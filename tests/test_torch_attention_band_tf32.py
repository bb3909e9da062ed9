"""The f32 B10 and B11 past head dim 4096 (the band form of
``csrc/attention_bwd.cu``) emulated on the CPU.

On the card the band form forms S = Q K^T and dP = dO V^T once a 128 x
64 tile over the whole head dim, in chunks of 32 columns (3xTF32, each
chunk's product in a fresh accumulator, added to the running sum in
f32), then P = exp(scale*S - LSE) and dS = P*(dP - delta) under the
mask, and stores them in a workspace; the product pass reads them back:
dV = P^T dO and dK = scale * dS^T Q (B10) over the band's rows, dQ =
scale * dS K (B11) over the keys, in steps of 32 rows (keys), each step
summed in a fresh accumulator and added in f32. The query rows go a band
of ``band_rows`` at a time; B10 stores on the first band and adds each
later one in band order. The emulation below follows that order: every
product through the 3xTF32 split of ``test_torch_attention_bwd``, the
chunks, steps and bands added in order. It is held to the f32 rule of
``chip_smoke.py``'s BWD_TOL (2e-5*|plain| + 2e-5*max|plain|) against the
plain versions, which the card's kernels are held to as well; the
kernels themselves run only on the card.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from accl_tpu_torch.ops import attention as A  # noqa: E402

from test_torch_attention_bwd import _f32_ratios, _mm_tf32x3  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "accl_tpu_torch" / "csrc"
CHUNK = 32      # head-dim columns of a score chunk
STEP = 32       # rows (B10) and keys (B11) of a product step
TILE = 64       # a score tile's keys; bands are whole multiples of it


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment."""
    yield


def _operands(B, H, Hkv, sq, skv, D, causal, seed):
    """f32 q, dout (B, H, sq, D), k, v (B, Hkv, skv, D) and the backward's
    operands: the forward's LSE, delta from O."""
    rng = np.random.default_rng(seed)
    xq, xdo = (torch.from_numpy(rng.standard_normal((B, H, sq, D))
                                .astype(np.float32)) for _ in range(2))
    xk, xv = (torch.from_numpy(rng.standard_normal((B, Hkv, skv, D))
                               .astype(np.float32)) for _ in range(2))
    o, lse = A.flash_attention_fwd(xq, xk, xv, causal)
    delta = (xdo * o).sum(-1).reshape(B * H, sq)
    return xq, xdo, xk, xv, lse, delta, causal, D ** -0.5


def _chunked(a, b):
    """a @ b^T over the last dim: one 3xTF32 product a CHUNK-column chunk
    (a fresh accumulator), the chunks added in f32 in order."""
    out = None
    for c in range(0, a.shape[-1], CHUNK):
        part = _mm_tf32x3(a[..., c:c + CHUNK],
                          b[..., c:c + CHUNK].transpose(-1, -2))
        out = part if out is None else out + part
    return out


def _stepped(a, b):
    """a @ b, the reduced dim cut into STEP-row steps from its start, each
    a 3xTF32 product (a fresh accumulator), the steps added in f32 in
    order. Under the causal mask the kernel's first step starts at a
    whole tile of the band, where these steps start too, and the steps
    before it add zeros."""
    out = None
    for t0 in range(0, a.shape[-1], STEP):
        part = _mm_tf32x3(a[..., t0:t0 + STEP], b[..., t0:t0 + STEP, :])
        out = part if out is None else out + part
    return out


def _band_route(q, do, k, v, lse, delta, causal, scale, rows=None):
    """(dk, dv, dq) as the band form computes them with bands of ``rows``
    query rows (``A.band_rows`` for B10 and for B11 when None)."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    qf, dof = (t.reshape(B, Hkv, g, Sq, D).float() for t in (q, do))
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    lse5 = lse.reshape(B, Hkv, g, Sq, 1)
    delta5 = delta.reshape(B, Hkv, g, Sq, 1)
    keys = torch.arange(Skv)
    out = {}
    for dkv in (True, False):
        R = rows or A.band_rows(dkv, Sq, Skv, D)
        dk = dv = dq = None
        for r0 in range(0, Sq, R):
            sl = slice(r0, min(r0 + R, Sq))
            rws = torch.arange(sl.start, sl.stop)
            s = _chunked(qf[..., sl, :], kf)
            dp = _chunked(dof[..., sl, :], vf)
            mask = (keys[None, :] <= rws[:, None] if causal
                    else torch.ones(len(rws), Skv, dtype=torch.bool))
            p = torch.where(mask, torch.exp(s * scale - lse5[..., sl, :]),
                            0.0)
            ds = p * (dp - delta5[..., sl, :])
            if dkv:
                bdv = _stepped(p.transpose(-1, -2), dof[..., sl, :])
                bdk = _stepped(ds.transpose(-1, -2), qf[..., sl, :]) * scale
                dv = bdv if dv is None else dv + bdv
                dk = bdk if dk is None else dk + bdk
            else:
                bdq = _stepped(ds, kf) * scale
                dq = bdq if dq is None else torch.cat([dq, bdq], dim=-2)
        if dkv:
            out["dk"] = dk.reshape(B * H, Skv, D)
            out["dv"] = dv.reshape(B * H, Skv, D)
        else:
            out["dq"] = dq.reshape(q.shape)
    return out["dk"], out["dv"], out["dq"]


# (B, H, Hkv, Sq, Skv, D, causal): a head dim past the cluster form (the
# 17a rows' 4104) and one that is not a multiple of 64 (4360), ragged
# lengths from 64 to 200, causal and unmasked, GQA 4/2 and 2/1
CASES = {
    "d4104-causal-200": (1, 4, 2, 200, 200, 4104, True),
    "d4104-full-130x200": (1, 4, 2, 130, 200, 4104, False),
    "d4360-causal-72": (1, 2, 1, 72, 72, 4360, True),
    "d4360-full-64x96": (1, 2, 1, 64, 96, 4360, False),
}
# one band (the rule's own at these shapes) and several of one tile each
BANDS = (None, TILE)


@pytest.mark.parametrize("rows", BANDS, ids=["one-band", "bands-of-64"])
@pytest.mark.parametrize("case", list(CASES))
def test_band_route_emulation_within_f32_limit(case, rows):
    """The emulated band form (32-column chunks, 32-row steps, the bands in
    order) stays within the f32 limit against the plain versions for dk,
    dv and dq, and differs from them (the limit is not vacuous)."""
    B, H, Hkv, sq, skv, D, causal = CASES[case]
    args = _operands(B, H, Hkv, sq, skv, D, causal, 900 + D + sq)
    if rows is None:
        assert A.band_rows(True, sq, skv, D) == sq
        assert A.band_rows(False, sq, skv, D) == sq
    ratios = _f32_ratios(args, _band_route(*args, rows=rows))
    assert max(ratios) <= 1.0, ratios
    assert min(ratios) > 0.0, ratios


def test_band_route_emulation_repeats_bitwise():
    """The emulation gives the same bits twice; bands of 64 rows give other
    bits than one band (B10 adds the bands' sums in band order), so the
    band order is what fixes them, and both stay within the limit."""
    args = _operands(1, 4, 2, 200, 200, 4104, True, 901)
    first, again = _band_route(*args), _band_route(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    other = _band_route(*args, rows=TILE)
    assert not all(torch.equal(a, b) for a, b in zip(first[:2], other[:2]))
    assert torch.equal(first[2], other[2])   # B11's bands own their rows
    assert max(_f32_ratios(args, other)) <= 1.0


def test_band_route_matches_reference_vjp():
    """The emulated band form at D 4104 (GQA 2/1, causal, S 64) against
    ``jax.vjp`` of the reference's custom VJP (its Pallas kernels in
    interpret mode) on the same cotangent, f32 rtol = atol = 2e-5, with
    dk and dv summed over each kv head's group as ``_FlashAttention``
    does."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from accl_tpu.ops import attention as R
    B, H, Hkv, S, D = 1, 2, 1, 64, 4104
    args = _operands(B, H, Hkv, S, S, D, True, 902)
    q, do, k, v = args[:4]
    _, vjp = jax.vjp(lambda a, b, c: R.flash_attention(a, b, c, causal=True),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    dk, dv, dq = _band_route(*args)
    got = (dq, dk.reshape(B, Hkv, H // Hkv, S, D).sum(2),
           dv.reshape(B, Hkv, H // Hkv, S, D).sum(2))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


def _words(dkv, R, Skv):
    r4 = -(-R // 4) * 4
    return 2 * Skv * r4 if dkv else R * (-(-Skv // 4) * 4)


@pytest.mark.parametrize("dkv", [True, False], ids=["b10", "b11"])
def test_band_rule_bounds_the_workspace(dkv):
    """``band_rows`` over a grid of shapes: Sq when the workspace fits in
    q's own words, else a multiple of 64 below Sq; the largest that fits
    (one more tile does not), and the workspace within q's words whenever
    a band of one tile fits; ``band_workspace_floats`` is B * H of the
    band's words."""
    for Sq in (1, 63, 64, 130, 200, 1024, 4160, 8192):
        for Skv in (1, 65, 300, 1024, 4160, 100000):
            for D in (264, 4104, 4360, 8192):
                R = A.band_rows(dkv, Sq, Skv, D)
                budget = Sq * D
                if _words(dkv, Sq, Skv) <= budget:
                    assert R == Sq
                    continue
                assert R <= Sq and (R % TILE == 0 or R == Sq)
                if _words(dkv, min(Sq, TILE), Skv) <= budget:
                    assert _words(dkv, R, Skv) <= budget
                    assert _words(dkv, R + TILE, Skv) > budget or \
                        R + TILE >= Sq
                assert A.band_workspace_floats(dkv, 2, 3, Sq, Skv, D) == \
                    6 * _words(dkv, R, Skv)
    # the 17a shape: one band, 64 MB for B10 (B 1, H 8), 32 MB for B11
    assert A.band_rows(dkv, 1024, 1024, 4104) == 1024
    assert A.band_workspace_floats(dkv, 1, 8, 1024, 1024, 4104) * 4 == (
        64 if dkv else 32) << 20
    # the card's several-band case: H 2/1, S 4160, D 4104
    assert A.band_rows(dkv, 4160, 4160, 4104) == (2048 if dkv else 4096)


def test_band_rule_and_routes_are_the_kernels():
    """The mirror's constants and rule are the kernel source's: the tile,
    chunk and step sizes, the words of the workspace, the band rule and
    the form's head dims (past CLUSTER_MAX_D, f32 only); the route codes
    29 and 30 are the header's and the wrapper's; no column-group kernel
    of B10 or B11 is left."""
    # the tile, chunk and step sizes live in the header the forward's band
    # form shares
    src = (CSRC / "attention_bwd.cu").read_text() + (
        CSRC / "attention_band.cuh").read_text()
    assert re.search(r"constexpr int BT = (\d+);", src).group(1) == str(TILE)
    assert re.search(r"constexpr int BCH = (\d+);", src).group(1) == str(
        CHUNK)
    assert re.search(r"constexpr int SROWS = (\d+);", src).group(1) == str(
        STEP)
    assert A.BAND_TILE == TILE
    assert "return dkv ? 2LL * Skv * round4(R) : static_cast<long long>(R) " \
        "* round4(Skv);" in src
    assert re.search(
        r"band_rows\(int dkv, int Sq, int Skv, int D\) \{\s*"
        r"const long long budget = static_cast<long long>\(Sq\) \* D;\s*"
        r"if \(band_words\(dkv, Sq, Skv\) <= budget\) return Sq;\s*"
        r"const long long r = budget / \(dkv \? 2LL \* Skv : round4\(Skv\)\) "
        r"/ BT \* BT;\s*const int lo = Sq < BT \? Sq : BT;\s*"
        r"return r < lo \? lo : r > Sq \? Sq : static_cast<int>\(r\);", src)
    assert src.count("if (head_dim > CLUSTER_MAX_D)\n    return launch_band(") \
        == 2
    cluster = (CSRC / "attention_cluster.cuh").read_text()
    assert "constexpr int CLUSTER_MAX_D = 8 * 8 * SL;" in cluster
    assert A.F32_CLUSTER_MAX_D == 8 * 8 * 64
    assert A.takes_band(torch.float32, 4104)
    assert not A.takes_band(torch.float32, 4096)
    assert not A.takes_band(torch.bfloat16, 4104)
    for gone in ("attn_bwd_dkv_cols_kernel", "attn_bwd_dq_cols_kernel",
                 "launch_cols", "COLS_BYTES", "CGRP"):
        assert gone not in src, gone
    header = (CSRC / "attention_route.cuh").read_text()
    assert "ROUTE_BWD_DKV_TF32_BAND = 29, ROUTE_BWD_DQ_TF32_BAND = 30" in header
    assert A.ROUTES[29] == "bwd_dkv_tf32_band"
    assert A.ROUTES[30] == "bwd_dq_tf32_band"
