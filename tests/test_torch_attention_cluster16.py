"""The 16-bit attention forward (B8, B9, the B12 chunks) and B11 past head
dim 256 on the CPU: their cluster forms, emulated.

On the card, bf16 and f16 B8, B9 and B12 chunks of S_new > 1 at 256 < D
<= ``FWD16_CLUSTER_MAX_D`` (2048; the wrapper pads D to a multiple of
128) run ``attn_fwd_cluster_wgmma_kernel`` (``csrc/attention_sm90.cu``),
and B11 runs ``attn_bwd_dq_cluster_wgmma_kernel``
(``csrc/attention_bwd_sm90.cu``): a cluster of C = ceil(D / 256) blocks,
block c holding columns 256c .. 256c + 255 (the last block may hold only
128), owns one 64-row q tile. For each 64-key tile every block forms its
slice's partial products (S_c = Q_c K_c^T, and for B11 dP_c = dO_c
V_c^T: exact 16-bit products summed in f32), and the C partials of each
position are summed in block order 0 .. C - 1, so every block holds the
same bits. The forward then runs B8's online softmax on that S (P
rounded to the operands' type before P V, the row sum from the f32 P);
B11 forms P = exp2(S scale log2 e - LSE log2 e) and dS = P (dP - delta)
under the mask, rounds dS to the operands' type and adds dS K_c to its
columns of dQ. ``cluster_fwd`` and ``cluster_dq`` below follow that
order.

The limits are those ``chip_smoke.py`` holds the kernels to, per element
(FWD_TOL, BWD_TOL):

    O:  |got - plain| <= u * m + r * |plain| + r * median|plain|
        (+ 2^-25 * s for f16), m the magnitude of the rounded sum P V
        (``fwd_rounding_magnitudes``), s ``fwd_subnormal_magnitudes``;
        the LSE within 2e-5 + 2e-5 * |lse|;
    dQ: the same rule with ``bwd_rounding_magnitudes`` and
        ``bwd_subnormal_magnitudes``;

u = 2^-8 and r = 2^-7 for bf16, u = 2^-11 and r = 2^-10 for f16, against
the plain versions (``flash_attention_ref``, ``flash_decode_ref``,
``flash_attention_bwd_dq_ref``) and, at small sizes, against the JAX
package's ``flash_attention``, its gradient and ``flash_decode`` (Pallas
in interpret mode) on the same numpy inputs, within two ulps of the
output scale and four of the gradient scale
(``test_torch_attention_wide.py``'s rule). The kernels themselves run
only on the card.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from accl_tpu.ops import attention as R  # noqa: E402
from accl_tpu_torch.ops import attention as A  # noqa: E402
from test_torch_attention_wide import _close  # noqa: E402

import chip_smoke as CS  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment."""
    yield


ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "accl_tpu_torch" / "csrc"
SLICE = 256            # a cluster block's columns (FSL, DSL: WGRP)
KEYS = 64              # the key tile (BKV)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG = float(torch.finfo(torch.float32).min)
UNIT = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}   # P's, dS's
REL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}    # O's, dQ's
SUBNORMAL_STEP = 2.0 ** -25
DTYPES = ("bfloat16", "float16")


def _t(dtype: str):
    return getattr(torch, dtype)


def _slices(D: int) -> list:
    """The blocks' column slices of a head dim D (a multiple of 128)."""
    return [slice(c, min(c + SLICE, D)) for c in range(0, D, SLICE)]


def _summed(a, b, order):
    """sum over the blocks c in ``order`` of a_c b_c^T (f32), a (.., n, D)
    and b (.., m, D) sliced by block: the partials summed in that order."""
    cols = _slices(a.shape[-1])
    out = None
    for c in order:
        part = torch.matmul(a[..., cols[c]], b[..., cols[c]].transpose(-1, -2))
        out = part if out is None else out + part
    return out


def cluster_fwd(q, k, v, causal: bool, scale: float, off: int = 0,
                order=None):
    """The cluster forward's arithmetic on the CPU. q (B, H, Sq, D), k and
    v (B, Hkv, Skv, D) of one 16-bit dtype, D a multiple of 128; key j is
    seen by row i under ``causal`` when j <= i + off. For each 64-key tile:
    the slices' S in f32 summed in block order (``order``, block order
    when None), scaled by scale log2(e), the running max m, alpha =
    exp2(m_old - m), p = exp2(s - m) (0 where hidden), l = l alpha + sum p,
    O = O alpha + P V with P rounded to the dtype. Returns (O in q's dtype,
    LSE = m ln 2 + log(max(l, 1e-30)) as (B*H, Sq) f32)."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    order = order or list(range(len(_slices(D))))
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scale_log2 = float(np.float32(scale) * np.float32(LOG2E))
    rows = torch.arange(Sq)
    m = torch.full((B, H, Sq), NEG)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, D)
    for k0 in range(0, Skv, KEYS):
        keys = torch.arange(k0, min(k0 + KEYS, Skv))
        s = _summed(qf, kf[:, :, keys], order) * scale_log2
        seen = (keys[None, :] <= rows[:, None] + off if causal
                else torch.ones(Sq, keys.numel(), dtype=torch.bool))
        m_new = torch.maximum(m, torch.where(seen, s, NEG).amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(seen, torch.exp2(s - m_new[..., None]), 0.0)
        m = m_new
        l = l * alpha + p.sum(-1)
        pr = p.to(q.dtype).float()
        acc = acc * alpha[..., None] + torch.matmul(pr, vf[:, :, keys])
    lc = l.clamp_min(1e-30)
    o = (acc / lc[..., None]).to(q.dtype)
    return o, (m * LN2 + torch.log(lc)).reshape(B * H, Sq)


def cluster_dq(q, do, k, v, lse, delta, causal: bool, scale: float,
               order=None, f32: bool = False):
    """The cluster B11's arithmetic on the CPU. q, do (B, H, Sq, D) and k,
    v (B, Hkv, Skv, D) of one 16-bit dtype, D a multiple of 128; lse,
    delta (B*H, Sq) f32. For each 64-key tile: the slices' S and dP in f32
    summed in block order (``order``, block order when None), P =
    exp2(S scale log2(e) - LSE log2(e)) and dS = P (dP - delta) under the
    top-left causal mask, dS rounded to the dtype, dQ += dS K in f32;
    returns dQ scale in q's dtype (``f32``: before that rounding)."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    order = order or list(range(len(_slices(D))))
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scale_log2 = float(np.float32(scale) * np.float32(LOG2E))
    lse2 = lse.reshape(B, H, Sq, 1) * LOG2E
    dl = delta.reshape(B, H, Sq, 1)
    rows = torch.arange(Sq)
    dq = torch.zeros(B, H, Sq, D)
    for k0 in range(0, Skv, KEYS):
        keys = torch.arange(k0, min(k0 + KEYS, Skv))
        s = _summed(qf, kf[:, :, keys], order)
        dp = _summed(dof, vf[:, :, keys], order)
        seen = (keys[None, :] <= rows[:, None] if causal
                else torch.ones(Sq, keys.numel(), dtype=torch.bool))
        p = torch.where(seen, torch.exp2(s * scale_log2 - lse2), 0.0)
        ds = (p * (dp - dl)).to(q.dtype).float()
        dq = dq + torch.matmul(ds, kf[:, :, keys])
    return dq * scale if f32 else (dq * scale).to(q.dtype)


def fwd_limit(plain, dtype, args, causal, scale, off=0):
    """FWD_TOL's per-element limit of O (module docstring)."""
    q, k, v = args
    mag = UNIT[dtype] * A.fwd_rounding_magnitudes(q, k, v, causal, scale,
                                                  off)
    if dtype == "float16":
        mag = mag + SUBNORMAL_STEP * A.fwd_subnormal_magnitudes(
            q, k, v, causal, scale, off)
    p = plain.float().abs()
    return mag + REL[dtype] * p + REL[dtype] * float(p.median())


def dq_limit(plain, dtype, args, causal, scale):
    """BWD_TOL's per-element limit of dQ (module docstring)."""
    _mk, _mv, mq = A.bwd_rounding_magnitudes(*args, causal, scale)
    mag = UNIT[dtype] * mq
    if dtype == "float16":
        mag = mag + SUBNORMAL_STEP * A.bwd_subnormal_magnitudes(
            *args, causal, scale)[2]
    p = plain.float().abs()
    return mag + REL[dtype] * p + REL[dtype] * float(p.median())


def ratio(got, plain, lim) -> float:
    """Largest error/limit over the elements."""
    return float(((got.float() - plain.float()).abs() / lim).max())


def lse_ratio(got, plain) -> float:
    return float(((got - plain).abs() / (2e-5 + 2e-5 * plain.abs())).max())


def _inputs(dtype, shapes, seed):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return xs, [torch.from_numpy(x).to(_t(dtype)) for x in xs]


# D: 264 (padded to 384: C = 2, the second block 128 live columns), 512
# (C 2), 640 (C 3), 1024 (C 4), 2048 (C 8); (kind, B, H, Hkv, Sq, Skv,
# causal): B8 on ragged q and key tiles with GQA, causal; B8 with Sq !=
# Skv unmasked; B9 over one key block (Skv <= 512)
DIMS = (264, 512, 640, 1024, 2048)
FWD_SHAPES = (("fwd", 1, 4, 2, 100, 100, True),
              ("fwd", 1, 2, 1, 70, 130, False),
              ("fwd_single", 1, 4, 1, 96, 96, True))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=lambda s: s[0] + (
    "-causal" if s[-1] else "-ragged"))
@pytest.mark.parametrize("D", DIMS)
def test_cluster_fwd_within_fwd_tol(D, shape, dtype):
    """The emulated cluster forward (B8 and B9) at every tested cluster
    size, within FWD_TOL's 16-bit limit of the plain version for O and
    the f32 limit for the LSE, and not equal to it (the limit is not
    vacuous)."""
    kind, B, H, Hkv, Sq, Skv, causal = shape
    assert A.is_single_block(Skv, None if kind == "fwd_single" else 16) == (
        kind == "fwd_single")
    _xs, (q, k, v) = _inputs(dtype, ((B, H, Sq, D), (B, Hkv, Skv, D),
                                     (B, Hkv, Skv, D)), seed=D + Sq)
    scale = D ** -0.5
    padded = A._pad_d(q, k, v)
    assert padded[0].shape[-1] == -(-D // 128) * 128
    assert len(_slices(padded[0].shape[-1])) == -(-D // SLICE)
    o, lse = cluster_fwd(*padded, causal, scale)
    o = o[..., :D]
    plain, plain_lse = A.flash_attention_ref(q, k, v, causal, scale)
    r = ratio(o, plain, fwd_limit(plain, dtype, (q, k, v), causal, scale))
    assert 0.0 < r <= 1.0, r
    assert lse_ratio(lse, plain_lse) <= 1.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", DIMS)
def test_cluster_prefill_within_fwd_tol(D, dtype):
    """A B12 chunk (S_new 70 new tokens after 60 cached, GQA 4/2) over a
    cache of 200 rows with NaN past kv_len 130: the emulated cluster form
    on the filled prefix, bottom-right causal, finite and within FWD_TOL
    of ``flash_decode_ref``."""
    s_new, kv_len, T = 70, 130, 200
    xs, (q, kc, vc) = _inputs(dtype, ((1, 4, s_new, D), (1, T, 2, D),
                                      (1, T, 2, D)), seed=3 * D)
    kc[:, kv_len:] = float("nan")
    vc[:, kv_len:] = float("nan")
    scale = D ** -0.5
    k, v = A.cache_prefix(kc, vc, kv_len)
    qp, kp, vp = A._pad_d(q, k.contiguous(), v.contiguous())
    o = cluster_fwd(qp, kp, vp, True, scale, off=kv_len - s_new)[0][..., :D]
    assert torch.isfinite(o).all()
    plain = A.flash_decode_ref(q, kc, vc, kv_len)
    lim = fwd_limit(plain, dtype, (q, k, v), True, scale, kv_len - s_new)
    assert 0.0 < ratio(o, plain, lim) <= 1.0


def _dq_case(dtype, D, causal, B, H, Hkv, Sq, Skv, seed):
    """16-bit q, do, k, v from numpy, the plain forward's O and LSE,
    delta = rowsum(do * o) as the autograd Function forms it."""
    xs, (q, do, k, v) = _inputs(dtype, ((B, H, Sq, D), (B, H, Sq, D),
                                        (B, Hkv, Skv, D), (B, Hkv, Skv, D)),
                                seed)
    o, lse = A.flash_attention_ref(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).reshape(B * H, Sq)
    return xs, (q, do, k, v, lse, delta)


DQ_SHAPES = {True: (1, 4, 2, 100, 100), False: (1, 2, 1, 70, 130)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", DIMS)
def test_cluster_dq_within_bwd_tol(D, causal, dtype):
    """The emulated cluster B11 at every tested cluster size within
    BWD_TOL's 16-bit dq limit of the plain version, and not equal to
    it."""
    _xs, args = _dq_case(dtype, D, causal, *DQ_SHAPES[causal], seed=D + 5)
    scale = D ** -0.5
    padded = A._pad_d(*args[:4])
    got = cluster_dq(*padded, *args[4:], causal, scale)[..., :D]
    plain = A.flash_attention_bwd_dq_ref(*args, causal, scale)
    r = ratio(got, plain, dq_limit(plain, dtype, args, causal, scale))
    assert 0.0 < r <= 1.0, r


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", (768, 1024))
def test_block_order_fixes_the_bits(D, dtype):
    """Each emulation in block order gives the same bits twice; in
    reverse block order (three and four blocks: two partials add the same
    either way) other bits, within the limits too: the order, which every
    block (or owner of a position) keeps, is what fixes them."""
    _xs, args = _dq_case(dtype, D, True, 1, 2, 1, 100, 100, seed=7 + D)
    q, do, k, v, lse, delta = args
    scale = D ** -0.5
    rev = list(range(D // SLICE))[::-1]
    first = cluster_fwd(q, k, v, True, scale)
    assert all(torch.equal(a, b) for a, b in
               zip(first, cluster_fwd(q, k, v, True, scale)))
    other = cluster_fwd(q, k, v, True, scale, order=rev)
    assert not all(torch.equal(a, b) for a, b in zip(first, other))
    plain = A.flash_attention_ref(q, k, v, True, scale)[0]
    assert ratio(other[0], plain, fwd_limit(plain, dtype, (q, k, v), True,
                                            scale)) <= 1.0
    dq = cluster_dq(*args, True, scale, f32=True)
    assert torch.equal(dq, cluster_dq(*args, True, scale, f32=True))
    dq_rev = cluster_dq(*args, True, scale, order=rev, f32=True)
    assert not torch.equal(dq, dq_rev)
    dq_rev = dq_rev.to(q.dtype)
    plain_dq = A.flash_attention_bwd_dq_ref(*args, True, scale)
    assert ratio(dq_rev, plain_dq, dq_limit(plain_dq, dtype, args, True,
                                            scale)) <= 1.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", (264, 512))
def test_cluster_forms_against_jax(D, dtype):
    """The emulated cluster forward, B11 and B12 chunk against the JAX
    package on the same inputs (causal, GQA 2/1, S 128): O against
    ``flash_attention``, dq against ``jax.vjp`` of it with the same
    cotangent, a chunk of 16 new tokens against ``flash_decode`` over a
    cache with NaN past kv_len; within two ulps of the output scale and
    four of the gradient scale."""
    B, H, Hkv, S = 1, 2, 1, 128
    xs, args = _dq_case(dtype, D, True, B, H, Hkv, S, S, seed=31 + D)
    jdt = getattr(jnp, dtype)
    jq, jdo, jk, jv = (jnp.asarray(x).astype(jdt) for x in xs)
    want_o, vjp = jax.vjp(
        lambda q, k, v: R.flash_attention(q, k, v, causal=True), jq, jk, jv)
    want_dq = vjp(jdo)[0]
    q, do, k, v, lse, delta = args
    scale = D ** -0.5
    qp, dop, kp, vp = A._pad_d(q, do, k, v)
    o = cluster_fwd(qp, kp, vp, True, scale)[0][..., :D]
    _close(o, want_o, dtype, f"{dtype} D={D} O")
    dq = cluster_dq(qp, dop, kp, vp, lse, delta, True, scale)[..., :D]
    _close(dq, want_dq, dtype, f"{dtype} D={D} dq", ulps=4)
    s_new, kv_len, T = 16, 100, S
    kc, vc = (np.array(x[0, :, :T].transpose(1, 0, 2)[None], np.float32)
              for x in xs[2:])
    kc[:, kv_len:] = np.nan
    vc[:, kv_len:] = np.nan
    qn = xs[0][:, :, :s_new]
    want = R.flash_decode(*(jnp.asarray(x).astype(jdt) for x in (qn, kc, vc)),
                          jnp.int32(kv_len))
    tq, tkc, tvc = (torch.from_numpy(x).to(_t(dtype)) for x in (qn, kc, vc))
    tk, tv = A.cache_prefix(tkc, tvc, kv_len)
    got = cluster_fwd(*A._pad_d(tq, tk.contiguous(), tv.contiguous()), True,
                      scale, off=kv_len - s_new)[0][..., :D]
    assert torch.isfinite(got).all()
    _close(got, want, dtype, f"{dtype} D={D} chunk")


def test_emulated_constants_are_the_kernels():
    """The emulation's slice, key tile and units are the kernels': 256
    columns a block (``FSL``, ``DSL``: ``WGRP``), 64-key tiles (``BKV``),
    units dealt to block u % C and summed in block order, C = ceil(D /
    256) blocks; the head dims of the cluster forms as the wrapper's and
    chip_smoke's: the forward (B12 only for chunks of S_new > 1) past 256
    to ``FWD16_CLUSTER_MAX_D`` (2048) but in ``FWD16_COLS_BAND`` (the
    clusters of three blocks; B9 only past ``FWD16_SINGLE_MIN_D``, 384),
    B11 past ``BWD16_DQ_CLUSTER_MIN_D`` (640) to 2048."""
    fwd = (CSRC / "attention_sm90.cu").read_text()
    bwd = (CSRC / "attention_bwd_sm90.cu").read_text()
    tile = (CSRC / "sm90_tile.cuh").read_text()
    assert re.search(r"constexpr int WGRP = (\d+);", tile).group(1) == str(
        SLICE)
    assert re.search(r"constexpr int WCH = (\d+);", tile).group(1) == str(
        A.COLS_CHUNK)
    assert re.search(r"constexpr int BKV = (\d+);", tile).group(1) == str(
        KEYS)
    assert "constexpr int FSL = WGRP;" in fwd
    assert "constexpr int DSL = WGRP;" in bwd
    assert "constexpr int FWD16_CLUSTER_MAX_D = 8 * FSL;" in fwd
    assert ("constexpr int FWD16_COLS_MIN_D = 2 * FSL, FWD16_COLS_MAX_D = "
            "3 * FSL;") in fwd
    assert A.FWD16_CLUSTER_MAX_D == 8 * SLICE
    assert A.FWD16_COLS_BAND == (2 * SLICE, 3 * SLICE)
    assert "constexpr int BWD16_DQ_CLUSTER_MIN_D = 5 * WCH;" in bwd
    assert "constexpr int BWD16_DQ_CLUSTER_MAX_D = 8 * DSL;" in bwd
    assert A.BWD16_DQ_CLUSTER_MIN_D == 5 * 128
    assert "constexpr int FWD16_SINGLE_MIN_D = 3 * WCH;" in fwd
    assert A.FWD16_SINGLE_MIN_D == 3 * 128
    assert "if (fwd16_cluster(head_dim, false))" in fwd             # B8
    assert "if (fwd16_cluster(head_dim, true))" in fwd              # B9
    assert "if (fwd16_cluster(head_dim, false) && s_new > 1)" in fwd  # B12
    assert ("if (head_dim > BWD16_DQ_CLUSTER_MIN_D && head_dim <= "
            "BWD16_DQ_CLUSTER_MAX_D)") in bwd
    assert "const int C = (a.D + FSL - 1) / FSL;" in fwd
    assert "(a.D + DSL - 1) / DSL," in bwd
    for src in (fwd, bwd):
        assert "u % C != rank" in src                 # owners
        assert "bb == rank" in src                    # block order
    assert all(len(_slices(d)) == -(-d // SLICE) <= 8
               for d in (384, 512, 640, 1024, 1280, 1792, 2048))


def _route(monkeypatch, code: int):
    """``_took_route`` as it counts a launch that reported ``code``."""
    class Lib:
        @staticmethod
        def accl_attn_last_route():
            return code
    monkeypatch.setattr(A._build, "library", lambda: Lib)
    A._took_route()


@pytest.mark.parametrize("kind,code", [("fwd_wgmma", 25),
                                       ("fwd_single_wgmma", 26),
                                       ("prefill_wgmma", 27),
                                       ("bwd_dq_wgmma", 28)])
def test_wrapper_routes_the_cluster_forms(kind, code, monkeypatch):
    """The cluster routes' codes are the header's, their tier a block's 256
    columns; a launch on one counts in ``route_launches`` and, for B8, B9
    and the B12 chunks, in the tensor-core counter of its kind, as the
    column-group form's did; ``takes_cluster16`` and chip_smoke's
    ``tier_of`` expect them at the head dims of the cluster forms (the
    wrapper's padding to 128 first) for both 16-bit dtypes, the column
    groups elsewhere past 256."""
    text = (CSRC / "attention_route.cuh").read_text()
    name = f"{kind}_cluster"
    assert f"ROUTE_{name.upper()} = {code}" in text
    assert A.ROUTES[code] == name
    counter = {"fwd_wgmma": "fwd_wgmma_launches",
               "fwd_single_wgmma": "fwd_single_wgmma_launches",
               "prefill_wgmma": "prefill_wgmma_launches"}.get(kind)
    key = (name, "float16", 256)
    monkeypatch.setattr(A, "route_launches", {})
    before = getattr(A, counter) if counter else None
    _route(monkeypatch, code << 16 | 2 << 12 | 256)
    assert A.route_launches == {key: 1}
    if counter:
        assert getattr(A, counter) == before + 1
        monkeypatch.setattr(A, counter, before)
    base = kind.removesuffix("_wgmma")
    cluster = {"bwd_dq": (648, 768, 1024, 1280, 1792, 2048),
               "fwd_single": (392, 512, 776, 1024, 1032, 1280, 1792, 2048)
               }.get(base, (264, 384, 512, 776, 1024, 1032, 1280, 1792,
                            2048))
    cols = {"bwd_dq": (264, 512, 640, 2056),
            "fwd_single": (264, 384, 520, 640, 768, 2056)
            }.get(base, (520, 640, 768, 2056))
    for dname in DTYPES:
        for D in cluster:
            assert A.takes_cluster16(base, -(-D // 128) * 128), D
            assert CS.tier_of(base, dname, D) == (name, dname, 256), D
        for D in cols:
            assert not A.takes_cluster16(base, -(-D // 128) * 128), D
            assert CS.tier_of(base, dname, D) == (f"{base}_wgmma_cols",
                                                  dname, 256), D
        assert CS.tier_of(base, dname, 256)[0] == f"{base}_wgmma"
    assert CS.tier_of(base, "float32", 1024)[0].endswith("_tf32_cols")
