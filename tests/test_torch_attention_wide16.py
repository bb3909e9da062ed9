"""The 16-bit attention past head dim 256 on the CPU: the cluster form of
B10 (``csrc/attention_bwd_sm90.cu``) and the wide split-KV single-token
decode (``csrc/attention_decode.cu``), emulated; and the split decode's
ticket counters, kept per (device, stream).

On the card, bf16 and f16 B10 at 256 < D <= ``BWD16_CLUSTER_MAX_D``
(1024; the wrapper pads D to a multiple of 128) runs
``attn_bwd_dkv_cluster_wgmma_kernel``: a cluster of C = D / 128 blocks,
block c holding columns 128c .. 128c + 127, forms its slice's partials
S^T_c = K_c Q_c^T and dP^T_c = V_c dO_c^T (exact 16-bit products summed
in f32), the owner of each position adds the C partials in block order,
forms P = exp(scale S - LSE) and dS = P (dP - delta) under the mask and
rounds both to the operands' type, and every block adds dV_c += P^T dO_c
and dK_c += dS^T Q_c a 64-row q tile at a time. ``cluster_dkv`` below
follows that order. A single-token decode of 16 bits up to
``DECODE_SPLIT_MAX_D`` (2048) runs ``attn_decode_split_wide_kernel``: the
slices of ``decode_split_ranges``, each an online softmax in f32 over key
tiles of 16384 / DP keys (DP the column tier: 512, 1024, 2048; twice the
f32 kernel's, so that a stage stays 64 KB), merged as a tree of fan-in 8,
O rounded once to the operands' type.

The limits are those ``chip_smoke.py`` holds the kernels to, per element:

    B10 (BWD_TOL), dk and dv:  |got - plain| <= u * m + 2e-5 * max|plain|
        m the magnitude of the rounded sums (``bwd_rounding_magnitudes``),
        u = 2^-8 for bf16 and 2^-11 for f16, plus 2^-25 * s for f16
        (``bwd_subnormal_magnitudes``: a subnormal P or dS);
    decode (the split route's, nothing rounded before O):
        |got - plain| <= r * |plain| + r * median|plain|,
        r = 2^-7 for bf16, 2^-10 for f16;

against the plain versions (``flash_attention_bwd_dkv_ref``,
``flash_decode_ref``) and, at small sizes, against the JAX package's
``flash_attention`` gradients and ``flash_decode`` (Pallas in interpret
mode) on the same numpy inputs, within four ulps of the gradient scale
and two of the output scale (``test_torch_attention_wide.py``'s rule).
The kernels themselves run only on the card.
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
from test_torch_attention_cluster_fwd import (  # noqa: E402
    wide_split, wide_tier)
from test_torch_attention_wide import _close  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment."""
    yield


CSRC = Path(__file__).resolve().parent.parent / "accl_tpu_torch" / "csrc"
SLICE = 128            # a cluster block's columns (attention_bwd_sm90.cu CSL)
TILE = 64              # the q tile (BQ)
LOG2E = 1.4426950408889634
UNIT = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}   # P's, dS's
REL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}    # O's
SUBNORMAL_STEP = 2.0 ** -25
DTYPES = ("bfloat16", "float16")


def _t(dtype: str):
    return getattr(torch, dtype)


# ---- B10's cluster form ------------------------------------------------------


def cluster_dkv(q, do, k, v, lse, delta, causal: bool, scale: float,
                order=None):
    """The cluster B10's arithmetic on the CPU. q, do (B, H, Sq, D) and k,
    v (B, Hkv, Skv, D) of one 16-bit dtype, D a multiple of SLICE; lse,
    delta (B*H, Sq) f32. For each 64-row q tile: each 128-column slice's
    S^T and dP^T in f32, the slices added in block order (``order``, block
    order when None), P = exp2(S scale log2(e) - LSE log2(e)) and dS = P
    (dP - delta) under the top-left causal mask, both rounded to the
    dtype, then dV += P^T dO and dK += dS^T Q in f32 tile by tile; dK
    scaled once. Returns the per-q-head partials (dk, dv), each (B*H,
    Skv, D) f32."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    C = D // SLICE
    order = order or list(range(C))
    kf = k.float().repeat_interleave(g, dim=1)        # (B, H, Skv, D)
    vf = v.float().repeat_interleave(g, dim=1)
    qf, dof = q.float(), do.float()
    lse2 = (lse.reshape(B, H, Sq) * LOG2E)
    dl = delta.reshape(B, H, Sq)
    dk = torch.zeros(B, H, Skv, D)
    dv = torch.zeros(B, H, Skv, D)
    keys = torch.arange(Skv)
    for q0 in range(0, Sq, TILE):
        rows = slice(q0, min(q0 + TILE, Sq))
        st = dpt = None
        for c in order:
            cols = slice(c * SLICE, (c + 1) * SLICE)
            ps = torch.matmul(kf[..., cols], qf[:, :, rows, cols]
                              .transpose(-1, -2))
            pd = torch.matmul(vf[..., cols], dof[:, :, rows, cols]
                              .transpose(-1, -2))
            st = ps if st is None else st + ps
            dpt = pd if dpt is None else dpt + pd
        qi = torch.arange(rows.start, rows.stop)
        seen = (keys[:, None] <= qi[None, :] if causal
                else torch.ones(Skv, qi.numel(), dtype=torch.bool))
        p = torch.where(seen, torch.exp2(st * (scale * LOG2E)
                                         - lse2[:, :, None, rows]), 0.0)
        ds = p * (dpt - dl[:, :, None, rows])
        pr = p.to(q.dtype).float()
        dsr = ds.to(q.dtype).float()
        dv = dv + torch.matmul(pr, dof[:, :, rows])
        dk = dk + torch.matmul(dsr, qf[:, :, rows])
    return ((dk * scale).reshape(B * H, Skv, D), dv.reshape(B * H, Skv, D))


def bwd_ratio(got, plain, mag) -> float:
    """Largest error/limit of a dk or dv partial (BWD_TOL)."""
    lim = mag + 2e-5 * float(plain.abs().max())
    return float(((got - plain).abs() / lim).max())


def _bwd_case(dtype, D, causal, B, H, Hkv, Sq, Skv, seed):
    """16-bit operands from numpy (q, do, k, v), the plain forward's O and
    LSE, delta = rowsum(do * o) as the autograd Function forms it; the
    wrapper's padding to a multiple of 128."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((B, H, Sq, D), (B, H, Sq, D), (B, Hkv, Skv, D),
                    (B, Hkv, Skv, D))]
    q, do, k, v = (torch.from_numpy(x).to(_t(dtype)) for x in xs)
    o, lse = A.flash_attention_ref(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).reshape(B * H, Sq)
    return xs, (q, do, k, v, lse, delta)


def _limits(dtype, args, causal, scale):
    """(dk's, dv's) allowances u * m (+ 2^-25 * s for f16)."""
    mk, mv, _ = A.bwd_rounding_magnitudes(*args, causal, scale)
    mags = [UNIT[dtype] * mk, UNIT[dtype] * mv]
    if dtype == "float16":
        sk, sv, _ = A.bwd_subnormal_magnitudes(*args, causal, scale)
        mags = [mags[0] + SUBNORMAL_STEP * sk, mags[1] + SUBNORMAL_STEP * sv]
    return mags


# D: 264 (padded to 384, C = 3), 512 (C 4), 640 (5), 768 (6), 896 (7),
# 1024 (8): every cluster size; (B, H, Hkv, Sq, Skv): ragged q and key
# tiles, GQA, and Sq != Skv unmasked
BWD_DIMS = (264, 512, 640, 768, 896, 1024)
BWD_SHAPES = {True: (1, 4, 2, 100, 100), False: (1, 2, 1, 70, 130)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", BWD_DIMS)
def test_cluster_dkv_within_bwd_tol(D, causal, dtype):
    """The emulated cluster B10, every cluster size from 3 to 8 blocks,
    within BWD_TOL's 16-bit limit of the plain version for dk and dv, and
    not equal to it (the limit is not vacuous)."""
    _xs, args = _bwd_case(dtype, D, causal, *BWD_SHAPES[causal], seed=D)
    scale = D ** -0.5
    padded = A._pad_d(*args[:4])
    assert padded[0].shape[-1] == -(-D // SLICE) * SLICE
    assert padded[0].shape[-1] // SLICE in range(3, 9)
    got = cluster_dkv(*padded, *args[4:], causal, scale)
    got = [t[..., :D] for t in got]
    plain = A.flash_attention_bwd_dkv_ref(*args, causal, scale)
    rs = [bwd_ratio(a, b, m) for a, b, m in
          zip(got, plain, _limits(dtype, args, causal, scale))]
    assert max(rs) <= 1.0, rs
    assert min(rs) > 0.0, rs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", (512, 1024))
def test_cluster_dkv_block_order_fixes_the_bits(D, dtype):
    """The emulation in block order gives the same bits twice; in reverse
    block order other bits, within the limit too: the order, which every
    owner of a position keeps, is what fixes them."""
    _xs, args = _bwd_case(dtype, D, True, 1, 2, 1, 100, 100, seed=7 + D)
    scale = D ** -0.5
    first = cluster_dkv(*args, True, scale)
    again = cluster_dkv(*args, True, scale)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    rev = list(range(D // SLICE))[::-1]
    other = cluster_dkv(*args, True, scale, order=rev)
    assert not all(torch.equal(a, b) for a, b in zip(first, other))
    plain = A.flash_attention_bwd_dkv_ref(*args, True, scale)
    assert max(bwd_ratio(a, b, m) for a, b, m in zip(
        other, plain, _limits(dtype, args, True, scale))) <= 1.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", (264, 512))
def test_cluster_dkv_against_jax(D, dtype):
    """The emulated cluster B10's dk and dv (the per-q-head partials
    summed over each GQA group and cast to k's dtype, as the autograd
    Function does) against ``jax.vjp`` of the JAX package's
    ``flash_attention`` on the same inputs and cotangent, causal, GQA 2/1,
    S 128: within four ulps of the gradient scale."""
    B, H, Hkv, S = 1, 2, 1, 128
    xs, args = _bwd_case(dtype, D, True, B, H, Hkv, S, S, seed=31 + D)
    jq, jdo, jk, jv = (jnp.asarray(x).astype(getattr(jnp, dtype))
                       for x in xs)
    _, vjp = jax.vjp(lambda q, k, v: R.flash_attention(q, k, v, causal=True),
                     jq, jk, jv)
    _dq, want_dk, want_dv = vjp(jdo)
    q, do, k, v, lse, delta = args
    padded = A._pad_d(q, do, k, v)
    dkp, dvp = (t[..., :D] for t in cluster_dkv(*padded, lse, delta, True,
                                                  D ** -0.5))
    g = H // Hkv
    dk = dkp.reshape(B, Hkv, g, S, D).sum(2).to(k.dtype)
    dv = dvp.reshape(B, Hkv, g, S, D).sum(2).to(v.dtype)
    _close(dk, want_dk, dtype, f"{dtype} D={D} dk", ulps=4)
    _close(dv, want_dv, dtype, f"{dtype} D={D} dv", ulps=4)


# ---- the 16-bit wide split decode -------------------------------------------


def wide_split16(q, kc, vc, kv_len: int, n_split: int):
    """The wide kernel's arithmetic on 16-bit operands: ``wide_split``
    (q and the cache widened to f32 exactly, each slice an online softmax
    in f32, the merge tree) over key tiles of 16384 / DP keys, O rounded
    once to q's dtype."""
    kt = 16384 // wide_tier(q.shape[-1])
    return wide_split(q, kc, vc, kv_len, n_split, kt).to(q.dtype)


def decode_ratio(got, plain, dtype) -> float:
    """Largest error/limit of the decode (the split route's rule)."""
    p = plain.float().abs()
    lim = REL[dtype] * p + REL[dtype] * float(p.median())
    return float(((got.float() - plain.float()).abs() / lim).max())


def _decode_inputs(H, Hkv, kv_len, D, dtype, seed):
    """q (1, H, 1, D) and a (1, kv_len + 1, Hkv, D) cache with NaN at
    kv_len, in ``dtype`` (numpy f32 for the JAX side)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, H, 1, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((1, kv_len + 1, Hkv, D)).astype(np.float32)
              for _ in range(2))
    kc[:, kv_len:] = np.nan
    vc[:, kv_len:] = np.nan
    xs = (q, kc, vc)
    return xs, [torch.from_numpy(x).to(_t(dtype)) for x in xs]


DECODE_DIMS = (264, 512, 1024, 2048)
KV_LENS = (1, 65, 300)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv_len", KV_LENS)
@pytest.mark.parametrize("D", DECODE_DIMS)
def test_wide_split16_within_decode_limit(D, kv_len, dtype):
    """Gemma-2B's 8 q heads over 1 kv head: the emulated 16-bit wide split
    on the route the wrapper takes (no padding past a multiple of 8), at
    the kernel's n_split on 132 SMs and at one more than the filled
    64-key tiles (empty slices): finite despite the NaN at kv_len, within
    the split route's limit of the plain version."""
    assert A.takes_split(_t(dtype), D)
    _xs, (q, kc, vc) = _decode_inputs(8, 1, kv_len, D, dtype, 11 * kv_len + D)
    assert A._pad_d(q, kc, vc, split=True)[0].shape[-1] == D
    plain = A.flash_decode_ref(q, kc, vc, kv_len)
    for n_split in (A.decode_splits(1, 1, kc.shape[1], 132),
                    -(-kv_len // 64) + 1):
        got = wide_split16(q, kc, vc, kv_len, n_split)
        assert got.dtype == q.dtype and torch.isfinite(got).all()
        assert decode_ratio(got, plain, dtype) <= 1.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", DECODE_DIMS)
def test_wide_split16_against_jax(D, dtype):
    """The emulated 16-bit wide split against the JAX package's
    ``flash_decode`` on the same inputs (GQA 4/2 heads, kv_len 130, NaN
    past it): within two ulps of the output scale."""
    kv_len = 130
    xs, (q, kc, vc) = _decode_inputs(4, 2, kv_len, D, dtype, 17 + D)
    jx = [jnp.asarray(x).astype(getattr(jnp, dtype)) for x in xs]
    want = R.flash_decode(*jx, jnp.int32(kv_len))
    assert np.isfinite(np.asarray(want, np.float32)).all()
    n_split = A.decode_splits(1, 2, kc.shape[1], 132)
    _close(wide_split16(q, kc, vc, kv_len, n_split), want, dtype,
           f"{dtype} D={D} decode")


# ---- the constants, the routes, the counters -------------------------------


def test_emulated_constants_are_the_kernels():
    """The emulation's slice, q tile, units and limits are the kernels':
    ``CSL`` (the wrapper's COLS_CHUNK) columns a block, ``BQ`` rows a q
    tile, 16 units a thread dealt to block u % C, the cluster form up to
    ``BWD16_CLUSTER_MAX_D`` as the wrapper's, entered for head dims past
    256; the wide split's 16-byte columns a thread, its 64 KB stages
    (16384 / DP keys of 16 bits) and ``DECODE_SPLIT_MAX_D`` for every
    dtype."""
    bwd = (CSRC / "attention_bwd_sm90.cu").read_text()
    tile = (CSRC / "sm90_tile.cuh").read_text()
    dec = (CSRC / "attention_decode.cu").read_text()
    hdr = (CSRC / "attention_tile.cuh").read_text()
    fwd = (CSRC / "attention.cu").read_text()
    assert re.search(r"constexpr int CSL = (\d+);", bwd).group(1) == str(
        SLICE) == str(A.COLS_CHUNK)
    assert re.search(r"constexpr int BQ = (\d+);", tile).group(1) == str(TILE)
    assert "constexpr int CUNITS = BQ / 4;" in bwd
    assert "constexpr int BWD16_CLUSTER_MAX_D = 8 * CSL;" in bwd
    assert A.BWD16_CLUSTER_MAX_D == 8 * SLICE
    assert "if (head_dim > 256 && head_dim <= BWD16_CLUSTER_MAX_D)" in bwd
    assert "const int o = u % C;" in bwd and "if (u % C != rank)" in bwd
    assert "static constexpr int VEC = 16 / sizeof(T);" in dec
    assert "static constexpr int KT = 32768 / ROWB;" in dec
    assert all(32768 // (dp * 2) == 16384 // dp for dp in (512, 1024, 2048))
    assert re.search(r"constexpr int DECODE_SPLIT_MAX_D = (\d+);",
                     hdr).group(1) == str(A.DECODE_SPLIT_MAX_D)
    assert "if (s_new == 1 && head_dim <= DECODE_SPLIT_MAX_D)" in fwd


def test_split_counters_are_kept_per_stream():
    """``_split_counters`` gives two (device, stream) keys two tensors and
    one key the same tensor while it holds enough; a key that needs more
    gets a larger one and leaves the other key's alone."""
    dev = torch.device("cpu")
    keys = [(None, 0x1001), (None, 0x1002)]
    try:
        a = A._split_counters(keys[0], dev, 8)
        b = A._split_counters(keys[1], dev, 8)
        assert a is not b and a.data_ptr() != b.data_ptr()
        assert a.dtype == b.dtype == torch.int32 and not a.any()
        assert A._split_counters(keys[0], dev, 4) is a
        assert A._split_counters(keys[1], dev, 8) is b
        c = A._split_counters(keys[0], dev, 16)
        assert c is not a and c.numel() == 16 and not c.any()
        assert A._split_counters(keys[1], dev, 8) is b
    finally:
        for key in keys:
            A._SPLIT_COUNTERS.pop(key, None)
