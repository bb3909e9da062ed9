"""The f32 forward past head dim 256 on the CPU: the cluster form of B8,
B9 and the B12 chunks (``csrc/attention.cu``) and the wide split-KV
single-token decode (``csrc/attention_decode.cu``), emulated.

On the card, f32 B8, B9 and B12 chunks of S_new > 1 new tokens at 256 <
D <= 4096 run ``attn_fwd_cluster_kernel`` / ``attn_decode_cluster_kernel``:
a cluster of C = ceil(ceil(D / 64) / NS) blocks (NS = 2 slices a block to
D 1024, 4 to 2048, 8 to 4096) forms S = Q K^T once a 32-key tile, each
block adding its 64-column slices' 3xTF32 partials in slice order and the
owner of each position adding the C block partials in block order; every
block then runs the same online softmax on the same S and adds P V on its
own columns, each tile's keys in a fresh 3xTF32 sum (O = O * alpha + PV).
The emulation below follows that order with the slices and products of
``test_torch_attention_cols_tf32.py``. A single-token f32 decode up to
``DECODE_SPLIT_MAX_D`` runs ``attn_decode_split_wide_kernel``: the slices of
``decode_split_ranges``, each an online softmax over key tiles of 8192 /
DP keys in f32 (DP the column tier: 512, 1024, 2048), merged as a tree of
fan-in 8 (the last child of a node to finish merges its children in
order). Both are held to the f32 rule ``chip_smoke.py`` holds
the kernels to (ATTN_TOL's), per element of O and of the LSE,

    |got - plain| <= 2e-5 + 2e-5 * |plain|,

against the plain versions (``flash_attention_ref``, ``flash_decode_ref``)
and, at small sizes, against the JAX package's ``flash_attention`` and
``flash_decode`` (Pallas in interpret mode) on the same numpy inputs. The
kernels themselves run only on the card.
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
from test_torch_attention_bwd import _mm_tf32x3  # noqa: E402
from test_torch_attention_cols_tf32 import (  # noqa: E402
    TIERS, WIDTH, _blocks, _ns, _sliced)


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment."""
    yield


CSRC = Path(__file__).resolve().parent.parent / "accl_tpu_torch" / "csrc"
F32_TOL = 2e-5
KEY_TILE = 32      # the cluster form's key tile (attention.cu CBK)
NEG = torch.finfo(torch.float32).min
# each tier's first and last head dims, an odd slice count (264), and one
# live slice in the last block of the 4- and 8-slice tiers (1032, 2056)
DIMS = (264, 512, 1024, 1032, 2048, 2056, 4096)


def ratio(got, want) -> float:
    """Largest error/limit over the elements (the f32 rule)."""
    w = torch.from_numpy(np.array(want, np.float32))
    return float(((got.float() - w).abs() / (F32_TOL + F32_TOL * w.abs()))
                 .max())


def cluster_fwd(q, k, v, causal, off=0, order=None):
    """The cluster form on the CPU, the q heads of one kv head side by
    side (row g * Sq + i is query i of head g, at position off + i): S
    through ``_sliced`` (64-column 3xTF32 slices, NS to a block in slice
    order, the blocks in ``order``, block order when None), scaled; per
    32-key tile the masked scores at finfo(f32).min with p = 0, the
    online rescale, P V as one 3xTF32 product in a fresh sum added as O *
    alpha + PV; o = O / l with l floored at 1e-30. Returns (O (B, H, Sq,
    D), LSE (B*H, Sq))."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qf = q.reshape(B, Hkv, (H // Hkv) * Sq, D).float()
    vf = v.float()
    s_all = _sliced(qf, k.float(), order or list(range(_blocks(D))))
    s_all = s_all * D ** -0.5
    pos = torch.arange(qf.shape[2]) % Sq + off
    m = torch.full((*qf.shape[:3], 1), NEG)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for kt in range(0, Skv, KEY_TILE):
        keys = torch.arange(kt, min(kt + KEY_TILE, Skv))
        seen = (keys[None, :] <= pos[:, None] if causal
                else torch.ones(pos.numel(), keys.numel(), dtype=torch.bool))
        s = torch.where(seen, s_all[..., kt:kt + KEY_TILE], NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(seen, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm_tf32x3(p, vf[:, :, kt:kt + KEY_TILE])
        m = m_new
    l = l.clamp_min(1e-30)
    return (acc / l).reshape(q.shape), (m + torch.log(l)).reshape(B * H, Sq)


def cluster_prefill(q, kc, vc, kv_len, order=None):
    """B12 with S_new > 1 on the cluster form: the filled prefix, the
    bottom-right causal mask."""
    k, v = A.cache_prefix(kc, vc, kv_len)
    return cluster_fwd(q, k, v, True, kv_len - q.shape[2], order)[0]


# (B, H, Hkv, Sq, Skv, causal, block_k): B8 (more than one reference
# block: block_k 16, as chip_smoke's cases) causal and Sq != Skv
# unmasked, B9 (one block) causal and unmasked with GQA
SHAPES = {"b8-causal": (1, 2, 1, 80, 80, True, 16),
          "b8-full-sq48-skv72": (1, 4, 2, 48, 72, False, 16),
          "b9-causal-gqa": (1, 4, 1, 40, 40, True, None),
          "b9-full-sq24-skv56": (1, 2, 1, 24, 56, False, None)}
CASES = [(D, shape) for D in DIMS for shape in sorted(SHAPES)]


def _ids(case):
    return f"d{case[0]}-{case[1]}"


def _fwd_inputs(D, shape, seed):
    B, H, Hkv, Sq, Skv, causal, bk = SHAPES[shape]
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    return xs, [torch.from_numpy(x) for x in xs], causal, bk


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_cluster_fwd_emulation_within_f32_limit(case):
    """The emulated cluster form within the f32 limit of the plain forward
    for O and the LSE, and not equal to it (the limit is not vacuous); the
    shape dispatches to B8 or B9 as its name says."""
    D, shape = case
    _xs, (q, k, v), causal, bk = _fwd_inputs(D, shape, 900 + D)
    assert A.is_single_block(k.shape[2], bk) == shape.startswith("b9")
    o, lse = cluster_fwd(q, k, v, causal)
    po, plse = A.flash_attention_ref(q, k, v, causal)
    r = max(ratio(o, po), ratio(lse, plse))
    assert 0.0 < r <= 1.0, r


@pytest.mark.parametrize("D", DIMS)
def test_cluster_fwd_emulation_repeats_bitwise(D):
    """With the blocks summed in block order the emulation gives the same
    bits twice; in reverse block order it gives other bits, within the
    limit too: the order, which every owner of a position keeps, is what
    fixes them."""
    _xs, (q, k, v), causal, _bk = _fwd_inputs(D, "b8-causal", 1000 + D)
    first, again = cluster_fwd(q, k, v, causal), cluster_fwd(q, k, v, causal)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    rev = list(range(_blocks(D)))[::-1]
    other = cluster_fwd(q, k, v, causal, order=rev)
    assert not all(torch.equal(a, b) for a, b in zip(first, other))
    po, plse = A.flash_attention_ref(q, k, v, causal)
    assert max(ratio(other[0], po), ratio(other[1], plse)) <= 1.0


@pytest.mark.parametrize("case", [(D, s) for D in (264, 512)
                                  for s in sorted(SHAPES)], ids=_ids)
def test_cluster_fwd_against_jax(case):
    """At D 264 and 512 the emulation against the JAX package's
    ``flash_attention`` (O) and ``_fwd`` (LSE) on the same f32 inputs,
    within the f32 limit taken around the JAX outputs."""
    D, shape = case
    xs, (q, k, v), causal, bk = _fwd_inputs(D, shape, 1100 + D)
    Sq, Skv = SHAPES[shape][3:5]
    jq, jk, jv = (jnp.asarray(x) for x in xs)
    want = R.flash_attention(jq, jk, jv, causal=causal, block_k=bk)
    rbq = min(R._auto_block(Sq), max(Sq, 8))
    rbk = min(bk or R._auto_block(Skv), max(Skv, 8))
    fwd = jax.jit(R._fwd, static_argnums=(3, 4, 5, 6))
    want_lse = np.asarray(fwd(jq, jk, jv, causal, D ** -0.5, rbq,
                              rbk)[1])[..., 0][:, :Sq]
    o, lse = cluster_fwd(q, k, v, causal)
    assert ratio(o, want) <= 1.0
    assert ratio(lse, want_lse) <= 1.0


T = 3 * 64 + 8     # a cache of three 64-key tiles and a ragged tail


def _cache(B, H, Hkv, s_new, kv_len, D, seed):
    """q (B, H, S_new, D) and a (B, T, Hkv, D) cache with NaN at and past
    kv_len, as numpy f32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, s_new, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
              for _ in range(2))
    kc[:, kv_len:] = np.nan
    vc[:, kv_len:] = np.nan
    return q, kc, vc


# (S_new, kv_len): a whole prefill and chunks after a filled prefix, on
# either side of the key tile, to the cache's ragged end
PREFILL = ((5, 5), (5, 65), (33, 33), (33, 130), (40, T))


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("s_new,kv_len", PREFILL)
def test_cluster_prefill_emulation_within_f32_limit(s_new, kv_len, D):
    """B12 chunks (GQA 4/2 heads over a ragged cache, NaN past kv_len) on
    the emulated cluster form: finite and within the f32 limit of the
    plain version."""
    xs = _cache(1, 4, 2, s_new, kv_len, D, 37 * s_new + kv_len + D)
    q, kc, vc = (torch.from_numpy(x) for x in xs)
    o = cluster_prefill(q, kc, vc, kv_len)
    assert torch.isfinite(o).all()
    assert ratio(o, A.flash_decode_ref(q, kc, vc, kv_len)) <= 1.0


@pytest.mark.parametrize("D", (264, 512))
@pytest.mark.parametrize("s_new,kv_len", ((5, 65), (33, 130)))
def test_cluster_prefill_against_jax(s_new, kv_len, D):
    """The emulated chunk against the JAX package's ``flash_decode`` (NaN
    past kv_len), within the f32 limit taken around its output."""
    xs = _cache(1, 4, 2, s_new, kv_len, D, 53 * s_new + kv_len + D)
    q, kc, vc = (torch.from_numpy(x) for x in xs)
    want = np.asarray(R.flash_decode(*(jnp.asarray(x) for x in xs),
                                     jnp.int32(kv_len), block_k=32))
    assert np.isfinite(want).all()
    assert ratio(cluster_prefill(q, kc, vc, kv_len), want) <= 1.0


# ---- the wide split-KV decode ----------------------------------------------


def wide_tier(D: int) -> int:
    """The wide kernel's column tier at head dim D (512, 1024, 2048)."""
    return next(dp for dp in (512, 1024, 2048) if D <= dp)


MERGE_FAN = 8     # attention_decode.cu's merge tree


def merge_node(parts):
    """One node of the merge tree: children (m, l, acc) in order, M = max
    m_i, w_i = e^(m_i - M), (M, sum w_i l_i, sum w_i acc_i)."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - M) for m, _, _ in parts]
    return (M, sum(wi * l for wi, (_, l, _) in zip(w, parts)),
            sum(wi * acc for wi, (_, _, acc) in zip(w, parts)))


def wide_split(q, kc, vc, kv_len: int, n_split: int, kt: int | None = None):
    """The wide kernel's arithmetic on the CPU: each slice of
    ``decode_split_ranges(kv_len, n_split)`` runs its rows' online softmax
    in f32 over key tiles of ``kt`` keys (8192 / DP for f32; an empty
    slice: m = finfo.min, l = 0, acc = 0); then the merge tree, MERGE_FAN
    children a node (``merge_node``) up to the root, O = acc / max(l,
    1e-30) in f32."""
    B, H, _, D = q.shape
    Hkv = kc.shape[2]
    kt = kt or 8192 // wide_tier(D)
    k, v = A.cache_prefix(kc, vc, kv_len)
    qf = q.reshape(B, Hkv, H // Hkv, D).float()
    parts = []
    for lo, hi in A.decode_split_ranges(kv_len, n_split):
        m = torch.full((B, Hkv, H // Hkv, 1), NEG)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf)
        for t0 in range(lo, hi, kt):
            kk = k[:, :, t0:min(t0 + kt, hi)].float()
            s = torch.matmul(qf, kk.transpose(-1, -2)) * D ** -0.5
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.matmul(
                p, v[:, :, t0:t0 + kk.shape[2]].float())
            m = m_new
        parts.append((m, l, acc))
    while True:   # level by level; the root merges even a lone slice
        parts = [merge_node(parts[i:i + MERGE_FAN])
                 for i in range(0, len(parts), MERGE_FAN)]
        if len(parts) == 1:
            break
    _m, l, acc = parts[0]
    return (acc / l.clamp_min(1e-30)).reshape(B, H, 1, D)


KV_LENS = (1, 65, 300, 2047)
WIDE_DIMS = (264, 512, 1024)


def _decode_inputs(H, Hkv, kv_len, D, seed):
    """q (1, H, 1, D) and a (1, kv_len + 1, Hkv, D) cache with NaN at
    kv_len, as numpy f32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, H, 1, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((1, kv_len + 1, Hkv, D)).astype(np.float32)
              for _ in range(2))
    kc[:, kv_len:] = np.nan
    vc[:, kv_len:] = np.nan
    return q, kc, vc


@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("kv_len", KV_LENS)
def test_wide_split_emulation_within_f32_limit(kv_len, D):
    """Gemma-2B's 8 q heads over 1 kv head: the emulated wide split at the
    kernel's n_split on 132 SMs and at one more than the filled 64-key
    tiles (empty slices), finite despite the NaN at kv_len, within the f32
    limit of the plain version and not equal to it."""
    xs = _decode_inputs(8, 1, kv_len, D, 3 * kv_len + D)
    q, kc, vc = (torch.from_numpy(x) for x in xs)
    plain = A.flash_decode_ref(q, kc, vc, kv_len)
    T_ = kc.shape[1]
    rs = []
    for n_split in (A.decode_splits(1, 1, T_, 132), -(-kv_len // 64) + 1):
        got = wide_split(q, kc, vc, kv_len, n_split)
        assert torch.isfinite(got).all()
        rs.append(ratio(got, plain))
    assert max(rs) <= 1.0, rs
    assert kv_len == 1 or max(rs) > 0.0


@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("kv_len", KV_LENS)
def test_wide_split_against_jax(kv_len, D):
    """The emulated wide split against the JAX package's ``flash_decode``
    on the same inputs (GQA 4/2 heads), within the limit taken around the
    JAX output."""
    xs = _decode_inputs(4, 2, kv_len, D, 5 * kv_len + D)
    want = np.asarray(R.flash_decode(*(jnp.asarray(x) for x in xs),
                                     jnp.int32(kv_len)))
    assert np.isfinite(want).all()
    q, kc, vc = (torch.from_numpy(x) for x in xs)
    n_split = A.decode_splits(1, 2, kc.shape[1], 132)
    assert ratio(wide_split(q, kc, vc, kv_len, n_split), want) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("D", [256, 264, 512, 1024, 2048, 2056, 4096])
def test_wrapper_routes_the_single_token_decode(D, dtype):
    """Which kernel takes a single-token decode at the wrapper's head dim:
    the split-KV kernel for every dtype up to ``DECODE_SPLIT_MAX_D``
    (2048), the chunk's route at S_new = 1 past it; on the split route
    the head dim pads to a multiple of 8 for every dtype (the wide kernel
    takes any such D up to its tier), off it to 128 for 16 bits past
    256; the split route's workspace holds each row's n_split partials of
    D + 2 floats (acc, m, l)."""
    tdt = getattr(torch, dtype)
    split = A.takes_split(tdt, D)
    assert split == (D <= 2048)
    assert A.DECODE_SPLIT_MAX_D == 2048
    ops = [torch.zeros(1, 2, 1, D, dtype=tdt) for _ in range(3)]
    step = 128 if D > 256 and tdt != torch.float32 and not split else 8
    padded = A._pad_d(*ops, split=split)
    assert padded[0].shape[-1] == -(-D // step) * step
    A._kernel_ready("flash_decode", *padded, split=split)
    n_split = A.decode_splits(4, 1, 2048, 132)
    assert A.split_workspace_floats(4, 8, n_split, D) == 4 * 8 * n_split * (
        D + 2)


def test_emulated_constants_are_the_kernels():
    """The emulation's slices, tiers, key tiles and limits are the
    kernels': ``SL`` columns a slice and ``cluster_ns``'s tiers in
    ``attention_cluster.cuh``, C = ceil(ceil(D / SL) / NS) <= 8 blocks;
    the forward cluster's key tile ``CBK`` and its RK = 128 / NS rows in
    ``attention.cu``, whose B8, B9 and B12 entry points take the cluster
    form at ``cluster_form(D)``; the wide split's key tile 8192 / DP at
    tiers 512 to 2048 (f32 rows: ``ROWB`` = 4 DP bytes), its merge
    tree's fan-in and ``DECODE_SPLIT_MAX_D`` as the wrapper's."""
    hdr = (CSRC / "attention_cluster.cuh").read_text()
    fwd = (CSRC / "attention.cu").read_text()
    dec = (CSRC / "attention_decode.cu").read_text()
    tile = (CSRC / "attention_tile.cuh").read_text()
    assert re.search(r"constexpr int SL = (\d+),", hdr).group(1) == str(WIDTH)
    assert re.search(r"return D <= 8 \* 2 \* SL \? 2 : D <= 8 \* 4 \* SL \? 4 "
                     r": 8;", hdr)
    assert re.search(r"return D > 256 && D <= CLUSTER_MAX_D;", hdr)
    assert TIERS == tuple((8 * ns * WIDTH, ns) for ns in (2, 4, 8))
    assert all(_blocks(D) <= 8 and _ns(D) in (2, 4, 8) for D in DIMS)
    assert re.search(r"constexpr int CBK = (\d+);", fwd).group(1) == str(
        KEY_TILE)
    assert "static constexpr int RK = 128 / NS;" in fwd
    assert fwd.count("if (cluster_form(head_dim))") == 2   # B8, B9
    assert "if (s_new > 1 && cluster_form(head_dim))" in fwd  # B12 chunks
    assert "static constexpr int KT = 32768 / ROWB;" in dec
    assert "static constexpr int ROWB = DP * sizeof(T);" in dec
    assert re.search(r"constexpr int MERGE_FAN = (\d+);", dec).group(1) == str(
        MERGE_FAN)
    assert re.search(r"launch_wide<512>.*launch_wide<1024>.*"
                     r"launch_wide<2048>", dec, re.S)
    assert re.search(r"constexpr int DECODE_SPLIT_MAX_D = (\d+);",
                     tile).group(1) == str(A.DECODE_SPLIT_MAX_D)
    assert wide_tier(A.DECODE_SPLIT_MAX_D) == A.DECODE_SPLIT_MAX_D
