"""The split-KV single-token decode (B12 with S_new == 1) on the CPU.

On the card, every single-token ``flash_decode`` runs
``attn_decode_split_kernel`` (``csrc/attention_decode.cu``): the filled
prefix is cut into ``decode_splits(B, Hkv, T, sm_count)`` slices by the
rule of ``decode_split_ranges``; each slice's block computes its (m, l,
acc) in f32, and the last block to finish merges them: M = max m_s, O =
sum e^(m_s - M) acc_s / max(sum e^(m_s - M) l_s, 1e-30). The kernel runs
only on the card; the tests below emulate that arithmetic in plain
PyTorch and hold the emulation to the limits ``chip_smoke.py`` holds the
kernel to, per element, against ``flash_decode_ref`` and against the JAX
package's ``flash_decode`` (Pallas in interpret mode, as ``test_ops.py``
runs it), on inputs made from one numpy seed:

    f32:  |got - plain| <= 2e-5 + 2e-5 * |plain|
    bf16: |got - plain| <= 2^-7 * |plain| + 2^-7 * median|plain|

Nothing is rounded to bf16 before the output (only the summation order
differs), so these are the decode limits of the CUDA-core route.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from accl_tpu.ops import attention as R  # noqa: E402
from accl_tpu_torch.ops import attention as A  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


NEG = torch.finfo(torch.float32).min
T = 3 * 64 + 8    # cache length: three key tiles and a ragged tail


def limit(plain):
    """The decode route's per-element limit (module docstring)."""
    p = plain.float().abs()
    if plain.dtype == torch.bfloat16:
        return 2.0 ** -7 * p + 2.0 ** -7 * float(p.median())
    return 2e-5 + 2e-5 * p


def ratio(got, plain) -> float:
    """Largest error/limit over the elements."""
    return float(((got.float() - plain.float()).abs() / limit(plain)).max())


def emulate(q, k_cache, v_cache, kv_len: int, n_split: int):
    """The split kernel's arithmetic on the CPU: (m, l, acc) of each slice
    of ``decode_split_ranges(kv_len, n_split)`` in f32 (an empty slice:
    m = finfo.min, l = 0, acc = 0), then the combine; O in q's dtype."""
    B, H, _, D = q.shape
    Hkv = k_cache.shape[2]
    k, v = A.cache_prefix(k_cache, v_cache, kv_len)      # (B, Hkv, n, D)
    qf = q.reshape(B, Hkv, H // Hkv, D).float()
    parts = []
    for lo, hi in A.decode_split_ranges(kv_len, n_split):
        if hi == lo:
            shape = (B, Hkv, H // Hkv, 1)
            parts.append((torch.full(shape, NEG), torch.zeros(shape),
                          torch.zeros(B, Hkv, H // Hkv, D)))
            continue
        s = torch.matmul(qf, k[:, :, lo:hi].float().transpose(-1, -2))
        s = s * D ** -0.5
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.matmul(p, v[:, :, lo:hi].float())))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - M) for m, _, _ in parts]
    den = sum(wi * l for wi, (_, l, _) in zip(w, parts)).clamp_min(1e-30)
    o = sum(wi * acc for wi, (_, _, acc) in zip(w, parts)) / den
    return o.reshape(B, H, 1, D).to(q.dtype)


def _inputs(B, H, Hkv, kv_len, D, seed):
    """q (B, H, 1, D) and a (B, T, Hkv, D) cache with NaN at and past
    kv_len, as numpy f32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
              for _ in range(2))
    kc[:, kv_len:] = np.nan
    vc[:, kv_len:] = np.nan
    return q, kc, vc


# (B, H, Hkv) for MHA, GQA (groups 2 and 4) and MQA
HEADS = {"mha": (1, 4, 4), "gqa2": (2, 6, 3), "gqa4": (2, 8, 2),
         "mqa": (1, 8, 1)}
KV_LENS = (1, 63, 64, 65, 130, T)
# splits from one to more than the filled 64-key tiles (T has 4)
SPLITS = (1, 2, 3, 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", KV_LENS)
@pytest.mark.parametrize("heads", sorted(HEADS))
def test_emulation_within_limit(heads, kv_len, dtype):
    """Every n_split (some with empty slices) and a D per case from 16 to
    128: the emulated split decode within the decode limit of the plain
    version, finite despite the NaN past kv_len."""
    B, H, Hkv = HEADS[heads]
    D = (16, 32, 64, 128)[(KV_LENS.index(kv_len) + sorted(HEADS).index(
        heads)) % 4]
    xs = _inputs(B, H, Hkv, kv_len, D, 7 * kv_len + D)
    q, kc, vc = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs)
    plain = A.flash_decode_ref(q, kc, vc, kv_len)
    for n_split in SPLITS:
        got = emulate(q, kc, vc, kv_len, n_split)
        assert got.dtype == q.dtype and torch.isfinite(got).all()
        assert ratio(got, plain) <= 1.0, (n_split, ratio(got, plain))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len,D,heads", [
    (1, 16, "gqa4"), (63, 32, "mqa"), (65, 64, "mha"), (130, 128, "gqa2"),
    (T, 64, "gqa4")])
def test_emulation_against_jax(kv_len, D, heads, dtype):
    """The emulation (the kernel's n_split on 132 SMs, and one more than
    the filled tiles) against the JAX package's ``flash_decode`` on the
    same inputs, within the limit taken around the JAX output."""
    B, H, Hkv = HEADS[heads]
    xs = _inputs(B, H, Hkv, kv_len, D, 100 + kv_len)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = R.flash_decode(*(jnp.asarray(x).astype(jdt) for x in xs),
                          jnp.int32(kv_len), block_k=32)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(tdt)
    assert torch.isfinite(want).all()
    q, kc, vc = (torch.from_numpy(x).to(tdt) for x in xs)
    for n_split in (A.decode_splits(B, Hkv, T, 132), -(-kv_len // 64) + 1):
        assert ratio(emulate(q, kc, vc, kv_len, n_split), want) <= 1.0


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 64), Hkv=st.integers(1, 16),
       T_=st.integers(1, 40_000), sm=st.integers(1, 264),
       frac=st.floats(0.0, 1.0))
def test_ranges_cover_the_prefix_once(B, Hkv, T_, sm, frac):
    """For every shape and SM count, the slices of ``decode_splits``'s
    n_split cover [0, kv_len) exactly once, in order, for any kv_len <=
    T; each non-empty slice starts on a 64-key boundary."""
    n_split = A.decode_splits(B, Hkv, T_, sm)
    kv_len = max(1, round(frac * T_))
    ranges = A.decode_split_ranges(kv_len, n_split)
    assert len(ranges) == n_split
    pos = 0
    for lo, hi in ranges:
        assert lo <= hi
        if hi > lo:
            assert lo == pos and lo % A.SPLIT_TILE == 0
            pos = hi
    assert pos == kv_len


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 64), Hkv=st.integers(1, 16),
       T_=st.integers(1, 40_000), sm=st.integers(1, 264))
def test_decode_splits_geometry(B, Hkv, T_, sm):
    """n_split fills at most one wave (four blocks an SM), covers the SMs
    at least twice unless the cache's 64-key tiles cap it, and leaves
    every slice room for a tile."""
    n = A.decode_splits(B, Hkv, T_, sm)
    tiles = -(-T_ // 64)
    assert 1 <= n <= tiles
    assert n == 1 or n * B * Hkv <= 4 * sm
    assert n * B * Hkv >= 2 * sm or n == tiles


def test_decode_splits_does_not_depend_on_kv_len():
    """The launch geometry is a function of B, Hkv, T and the SM count
    alone: kv_len is no argument, so a step's grid is the same at every
    fill length (a device-side kv_len changes only where the kernel reads
    it)."""
    assert list(inspect.signature(A.decode_splits).parameters) == [
        "B", "Hkv", "T", "sm_count"]
    assert A.decode_splits(4, 8, 1056, 132) == 16   # the serving step
    assert A.decode_splits(4, 8, 4096, 132) == 16


def test_split_counters_stay_zero_on_the_cpu():
    """A CPU decode runs the plain version: the split route's counter and
    ``last_decode_splits`` do not move."""
    xs = _inputs(2, 8, 2, 65, 32, 3)
    q, kc, vc = (torch.from_numpy(x) for x in xs)
    before = (A.decode_split_launches, A.decode_launches, A.last_decode_splits,
              A.plain_runs["decode"])
    out = A.flash_decode(q, kc, vc, 65)
    assert torch.equal(out, A.flash_decode_ref(q, kc, vc, 65))
    assert (A.decode_split_launches, A.decode_launches,
            A.last_decode_splits) == before[:3]
    assert A.plain_runs["decode"] == before[3] + 1
