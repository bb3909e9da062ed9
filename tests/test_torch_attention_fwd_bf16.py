"""The bf16 route of the attention forward (B8, B9, and B12 with S_new >
1) against its limit, on the CPU.

On the card, bf16 B8, bf16 B9 and bf16 B12 chunks of S_new > 1 new
tokens run on the tensor cores (``csrc/attention_sm90.cu``), which round
the f32
probabilities P to bf16 (round to nearest even) as the first operand of
P V, with the row sum l taken from the f32 P. The kernels run only on the
card; the tests below emulate that rounding on the CPU and hold the
emulation to the limit ``chip_smoke.py`` holds the kernels to, per
element, with m the magnitude of the rounded sum
(``fwd_rounding_magnitudes``, m_i = sum_j p_ij |v_j| / l_i):

    |got - plain| <= 2^-8 * m + 2^-7 * |plain| + 2^-7 * median|plain|

A rounding moves each term p * v by less than 2^-8 of its magnitude
(bf16 keeps 8 significant bits); the last two terms are the bf16 output
limit of the forward (one bf16 ulp of the element, floored at one ulp
of the typical output). The plain versions are ``flash_attention_ref``
and ``flash_decode_ref``; the JAX package's ``flash_attention`` and
``flash_decode`` (Pallas in interpret mode, as ``test_ops.py`` runs
them) stand beside them under the same limit.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from accl_tpu.ops import attention as R  # noqa: E402
from accl_tpu_torch.ops import attention as A  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


MARGIN = 2.0 ** -8     # P's rounding: each term moves by < 2^-8 of itself
BF16_REL = 2.0 ** -7   # one bf16 ulp of the element and of the median

# (B, H, Hkv, Sq, Skv, D, causal)
FWD = {
    "mha-causal-d16": (1, 4, 4, 80, 80, 16, True),
    "mha-d32": (1, 4, 4, 80, 80, 32, False),
    "gqa-causal-ragged130-d64": (1, 8, 2, 130, 130, 64, True),
    "gqa-ragged130-d64": (1, 8, 2, 130, 130, 64, False),
    "mqa-causal-d128": (1, 8, 1, 96, 96, 128, True),
    "mqa-ragged70-d128": (2, 4, 1, 70, 70, 128, False),
    "gqa-causal-sq40-skv96": (2, 4, 2, 40, 96, 16, True),
    "gqa-sq96-skv40": (1, 4, 2, 96, 40, 32, False),
}

T = 3 * 64 + 8   # cache length: three key tiles and a ragged tail
# (S_new, kv_len): a whole prefill (kv_len = S_new) and chunks after a
# filled prefix (kv_len > S_new), around one key tile and at T
PREFILL = sorted({(s, n) for s in (3, 64, 65) for n in (s, 63, 64, 65, T)
                  if n >= s})


def limit(plain, mag):
    """The bf16 route's per-element limit (module docstring)."""
    p = plain.float().abs()
    return MARGIN * mag + BF16_REL * p + BF16_REL * float(p.median())


def ratio(got, plain, mag) -> float:
    """Largest error/limit over the elements."""
    return float(((got.float() - plain.float()).abs()
                  / limit(plain, mag)).max())


def emulate(q, k, v, causal, off=0):
    """The bf16 route on the CPU: the plain forward's f32 P rounded to
    bf16 before P V, l from the f32 P; O in q's dtype."""
    scale = q.shape[-1] ** -0.5
    _m, p, l, vf = A._fwd_parts(q, k, v, causal, scale, off)
    o = torch.matmul(p.bfloat16().float(), vf) / l
    return o.reshape(q.shape).to(q.dtype)


def _fwd_inputs(case):
    B, H, Hkv, Sq, Skv, D, causal = FWD[case]
    rng = np.random.default_rng(sorted(FWD).index(case) + 300)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    return xs, causal


def _fwd_case(case):
    """bf16 q, k, v, the emulation, the plain O and the magnitudes."""
    xs, causal = _fwd_inputs(case)
    q, k, v = (torch.from_numpy(x).bfloat16() for x in xs)
    plain = A.flash_attention_ref(q, k, v, causal)[0]
    mag = A.fwd_rounding_magnitudes(q, k, v, causal)
    return xs, emulate(q, k, v, causal), plain, mag


def _prefill_inputs(s_new, kv_len, D=32):
    """q (2, 8, S_new, D) and a (2, T, 2, D) cache with NaN at and past
    kv_len, as numpy f32."""
    rng = np.random.default_rng(1000 * s_new + kv_len)
    q = rng.standard_normal((2, 8, s_new, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, T, 2, D)).astype(np.float32)
              for _ in range(2))
    kc[:, kv_len:] = np.nan
    vc[:, kv_len:] = np.nan
    return q, kc, vc


def _prefill_case(s_new, kv_len):
    xs = _prefill_inputs(s_new, kv_len)
    q, kc, vc = (torch.from_numpy(x).bfloat16() for x in xs)
    k, v = A.cache_prefix(kc, vc, kv_len)
    off = kv_len - s_new
    plain = A.flash_decode_ref(q, kc, vc, kv_len)
    mag = A.fwd_rounding_magnitudes(q, k, v, True, None, off)
    return xs, emulate(q, k, v, True, off), plain, mag


@pytest.mark.parametrize("case", sorted(FWD))
def test_fwd_emulation_within_limit(case):
    """(a) B8: the emulated bf16 route within the limit of the plain
    forward, and not equal to it (the rounding shows)."""
    _xs, emu, plain, mag = _fwd_case(case)
    assert emu.dtype == torch.bfloat16 and emu.shape == plain.shape
    r = ratio(emu, plain, mag)
    assert 0.0 < r <= 1.0, r


@pytest.mark.parametrize("s_new,kv_len", PREFILL)
def test_prefill_emulation_within_limit(s_new, kv_len):
    """(a) B12 with S_new > 1, bottom-right causal over a part-full cache
    with NaN past kv_len: the emulation within the limit of the plain
    version, finite."""
    _xs, emu, plain, mag = _prefill_case(s_new, kv_len)
    assert torch.isfinite(emu).all() and torch.isfinite(mag).all()
    assert ratio(emu, plain, mag) <= 1.0


@pytest.mark.parametrize("case", sorted(FWD))
def test_fwd_limit_catches_a_moved_element(case):
    """(b) An element of the emulated output moved by 4 * 2^-8 * m, away
    from the plain value, fails the limit: at the element of largest m
    and at the element of median m among those where m is more than
    twice median|plain| (there 4 * 2^-8 * m exceeds 2^-8 * m + 2^-7 *
    |plain| + 2^-7 * median|plain|, since m >= |plain|)."""
    _xs, emu, plain, mag = _fwd_case(case)
    med = float(plain.float().abs().median())
    flat_mag = mag.reshape(-1)
    cand = torch.nonzero(flat_mag > 2 * med).reshape(-1)
    assert cand.numel() > 0
    order = cand[torch.argsort(flat_mag[cand])]
    for flat in (int(flat_mag.argmax()), int(order[order.numel() // 2])):
        moved = emu.float().clone().reshape(-1)
        side = 1.0 if moved[flat] >= plain.float().reshape(-1)[flat] else -1.0
        moved[flat] += side * 4 * MARGIN * float(flat_mag[flat])
        assert ratio(moved.reshape(emu.shape), plain, mag) > 1.0, (case, flat)


@pytest.mark.parametrize("off", [0, 3])
def test_rounding_magnitudes_brute_force(off):
    """(c) ``fwd_rounding_magnitudes`` against sum_j p_ij |v_j| / l_i
    written out term by term on a small GQA causal case (off 0: B8's
    mask; off 3: a chunk after 3 cached keys), rtol 1e-5, atol 1e-6 (f32
    against f64 sums of 5-8 terms)."""
    rng = np.random.default_rng(11 + off)
    B, H, Hkv, Sq, D = 1, 4, 2, 5, 16
    Skv = Sq + off
    q = torch.from_numpy(rng.standard_normal((B, H, Sq, D))).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, Skv, D)))
            .bfloat16() for _ in range(2))
    scale = D ** -0.5
    got = A.fwd_rounding_magnitudes(q, k, v, True, scale, off)
    qd, kd, vd = (t.double() for t in (q, k, v))
    want = torch.zeros(B, H, Sq, D, dtype=torch.float64)
    for h in range(H):
        kv = h // (H // Hkv)
        for i in range(Sq):
            seen = range(i + off + 1)
            s = [float(qd[0, h, i] @ kd[0, kv, j]) * scale for j in seen]
            mx = max(s)
            p = [np.exp(x - mx) for x in s]
            for j, pj in zip(seen, p):
                want[0, h, i] += pj * vd[0, kv, j].abs()
            want[0, h, i] /= sum(p)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want.float(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(FWD))
def test_fwd_emulation_against_jax(case):
    """(d) The emulated B8 route against the JAX package's
    ``flash_attention`` on the same bf16 inputs, within the limit taken
    around the JAX output."""
    xs, emu, _plain, mag = _fwd_case(case)
    causal = FWD[case][6]
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in xs)
    want = torch.from_numpy(np.array(
        R.flash_attention(jq, jk, jv, causal=causal).astype(jnp.float32)))
    assert ratio(emu, want, mag) <= 1.0


@pytest.mark.parametrize("s_new,kv_len", [(3, 3), (3, 65), (64, 64),
                                          (64, T), (65, 65), (65, T)])
def test_prefill_emulation_against_jax(s_new, kv_len):
    """(d) The emulated B12 prefill route against the JAX package's
    ``flash_decode`` (NaN past kv_len), within the limit taken around the
    JAX output."""
    xs, emu, _plain, mag = _prefill_case(s_new, kv_len)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in xs)
    want = torch.from_numpy(np.array(R.flash_decode(
        jq, jk, jv, jnp.int32(kv_len), block_k=32).astype(jnp.float32)))
    assert torch.isfinite(want).all()
    assert ratio(emu, want, mag) <= 1.0


def test_route_counters_stay_zero_on_the_cpu():
    """The tensor-core route's counters count launches on the card only:
    the CPU runs the plain versions under their own branch counts."""
    xs, causal = _fwd_inputs("gqa-causal-sq40-skv96")
    q, k, v = (torch.from_numpy(x).bfloat16() for x in xs)
    before = (A.fwd_wgmma_launches, A.prefill_wgmma_launches,
              dict(A.plain_runs))
    A.flash_attention_fwd(q, k, v, causal, block_k=32)   # B8, not B9
    pq, kc, vc = (torch.from_numpy(x).bfloat16()
                  for x in _prefill_inputs(64, 65))
    A.flash_decode(pq, kc, vc, 65)
    assert (A.fwd_wgmma_launches, A.prefill_wgmma_launches) == before[:2]
    ran = {key: A.plain_runs[key] - before[2][key] for key in before[2]}
    assert ran == {"fwd": 1, "fwd_single": 0, "bwd_dkv": 0, "bwd_dq": 0,
                   "decode": 1}


# B9: one key block under the reference's rule (Skv <= 128, 256 or 512 by
# _auto_block and its clamp, or an explicit block_k): (B, H, Hkv, Sq, Skv,
# D, causal, block_k)
SINGLE = {
    "mha-causal-40-d64": (1, 4, 4, 40, 40, 64, True, None),
    "gqa-causal-128-d32": (1, 8, 2, 128, 128, 32, True, None),
    "mqa-130-bk256-d16": (1, 8, 1, 130, 130, 16, False, 256),
    "gqa-causal-256-d16": (2, 4, 2, 256, 256, 16, True, None),
    "mqa-causal-sq96-skv40-d128": (1, 4, 1, 96, 40, 128, True, None),
    "gqa-sq40-skv256-d32": (1, 4, 2, 40, 256, 32, False, None),
}
KEY_TILE = 64    # the kernel's key tile (csrc/sm90_tile.cuh BKV)


def emulate_single(q, k, v, causal):
    """B9's tensor-core route on the CPU, pass by pass over 64-key tiles:
    pass 1 takes each row's max over every visible key; pass 2 walks the
    tiles backwards with that final max, p = exp(s - m) in f32 (0 where
    the mask hides the pair), l summed from the f32 p, O += P V with P
    rounded to bf16. The q heads of one kv head side by side, as
    ``_fwd_parts``. Returns (O in q's dtype, LSE (B*H, Sq) f32)."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qf = q.reshape(B, Hkv, (H // Hkv) * Sq, D).float()
    s = torch.matmul(qf, k.float().transpose(-1, -2)) * D ** -0.5
    rows = torch.arange(qf.shape[2]) % Sq
    keys = torch.arange(Skv)
    mask = (keys[None, :] <= rows[:, None] if causal
            else torch.ones(rows.numel(), Skv, dtype=torch.bool))
    s = torch.where(mask, s, torch.finfo(torch.float32).min)
    tiles = [slice(j, j + KEY_TILE) for j in range(0, Skv, KEY_TILE)]
    m = torch.full((*s.shape[:-1], 1), torch.finfo(torch.float32).min)
    for t in tiles:                                    # pass 1
        m = torch.maximum(m, s[..., t].amax(-1, keepdim=True))
    acc = torch.zeros(*s.shape[:-1], D)
    l = torch.zeros_like(m)
    for t in reversed(tiles):                          # pass 2
        p = torch.where(mask[:, t], torch.exp(s[..., t] - m), 0.0)
        l = l + p.sum(-1, keepdim=True)
        acc = acc + torch.matmul(p.bfloat16().float(), v[:, :, t].float())
    l = l.clamp_min(1e-30)
    o = (acc / l).reshape(q.shape).to(q.dtype)
    return o, (m + torch.log(l)).reshape(B * H, Sq)


def _single_case(case):
    B, H, Hkv, Sq, Skv, D, causal, bk = SINGLE[case]
    rng = np.random.default_rng(sorted(SINGLE).index(case) + 500)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    q, k, v = (torch.from_numpy(x).bfloat16() for x in xs)
    return xs, q, k, v, causal, bk


@pytest.mark.parametrize("case", sorted(SINGLE))
def test_single_emulation_within_limit(case):
    """(a) B9: the emulated two-pass route within the forward's limit of
    the plain version, not equal to it (the rounding shows), its LSE
    within 2e-5 + 2e-5 * |lse|; the case is one key block."""
    _xs, q, k, v, causal, bk = _single_case(case)
    assert A.is_single_block(k.shape[2], bk)
    plain, plain_lse = A.flash_attention_ref(q, k, v, causal)
    mag = A.fwd_rounding_magnitudes(q, k, v, causal)
    emu, lse = emulate_single(q, k, v, causal)
    assert emu.dtype == torch.bfloat16 and emu.shape == plain.shape
    assert 0.0 < ratio(emu, plain, mag) <= 1.0
    assert float(((lse - plain_lse).abs()
                  / (2e-5 + 2e-5 * plain_lse.abs())).max()) <= 1.0


@pytest.mark.parametrize("case", sorted(SINGLE))
def test_single_emulation_against_jax(case):
    """(d) The emulated B9 route against the JAX package's
    ``flash_attention`` on the same bf16 inputs, whose one-block shapes
    run ``_fwd_kernel_single`` (Pallas in interpret mode), within the
    limit taken around the JAX output."""
    xs, q, k, v, causal, bk = _single_case(case)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in xs)
    want = torch.from_numpy(np.array(R.flash_attention(
        jq, jk, jv, causal=causal, block_k=bk).astype(jnp.float32)))
    mag = A.fwd_rounding_magnitudes(q, k, v, causal)
    assert ratio(emulate_single(q, k, v, causal)[0], want, mag) <= 1.0


def test_single_and_split_counters_stay_zero_on_the_cpu():
    """B9's tensor-core counter and the split decode's count launches on
    the card only: the CPU runs the plain versions under their own
    branch counts."""
    _xs, q, k, v, causal, bk = _single_case("gqa-causal-128-d32")
    pq, kc, vc = (torch.from_numpy(x).bfloat16()[:, :, :1] if i == 0 else
                  torch.from_numpy(x).bfloat16()
                  for i, x in enumerate(_prefill_inputs(3, 65)))
    before = (A.fwd_single_wgmma_launches, A.decode_split_launches,
              dict(A.plain_runs))
    A.flash_attention_fwd(q, k, v, causal, block_k=bk)     # B9
    A.flash_decode(pq, kc, vc, 65)                          # one new token
    assert (A.fwd_single_wgmma_launches,
            A.decode_split_launches) == before[:2]
    ran = {key: A.plain_runs[key] - before[2][key] for key in before[2]}
    assert ran == {"fwd": 0, "fwd_single": 1, "bwd_dkv": 0, "bwd_dq": 0,
                   "decode": 1}
