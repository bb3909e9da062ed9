"""The f32 route of the attention forward (B8, B9, and B12 with S_new >
1) against the f32 limit, on the CPU.

On the card, f32 B8, f32 B9 and f32 B12 chunks of S_new > 1 new tokens
run one tile (``flash_tile`` of ``csrc/attention.cu``) on the TF32
tensor cores: every f32 operand (Q, K, V and the probabilities P) is
split into hi = tf32(a) and lo = tf32(a - hi), and each product is
formed as lo*hi + hi*lo + hi*hi in f32 (3xTF32). The keys stream in
tiles of ``KEY_TILE``; each tile's scores and each tile's P V start in a
fresh sum, and the running output takes O = O * alpha + PV in f32 (the
online softmax). The kernels run only on the card; the tests below
emulate that arithmetic on the CPU, with the helpers of
``test_torch_attention_bwd.py``, and hold it to the limit
``chip_smoke.py`` holds the kernels to (ATTN_TOL's f32 rule), per
element of O and of the LSE:

    |got - plain| <= 2e-5 + 2e-5 * |plain|

against the plain versions (``flash_attention_ref``,
``flash_decode_ref``) and the JAX package's ``flash_attention`` and
``flash_decode`` (Pallas in interpret mode, as ``test_ops.py`` runs
them). One TF32 product a product breaks that limit.
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
from test_torch_attention_bwd import _mm_tf32x1, _mm_tf32x3  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


F32_TOL = 2e-5
KEY_TILE = 32   # csrc/attention.cu FWD_BK
NEG = torch.finfo(torch.float32).min
SRC = (Path(__file__).resolve().parent.parent / "accl_tpu_torch" / "csrc"
       / "attention.cu")


def emulate(q, k, v, causal, off=0, mm=_mm_tf32x3, tile=KEY_TILE):
    """The f32 route on the CPU, key tile by key tile, the q heads of one
    kv head side by side (row g * Sq + i is query i of head g, at
    position off + i): S = Q K^T through ``mm`` in a fresh sum, scaled;
    masked scores at finfo(f32).min with p = 0; the online rescale; P V
    through ``mm`` in a fresh sum, added as O * alpha + PV; o = O / l with
    l floored at 1e-30. Returns (O (B, H, Sq, D), LSE (B*H, Sq))."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qf = q.reshape(B, Hkv, (H // Hkv) * Sq, D).float()
    pos = torch.arange(qf.shape[2]) % Sq + off
    m = torch.full((*qf.shape[:3], 1), NEG)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for kt in range(0, Skv, tile):
        kk = k[:, :, kt:kt + tile].float()
        vv = v[:, :, kt:kt + tile].float()
        keys = torch.arange(kt, kt + kk.shape[2])
        seen = (keys[None, :] <= pos[:, None] if causal
                else torch.ones(pos.numel(), keys.numel(), dtype=torch.bool))
        s = torch.where(seen, mm(qf, kk.transpose(-1, -2)) * D ** -0.5, NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(seen, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vv)
        m = m_new
    l = l.clamp_min(1e-30)
    return (acc / l).reshape(q.shape), (m + torch.log(l)).reshape(B * H, Sq)


def ratio(got, want) -> float:
    """Largest error/limit over the elements (f32 rule)."""
    w = torch.from_numpy(np.array(want, np.float32))
    return float(((got.float() - w).abs() / (F32_TOL + F32_TOL * w.abs()))
                 .max())


# (B, H, Hkv, Sq, Skv, D, causal, block_k): B8 (more than one reference
# block) and B9 (one block), MHA/GQA/MQA, D 16-128, ragged lengths, Sq !=
# Skv both ways, and one block of 4096 keys (block_k = 4096: the f32 B9
# tile streams its keys, so the block has no length limit)
CASES = {
    "b8-mha-causal-d16": (1, 4, 4, 300, 300, 16, True, 128),
    "b8-mha-d32": (1, 4, 4, 130, 130, 32, False, None),
    "b8-gqa-causal-ragged130-d64": (1, 8, 2, 130, 130, 64, True, 32),
    "b8-mqa-ragged513-d128": (1, 4, 1, 513, 513, 128, False, None),
    "b8-gqa-causal-sq40-skv96": (2, 4, 2, 40, 96, 16, True, 32),
    "b8-gqa-sq96-skv40": (1, 4, 2, 96, 40, 32, False, 32),
    "b9-mha-causal-40-d64": (1, 4, 4, 40, 40, 64, True, None),
    "b9-gqa-causal-128-d32": (1, 8, 2, 128, 128, 32, True, None),
    "b9-mqa-130-bk256-d16": (1, 8, 1, 130, 130, 16, False, 256),
    "b9-mqa-causal-sq96-skv40-d128": (1, 4, 1, 96, 40, 128, True, None),
    "b9-gqa-sq40-skv256-d32": (1, 4, 2, 40, 256, 32, False, None),
    "b9-gqa-4096-bk4096-d32": (1, 4, 2, 64, 4096, 32, False, 4096),
    "b9-mqa-causal-4096-bk4096-d16": (1, 2, 1, 4096, 4096, 16, True, 4096),
}

T = 3 * 64 + 8   # cache length: 6 key tiles and a ragged tail
# (S_new, kv_len): a whole prefill (kv_len = S_new) and chunks after a
# filled prefix, around the key tile and at T
PREFILL = sorted({(s, n) for s in (3, 32, 33, 65)
                  for n in (s, 31, 32, 33, 65, T) if n >= s})


def _case(case):
    B, H, Hkv, Sq, Skv, D, causal, bk = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 700)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    return xs, [torch.from_numpy(x) for x in xs], causal, bk


def _prefill(s_new, kv_len, D=32):
    """q (2, 8, S_new, D) and a (2, T, 2, D) cache with NaN at and past
    kv_len, as numpy f32."""
    rng = np.random.default_rng(1000 * s_new + kv_len + 7)
    q = rng.standard_normal((2, 8, s_new, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, T, 2, D)).astype(np.float32)
              for _ in range(2))
    kc[:, kv_len:] = np.nan
    vc[:, kv_len:] = np.nan
    return q, kc, vc


def _emulate_prefill(q, kc, vc, kv_len, mm=_mm_tf32x3):
    k, v = A.cache_prefix(kc, vc, kv_len)
    return emulate(q, k, v, True, kv_len - q.shape[2], mm)[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_fwd_emulation_within_f32_limit(case):
    """The emulated route (B8 and B9) within the f32 limit of the plain
    forward, O and LSE, and not equal to it (the limit is not vacuous);
    the case dispatches as its name says."""
    _xs, (q, k, v), causal, bk = _case(case)
    assert A.is_single_block(k.shape[2], bk) == case.startswith("b9")
    o, lse = emulate(q, k, v, causal)
    po, plse = A.flash_attention_ref(q, k, v, causal)
    r = max(ratio(o, po), ratio(lse, plse))
    assert 0.0 < r <= 1.0, r


@pytest.mark.parametrize("case", sorted(CASES))
def test_fwd_emulation_against_jax(case):
    """The emulated route against the JAX package's ``flash_attention``
    (O) and ``_fwd`` (LSE) on the same f32 inputs, within the f32 limit
    taken around the JAX outputs."""
    xs, (q, k, v), causal, bk = _case(case)
    B, H, Hkv, Sq, Skv, D = CASES[case][:6]
    jq, jk, jv = (jnp.asarray(x) for x in xs)
    want = R.flash_attention(jq, jk, jv, causal=causal, block_k=bk)
    rbq = min(R._auto_block(Sq), max(Sq, 8))
    rbk = min(bk or R._auto_block(Skv), max(Skv, 8))
    fwd = jax.jit(R._fwd, static_argnums=(3, 4, 5, 6))
    want_lse = np.asarray(fwd(jq, jk, jv, causal, D ** -0.5, rbq,
                              rbk)[1])[..., 0][:, :Sq]
    o, lse = emulate(q, k, v, causal)
    assert ratio(o, want) <= 1.0
    assert ratio(lse, want_lse) <= 1.0


@pytest.mark.parametrize("s_new,kv_len", PREFILL)
def test_prefill_emulation_within_f32_limit(s_new, kv_len):
    """B12 with S_new > 1, bottom-right causal over a part-full cache with
    NaN past kv_len: the emulation finite and within the f32 limit of the
    plain version."""
    q, kc, vc = (torch.from_numpy(x) for x in _prefill(s_new, kv_len))
    o = _emulate_prefill(q, kc, vc, kv_len)
    assert torch.isfinite(o).all()
    assert ratio(o, A.flash_decode_ref(q, kc, vc, kv_len)) <= 1.0


@pytest.mark.parametrize("s_new,kv_len", [(3, 3), (3, T), (32, 33),
                                          (33, 65), (65, 65), (65, T)])
def test_prefill_emulation_against_jax(s_new, kv_len):
    """The emulated prefill against the JAX package's ``flash_decode``
    (NaN past kv_len), within the f32 limit taken around its output."""
    xs = _prefill(s_new, kv_len)
    q, kc, vc = (torch.from_numpy(x) for x in xs)
    jq, jk, jv = (jnp.asarray(x) for x in xs)
    want = np.asarray(R.flash_decode(jq, jk, jv, jnp.int32(kv_len),
                                     block_k=32))
    assert np.isfinite(want).all()
    assert ratio(_emulate_prefill(q, kc, vc, kv_len), want) <= 1.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_tf32_product_exceeds_f32_limit(case):
    """One TF32 product a product (S and P V) moves O or the LSE past the
    f32 limit: the limit is not loose, and the route needs three."""
    _xs, (q, k, v), causal, _bk = _case(case)
    o, lse = emulate(q, k, v, causal, mm=_mm_tf32x1)
    po, plse = A.flash_attention_ref(q, k, v, causal)
    assert max(ratio(o, po), ratio(lse, plse)) > 1.0


@pytest.mark.parametrize("s_new,kv_len", [(3, T), (33, 65), (65, T)])
def test_single_tf32_prefill_exceeds_f32_limit(s_new, kv_len):
    """The same for the prefill."""
    q, kc, vc = (torch.from_numpy(x) for x in _prefill(s_new, kv_len))
    o = _emulate_prefill(q, kc, vc, kv_len, mm=_mm_tf32x1)
    assert ratio(o, A.flash_decode_ref(q, kc, vc, kv_len)) > 1.0


def test_emulation_tiles_are_the_kernels():
    """The emulation's key tile is the one the kernels stream
    (``FWD_BK``), the three kernels are there, and both products (S and
    P V) are 3xTF32."""
    src = SRC.read_text()
    assert re.findall(r"FWD_BK = (\d+)", src) == [str(KEY_TILE)]
    for kern in ("attn_fwd_kernel", "attn_fwd_single_kernel",
                 "attn_decode_kernel"):
        assert re.search(rf"{kern}\(", src), kern
    assert src.count("mma_3xtf32(") >= 4


def test_tiles_change_nothing_but_roundings():
    """The emulation at another key tile gives the same function (within
    the f32 limit) but other roundings: the tile is what the emulation
    mirrors, not a free choice that the tests would hide."""
    _xs, (q, k, v), causal, _bk = _case("b8-mha-causal-d16")
    o32, _ = emulate(q, k, v, causal)
    o64, _ = emulate(q, k, v, causal, tile=64)
    assert ratio(o32, o64) <= 1.0
    assert not torch.equal(o32, o64)
