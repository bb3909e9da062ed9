"""The attention kernels' widened contract on the CPU: f16 operands and
head dims off the old (16, 32, 64, 128), against the reference.

The same numpy inputs go through ``accl_tpu.ops.attention`` (Pallas in
interpret mode, as ``test_ops.py`` runs it) and through
``accl_tpu_torch.ops.attention``, whose wrappers run the plain versions
on CPU tensors: the forward (B8 and B9 by the reference's block rule),
(``test_torch_attention_dtypes_bwd.py`` holds the backward through
``_FlashAttention``, B10 and B11, and KV-cache decode and chunked
prefill, B12, on the same cases).
Cases: f16 at D = 8, 12, 80, 96 and 256, bf16 at 8, 80 and 256, f32 at
12, 96 and 256 (D = 8 is the dry run's and ``LlamaConfig.tiny``'s, 80
Phi-2's, 96 Phi-3-mini's, 256 Gemma-2B's; 12 is not a multiple of 8,
which the wrapper pads on the card).

Tolerances, per element against the reference: f32 rtol = atol = 2e-5
(one f32 softmax in another summation order); a 16-bit output within two
ulps of its dtype at the output scale (2^-(p-1) * max|O|, p = 8 for bf16
and 11 for f16: both sides round an f32 value, and the reference's
kernels round P to q's dtype before P V where the plain version keeps it
f32); 16-bit gradients within 2^-(p-2) * max|grad| (the reference's
backward also rounds dS to q's dtype). On the card the kernels are held
to the plain versions under ``chip_smoke.py``'s limits.

Also: the wrapper's zero padding of a head dim that is not a multiple
of 8. ``test_torch_llama_f16.py`` holds an f16 Llama.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from accl_tpu.ops import attention as R  # noqa: E402
from accl_tpu_torch.ops import attention as A  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


F32_TOL = 2e-5
SIG = {"bfloat16": 8, "float16": 11}      # significant bits
CASES = ([("float16", d) for d in (8, 12, 80, 96, 256)]
         + [("bfloat16", 8), ("bfloat16", 80), ("bfloat16", 256),
            ("float32", 12), ("float32", 96), ("float32", 256)])


def _ids(case):
    return f"{case[0]}-d{case[1]}"


def _close(got: torch.Tensor, want, dtype: str, what: str, ulps: int = 2):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert np.isfinite(g).all(), what
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=what)
        return
    tol = ulps * 2.0 ** -(SIG[dtype] - 1) * float(np.abs(w).max())
    np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=what)


def _inputs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("bk", [None, 16])
def test_forward_matches_reference(case, bk):
    """O and the LSE at S = 40, causal, GQA 4/2: B9 under the reference's
    own block (one block), B8 under block_k = 16 (three blocks)."""
    dtype, D = case
    B, H, Hkv, S = 1, 4, 2, 40
    xs = _inputs(D + (bk or 0), [(B, H, S, D), (B, Hkv, S, D),
                                 (B, Hkv, S, D)])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in xs)
    want = R.flash_attention(jq, jk, jv, causal=True, block_k=bk)
    rbk = min(bk or R._auto_block(S), max(S, 8))
    rbq = min(R._auto_block(S), max(S, 8))
    fwd = jax.jit(R._fwd, static_argnums=(3, 4, 5, 6))
    want_lse = np.asarray(fwd(jq, jk, jv, True, D ** -0.5, rbq,
                              rbk)[1])[..., 0][:, :S]
    before = dict(A.plain_runs)
    o, lse = A.flash_attention_fwd(*(torch.from_numpy(x).to(tdt)
                                     for x in xs), causal=True, block_k=bk)
    single = bk is None
    assert A.plain_runs["fwd_single"] - before["fwd_single"] == int(single)
    assert A.plain_runs["fwd"] - before["fwd"] == int(not single)
    assert o.dtype == tdt and o.shape == (B, H, S, D)
    _close(o, want, dtype, f"{case} block_k={bk} O")
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=F32_TOL,
                               atol=F32_TOL, err_msg=f"{case} LSE")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_zero_padding_of_the_head_dim(dtype):
    """What the wrapper does on the card for D = 12: q, k, v padded with
    zero columns to 16 (``_pad_d``), the scale kept at 12 ** -0.5, the
    outputs sliced back. Zero columns change no score and give zero
    output columns, so the forward, B10, B11 and B12 on the padded
    operands equal the unpadded plain versions (f32 rtol = atol = 1e-6:
    the matmuls' sums may take another order; 16-bit: one ulp)."""
    tdt = getattr(torch, dtype)
    D, S = 12, 33
    q, k, v, do = (torch.from_numpy(x).to(tdt) for x in _inputs(
        5, [(1, 4, S, D), (1, 2, S, D), (1, 2, S, D), (1, 4, S, D)]))
    qp, kp, vp, dop = A._pad_d(q, k, v, do)
    assert qp.shape[-1] == 16 and torch.equal(qp[..., :D], q)
    assert not qp[..., D:].any()
    sc = D ** -0.5
    o, lse = A.flash_attention_ref(q, k, v, True, sc)
    op, lsep = A.flash_attention_ref(qp, kp, vp, True, sc)
    assert not op[..., D:].any()
    tol = (dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else
           dict(rtol=2.0 ** -(SIG[dtype] - 1), atol=2.0 ** -SIG[dtype]))
    torch.testing.assert_close(op[..., :D], o, **tol)
    torch.testing.assert_close(lsep, lse, rtol=1e-6, atol=1e-6)
    delta = (do.float() * o.float()).sum(-1).reshape(4, S)
    parts = A.flash_attention_bwd_dkv_ref(q, do, k, v, lse, delta, True, sc)
    pparts = A.flash_attention_bwd_dkv_ref(qp, dop, kp, vp, lse, delta, True,
                                           sc)
    dq = A.flash_attention_bwd_dq_ref(q, do, k, v, lse, delta, True, sc)
    pdq = A.flash_attention_bwd_dq_ref(qp, dop, kp, vp, lse, delta, True, sc)
    for a, b in zip(parts + (dq,), pparts + (pdq,)):
        assert not b[..., D:].any()
        torch.testing.assert_close(b[..., :D], a, **tol)
    kc, vc = (t.transpose(1, 2).contiguous() for t in (k, v))
    kcp, vcp = A._pad_d(kc, vc)
    dec = A.flash_decode_ref(q[:, :, -1:], kc, vc, S, sc)
    decp = A.flash_decode_ref(qp[:, :, -1:], kcp, vcp, S, sc)
    torch.testing.assert_close(decp[..., :D], dec, **tol)
    assert A._pad_d(q[..., :8])[0].shape[-1] == 8      # a multiple: as is
