"""Attention at head dims past 256 on the CPU, against the reference:
the gradients and KV-cache decode.

The cases and tolerances of ``test_torch_attention_wide.py`` (D = 264,
320 and 512 on f32, bf16 and f16): dq, dk and dv through the port's
``_FlashAttention`` (B10 and B11's plain versions on CPU tensors; on the
card their column-group kernels, and for f32 the cluster form) against
``jax.vjp`` of the reference's custom VJP in interpret mode, within four
ulps of the gradient scale for 16-bit (the reference also rounds dS to
q's dtype), f32 rtol = atol = 2e-5; the same in f32 past D = 1024 (the
cluster form's 4- and 8-slice tiers on the card); B12's decode and
chunked prefill over a part-full cache with NaN past kv_len, within two
ulps of the output scale.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from accl_tpu.ops import attention as R  # noqa: E402
from accl_tpu_torch.ops import attention as A  # noqa: E402

from test_torch_attention_wide import CASES, _close, _ids, _inputs  # noqa: E402,E501


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment."""
    yield


# f32 head dims past 1024: one live slice in a cluster's last block at
# four and eight slices a block (1032, 2056), and the cluster form's last
# head dim (4096)
WIDE_F32_DIMS = (1032, 2056, 4096)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_grads_match_reference(case):
    """dq, dk, dv through ``_FlashAttention`` against ``jax.vjp`` of the
    reference's custom VJP on the same cotangent, causal, GQA 2/1."""
    _grads_case(*case)


@pytest.mark.parametrize("D", WIDE_F32_DIMS)
def test_f32_grads_past_1024_match_reference(D):
    """As ``test_grads_match_reference`` in f32 at the head dims past 1024
    (B 1, H 2, Hkv 1, S 16, rtol = atol = 2e-5)."""
    _grads_case("float32", D)


def _grads_case(dtype, D):
    B, H, Hkv, S = 1, 2, 1, 16
    xq, xk, xv, xdo = _inputs(3 * D, [(B, H, S, D), (B, Hkv, S, D),
                                      (B, Hkv, S, D), (B, H, S, D)])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (xq, xk, xv, xdo))
    _, vjp = jax.vjp(lambda q, k, v: R.flash_attention(q, k, v, causal=True),
                     jq, jk, jv)
    want = vjp(jdo)
    q, k, v = (torch.from_numpy(x).to(tdt).requires_grad_()
               for x in (xq, xk, xv))
    o = A.flash_attention(q, k, v, causal=True)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    o.backward(torch.from_numpy(xdo).to(tdt))
    for t, w, name in zip((q, k, v), want, "qkv"):
        assert t.grad.dtype == tdt and t.grad.shape == t.shape
        _close(t.grad, w, dtype, f"{dtype} D={D} d{name}", ulps=4)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_decode_matches_reference(case):
    """One new token (B12's decode) and a chunk of 5 (its prefill) over a
    part-full cache (B, T, Hkv, D) with NaN at and past kv_len."""
    dtype, D = case
    B, H, Hkv, T, kv_len = 1, 2, 1, 24, 17
    kc, vc = _inputs(D, [(B, T, Hkv, D), (B, T, Hkv, D)])
    kc[:, kv_len:] = np.nan
    vc[:, kv_len:] = np.nan
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for s_new in (1, 5):
        q, = _inputs(D + s_new, [(B, H, s_new, D)])
        jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, kc, vc))
        want = R.flash_decode(jq, jk, jv, jnp.int32(kv_len), block_k=16)
        got = A.flash_decode(*(torch.from_numpy(x).to(tdt)
                               for x in (q, kc, vc)), kv_len, block_k=16)
        assert got.dtype == tdt and got.shape == (B, H, s_new, D)
        _close(got, want, dtype, f"{case} decode s_new={s_new}")
