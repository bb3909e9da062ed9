"""The attention kernels' widened contract on the CPU, continued from
``test_torch_attention_dtypes.py`` (its cases and tolerances): the
backward through ``_FlashAttention`` (B10, B11) against the reference's
custom VJP, and KV-cache decode and chunked prefill (B12) against
``flash_decode``, the reference's Pallas kernels in interpret mode.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from accl_tpu.ops import attention as R  # noqa: E402
from accl_tpu_torch.ops import attention as A  # noqa: E402
from test_torch_attention_dtypes import CASES, _close, _ids, _inputs  # noqa: E402,E501


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_grads_match_reference(case):
    """dq, dk, dv through ``_FlashAttention`` against the reference's
    custom VJP on the same cotangent, causal, GQA 4/2."""
    dtype, D = case
    B, H, Hkv, S = 1, 4, 2, 24
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
        _close(t.grad, w, dtype, f"{case} d{name}", ulps=4)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_decode_matches_reference(case):
    """One new token and a chunk of 9 over a part-full cache (B, T, Hkv,
    D) with NaN at and past kv_len: finite, equal to the reference's."""
    dtype, D = case
    B, H, Hkv, T, kv_len = 1, 4, 2, 40, 27
    kc, vc = _inputs(D, [(B, T, Hkv, D), (B, T, Hkv, D)])
    kc[:, kv_len:] = np.nan
    vc[:, kv_len:] = np.nan
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for s_new in (1, 9):
        q, = _inputs(D + s_new, [(B, H, s_new, D)])
        jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, kc, vc))
        want = R.flash_decode(jq, jk, jv, jnp.int32(kv_len), block_k=16)
        got = A.flash_decode(*(torch.from_numpy(x).to(tdt)
                               for x in (q, kc, vc)), kv_len, block_k=16)
        assert got.dtype == tdt and got.shape == (B, H, s_new, D)
        _close(got, want, dtype, f"{case} decode s_new={s_new}")
