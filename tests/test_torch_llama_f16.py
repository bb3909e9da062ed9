"""An f16 tiny Llama (forward, ``forward_cached`` step by step, the loss
and every gradient) against ``accl_tpu.models.llama`` with
``dtype=jnp.float16``, on the CPU: the f16 path of the attention
kernels' widened contract (``test_torch_attention_dtypes.py`` holds the
kernels' plain versions). The reference runs its Pallas attention in
interpret mode, the port the plain versions of B8-B12.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from accl_tpu.models import llama as RL  # noqa: E402
from accl_tpu_torch.convert import llama_params_to_reference  # noqa: E402
from accl_tpu_torch.models import Llama, LlamaConfig  # noqa: E402
from accl_tpu_torch.ops import attention as A  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


TINY = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128)
LB, LS = 2, 10


@pytest.fixture(scope="module")
def f16_pair():
    rcfg = dataclasses.replace(RL.LlamaConfig.tiny(**TINY),
                               dtype=jnp.float16)
    ref = RL.Llama(rcfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
    pcfg = dataclasses.replace(LlamaConfig.tiny(**TINY), dtype=torch.float16)
    port = Llama(pcfg, device="cpu").load_reference_params(params)
    return ref, params, port


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(4).integers(0, 256, (LB, LS)).astype(
        np.int32)


def _t(tok):
    return torch.from_numpy(np.asarray(tok)).long()


def _logit_tol(want) -> float:
    """16 f16 ulps of the logit scale: every layer rounds its activations
    to f16 at some ten points (2^-11 relative each), and XLA and torch
    place some of those roundings differently (fused elementwise chains,
    matmul accumulation), as for bf16 in ``test_torch_llama.py``."""
    return 16 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 10)


def test_f16_llama_forward_matches_reference(f16_pair, tokens):
    ref, params, port = f16_pair
    want = np.asarray(ref.forward(params, jnp.asarray(tokens)), np.float32)
    got = port(_t(tokens)).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=_logit_tol(want))
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def test_f16_llama_forward_cached_matches_reference_per_step(f16_pair,
                                                              tokens):
    """Prefill 6 tokens (B12's chunk), then 4 single-token decodes."""
    ref, params, port = f16_pair
    rcache = ref.init_kv_cache(LB, max_len=LS)
    cache = port.init_kv_cache(LB, max_len=LS)
    assert cache["k"].dtype == torch.float16
    for a, b in [(0, 6)] + [(t, t + 1) for t in range(6, LS)]:
        want, rcache = ref.forward_cached(params, jnp.asarray(tokens[:, a:b]),
                                          rcache)
        want = np.asarray(want, np.float32)
        got, _ = port.forward_cached(_t(tokens[:, a:b]), cache)
        got = got.float().numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=_logit_tol(want),
                                   err_msg=f"step {a}:{b}")


def test_f16_llama_loss_and_grads_match_reference(f16_pair, tokens):
    """The loss within 2^-8 relative and every gradient within 2^-6 of
    its leaf's largest magnitude against ``jax.grad(ref.loss)``: f16
    activations on both sides, rounded at different points."""
    ref, params, port = f16_pair
    want_loss = float(ref.loss(params, jnp.asarray(tokens)))
    want = jax.tree.map(np.asarray,
                        jax.grad(ref.loss)(params, jnp.asarray(tokens)))
    port.requires_grad_(True)
    before = dict(A.plain_runs)
    loss = port.loss(_t(tokens))
    loss.backward()
    assert A.plain_runs["bwd_dkv"] - before["bwd_dkv"] == TINY["n_layers"]
    np.testing.assert_allclose(float(loss.detach()), want_loss,
                               rtol=2.0 ** -8)
    got = llama_params_to_reference(
        {k: p.grad for k, p in port.named_parameters()})
    pairs = [(got[k], want[k], k) for k in ("embed", "final_norm",
                                            "lm_head")]
    pairs += [(got["layers"][k], w, k) for k, w in want["layers"].items()]
    for g, w, name in pairs:
        g = np.asarray(g, np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2.0 ** -6 * np.abs(w).max(),
                                   err_msg=name)
