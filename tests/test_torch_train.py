"""The port's Llama training path against the reference's, on the CPU.

The reference's ``Llama.init(jax.random.key(0))`` parameters go through
``llama_params_from_reference`` into the port's module; the same tokens
then go through the reference's ``loss`` / ``jax.grad`` / optax
``make_train_step`` and the port's ``loss`` / autograd /
``make_train_step`` with the matching ``torch.optim`` optimizer. On the
CPU the port's attention runs its plain versions (B8-B11's). Gradients
and updated parameters come back through ``llama_params_to_reference``
and are compared leaf by leaf. Tolerances: f32 losses and parameters
within rtol = atol = 2e-4 (the tolerance of ``test_torch_llama.py``);
each gradient leaf within 2e-4 of its own largest entry plus 2e-4
relative (the leaves' scales span decades: the embedding's untouched
rows are exactly zero).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from accl_tpu.models import llama as RL  # noqa: E402
from accl_tpu_torch.convert import (llama_params_from_reference,  # noqa: E402
                                    llama_params_to_reference)
from accl_tpu_torch.models import Llama, LlamaConfig  # noqa: E402
from accl_tpu_torch.ops import attention as A  # noqa: E402

TOL = 2e-4
TINY = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128)
B, S = 2, 16


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


def _pair(attention="flash", dtype="float32"):
    rcfg = dataclasses.replace(RL.LlamaConfig.tiny(**TINY),
                               dtype=getattr(jnp, dtype), attention=attention)
    ref = RL.Llama(rcfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
    pcfg = dataclasses.replace(LlamaConfig.tiny(**TINY),
                               dtype=getattr(torch, dtype),
                               attention=attention)
    port = Llama(pcfg, device="cpu").load_reference_params(params)
    return ref, params, port


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(2).integers(0, 256, (B, S)).astype(np.int32)


def _t(tok):
    return torch.from_numpy(np.asarray(tok)).long()


def _close_leaves(got: dict, want: dict, what: str, grad: bool = False):
    for key in ("embed", "final_norm", "lm_head"):
        _close_leaf(got[key], want[key], f"{what} {key}", grad)
    for key, w in want["layers"].items():
        _close_leaf(got["layers"][key], w, f"{what} layers.{key}", grad)


def _close_leaf(g, w, what, grad):
    w = np.asarray(w)
    assert g.shape == w.shape and g.dtype == w.dtype, what
    atol = TOL * float(np.abs(w).max()) if grad else TOL
    np.testing.assert_allclose(g, w, rtol=TOL, atol=atol, err_msg=what)


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_loss_matches_reference(attention, tokens):
    ref, params, port = _pair(attention)
    want = float(ref.loss(params, jnp.asarray(tokens)))
    got = port.loss(_t(tokens))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_grads_match_reference(attention, tokens):
    """Every parameter's gradient against ``jax.grad(ref.loss)``; the
    flash path's backward ran the plain B10 and B11 once per layer."""
    ref, params, port = _pair(attention)
    want = jax.grad(ref.loss)(params, jnp.asarray(tokens))
    port.requires_grad_(True)
    before = dict(A.plain_runs)
    port.loss(_t(tokens)).backward()
    n = TINY["n_layers"] if attention == "flash" else 0
    assert A.plain_runs["bwd_dkv"] - before["bwd_dkv"] == n
    assert A.plain_runs["bwd_dq"] - before["bwd_dq"] == n
    grads = {k: p.grad for k, p in port.named_parameters()}
    _close_leaves(llama_params_to_reference(grads),
                  jax.tree.map(np.asarray, want), f"{attention} grad",
                  grad=True)


OPTIMIZERS = {
    "sgd": (lambda: optax.sgd(0.5),
            lambda ps: torch.optim.SGD(ps, lr=0.5)),
    "adam": (lambda: optax.adam(1e-2),
             lambda ps: torch.optim.Adam(ps, lr=1e-2, eps=1e-8)),
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_train_step_matches_optax(opt, tokens):
    """Three steps of ``make_train_step`` against the reference's with
    the matching optax optimizer: the losses and the parameters after."""
    ref, params, port = _pair()
    make_ref, make_port = OPTIMIZERS[opt]
    optimizer = make_ref()
    opt_state = optimizer.init(params)
    ref_step = jax.jit(ref.make_train_step(optimizer))
    step = port.make_train_step(make_port(port.parameters()))
    for i in range(3):
        params, opt_state, want = ref_step(params, opt_state,
                                           jnp.asarray(tokens))
        got = step(_t(tokens))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert not got.requires_grad
        np.testing.assert_allclose(float(got), float(want), rtol=TOL,
                                   atol=TOL, err_msg=f"{opt} step {i}")
    _close_leaves(llama_params_to_reference(port.state_dict()),
                  jax.tree.map(np.asarray, params), f"{opt} params")


def test_train_step_reduces_loss():
    """The port of ``test_models.py::test_train_step_reduces_loss``: the
    tiny config (bf16 activations, f32 parameters, flash attention),
    Adam 1e-2, 8 steps on one batch."""
    model = Llama(LlamaConfig.tiny(), device="cpu").init(
        torch.Generator().manual_seed(0))
    step = model.make_train_step(torch.optim.Adam(model.parameters(),
                                                  lr=1e-2))
    tokens = _t(np.random.default_rng(1).integers(
        0, model.config.vocab_size, (4, 32)))
    losses = [float(step(tokens)) for _ in range(8)]
    assert losses[-1] < losses[0] * 0.9, losses


def test_serving_after_training_builds_no_graph(tokens):
    """``generate`` and ``forward_cached`` of a model that has trained
    build no autograd graph and leave the gradients as they were."""
    _ref, _params, port = _pair()
    step = port.make_train_step(torch.optim.SGD(port.parameters(), lr=0.1))
    step(_t(tokens))
    assert all(p.requires_grad and p.grad is not None
               for p in port.parameters())
    grads = {k: p.grad.clone() for k, p in port.named_parameters()}
    out = port.generate(_t(tokens[:, :5]), max_new=4)
    assert out.shape == (B, 4) and not out.requires_grad
    cache = port.init_kv_cache(B, S)
    logits, cache = port.forward_cached(_t(tokens[:, :6]), cache)
    assert logits.grad_fn is None and not logits.requires_grad
    assert not cache["k"].requires_grad and not cache["v"].requires_grad
    for k, p in port.named_parameters():
        assert torch.equal(p.grad, grads[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trip_bit_for_bit(dtype):
    """state_dict -> reference pytree -> state_dict, and the reference's
    pytree -> state_dict -> pytree, both bit for bit."""
    cfg = dataclasses.replace(LlamaConfig.tiny(**TINY),
                              param_dtype=getattr(torch, dtype))
    port = Llama(cfg, device="cpu").init(torch.Generator().manual_seed(7))
    sd = port.state_dict()
    tree = llama_params_to_reference(sd)
    assert tree["layers"]["wq"].shape == (TINY["n_layers"], 64, 64)
    assert tree["embed"].dtype.name == dtype
    back = llama_params_from_reference(tree)
    assert back.keys() == sd.keys()
    for key, t in sd.items():
        assert back[key].dtype == t.dtype, key
        assert torch.equal(back[key].view(torch.int16 if dtype == "bfloat16"
                                          else torch.int32),
                           t.view(torch.int16 if dtype == "bfloat16"
                                  else torch.int32)), key
    rcfg = dataclasses.replace(RL.LlamaConfig.tiny(**TINY),
                               param_dtype=getattr(jnp, dtype))
    params = jax.tree.map(np.asarray, RL.Llama(rcfg).init(jax.random.key(1)))
    again = llama_params_to_reference(llama_params_from_reference(params))
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(again)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_converter_rejects_missing_and_extra_keys():
    port = Llama(LlamaConfig.tiny(**TINY), device="cpu")
    sd = port.state_dict()
    with pytest.raises(KeyError, match="layers.1.wq"):
        llama_params_to_reference({k: v for k, v in sd.items()
                                   if k != "layers.1.wq"})
    with pytest.raises(KeyError, match="bias"):
        llama_params_to_reference(dict(sd, bias=torch.zeros(3)))
