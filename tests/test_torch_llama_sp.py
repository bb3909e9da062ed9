"""The port's sequence-parallel Llama against the reference's, on the CPU.

A tiny f32 config (n_heads 4, n_kv_heads 2) with the reference's
``init(jax.random.key(0))`` weights carried across by
``llama_params_from_reference``. The reference runs ``forward`` /
``loss`` with ``dp="dp", sp="sp"`` and a (2, 4) mesh of the 8 virtual
CPU devices (ring attention under shard_map, its Pallas kernels in
interpret mode); the port runs the same arguments over a (2, 4)
``cpu_mesh`` of virtual ranks (ring attention over the sp axis, the
plain versions of B9-B11 a visible block, the dp groups on the batch
axis). Tolerances: logits and the loss within rtol = atol = 2e-4 (the
reference's own sequence-parallel test); each gradient leaf within 2e-4
of its own largest entry plus 2e-4 relative (``test_torch_train.py``'s
rule).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from accl_tpu.models import llama as RL  # noqa: E402
from accl_tpu.utils.compat import set_mesh  # noqa: E402
from accl_tpu_torch.convert import llama_params_to_reference  # noqa: E402
from accl_tpu_torch.models import Llama, LlamaConfig  # noqa: E402
from accl_tpu_torch.ops import attention as A  # noqa: E402
from accl_tpu_torch.parallel import cpu_mesh  # noqa: E402

TOL = 2e-4
TINY = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128)
B, S = 4, 64
SP = dict(dp="dp", sp="sp")


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


@pytest.fixture(scope="module")
def pair():
    rcfg = dataclasses.replace(RL.LlamaConfig.tiny(**TINY),
                               dtype=jnp.float32)
    ref = RL.Llama(rcfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
    pcfg = dataclasses.replace(LlamaConfig.tiny(**TINY), dtype=torch.float32)
    return ref, params, pcfg


def _port(pair):
    _ref, params, pcfg = pair
    return Llama(pcfg, device="cpu").load_reference_params(params)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(0, 256, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_mesh():
    return Mesh(np.array(jax.devices("cpu")[:8]).reshape(2, 4), ("dp", "sp"))


def _mesh():
    return cpu_mesh(8, (2, 4), ("dp", "sp"))


def _t(tok):
    return torch.from_numpy(np.asarray(tok)).long()


def _on_mesh(ref_mesh, params, tokens):
    return (jax.device_put(params, NamedSharding(ref_mesh, P())),
            jax.device_put(tokens, NamedSharding(ref_mesh, P("dp", "sp"))))


def test_sp_forward_matches_reference_and_unsharded(pair, tokens, ref_mesh):
    ref, params, _ = pair
    with set_mesh(ref_mesh):
        p, t = _on_mesh(ref_mesh, params, tokens)
        want = np.asarray(jax.jit(lambda p, t: ref.forward(
            p, t, mesh=ref_mesh, **SP))(p, t))
    port = _port(pair)
    before = dict(A.plain_runs)
    with torch.no_grad():
        got = port(_t(tokens), mesh=_mesh(), **SP)
        unsharded = port(_t(tokens))
    # a causal ring of 4 ranks: 10 blocks a layer (B9: 16 keys a shard),
    # then the unsharded forward's one B9 a layer
    n = TINY["n_layers"]
    assert A.plain_runs["fwd_single"] - before["fwd_single"] == 10 * n + n
    assert got.dtype == torch.float32 and got.shape == (B, S, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), unsharded.numpy(), rtol=TOL,
                               atol=TOL)


def _close_leaves(got: dict, want: dict):
    flat = [(k, got[k], want[k]) for k in ("embed", "final_norm", "lm_head")]
    flat += [(f"layers.{k}", got["layers"][k], w)
             for k, w in want["layers"].items()]
    for what, g, w in flat:
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, what
        err = np.abs(g - w)
        lim = TOL * float(np.abs(w).max()) + TOL * np.abs(w)
        assert (err <= lim).all(), (f"{what}: max abs err {err.max():.3g}, "
                                    f"{(err / lim).max():.3g} times the "
                                    f"limit")


def test_sp_loss_and_gradients_match_jax_grad(pair, tokens, ref_mesh):
    """The loss and every parameter's gradient against ``jax.grad`` of
    the reference's ``loss`` with sp; the port's backward ran B10 and
    B11 once per visible block per layer."""
    ref, params, _ = pair
    with set_mesh(ref_mesh):
        p, t = _on_mesh(ref_mesh, params, tokens)
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda p, t: ref.loss(p, t, mesh=ref_mesh, **SP)))(p, t)
    want = jax.tree.map(np.asarray, want)
    port = _port(pair).requires_grad_(True)
    before = dict(A.plain_runs)
    loss = port.loss(_t(tokens), mesh=_mesh(), **SP)
    loss.backward()
    for key in ("bwd_dkv", "bwd_dq"):
        assert A.plain_runs[key] - before[key] == 10 * TINY["n_layers"]
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=TOL, atol=TOL)
    grads = {k: p.grad for k, p in port.named_parameters()}
    _close_leaves(llama_params_to_reference(grads), want)


def test_sp_train_steps_descend(pair, tokens):
    port = _port(pair)
    step = port.make_train_step(torch.optim.Adam(port.parameters(),
                                                 lr=1e-3), mesh=_mesh(),
                                **SP)
    l0, l1 = float(step(_t(tokens))), float(step(_t(tokens)))
    assert np.isfinite(l0) and l1 < l0, (l0, l1)


def test_sp_without_mesh_takes_the_dense_path(pair, tokens):
    """``sp`` (or ``dp``) without a mesh runs the reference's dense
    branch: no kernel launches, the dense model's logits bitwise, the
    reference's within the tolerance."""
    ref, params, pcfg = pair
    want = np.asarray(ref.forward(params, jnp.asarray(tokens), sp="sp"))
    port = _port(pair)
    dense = Llama(dataclasses.replace(pcfg, attention="dense"), device="cpu")
    dense.load_state_dict(port.state_dict())
    before = dict(A.plain_runs)
    with torch.no_grad():
        got = port(_t(tokens), sp="sp")
        assert torch.equal(got, dense(_t(tokens)))
    assert A.plain_runs == before
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _ref_message(ref, params, tokens, ref_mesh, **kw):
    p = jax.device_put(params, NamedSharding(ref_mesh, P()))
    with set_mesh(ref_mesh), pytest.raises(ValueError) as e:
        ref.forward(p, jnp.asarray(tokens), mesh=ref_mesh, **kw)
    return str(e.value)


@pytest.mark.parametrize("case", ["sp axis", "sequence", "dp axis", "batch"])
def test_sp_errors_match_reference(case, pair, tokens, ref_mesh):
    """The reference's ValueErrors, word for word. The sp ones are read
    from the reference's run; with dp given, the reference's embedding
    sharding constraint raises (a ValueError of JAX's) before its own dp
    checks run, so their text is taken from its source."""
    ref, params, _ = pair
    port = _port(pair)
    kw, toks = {
        "sp axis": (dict(sp="zz"), tokens),
        "sequence": (dict(sp="sp"), tokens[:, :62]),
        "dp axis": (dict(dp="qq", sp="sp"), tokens),
        "batch": (dict(dp="dp", sp="sp"), tokens[:3])}[case]
    with pytest.raises(ValueError) as e:
        port(_t(toks), mesh=_mesh(), **kw)
    got = str(e.value)
    want = _ref_message(ref, params, toks, ref_mesh, **kw)
    if case in ("sp axis", "sequence"):
        assert got == want
    else:
        import inspect
        src = inspect.getsource(RL.Llama._forward_with_aux)
        assert got == {"dp axis": "dp axis 'qq' not in mesh ('dp', 'sp')",
                       "batch": "batch 3 not divisible by dp axis size 2"
                       }[case]
        template = {"dp axis": 'f"dp axis {dp!r} not in mesh "',
                    "batch": 'f"batch {B} not divisible by dp axis size "'}
        assert template[case] in src

