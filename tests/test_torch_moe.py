"""The port's mixture-of-experts layer against ``accl_tpu.models.moe``.

The reference's ``MoELayer.init(jax.random.key(s))`` weights cross by
``moe_params_from_reference``; tokens are numpy seeds. Both run f32 on
the CPU. What is held:

* routing: the chosen experts equal ``lax.top_k`` of the reference's
  probabilities (a zero router too, where every expert ties and the
  lower index wins), the kept (token, expert) pairs equal the
  reference's dispatch tensor's, the port's gathered dispatch equals
  ``einsum("tec,td->ecd", dispatch, x)`` bit for bit, and its slot gates
  the reference's combine tensor within 1e-6 relative;
* ``apply_dense`` and ``moe_apply_sharded`` (a ``cpu_mesh(4)`` ep axis
  against the reference's shard_map on 4 virtual CPU devices): outputs
  within rtol = atol = 1e-5 (the expert GEMMs sum in another order; the
  combine adds the same <= 2 terms), dropped tokens exactly zero on both
  sides, the aux within 1e-6 relative;
* gradients of a scalar of the output and the aux, with respect to the
  four weights and the tokens, against ``jax.grad``: each leaf within
  2e-4 of its largest entry plus 2e-4 relative (``test_torch_train.py``'s
  rule: at top_k = 1 the renormalisation p / p cancels, and the router's
  gradient keeps both sides' f32 rounding of that cancellation, 1.2e-4
  of its largest entry here); the expert-parallel path's against the
  dense path's on the same routing, within 1e-5 of the same.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from accl_tpu.models import moe as RM  # noqa: E402
from accl_tpu.parallel import cpu_mesh as jax_cpu_mesh  # noqa: E402
from accl_tpu_torch.convert import (moe_params_from_reference,  # noqa: E402
                                    moe_params_to_reference)
from accl_tpu_torch.models import moe as M  # noqa: E402
from accl_tpu_torch.parallel import RankCollectives, cpu_mesh  # noqa: E402

TOL = 1e-5
GATE_RTOL = 1e-6
GRAD_TOL = 2e-4


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


def _pair(seed: int, **kw):
    """(reference layer, its numpy params, the port's layer with them)."""
    rcfg = RM.MoEConfig(**kw)
    ref = RM.MoELayer(rcfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.key(seed)))
    pcfg = M.MoEConfig(**kw)
    port = M.MoELayer(pcfg, device="cpu")
    port.load_state_dict(moe_params_from_reference(params))
    return ref, params, port


def _x(seed: int, T: int, d: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((T, d)).astype(
        np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("tokens,factor", [(1, 1.25), (7, 1.0), (32, 0.25),
                                           (64, 8.0), (1024, 1.25),
                                           (2048, 1.25), (333, 0.7)])
@pytest.mark.parametrize("E,k", [(8, 2), (4, 1), (8, 1), (16, 4)])
def test_capacity_matches_reference(tokens, factor, E, k):
    kw = dict(n_experts=E, top_k=k, capacity_factor=factor)
    assert M.MoEConfig(**kw).capacity(tokens) == \
        RM.MoEConfig(**kw).capacity(tokens)


def _dense_combine(r: M.Routing, T: int, E: int, C: int) -> np.ndarray:
    """The port's slots as the reference's (T, E, C) combine tensor."""
    out = np.zeros((T + 1, E, C), np.float32)
    tok = r.slot_token.numpy()
    gate = r.slot_gate.numpy()
    for e in range(E):
        out[tok[e], e, np.arange(C)] = gate[e]
    return out[:T]


@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("top_k,factor", [(1, 1.25), (2, 1.25), (2, 0.5),
                                          (1, 0.25)])
def test_route_and_dispatch_match_reference(top_k, factor, zero_router):
    """Chosen experts equal ``lax.top_k``'s (with a zero router every
    expert ties: the lowest indices win on both sides), kept pairs
    equal, dispatch bitwise, slot gates the combine tensor's."""
    E, d, T = 8, 16, 64
    ref, params, port = _pair(3, dim=d, ffn_dim=32, n_experts=E,
                              top_k=top_k, capacity_factor=factor)
    if zero_router:
        params = dict(params, router=np.zeros_like(params["router"]))
        with torch.no_grad():
            port.router.zero_()
    x = _x(4, T, d)
    C = ref.config.capacity(T)
    disp, comb, aux = (np.asarray(a) for a in ref._route(params, x, C))
    probs = jax.nn.softmax(jnp.asarray(x) @ params["router"], axis=-1)
    want_idx = np.asarray(jax.lax.top_k(probs, top_k)[1])
    r = M.route(port.config, port.router, _t(x)[None], C)
    np.testing.assert_array_equal(r.idx[0].numpy(), want_idx)
    if zero_router:
        assert (want_idx == np.arange(top_k)).all()
    np.testing.assert_array_equal(r.keep[0].numpy(), disp.sum(-1))
    want_in = np.asarray(jnp.einsum("tec,td->ecd", disp, x))
    got_in = M.dispatch(r, _t(x)).numpy()
    np.testing.assert_array_equal(got_in, want_in)
    np.testing.assert_allclose(_dense_combine(r, T, E, C), comb,
                               rtol=GATE_RTOL, atol=0)
    np.testing.assert_allclose(float(r.aux[0]), float(aux), rtol=GATE_RTOL)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("factor", [1.25, 8.0])
def test_apply_dense_matches_reference(top_k, factor):
    ref, params, port = _pair(0, dim=16, ffn_dim=32, n_experts=8,
                              top_k=top_k, capacity_factor=factor)
    x = _x(1, 64, 16)
    want, want_aux = ref.apply_dense(params, x)
    with torch.no_grad():
        got, aux = port.apply_dense(_t(x))
    assert got.dtype == torch.float32 and got.shape == (64, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=GATE_RTOL)


def test_zero_router_ties_pick_the_reference_experts():
    """Uniform logits: every token's two experts are 0 and 1, as
    ``lax.top_k`` picks; the outputs and the aux (~1, balanced) agree."""
    ref, params, port = _pair(6, dim=8, ffn_dim=16, n_experts=4, top_k=2,
                              capacity_factor=4.0)
    params = dict(params, router=np.zeros_like(params["router"]))
    with torch.no_grad():
        port.router.zero_()
    x = _x(7, 128, 8)
    want, want_aux = ref.apply_dense(params, x)
    with torch.no_grad():
        got, aux = port.apply_dense(_t(x))
        r = M.route(port.config, port.router, _t(x)[None],
                    port.config.capacity(128))
    assert (r.idx[0] == torch.tensor([0, 1])).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=GATE_RTOL)
    assert 0.4 < float(aux) < 1.6


def test_capacity_drops_tokens():
    """The reference test's shape: C = ceil(32*1*0.25/4) = 2 a expert; at
    most 8 tokens get outputs, the rest exactly zero, and the dropped
    rows are the reference's."""
    ref, params, port = _pair(4, dim=8, ffn_dim=16, n_experts=4, top_k=1,
                              capacity_factor=0.25)
    x = _x(5, 32, 8)
    want, _ = ref.apply_dense(params, x)
    with torch.no_grad():
        got, _ = port.apply_dense(_t(x))
    want = np.asarray(want)
    assert got.shape == x.shape
    nonzero = (got.abs() > 0).any(dim=1).numpy()
    assert nonzero.sum() <= 4 * port.config.capacity(32)
    np.testing.assert_array_equal(nonzero, np.any(np.abs(want) > 0, axis=1))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aux_loss_matches_reference(seed):
    ref, params, port = _pair(10 + seed, dim=16, ffn_dim=32, n_experts=8,
                              top_k=2, capacity_factor=1.0)
    x = _x(20 + seed, 96, 16) * (1 + seed)
    C = ref.config.capacity(96)
    want = float(ref._route(params, x, C)[2])
    got = float(M.route(port.config, port.router, _t(x)[None], C).aux[0])
    np.testing.assert_allclose(got, want, rtol=GATE_RTOL)


def test_groups_route_on_their_own():
    """apply_groups over G groups equals apply_dense on each group: each
    group's queues and capacity are its own."""
    _, _, port = _pair(8, dim=16, ffn_dim=32, n_experts=8, top_k=2,
                       capacity_factor=0.5)
    x = _t(np.stack([_x(30 + g, 40, 16) for g in range(3)]))
    with torch.no_grad():
        out, aux = port.apply_groups(x)
        for g in range(3):
            o, a = port.apply_dense(x[g])
            np.testing.assert_allclose(out[g].numpy(), o.numpy(), rtol=TOL,
                                       atol=TOL)
            assert float(aux[g]) == float(a)


@pytest.mark.parametrize("top_k,factor", [(1, 8.0), (2, 8.0), (2, 1.0)])
def test_moe_apply_sharded_matches_reference(top_k, factor):
    """The ep = 4 path (one alltoall each way over the port's rank
    collectives) against the reference's shard_map program; the capacity
    is each rank's, so a tight factor drops tokens on both sides alike."""
    W = 4
    ref, params, port = _pair(0, dim=16, ffn_dim=32, n_experts=8,
                              top_k=top_k, capacity_factor=factor)
    x = _x(1, 64, 16)
    want, want_aux = RM.moe_apply_sharded(
        ref, params, jnp.asarray(x), jax_cpu_mesh(W, axis_names=("ep",)),
        "ep")
    mesh = cpu_mesh(W, axis_names=("ep",))
    with torch.no_grad():
        got, aux = M.moe_apply_sharded(port, _t(x), mesh, "ep")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=GATE_RTOL)
    # and against the port's own per-rank dense layer
    with torch.no_grad():
        dense = torch.cat([port.apply_dense(_t(x)[r * 16:(r + 1) * 16])[0]
                           for r in range(W)])
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=TOL,
                               atol=TOL)


def test_apply_ep_moves_slot_rows_by_alltoall():
    """Two alltoalls a call, each of the (W, W, E/W, C, d) slot blocks:
    W - 1 blocks a rank leave it each way."""
    W, d, T = 4, 16, 16
    _, _, port = _pair(2, dim=d, ffn_dim=32, n_experts=8, top_k=2,
                       capacity_factor=1.25)
    coll = RankCollectives(cpu_mesh(W, axis_names=("ep",)).group("ep"))
    calls = []
    orig = coll.alltoall

    def counted(x, *a, **kw):
        calls.append(tuple(x.shape))
        return orig(x, *a, **kw)

    coll.alltoall = counted
    C = port.config.capacity(T)
    with torch.no_grad():
        port.apply_ep(_t(_x(3, W * T, d)).view(W, T, d), coll)
    block = (8 // W) * C * d
    assert calls == [(W, W * block)] * 2
    assert coll.wire_bytes == 2 * W * (W - 1) * block * 4


def _close(got: np.ndarray, want: np.ndarray, what: str, tol: float):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    lim = tol * float(np.abs(want).max()) + tol * np.abs(want)
    err = np.abs(got - want)
    assert (err <= lim).all(), (f"{what}: max abs err {err.max():.3g}, "
                                f"{(err / lim).max():.3g} times the limit")


@pytest.mark.parametrize("top_k,factor", [(1, 1.25), (2, 1.25), (2, 0.5)])
def test_gradients_match_jax_grad(top_k, factor):
    """d/d(weights, x) of sum(out * probe) + 0.5 * aux: through the
    gates (probs), the renormalisation (vals) and the aux (frac_probs);
    the masks carry none."""
    ref, params, port = _pair(5, dim=16, ffn_dim=32, n_experts=8,
                              top_k=top_k, capacity_factor=factor)
    x = _x(6, 64, 16)
    probe = _x(7, 64, 16)

    def f(p, x):
        out, aux = ref.apply_dense(p, x)
        return jnp.sum(out * probe) + 0.5 * aux

    want_p, want_x = jax.grad(f, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    port.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    out, aux = port.apply_dense(xt)
    ((out * _t(probe)).sum() + 0.5 * aux).backward()
    got = moe_params_to_reference({k: v.grad for k, v in
                                   port.weights().items()})
    for k in port.weights():
        _close(got[k], want_p[k], k, GRAD_TOL)
    _close(xt.grad.numpy(), want_x, "x", GRAD_TOL)


def test_ep_gradients_match_dense():
    """The expert-parallel path's gradients (the alltoall's backward is
    itself) equal the dense path's, rank by rank, on the same routing."""
    W, T, d = 4, 16, 16
    _, _, port = _pair(9, dim=d, ffn_dim=32, n_experts=8, top_k=2,
                       capacity_factor=1.0)
    port.requires_grad_(True)
    x = _t(_x(10, W * T, d))
    probe = _t(_x(11, W * T, d))
    grads = []
    for ep in (True, False):
        port.zero_grad(set_to_none=True)
        xt = x.clone().requires_grad_(True)
        if ep:
            coll = RankCollectives(cpu_mesh(W, axis_names=("ep",)).group(
                "ep"))
            out, aux = port.apply_ep(xt.view(W, T, d), coll)
            out, aux = out.reshape(W * T, d), aux.mean()
        else:
            parts = [port.apply_dense(xt[r * T:(r + 1) * T])
                     for r in range(W)]
            out = torch.cat([o for o, _ in parts])
            aux = torch.stack([a for _, a in parts]).mean()
        ((out * probe).sum() + aux).backward()
        grads.append({"x": xt.grad.clone(), **{
            k: v.grad.clone() for k, v in port.weights().items()}})
    for k in grads[0]:
        _close(grads[0][k].numpy(), grads[1][k].numpy(), k, TOL)


def test_refuses_bad_shapes():
    _, _, port = _pair(0, dim=16, ffn_dim=32, n_experts=8, top_k=2)
    coll = RankCollectives(cpu_mesh(3, axis_names=("ep",)).group("ep"))
    with pytest.raises(ValueError, match="not divisible by ep=3"):
        port.apply_ep(torch.zeros(3, 4, 16), coll)
    with pytest.raises(ValueError, match="2 token rows for 3 ranks"):
        port.apply_ep(torch.zeros(2, 4, 16), coll)
    with pytest.raises(ValueError, match="not divisible by ep=4"):
        M.moe_apply_sharded(port, torch.zeros(10, 16),
                            cpu_mesh(4, axis_names=("ep",)))
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            M.MoELayer(M.MoEConfig())
        else:
            raise RuntimeError("CUDA present: the default device works")
