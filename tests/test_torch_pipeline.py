"""The port's GPipe pipeline schedule against ``accl_tpu.parallel.pipeline``.

The reference's tanh stages (``test_parallel_schedules.py``: x @ w + b
through tanh, w normal x d^-0.5, b normal x 0.1, from
``jax.random.key``) cross as numpy arrays; the reference runs
``pipeline_sharded`` under shard_map on a CPU mesh of W virtual devices,
the port over a ``cpu_mesh`` of W virtual ranks. Both run f32 on the
CPU. Outputs within rtol = atol = 1e-5 (the reference test's own
tolerance against the stages in sequence), and the port's bitwise its
own stages applied in sequence (the same products on the same shapes in
the same order); gradients of the stage parameters and the inputs
against ``jax.grad`` of the reference's ``pipeline_sharded``, each leaf
within 1e-5 of its largest entry plus 1e-5 relative.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from accl_tpu.parallel import cpu_mesh as jax_cpu_mesh  # noqa: E402
from accl_tpu.parallel.pipeline import (  # noqa: E402
    pipeline_sharded as ref_pipeline_sharded)
from accl_tpu_torch.parallel import (RankCollectives, cpu_mesh,  # noqa: E402
                                     pipeline_apply, pipeline_sharded)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


def _ref_stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _params(seed: int, W: int, d: int) -> dict:
    kw, kb = jax.random.split(jax.random.key(seed))
    return {"w": np.asarray(jax.random.normal(kw, (W, d, d)) * (d ** -0.5)),
            "b": np.asarray(jax.random.normal(kb, (W, d)) * 0.1)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _sequential(params: dict, x: torch.Tensor) -> torch.Tensor:
    W = params["w"].shape[0]
    out = []
    for m in range(x.shape[0]):
        y = x[m]
        for s in range(W):
            y = _stage({k: v[s] for k, v in params.items()}, y)
        out.append(y)
    return torch.stack(out)


@pytest.mark.parametrize("W,n_micro,mb", [(4, 4, 4), (4, 8, 4), (8, 8, 4),
                                          (4, 1, 2), (2, 5, 3)])
def test_pipeline_matches_reference(W, n_micro, mb):
    d = 16 if mb != 2 else 8
    params = _params(W + n_micro, W, d)
    x = np.random.default_rng(n_micro).standard_normal(
        (n_micro, mb, d)).astype(np.float32)
    want = np.asarray(ref_pipeline_sharded(
        _ref_stage, jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        jax_cpu_mesh(W, axis_names=("pp",)), "pp"))
    pt = {k: _t(v) for k, v in params.items()}
    got = pipeline_sharded(_stage, pt, _t(x), cpu_mesh(W,
                                                       axis_names=("pp",)))
    assert got.shape == (n_micro, mb, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert torch.equal(got, _sequential(pt, _t(x)))


@pytest.mark.parametrize("W,n_micro", [(4, 4), (4, 8), (8, 8), (4, 1)])
def test_schedule_skips_the_fill_and_drain_and_shifts_once_a_step(W,
                                                                  n_micro):
    """n_micro + W - 1 exchange rounds; W * n_micro stage calls (the
    skipped steps compute nothing); each round carries only live
    activations into the next stage."""
    d = 8
    params = {k: _t(v) for k, v in _params(1, W, d).items()}
    calls = []

    def stage(p, x):
        calls.append(x.shape)
        return _stage(p, x)

    coll = RankCollectives(cpu_mesh(W, axis_names=("pp",)).group("pp"))
    x = torch.randn(n_micro, 2, d, generator=torch.Generator().manual_seed(0))
    out = pipeline_apply(stage, params, x, coll)
    assert len(calls) == W * n_micro
    assert coll.exchange_rounds == n_micro + W - 1
    assert coll.wire_bytes == n_micro * (W - 1) * 2 * d * 4
    assert torch.equal(out, _sequential(params, x))


def test_replicate_out_false_leaves_the_outputs_on_the_last_rank():
    W, d = 4, 8
    params = {k: _t(v) for k, v in _params(2, W, d).items()}
    coll = RankCollectives(cpu_mesh(W, axis_names=("pp",)).group("pp"))
    x = torch.randn(3, 2, d, generator=torch.Generator().manual_seed(1))
    rows = pipeline_apply(_stage, params, x, coll, replicate_out=False)
    assert rows.shape == (W, 3, 2, d)
    assert torch.equal(rows[W - 1], _sequential(params, x))
    assert not rows[:W - 1].any()


@pytest.mark.parametrize("W,n_micro", [(4, 4), (4, 8), (8, 8), (4, 1)])
def test_gradients_match_jax_grad(W, n_micro):
    """d/d(w, b, x) of sum(out * probe): the backward of each shift is
    the inverse shift, so every stage's parameters get their gradient."""
    d, mb = 16, 4
    params = _params(10 + W, W, d)
    x = np.random.default_rng(W * n_micro).standard_normal(
        (n_micro, mb, d)).astype(np.float32)
    probe = np.random.default_rng(7).standard_normal(
        (n_micro, mb, d)).astype(np.float32)
    mesh = jax_cpu_mesh(W, axis_names=("pp",))

    def f(p, x):
        return jnp.sum(ref_pipeline_sharded(_ref_stage, p, x, mesh, "pp")
                       * probe)

    want_p, want_x = jax.grad(f, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    pt = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    xt = _t(x).requires_grad_(True)
    out = pipeline_sharded(_stage, pt, xt, cpu_mesh(W, axis_names=("pp",)))
    (out * _t(probe)).sum().backward()
    for what, got, want in (("w", pt["w"].grad, want_p["w"]),
                            ("b", pt["b"].grad, want_p["b"]),
                            ("x", xt.grad, want_x)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want)
        lim = TOL * float(np.abs(want).max()) + TOL * np.abs(want)
        assert (err <= lim).all(), f"{what}: {(err / lim).max():.3g}x limit"
        assert (np.abs(got.numpy()).reshape(W, -1).max(axis=1) > 0).all() \
            or what == "x", f"{what}: a stage got no gradient"


def test_refusals():
    params = {k: _t(v) for k, v in _params(0, 4, 8).items()}
    with pytest.raises(ValueError, match="4 rows for 2 pp ranks"):
        pipeline_sharded(_stage, params, torch.zeros(2, 2, 8),
                         cpu_mesh(2, axis_names=("pp",)))
    with pytest.raises(ValueError, match="not in mesh"):
        pipeline_sharded(_stage, params, torch.zeros(2, 2, 8),
                         cpu_mesh(4, axis_names=("ep",)))
