"""The port's tensor-parallel Llama against the reference's, on the CPU.

Tiny f32 configs (dim 64, 2 layers, 4 q heads) with the reference's
``init(jax.random.key(0))`` weights carried across by
``llama_params_from_reference``, in the reference's two tp cases:
"mha-tp4" (4 KV heads, a (2, 4) ("dp", "tp") mesh) and "gqa-tp2" (2 KV
heads, a (2, 2) mesh). The reference runs ``shard_params`` and
``forward`` / ``loss`` / ``forward_cached`` / ``generate`` with
``dp="dp", mesh=`` on the 8 virtual CPU devices (its attention under
shard_map over the tp head shards, the Pallas kernels in interpret
mode); the port runs the same arguments over a ``cpu_mesh`` of virtual
ranks (column and row shards as views of its parameters, the tp
all-reduces through ``RankCollectives``, the plain versions of B9-B12 a
visible launch). Tolerances: logits, caches and the loss within rtol =
atol = 2e-4 (the reference's own tensor-parallel test); each gradient
leaf within 2e-4 of its own largest entry plus 2e-4 relative
(``test_torch_train.py``'s rule); shards bitwise; greedy tokens equal.
"""

from __future__ import annotations

import dataclasses
import inspect
import math

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
from accl_tpu_torch.parallel import RankCollectives, cpu_mesh  # noqa: E402
from accl_tpu_torch.parallel import tensor_parallel as TP  # noqa: E402

TOL = 2e-4
TINY = dict(dim=64, n_layers=2, n_heads=4, ffn_dim=128)
B, S = 4, 32
# case: (n_kv_heads, mesh shape); the reference's tensor-parallel cases
CASES = {"mha-tp4": (4, (2, 4)), "gqa-tp2": (2, (2, 2))}
NAMES = ("dp", "tp")
# a forward: 2 all-reduces a layer (wo, down) and 1 for the embedding
AR_PER_PASS = 2 * TINY["n_layers"] + 1


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


_PAIRS: dict = {}


def _pair(case: str, attention: str = "flash"):
    """(reference model, its numpy params, the port's config)."""
    key = (case, attention)
    if key not in _PAIRS:
        n_kv = CASES[case][0]
        rcfg = dataclasses.replace(RL.LlamaConfig.tiny(**TINY,
                                                       n_kv_heads=n_kv),
                                   dtype=jnp.float32, attention=attention)
        ref = RL.Llama(rcfg)
        params = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
        pcfg = dataclasses.replace(LlamaConfig.tiny(**TINY, n_kv_heads=n_kv),
                                   dtype=torch.float32, attention=attention)
        _PAIRS[key] = (ref, params, pcfg)
    return _PAIRS[key]


def _port(case: str, attention: str = "flash") -> Llama:
    _ref, params, pcfg = _pair(case, attention)
    return Llama(pcfg, device="cpu").load_reference_params(params)


def _ref_mesh(case: str) -> Mesh:
    shape = CASES[case][1]
    return Mesh(np.array(jax.devices("cpu")[:math.prod(shape)])
                .reshape(shape), NAMES)


def _mesh(case: str):
    return cpu_mesh(8, CASES[case][1], NAMES)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(0, 256, (B, S)).astype(np.int32)


def _t(tok):
    return torch.from_numpy(np.asarray(tok)).long()


def _ref_sharded(case, params, tokens):
    """The reference's params through its ``shard_params`` and the tokens
    split over dp, on the case's mesh (call under ``set_mesh``)."""
    ref, _, _ = _pair(case)
    mesh = _ref_mesh(case)
    return (ref.shard_params(params, mesh),
            jax.device_put(tokens, NamedSharding(mesh, P("dp", None))))


def test_param_specs_match_reference():
    """Each entry of the port's ``param_specs`` is the reference's spec
    (a layer's without its leading layer axis), for every parameter."""
    ref, _, _ = _pair("gqa-tp2")
    port = _port("gqa-tp2")
    for names in (("dp", "tp"), ("data", "model")):
        want = ref.param_specs(*names)
        got = port.param_specs(*names)
        assert set(got) == set(port.state_dict())
        for name, spec in got.items():
            parts = name.split(".")
            if parts[0] == "layers":
                assert spec == tuple(want["layers"][parts[2]])[1:], name
            else:
                assert spec == tuple(want[name]), name
            assert len(spec) == port.get_parameter(name).dim(), name


@pytest.mark.parametrize("case", CASES)
def test_shard_params_match_reference_shards(case):
    """Every rank's shard of the port's ``shard_params`` equals, bitwise,
    the addressable shard of the reference's ``shard_params`` on each
    device of that tp index (every dp index); a replicated parameter is
    the parameter itself, equal to every device's shard. The shards are
    views: no weight is copied."""
    ref, params, _ = _pair(case)
    mesh = _ref_mesh(case)
    where = {d: idx for idx, d in np.ndenumerate(mesh.devices)}
    port = _port(case)
    shards = port.shard_params(_mesh(case), dp="dp", tp="tp")
    masters = dict(port.named_parameters())
    want = ref.shard_params(params, mesh)
    flat = [(k, want[k]) for k in ("embed", "final_norm", "lm_head")]
    flat += [(f"layers.{k}", v) for k, v in want["layers"].items()]
    n_cmp = 0
    for key, arr in flat:
        for sh in arr.addressable_shards:
            _dp, r = where[sh.device]
            data = np.asarray(sh.data)
            if key.startswith("layers."):
                leaf = key.split(".")[1]
                pairs = [(f"layers.{i}.{leaf}", data[i])
                         for i in range(data.shape[0])]
            else:
                pairs = [(key, data)]
            for name, w in pairs:
                got = shards[name]
                if got is not masters[name]:
                    assert got.shape[0] == CASES[case][1][1], name
                    got = got[r]
                np.testing.assert_array_equal(got.numpy(), w, err_msg=name)
                n_cmp += 1
    assert n_cmp == math.prod(CASES[case][1]) * len(masters)
    for name, sh in shards.items():
        assert sh.untyped_storage().data_ptr() == \
            masters[name].untyped_storage().data_ptr(), name


def test_shard_params_refuses_indivisible_dimensions():
    """A parameter dimension the tp axis does not split evenly is
    refused (the reference's device_put refuses it too)."""
    cfg = dataclasses.replace(LlamaConfig.tiny(vocab=250, **TINY),
                              dtype=torch.float32)
    port = Llama(cfg, device="cpu")
    with pytest.raises(ValueError, match="does not split into 4 tp shards"):
        port.shard_params(cpu_mesh(8, (2, 4), NAMES))
    with pytest.raises(ValueError, match="tp axis 'zz' not in mesh"):
        port.shard_params(cpu_mesh(8, (2, 4), NAMES), tp="zz")


@pytest.mark.parametrize("case", CASES)
def test_tp_forward_matches_reference_and_unsharded(case, tokens):
    """The tp forward against the reference's (its flash attention under
    shard_map over the tp head shards) and the port's unsharded forward;
    one attention launch a layer over every rank's heads, 2 tp
    all-reduces a layer and 1 for the embedding."""
    ref, params, _ = _pair(case)
    mesh = _ref_mesh(case)
    with set_mesh(mesh):
        p, t = _ref_sharded(case, params, tokens)
        want = np.asarray(jax.jit(lambda p, t: ref.forward(
            p, t, dp="dp", mesh=mesh))(p, t))
    port = _port(case)
    runs, ars = dict(A.plain_runs), TP.allreduce_calls
    with torch.no_grad():
        got = port(_t(tokens), dp="dp", mesh=_mesh(case))
    assert A.plain_runs["fwd_single"] - runs["fwd_single"] == \
        TINY["n_layers"]
    assert sum(A.plain_runs.values()) - sum(runs.values()) == \
        TINY["n_layers"]
    assert TP.allreduce_calls - ars == AR_PER_PASS
    with torch.no_grad():
        unsharded = port(_t(tokens))
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


@pytest.mark.parametrize("case", CASES)
def test_tp_loss_and_gradients_match_jax_grad(case, tokens):
    """The loss and every parameter's gradient (through the shard views,
    onto the parameters) against ``jax.grad`` of the reference's tp
    ``loss``; the backward ran B10 and B11 once a layer and one tp
    all-reduce for each of the forward's."""
    ref, params, _ = _pair(case)
    mesh = _ref_mesh(case)
    with set_mesh(mesh):
        p, t = _ref_sharded(case, params, tokens)
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda p, t: ref.loss(p, t, dp="dp", mesh=mesh)))(p, t)
    want = jax.tree.map(np.asarray, want)
    port = _port(case).requires_grad_(True)
    runs, ars = dict(A.plain_runs), TP.allreduce_calls
    loss = port.loss(_t(tokens), dp="dp", mesh=_mesh(case))
    loss.backward()
    for key in ("bwd_dkv", "bwd_dq"):
        assert A.plain_runs[key] - runs[key] == TINY["n_layers"]
    assert TP.allreduce_calls - ars == 2 * AR_PER_PASS
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=TOL, atol=TOL)
    grads = {k: p.grad for k, p in port.named_parameters()}
    _close_leaves(llama_params_to_reference(grads), want)


@pytest.mark.parametrize("case", CASES)
def test_tp_train_steps_descend(case, tokens):
    port = _port(case)
    step = port.make_train_step(torch.optim.Adam(port.parameters(),
                                                 lr=1e-3),
                                dp="dp", mesh=_mesh(case))
    l0, l1 = float(step(_t(tokens))), float(step(_t(tokens)))
    assert np.isfinite(l0) and l1 < l0, (l0, l1)


def _gathered(cache_t: torch.Tensor) -> np.ndarray:
    """A sharded cache tensor (L, T, B, max_len, Hkv/T, hd) gathered to
    the reference's (L, B, max_len, Hkv, hd)."""
    L, T, b, m, h, d = cache_t.shape
    return cache_t.permute(0, 2, 3, 1, 4, 5).reshape(L, b, m, T * h,
                                                     d).numpy()


@pytest.mark.parametrize("case", CASES)
def test_tp_forward_cached_matches_reference_per_step(case, tokens):
    """A prefill of 6 tokens, then 4 decode steps, each against the
    reference's tp ``forward_cached`` (B12 per KV-head shard under
    shard_map): the logits, and the cache shards gathered against the
    reference's cache. One B12 launch a layer a step over every rank's
    shard, written in place (the cache tensors stay the same)."""
    ref, params, _ = _pair(case)
    mesh = _ref_mesh(case)
    n = 10
    step = jax.jit(ref.forward_cached, static_argnames=("mesh", "dp", "tp"))
    port = _port(case)
    pmesh = _mesh(case)
    cache = port.init_kv_cache(B, n, mesh=pmesh)
    T = CASES[case][1][1]
    assert cache["k"].shape == (TINY["n_layers"], T, B, n, CASES[case][0]
                                // T, 16)
    k_ptr = cache["k"].data_ptr()
    rcache = ref.init_kv_cache(B, n)
    with set_mesh(mesh):
        p, _t0 = _ref_sharded(case, params, tokens)
        for a, b in ((0, 6), (6, 7), (7, 8), (8, 9), (9, 10)):
            t = jax.device_put(tokens[:, a:b],
                               NamedSharding(mesh, P("dp", None)))
            want, rcache = step(p, t, rcache, mesh=mesh, dp="dp")
            runs, ars = A.plain_runs["decode"], TP.allreduce_calls
            got, cache = port.forward_cached(_t(tokens[:, a:b]), cache,
                                             mesh=pmesh, dp="dp")
            assert A.plain_runs["decode"] - runs == TINY["n_layers"]
            assert TP.allreduce_calls - ars == AR_PER_PASS
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"tokens {a}..{b}")
    assert cache["pos"] == n and cache["k"].data_ptr() == k_ptr
    for key in ("k", "v"):
        np.testing.assert_allclose(_gathered(cache[key]),
                                   np.asarray(rcache[key]), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_tp_generate_matches_reference_and_unsharded(case, tokens):
    ref, params, _ = _pair(case)
    mesh = _ref_mesh(case)
    prompt = tokens[:, :5]
    want_unsharded = np.asarray(ref.generate(params, jnp.asarray(prompt),
                                             max_new=6))
    with set_mesh(mesh):
        p, _t0 = _ref_sharded(case, params, tokens)
        want = np.asarray(ref.generate(
            p, jax.device_put(prompt, NamedSharding(mesh, P("dp", None))),
            max_new=6, mesh=mesh, dp="dp"))
    port = _port(case)
    got = port.generate(_t(prompt), max_new=6, mesh=_mesh(case), dp="dp")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want_unsharded)
    np.testing.assert_array_equal(
        port.generate(_t(prompt), max_new=6).numpy(), want)


def test_dense_with_mesh_takes_the_unsharded_dense_path(tokens):
    """``attention="dense"`` with a mesh runs the reference's dense
    branch: no kernel launch and no tp all-reduce, the dense model's
    logits unsharded, the reference's sharded dense forward within the
    tolerance."""
    case = "mha-tp4"
    ref, params, _ = _pair(case, "dense")
    mesh = _ref_mesh(case)
    with set_mesh(mesh):
        p, t = _ref_sharded(case, params, tokens)
        want = np.asarray(jax.jit(lambda p, t: ref.forward(
            p, t, dp="dp", mesh=mesh))(p, t))
    port = _port(case, "dense")
    runs, ars = dict(A.plain_runs), TP.allreduce_calls
    with torch.no_grad():
        got = port(_t(tokens), dp="dp", mesh=_mesh(case))
        assert torch.equal(got, port(_t(tokens)))
    assert A.plain_runs == runs and TP.allreduce_calls == ars
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# (entry point, case, config attention, kwargs, batch)
ERRORS = {
    "forward tp axis": ("forward", "mha-tp4", "flash", dict(tp="zz"), B),
    "forward heads": ("forward", "gqa-tp2", "flash", {}, B),
    "forward batch": ("forward", "mha-tp4", "flash", dict(dp="dp"), 3),
    "forward dp axis": ("forward", "mha-tp4", "flash", dict(dp="qq"), B),
    "cached dense": ("cached", "mha-tp4", "dense", {}, B),
    "cached tp axis": ("cached", "mha-tp4", "flash", dict(tp="zz"), B),
    "cached heads": ("cached", "gqa-tp2", "flash", {}, B),
    "cached dp axis": ("cached", "mha-tp4", "flash", dict(dp="qq"), B),
    "cached batch": ("cached", "mha-tp4", "flash", dict(dp="dp"), 3),
}


@pytest.mark.parametrize("what", ERRORS)
def test_tp_errors_match_reference(what, tokens):
    """The reference's ValueErrors, word for word, read from its run.
    The gqa case (2 KV heads) meets a (2, 4) mesh. With dp given, the
    reference's forward raises JAX's own error at its embedding's
    sharding constraint before its "dp axis" check runs; the port raises
    that check's text (the reference's sp branch), read from its
    source."""
    entry, case, attention, kw, b = ERRORS[what]
    ref, params, _ = _pair(case, attention)
    mesh = _ref_mesh("mha-tp4")
    toks = tokens[:b, :16]
    port = _port(case, attention)
    pmesh = cpu_mesh(8, (2, 4), NAMES)
    with pytest.raises(ValueError) as e:
        if entry == "forward":
            port(_t(toks), mesh=pmesh, **kw)
        else:
            port.forward_cached(_t(toks), port.init_kv_cache(b, 16),
                                mesh=pmesh, **kw)
    got = str(e.value)
    if what == "forward dp axis":
        assert got == "dp axis 'qq' not in mesh ('dp', 'tp')"
        assert 'f"dp axis {dp!r} not in mesh "' in inspect.getsource(
            RL.Llama._forward_with_aux)
        return
    with set_mesh(mesh), pytest.raises(ValueError) as e:
        if entry == "forward" and "dp" in kw:
            jax.jit(lambda p, t: ref.forward(p, t, mesh=mesh, **kw)).trace(
                params, jnp.asarray(toks))
        elif entry == "forward":
            ref.forward(params, jnp.asarray(toks), mesh=mesh, **kw)
        else:
            ref.forward_cached(params, jnp.asarray(toks),
                               ref.init_kv_cache(b, 16), mesh=mesh, **kw)
    assert got == str(e.value)


@pytest.mark.parametrize("layout", ["sharded without mesh",
                                    "unsharded with mesh",
                                    "sharded for another tp size"])
def test_forward_cached_refuses_a_cache_of_another_layout(layout, tokens):
    port = _port("mha-tp4")
    mesh4, mesh2 = _mesh("mha-tp4"), cpu_mesh(8, (2, 2), NAMES)
    cache, mesh = {
        "sharded without mesh": (port.init_kv_cache(B, 16, mesh=mesh4),
                                 None),
        "unsharded with mesh": (port.init_kv_cache(B, 16), mesh4),
        "sharded for another tp size": (
            port.init_kv_cache(B, 16, mesh=mesh2), mesh4)}[layout]
    with pytest.raises(ValueError, match="forward_cached: a cache of k"):
        port.forward_cached(_t(tokens[:, :4]), cache, mesh=mesh)
    assert cache["pos"] == 0 and not cache["k"].any()


def test_tp_allreduce_sums_rows_and_gradients():
    """``tp_allreduce`` puts the sum of the T rows in every row, and
    each input row's gradient is the sum of the T gradient rows;
    ``vocab_parallel_embed`` equals the table's lookup in every row."""
    g = torch.Generator().manual_seed(3)
    coll = RankCollectives(cpu_mesh(8, (2, 4), NAMES).group("tp"))
    x = torch.randn(4, 3, 5, generator=g, dtype=torch.float64,
                    requires_grad=True)
    y = TP.tp_allreduce(x, coll)
    assert torch.equal(y, x.detach().sum(0).expand_as(y))
    w = torch.randn(4, 3, 5, generator=g, dtype=torch.float64)
    (y * w).sum().backward()
    assert torch.equal(x.grad, w.sum(0).expand_as(w))
    table = torch.randn(16, 6, generator=g)
    ids = torch.randint(0, 16, (2, 7), generator=g)
    rows = TP.vocab_parallel_embed(ids, TP.shard_view(table, 0, 4), coll,
                                   torch.bfloat16)
    assert rows.shape == (4, 2, 7, 6)
    for r in range(4):
        assert torch.equal(rows[r], table[ids].to(torch.bfloat16))
