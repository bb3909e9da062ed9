"""The port's Mixtral-style MoE Llama against the reference's, on the CPU.

The reference's tiny MoE config (``test_models.py``'s
``test_moe_llama_trains_and_decodes``: dim 64, 2 layers, 4 heads, 2 KV
heads, ffn 96, 4 experts, top 2, f32 activations) with its
``init(jax.random.key(0))`` weights carried across by
``llama_params_from_reference``; tokens from a numpy seed. The port's
attention wrappers run their plain versions here. Tolerances: logits,
the loss and the aux within rtol = atol = 2e-4 (the reference's own
MoE test); each gradient leaf within 2e-4 of its largest entry plus
2e-4 relative (``test_torch_train.py``'s rule); greedy tokens and the
bucket lists equal.

The tensor-parallel cases are ``test_torch_llama_tp.py``'s: "mha-tp4"
(4 KV heads on a (2, 4) ("dp", "tp") mesh) and "gqa-tp2" (2 KV heads on
(2, 2)); the reference runs ``shard_params`` and ``forward`` / ``loss``
with ``dp="dp", mesh=`` on the 8 virtual CPU devices. The
sequence-parallel cases run ``forward`` / ``loss`` with ``dp="dp",
sp="sp"`` on a (2, 4) ("dp", "sp") mesh on both sides.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from accl_tpu.models import llama as RL  # noqa: E402
from accl_tpu.parallel import bucketing as jb  # noqa: E402
from accl_tpu.utils.compat import set_mesh  # noqa: E402
from accl_tpu_torch.convert import (llama_params_from_reference,  # noqa: E402
                                    llama_params_to_reference)
from accl_tpu_torch.models import Llama, LlamaConfig  # noqa: E402
from accl_tpu_torch.models import moe as M  # noqa: E402
from accl_tpu_torch.ops import attention as A  # noqa: E402
from accl_tpu_torch.parallel import (cpu_mesh, make_ddp_train_step,  # noqa: E402
                                     plan_from_buckets)
from accl_tpu_torch.parallel import tensor_parallel as TP  # noqa: E402
from accl_tpu_torch.parallel.bucketing import (  # noqa: E402
    _flatten_bucket, tree_flatten)

TOL = 2e-4
TINY = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=96)
MOE = dict(n_experts=4, moe_top_k=2)
B, S = 2, 32
CASES = {"mha-tp4": (4, (2, 4)), "gqa-tp2": (2, (2, 2))}
NAMES = ("dp", "tp")


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


_PAIRS: dict = {}


def _pair(n_kv: int = 2, attention: str = "flash", **kw):
    """(reference model, its numpy params, the port's config)."""
    key = (n_kv, attention, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        tiny = dict(TINY, n_kv_heads=n_kv)
        rcfg = dataclasses.replace(RL.LlamaConfig.tiny(**tiny), **MOE, **kw,
                                   dtype=jnp.float32, attention=attention)
        ref = RL.Llama(rcfg)
        params = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
        pcfg = dataclasses.replace(LlamaConfig.tiny(**tiny), **MOE, **kw,
                                   dtype=torch.float32, attention=attention)
        _PAIRS[key] = (ref, params, pcfg)
    return _PAIRS[key]


def _port(n_kv: int = 2, attention: str = "flash", **kw) -> Llama:
    _, params, pcfg = _pair(n_kv, attention, **kw)
    return Llama(pcfg, device="cpu").load_reference_params(params)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(0, 256, (B, S)).astype(np.int32)


def _t(tok):
    return torch.from_numpy(np.asarray(tok)).long()


def _close(got, want, what: str = ""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def _close_leaves(got: dict, want: dict):
    flat = [(k, got[k], want[k]) for k in ("embed", "final_norm", "lm_head")]
    flat += [(f"layers.{k}", got["layers"][k], w)
             for k, w in want["layers"].items()]
    assert set(got["layers"]) == set(want["layers"])
    for what, g, w in flat:
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, what
        err = np.abs(g - w)
        lim = TOL * float(np.abs(w).max()) + TOL * np.abs(w)
        assert (err <= lim).all(), (f"{what}: max abs err {err.max():.3g}, "
                                    f"{(err / lim).max():.3g} times the "
                                    f"limit")


def _grads(port: Llama) -> dict:
    return llama_params_to_reference({n: p.grad for n, p in
                                      port.named_parameters()})


def test_moe_llama_constructs_with_expert_blocks():
    port = _port()
    c = port.config
    for lyr in port.layers:
        assert isinstance(lyr.moe, M.MoELayer)
        assert not hasattr(lyr, "w_gate")
        assert tuple(lyr.moe.w_gate.shape) == (4, 64, 96)
        assert tuple(lyr.moe.w_down.shape) == (4, 96, 64)
        assert tuple(lyr.moe.router.shape) == (64, 4)
    assert port.param_count() == sum(
        int(np.prod(np.shape(v))) for v in jax.tree.leaves(_pair()[1]))
    mc = port.layers[0].moe.config
    assert (mc.n_experts, mc.top_k, mc.capacity_factor, mc.dim,
            mc.ffn_dim) == (c.n_experts, c.moe_top_k, 1.25, 64, 96)
    assert mc.capacity(S) == 20          # ceil(32 * 2 * 1.25 / 4)


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_forward_matches_reference(attention, tokens):
    ref, params, _ = _pair(attention=attention)
    want, want_aux = ref._forward_with_aux(params, jnp.asarray(tokens))
    port = _port(attention=attention)
    before = dict(A.plain_runs)
    with torch.no_grad():
        got, aux = port._forward_with_aux(_t(tokens))
        plain = port(_t(tokens))
    assert got.dtype == torch.float32 and got.shape == (B, S, 256)
    _close(got, want)
    _close(float(aux), float(want_aux))
    assert torch.equal(plain, got)
    ran = sum(A.plain_runs.values()) - sum(before.values())
    assert ran == (2 * TINY["n_layers"] if attention == "flash" else 0)


def test_forward_cached_step_by_step_matches_reference(tokens):
    """A 20-token prefill (routed as one group, as ``forward`` routes a
    sequence) then 12 one-token decode steps (C = 1: never dropped), each
    step's logits against the reference's ``forward_cached`` on its own
    cache; the prefill also equals the full forward on its tokens."""
    ref, params, _ = _pair()
    port = _port()
    fc = jax.jit(ref.forward_cached, static_argnames=("mesh", "dp", "tp"))
    rcache = ref.init_kv_cache(B, S)
    cache = port.init_kv_cache(B, S)
    P0 = 20
    want, rcache = fc(params, jnp.asarray(tokens[:, :P0]), rcache)
    got, cache = port.forward_cached(_t(tokens[:, :P0]), cache)
    _close(got, want, "prefill")
    with torch.no_grad():
        _close(got, port(_t(tokens[:, :P0])), "prefill vs forward")
    for i in range(P0, S):
        want, rcache = fc(params, jnp.asarray(tokens[:, i:i + 1]), rcache)
        got, cache = port.forward_cached(_t(tokens[:, i:i + 1]), cache)
        _close(got, want, f"decode at {i}")
        _close(cache["k"].numpy(), rcache["k"], f"k cache at {i}")
    assert cache["pos"] == S


def test_whole_prompt_prefill_equals_forward(tokens):
    """The reference's own check (``test_models.py``): the cached forward
    over the whole prompt matches the full forward."""
    port = _port()
    with torch.no_grad():
        full = port(_t(tokens))
    got, _ = port.forward_cached(_t(tokens), port.init_kv_cache(B, S))
    _close(got, full)


def test_generate_matches_reference(tokens):
    ref, params, _ = _pair()
    want = np.asarray(ref.generate(params, jnp.asarray(tokens[:, :5]),
                                   max_new=8))
    got = _port().generate(_t(tokens[:, :5]), max_new=8)
    assert got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_loss_matches_reference_with_the_aux_term(tokens):
    """``loss`` = cross entropy + moe_aux_coef * sum over layers of each
    layer's batch-mean aux, as the reference's; a larger coefficient
    moves both alike."""
    for coef in (0.01, 0.5):
        ref, params, _ = _pair(moe_aux_coef=coef)
        want = float(ref.loss(params, jnp.asarray(tokens)))
        port = _port(moe_aux_coef=coef)
        with torch.no_grad():
            got = float(port.loss(_t(tokens)))
            _, aux = port._forward_with_aux(_t(tokens))
            logits = port(_t(tokens))[:, :-1]
            ce = float(torch.nn.functional.cross_entropy(
                logits.reshape(-1, 256), _t(tokens)[:, 1:].reshape(-1)))
        _close(got, want, f"coef {coef}")
        assert got == pytest.approx(ce + coef * float(aux), rel=1e-6)


def test_train_step_gradients_match_jax_grad(tokens):
    """One train step: every gradient (the experts', the router's
    through the gates, the renormalisation and the aux) against
    ``jax.grad`` of the reference's loss; the loss the step returns;
    the backward ran B10 and B11 once a layer."""
    ref, params, _ = _pair()
    want_loss, want = jax.value_and_grad(ref.loss)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens))
    want = jax.tree.map(np.asarray, want)
    port = _port()
    held = {}

    class Probe(torch.optim.SGD):
        def step(self, closure=None):
            held.update(_grads(port))
            return super().step(closure)

    before = dict(A.plain_runs)
    step = port.make_train_step(Probe(port.parameters(), lr=1e-3))
    loss = step(_t(tokens))
    _close(float(loss), float(want_loss))
    _close_leaves(held, want)
    assert A.plain_runs["bwd_dkv"] - before["bwd_dkv"] == TINY["n_layers"]
    assert A.plain_runs["bwd_dq"] - before["bwd_dq"] == TINY["n_layers"]


def test_training_descends(tokens):
    """The reference test's loop: Adam 1e-3, five steps on one batch."""
    port = _port()
    step = port.make_train_step(torch.optim.Adam(port.parameters(),
                                                 lr=1e-3))
    losses = [float(step(_t(tokens))) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def _ref_key(port_name: str) -> str:
    parts = port_name.split(".")
    if parts[0] == "layers":
        return f"['layers']['{parts[-1]}']"
    return f"['{parts[0]}']"


@pytest.mark.parametrize("bucket_bytes", [1 << 10, 1 << 14, 25 << 20])
def test_grad_buckets_match_reference(bucket_bytes):
    """The MoE leaves in the reference's sorted order (attn_norm,
    mlp_norm, router, w_down, w_gate, w_up, wk, wo, wq, wv), each listed
    as the port's per-layer names in layer order; a plan from the
    buckets fuses the reference plan's bytes bitwise."""
    ref, params, _ = _pair()
    want = ref.grad_buckets(params, bucket_bytes)
    port = _port()
    got = port.grad_buckets(bucket_bytes)
    mapped = []
    for b in got:
        keys = []
        for name in b:
            k = _ref_key(name)
            if k not in keys:
                keys.append(k)
        mapped.append(keys)
    assert mapped == want
    assert any("moe.router" in n for b in got for n in b)
    named = dict(port.named_parameters())
    plan = plan_from_buckets(named, got)
    rplan = jb.make_bucket_plan(params, bucket_bytes)
    assert [b.nbytes for b in plan.buckets] == \
        [b.nbytes for b in rplan.buckets]
    rows = [tree_flatten(named)[0]]
    leaves = jax.tree_util.tree_leaves(params)
    for b, rb in zip(plan.buckets, rplan.buckets):
        assert np.array_equal(_flatten_bucket(b, rows)[0].numpy(),
                              np.asarray(jb._flatten_bucket(rb, leaves)))


def test_ddp_step_on_the_moe_model_equals_fullbatch_step(tokens):
    """``make_ddp_train_step`` on the MoE model: a step over 2 ranks
    (one sequence each: routing is per sequence, so each rank routes what
    the full batch routes) equals the full-batch step within f32
    rounding."""
    a, b = _port(), _port()
    full = a.make_train_step(torch.optim.SGD(a.parameters(), lr=0.5))
    want = full(_t(tokens))
    params = dict(b.named_parameters())
    ddp = make_ddp_train_step(
        b.loss, torch.optim.SGD(b.parameters(), lr=0.5), params,
        cpu_mesh(2, axis_names=("dp",)),
        plan=plan_from_buckets(params, b.grad_buckets(1 << 14)),
        algorithm="ring")
    got = ddp(_t(tokens))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


# -- tensor parallelism -------------------------------------------------------

def _ref_mesh(case: str) -> Mesh:
    shape = CASES[case][1]
    return Mesh(np.array(jax.devices("cpu")[:math.prod(shape)])
                .reshape(shape), NAMES)


def _mesh(case: str):
    return cpu_mesh(8, CASES[case][1], NAMES)


def test_param_specs_match_reference():
    """The expert tensors' specs: the router replicated, gate and up
    split on f (their last dimension), down on its f rows (dimension
    -2), a layer's entry without the reference's layer axis."""
    ref, _, _ = _pair(4)
    port = _port(4)
    want = ref.param_specs("dp", "tp")
    got = port.param_specs("dp", "tp")
    assert set(got) == set(port.state_dict())
    for name, spec in got.items():
        parts = name.split(".")
        if parts[0] == "layers":
            assert spec == tuple(want["layers"][parts[-1]])[1:], name
        else:
            assert spec == tuple(want[name]), name
    assert got["layers.0.moe.w_gate"] == (None, None, "tp")
    assert got["layers.0.moe.w_down"] == (None, "tp", None)
    assert got["layers.0.moe.router"] == (None, None)


@pytest.mark.parametrize("case", CASES)
def test_tp_forward_matches_reference_sharded_forward(case, tokens):
    """dp x tp forward: the reference's sharded params and forward with
    ``dp="dp", mesh=`` against the port's over a ``cpu_mesh``; 2 tp
    all-reduces a layer and 1 for the embedding, as the dense FFN's."""
    n_kv = CASES[case][0]
    ref, params, _ = _pair(n_kv)
    mesh = _ref_mesh(case)
    with set_mesh(mesh):
        p = ref.shard_params(params, mesh)
        t = jax.device_put(tokens, NamedSharding(mesh, P("dp", None)))
        want = np.asarray(jax.jit(lambda p, t: ref.forward(
            p, t, dp="dp", mesh=mesh))(p, t))
    port = _port(n_kv)
    ars = TP.allreduce_calls
    with torch.no_grad():
        got = port(_t(tokens), dp="dp", mesh=_mesh(case))
        unsharded = port(_t(tokens))
    assert TP.allreduce_calls - ars == 2 * TINY["n_layers"] + 1
    _close(got, want)
    _close(got, unsharded)


def test_tp_forward_matches_reference_test_form(tokens):
    """The reference test's own form: sharded params on a (2, 4) mesh,
    ``forward(dp="dp")`` with no mesh (its dense path); the port's tp
    forward over (2, 4) needs 4 KV heads, so its unsharded forward
    stands beside, equal within the same tolerance."""
    ref, params, _ = _pair()
    mesh = _ref_mesh("mha-tp4")
    with set_mesh(mesh):
        p = ref.shard_params(params, mesh)
        t = jax.device_put(tokens, NamedSharding(mesh, P("dp", None)))
        want = np.asarray(jax.jit(lambda p, t: ref.forward(p, t, dp="dp"))(
            p, t))
    with torch.no_grad():
        got = _port()(_t(tokens), dp="dp")
    _close(got, want)


@pytest.mark.parametrize("case", CASES)
def test_tp_loss_and_gradients_match_jax_grad(case, tokens):
    """The tp loss (aux included) and every gradient through the shard
    views against ``jax.grad`` of the reference's tp loss: the router's
    gradient comes through rank 0's routing, the experts' through each
    rank's shards."""
    n_kv = CASES[case][0]
    ref, params, _ = _pair(n_kv)
    mesh = _ref_mesh(case)
    with set_mesh(mesh):
        p = ref.shard_params(params, mesh)
        t = jax.device_put(tokens, NamedSharding(mesh, P("dp", None)))
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda p, t: ref.loss(p, t, dp="dp", mesh=mesh)))(p, t)
    want = jax.tree.map(np.asarray, want)
    port = _port(n_kv).requires_grad_(True)
    loss = port.loss(_t(tokens), dp="dp", mesh=_mesh(case))
    loss.backward()
    _close(float(loss.detach()), float(want_loss))
    _close_leaves(_grads(port), want)


@pytest.mark.parametrize("case", CASES)
def test_tp_generate_matches_unsharded(case, tokens):
    """tp decode over per-rank KV-head shards with expert blocks: the
    greedy tokens of the unsharded model."""
    port = _port(CASES[case][0])
    want = port.generate(_t(tokens[:, :6]), max_new=6)
    got = port.generate(_t(tokens[:, :6]), max_new=6, mesh=_mesh(case),
                        dp="dp")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# -- sequence parallelism with experts -----------------------------------------

SP = dict(dp="dp", sp="sp")


def _sp_ref_mesh() -> Mesh:
    return Mesh(np.array(jax.devices("cpu")[:8]).reshape(2, 4), ("dp", "sp"))


def _sp_on_mesh(mesh, params, tokens):
    return (jax.device_put(params, NamedSharding(mesh, P())),
            jax.device_put(tokens, NamedSharding(mesh, P("dp", "sp"))))


class _RecordingLax:
    """The reference's ``lax`` with ``top_k`` reporting each routed
    group's probabilities and expert indices to the host."""

    def __init__(self, picks: list):
        self._picks = picks

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def top_k(self, probs, k):
        vals, idx = jax.lax.top_k(probs, k)
        jax.debug.callback(
            lambda p, i: self._picks.append((np.asarray(p), np.asarray(i))),
            probs, idx)
        return vals, idx


def test_sp_forward_with_experts_matches_reference(tokens, monkeypatch):
    """The sp forward (ring attention over a (2, 4) ("dp", "sp") mesh)
    with expert blocks against the reference's sp forward, logits and aux
    within TOL; every layer routes every sequence to the same experts."""
    from accl_tpu.models import moe as RM
    ref, params, _ = _pair()
    mesh = _sp_ref_mesh()
    want_probs = []
    monkeypatch.setattr(RM, "lax", _RecordingLax(want_probs))
    with set_mesh(mesh):
        p, t = _sp_on_mesh(mesh, params, tokens)
        want, want_aux = jax.jit(lambda p, t: ref._forward_with_aux(
            p, t, mesh=mesh, **SP))(p, t)
        want, want_aux = np.asarray(want), float(want_aux)
    jax.effects_barrier()
    monkeypatch.undo()
    port = _port()
    got_picks = []
    top_k = M._top_k

    def record(probs, k):
        got_picks.append((probs, top_k(probs, k)))
        return got_picks[-1][1]

    monkeypatch.setattr(M, "_top_k", record)
    with torch.no_grad():
        got, aux = port._forward_with_aux(_t(tokens), mesh=cpu_mesh(
            8, (2, 4), ("dp", "sp")), **SP)
    assert got.shape == (B, S, 256)
    _close(got, want, "sp logits")
    _close(float(aux), want_aux, "sp aux")
    # each of the port's (layer, sequence) groups is the reference's
    # group of the nearest probabilities: the same experts, in order
    L = TINY["n_layers"]
    assert len(got_picks) == L and len(want_probs) == L * B
    for i, (probs, idx) in enumerate(got_picks):
        assert tuple(idx.shape) == (B, S, MOE["moe_top_k"])
        for b in range(B):
            j = min(range(len(want_probs)), key=lambda j: float(np.abs(
                want_probs[j][0] - probs[b].numpy()).max()))
            _close(probs[b], want_probs[j][0], f"layer {i} probs")
            np.testing.assert_array_equal(
                idx[b].numpy(), want_probs[j][1],
                err_msg=f"layer {i}, sequence {b}")


def test_sp_loss_and_gradients_with_experts_match_jax_grad(tokens):
    """The sp loss (the aux term included) and every parameter's
    gradient, the router's among them, against ``jax.grad`` of the
    reference's sp loss on the same (2, 4) mesh; a train step with sp
    returns that loss."""
    ref, params, _ = _pair()
    mesh = _sp_ref_mesh()
    with set_mesh(mesh):
        p, t = _sp_on_mesh(mesh, params, tokens)
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda p, t: ref.loss(p, t, mesh=mesh, **SP)))(p, t)
    want = jax.tree.map(np.asarray, want)
    port = _port()
    held = {}

    class Probe(torch.optim.SGD):
        def step(self, closure=None):
            held.update(_grads(port))
            return super().step(closure)

    step = port.make_train_step(Probe(port.parameters(), lr=1e-3),
                                mesh=cpu_mesh(8, (2, 4), ("dp", "sp")), **SP)
    loss = step(_t(tokens))
    _close(float(loss), float(want_loss))
    _close_leaves(held, want)
    assert float(np.abs(held["layers"]["router"]).max()) > 0


def test_convert_round_trip_of_the_moe_leaves():
    """Reference pytree -> state dict -> reference pytree, every leaf
    bitwise (f32 and bf16); the expert leaves land under
    ``layers.<i>.moe.``; a missing expert leaf is refused."""
    _, params, _ = _pair()
    sd = llama_params_from_reference(params)
    assert tuple(sd["layers.1.moe.w_gate"].shape) == (4, 64, 96)
    assert tuple(sd["layers.0.moe.router"].shape) == (64, 4)
    back = llama_params_to_reference(sd)
    assert set(back["layers"]) == set(params["layers"])
    for k, v in params["layers"].items():
        np.testing.assert_array_equal(back["layers"][k], v)
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(back[k], params[k])
    bf16 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        params)
    back16 = llama_params_to_reference(llama_params_from_reference(bf16))
    for k, v in bf16["layers"].items():
        assert back16["layers"][k].dtype == v.dtype
        np.testing.assert_array_equal(back16["layers"][k].view(np.uint16),
                                      v.view(np.uint16))
    broken = dict(params, layers={k: v for k, v in params["layers"].items()
                                  if k != "w_up"})
    with pytest.raises(KeyError, match="w_up"):
        llama_params_from_reference(broken)


def _route_grads(port, tokens, picks, replay: bool) -> dict:
    """Every gradient of one loss backward; the pass records its expert
    choices into ``picks``, or with ``replay`` takes them from there."""
    top_k = M._top_k
    it = iter(list(picks))

    def record(probs, k):
        picks.append(top_k(probs, k))
        return picks[-1]

    try:
        M._top_k = (lambda probs, k: next(it)) if replay else record
        port.loss(_t(tokens)).backward()
    finally:
        M._top_k = top_k
    grads = {n: p.grad for n, p in port.named_parameters()}
    port.zero_grad(set_to_none=True)
    return grads


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


@pytest.mark.parametrize("experts", [0, 4])
def test_bf16_route_gradients_within_the_chip_bound(experts, tokens):
    """The rule of chip_smoke's phase 15b on a bf16 model here, with the
    plain versions of B8/B10/B11 as the kernel route: against the f32
    plain route (attention="dense", f32 activations), every leaf's
    gradient of the kernel route is within 1.5 times the bf16 plain
    route's distance (relative L2), both later passes replaying the
    first one's expert choices. The two bf16 routes round differently,
    each about as far from f32 as the other (printed)."""
    cfg = dataclasses.replace(LlamaConfig.tiny(**TINY), n_experts=experts,
                              max_seq_len=S)
    port = Llama(cfg, device="cpu").init(
        torch.Generator().manual_seed(3)).requires_grad_(True)
    picks = []
    kernel = _route_grads(port, tokens, picks, replay=False)
    port.config = dataclasses.replace(cfg, attention="dense")
    plain = _route_grads(port, tokens, picks, replay=True)
    port.config = dataclasses.replace(cfg, attention="dense",
                                      dtype=torch.float32)
    f32 = _route_grads(port, tokens, picks, replay=True)
    ratio = {n: _rel(kernel[n], f32[n]) / _rel(plain[n], f32[n])
             for n in f32}
    worst = max(ratio, key=ratio.get)
    far = max(f32, key=lambda n: _rel(kernel[n], f32[n]))
    print(f"bf16, {experts} experts: worst ratio {worst} "
          f"{ratio[worst]:.3f}; farthest from f32 {far} kernel "
          f"{_rel(kernel[far], f32[far]):.3e}, plain "
          f"{_rel(plain[far], f32[far]):.3e}; kernel vs plain worst "
          f"{max(_rel(kernel[n], plain[n]) for n in f32):.3e}")
    assert len(picks) == (TINY["n_layers"] if experts else 0)
    assert ratio[worst] <= 1.5, (worst, ratio[worst])
