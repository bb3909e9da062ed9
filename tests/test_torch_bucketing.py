"""The bucketed data-parallel all-reduce against the reference's.

``make_bucket_plan`` is held slot for slot to ``accl_tpu.parallel``'s
plan on the same trees (cover, reverse order, per dtype, the leaf-count
check); ``bucketed_allreduce`` on ``cpu_mesh(8)`` rank rows against the
reference under ``shard_map`` on the 8 virtual CPU devices ("ring": the
reference's ring bitwise and within 8 f32 roundings of a float64 mean;
"xla" and the bf16 wire within stated bounds); ``make_ddp_train_step``
over 4 ranks against the full-batch SGD step, as the reference's test
holds its own; ``Llama.grad_buckets`` against the reference's buckets
under the name mapping of ``accl_tpu_torch.convert``, and the plan built
from them against the reference's plan over its stacked parameters.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from accl_tpu.models.llama import Llama as JLlama  # noqa: E402
from accl_tpu.models.llama import LlamaConfig as JConfig  # noqa: E402
from accl_tpu.parallel import bucketing as jb  # noqa: E402
from accl_tpu.parallel import cpu_mesh as j_cpu_mesh  # noqa: E402
from accl_tpu.utils.compat import shard_map  # noqa: E402
from accl_tpu_torch.arith import dtype_name  # noqa: E402
from accl_tpu_torch.models import Llama, LlamaConfig  # noqa: E402
from accl_tpu_torch.parallel import (  # noqa: E402
    RankCollectives, bucketed_allreduce, cpu_mesh, make_bucket_plan,
    make_ddp_train_step, plan_from_buckets)
from accl_tpu_torch.parallel.bucketing import (tree_flatten,  # noqa: E402
                                               tree_unflatten)

@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and /dev/shm is shared by every worker of a
    parallel run, so the sweep would count another worker's live
    segments against this module's tests."""
    yield


W = 8


def small_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w1": rng.standard_normal((32, 16)).astype(np.float32),
        "b1": rng.standard_normal(16).astype(np.float32),
        "w2": rng.standard_normal((16, 8)).astype(np.float32),
        "emb": rng.standard_normal((64, 32)).astype(np.float32),
    }


def mixed_tree():
    rng = np.random.default_rng(3)
    return {"a": rng.standard_normal(40).astype(np.float32),
            "b": rng.standard_normal((4, 6)).astype(np.float16),
            "c": {"x": rng.standard_normal((3, 5)).astype(np.float32),
                  "y": [rng.standard_normal(7).astype(np.float16),
                        rng.standard_normal((2, 9)).astype(np.float32)]},
            "d": rng.standard_normal(12).astype(np.float32)}


def to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def plan_rows(plan, port: bool):
    """Every bucket as (nbytes, dtype name, slots as tuples)."""
    return [(b.nbytes, dtype_name(b.dtype) if port else np.dtype(b.dtype).name,
             [(s.leaf_index, s.offset, s.size, tuple(s.shape))
              for s in b.slots]) for b in plan.buckets]


@pytest.mark.parametrize("tree_fn", [small_tree, mixed_tree])
@pytest.mark.parametrize("bucket_bytes", [8, 64, 1024, 2048, 1 << 20])
def test_plan_matches_reference(tree_fn, bucket_bytes):
    """The same buckets, slot for slot: reverse leaf order, one bucket
    list per dtype, closed at bucket_bytes."""
    tree = tree_fn()
    ref = jb.make_bucket_plan(tree, bucket_bytes)
    got = make_bucket_plan(to_torch(tree), bucket_bytes)
    assert plan_rows(got, True) == plan_rows(ref, False)
    assert (got.n_leaves, got.total_bytes) == (ref.n_leaves, ref.total_bytes)
    assert got.describe() == ref.describe()


def test_plan_covers_all_leaves_once():
    tree = to_torch(small_tree())
    plan = make_bucket_plan(tree, bucket_bytes=1024)
    seen = sorted(s.leaf_index for b in plan.buckets for s in b.slots)
    assert seen == list(range(plan.n_leaves))
    assert plan.total_bytes == sum(v.numel() * 4 for v in tree.values())
    assert len(plan.buckets) > 1


def test_plan_reverse_order_and_dtypes():
    plan = make_bucket_plan({"a": torch.zeros(4), "z": torch.zeros(4)}, 8)
    assert plan.buckets[0].slots[0].leaf_index == plan.n_leaves - 1
    plan = make_bucket_plan(to_torch(mixed_tree()), 1 << 20)
    for b in plan.buckets:
        assert all(s.dtype == b.dtype for s in b.slots)


def test_tree_round_trip_in_jax_order():
    tree = to_torch(mixed_tree())
    leaves, treedef = tree_flatten(tree)
    ref = jax.tree_util.tree_leaves(mixed_tree())
    assert [tuple(x.shape) for x in leaves] == [x.shape for x in ref]
    back = tree_unflatten(treedef, leaves)
    assert jax.tree.map(lambda a, b: a is b, back, tree) == jax.tree.map(
        lambda a: True, tree)


def test_prebuilt_plan_and_leaf_mismatch():
    """A plan built for another tree is refused, in both packages."""
    tree = small_tree()
    with pytest.raises(ValueError):
        jb.bucketed_allreduce({"only": tree["w1"]}, "dp",
                              plan=jb.make_bucket_plan(tree))
    plan = make_bucket_plan(to_torch(tree))
    coll = RankCollectives(cpu_mesh(2).group("rank"))
    rows = [{"only": torch.from_numpy(tree["w1"])} for _ in range(2)]
    with pytest.raises(ValueError, match="plan built for 4 leaves"):
        bucketed_allreduce(rows, coll, plan=plan)
    with pytest.raises(ValueError, match="expected 2 rank"):
        bucketed_allreduce(rows[:1], coll, plan=plan)


def _reference_allreduce(trees, algorithm, wire):
    mesh = j_cpu_mesh(W, axis_names=("dp",))
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *trees)

    def shard_fn(t):
        local = jax.tree.map(lambda x: x[0], t)
        out = jb.bucketed_allreduce(local, "dp", bucket_bytes=2048,
                                    wire_dtype=wire, algorithm=algorithm)
        return jax.tree.map(lambda x: x[None], out)

    f = jax.jit(shard_map(shard_fn, mesh=mesh, in_specs=P("dp"),
                          out_specs=P("dp")))
    out = f(jax.device_put(stacked, NamedSharding(mesh, P("dp"))))
    return {k: np.asarray(v) for k, v in out.items()}


# the bound each result is held to around the float64 mean of the 8 rows:
# (W - 1) f32 roundings of partial sums of at most sum|x| plus the divide
# (f32); on a bf16 wire every hop also rounds its payload to bf16 (u = 2^-8)
F32_U, BF16_U = 2.0 ** -24, 2.0 ** -8


def _bound(trees, k, wire):
    absum = sum(np.abs(t[k].astype(np.float64)) for t in trees) / W
    u = BF16_U if wire else F32_U
    hops = 2 * (W - 1) if wire else W - 1
    return ((1 + u) ** (hops + 1) - 1) * absum + 1e-30


@pytest.mark.parametrize("algorithm", ["xla", "ring"])
@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_bucketed_allreduce_matches_reference(algorithm, wire):
    """Every rank's result within the bound of the float64 mean and
    against the reference's: the fp32 ring bitwise (the same hop order
    and roundings), the rest within the same bound. The ranks agree
    bitwise except on the ring's bf16 wire, where each rank's own chunk
    lands exact and the others through the wire, as in the reference."""
    trees = [small_tree(seed=r) for r in range(W)]
    coll = RankCollectives(cpu_mesh(W).group("rank"))
    got = bucketed_allreduce([to_torch(t) for t in trees], coll,
                             bucket_bytes=2048, wire_dtype=wire,
                             algorithm=algorithm)
    ref = _reference_allreduce(trees, algorithm, wire)
    for k in trees[0]:
        mean = np.mean(np.stack([t[k].astype(np.float64) for t in trees]), 0)
        bd = _bound(trees, k, wire)
        for r in range(W):
            g = got[r][k].numpy()
            assert g.dtype == np.float32 and g.shape == trees[0][k].shape
            if not (algorithm == "ring" and wire):
                assert np.array_equal(g, got[0][k].numpy())
            assert (np.abs(g - mean) <= bd).all(), (k, r)
            if algorithm == "ring" and wire is None:
                assert np.array_equal(g, ref[k][r]), (k, r)
            else:
                assert (np.abs(g - ref[k][r]) <= 2 * bd).all(), (k, r)


def test_bucketed_allreduce_in_place_and_max():
    """``out=grads`` writes the rows in place; MAX is not averaged."""
    trees = [to_torch(small_tree(seed=r)) for r in range(4)]
    want = {k: torch.stack([t[k] for t in trees]).amax(0) for k in trees[0]}
    coll = RankCollectives(cpu_mesh(4).group("rank"))
    ptrs = [t["w1"].data_ptr() for t in trees]
    from accl_tpu_torch.constants import ReduceFunc
    out = bucketed_allreduce(trees, coll, bucket_bytes=1024, out=trees,
                             algorithm="ring", func=ReduceFunc.MAX)
    assert out[0] is trees[0]
    assert [t["w1"].data_ptr() for t in trees] == ptrs
    for t in trees:
        for k in want:
            assert torch.equal(t[k], want[k])


def test_ddp_train_step_matches_fullbatch():
    """The DDP step over 4 ranks equals the one-process SGD step on the
    full batch, and the reference's DDP step (its test's inputs)."""
    import optax
    rng = np.random.default_rng(0)
    params_np = {"w": rng.standard_normal((8, 4)).astype(np.float32),
                 "b": np.zeros(4, np.float32)}
    batch = rng.standard_normal((16, 8)).astype(np.float32)

    def j_loss(p, x):
        return jnp.mean((x @ p["w"] + p["b"]) ** 2)

    jmesh = j_cpu_mesh(4, axis_names=("dp",))
    opt = optax.sgd(0.1)
    step = jb.make_ddp_train_step(j_loss, opt, axis_name="dp",
                                  bucket_bytes=64)

    def shard_fn(p, s, x):
        new_p, new_s, loss = step(p, s, x)
        return new_p, new_s, loss[None]

    f = jax.jit(shard_map(shard_fn, mesh=jmesh,
                          in_specs=(P(), P(), P("dp")),
                          out_specs=(P(), P(), P("dp")), check_vma=False))
    ref_p, _, ref_loss = f(params_np, opt.init(params_np),
                           jax.device_put(batch, NamedSharding(jmesh,
                                                               P("dp"))))
    # the golden: one process, full batch, torch autograd and SGD
    gold = {k: torch.from_numpy(v.copy()).requires_grad_(True)
            for k, v in params_np.items()}
    x = torch.from_numpy(batch)
    gold_loss = torch.mean((x @ gold["w"] + gold["b"]) ** 2)
    gold_loss.backward()
    with torch.no_grad():
        for p in gold.values():
            p -= 0.1 * p.grad
    params = {k: torch.from_numpy(v.copy()) for k, v in params_np.items()}
    mesh = cpu_mesh(4, axis_names=("dp",))
    ddp = make_ddp_train_step(
        lambda s: torch.mean((s @ params["w"] + params["b"]) ** 2),
        torch.optim.SGD(list(params.values()), lr=0.1), params, mesh,
        bucket_bytes=64, algorithm="ring")
    loss = ddp(x)
    for k in params:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   gold[k].detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(ref_p[k]), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(float(loss), float(gold_loss.detach()),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ref_loss), float(loss), rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        ddp(x[:6])


def _tiny_pair(n_layers=2):
    jcfg = JConfig.tiny(n_layers=n_layers)
    jparams = JLlama(jcfg).init(jax.random.PRNGKey(0))
    model = Llama(LlamaConfig.tiny(n_layers=n_layers), device="cpu")
    model.load_reference_params(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, model


def _ref_key(port_name: str) -> str:
    parts = port_name.split(".")
    if parts[0] == "layers":
        return f"['layers']['{parts[2]}']"
    return f"['{parts[0]}']"


@pytest.mark.parametrize("bucket_bytes", [1 << 10, 1 << 14, 25 << 20])
def test_grad_buckets_match_reference(bucket_bytes):
    """The port's buckets are the reference's under the name mapping:
    each reference leaf (a weight stacked over the layers) lists the
    port's per-layer names of that weight, in layer order."""
    jcfg, jparams, model = _tiny_pair(n_layers=3)
    ref = JLlama(jcfg).grad_buckets(jparams, bucket_bytes)
    got = model.grad_buckets(bucket_bytes)
    mapped = []
    for b in got:
        keys = []
        for name in b:
            k = _ref_key(name)
            if k not in keys:
                keys.append(k)
        mapped.append(keys)
    assert mapped == ref
    for b in got:
        for name in b:
            if name.startswith("layers."):
                layer_names = [n for n in b if n.endswith(
                    "." + name.split(".")[2])]
                assert layer_names == [
                    f"layers.{i}.{name.split('.')[2]}" for i in range(3)]


def test_plan_from_grad_buckets_fuses_the_reference_buffers():
    """A plan from ``grad_buckets`` fuses, bucket by bucket, the same
    bytes as the reference's plan over its stacked parameters."""
    jcfg, jparams, model = _tiny_pair()
    params = dict(model.named_parameters())
    plan = plan_from_buckets(params, model.grad_buckets(1 << 14))
    ref = jb.make_bucket_plan(jparams, 1 << 14)
    assert [b.nbytes for b in plan.buckets] == [b.nbytes for b in ref.buckets]
    rows = [tree_flatten(params)[0]]
    jleaves = jax.tree_util.tree_leaves(jparams)
    from accl_tpu_torch.parallel.bucketing import _flatten_bucket
    for b, rb in zip(plan.buckets, ref.buckets):
        got = _flatten_bucket(b, rows)[0].detach().numpy()
        want = np.asarray(jb._flatten_bucket(rb, jleaves))
        assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="every key"):
        plan_from_buckets(params, [["embed"]])


def test_llama_ddp_step_equals_fullbatch_step():
    """On a tiny f32 Llama, a DDP step over 2 ranks (each one sequence,
    the ring, the reference's buckets) and the full-batch step give the
    same loss and parameters within f32 rounding (f32 activations): both
    average the same per-token gradients."""
    import dataclasses
    cfg = dataclasses.replace(LlamaConfig.tiny(n_layers=2),
                              dtype=torch.float32)
    g = torch.Generator().manual_seed(5)
    a = Llama(cfg, device="cpu").init(g)
    b = Llama(cfg, device="cpu")
    b.load_state_dict(a.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(6))
    full = a.make_train_step(torch.optim.SGD(a.parameters(), lr=0.5))
    want = full(tokens)
    params = dict(b.named_parameters())
    ddp = make_ddp_train_step(
        b.loss, torch.optim.SGD(b.parameters(), lr=0.5), params,
        cpu_mesh(2, axis_names=("dp",)),
        plan=plan_from_buckets(params, b.grad_buckets(1 << 14)),
        algorithm="ring")
    got = ddp(tokens)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
