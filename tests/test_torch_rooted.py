"""The port's rooted collectives and alltoall against the reference's.

The same numpy inputs go through ``accl_tpu`` (``MeshCollectives`` /
``Tree2DCollectives`` on the virtual CPU mesh, and ``tpu_world`` at the
driver tier) and through ``accl_tpu_torch`` on the CPU:

* bcast / scatter / gather / alltoall: bitwise at W = 2, 4 and 8, at
  several roots, with no wire and with every per-tensor wire (a pure
  cast per hop, fp8 included); the binomial schedules are the
  reference's, round for round.
* reduce: the 2D tree (W = 4 and 8 fold; W = 2 does not) bitwise for
  int32 and f32, and the 1-D path (ring bitwise; psum within rtol=1e-6,
  atol=1e-6, the reduction order over ranks differs).
* the driver tier, ``cuda_world(4, device="cpu")`` against
  ``tpu_world(4, platform="cpu")``, host-mirror and device-resident, for
  every new op and wire: bitwise, except the device-resident f32 reduce:
  there the reference runs its 1-D psum program while the port takes
  the 2D tree on both paths (within rtol=1e-6, atol=1e-6).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from accl_tpu.constants import ReduceFunc as JRF  # noqa: E402
from accl_tpu.device.tpu import _factor_2d, tpu_world  # noqa: E402
from accl_tpu.parallel import tree as jtree  # noqa: E402
from accl_tpu.parallel.collectives import MeshCollectives  # noqa: E402
from accl_tpu.parallel.mesh import cpu_mesh  # noqa: E402
from accl_tpu.testing import run_ranks as j_run_ranks  # noqa: E402
from accl_tpu_torch import cuda_world  # noqa: E402
from accl_tpu_torch.constants import ReduceFunc  # noqa: E402
from accl_tpu_torch.parallel import tree as ttree  # noqa: E402
from accl_tpu_torch.parallel.collectives import RankCollectives  # noqa: E402
from accl_tpu_torch.parallel.mesh import make_group  # noqa: E402
from accl_tpu_torch.testing import run_ranks  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


WIRES = [None, "float16", "bfloat16", "float8_e4m3fn", "float8_e5m2"]
_MESH: dict = {}


def _np_dtype(name):
    if name is None:
        return None
    return np.dtype(np.float16) if name == "float16" else \
        np.dtype(getattr(ml_dtypes, name))


def _colls(W: int):
    if W not in _MESH:
        _MESH[W] = (MeshCollectives(cpu_mesh(W)),
                    RankCollectives(make_group(W, "cpu")))
    return _MESH[W]


def _inputs(W: int, n: int, seed: int, dtype="float32") -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, (W, n)).astype(np.int32)
    return (rng.standard_normal((W, n))
            * np.float32(10.0) ** rng.integers(-3, 4, (W, n))).astype(
                np.float32)


def _same(got, ref, what: str):
    got, ref = np.ascontiguousarray(got), np.ascontiguousarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    iv = np.uint32 if got.itemsize == 4 else np.uint8
    bad = got.view(iv) != ref.view(iv)
    assert not bad.any(), f"{what}: {int(bad.sum())} of {bad.size} differ"


def _roots(W: int):
    return sorted({0, W - 1, (W // 2 + 1) % W})


# -- schedules ----------------------------------------------------------------

def test_schedules_are_the_references():
    for W in range(1, 34):
        assert ttree.gather_rounds(W) == jtree.gather_rounds(W)
        assert ttree.scatter_rounds(W) == jtree.scatter_rounds(W)
        assert ttree.factor_2d(W) == _factor_2d(W)


# -- bcast / scatter / gather / alltoall --------------------------------------

@pytest.mark.parametrize("wire", WIRES, ids=str)
@pytest.mark.parametrize("W", [2, 4, 8])
@pytest.mark.parametrize("op", ["bcast", "scatter", "gather"])
def test_rooted_op_bitwise(op, W, wire):
    mc, rc = _colls(W)
    c = 37
    x = _inputs(W, W * c if op == "scatter" else c, 100 + W)
    for root in _roots(W):
        ref = np.asarray(getattr(mc, op)(mc.shard(list(x)), root=root,
                                         wire_dtype=_np_dtype(wire)))
        got = getattr(rc, op)(torch.from_numpy(x), root, wire).numpy()
        _same(got, ref, f"{op} W={W} root={root} wire={wire}")
        if op == "bcast":
            _same(got[root], x[root], "the root's copy stays exact")
            if wire is not None:    # the wire really cast the payload
                assert (got[(root + 1) % W] != x[root]).any()


@pytest.mark.parametrize("wire", WIRES, ids=str)
@pytest.mark.parametrize("W", [2, 4, 8])
def test_alltoall_bitwise(W, wire):
    mc, rc = _colls(W)
    x = _inputs(W, W * 29, 7 + W)
    ref = np.asarray(mc.alltoall(mc.shard(list(x)),
                                 wire_dtype=_np_dtype(wire)))
    got = rc.alltoall(torch.from_numpy(x), wire).numpy()
    _same(got, ref, f"alltoall W={W} wire={wire}")
    for r in range(W):     # the own chunk never crossed the wire
        _same(got[r, r * 29:(r + 1) * 29], x[r, r * 29:(r + 1) * 29],
              "own chunk")


@pytest.mark.parametrize("W", [3, 5, 6])
def test_rooted_ops_in_worlds_that_are_not_powers_of_two(W):
    """Padded gather subtrees and clamped scatter blocks, against numpy."""
    rc = RankCollectives(make_group(W, "cpu"))
    x = _inputs(W, W * 5, W, "int32")
    for root in range(W):
        b = rc.bcast(torch.from_numpy(x), root).numpy()
        np.testing.assert_array_equal(b, np.broadcast_to(x[root], x.shape))
        s = rc.scatter(torch.from_numpy(x), root).numpy()
        np.testing.assert_array_equal(s, x[root].reshape(W, 5))
        g = rc.gather(torch.from_numpy(x[:, :5].copy()), root).numpy()
        np.testing.assert_array_equal(g[root], x[:, :5].reshape(-1))
        assert not np.delete(g, root, axis=0).any()


# -- reduce -------------------------------------------------------------------

def _ref_tree(W: int):
    o, i = _factor_2d(W)
    return jtree.Tree2DCollectives(Mesh(
        np.asarray(jax.devices("cpu")[:W]).reshape(o, i),
        ("outer", "inner")))


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("func", list(ReduceFunc), ids=lambda f: f.name)
@pytest.mark.parametrize("W", [4, 8])
def test_tree_reduce_bitwise(W, func, dtype):
    jt = _ref_tree(W)
    rc = RankCollectives(make_group(W, "cpu"))
    tt = ttree.Tree2DCollectives.fold(rc)
    assert (tt.O, tt.I) == (jt.O, jt.I)
    x = _inputs(W, 300, 5 + int(func), dtype)
    if dtype == "float32" and func == ReduceFunc.PROD:
        x = (1.0 + 0.01 * x / np.abs(x).max()).astype(np.float32)
    if dtype == "int32" and func == ReduceFunc.PROD:
        x = (x % 3 + 1).astype(np.int32)
    root = W - 3
    ref = np.asarray(jt.reduce(jt.shard(list(x)), root=root,
                               func=JRF(int(func))))
    got = tt.reduce(torch.from_numpy(x), root, func).numpy()
    _same(got, ref, f"tree reduce W={W} {func.name} {dtype}")


def test_worlds_without_2d_structure_have_no_tree():
    for W in (1, 2, 3, 5, 7):
        assert ttree.Tree2DCollectives.fold(
            RankCollectives(make_group(W, "cpu"))) is None


@pytest.mark.parametrize("wire", WIRES, ids=str)
@pytest.mark.parametrize("alg", ["ring", "xla"])
def test_1d_reduce(alg, wire):
    """The 1-D rooted reduce: an allreduce only the root keeps (ring:
    bitwise except the fp8 wire's fused SUM; xla: within tolerance)."""
    W = 4
    mc, rc = _colls(W)
    x = _inputs(W, 203, 21)
    root = 2
    ref = np.asarray(mc._program("reduce", alg, JRF.SUM, wire, root)(
        mc.shard(list(x))))
    got = rc.reduce(torch.from_numpy(x), root, ReduceFunc.SUM, wire,
                    alg).numpy()
    assert not np.delete(got, root, axis=0).any()
    if alg == "ring" and wire not in ("float8_e4m3fn", "float8_e5m2"):
        _same(got, ref, f"ring reduce {wire}")
    else:
        atol = 1e-6 if wire is None else 0.25 * np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=atol)


# -- driver tier --------------------------------------------------------------

W_DRV = 4


@pytest.fixture(scope="module")
def worlds():
    tw = tpu_world(W_DRV, platform="cpu")
    cw = cuda_world(W_DRV, device="cpu")
    yield tw, cw
    for a in tw + cw:
        a.deinit()


def _body(op: str, ins, count: int, root: int, resident: bool, wire,
          jax_side: bool):
    W = W_DRV

    def fn(a):
        def buf(data=None, n=None):
            if jax_side:
                if data is not None:
                    return (a.buffer(data=jnp.asarray(data)) if resident
                            else a.buffer(data=data.copy()))
                return a.buffer((n,), np.float32, device_resident=resident)
            if data is not None:
                return a.buffer(data=torch.from_numpy(data.copy()),
                                device_resident=resident)
            return a.buffer((n,), torch.float32, device_resident=resident)

        kw = {}
        if wire is not None:
            kw["compress_dtype"] = _np_dtype(wire) if jax_side else wire
        x = ins[a.rank]
        me_root = a.rank == root
        if op == "bcast":
            b = buf(x[:count]) if me_root else buf(
                np.full(count, 7.0, np.float32))
            a.bcast(b, count, root=root, **kw)
            return np.asarray(b.data, np.float32).copy()
        if op == "scatter":
            d = buf(n=count)
            a.scatter(buf(x) if me_root else None, d, count, root=root, **kw)
            return np.asarray(d.data, np.float32).copy()
        if op == "alltoall":
            d = buf(n=W * count)
            a.alltoall(buf(x), d, count, **kw)
            return np.asarray(d.data, np.float32).copy()
        n_out = W * count if op == "gather" else count
        d = buf(n=n_out) if me_root else None
        getattr(a, op)(buf(x[:count]), d, count, root=root, **kw)
        return None if d is None else np.asarray(d.data, np.float32).copy()
    return fn


@pytest.mark.parametrize("wire", WIRES, ids=str)
@pytest.mark.parametrize("resident", [False, True],
                         ids=["host", "resident"])
@pytest.mark.parametrize("op", ["bcast", "scatter", "gather", "reduce",
                                "alltoall"])
def test_driver_matches_tpu_world(worlds, op, resident, wire):
    tw, cw = worlds
    count, root = 40, 1 + (len(op) % 3)
    rng = np.random.default_rng(len(op))
    ins = [rng.standard_normal(W_DRV * count).astype(np.float32)
           for _ in range(W_DRV)]
    ref = j_run_ranks(tw, _body(op, ins, count, root, resident, wire, True))
    got = run_ranks(cw, _body(op, ins, count, root, resident, wire, False))
    for r in range(W_DRV):
        assert (got[r] is None) == (ref[r] is None)
        if ref[r] is None:
            continue
        if op == "reduce" and resident and wire is None:
            np.testing.assert_allclose(got[r], ref[r], rtol=1e-6, atol=1e-6)
        else:
            _same(got[r], ref[r], f"{op} rank {r}")
    if op == "bcast":   # the root's buffer was not rewritten
        _same(got[root], ins[root][:count], "bcast root")


def test_driver_routes_rooted_ops(worlds, monkeypatch):
    """AUTO and TREE reduce take the 2D tree; a compressed reduce and an
    explicit RING keep the 1-D path."""
    _, cw = worlds
    ctx = cw[0].device.ctx
    assert (ctx.tree.O, ctx.tree.I) == (2, 2)
    used = []
    orig = ttree.Tree2DCollectives.reduce
    monkeypatch.setattr(ttree.Tree2DCollectives, "reduce",
                        lambda self, *a, **k: used.append(1) or orig(
                            self, *a, **k))
    ins = [np.arange(8, dtype=np.float32) * (r + 1) for r in range(W_DRV)]

    def fn(algorithm, wire):
        def go(a):
            d = a.buffer((8,), torch.float32) if a.rank == 0 else None
            a.reduce(a.buffer(data=torch.from_numpy(ins[a.rank].copy())), d,
                     8, root=0, algorithm=algorithm, compress_dtype=wire)
            return None if d is None else d.data.copy()
        return go

    for alg, wire, tree in [("auto", None, True), ("tree", None, True),
                            ("auto", "float16", False), ("ring", None, False)]:
        used.clear()
        out = run_ranks(cw, fn(alg, wire))[0]
        np.testing.assert_array_equal(out, sum(ins))
        assert bool(used) == tree, (alg, wire)


def test_w2_world_runs_rooted_ops_without_a_tree():
    cw = cuda_world(2, device="cpu")
    try:
        assert cw[0].device.ctx.tree is None

        def fn(a):
            b = a.buffer(data=torch.full((6,), float(a.rank + 1)))
            d = a.buffer((6,), torch.float32)
            a.reduce(b, d, 6, root=1)
            a.bcast(d, 6, root=1, compress_dtype="bfloat16")
            return d.data.copy()
        for out in run_ranks(cw, fn):
            np.testing.assert_array_equal(out, np.full(6, 3.0, np.float32))
    finally:
        for a in cw:
            a.deinit()
