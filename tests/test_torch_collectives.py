"""The port's rank collectives against the reference's mesh collectives.

``RankCollectives`` (W ranks on one torch device, here the CPU) against
``MeshCollectives(cpu_mesh(4))`` on the same numpy inputs:

* ring family, full precision: bitwise for SUM/MAX/MIN/PROD x f32/i32;
* ring family, block-scaled wire with ``qblock``: bitwise;
* "xla" family: f32 within rtol=1e-6, atol=1e-6 (the reduction order
  over ranks differs from psum's), i32 exactly.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

from accl_tpu.constants import ReduceFunc as JRF  # noqa: E402
from accl_tpu.parallel.collectives import MeshCollectives  # noqa: E402
from accl_tpu.parallel.mesh import cpu_mesh  # noqa: E402
from accl_tpu_torch.constants import ReduceFunc  # noqa: E402
from accl_tpu_torch.parallel.collectives import (  # noqa: E402
    PLAIN, RankCollectives)
from accl_tpu_torch.parallel.mesh import make_group  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


W = 4
FUNCS = list(ReduceFunc)


@pytest.fixture(scope="module")
def mesh_coll():
    return MeshCollectives(cpu_mesh(W))


@pytest.fixture(scope="module")
def rank_coll():
    return RankCollectives(make_group(W, "cpu"))


def _inputs(n: int, dtype: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, (W, n)).astype(np.int32)
    return rng.standard_normal((W, n)).astype(np.float32)


def _np_wire(name):
    return np.dtype(np.int8) if name == "int8" else \
        np.dtype(getattr(ml_dtypes, name))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.itemsize == 4 else np.uint8)


def _run_both(mesh_coll, rank_coll, op, x, **kw):
    jfunc = {} if "func" not in kw else {"func": JRF(int(kw["func"]))}
    jkw = {k: v for k, v in kw.items() if k != "func"}
    ref = np.asarray(getattr(mesh_coll, op)(mesh_coll.shard(list(x)),
                                            **jfunc, **jkw))
    got = getattr(rank_coll, op)(torch.from_numpy(x), **kw).numpy()
    return got, ref


# -- ring family, full precision ---------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("func", FUNCS, ids=lambda f: f.name)
@pytest.mark.parametrize("op", ["allreduce", "reduce_scatter"])
def test_ring_reduction_bitwise(mesh_coll, rank_coll, op, func, dtype):
    # allreduce: ragged n pads to a multiple of W; reduce_scatter: W chunks
    n = 1001 if op == "allreduce" else W * 250
    x = _inputs(n, dtype, 31 + int(func))
    if func == ReduceFunc.PROD and dtype == "float32":
        x = (1.0 + 0.01 * x).astype(np.float32)
    got, ref = _run_both(mesh_coll, rank_coll, op, x, func=func,
                         algorithm="ring")
    assert got.shape == ref.shape
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_ring_allgather_bitwise(mesh_coll, rank_coll, dtype):
    x = _inputs(333, dtype, 5)
    got, ref = _run_both(mesh_coll, rank_coll, "allgather", x,
                         algorithm="ring")
    np.testing.assert_array_equal(_bits(got), _bits(ref))


# -- ring family, block-scaled wire ------------------------------------------

BS_LANES = [("float8_e4m3fn", ReduceFunc.SUM), ("int8", ReduceFunc.MAX),
            ("float8_e5m2", ReduceFunc.SUM)]


@pytest.mark.parametrize("wire,func", BS_LANES, ids=lambda v: getattr(
    v, "name", v))
@pytest.mark.parametrize("op", ["allreduce", "reduce_scatter", "allgather"])
def test_ring_block_scaled_bitwise(mesh_coll, rank_coll, op, wire, func):
    qblock = 64
    # chunks of 300 elements: a ragged last scale block in every chunk
    n = {"allreduce": W * 300 - 3, "reduce_scatter": W * 300,
         "allgather": 300}[op]
    rng = np.random.default_rng(17)
    x = (rng.standard_normal((W, n))
         * np.float32(10.0) ** rng.integers(-3, 3, (W, n))).astype(
             np.float32)
    kw = {"algorithm": "ring", "qblock": qblock}
    if op != "allgather":
        kw["func"] = func
    ref = np.asarray(getattr(mesh_coll, op)(
        mesh_coll.shard(list(x)), wire_dtype=_np_wire(wire),
        **({"func": JRF(int(func))} if op != "allgather" else {}),
        algorithm="ring", qblock=qblock))
    got = getattr(rank_coll, op)(torch.from_numpy(x), wire_dtype=wire,
                                 **kw).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    if op == "allgather":
        for r in range(W):   # the own chunk lands exact
            np.testing.assert_array_equal(got[r, r * n:(r + 1) * n], x[r])


# -- "xla" family ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("func", FUNCS, ids=lambda f: f.name)
@pytest.mark.parametrize("op", ["allreduce", "reduce_scatter"])
def test_xla_family_reductions(mesh_coll, rank_coll, op, func, dtype):
    x = _inputs(W * 64, dtype, 3 + int(func))
    if func == ReduceFunc.PROD and dtype == "float32":
        x = (1.0 + 0.01 * x).astype(np.float32)
    got, ref = _run_both(mesh_coll, rank_coll, op, x, func=func,
                         algorithm="xla")
    if op == "reduce_scatter" and func in (ReduceFunc.MAX, ReduceFunc.MIN):
        # the reference lowers every xla reduce_scatter to psum_scatter,
        # which sums whatever the func: hold the port to a numpy oracle
        red = {ReduceFunc.MAX: np.max, ReduceFunc.MIN: np.min}[func]
        ref = red(x.reshape(W, W, -1), axis=0)
    if dtype == "int32":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_xla_family_allgather(mesh_coll, rank_coll, dtype):
    x = _inputs(100, dtype, 9)
    got, ref = _run_both(mesh_coll, rank_coll, "allgather", x,
                         algorithm="xla")
    np.testing.assert_array_equal(got, ref)


# -- port-side properties ----------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3, 5])
def test_ring_worlds_against_numpy_oracle(world):
    """Odd and tiny worlds (W=1: no hop; W=2: no ping-pong buffer)."""
    coll = RankCollectives(make_group(world, "cpu"))
    rng = np.random.default_rng(world)
    x = rng.integers(-50, 50, (world, 7 * world + 2)).astype(np.int32)
    got = coll.allreduce(torch.from_numpy(x), algorithm="ring").numpy()
    np.testing.assert_array_equal(got, np.broadcast_to(x.sum(0), x.shape))
    y = x[:, :7 * world]
    got = coll.reduce_scatter(torch.from_numpy(y.copy()),
                              algorithm="ring").numpy()
    np.testing.assert_array_equal(got, y.sum(0).reshape(world, 7))


def test_in_place_rows_and_plain_kernel_set(rank_coll):
    """Output rows aliasing the input land through temporaries, and the
    PLAIN kernel set gives the kernels' results bit for bit."""
    x = _inputs(W * 40, "float32", 2)
    rows = [torch.from_numpy(x[r].copy()) for r in range(W)]
    ref = rank_coll.allreduce(torch.from_numpy(x), algorithm="ring")
    rank_coll.allreduce(rows, algorithm="ring", out=rows)
    for r in range(W):
        assert torch.equal(rows[r], ref[r])
    plain = RankCollectives(rank_coll.group, kernels=PLAIN)
    q = plain.allreduce(torch.from_numpy(x), algorithm="ring",
                        wire_dtype="float8_e4m3fn", qblock=32)
    k = rank_coll.allreduce(torch.from_numpy(x), algorithm="ring",
                            wire_dtype="float8_e4m3fn", qblock=32)
    assert torch.equal(q.view(torch.int32), k.view(torch.int32))


def test_eligibility_and_unported_wire(rank_coll):
    """Block-scaled eligibility; an int8 wire without qblock (plain
    integer narrowing, which the reference's driver refuses too) and the
    point-to-point exchange (not ported yet) raise NotImplementedError."""
    ok = RankCollectives._bs_eligible
    assert ok("allreduce", "float8_e4m3fn", 128)
    assert ok("allgather", "int8", 32)
    assert not ok("allreduce", "int8", 0)
    assert not ok("allreduce", "float16", 64)
    assert not ok("bcast", "int8", 64)
    assert not ok("alltoall", "float8_e4m3fn", 64)
    x = torch.zeros(W, 16)
    with pytest.raises(NotImplementedError):
        rank_coll.allreduce(x, algorithm="ring", wire_dtype="int8")
    with pytest.raises(NotImplementedError):
        rank_coll._run("exchange", x, ReduceFunc.SUM, "xla", None, 0, None)
    with pytest.raises(ValueError):
        rank_coll.allreduce(torch.zeros(3, 16))
