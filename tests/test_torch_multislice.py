"""The port's multi-slice tier (``accl_tpu_torch/parallel/multislice.py``)
and multi-axis allreduce against the reference's, on the CPU.

The reference's ``tests/test_multislice.py`` case for case: its 8
virtual CPU devices as 2 slices x 4 chips, the port's 8 virtual ranks on
a ``hybrid_mesh((4,), 2, device="cpu")``, the same seeded rank-major
rows through both. Tolerances: SUM within rtol 1e-5 (the reference's
psum orders its sums otherwise); MAX and MIN bitwise; PROD within rtol
1e-4; the bf16 dcn wire within the reference's own bounds (rtol 0.02,
atol 0.1). The two-process lane runs two processes over gloo, each
holding one slice, held bitwise to the one-process result. The
multi-axis allreduce is ``tests/test_collectives.py``'s test of the
reference's ``multi_axis_ring_allreduce_shard`` on a (2, 2, 2) mesh.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from accl_tpu import parallel as RP  # noqa: E402
from accl_tpu.constants import ReduceFunc as RefReduceFunc  # noqa: E402
from accl_tpu.parallel.collectives import (  # noqa: E402
    multi_axis_ring_allreduce_shard)
from accl_tpu.utils.compat import shard_map  # noqa: E402
from accl_tpu_torch.constants import ReduceFunc  # noqa: E402
from accl_tpu_torch.parallel import (cpu_mesh, distributed_init,  # noqa: E402
                                     hierarchical_allreduce,
                                     hierarchical_allreduce_sharded,
                                     hybrid_mesh,
                                     multi_axis_ring_allreduce, slice_count)
from accl_tpu_torch.parallel.collectives import KERNELS  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_LIMIT_S = 120
CHILD_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test fails once it runs past TEST_LIMIT_S seconds."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past its {TEST_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def ref_mesh():
    return RP.hybrid_mesh(ici_shape=(4,), n_slices=2)


@pytest.fixture(scope="module")
def mesh():
    return hybrid_mesh((4,), 2, device="cpu")


def _rank_major(n, seed=0):
    return np.random.default_rng(seed).standard_normal((8, n)).astype(
        np.float32)


def _port(x, mesh, **kw):
    return hierarchical_allreduce_sharded(torch.from_numpy(x), mesh,
                                          **kw).numpy()


def _ref(x, ref_mesh, **kw):
    return np.asarray(RP.hierarchical_allreduce_sharded(jnp.asarray(x),
                                                        ref_mesh, **kw))


# -- the reference's tests -----------------------------------------------------

def test_hybrid_mesh_shape(mesh, ref_mesh):
    assert mesh.axis_names == tuple(ref_mesh.axis_names) == ("dcn", "ici")
    assert tuple(mesh.shape.values()) == ref_mesh.devices.shape == (2, 4)
    assert mesh.size == 8 and mesh.local_slice is None
    assert slice_count() == 1                      # no process group
    assert mesh.groups("ici") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.groups("dcn") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    # the defaults: one slice of every rank, as the reference's
    dflt, rdflt = hybrid_mesh(device="cpu"), RP.hybrid_mesh()
    assert tuple(dflt.shape.values()) == rdflt.devices.shape == (1, 8)
    two = hybrid_mesh((2, 2), 2, ("x", "y"), device="cpu")
    assert two.axis_names == ("dcn", "x", "y") and two.size == 8


@pytest.mark.parametrize("kw", [dict(ici_shape=(2, 2)),
                                dict(ici_shape=(4,), n_slices=3)])
def test_hybrid_mesh_errors_equal_the_reference(kw):
    with pytest.raises(ValueError) as want:
        RP.hybrid_mesh(**kw)
    with pytest.raises(ValueError) as got:
        hybrid_mesh(**kw, device="cpu")
    assert str(got.value) == str(want.value)


def _sum_bound(x):
    """Per element, what one f32 sum of the 8 rows in any order may err
    from the exact sum: 7 roundings of at most sum_r |x_r|."""
    return 7 * 2.0 ** -24 * np.abs(x.astype(np.float64)).sum(0)


def test_hierarchical_allreduce_matches_flat_sum(mesh, ref_mesh):
    """Against the reference within rtol 1e-5; an element whose sum
    cancels (|sum| << sum |x|) differs in relative terms by more, so
    each side's f32 summation bound stands beside rtol as atol; against
    the float64 sum within that bound."""
    x = _rank_major(513)                          # odd: the pad path
    got = _port(x, mesh)
    want = _ref(x, ref_mesh)
    bound = _sum_bound(x)
    exact = x.astype(np.float64).sum(0)
    for r in range(8):
        assert (np.abs(got[r] - exact) <= bound).all(), r
        assert (np.abs(got[r] - want[r])
                <= 1e-5 * np.abs(want[r]) + 2 * bound).all(), r
    assert (got == got[0]).all()                  # every rank alike


@pytest.mark.parametrize("func", ["MAX", "MIN", "PROD"])
def test_hierarchical_allreduce_nonsum(mesh, ref_mesh, func):
    x = _rank_major(64, seed=3)
    if func == "PROD":
        x = np.abs(x) + 0.5
    got = _port(x, mesh, func=ReduceFunc[func])
    want = _ref(x, ref_mesh, func=RefReduceFunc[func])
    op = {"MAX": np.max, "MIN": np.min, "PROD": np.prod}[func]
    np.testing.assert_allclose(got[0], op(x, axis=0), rtol=1e-4)
    if func == "PROD":
        np.testing.assert_allclose(got, want, rtol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


def test_hierarchical_allreduce_dcn_compression(mesh, ref_mesh):
    """bf16 on the dcn hop only: the slice sums are exact f32 rings, the
    cross-slice fold is compressed."""
    x = _rank_major(256, seed=7)
    got = _port(x, mesh, wire_dtype=torch.bfloat16)
    want = _ref(x, ref_mesh, wire_dtype=jnp.bfloat16)
    golden = np.sum(x, axis=0)
    np.testing.assert_allclose(got[3], golden, rtol=0.02, atol=0.1)
    np.testing.assert_allclose(got, want, rtol=0.02, atol=0.1)
    # one rounding to bf16 of each slice's shard, one of their sum
    exact = _port(x, mesh)
    assert not np.array_equal(got, exact)


@pytest.mark.parametrize("func", ["SUM", "MAX", "MIN"])
@pytest.mark.parametrize("pay,wire", [("float16", "bfloat16"),
                                      ("bfloat16", "float16")])
def test_hierarchical_allreduce_payload_dcn_wire(mesh, ref_mesh, pay, wire,
                                                 func):
    """An f16 or bf16 payload on the other 16-bit dcn wire: the owned
    shard widens to f32 and goes down to the wire once (B2 twice), the
    slices' shards combine in the wire dtype, and the sum comes back
    through f32 to the payload, as the reference's ``astype`` chain.
    MAX and MIN are bitwise the reference's. SUM's in-slice ring adds in
    another order than ``psum_scatter`` (as for f32), so it is held to
    the reference within 2^-(p-1) * 3 * 8 * max|x| (p the wire's
    significant bits: one wire rounding of each slice's shard and one of
    their sum, at the scale of a sum of 8 rows), and it must differ from
    the port's own result without a wire (the shards really crossed it)
    by no more than that."""
    tp, jp = getattr(torch, pay), getattr(jnp, pay)
    x = _rank_major(515, seed=11)
    x[2] *= 300.0
    xt = torch.from_numpy(x).to(tp)
    got = hierarchical_allreduce_sharded(xt, mesh, wire_dtype=wire,
                                         func=ReduceFunc[func])
    want = np.asarray(RP.hierarchical_allreduce_sharded(
        jnp.asarray(x).astype(jp), ref_mesh, wire_dtype=getattr(jnp, wire),
        func=RefReduceFunc[func]))
    assert got.dtype == tp and got.shape == x.shape
    if func != "SUM":
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16)), func
        return
    p = 8 if wire == "bfloat16" else 11
    g = got.float().numpy()
    tol = 2.0 ** -(p - 1) * 3 * 8 * np.abs(x).max()
    np.testing.assert_allclose(g, want.astype(np.float32), rtol=0, atol=tol)
    plain = hierarchical_allreduce_sharded(xt, mesh).float().numpy()
    assert (g != plain).any()
    np.testing.assert_allclose(g, plain, rtol=0, atol=tol)


FP8_WIRES = ("float8_e4m3fn", "float8_e5m2")


@pytest.mark.parametrize("func", ["SUM", "MAX", "MIN", "PROD"])
@pytest.mark.parametrize("wire", FP8_WIRES)
@pytest.mark.parametrize("slices", [2, 4, 8])
def test_hierarchical_allreduce_fp8_dcn_wire(slices, wire, func):
    """An fp8 dcn wire at 2, 4 and 8 slices (8 ranks: 2x4, 4x2, 8x1),
    bitwise the reference: SUM folds the slices' shards in f16 and rounds
    once to the wire, PROD folds on the wire, rounding after each product
    (e4m3fn's overflow to NaN included: at scale 3, PROD's NaNs are
    checked to occur), MAX and MIN are exact. The payload is f32 with
    values of scale 3; NaN matches NaN code for code in f32 only as a
    NaN, so NaNs are compared by position."""
    ici = 8 // slices
    ref_mesh = RP.hybrid_mesh(ici_shape=(ici,), n_slices=slices)
    mesh = hybrid_mesh((ici,), slices, device="cpu")
    x = _rank_major(4096, seed=slices) * 3
    if func == "PROD":
        x = np.abs(x) + 0.25 if wire == "float8_e5m2" else x
    got = hierarchical_allreduce_sharded(torch.from_numpy(x), mesh,
                                         wire_dtype=wire,
                                         func=ReduceFunc[func]).numpy()
    want = np.asarray(RP.hierarchical_allreduce_sharded(
        jnp.asarray(x), ref_mesh, wire_dtype=getattr(jnp, wire),
        func=RefReduceFunc[func]))
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32),
                          want[~nan].view(np.uint32))
    if func == "PROD" and wire == "float8_e4m3fn" and slices >= 4:
        assert nan.any()            # products past 448 are NaN in e4m3fn
    assert (got == got[0])[~nan].all()      # every rank alike
    plain = hierarchical_allreduce_sharded(torch.from_numpy(x), mesh,
                                           func=ReduceFunc[func]).numpy()
    if func == "SUM":               # the shards really crossed the wire
        assert not np.array_equal(got, plain)


def test_distributed_init_single_process_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert RP.distributed_init() is False
    assert distributed_init() is False
    assert slice_count() == 1


def test_dp_grad_sync_over_hybrid_mesh(mesh, ref_mesh):
    """Gradient sync hierarchical over (ici, dcn): a dp step whose
    averaged gradient matches the single-device gradient."""
    W, n = 8, 128
    w = np.linspace(-1, 1, n).astype(np.float32)
    batches = np.random.default_rng(5).standard_normal((W, n)).astype(
        np.float32)

    def body(wv, bv):
        g = jnp.dot(wv, bv[0]) * bv[0]
        return (RP.multislice.hierarchical_allreduce(g, "ici", "dcn")
                / W)[None]

    want = np.asarray(jax.jit(shard_map(
        body, mesh=ref_mesh, in_specs=(P(None), P(("dcn", "ici"))),
        out_specs=P(("dcn", "ici"))))(jnp.asarray(w), jnp.asarray(batches)))
    tw, tb = torch.from_numpy(w), torch.from_numpy(batches)
    grads = torch.stack([torch.dot(tw, b) * b for b in tb])
    got = (hierarchical_allreduce(grads, mesh) / W).numpy()
    golden = np.mean([np.dot(w, b) * b for b in batches], axis=0)
    np.testing.assert_allclose(got[0], golden, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# -- the port's own ---------------------------------------------------------------

def _counting():
    counts = {"combine": 0, "cast": 0}

    def count(name):
        fn = getattr(KERNELS, name)

        def run(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return run

    return counts, KERNELS._replace(combine=count("combine"),
                                    cast=count("cast"))


@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_rows_path_launches(mesh, wire):
    """Phase 1 is 3 ring hops in each of the 2 ici groups, phase 2 one
    combine over the 4 owned shards; a wire adds a cast each way.
    ``kernels`` reaches every launch: the plain versions give the same
    bits."""
    x = torch.from_numpy(_rank_major(1024, seed=11))
    counts, k = _counting()
    got = hierarchical_allreduce(x, mesh, wire_dtype=wire, kernels=k)
    assert counts == {"combine": 2 * 3 + 1,
                      "cast": 0 if wire is None else 2}
    from accl_tpu_torch.parallel.collectives import PLAIN
    plain = hierarchical_allreduce(list(x), mesh, wire_dtype=wire,
                                   kernels=PLAIN)
    assert torch.equal(got, plain)


def test_argument_errors(mesh, ref_mesh):
    x = _rank_major(8)[:4]
    with pytest.raises(ValueError) as want:
        RP.hierarchical_allreduce_sharded(jnp.asarray(x), ref_mesh)
    with pytest.raises(ValueError) as got:
        hierarchical_allreduce_sharded(torch.from_numpy(x), mesh)
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="int8 dcn wire.*"
                                                  "plain int8 cast truncates"):
        hierarchical_allreduce_sharded(torch.zeros(8, 8), mesh,
                                       wire_dtype="int8")
    if not torch.cuda.is_available():             # the default device
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            hybrid_mesh((4,), 2)


# -- two processes over gloo ------------------------------------------------------

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import torch.distributed as dist
from accl_tpu_torch.parallel import (distributed_init, hybrid_mesh,
                                     hierarchical_allreduce_sharded,
                                     slice_count)
root, rank, port, n, out = sys.argv[1:6]
rank, n = int(rank), int(n)
assert distributed_init(f"127.0.0.1:{port}", 2, rank)
assert distributed_init() and slice_count() == 2
mesh = hybrid_mesh((4,), 2, device="cpu")
assert mesh.local_slice == rank and mesh.local_size == 4
x = np.random.default_rng(0).standard_normal((8, n)).astype(np.float32)
mine = torch.from_numpy(x[4 * rank:4 * rank + 4])
res = {}
for name, kw in (("sum", {}), ("bf16", {"wire_dtype": torch.bfloat16}),
                 ("max", {"func": 1}),
                 ("e4m3", {"wire_dtype": "float8_e4m3fn"})):
    res[name] = hierarchical_allreduce_sharded(mine, mesh, **kw).numpy()
np.savez(out, **res)
dist.barrier()
dist.destroy_process_group()
print(json.dumps({"rank": rank, "ok": True}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_over_gloo_equal_one_process(mesh, tmp_path):
    """Two processes, one slice each, the dcn hop an all_gather over
    gloo: each process's rows bitwise the one-process result (SUM, the
    bf16 and e4m3fn wires, MAX), on an odd length."""
    n = 1001
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, ROOT, str(r), str(port), str(n),
         str(tmp_path / f"r{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
        assert json.loads(so.strip().splitlines()[-1])["ok"]
    x = torch.from_numpy(_rank_major(n))
    want = {"sum": hierarchical_allreduce_sharded(x, mesh),
            "bf16": hierarchical_allreduce_sharded(
                x, mesh, wire_dtype=torch.bfloat16),
            "max": hierarchical_allreduce_sharded(x, mesh,
                                                  func=ReduceFunc.MAX),
            "e4m3": hierarchical_allreduce_sharded(
                x, mesh, wire_dtype="float8_e4m3fn")}
    for r in range(2):
        got = np.load(tmp_path / f"r{r}.npz")
        for name, w in want.items():
            assert np.array_equal(got[name], w[4 * r:4 * r + 4].numpy()), (
                r, name)


# -- the multi-axis ring -------------------------------------------------------------

@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_multi_axis_ring_allreduce_drives_every_axis(wire):
    """On a (2, 2, 2) mesh: the sum within rtol 1e-5, bitwise the
    reference's ``multi_axis_ring_allreduce_shard`` on the same rows (f32
    and the bf16 wire), and ring hops recorded in all three axis
    directions (flattened strides 1, 2, 4)."""
    n = 8 * 3 * 4
    ins = np.random.default_rng(0).standard_normal((8, n)).astype(np.float32)
    ref_mesh = Mesh(np.array(jax.devices("cpu")[:8]).reshape(2, 2, 2),
                    ("a", "b", "c"))
    rw = None if wire is None else jnp.bfloat16

    def f(x):
        return multi_axis_ring_allreduce_shard(x[0], ("a", "b", "c"),
                                               wire_dtype=rw)[None]

    want = np.asarray(jax.jit(shard_map(
        f, mesh=ref_mesh, in_specs=P(("a", "b", "c"), None),
        out_specs=P(("a", "b", "c"), None)))(jnp.asarray(ins)))
    colls = {}
    got = multi_axis_ring_allreduce(
        torch.from_numpy(ins), cpu_mesh(8, (2, 2, 2), ("a", "b", "c")),
        wire_dtype=wire, colls=colls).numpy()
    if wire is None:
        for r in range(8):
            np.testing.assert_allclose(got[r], ins.sum(0), rtol=1e-5)
    # the same ring schedules, hop for hop: bitwise, with the wire too
    np.testing.assert_array_equal(got, want)
    strides = {min(abs(a - b), 8 - abs(a - b))
               for per in colls.values() for c in per
               for a, b in c.permutation_pairs}
    assert {1, 2, 4} <= strides, strides
    # every axis's groups: 2 ranks, 3 parts x (1 reduce-scatter + 1
    # allgather hop) a group
    for ax, per in colls.items():
        assert len(per) == 4
        for c in per:
            assert len(c.permutation_pairs) == 3 * 2 * 2, ax


def test_multi_axis_launches_and_errors():
    counts, k = _counting()
    mesh3 = cpu_mesh(8, (2, 2, 2), ("a", "b", "c"))
    x = torch.from_numpy(_rank_major(96, seed=2))
    got = multi_axis_ring_allreduce(x, mesh3, kernels=k)
    # 3 parts x 3 axes x 4 groups, one hop each
    assert counts["combine"] == 36
    assert (np.abs(got.numpy()[5] - x.numpy().astype(np.float64).sum(0))
            <= _sum_bound(x.numpy())).all()
    with pytest.raises(ValueError, match="does not split into 3 parts"):
        multi_axis_ring_allreduce(torch.zeros(8, 10), mesh3)


@pytest.mark.parametrize("op", ["reduce_scatter", "allgather", "allreduce"])
@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_ring_hops_are_recorded_as_they_move(op, wire):
    """A group of 4 ranks named 10..13 records, for each ring hop, the
    pair of every row it moved: rank r's row from rank r + 1, W - 1 hops
    a phase. A group that names no ranks records nothing."""
    from accl_tpu_torch.parallel import RankCollectives, RankGroup
    x = torch.from_numpy(_rank_major(16, seed=3)[:4])
    coll = RankCollectives(RankGroup(4, torch.device("cpu")),
                           ranks=[10, 11, 12, 13])
    getattr(coll, op)(x, algorithm="ring", wire_dtype=wire)
    ring = [(10 + (r + 1) % 4, 10 + r) for r in range(4)]
    phases = 2 if op == "allreduce" else 1
    assert coll.permutation_pairs == ring * (3 * phases)
    quiet = RankCollectives(RankGroup(4, torch.device("cpu")))
    getattr(quiet, op)(x, algorithm="ring", wire_dtype=wire)
    assert quiet.permutation_pairs is None
