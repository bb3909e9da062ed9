"""The port's driver configuration surface against the reference's.

``preflight``, the segment size set at bring-up and by
``set_max_segment_size``, the arith registry (a custom entry, a removed
pair, ``invalidate_arith_cache``), ``plan_cache_stats`` and the tuner's
wiring into the constructor, each compared with ``tpu_world(4,
platform="cpu")``'s.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

from accl_tpu.arith import DEFAULT_ARITH_CONFIGS as J_ARITH  # noqa: E402
from accl_tpu.arith import _mk as j_mk  # noqa: E402
from accl_tpu.device.tpu import tpu_world  # noqa: E402
from accl_tpu.testing import run_ranks as j_run_ranks  # noqa: E402
from accl_tpu.tuner import Tuner as JTuner  # noqa: E402
from accl_tpu_torch import CCLOp, cuda_world  # noqa: E402
from accl_tpu_torch.arith import DEFAULT_ARITH_CONFIGS as T_ARITH  # noqa: E402
from accl_tpu_torch.arith import _mk as t_mk  # noqa: E402
from accl_tpu_torch.arith import dtype_name  # noqa: E402
from accl_tpu_torch.constants import DEFAULT_MAX_SEGMENT_SIZE  # noqa: E402
from accl_tpu_torch.testing import run_ranks  # noqa: E402
from accl_tpu_torch.tuner import Topology, Tuner  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep: the port creates no shm."""
    yield


W = 4


@pytest.fixture(scope="module")
def worlds():
    tw = tpu_world(W, platform="cpu")
    cw = cuda_world(W, device="cpu")
    yield tw, cw
    for a in tw + cw:
        a.deinit()


@pytest.mark.parametrize("op", ["allreduce", "allgather", "bcast",
                                "reduce_scatter", "alltoall", "send"])
@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hier"])
def test_preflight_matches(worlds, op, hier):
    tw, cw = worlds
    for a in tw + cw:
        if hier:
            a.configure_hierarchy([0, 0, 1, 1])
        else:
            a._hier = None
    for count in (1, 1 << 20, 1 << 28):
        want = tw[0].preflight(count, np.float32, op=op)
        got = cw[0].preflight(count, torch.float32, op=op)
        assert got == want == []


def test_segment_size_reaches_the_device(worlds):
    tw, cw = worlds
    assert DEFAULT_MAX_SEGMENT_SIZE == 1 << 20
    assert cw[0].device.max_segment_size == tw[0].device.max_segment_size
    for nbytes in (4096, 3 << 20, 1 << 20):
        tw[0].set_max_segment_size(nbytes)
        cw[0].set_max_segment_size(nbytes)
        assert cw[0].device.max_segment_size == \
            tw[0].device.max_segment_size == nbytes
    assert cw[0].device.preferred_segment_size() == \
        tw[0].device.preferred_segment_size()


def test_tuner_recommends_the_bring_up_segment_size():
    topo = dict(world_size=2, alpha_us=20.0, beta_gbps=4.0, tier="cpu")
    from accl_tpu.tuner.cost import Topology as JTopology
    tt, jt = Tuner(topology=Topology(**topo)), \
        JTuner(topology=JTopology(**topo))
    cw = cuda_world(2, device="cpu", tuner=tt)
    tw = tpu_world(2, platform="cpu", tuner=jt)
    try:
        assert cw[0].device.max_segment_size == \
            tw[0].device.max_segment_size == \
            tt.recommend_segment_size(DEFAULT_MAX_SEGMENT_SIZE)
        assert cw[0].device.tuner is tt and tw[0].device.tuner is jt
    finally:
        for a in cw + tw:
            a.deinit()


def test_cuda_topology_binds_when_the_tuner_has_none():
    tt = Tuner()
    cw = cuda_world(2, device="cpu", tuner=tt)
    try:
        topo = cw[0].device.topology()
        assert tt.topology == topo and topo.tier == "cuda"
        assert topo.world_size == 2 and topo.alpha_us > 0 \
            and topo.beta_gbps > 0
        assert cw[0].device.auto_resolvable_ops() == frozenset(
            {"allreduce", "allgather", "reduce_scatter"})
    finally:
        for a in cw:
            a.deinit()


def test_plan_cache_stats_is_the_reference_stub(worlds):
    tw, cw = worlds
    assert cw[0].plan_cache_stats() == tw[0].plan_cache_stats()
    assert cw[0].plan_cache_stats()["enabled"] is False


def test_arith_registry_form_matches():
    assert sorted(T_ARITH) == sorted(k for k in J_ARITH
                                     if k in T_ARITH)
    for key in T_ARITH:
        j, t = J_ARITH[key], T_ARITH[key]
        assert (dtype_name(t.uncompressed_dtype),
                dtype_name(t.compressed_dtype), t.quant_block) == \
            (j.uncompressed_dtype.name, j.compressed_dtype.name,
             j.quant_block)
    t, j = t_mk("float32", "int8", quant_block=64), \
        j_mk("float32", "int8", quant_block=64)
    assert t.quant_block == j.quant_block == 64


def _registry_body(torch_side: bool, registry_edit):
    def fn(a):
        out = []
        if torch_side:
            src = a.buffer(data=torch.full((16,), float(a.rank + 1)))
            dst = a.buffer((16,), torch.float32)
            wire = torch.bfloat16
        else:
            src = a.buffer(data=np.full(16, float(a.rank + 1), np.float32))
            dst = a.buffer((16,), np.float32)
            wire = ml_dtypes.bfloat16
        a.allreduce(src, dst, 16, compress_dtype=wire)     # memoized
        out.append(float(dst.data[0]))
        registry_edit(a)
        try:
            a.allreduce(src, dst, 16, compress_dtype=wire)
            out.append("ran")
        except KeyError as exc:
            out.append(f"KeyError {exc}")
        a.invalidate_arith_cache()
        try:
            a.allreduce(src, dst, 16, compress_dtype=wire)
            out.append("ran")
        except KeyError as exc:
            out.append(f"KeyError {exc}")
        a.arith_registry = a.arith_registry | {
            ("float32", "bfloat16"): (t_mk if torch_side else j_mk)(
                "float32", "bfloat16")}
        a.allreduce(src, dst, 16, compress_dtype=wire)
        out.append(float(dst.data[0]))
        return out
    return fn


def test_arith_registry_mutation_and_invalidation_match(worlds):
    """An in-place removal is not seen until invalidate_arith_cache; a
    rebound registry drops the memo at once."""
    tw, cw = worlds

    def drop(a):
        a.arith_registry.pop(("float32", "bfloat16"), None)

    want = j_run_ranks(tw, _registry_body(False, drop))
    got = run_ranks(cw, _registry_body(True, drop))
    assert got == want
    assert got[0][1] == "ran" and got[0][2].startswith("KeyError")


def test_custom_registry_entry_resolves():
    """A caller's registry entry is what the call resolves to: a
    (float32, int8) pair carrying its own quant_block rides the
    block-scaled wire when the call asks for it."""
    reg = dict(T_ARITH)
    reg[("float32", "int8")] = t_mk("float32", "int8", quant_block=32)
    cw = cuda_world(2, device="cpu")
    for a in cw:
        a.arith_registry = reg
    try:
        def fn(a):
            desc = a._prepare(
                CCLOp.allreduce, count=64,
                comm=a.comm, op0=a.buffer((64,), torch.float32),
                res=a.buffer((64,), torch.float32),
                compress_dtype=torch.int8, block_scale=64)
            return (a._arith_memo[frozenset({torch.float32, torch.int8})]
                    is reg[("float32", "int8")], desc.arithcfg.quant_block)

        for same, qb in run_ranks(cw, fn):
            assert same and qb == 64
    finally:
        for a in cw:
            a.deinit()
