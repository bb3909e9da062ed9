"""The port's N-tier hierarchy (``accl_tpu_torch/hier``) against the
reference's.

The topology helpers and the pure planner ``plan_phases`` must give the
reference's values field for field (every op, aligned, uneven and 3-tier
nests, every rank and root, counts that do and do not divide); the
hierarchical collectives of ``cuda_world(8, device="cpu")`` agree with
``tpu_world(8, platform="cpu")``'s within psum-order tolerance (rtol
1e-6, atol 1e-6 on unit-normal inputs; gathers and broadcasts bitwise)
and bitwise with the same phases issued by hand on the port's split
communicators; ``compress_phases="inter"`` agrees within the block-scaled
codec's bound; the error texts are the reference's word for word.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from accl_tpu.device.tpu import tpu_world  # noqa: E402
from accl_tpu.hier import engine as jengine  # noqa: E402
from accl_tpu.hier import topology as jtopo  # noqa: E402
from accl_tpu.testing import run_ranks as j_run_ranks  # noqa: E402
from accl_tpu.tracing import METRICS as J_METRICS  # noqa: E402
from accl_tpu_torch import cuda_world  # noqa: E402
from accl_tpu_torch.constants import CollectiveAlgorithm as A  # noqa: E402
from accl_tpu_torch.hier import engine as tengine  # noqa: E402
from accl_tpu_torch.hier import topology as ttopo  # noqa: E402
from accl_tpu_torch.testing import run_ranks  # noqa: E402
from accl_tpu_torch.tracing import METRICS  # noqa: E402
from accl_tpu_torch.tuner import Tuner  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep: the port creates no shm."""
    yield


W = 8
# the block-scaled codec's error per quantization, in units of the
# block's amax: half an e4m3 step at its scale
BS_BOUND_PER_AMAX = 2.0 ** -4 / (1 - 2.0 ** -4)
ALIGNED = [0, 0, 0, 0, 1, 1, 1, 1]
UNEVEN = [0, 0, 0, 1, 1, 1, 1, 1]
CHIPS8 = [0, 0, 1, 1, 2, 2, 3, 3]
RACKS8 = [0, 0, 0, 0, 1, 1, 1, 1]
# (hosts, coarser levels): the two-tier shapes, a singleton host, and
# three-tier nests (even, and uneven at the chip level)
NESTS = {
    "aligned": (ALIGNED, ()),
    "uneven": (UNEVEN, ()),
    "w6": ([0, 0, 0, 1, 1, 1], ()),
    "singleton": ([0, 1, 1], ()),
    "three_tier": (CHIPS8, (RACKS8,)),
    "three_tier_uneven": ([0, 0, 0, 1, 1, 2, 2, 2, 3, 3, 3, 3],
                          ([0] * 5 + [1] * 7,)),
}


def _tot(metrics, name: str, **labels) -> float:
    rows = metrics.snapshot()["counters"].get(name, {})
    want = [f"{k}={v}" for k, v in labels.items()]
    return sum(v for k, v in rows.items()
               if all(w in k.split(",") for w in want))


# -- topology -----------------------------------------------------------------

def test_groups_from_hosts_and_validate_nest_match():
    for hosts in (ALIGNED, UNEVEN, [0], [3, 3, 7], [0, 1, 2, 3]):
        assert ttopo.groups_from_hosts(hosts) == \
            jtopo.groups_from_hosts(hosts)
    for bad in ([0, 1, 0], []):
        with pytest.raises(ValueError) as te:
            ttopo.groups_from_hosts(bad)
        with pytest.raises(ValueError) as je:
            jtopo.groups_from_hosts(bad)
        assert str(te.value) == str(je.value)
    g = jtopo.groups_from_hosts
    chains = [
        (g(CHIPS8), g(RACKS8)),                        # valid
        (g(CHIPS8), g([0, 0, 0, 1, 1, 1, 1, 1])),      # splits a chip
        (g(CHIPS8), g(CHIPS8)),                        # not coarser
        (g(CHIPS8), g([0, 0, 0, 0, 1, 1])),            # wrong rank count
    ]
    for chain in chains:
        errs = []
        for fn in (ttopo.validate_nest, jtopo.validate_nest):
            try:
                fn(chain)
                errs.append(None)
            except ValueError as exc:
                errs.append(str(exc))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("kind", ["hosts", "nest"])
def test_mesh_topology_matches(kind):
    if kind == "hosts":
        kw = dict(alpha_us=20.0, beta_gbps=4.0, inter_alpha_us=200.0,
                  inter_beta_gbps=0.2)
        t = ttopo.MeshTopology.from_hosts(UNEVEN, **kw)
        j = jtopo.MeshTopology.from_hosts(UNEVEN, **kw)
    else:
        tiers = [(CHIPS8, 100.0, 0.2), (RACKS8, 300.0, 0.02)]
        t = ttopo.MeshTopology.from_nest(tiers, alpha_us=20.0,
                                         beta_gbps=4.0)
        j = jtopo.MeshTopology.from_nest(tiers, alpha_us=20.0,
                                         beta_gbps=4.0)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for attr in ("n_hosts", "two_tier", "n_tiers", "aligned", "mesh_world"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.hosts_list() == j.hosts_list()
    assert t.nest() == j.nest()
    assert t.hosts_levels() == j.hosts_levels()
    for lvl in range(t.n_tiers):
        for w in (None, 2, 4):
            assert dataclasses.asdict(t.tier_topology(lvl, w)) == \
                dataclasses.asdict(j.tier_topology(lvl, w))
        assert t.tier_beta_gbps(lvl) == j.tier_beta_gbps(lvl)
    assert dataclasses.asdict(t.flat_equivalent()) == \
        dataclasses.asdict(j.flat_equivalent())


# -- the planner ----------------------------------------------------------------

def _plan_dict(plan):
    if plan is None:
        return None
    return {"mode": plan.mode, "scratch": dict(plan.scratch),
            "phases": [dataclasses.asdict(p) for p in plan.phases]}


@pytest.mark.parametrize("nest", sorted(NESTS))
@pytest.mark.parametrize("op", ["allreduce", "bcast", "allgather",
                                "reduce_scatter"])
def test_plan_phases_field_for_field(op, nest):
    hosts, levels = NESTS[nest]
    groups = jtopo.groups_from_hosts(hosts)
    lv = tuple(jtopo.groups_from_hosts(x) for x in levels)
    n = len(hosts)
    counts = (1, 7, 12, 24, 1000, 4096)    # divides some group sizes only
    roots = range(n) if op == "bcast" else (0,)
    checked = 0
    for me in range(n):
        for count in counts:
            for root in roots:
                want = jengine.plan_phases(op, groups, me, count, root,
                                           nest=lv)
                got = tengine.plan_phases(op, groups, me, count, root,
                                          nest=lv)
                assert _plan_dict(got) == _plan_dict(want), \
                    (op, nest, me, count, root)
                checked += 1
    assert checked >= n * len(counts)
    for ph in want.phases:
        assert tengine.phase_tier_level(ph.members, (groups,) + lv) == \
            jengine.phase_tier_level(ph.members, (groups,) + lv)


def test_plan_degenerate_and_refusals_match():
    one = jtopo.groups_from_hosts([0, 0, 0])
    assert tengine.plan_phases("allreduce", one, 0, 8) is None
    assert jengine.plan_phases("allreduce", one, 0, 8) is None
    two = jtopo.groups_from_hosts([0, 1])
    with pytest.raises(ValueError) as te:
        tengine.plan_phases("alltoall", two, 0, 8)
    with pytest.raises(ValueError) as je:
        jengine.plan_phases("alltoall", two, 0, 8)
    assert str(te.value) == str(je.value)


class _Comm:
    size = 8
    local_rank = 0


class _Accl:
    def __init__(self, tuner_topology):
        self.comm = _Comm()
        self.tuner = type("T", (), {"topology": tuner_topology})()


def test_compress_predicate_forms_match():
    tiers = [(CHIPS8, 100.0, 0.2), (RACKS8, 300.0, 0.02)]
    t = tengine.Hierarchy(_Accl(ttopo.MeshTopology.from_nest(
        tiers, alpha_us=20.0, beta_gbps=4.0)), CHIPS8, levels=[RACKS8])
    j = jengine.Hierarchy(_Accl(jtopo.MeshTopology.from_nest(
        tiers, alpha_us=20.0, beta_gbps=4.0)), CHIPS8, levels=[RACKS8])
    seen_t, seen_j = [], []
    for form in (None, "all", "inter", "slow", 0.1, 5.0,
                 lambda lvl, beta: seen_t.append((lvl, beta)) or lvl == 2):
        jform = form
        if callable(form):
            def jform(lvl, beta):
                seen_j.append((lvl, beta))
                return lvl == 2
        got = [t._compress_predicate(form)(lv) for lv in range(3)]
        want = [j._compress_predicate(jform)(lv) for lv in range(3)]
        assert got == want, form
    assert seen_t == seen_j == [(0, 4.0), (1, 0.2), (2, 0.02)]
    for bad in ("sometimes", [1]):
        with pytest.raises(ValueError) as te:
            t._compress_predicate(bad)
        with pytest.raises(ValueError) as je:
            j._compress_predicate(bad)
        assert str(te.value) == str(je.value)
    # no mesh figures: every boundary tier is presumed slow
    t0 = tengine.Hierarchy(_Accl(None), ALIGNED)
    j0 = jengine.Hierarchy(_Accl(None), ALIGNED)
    assert [t0._compress_predicate("slow")(lv) for lv in range(2)] == \
        [j0._compress_predicate("slow")(lv) for lv in range(2)]


# -- the worlds -------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    tw = tpu_world(W, platform="cpu")
    cw = cuda_world(W, device="cpu")
    yield tw, cw
    for a in tw + cw:
        a.deinit()


def _inputs(n: int, seed: int, w: int = W):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(w)]


def _collectives(count: int, ins, bins, torch_side: bool, **kw):
    """Every rank: HIERARCHICAL allreduce, allgather (count a rank),
    reduce_scatter (count a rank) and bcast (root 5) of its inputs."""

    def fn(a):
        r, Wd = a.rank, a.world_size
        if torch_side:
            mk = lambda x: a.buffer(data=torch.from_numpy(x.copy()))  # noqa
            empty = lambda n: a.buffer((n,), torch.float32)  # noqa
        else:
            mk = lambda x: a.buffer(data=x.copy())  # noqa
            empty = lambda n: a.buffer((n,), np.float32)  # noqa
        out = {}
        src, dst = mk(ins[r]), empty(Wd * count)
        a.allreduce(src, dst, Wd * count, algorithm="HIERARCHICAL", **kw)
        out["allreduce"] = dst
        g = empty(Wd * count)
        a.allgather(mk(ins[r][:count]), g, count, algorithm="HIERARCHICAL")
        out["allgather"] = g
        rs = empty(count)
        a.reduce_scatter(src, rs, count, algorithm="HIERARCHICAL", **kw)
        out["reduce_scatter"] = rs
        b = mk(bins[r])
        a.bcast(b, Wd * count, root=5, algorithm="HIERARCHICAL")
        out["bcast"] = b
        return {k: np.asarray(v.data, dtype=np.float32).copy()
                for k, v in out.items()}
    return fn


def _configure(accls, hosts, levels=()):
    for a in accls:
        a.configure_hierarchy(hosts, levels=levels)


@pytest.mark.parametrize("nest", ["aligned", "uneven", "three_tier"])
def test_hierarchical_collectives_match_tpu_world(worlds, nest):
    tw, cw = worlds
    hosts, levels = NESTS[nest]
    count = 96
    ins = _inputs(W * count, 3)
    bins = _inputs(W * count, 4)
    _configure(tw, hosts, levels)
    _configure(cw, hosts, levels)
    want = j_run_ranks(tw, _collectives(count, ins, bins, False))
    got = run_ranks(cw, _collectives(count, ins, bins, True))
    total = np.sum(np.stack(ins).astype(np.float64), axis=0)
    gathered = np.concatenate([x[:count] for x in ins])
    for r in range(W):
        for op in ("allreduce", "reduce_scatter"):
            np.testing.assert_allclose(got[r][op], want[r][op],
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[r]["allreduce"], total, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[r]["reduce_scatter"],
                                   total[r * count:(r + 1) * count],
                                   rtol=1e-5, atol=1e-5)
        assert np.array_equal(got[r]["allgather"], want[r]["allgather"])
        assert np.array_equal(got[r]["allgather"], gathered)
        assert np.array_equal(got[r]["bcast"], want[r]["bcast"])
        assert np.array_equal(got[r]["bcast"], bins[5])


def test_hierarchical_matches_hand_issued_phases(worlds):
    """2 hosts x 4 ranks: the engine's programs bitwise against the same
    phases issued one by one on split communicators of the port."""
    _, cw = worlds
    count = 64
    n = W * count
    ins = _inputs(n, 5)
    bins = _inputs(n, 6)
    _configure(cw, ALIGNED)
    got = run_ranks(cw, _collectives(count, ins, bins, True))

    def by_hand(a):
        r = a.rank
        host, j = divmod(r, 4)
        inner = a.split_communicator([4 * host + i for i in range(4)],
                                     key=0x7001)
        outer = a.split_communicator([j, 4 + j], key=0x7002 + j)
        leaders = (a.split_communicator([0, 4], key=0x7010)
                   if r in (0, 4) else None)
        reps = a.split_communicator([0, 5], key=0x7011) \
            if r in (0, 5) else None
        mk = lambda x: a.buffer(data=torch.from_numpy(x.copy()))  # noqa
        empty = lambda k: a.buffer((k,), torch.float32)  # noqa
        out = {}
        src = mk(ins[r])
        s1, s2, dst = empty(n // 4), empty(n // 4), empty(n)
        a.reduce_scatter(src, s1, n // 4, comm=inner)
        a.allreduce(s1, s2, n // 4, comm=outer)
        a.allgather(s2, dst, n // 4, comm=inner)
        out["allreduce"] = dst
        g = empty(n)
        blk = g[4 * host * count:(4 * host + 4) * count]
        a.gather(mk(ins[r][:count]), blk if j == 0 else None, count,
                 root=0, comm=inner)
        if j == 0:
            a.allgather(blk, g, 4 * count, comm=leaders)
        a.bcast(g, n, root=0, comm=inner)
        out["allgather"] = g
        sn = empty(n) if j == 0 else None
        a.reduce(src, sn, n, root=0, comm=inner)
        sb = empty(4 * count) if j == 0 else None
        if j == 0:
            a.reduce_scatter(sn, sb, 4 * count, comm=leaders)
        rs = empty(count)
        a.scatter(sb, rs, count, root=0, comm=inner)
        out["reduce_scatter"] = rs
        b = mk(bins[r])
        if r in (0, 5):
            a.bcast(b, n, root=1, comm=reps)
        a.bcast(b, n, root=0 if host == 0 else 1, comm=inner)
        out["bcast"] = b
        return {k: np.asarray(v.data, dtype=np.float32).copy()
                for k, v in out.items()}

    want = run_ranks(cw, by_hand)
    for r in range(W):
        for op in want[r]:
            assert np.array_equal(got[r][op].view(np.uint32),
                                  want[r][op].view(np.uint32)), (r, op)


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_compress_phases_inter_fp8_matches_reference(worlds, resident):
    """fp8-e4m3 block 128 on the inter phases only: within the codec's
    bound of the reference, the same hier_phase_wire_total rows."""
    tw, cw = worlds
    n = W * 512
    ins = _inputs(n, 9)
    import ml_dtypes
    _configure(tw, ALIGNED)
    _configure(cw, ALIGNED)

    def body(torch_side):
        def fn(a):
            x = ins[a.rank].copy()
            if torch_side:
                src = a.buffer(data=torch.from_numpy(x),
                               device_resident=resident)
                dst = a.buffer((n,), torch.float32,
                               device_resident=resident)
                wire = torch.float8_e4m3fn
            else:
                src, dst = a.buffer(data=x), a.buffer((n,), np.float32)
                wire = ml_dtypes.float8_e4m3fn
            a.allreduce(src, dst, n, algorithm="HIERARCHICAL",
                        compress_dtype=wire, block_scale=128,
                        compress_phases="inter")
            return np.asarray(dst.data, dtype=np.float32).copy()
        return fn

    def rows(metrics):
        return {w: _tot(metrics, "hier_phase_wire_total", tier=t, wire=w)
                for t, w in (("intra", "full"), ("inter", "quantized"))}

    j0, t0 = rows(J_METRICS), rows(METRICS)
    want = j_run_ranks(tw, body(False))
    got = run_ranks(cw, body(True))
    j1, t1 = rows(J_METRICS), rows(METRICS)
    dj = {k: j1[k] - j0[k] for k in j1}
    dt = {k: t1[k] - t0[k] for k in t1}
    assert dt == dj == {"full": 2 * W, "quantized": W}
    total = np.sum(np.stack(ins).astype(np.float64), axis=0)
    amax = float(np.abs(np.stack(ins)).sum(axis=0).max())
    # the 2-rank inter allreduce quantizes an element twice (one
    # reduce-scatter hop, the allgather): each within half an e4m3 step
    # of its block's scale, BS_BOUND_PER_AMAX of max sum|x|
    bound = BS_BOUND_PER_AMAX * 2 * amax + 1e-3
    for r in range(W):
        assert np.abs(got[r] - want[r]).max() <= 2 * bound
        err = np.abs(got[r] - total).max()
        assert 0 < err <= bound, err


def test_explicit_hierarchical_requires_configuration():
    cw = cuda_world(2, device="cpu")
    tw = tpu_world(2, platform="cpu")
    try:
        msgs = []
        for a, mk in ((cw[0], lambda: cw[0].buffer((8,), torch.float32)),
                      (tw[0], lambda: tw[0].buffer((8,), np.float32))):
            src, dst = mk(), mk()
            with pytest.raises(ValueError, match="configure_hierarchy") as e:
                a.allreduce(src, dst, 8, algorithm="HIERARCHICAL")
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        msgs = []
        for a in (cw[0], tw[0]):
            with pytest.raises(ValueError) as e:
                a.configure_hierarchy([0, 0])
            msgs.append(str(e.value))
            with pytest.raises(ValueError) as e:
                a.configure_hierarchy([0, 1, 1])
            msgs.append(str(e.value))
            with pytest.raises(ValueError) as e:
                a.configure_hierarchy([0, 1], levels=[[0, 0, 1]])
            msgs.append(str(e.value))
        assert msgs[:3] == msgs[3:]
        assert "at least two hosts" in msgs[0] and "maps" in msgs[1]
    finally:
        for a in cw + tw:
            a.deinit()


def test_split_comm_and_multidim_refusals_match(worlds):
    tw, cw = worlds
    _configure(tw, ALIGNED)
    _configure(cw, ALIGNED)

    def body(torch_side):
        dt = torch.float32 if torch_side else np.float32

        def fn(a):
            msgs = []
            sub = a.split_communicator([0, 1], key=0x7777) \
                if a.rank in (0, 1) else None
            if sub is not None:
                s, d = a.buffer((8,), dt), a.buffer((8,), dt)
                with pytest.raises(ValueError, match="WORLD") as e:
                    a.allreduce(s, d, 8, comm=sub, algorithm="HIERARCHICAL")
                msgs.append(str(e.value))
            s, d2 = a.buffer((8,), dt), a.buffer((8, 8), dt)
            with pytest.raises(ValueError, match="1-D") as e:
                a.allgather(s, d2, 8, algorithm="HIERARCHICAL")
            msgs.append(str(e.value))
            with pytest.raises(ValueError, match="compress_phases") as e:
                a.allreduce(s, s, 8, compress_phases="sometimes")
            msgs.append(str(e.value))
            return msgs
        return fn

    want = j_run_ranks(tw, body(False))
    got = run_ranks(cw, body(True))
    assert got == want


def test_barrier_immune_to_hierarchical_tuner():
    """A tuner pinned HIERARCHICAL for every allreduce bucket does not
    reroute the barrier; a flat AUTO call that leans HIERARCHICAL with
    no hierarchy takes the flat default."""
    tuner = Tuner()
    cw = cuda_world(4, device="cpu", tuner=tuner)
    for b in range(0, 31):
        tuner.pin("allreduce", 4, b, A.HIERARCHICAL)
    try:
        def body(a):
            a.barrier()
            s = a.buffer(data=torch.full((8,), float(a.rank)))
            d = a.buffer((8,), torch.float32)
            a.allreduce(s, d, 8)
            return d.data.copy()

        for out in run_ranks(cw, body, timeout=30.0):
            assert (out == 6.0).all()
    finally:
        for a in cw:
            a.deinit()


def test_async_hier_private_scratch_on_singleton_host():
    """Back-to-back ASYNC hierarchical allreduces with a singleton host:
    call 2's inner phase has no FIFO ordering against call 1's draining
    leader phase (another comm), so each async program gets private
    scratch."""
    hosts = [0, 1, 1]
    n = 512
    cw = cuda_world(3, device="cpu")
    for a in cw:
        a.configure_hierarchy(hosts)

    def body(a):
        s1 = a.buffer(data=torch.full((n,), 1.0 + a.rank))
        d1 = a.buffer((n,), torch.float32)
        s2 = a.buffer(data=torch.full((n,), 10.0 + a.rank))
        d2 = a.buffer((n,), torch.float32)
        h1 = a.allreduce(s1, d1, n, algorithm="HIERARCHICAL",
                         run_async=True)
        h2 = a.allreduce(s2, d2, n, algorithm="HIERARCHICAL",
                         run_async=True, waitfor=[h1])
        h2.wait(60.0)
        h1.wait(60.0)
        return float(d1.data[0]), float(d2.data[0]), \
            bool((d1.data == d1.data[0]).all())

    try:
        outs = run_ranks(cw, body, timeout=60.0)
    finally:
        for a in cw:
            a.deinit()
    for v1, v2, flat in outs:
        assert v1 == 6.0 and v2 == 33.0 and flat, (v1, v2)


def test_tuner_auto_routes_like_the_reference():
    """A shared tuner over a two-tier MeshTopology: AUTO allreduces with
    compress_dtype="auto" route and pick their wire as the reference's
    tuner does; the results agree within the fp8 codec's bound."""
    from accl_tpu.tuner import Tuner as JTuner
    from accl_tpu.hier import MeshTopology as JMesh
    from accl_tpu_torch.hier import MeshTopology as TMesh
    jt = JTuner(topology=JMesh.from_hosts(ALIGNED))
    tt = Tuner(topology=TMesh.from_hosts(ALIGNED))
    tws = tpu_world(W, platform="cpu", tuner=jt)
    cws = cuda_world(W, device="cpu", tuner=tt)
    sizes = (64, 4096, 1 << 15)
    ins = {n: _inputs(n, n) for n in sizes}

    def body(torch_side):
        def fn(a):
            out = []
            for n in sizes:
                x = ins[n][a.rank].copy()
                if torch_side:
                    src, dst = (a.buffer(data=torch.from_numpy(x)),
                                a.buffer((n,), torch.float32))
                else:
                    src, dst = a.buffer(data=x), a.buffer((n,), np.float32)
                a.allreduce(src, dst, n, compress_dtype="auto")
                out.append(np.asarray(dst.data, np.float32).copy())
            return out
        return fn

    try:
        want = j_run_ranks(tws, body(False))
        got = run_ranks(cws, body(True))
    finally:
        for a in tws + cws:
            a.deinit()
    assert cws[0].hierarchy is not None and tws[0].hierarchy is not None
    for i, n in enumerate(sizes):
        nb = 4 * n
        assert tt.select("allreduce", W, nb).name == \
            jt.select("allreduce", W, nb).name
        assert tt.select_wire("allreduce", W, nb) == \
            jt.select_wire("allreduce", W, nb)
        total = np.sum(np.stack(ins[n]).astype(np.float64), axis=0)
        amax = float(np.abs(np.stack(ins[n])).sum(axis=0).max())
        # every phase quantized: 3 inner reduce-scatter hops, the 2-rank
        # outer allreduce's 2 quantizations and the inner allgather's 1
        bound = BS_BOUND_PER_AMAX * 6 * amax + 1e-3
        for r in range(W):
            assert np.abs(got[r][i] - total).max() <= bound
            assert np.abs(got[r][i] - want[r][i]).max() <= 2 * bound


def test_concurrent_outer_groups_stress():
    """Four 2-rank outer groups at once, many times over, under a short
    switch interval: every rank's result stays the exact sum."""
    import sys
    cw = cuda_world(W, device="cpu")
    _configure(cw, ALIGNED)
    n = 256
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def body(a):
            s = a.buffer(data=torch.full((n,), float(a.rank + 1)))
            d = a.buffer((n,), torch.float32)
            ok = True
            for _ in range(20):
                a.allreduce(s, d, n, algorithm="HIERARCHICAL")
                ok &= bool((d.data == 36.0).all())
            return ok

        assert all(run_ranks(cw, body, timeout=120.0))
    finally:
        sys.setswitchinterval(old)
        for a in cw:
            a.deinit()
