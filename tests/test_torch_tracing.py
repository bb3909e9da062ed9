"""The port's profiler, flight recorder and exposition against the
reference's ``accl_tpu.tracing``.

The same calls on ``tpu_world(4, platform="cpu")`` and
``cuda_world(4, device="cpu")`` give equal ``CallRecord`` fields (all but
the two times), including the logical records of a hierarchical
allreduce and of a redistribute with their phases' ``parent`` tags, and
the same flight-recorder event kinds; the registries' Prometheus text,
the Chrome JSON and the profiler's summary, table and CSV are held to
the reference's byte for byte on the same inputs.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from accl_tpu import tracing as jt  # noqa: E402
from accl_tpu.constants import ACCLError as JACCLError  # noqa: E402
from accl_tpu.device.tpu import tpu_world  # noqa: E402
from accl_tpu.hier import ShardSpec as JShardSpec  # noqa: E402
from accl_tpu.retry import RetryPolicy as JRetryPolicy  # noqa: E402
from accl_tpu.testing import run_ranks as j_run_ranks  # noqa: E402
from accl_tpu_torch import (ACCLError, ErrorCode, cuda_world,  # noqa: E402
                            tracing as pt)
from accl_tpu_torch.hier import ShardSpec  # noqa: E402
from accl_tpu_torch.retry import RetryPolicy  # noqa: E402
from accl_tpu_torch.testing import run_ranks  # noqa: E402

W = 4
N = 64


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep: the port creates no shm."""
    yield


@pytest.fixture
def worlds():
    tw = tpu_world(W, platform="cpu")
    cw = cuda_world(W, device="cpu")
    yield tw, cw
    for a in tw + cw:
        a.deinit()


def _bufs(a, jax_side: bool, values, n_out):
    if jax_side:
        return (a.buffer(data=np.asarray(values, np.float32)),
                a.buffer((n_out,), np.float32))
    return (a.buffer(data=torch.tensor(values, dtype=torch.float32)),
            a.buffer((n_out,), torch.float32))


def _calls(jax_side: bool):
    """Integer-valued operands, so every result is exact on both sides."""
    def fn(a):
        r = a.rank
        src, dst = _bufs(a, jax_side, [float(r + i % 5) for i in range(N)], N)
        big, out = _bufs(a, jax_side, [float(r)] * (W * N), W * N)
        a.start_profiling()
        a.nop()
        a.allreduce(src, dst, N)
        a.allreduce(src, dst, N, algorithm="ring")
        a.allgather(src, out, N)
        a.reduce_scatter(big, dst, N)
        a.bcast(src, N, root=1)
        a.reduce(src, dst, N, root=2)
        if r == 0:
            a.send(src, N, dst=1, tag=5)
        elif r == 1:
            a.recv(dst, N, src=0, tag=5)
        a.copy(src, dst, N)
        a.end_profiling()
        a.nop()                         # not recorded: profiling is off
        return a.profiler.records
    return fn


def _fields(rec) -> tuple:
    d = dataclasses.asdict(rec)
    d.pop("t_start")
    d.pop("duration_s")
    return tuple(sorted(d.items()))


def test_call_records_match_reference(worlds):
    tw, cw = worlds
    ref = j_run_ranks(tw, _calls(True))
    got = run_ranks(cw, _calls(False))
    for r in range(W):
        assert sorted(map(_fields, got[r])) == sorted(map(_fields, ref[r]))
        assert all(x.duration_s > 0 for x in got[r])
    ops = collections.Counter(x.op for x in got[0])
    assert ops == {"nop": 1, "allreduce": 2, "allgather": 1,
                   "reduce_scatter": 1, "bcast": 1, "reduce": 1, "send": 1,
                   "copy": 1}
    assert {x.algorithm for x in got[0] if x.op == "allreduce"} == {
        "AUTO", "RING"}
    # a nop names no communicator (comm id 0), as in the reference
    assert {x.tenant for x in got[0] if x.op != "nop"} == {
        f"comm-{cw[0].comm.comm_id}"}


def _logical(jax_side: bool, hosts):
    def fn(a):
        r = a.rank
        src, dst = _bufs(a, jax_side, [float(r * 3 + i % 7) for i in range(N)],
                         N)
        a.configure_hierarchy(hosts)
        spec = (JShardSpec if jax_side else ShardSpec)
        shard, full = _bufs(a, jax_side, [float(r)] * (N // W), N)
        a.start_profiling()
        a.allreduce(src, dst, N, algorithm="HIERARCHICAL")
        a.redistribute(shard, spec.even(N, W), full,
                       spec.replicated(N, W))
        a.end_profiling()
        return a.profiler.records
    return fn


def test_logical_records_and_parent_tags(worlds):
    """A hierarchical allreduce reads as one call: one HIERARCHICAL record
    beside its phases, all under one ``parent`` tag; a redistribute gives
    one record of its plan's kind beside the calls it issued."""
    tw, cw = worlds
    hosts = [0, 0, 1, 1]
    ref = j_run_ranks(tw, _logical(True, hosts))
    got = run_ranks(cw, _logical(False, hosts))
    for r in range(W):
        assert sorted(map(_fields, got[r])) == sorted(map(_fields, ref[r]))
        by_parent = collections.defaultdict(list)
        for x in got[r]:
            by_parent[x.parent].append(x)
        assert set(by_parent) == {"hier:allreduce#1", "redist#1"}
        hier = by_parent["hier:allreduce#1"]
        logical = [x for x in hier if x.algorithm == "HIERARCHICAL"]
        assert len(logical) == 1 and logical[0].op == "allreduce"
        assert logical[0].count == N and len(hier) > 1
        redist = by_parent["redist#1"]
        assert [x.op for x in redist if x.op == "redistribute"] == [
            "redistribute"]
        assert {x.algorithm for x in redist if x.op == "redistribute"} == {
            "ALLGATHER"}


def _emitting(jax_side: bool):
    def fn(a):
        r = a.rank
        src, dst = _bufs(a, jax_side, [float(r + i % 3) for i in range(N)], N)
        a.allreduce(src, dst, N, verify_integrity=True)          # fingerprint
        spec = JShardSpec if jax_side else ShardSpec
        shard, full = _bufs(a, jax_side, [float(r)] * (N // W), N)
        a.redistribute(shard, spec.even(N, W), full,
                       spec.replicated(N, W))                    # reshard
        sub = a.shrink_communicator([3]) if r != 3 else None     # shrink
        if r != 3:
            a.grow_communicator([3], comm=sub, key=7)            # grow
        else:
            a.grow_communicator([3], base_members=[0, 1, 2], key=7)
        if r == 1:                                               # call_retry
            a.set_timeout(0.05)
            pol = (JRetryPolicy if jax_side else RetryPolicy)(
                retries=1, backoff_s=0.01)
            with pytest.raises((ACCLError, JACCLError)) as ei:
                a.recv(dst, N, src=2, tag=77, retry_policy=pol)
            assert ei.value.error_word & int(ErrorCode.RECEIVE_TIMEOUT_ERROR)
            a.set_timeout(30.0)
        return True
    return fn


def test_trace_event_kinds_match_reference(worlds):
    """The driver's emit sites (fingerprint, reshard, membership_shrink,
    membership_grow, call_retry) give the same events by (stage, rank) on
    both packages, and none while the recorder is disarmed."""
    tw, cw = worlds
    kinds = {}
    for name, trace, world, runner, jax_side in (
            ("ref", jt.TRACE, tw, j_run_ranks, True),
            ("port", pt.TRACE, cw, run_ranks, False)):
        trace.clear()
        trace.start()
        try:
            runner(world, _emitting(jax_side))
        finally:
            trace.stop()
        kinds[name] = collections.Counter(
            (e["stage"], e["rank"]) for e in trace.events())
        trace.clear()
        runner(world, lambda a: a.soft_reset())
    assert kinds["port"] == kinds["ref"]
    stages = {s for s, _ in kinds["port"]}
    assert stages == {"fingerprint", "reshard", "membership_shrink",
                      "membership_grow", "call_retry"}
    run_ranks(cw, _emitting(False))          # disarmed: nothing recorded
    assert pt.TRACE.events() == []


def _fill(reg):
    reg.inc("accl_calls_total", 3, op="allreduce", rank=0, tenant="t-a")
    reg.inc("accl_calls_total", op="bcast", rank=1, tenant="comm-7")
    reg.inc("plain_total")
    reg.set_gauge("rx_pool_occupancy", 0.25, rank=2)
    for v in (0.5, 3.0, 17.0, 1e6, 4.0 ** 9):
        reg.observe("queue_wait_us", v, tenant="t-a")
    reg.observe("lat_us", 2.0)

    class Owner:
        pass
    owner = Owner()
    reg.register_collector(owner, lambda o: [
        ("counter", "accl_bytes_total", {"op": "allreduce", "rank": 0}, 64),
        ("gauge", "executor_last_moves", {"rank": 0}, 5),
        ("histogram", "queue_wait_us", {"tenant": "t-b"},
         [2, 10.0, [1, 1] + [0] * 9])])
    return owner


def test_prometheus_text_byte_for_byte():
    """The same registry contents give the same exposition text, and
    ``reset`` drops the direct writes but keeps the collectors."""
    regs = (jt.MetricsRegistry(), pt.MetricsRegistry())
    owners = [_fill(r) for r in regs]
    texts = [r.to_prometheus() for r in regs]
    assert texts[0] == texts[1]
    assert 'accl_calls_total{op="allreduce",rank="0",tenant="t-a"} 3' \
        in texts[1]
    assert 'queue_wait_us_bucket{tenant="t-a",le="+Inf"} 5' in texts[1]
    for r in regs:
        r.reset()
    after = [r.to_prometheus() for r in regs]
    assert after[0] == after[1]
    assert "plain_total" not in after[1]
    assert "accl_bytes_total" in after[1]
    del owners


def test_metrics_text_rows_carry_tenant(worlds):
    """``metrics_text`` is the exposition of the process registry, and
    every call-accounting row of the world carries a ``tenant`` label."""
    _, cw = worlds
    run_ranks(cw, _calls(False))
    text = cw[0].metrics_text()
    assert text == pt.METRICS.to_prometheus()
    ctx = f'ctx="{cw[0].device.ctx.seq}"'
    rows = [ln for ln in text.splitlines()
            if ln.startswith("accl_calls_total{") and ctx in ln]
    assert len(rows) >= W
    assert all('tenant="comm-' in ln for ln in rows)


def _records():
    rng = np.random.default_rng(4)
    out = []
    for i in range(23):
        op = ("allreduce", "bcast", "send")[i % 3]
        out.append(dict(op=op, count=int(rng.integers(1, 1 << 20)),
                        nbytes=int(rng.integers(4, 1 << 22)), comm_id=7 + i % 2,
                        t_start=float(rng.random() * 100),
                        duration_s=float(rng.random() * 1e-2),
                        error_word=int(i == 5), algorithm="RING" if i % 2
                        else "", tenant="t-a" if i % 4 else "",
                        parent="hier:allreduce#1" if i == 3 else "",
                        lanes=i % 3, overlap_frac=0.125 * (i % 5)))
    return out


def test_profiler_summary_table_and_csv_round_trip(tmp_path):
    """Summary, table and CSV equal the reference's on the same records;
    each package reads back the other's CSV."""
    ref, port = jt.Profiler(), pt.Profiler()
    ref.start()
    port.start()
    for d in _records():
        ref.record(jt.CallRecord(**d))
        port.record(pt.CallRecord(**d))
    assert {k: dataclasses.asdict(v) for k, v in port.summary().items()} == {
        k: dataclasses.asdict(v) for k, v in ref.summary().items()}
    assert port.table() == ref.table()
    assert port.summary()["send"].mean_gbps == ref.summary()["send"].mean_gbps
    p_csv, r_csv = tmp_path / "port.csv", tmp_path / "ref.csv"
    port.to_csv(str(p_csv))
    ref.to_csv(str(r_csv))
    assert p_csv.read_text() == r_csv.read_text()
    back = pt.Profiler.read_csv(str(p_csv))
    assert [_fields(x) for x in back] == [
        _fields(x) for x in jt.Profiler.read_csv(str(p_csv))]
    assert [(x.op, x.count, x.tenant, x.parent) for x in back] == [
        (d["op"], d["count"], d["tenant"], d["parent"]) for d in _records()]
    assert [_fields(x) for x in pt.Profiler.read_csv(str(r_csv))] == [
        _fields(x) for x in back]
    assert pt.Profiler().summary() == {} and pt._percentile([], 0.5) == 0.0


def test_record_after_stop_is_dropped(worlds):
    """The switch is read when a call retires: an async call issued while
    profiling and retired after ``end_profiling`` leaves no record, as a
    standalone ``record`` after ``stop`` does not."""
    from accl_tpu_torch.call import CallHandle
    prof = pt.Profiler()
    prof.start()
    h = CallHandle()
    prof.attach(h, "allreduce", 4, 16, 1)
    prof.stop()
    h.complete(0)
    prof.record(pt.CallRecord("x", 1, 4, 1, 0.0, 1e-6))
    assert prof.records == []
    prof.start()
    h2 = CallHandle()
    prof.attach(h2, "bcast", 4, 16, 1, algorithm="TREE", tenant="t",
                parent="p")
    h2.complete(3)
    (rec,) = prof.records
    assert (rec.op, rec.error_word, rec.algorithm, rec.tenant,
            rec.parent) == ("bcast", 3, "TREE", "t", "p")
    prof.clear()
    assert prof.records == []


def test_measure_call_latency_keys(worlds):
    tw, cw = worlds
    got = pt.measure_call_latency(cw[0], n=20)
    ref = jt.measure_call_latency(tw[0], n=20)
    assert set(got) == set(ref) == {"n", "p50_us", "p95_us", "mean_us",
                                    "min_us"}
    assert got["n"] == 20.0
    assert 0 < got["min_us"] <= got["p50_us"] <= got["p95_us"]


def _events():
    evs = []
    for i in range(12):
        evs.append({"t_ns": 1000 * i + 7, "dur_ns": 250 * (i % 3),
                    "stage": ("recv", "combine", "egress", "call_retry")[i % 4],
                    "rank": i % 3 - 1, "call_seq": i // 4, "lane": i % 2 - 1,
                    "step": i % 5 - 1, "seqn": i, "peer": (i + 1) % 3,
                    "nbytes": 64 * i, "thread": f"cuda-rank{i % 2}",
                    "tenant": "t-b" if i % 5 == 0 else ""})
    return evs


def test_chrome_json_byte_for_byte(tmp_path):
    """The Chrome/Perfetto export of the same events is the reference's,
    byte for byte, and valid trace-event JSON."""
    paths = []
    for name, mod in (("ref", jt), ("port", pt)):
        path = tmp_path / f"{name}.json"
        assert mod.EventTrace().export_chrome(str(path), _events()) == 12
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    doc = json.loads(paths[1].read_text())
    assert doc["displayTimeUnit"] == "ms"
    phases = collections.Counter(e["ph"] for e in doc["traceEvents"])
    assert phases["X"] == 12 and phases["M"] >= 2
    for e in doc["traceEvents"]:
        assert {"ph", "name", "pid", "tid", "args"} <= set(e)
        if e["ph"] == "X":
            assert {"ts", "dur", "cat"} <= set(e)


def test_emit_overlap_and_trigger_dump(tmp_path):
    """A disarmed recorder keeps nothing; armed, the events read back in
    time order and ``overlap_frac`` equals the reference's on the same
    emits; ``trigger_dump`` writes at most ``max_dumps`` files an
    arming."""
    tr, jr = pt.EventTrace(capacity=512), jt.EventTrace(capacity=512)
    for t in (tr, jr):
        t.emit("combine", rank=0, call_seq=1, t_ns=10, dur_ns=5)
        assert t.events() == []
        t.start()
        t.emit("combine", rank=0, call_seq=1, t_ns=100, dur_ns=50)
        t.emit("recv", rank=0, call_seq=1, peer=1, seqn=3, t_ns=120,
               dur_ns=100)
        t.emit("wire_send", rank=1, peer=0, seqn=3, t_ns=90)
        t.emit("combine", rank=1, call_seq=2, t_ns=400, dur_ns=10)
    assert [e["stage"] for e in tr.events()] == [
        e["stage"] for e in jr.events()] == ["wire_send", "combine", "recv",
                                            "combine"]
    for seq in (1, 2, 3):
        assert tr.overlap_frac(seq) == jr.overlap_frac(seq)
    assert tr.overlap_frac(1) == 1.0 and tr.overlap_frac(3) is None
    tr.dump_dir, tr.max_dumps = str(tmp_path), 2
    paths = [tr.trigger_dump("recv deadline, rank 1") for _ in range(3)]
    assert paths[2] is None and all(os.path.exists(p) for p in paths[:2])
    assert os.path.basename(paths[0]).endswith("_1_recv_deadline__rank_1.json")
    tr.stop()
    assert tr.trigger_dump("off") is None
    tr.start()                              # a fresh budget an arming
    assert tr.trigger_dump("again") is not None
    assert tr.next_call_seq() + 1 == tr.next_call_seq()
    tr.clear()
    assert tr.events() == [] and tr.dump_paths == []


def test_failure_sites_dump_the_recorder(tmp_path):
    """An armed flight recorder is dumped where the port's device fails a
    call, as the reference's executor does: a receive's deadline
    (``recv_deadline_abort``, the reference's reason), a collective group
    incomplete at its deadline and a communicator abort. Each dump is a
    Chrome trace; a disarmed recorder writes nothing."""
    tr = pt.TRACE
    saved = (tr.enabled, tr.dump_dir, tr.max_dumps)
    cw = cuda_world(2, device="cpu", timeout=0.2)
    try:
        def failures():
            buf = cw[0].buffer(data=torch.zeros(4))
            with pytest.raises(ACCLError) as ei:
                cw[0].recv(buf, 4, src=1, tag=7)
            assert ei.value.error_word & ErrorCode.RECEIVE_TIMEOUT_ERROR
            with pytest.raises(ACCLError) as ei:
                cw[0].allreduce(buf, cw[0].buffer((4,), torch.float32), 4)
            assert ei.value.error_word & ErrorCode.RECEIVE_TIMEOUT_ERROR
            cw[1].device.abort_comm(cw[1].comm.comm_id,
                                    int(ErrorCode.PEER_FAILED))

        tr.stop()
        tr.clear()
        tr.dump_dir, tr.max_dumps = str(tmp_path), 8
        failures()
        assert tr.dump_paths == [] and os.listdir(tmp_path) == []
        tr.start()
        failures()
        tr.stop()
        names = [os.path.basename(p) for p in tr.dump_paths]
        want = ["recv_deadline_abort", "collective_deadline_abort",
                f"comm{cw[1].comm.comm_id}_abort_0x"
                f"{int(ErrorCode.PEER_FAILED):x}"]
        assert len(names) == 3, names
        for name, reason in zip(names, want):
            assert name.endswith(f"_{reason}.json"), (name, reason)
        for p in tr.dump_paths:
            with open(p) as f:
                assert isinstance(json.load(f)["traceEvents"], list)
    finally:
        tr.clear()
        tr.enabled, tr.dump_dir, tr.max_dumps = saved
        for a in cw:
            a.deinit()


def test_health_rows_match_reference():
    class Pool:
        bufs = [0] * 6
        hwm = 4

        def occupancy(self):
            return 0.5

    class Ex:
        last_stats = {"moves": 3, "max_inflight": 2}

    class Owner:
        pool, executor = Pool(), Ex()

    labels = {"rank": 1, "tier": "device"}
    assert list(pt.health_rows(Owner(), labels)) == list(
        jt.health_rows(Owner(), labels))
    assert list(pt.health_rows(object(), labels)) == []


def test_annotate_and_trace_to(tmp_path):
    """``trace_to`` writes a Chrome trace in which the ``annotate`` range
    appears by name."""
    with pt.trace_to(str(tmp_path)):
        with pt.annotate("accl_region_under_test"):
            torch.ones(64).sum()
    doc = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "accl_region_under_test" in names


def test_profiled_history_feeds_the_tuner(worlds, tmp_path):
    """Records of forced algorithms, through a CSV round trip, train a
    Tuner (``ingest_records``): the reference's offline-history path. An
    AUTO record credits nothing."""
    from accl_tpu_torch import Tuner
    _, cw = worlds

    def fn(a):
        src, dst = _bufs(a, False, [1.0] * N, N)
        a.start_profiling()
        for alg in ("ring", "RECURSIVE_DOUBLING", "ring", "NON_FUSED"):
            a.allreduce(src, dst, N, algorithm=alg)
        a.allreduce(src, dst, N)                      # AUTO: not credited
        a.end_profiling()
        return a.profiler
    prof = run_ranks(cw, fn)[0]
    path = str(tmp_path / "history.csv")
    prof.to_csv(path)
    tuner = Tuner(min_samples=1)
    assert tuner.ingest_records(pt.Profiler.read_csv(path), W) == 4
    entry = {(e["op"], e["world"]): e for e in tuner.entries()}
    assert entry[("allreduce", W)]["samples"] >= 1
    assert entry[("allreduce", W)]["algorithm"] in (
        "RING", "RECURSIVE_DOUBLING", "NON_FUSED")


def _barrier_calls(a):
    a.start_profiling()
    a.barrier()
    a.barrier()
    a.end_profiling()
    return (a.profiler.records, dict(a._call_counts), dict(a._byte_counts))


def test_barrier_accounted_as_allreduce(worlds):
    """A barrier is a 1-element f32 allreduce on a scratch buffer in both
    packages: its ``CallRecord`` and its ``accl_calls_total`` /
    ``accl_bytes_total`` rows read ``allreduce``, call for call and byte
    for byte."""
    tw, cw = worlds
    ref = j_run_ranks(tw, _barrier_calls)
    got = run_ranks(cw, _barrier_calls)
    for r in range(W):
        (jrec, jcalls, jbytes), (prec, pcalls, pbytes) = ref[r], got[r]
        assert sorted(map(_fields, prec)) == sorted(map(_fields, jrec))
        assert {x.op for x in prec} == {"allreduce"}
        assert [x.count for x in prec] == [1, 1]
        assert pcalls == jcalls and pbytes == jbytes
        comm_id = cw[r].comm.comm_id
        assert pcalls == {("allreduce", comm_id): 2}
        text = pt.METRICS.to_prometheus()
        ctx = f'ctx="{cw[r].device.ctx.seq}"'
        rows = [ln for ln in text.splitlines()
                if ln.startswith(("accl_calls_total{", "accl_bytes_total{"))
                and ctx in ln and f'rank="{r}"' in ln]
        assert rows and all('op="allreduce"' in ln for ln in rows)
