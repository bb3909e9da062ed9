"""Tracing and profiling: per-call records, the flight recorder, metrics.

The port of ``accl_tpu/tracing.py``:

* :class:`Profiler` — one :class:`CallRecord` per call, taken when the
  call retires (the handle's done callback), with per-op summaries
  (count, total, mean, p50, p95) and a CSV dump in the reference's
  column order. On this tier a call whose operands live on the card
  retires once its kernels are enqueued, so a record times the host's
  issue-to-enqueue window, not the kernels (ROADMAP §C2).
* :class:`EventTrace` — the flight recorder: per-thread bounded rings of
  structured events, off by default (``ACCL_TPU_TRACE=1`` or
  ``ACCL.start_trace()``), every emit site behind one
  ``if TRACE.enabled:`` test. Exports Chrome/Perfetto trace-event JSON
  and dumps the ring on a failure trigger (:meth:`EventTrace.trigger_dump`).
* :class:`MetricsRegistry` — process-wide counters, gauges and
  histograms with labels, plus weakly held collectors polled at
  snapshot time; Prometheus text exposition.
* :func:`annotate` and :func:`trace_to` — a named range on the
  ``torch.profiler`` timeline (and an NVTX range when CUDA is present),
  and a ``torch.profiler`` capture exported as a Chrome trace.
* :func:`measure_call_latency` — the ``nop`` latency probe.

The process-wide singletons are ``TRACE`` and ``METRICS``.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import dataclasses
import itertools
import json
import os
import tempfile
import threading
import time
import weakref

__all__ = [
    "CallRecord", "Profiler", "ProfilerSummary", "EventTrace",
    "MetricsRegistry", "TRACE", "METRICS", "annotate", "trace_to",
    "health_rows", "measure_call_latency",
]


@dataclasses.dataclass
class CallRecord:
    """One retired call. The pipelined-executor and plan-cache fields are
    the reference's; this tier has neither, so they stay 0 or ""."""

    op: str                 # scenario name (allreduce, send, ...)
    count: int              # elements
    nbytes: int             # uncompressed payload bytes (count * elem size)
    comm_id: int
    t_start: float          # perf_counter seconds, host-side issue time
    duration_s: float       # issue -> retire
    error_word: int = 0
    algorithm: str = ""     # the CollectiveAlgorithm name the call ran
    #                         where the driver knows it, "AUTO" where the
    #                         backend resolved it, "" for ops without an
    #                         algorithm axis
    moves: int = 0
    pipelined_moves: int = 0
    pipeline_depth: int = 0
    combine_overlap: int = 0
    expand_us: float = 0.0
    plan_us: float = 0.0
    plan_cache: str = ""
    lanes: int = 0
    overlap_frac: float = 0.0
    tenant: str = ""        # the driver's tenant, else "comm-<id>"
    # the tag of the logical call this one is a phase of (a hierarchical
    # program, a redistribute); the logical record carries the same tag
    parent: str = ""

    @property
    def duration_us(self) -> float:
        return self.duration_s * 1e6


@dataclasses.dataclass
class ProfilerSummary:
    """Aggregate statistics for one op."""

    op: str
    n: int
    total_us: float
    mean_us: float
    p50_us: float
    p95_us: float
    min_us: float
    max_us: float
    total_bytes: int

    @property
    def mean_gbps(self) -> float:
        """Payload bytes over time in call, GB/s."""
        if self.total_us == 0:
            return 0.0
        return self.total_bytes / (self.total_us * 1e-6) / 1e9


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


_CSV_COLUMNS = ("op,count,nbytes,comm_id,t_start,duration_us,error,"
                "algorithm,moves,pipelined_moves,pipeline_depth,"
                "combine_overlap,expand_us,plan_us,plan_cache,"
                "lanes,overlap_frac,tenant,parent")


class Profiler:
    """Thread-safe per-call timing recorder, fed by the driver's done
    callbacks while armed (``ACCL.start_profiling`` / ``end_profiling``)
    or directly through :meth:`record`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: list[CallRecord] = []
        self.enabled = False

    def start(self):
        self.enabled = True

    def stop(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            self._records.clear()

    def record(self, rec: CallRecord):
        """Append one record if the profiler is armed now: a call that
        retires after ``stop()`` is dropped, whenever it was issued."""
        if not self.enabled:
            return
        with self._lock:
            self._records.append(rec)

    def attach(self, handle, op: str, count: int, nbytes: int, comm_id: int,
               t0: float | None = None, algorithm: str = "",
               tenant: str = "", parent: str = ""):
        """Record the call of ``handle`` when it retires, timed from ``t0``
        (taken before dispatch) to the done callback."""
        if t0 is None:
            t0 = time.perf_counter()

        def _on_done(error_word: int):
            self.record(CallRecord(
                op=op, count=count, nbytes=nbytes, comm_id=comm_id,
                t_start=t0, duration_s=time.perf_counter() - t0,
                error_word=error_word, algorithm=algorithm,
                tenant=tenant, parent=parent))

        handle.add_done_callback(_on_done)

    @property
    def records(self) -> list[CallRecord]:
        with self._lock:
            return list(self._records)

    def summary(self) -> dict[str, ProfilerSummary]:
        by_op: dict[str, list[CallRecord]] = {}
        for r in self.records:
            by_op.setdefault(r.op, []).append(r)
        out = {}
        for op, recs in sorted(by_op.items()):
            durs = sorted(r.duration_us for r in recs)
            out[op] = ProfilerSummary(
                op=op, n=len(recs), total_us=sum(durs),
                mean_us=sum(durs) / len(durs),
                p50_us=_percentile(durs, 0.50),
                p95_us=_percentile(durs, 0.95),
                min_us=durs[0], max_us=durs[-1],
                total_bytes=sum(r.nbytes for r in recs))
        return out

    def table(self) -> str:
        rows = [f"{'op':<16}{'n':>6}{'mean_us':>12}{'p50_us':>12}"
                f"{'p95_us':>12}{'GB/s':>10}"]
        for s in self.summary().values():
            rows.append(f"{s.op:<16}{s.n:>6}{s.mean_us:>12.2f}"
                        f"{s.p50_us:>12.2f}{s.p95_us:>12.2f}"
                        f"{s.mean_gbps:>10.3f}")
        return "\n".join(rows)

    def to_csv(self, path: str):
        """One row per retired call, the reference's columns."""
        with open(path, "w") as f:
            f.write(_CSV_COLUMNS + "\n")
            for r in self.records:
                f.write(f"{r.op},{r.count},{r.nbytes},{r.comm_id},"
                        f"{r.t_start:.9f},{r.duration_us:.3f},"
                        f"{r.error_word},{r.algorithm},{r.moves},"
                        f"{r.pipelined_moves},{r.pipeline_depth},"
                        f"{r.combine_overlap},{r.expand_us:.1f},"
                        f"{r.plan_us:.1f},{r.plan_cache},"
                        f"{r.lanes},{r.overlap_frac:.4f},{r.tenant},"
                        f"{r.parent}\n")

    @staticmethod
    def read_csv(path: str) -> list[CallRecord]:
        """Parse a :meth:`to_csv` dump back into records; a dump without
        the later columns reads them as empty or zero."""
        out = []
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                out.append(CallRecord(
                    op=row["op"], count=int(row["count"]),
                    nbytes=int(row["nbytes"]),
                    comm_id=int(row["comm_id"]),
                    t_start=float(row["t_start"]),
                    duration_s=float(row["duration_us"]) * 1e-6,
                    error_word=int(row["error"]),
                    algorithm=row.get("algorithm") or "",
                    moves=int(row.get("moves") or 0),
                    pipelined_moves=int(row.get("pipelined_moves") or 0),
                    pipeline_depth=int(row.get("pipeline_depth") or 0),
                    combine_overlap=int(row.get("combine_overlap") or 0),
                    expand_us=float(row.get("expand_us") or 0.0),
                    plan_us=float(row.get("plan_us") or 0.0),
                    plan_cache=row.get("plan_cache") or "",
                    lanes=int(row.get("lanes") or 0),
                    overlap_frac=float(row.get("overlap_frac") or 0.0),
                    tenant=row.get("tenant") or "",
                    parent=row.get("parent") or ""))
        return out


# -- flight recorder ---------------------------------------------------------
#
# An event is a plain tuple (one clock read and a deque append an emit):
#   (t_ns, dur_ns, stage, rank, call_seq, lane, step, seqn, peer, nbytes,
#    thread_name, tenant)
_EV_FIELDS = ("t_ns", "dur_ns", "stage", "rank", "call_seq", "lane",
              "step", "seqn", "peer", "nbytes", "thread", "tenant")

# the stages combine time can hide behind
_WIRE_STAGES = frozenset({"recv", "relay", "egress", "cut_through"})


class EventTrace:
    """Bounded per-thread-ring flight recorder with Chrome-trace export.

    ``ACCL_TPU_TRACE=1`` arms the process-wide instance (``TRACE``) at
    import (``ACCL_TPU_TRACE_EVENTS`` sizes each ring,
    ``ACCL_TPU_TRACE_DUMP_DIR`` and ``ACCL_TPU_TRACE_MAX_DUMPS`` steer
    :meth:`trigger_dump`); :meth:`start` / :meth:`stop` toggle it at run
    time. Each emitting thread appends to its own
    ``deque(maxlen=capacity)`` without a lock, the oldest event dropping
    when full; rings register once and outlive their threads, so a
    finished worker's tail still exports."""

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            capacity = int(os.environ.get("ACCL_TPU_TRACE_EVENTS", 65536))
        self.capacity = max(256, int(capacity))
        self.enabled = os.environ.get("ACCL_TPU_TRACE", "").lower() in (
            "1", "true", "on", "yes")
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._buffers: list[tuple[threading.Thread, collections.deque]] = []
        self._call_seq = itertools.count(1)
        self.dump_dir = os.environ.get("ACCL_TPU_TRACE_DUMP_DIR") or ""
        self.max_dumps = int(os.environ.get("ACCL_TPU_TRACE_MAX_DUMPS", 4))
        self._dumps = 0
        self.dump_paths: list[str] = []

    def start(self):
        # each arming gets its own dump budget
        self._dumps = 0
        self.enabled = True

    def stop(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            # dead threads' rings can take no new event: drop them
            self._buffers = [(t, b) for t, b in self._buffers
                             if t.is_alive()]
            for _, buf in self._buffers:
                buf.clear()
            self._dumps = 0
            self.dump_paths.clear()

    def next_call_seq(self) -> int:
        """A process-unique call sequence number (``itertools.count``:
        rank threads draw concurrently)."""
        return next(self._call_seq)

    def _buffer(self) -> collections.deque:
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = collections.deque(maxlen=self.capacity)
            self._tls.buf = buf
            with self._lock:
                if len(self._buffers) >= 256:
                    # bound the table under thread churn: dead threads'
                    # rings go
                    self._buffers = [(t, b) for t, b in self._buffers
                                     if t.is_alive()]
                self._buffers.append((threading.current_thread(), buf))
        return buf

    def emit(self, stage: str, *, rank: int = -1, call_seq: int = 0,
             lane: int = -1, step: int = -1, seqn: int = -1,
             peer: int = -1, nbytes: int = 0, t_ns: int | None = None,
             dur_ns: int = 0, tenant: str = ""):
        """Record one event starting at ``t_ns`` (monotonic ns, now when
        omitted) and lasting ``dur_ns``. Callers test ``enabled`` first;
        the test here only covers a disarm race."""
        if not self.enabled:
            return
        if t_ns is None:
            t_ns = time.monotonic_ns()
        self._buffer().append(
            (t_ns, dur_ns, stage, rank, call_seq, lane, step, seqn, peer,
             nbytes, threading.current_thread().name, tenant))

    def events(self) -> list[dict]:
        """Every thread's ring merged and sorted by time, as dicts."""
        with self._lock:
            rings = [buf for _, buf in self._buffers]
        raw = [ev for buf in rings for ev in list(buf)]
        raw.sort(key=lambda e: e[0])
        return [dict(zip(_EV_FIELDS, ev)) for ev in raw]

    def export_chrome(self, path: str, events: list[dict] | None = None
                      ) -> int:
        """Write Chrome/Perfetto trace-event JSON: one process per rank,
        one track per lane (an unlaned event tracks under its thread),
        tenant-prefixed where attributed. Returns the events written."""
        evs = self.events() if events is None else events
        t0 = min((e["t_ns"] for e in evs), default=0)
        tids: dict[tuple[int, str], int] = {}
        out: list[dict] = []
        for e in evs:
            pid = e["rank"] if e["rank"] >= 0 else 0
            label = (f"lane {e['lane']}" if e["lane"] >= 0
                     else str(e["thread"]))
            tenant = e.get("tenant", "")
            if tenant:
                label = f"{tenant} {label}"
            key = (pid, label)
            tid = tids.get(key)
            if tid is None:
                tid = tids[key] = len(tids) + 1
                out.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": tid, "args": {"name": label}})
            args = {k: e[k] for k in ("call_seq", "step", "seqn", "peer",
                                      "nbytes") if e[k] not in (-1,)}
            args["thread"] = e["thread"]
            if tenant:
                args["tenant"] = tenant
            out.append({"ph": "X", "name": e["stage"], "cat": "accl_tpu",
                        "pid": pid, "tid": tid,
                        "ts": (e["t_ns"] - t0) / 1e3,
                        "dur": e["dur_ns"] / 1e3, "args": args})
        for pid in sorted({e["rank"] if e["rank"] >= 0 else 0
                           for e in evs}):
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": f"rank {pid}"}})
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)
        return len(evs)

    def overlap_frac(self, call_seq: int) -> float | None:
        """The fraction of one call's combine time that lies under the
        union of its wire intervals (recv/relay/egress/cut_through, each
        widened to its frame's ``wire_send``/``ingest`` instants matched
        by (receiver, sender, seqn)). None when the rings hold no combine
        event of the call."""
        combine: list[tuple[int, int]] = []
        wire: list[tuple[int, int]] = []
        recvs: list[tuple[tuple[int, int, int], int, int]] = []
        egress: list[tuple[tuple[int, int, int], int, int]] = []
        ingests: dict[tuple[int, int, int], list[int]] = {}
        sends: dict[tuple[int, int, int], list[int]] = {}
        with self._lock:
            rings = [buf for _, buf in self._buffers]
        for buf in [list(b) for b in rings]:
            for ev in buf:
                if ev[2] == "ingest":
                    ingests.setdefault((ev[3], ev[8], ev[7]),
                                       []).append(ev[0])
                    continue
                if ev[2] == "wire_send":
                    sends.setdefault((ev[8], ev[3], ev[7]),
                                     []).append(ev[0])
                    continue
                if ev[4] != call_seq or ev[1] <= 0:
                    continue
                span = (ev[0], ev[0] + ev[1])
                if ev[2] == "combine":
                    combine.append(span)
                elif ev[2] in _WIRE_STAGES:
                    if ev[2] == "recv" and ev[7] >= 0:
                        recvs.append(((ev[3], ev[8], ev[7]),
                                      span[0], span[1]))
                        continue
                    if ev[2] == "egress" and ev[7] >= 0:
                        egress.append(((ev[8], ev[3], ev[7]),
                                       span[0], span[1]))
                        continue
                    wire.append(span)
        if not combine:
            return None
        for key, s, t in recvs:
            for d in (sends, ingests):
                ts = [it for it in d.get(key, ()) if it <= t]
                if ts:
                    s = min(s, max(ts))
            wire.append((s, t))
        for key, s, t in egress:
            ts = [it for it in ingests.get(key, ()) if it >= s]
            if ts:
                t = max(t, min(ts))
            wire.append((s, t))
        wire.sort()
        merged: list[list[int]] = []
        for s, t in wire:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        total = hidden = 0
        for s, t in combine:
            total += t - s
            for ws, wt in merged:
                if wt <= s:
                    continue
                if ws >= t:
                    break
                hidden += min(t, wt) - max(s, ws)
        return hidden / total if total else 0.0

    def trigger_dump(self, reason: str, rank: int = -1) -> str | None:
        """Dump the rings to a Chrome-trace file on a failure trigger, at
        most ``max_dumps`` times an arming; a failed write is skipped.
        Returns the path written, or None."""
        if not self.enabled:
            return None
        with self._lock:
            if self._dumps >= self.max_dumps:
                return None
            self._dumps += 1
            n = self._dumps
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)[:48]
        path = os.path.join(
            self.dump_dir or tempfile.gettempdir(),
            f"accl_tpu_trace_{os.getpid()}_{n}_{safe}.json")
        try:
            nev = self.export_chrome(path)
        except OSError:
            return None
        self.dump_paths.append(path)
        from .log import get_logger
        get_logger("tracing").warning(
            "rank %s: flight recorder dumped %d events to %s (%s)",
            rank if rank >= 0 else "-", nev, path, reason)
        return path


# -- metrics registry --------------------------------------------------------

def health_rows(owner, labels: dict):
    """Collector rows of one rank's execution backend: its rx pool,
    move executor and plan cache, from whichever of them ``owner`` has
    (this tier's device has none of the three, so it yields nothing)."""
    pool = getattr(owner, "pool", None)
    if pool is not None:
        yield ("gauge", "rx_pool_occupancy", labels, pool.occupancy())
        yield ("gauge", "rx_pool_occupancy_hwm", labels, pool.hwm)
        yield ("gauge", "rx_pool_size", labels, len(pool.bufs))
    ex = getattr(owner, "executor", None)
    if ex is not None:
        for k, v in ex.last_stats.items():
            yield ("gauge", f"executor_last_{k}", labels, v)
    cache = getattr(owner, "plan_cache", None)
    if cache is not None and hasattr(cache, "metrics_rows"):
        yield from cache.metrics_rows(labels)


class MetricsRegistry:
    """Counters, gauges and histograms with Prometheus-style labels, plus
    weakly-held *collectors* polled at snapshot time.

    Rare events write directly (:meth:`inc`, :meth:`set_gauge`,
    :meth:`observe`); high-rate sources keep their own cheap counters and
    register a collector that turns them into labeled rows only when a
    snapshot is taken. A collector holds its owner weakly and vanishes
    with it."""

    _HIST_BUCKETS = tuple(4.0 ** k for k in range(0, 10))  # 1..4^9, +Inf

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, list] = {}  # key -> [count, sum, [bucket n]]
        self._collectors: list[tuple[weakref.ref, object]] = []

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))

    # -- direct writes -------------------------------------------------------
    def inc(self, name: str, value: float = 1, **labels):
        key = self._key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

    def set_gauge(self, name: str, value: float, **labels):
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def observe(self, name: str, value: float, **labels):
        """Histogram sample (fixed power-of-4 buckets in the observed
        unit)."""
        key = self._key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = [0, 0.0,
                                        [0] * (len(self._HIST_BUCKETS) + 1)]
            h[0] += 1
            h[1] += value
            for i, edge in enumerate(self._HIST_BUCKETS):
                if value <= edge:
                    h[2][i] += 1
                    break
            else:
                h[2][-1] += 1

    # -- collectors ----------------------------------------------------------
    def register_collector(self, owner, fn):
        """``fn(owner) -> iterable of (kind, name, labels_dict, value)``
        with kind "counter" | "gauge" | "histogram" (histogram value:
        ``[count, sum, bucket-count list]``). ``owner`` is held weakly."""
        with self._lock:
            self._collectors = [(r, f) for r, f in self._collectors
                                if r() is not None]
            self._collectors.append((weakref.ref(owner), fn))

    def _collect(self) -> list[tuple[str, str, dict, float]]:
        with self._lock:
            refs = list(self._collectors)
        rows = []
        for ref, fn in refs:
            owner = ref()
            if owner is None:
                continue
            try:
                rows.extend(fn(owner))
            except Exception:  # noqa: BLE001 — a dying world's collector
                # must not take the whole snapshot down with it
                continue
        return rows

    # -- reporting -----------------------------------------------------------
    @staticmethod
    def _label_str(labels: tuple) -> str:
        return ",".join(f"{k}={v}" for k, v in labels)

    def snapshot(self) -> dict:
        """``{"counters": {name: {"k=v,...": value}}, "gauges": {...},
        "histograms": {name: {labels: {count, sum, buckets}}}}``: direct
        writes merged with every live collector's rows."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: [h[0], h[1], list(h[2])]
                     for k, h in self._hists.items()}
        for kind, name, labels, value in self._collect():
            key = self._key(name, labels)
            if kind == "counter":
                counters[key] = counters.get(key, 0) + value
            elif kind == "histogram":
                h = hists.get(key)
                if h is None:
                    hists[key] = [value[0], value[1], list(value[2])]
                else:
                    h[0] += value[0]
                    h[1] += value[1]
                    h[2] = [a + b for a, b in zip(h[2], value[2])]
            else:
                gauges[key] = value
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for key, v in counters.items():
            out["counters"].setdefault(key[0], {})[
                self._label_str(key[1])] = v
        for key, v in gauges.items():
            out["gauges"].setdefault(key[0], {})[
                self._label_str(key[1])] = v
        for key, (n, s, buckets) in hists.items():
            edges = [*(str(e) for e in self._HIST_BUCKETS), "+Inf"]
            out["histograms"].setdefault(key[0], {})[
                self._label_str(key[1])] = {
                    "count": n, "sum": s,
                    "buckets": dict(zip(edges, buckets))}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition of :meth:`snapshot` (counter and
        gauge families, cumulative histogram buckets)."""
        snap = self.snapshot()
        lines = []

        def fmt(name, labels, value):
            lab = ("{" + ",".join(
                f'{k}="{v}"' for k, v in
                (p.split("=", 1) for p in labels.split(","))) + "}"
                if labels else "")
            lines.append(f"{name}{lab} {value}")

        for kind in ("counters", "gauges"):
            ptype = "counter" if kind == "counters" else "gauge"
            for name in sorted(snap[kind]):
                lines.append(f"# TYPE {name} {ptype}")
                for labels in sorted(snap[kind][name]):
                    fmt(name, labels, snap[kind][name][labels])
        for name in sorted(snap["histograms"]):
            lines.append(f"# TYPE {name} histogram")
            for labels in sorted(snap["histograms"][name]):
                h = snap["histograms"][name][labels]
                cum = 0
                for edge, n in h["buckets"].items():
                    cum += n
                    le = f"le={edge}"
                    lab = f"{labels},{le}" if labels else le
                    fmt(f"{name}_bucket", lab, cum)
                fmt(f"{name}_sum", labels, h["sum"])
                fmt(f"{name}_count", labels, h["count"])
        return "\n".join(lines) + "\n"

    def reset(self):
        """Drop every directly written series; collectors stay
        registered (their sources own their lifetimes)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


# one health surface across every world living in this process
TRACE = EventTrace()
METRICS = MetricsRegistry()


# -- profiler bridges ----------------------------------------------------------

@contextlib.contextmanager
def annotate(name: str):
    """Name a region on the ``torch.profiler`` timeline, and as an NVTX
    range when CUDA is present."""
    import torch
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Capture the enclosed region with ``torch.profiler`` (the CPU, and
    CUDA when present) and write it to ``log_dir`` as a Chrome trace
    (``trace.json``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def measure_call_latency(accl, n: int = 100) -> dict[str, float]:
    """Round-trip latency of the full call path through ``nop``: warm-up,
    then ``n`` timed calls (p50, p95, mean and min in microseconds)."""
    for _ in range(min(n, 10)):
        accl.nop()
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        accl.nop()
        samples.append((time.perf_counter() - t0) * 1e6)
    samples.sort()
    return {
        "n": float(n),
        "p50_us": _percentile(samples, 0.50),
        "p95_us": _percentile(samples, 0.95),
        "mean_us": sum(samples) / len(samples),
        "min_us": samples[0],
    }
