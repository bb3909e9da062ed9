"""Workloads with communication issued behind compute.

The port of ``accl_tpu/workloads``. Two workload shapes drive the
driver's async and chained call path with compute between the calls:

* :mod:`.ring_attention`: attention over a ring of ranks, each block's
  K/V rotation (an async send and a chained recv) issued before the
  previous block's fold;
* :mod:`.moe`: expert-parallel MoE, skewed top-1 routing lowered onto
  ``alltoallv`` dispatch and combine (the dispatch leg optionally on the
  block-scaled fp8 wire), in chunks so that chunk c+1's dispatch and
  chunk c's combine are in flight while chunk c's expert runs.

:class:`OverlapMeter` stamps every issued handle at issue and at
completion (a done callback) and adds up the time the workload blocks in
``wait()``: ``overlap_frac`` = 1 - exposed / in flight. On one card the
ranks' launches share the default stream, so this is a host-side
measure: how much of a call's host time the workload did not wait on.

Metric families (:data:`~accl_tpu_torch.tracing.METRICS`):
``workload_overlap_frac`` (gauge), ``workload_steps_total``,
``workload_comm_us_total`` and ``workload_exposed_us_total``
(counters), each labelled by rank and workload.
"""

from __future__ import annotations

import time

from ..tracing import METRICS

__all__ = ["OverlapMeter", "ring_attention", "moe"]


class OverlapMeter:
    """Ledger of issued communication against the time blocked on it.

    ``meter.issue(handle)`` right after an async call;
    ``meter.wait(handle)`` instead of ``handle.wait()``. Completion times
    come from the handle's done callback, so a call that retires during
    compute is credited its true span even when the workload looks at it
    later."""

    def __init__(self):
        self._recs: dict[int, dict] = {}
        self.exposed_s = 0.0

    def issue(self, handle):
        rec = {"t0": time.perf_counter(), "t1": None}
        self._recs[id(handle)] = rec

        def _done(_err, r=rec):
            r["t1"] = time.perf_counter()
        handle.add_done_callback(_done)
        return handle

    def wait(self, handle):
        t0 = time.perf_counter()
        handle.wait()
        dt = time.perf_counter() - t0
        self.exposed_s += dt
        rec = self._recs.get(id(handle))
        if rec is not None and rec["t1"] is None:
            rec["t1"] = time.perf_counter()
        return dt

    @property
    def comm_s(self) -> float:
        now = time.perf_counter()
        return sum((r["t1"] if r["t1"] is not None else now) - r["t0"]
                   for r in self._recs.values())

    @property
    def overlap_frac(self) -> float:
        """1 - exposed / in flight, clamped to [0, 1]; 1.0 when nothing
        was issued."""
        total = self.comm_s
        if total <= 0.0:
            return 1.0
        return max(0.0, min(1.0, 1.0 - self.exposed_s / total))

    def publish(self, rank: int, workload: str, steps: int) -> dict:
        """Write this run's ledger into the metrics registry and return
        the stats dict the workload hands its caller."""
        of = round(self.overlap_frac, 4)
        METRICS.set_gauge("workload_overlap_frac", of, rank=rank,
                          workload=workload)
        METRICS.inc("workload_steps_total", steps, rank=rank,
                    workload=workload)
        METRICS.inc("workload_comm_us_total",
                    round(self.comm_s * 1e6), rank=rank, workload=workload)
        METRICS.inc("workload_exposed_us_total",
                    round(self.exposed_s * 1e6), rank=rank,
                    workload=workload)
        return {"overlap_frac": of, "comm_s": self.comm_s,
                "exposed_s": self.exposed_s, "steps": steps}


from . import moe, ring_attention  # noqa: E402  (public submodules)
