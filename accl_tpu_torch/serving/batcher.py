"""Continuous batching: per-step admission against in-flight budgets.

The port's copy of ``accl_tpu/serving/batcher.py`` (pure host code).

A static batcher drains the whole batch before admitting the next one —
tail requests hold the batch hostage and fresh arrivals wait a full
generation. This batcher rebuilds the decode batch EVERY step:

* retire requests that produced their last token (release their KV
  references immediately — their blocks become shareable/evictable
  before the step's collective even lands);
* admit pending requests while the in-flight token budget and batch
  cap allow, acquiring their KV blocks (prefix hits cost zero wire
  bytes) and reporting the misses the caller must transfer;
* the surviving + admitted set is the step's batch — no drain barrier
  anywhere.

KV admission failures (``MemoryError`` from the block manager — every
arena full of in-use blocks) defer the request, exactly like rx-pool
backpressure defers a collective; it retries next step after
retirements freed references.

The batcher is transport-free: the caller runs the decode steps and
the KV puts.

TTFT (time-to-first-token) is recorded per request at the end of its
first decode step — admission wait plus one step, the serving gate's
p99 metric.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

from ..tracing import METRICS

__all__ = ["Request", "ContinuousBatcher"]


@dataclasses.dataclass
class Request:
    """One serving request's lifecycle record."""

    rid: int
    prompt_tokens: int            # tokens in the (prefilled) prompt
    decode_tokens: int            # tokens to produce before retiring
    prefix_hashes: tuple = ()     # KV block hash chain (kvcache.py)
    # -- filled in by the batcher -----------------------------------------
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    kv_rank: int = -1             # placement rank from the block manager
    remaining: int = 0
    decoded: int = 0

    @property
    def tokens_in_flight(self) -> int:
        """Budget footprint: prompt KV plus tokens decoded so far."""
        return self.prompt_tokens + self.decoded

    @property
    def ttft_s(self) -> float:
        return (self.t_first_token - self.t_submit
                if self.t_first_token else 0.0)


class ContinuousBatcher:
    """Admission/retirement loop over a decode pool.

    Args:
        kv: the :class:`~accl_tpu_torch.serving.KVBlockManager` (None = no KV
            accounting — pure batching).
        max_inflight_tokens: budget over every active request's
            ``tokens_in_flight``; admission stops (not the batch) when
            the next request would exceed it.
        max_batch: hard cap on active requests per step.
        name: metrics label.
    """

    def __init__(self, kv=None, max_inflight_tokens: int = 1 << 16,
                 max_batch: int = 64, name: str = "serving"):
        self.kv = kv
        self.max_inflight_tokens = int(max_inflight_tokens)
        self.max_batch = int(max_batch)
        self.name = name
        self._mu = threading.Lock()
        self._pending: deque[Request] = deque()
        self._active: list[Request] = []
        self._done: list[Request] = []
        self.admitted_total = 0
        self.retired_total = 0
        self.deferred_total = 0
        METRICS.register_collector(self, ContinuousBatcher._metrics_rows)

    # -- intake ------------------------------------------------------------
    def submit(self, req: Request, now: float | None = None):
        req.t_submit = time.monotonic() if now is None else now
        req.remaining = req.decode_tokens
        with self._mu:
            self._pending.append(req)

    # -- the per-step loop -------------------------------------------------
    def step_begin(self, now: float | None = None
                   ) -> tuple[list[Request], list]:
        """Rebuild the batch for one decode step. Returns ``(batch,
        kv_misses)``: the active requests this step decodes, and the
        fresh :class:`~accl_tpu_torch.serving.BlockRef` list newly admitted
        requests need transferred (one put-with-notify each) BEFORE the
        step's collective may touch their KV."""
        now = time.monotonic() if now is None else now
        misses: list = []
        with self._mu:
            inflight = sum(r.tokens_in_flight for r in self._active)
            # admit in arrival order; stop at the first request that
            # does not fit (FIFO fairness — no size-based overtaking)
            while self._pending and len(self._active) < self.max_batch:
                req = self._pending[0]
                if inflight + req.tokens_in_flight > \
                        self.max_inflight_tokens:
                    break
                if self.kv is not None and req.prefix_hashes:
                    try:
                        rank, _hits, mm = self.kv.acquire(
                            req.prefix_hashes)
                    except MemoryError:
                        # KV backpressure: defer — retirements this
                        # step free references, retry next step
                        self.deferred_total += 1
                        break
                    req.kv_rank = rank
                    misses.extend(mm)
                self._pending.popleft()
                req.t_admit = now
                inflight += req.tokens_in_flight
                self._active.append(req)
                self.admitted_total += 1
            return list(self._active), misses

    def step_end(self, now: float | None = None) -> list[Request]:
        """Account one completed decode step: every active request
        produced one token; requests that hit their budget retire (KV
        released NOW — their blocks are shareable before the next
        step). Returns the retired requests."""
        now = time.monotonic() if now is None else now
        retired: list[Request] = []
        with self._mu:
            keep: list[Request] = []
            for r in self._active:
                r.decoded += 1
                r.remaining -= 1
                if r.decoded == 1:
                    r.t_first_token = now
                if r.remaining <= 0:
                    r.t_done = now
                    retired.append(r)
                else:
                    keep.append(r)
            self._active = keep
            self._done.extend(retired)
            self.retired_total += len(retired)
        for r in retired:
            if self.kv is not None and r.prefix_hashes \
                    and r.kv_rank >= 0:
                self.kv.release(r.prefix_hashes, r.kv_rank)
        return retired

    # -- introspection -----------------------------------------------------
    def active(self) -> list[Request]:
        with self._mu:
            return list(self._active)

    def pending_count(self) -> int:
        with self._mu:
            return len(self._pending)

    def done(self) -> list[Request]:
        with self._mu:
            return list(self._done)

    def drain_done(self) -> list[Request]:
        with self._mu:
            out, self._done = self._done, []
            return out

    def requeue(self, req: Request):
        """Put a previously admitted request back at the head of the
        pending queue (decode-rank failure: its KV placement died; it
        re-acquires on a surviving rank at the next step)."""
        with self._mu:
            self._active = [r for r in self._active
                            if r.rid != req.rid]
            req.kv_rank = -1
            req.decoded = 0
            req.remaining = req.decode_tokens
            req.t_first_token = 0.0
            self._pending.appendleft(req)

    # -- observability: the serving_* family ---------------------------------
    def _metrics_rows(self):
        labels = {"pool": self.name}
        with self._mu:
            batch = len(self._active)
            queued = len(self._pending)
            inflight = sum(r.tokens_in_flight for r in self._active)
        yield ("counter", "serving_admitted_total", labels,
               self.admitted_total)
        yield ("counter", "serving_retired_total", labels,
               self.retired_total)
        yield ("counter", "serving_deferred_total", labels,
               self.deferred_total)
        yield ("gauge", "serving_batch_size", labels, batch)
        yield ("gauge", "serving_queue_depth", labels, queued)
        yield ("gauge", "serving_inflight_tokens", labels, inflight)
