"""Put-with-notify completion queue: the serving control plane's "which
requests' KV arrived" primitive.

The port's copy of ``accl_tpu/rma/notify.py``. A put carrying a notify
token (``ACCL.put(..., notify=token)``) makes the TARGET enqueue one
:class:`NotifyRecord` on its rank-local queue once the transfer has
landed in the window, or a typed-error record when it fails there
(unknown window, out-of-range offset). Discovery is then one local
dequeue (:meth:`NotifyQueue.poll`): no collective, no matching receive.

Bounded: past ``cap`` records a window's OLDEST record is dropped and
counted (``dropped``), so a serving loop that stops polling loses
notifications instead of growing without bound.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque

DEFAULT_NOTIFY_CAP = 4096
ANY_WINDOW = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class NotifyRecord:
    """One completed (or typed-failed) inbound put-with-notify."""

    token: int    # initiator-chosen request token (u64)
    window: int   # target window id the put addressed
    src: int      # initiator's global rank
    err: int      # 0 = landed clean; typed error word otherwise
    offset: int   # byte offset inside the window
    nbytes: int   # uncompressed bytes landed (0 on error)


class NotifyQueue:
    """Per-rank completion queue, partitioned by window id. ``push`` runs
    on the initiator's worker thread, ``poll`` on the target's serving
    loop; one lock."""

    def __init__(self, cap: int = DEFAULT_NOTIFY_CAP):
        self._mu = threading.Lock()
        self._qs: dict[int, deque] = {}
        self.cap = int(cap)
        self.dropped = 0
        self.enqueued = 0
        self.polled = 0

    def push(self, rec: NotifyRecord):
        with self._mu:
            q = self._qs.get(rec.window)
            if q is None:
                q = self._qs[rec.window] = deque()
            if len(q) >= self.cap:
                q.popleft()
                self.dropped += 1
            q.append(rec)
            self.enqueued += 1

    def poll(self, window: int = ANY_WINDOW,
             max_records: int = 64) -> list[NotifyRecord]:
        """Dequeue up to ``max_records`` completions for ``window``
        (ANY_WINDOW drains round-robin across windows, so one hot window
        cannot starve the rest). Purely local."""
        out: list[NotifyRecord] = []
        n = max(0, int(max_records))
        with self._mu:
            if window != ANY_WINDOW:
                q = self._qs.get(int(window))
                while q and len(out) < n:
                    out.append(q.popleft())
            else:
                live = [q for q in self._qs.values() if q]
                while live and len(out) < n:
                    nxt = []
                    for q in live:
                        if q and len(out) < n:
                            out.append(q.popleft())
                        if q:
                            nxt.append(q)
                    live = nxt
            self.polled += len(out)
        return out

    def pending(self, window: int = ANY_WINDOW) -> int:
        with self._mu:
            if window != ANY_WINDOW:
                q = self._qs.get(int(window))
                return len(q) if q else 0
            return sum(len(q) for q in self._qs.values())

    def clear(self):
        with self._mu:
            self._qs.clear()
