"""Call descriptors and asynchronous call handles.

The descriptor is the reference's 15-word call record as a dataclass;
the handle is a future the backend completes with one error word, and
runs its done callbacks (:meth:`CallHandle.add_done_callback`) before
it wakes its waiters. ``waitfor=`` chaining is preserved: a backend
starts a call only after its dependencies complete.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Sequence

from .constants import (ACCLError, CCLOp, CollectiveAlgorithm, Compression,
                        ErrorCode, ReduceFunc, StreamFlags)


@dataclasses.dataclass
class CallDescriptor:
    """One device call."""

    scenario: CCLOp
    count: int = 0
    comm_id: int = 0
    root_src_dst: int = 0
    function: ReduceFunc = ReduceFunc.SUM
    tag: int = 0
    arithcfg: Any = None                      # resolved ArithConfig
    compression: Compression = Compression.NONE
    stream_flags: StreamFlags = StreamFlags.NO_STREAM
    algorithm: CollectiveAlgorithm = CollectiveAlgorithm.AUTO
    addr_0: Any = None                        # op0 buffer address
    addr_1: Any = None                        # op1 buffer address
    addr_2: Any = None                        # result buffer address
    # caller's ABSOLUTE deadline (time.monotonic() seconds), set by
    # Device.call_sync: a parked rendezvous deposit never outlives it
    deadline: Any = None
    # alltoallv's count vectors: (send_counts, recv_counts), comm.size
    # elements each, in elements of the uncompressed dtype; None for
    # every fixed-count op. ``count`` is max(sum(send), sum(recv)).
    counts: Any = None
    # the cross-call pipelining hint of an async ``chain=True`` call: its
    # buffers are disjoint from the still-draining predecessor's. A
    # backend without cross-call pipelining (this one) ignores it.
    chain: bool = False


class CallHandle:
    """Future-like handle for an async device call. ``wait()`` blocks
    until the call retires and raises :class:`ACCLError` on a nonzero
    error word."""

    def __init__(self, context: str = ""):
        self._done = threading.Event()
        self._error_word = 0
        self._result: Any = None
        self._exception: BaseException | None = None
        self._callbacks: list = []
        self._cb_lock = threading.Lock()
        self.context = context

    def complete(self, error_word: int = 0, result: Any = None,
                 exception: BaseException | None = None):
        self._error_word = int(error_word)
        self._result = result
        self._exception = exception
        # callbacks run BEFORE the waiters wake: a thread returning from
        # wait() sees every callback's effect
        with self._cb_lock:
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb(self._error_word)
            except Exception:  # noqa: BLE001 - a raising observer must
                pass           # not fail the backend's completion
        self._done.set()

    def add_done_callback(self, fn):
        """Call ``fn(error_word)`` when the call retires (at once when it
        already has)."""
        with self._cb_lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        try:
            fn(self._error_word)
        except Exception:  # noqa: BLE001
            pass

    def wait(self, timeout: float | None = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError(f"call {self.context or ''} did not complete "
                               f"within {timeout}s")
        if self._error_word != int(ErrorCode.COLLECTIVE_OP_SUCCESS):
            raise ACCLError(self._error_word, self.context) from self._exception
        return self._result

    def done(self) -> bool:
        return self._done.is_set()

    @property
    def error_word(self) -> int:
        return self._error_word


class _AlwaysSet:
    """Event stand-in for already-retired handles."""

    @staticmethod
    def wait(timeout=None) -> bool:
        return True

    @staticmethod
    def is_set() -> bool:
        return True


_ALWAYS_SET = _AlwaysSet()
_SHARED_CB_LOCK = threading.Lock()  # uncontended: callbacks of retired
#                                     handles run at once


class CompletedHandle(CallHandle):
    """A handle for synchronously-executed calls (already retired)."""

    def __init__(self, error_word: int = 0, result: Any = None,
                 context: str = ""):
        self._done = _ALWAYS_SET
        self._error_word = int(error_word)
        self._result = result
        self._exception = None
        self._callbacks: list = []
        self._cb_lock = _SHARED_CB_LOCK
        self.context = context


def wait_all(handles: Sequence[CallHandle], timeout: float | None = None):
    """Wait on a set of handles; first error wins."""
    return [h.wait(timeout) for h in handles]
