"""Call descriptors and asynchronous call handles.

The descriptor is the reference's 15-word call record as a dataclass;
the handle is a future the backend completes with one error word.
``waitfor=`` chaining is preserved: a backend starts a call only after
its dependencies complete.
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


class CallHandle:
    """Future-like handle for an async device call. ``wait()`` blocks
    until the call retires and raises :class:`ACCLError` on a nonzero
    error word."""

    def __init__(self, context: str = ""):
        self._done = threading.Event()
        self._error_word = 0
        self._result: Any = None
        self._exception: BaseException | None = None
        self.context = context

    def complete(self, error_word: int = 0, result: Any = None,
                 exception: BaseException | None = None):
        self._error_word = int(error_word)
        self._result = result
        self._exception = exception
        self._done.set()

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


class CompletedHandle(CallHandle):
    """A handle for synchronously-executed calls (already retired)."""

    def __init__(self, error_word: int = 0, result: Any = None,
                 context: str = ""):
        self._done = _ALWAYS_SET
        self._error_word = int(error_word)
        self._result = result
        self._exception = None
        self.context = context


def wait_all(handles: Sequence[CallHandle], timeout: float | None = None):
    """Wait on a set of handles; first error wins."""
    return [h.wait(timeout) for h in handles]
