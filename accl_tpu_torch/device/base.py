"""Abstract device backend interface: the surface the ACCL driver talks
to. Buffers and call descriptors are the currency."""

from __future__ import annotations

import abc
import dataclasses
import threading
import time
from typing import Sequence

from ..buffer import ACCLBuffer
from ..call import CallDescriptor, CallHandle
from ..communicator import Communicator


class Device(abc.ABC):
    """One rank's execution backend."""

    # -- shared inline fast-path gate ---------------------------------------
    # A backend that can retire a call in the caller's thread guards the
    # path with one counter: >0 means calls are queued or running on the
    # worker, so running inline now would break per-rank FIFO order.

    def __init__(self):
        self._inline_mu = threading.Lock()
        self._inline_inflight = 0

    def _inline_begin(self, waitfor: Sequence[CallHandle]) -> bool:
        """True iff the device is idle and every dependency retired —
        the caller may run inline and MUST call :meth:`_inflight_done`
        when finished."""
        if not all(dep.done() for dep in waitfor):
            return False
        with self._inline_mu:
            if self._inline_inflight != 0:
                return False
            self._inline_inflight += 1
            return True

    def _inflight_add(self):
        with self._inline_mu:
            self._inline_inflight += 1

    def _inflight_done(self):
        with self._inline_mu:
            self._inline_inflight -= 1

    @abc.abstractmethod
    def register_buffer(self, buf: ACCLBuffer): ...

    @abc.abstractmethod
    def deregister_buffer(self, buf: ACCLBuffer): ...

    @abc.abstractmethod
    def call_async(self, desc: CallDescriptor,
                   waitfor: Sequence[CallHandle] = (), *,
                   inline_ok: bool = False) -> CallHandle:
        """Submit a call; returns its handle. ``inline_ok``: the caller
        will block on the handle at once, so the backend MAY retire the
        call in the calling thread."""

    def call_sync(self, desc: CallDescriptor,
                  waitfor: Sequence[CallHandle] = (),
                  timeout: float | None = None):
        if timeout is not None:
            # the caller's bound becomes an ABSOLUTE deadline, so a
            # TimeoutError here implies the call will not run later
            desc = dataclasses.replace(
                desc, deadline=time.monotonic() + timeout)
        return self.call_async(desc, waitfor,
                               inline_ok=timeout is None).wait(timeout)

    @abc.abstractmethod
    def configure_communicator(self, comm: Communicator): ...

    @abc.abstractmethod
    def set_timeout(self, timeout: float): ...

    def adopt_device_tensor(self, t):
        """Accept a live tensor for a device-resident buffer."""
        raise ValueError(f"{type(self).__name__} has no device tensors")

    def make_device_tensor(self, shape, dtype, init=None):
        """Allocate a tensor on this rank's device (zeros, or ``init``)."""
        raise ValueError(f"{type(self).__name__} has no device tensors")

    def soft_reset(self):
        """Parity: HOUSEKEEP_SWRST."""

    def deinit(self):
        """Release backend resources."""

    def apply_config(self, desc: CallDescriptor) -> int:
        """Shared ACCL_CONFIG dispatch: subfunction in ``tag``, value in
        ``count`` (ms for timeout). The connection subfunctions succeed
        as no-ops (an in-process world has no ports or sessions), and so
        do segment size (a single-device ring does not segment) and the
        profiling ones (no profiler is attached yet)."""
        from ..constants import CfgFunc, ErrorCode
        try:
            fn = CfgFunc(desc.tag)
        except ValueError:
            return int(ErrorCode.INVALID_CALL)
        val = int(desc.count)
        if fn == CfgFunc.reset_periph:
            self.soft_reset()
            return 0
        if fn == CfgFunc.set_timeout:
            self.set_timeout(val / 1000.0)
            return 0
        if fn in (CfgFunc.enable_pkt, CfgFunc.open_port, CfgFunc.open_con,
                  CfgFunc.close_con, CfgFunc.set_stack_type,
                  CfgFunc.set_max_segment_size, CfgFunc.start_profiling,
                  CfgFunc.end_profiling):
            return 0
        return int(ErrorCode.INVALID_CALL)
