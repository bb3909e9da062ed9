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
from ..constants import DEFAULT_MAX_SEGMENT_SIZE


class Device(abc.ABC):
    """One rank's execution backend."""

    # the driver's attached Tuner (ACCL(tuner=) sets it), for a backend
    # that resolves AUTO itself
    tuner = None
    max_segment_size = DEFAULT_MAX_SEGMENT_SIZE

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

    def set_max_segment_size(self, nbytes: int):
        self.max_segment_size = int(nbytes)

    def preferred_segment_size(self) -> int:
        """The segment size the driver sets at bring-up when no tuner
        recommends one."""
        return DEFAULT_MAX_SEGMENT_SIZE

    def topology(self):
        """Link descriptor of this backend's tier for the tuner's cost
        model; a backend overrides it with its own figures. The generic
        default only has to order algorithms sanely."""
        from ..tuner.cost import Topology
        return Topology(world_size=0, alpha_us=50.0, beta_gbps=1.0,
                        tier="generic")

    def auto_resolvable_ops(self):
        """Ops whose AUTO the driver resolves through the tuner before
        issue; None means every op with an algorithm axis."""
        return None

    def adopt_device_tensor(self, t):
        """Accept a live tensor for a device-resident buffer."""
        raise ValueError(f"{type(self).__name__} has no device tensors")

    def make_device_tensor(self, shape, dtype, init=None):
        """Allocate a tensor on this rank's device (zeros, or ``init``)."""
        raise ValueError(f"{type(self).__name__} has no device tensors")

    # -- one-sided RMA windows (accl_tpu_torch/rma) ---------------------------
    def register_window(self, wid: int, addr: int, nbytes: int):
        """Register ``[addr, addr+nbytes)`` as one-sided window ``wid``
        so peers can put/get against it. A backend without RMA refuses
        here, at registration, not later as a timeout."""
        from ..constants import ACCLError, ErrorCode
        raise ACCLError(int(ErrorCode.COLLECTIVE_NOT_IMPLEMENTED),
                        f"{type(self).__name__} has no one-sided RMA")

    def deregister_window(self, wid: int):
        """Remove a window registration (no-op when absent)."""

    def poll_notifications(self, window: int, max_records: int = 64):
        """Drain put-with-notify completion records for ``window``
        (``rma.ANY_WINDOW`` = all). Purely local: no call, no
        collective. A backend without RMA has nothing pending."""
        return []

    # -- elastic membership (ACCL.grow_communicator, ACCL.revoke) -------------
    def join_handshake(self, comm: Communicator, timeout: float) -> int:
        """Bootstrap handshake of a grown communicator: 0 once every
        member agrees, else a typed error word. A single controller holds
        every rank, so membership is a host-side fact and the handshake
        succeeds at once, as on the reference's device tier."""
        return 0

    def abort_comm(self, comm_id: int, err: int):
        """Fail this rank's calls in flight on ``comm_id`` with ``err``
        now, and latch ``err`` for the ones still to run. Default: no-op
        (the driver's revoked-comm check refuses the next call)."""

    def soft_reset(self):
        """Parity: HOUSEKEEP_SWRST."""

    def deinit(self):
        """Release backend resources."""

    def apply_config(self, desc: CallDescriptor) -> int:
        """Shared ACCL_CONFIG dispatch: subfunction in ``tag``, value in
        ``count`` (ms for timeout, bytes for segment size). The
        connection subfunctions succeed as no-ops (an in-process world has
        no ports or sessions), and so do the profiling ones (no profiler
        is attached yet). The segment size is kept (``max_segment_size``)
        and changes nothing: a single-device ring does not segment."""
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
        if fn == CfgFunc.set_max_segment_size:
            self.set_max_segment_size(val)
            return 0
        if fn in (CfgFunc.enable_pkt, CfgFunc.open_port, CfgFunc.open_con,
                  CfgFunc.close_con, CfgFunc.set_stack_type,
                  CfgFunc.start_profiling, CfgFunc.end_profiling):
            return 0
        return int(ErrorCode.INVALID_CALL)
