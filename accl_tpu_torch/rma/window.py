"""Registered memory windows: the address namespace of one-sided ops.

The port's copy of ``accl_tpu/rma/window.py``. A window is a
``(window_id -> [addr, addr+nbytes))`` registration on ONE rank; a
peer's put/get names ``(target_rank, window_id, byte offset)`` and the
target resolves it locally. Ids are exchanged at configure time by the
application: :meth:`~accl_tpu_torch.accl.ACCL.register_window` hands them
out from a per-driver counter, so symmetric registration order yields
agreeing ids without a handshake.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref

from ..constants import ACCLError, ErrorCode

# every live registry, weakly (dies with its world): ``sweep_leaked``
# walks it to find windows registered on a registry after its close
_LIVE: "weakref.WeakSet[WindowRegistry]" = weakref.WeakSet()


def sweep_leaked() -> list[str]:
    """Find (and clean) window registrations that outlived their world:
    any CLOSED registry still holding entries (a register after deinit,
    or a close path that forgot to purge). Returns one description per
    leaking registry; leftovers are cleared."""
    leaked: list[str] = []
    for reg in list(_LIVE):
        n = len(reg)
        if reg.closed and n:
            leaked.append(f"{reg.owner or 'registry'}: {n} window(s) "
                          f"registered after close")
            with reg._mu:
                reg._windows.clear()
    return leaked


@dataclasses.dataclass(frozen=True)
class Window:
    wid: int
    addr: int
    nbytes: int


class WindowRegistry:
    """Per-rank window table. Registration happens from the host at
    configure time, resolution on the initiator's worker thread for
    every put/get; a lock-guarded dict keeps both safe. :meth:`close`
    (device deinit) marks the registry dead and purges every
    registration, so a torn-down rank accepts no more peer puts."""

    def __init__(self, owner: str = ""):
        self._mu = threading.Lock()
        self._windows: dict[int, Window] = {}
        self.owner = owner
        self.closed = False
        _LIVE.add(self)

    def register(self, wid: int, addr: int, nbytes: int):
        if nbytes <= 0:
            raise ValueError(f"window {wid}: nbytes must be positive, "
                             f"got {nbytes}")
        with self._mu:
            self._windows[int(wid)] = Window(int(wid), int(addr),
                                             int(nbytes))

    def deregister(self, wid: int):
        with self._mu:
            self._windows.pop(int(wid), None)

    def close(self):
        """Purge every registration and mark the registry dead;
        registrations made after this are what :func:`sweep_leaked`
        reports."""
        with self._mu:
            self._windows.clear()
            self.closed = True

    def get(self, wid: int) -> Window | None:
        with self._mu:
            return self._windows.get(int(wid))

    def resolve(self, wid: int, offset: int, nbytes: int) -> int:
        """Byte address of ``[offset, offset+nbytes)`` inside window
        ``wid``; raises the typed window error when the id is unknown or
        the range falls outside the registration."""
        with self._mu:
            w = self._windows.get(int(wid))
        if w is None:
            raise ACCLError(int(ErrorCode.RMA_WINDOW_ERROR),
                            f"window {wid} not registered")
        if offset < 0 or offset + nbytes > w.nbytes:
            raise ACCLError(
                int(ErrorCode.RMA_WINDOW_ERROR),
                f"range [{offset}, +{nbytes}) outside window {wid} "
                f"({w.nbytes} B)")
        return w.addr + int(offset)

    def __len__(self) -> int:
        with self._mu:
            return len(self._windows)
