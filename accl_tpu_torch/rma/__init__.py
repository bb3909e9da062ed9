"""One-sided RMA: registered memory windows and the put-with-notify
completion queue.

The port's copy of ``accl_tpu/rma``, trimmed to what the device tier
needs: ``window.py`` and ``notify.py``. The reference's ``plan.py`` and
``engine.py`` (eager/rendezvous, RTS/CTS, the rx pool) belong to its
emulated fabric; W ranks on one card move a put's payload with one
device copy (or B2 down and up on a compressed wire), see
:mod:`accl_tpu_torch.device.cuda`.
"""

from .notify import (ANY_WINDOW, DEFAULT_NOTIFY_CAP, NotifyQueue,
                     NotifyRecord)
from .window import Window, WindowRegistry, sweep_leaked

__all__ = [
    "ANY_WINDOW", "DEFAULT_NOTIFY_CAP", "NotifyQueue", "NotifyRecord",
    "Window", "WindowRegistry", "sweep_leaked",
]
