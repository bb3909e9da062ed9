"""Request-level serving control plane on top of RMA.

The port's copy of ``accl_tpu/serving``. RMA gives serving its
dataplane verbs: registered windows, put/get and put-with-notify
(:mod:`accl_tpu_torch.rma`). This package adds the control plane a
disaggregated prefill/decode deployment needs on top of them:

* :class:`KVBlockManager` (kvcache.py): fixed-size KV-block placement
  and eviction over the decode ranks' registered windows, with
  ref-counted prefix sharing keyed by token-prefix hash: a shared
  prompt's blocks cross the wire once, every later request's hit is
  ZERO wire bytes, and eviction is LRU over refcount-0 blocks only.
* :class:`ContinuousBatcher` (batcher.py): per-step request admission
  and retirement against an in-flight token budget; the decode batch is
  rebuilt every step.

Both are host-side and transport-free: they decide what moves and the
caller executes the puts. The reference's ``elastic.py`` (decode-pool
resharding) is not ported yet.
"""

from .batcher import ContinuousBatcher, Request
from .kvcache import BlockRef, KVBlockManager, prefix_hashes

__all__ = [
    "KVBlockManager", "BlockRef", "prefix_hashes",
    "ContinuousBatcher", "Request",
]
