"""Utilities: checkpoint/resume of training state.

The counterpart of ``accl_tpu/utils``. The reference's ``compat`` and
``platform`` modules resolve JAX API drift and ``JAX_PLATFORMS``; the
port has neither, and picks its device with
:func:`~accl_tpu_torch.parallel.mesh.resolve_device`.
"""

from .checkpoint import (CheckpointManager, load_checkpoint,
                         save_checkpoint)

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint"]
