"""accl_tpu_torch: the ACCL collective framework on PyTorch and CUDA.

The port of ``accl_tpu`` (JAX/Pallas on a TPU) to an NVIDIA H100. It
imports torch and numpy, never jax or the JAX package. W virtual ranks
share one device; the collectives (ring and fused dense ops, alltoall,
binomial and 2D-tree rooted ops) run their per-hop work through
hand-written CUDA C++ kernels (``csrc/``): the elementwise combine, the
per-tensor wire lanes (casts and the scaled fp8 codec) and the
block-scaled fp8/int8 wire codec. The local and point-to-point ops
(``copy``, ``combine``, eager ``send`` / ``recv`` on every wire, the
stream ports and ``stream_put``) run through the same kernels. RMA
(``put``, ``get``) is not ported yet. The Llama serving path
(:mod:`.models`: forward, KV-cache prefill and decode, generate) runs its
attention through hand-written kernels too (flash attention forward and
cache decode, :mod:`.ops.attention`). On CPU tensors every kernel
wrapper runs its plain PyTorch version instead.

Layers: driver :class:`ACCL` -> backend :mod:`.device.cuda` ->
dataplane :mod:`.parallel.collectives` -> kernels :mod:`.ops`; model
:mod:`.models` (``Llama``) -> attention kernels :mod:`.ops.attention`.
"""

from .accl import ACCL
from .arith import ArithConfig, DEFAULT_ARITH_CONFIGS, resolve_arith_config
from .buffer import ACCLBuffer
from .call import CallDescriptor, CallHandle, wait_all
from .communicator import Communicator, Rank
from .constants import (ACCLError, CCLOp, CfgFunc, Compression, ErrorCode,
                        ReduceFunc, StreamFlags, TAG_ANY, decode_error)
from .device.cuda import CudaContext, CudaDevice, cuda_world
from .models import Llama, LlamaConfig

__version__ = "0.1.0"

__all__ = [
    "ACCL", "ACCLBuffer", "ACCLError", "ArithConfig", "CallDescriptor",
    "CallHandle", "CCLOp", "CfgFunc", "Communicator", "Compression",
    "CudaContext", "CudaDevice", "DEFAULT_ARITH_CONFIGS", "ErrorCode",
    "Llama", "LlamaConfig",
    "Rank", "ReduceFunc", "StreamFlags", "TAG_ANY", "cuda_world",
    "decode_error", "resolve_arith_config", "wait_all",
]
