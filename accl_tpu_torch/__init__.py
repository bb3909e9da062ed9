"""accl_tpu_torch: the ACCL collective framework on PyTorch and CUDA.

The port of ``accl_tpu`` (JAX/Pallas on a TPU) to an NVIDIA H100. It
imports torch and numpy, never jax or the JAX package. W virtual ranks
share one device; the collectives (ring and fused dense ops, alltoall,
binomial and 2D-tree rooted ops) run their per-hop work through
hand-written CUDA C++ kernels (``csrc/``): the elementwise combine, the
per-tensor wire lanes (casts and the scaled fp8 codec) and the
block-scaled fp8/int8 wire codec. The local and point-to-point ops
(``copy``, ``combine``, eager ``send`` / ``recv`` on every wire, the
stream ports and ``stream_put``) run through the same kernels, and so
does one-sided RMA (registered windows, ``put`` with notify, ``get``:
:mod:`.rma`), which carries the serving control plane
(:mod:`.serving`: KV-block placement and continuous batching). The
driver's call contract (``retries=`` / ``retry_policy=``, :mod:`.retry`;
``chain=``) covers every data call; communicators split, shrink, grow
and are revoked; ``alltoallv`` moves uneven chunks and ``redistribute``
changes an array's sharding (:mod:`.hier`), which carry the elastic
decode pool (:mod:`.serving.elastic`) and the host workloads
(:mod:`.workloads`: MoE dispatch and combine, ring attention). A shared
:class:`Tuner` (:mod:`.tuner`) resolves AUTO and ``compress_dtype="auto"``
by size and topology, and ``HIERARCHICAL`` calls lower to phase programs
over per-tier sub-communicators (:mod:`.hier`); ``tuner.sweep`` measures
the tuning table AUTO loads. The driver records its calls
(:mod:`.tracing`: the profiler, the flight recorder, the Prometheus
exposition) and labels them by tenant. Data-parallel training
all-reduces its gradients in buckets (:mod:`.parallel.bucketing`). The
Llama serving path
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
from .retry import RetryPolicy
from .tuner import Topology, Tuner

__version__ = "0.1.0"

__all__ = [
    "ACCL", "ACCLBuffer", "ACCLError", "ArithConfig", "CallDescriptor",
    "CallHandle", "CCLOp", "CfgFunc", "Communicator", "Compression",
    "CudaContext", "CudaDevice", "DEFAULT_ARITH_CONFIGS", "ErrorCode",
    "Llama", "LlamaConfig",
    "Rank", "ReduceFunc", "RetryPolicy", "StreamFlags", "TAG_ANY",
    "Topology", "Tuner", "cuda_world",
    "decode_error", "resolve_arith_config", "wait_all",
]
