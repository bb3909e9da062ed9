"""The ACCL driver: the user-facing host API.

The port of ``accl_tpu/accl.py``: buffers, the collectives
(``allreduce`` / ``reduce_scatter`` / ``allgather`` / ``alltoall``, the
rooted ``bcast`` / ``scatter`` / ``gather`` / ``reduce``, ``barrier``),
the local ops ``copy`` and ``combine``, point to point ``send`` and
``recv``, the stream ports (``stream_push``, ``stream_pop``, the
remote-stream ``stream_put`` and ``stream_flags`` on the local and p2p
ops), ``nop`` and ``soft_reset``, with the reference's dtype resolution
and wire-compression flags. ``compress_dtype`` names the wire dtype: f16,
bf16 and fp8 ride the per-tensor lanes; with ``block_scale`` an int8/fp8
wire is block-scale quantized (``block_scale=True`` means
``quant.DEFAULT_BLOCK`` — there is no tuner yet — an int is clamped into
the legal envelope), on the ring-shaped collectives and on send/recv;
the other collectives then take the full-precision wire, as the
reference does. One-sided RMA: ``register_window``, ``deregister_window``,
``put`` (with ``notify=``), ``get`` and ``poll_notifications``. Every call
but ``config`` is counted per (op, communicator) in ``accl_calls_total``
and ``accl_bytes_total`` (:meth:`ACCL.metrics_snapshot`). Not here yet:
the tuner, the hierarchy, communicator splits and retry policies.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np
import torch

from . import quant
from .arith import dtype_name, resolve_arith_config, to_torch_dtype
from .buffer import ACCLBuffer
from .call import CallDescriptor, CallHandle, CompletedHandle
from .communicator import Communicator
from .constants import (CCLOp, CfgFunc, CollectiveAlgorithm, Compression,
                        ReduceFunc, StreamFlags, TAG_ANY)
from .device.base import Device
from .rma import ANY_WINDOW
from .tracing import METRICS


def _check_block_scaled(cfg, compression: Compression,
                        stream_flags: StreamFlags) -> None:
    """The reference's checks of a block-scaled descriptor
    (``accl_tpu/moveengine.py`` ``expand_call``), with its messages."""
    if compression & (Compression.OP0_COMPRESSED | Compression.OP1_COMPRESSED
                      | Compression.RES_COMPRESSED):
        raise ValueError(
            "BLOCK_SCALED requires uncompressed operand storage: the "
            "combine lane dequantizes into (and requantizes from) the f32 "
            "accumulator, so compressed-stored operands cannot ride the "
            "block-scaled wire")
    if stream_flags != StreamFlags.NO_STREAM:
        raise ValueError(
            "BLOCK_SCALED cannot combine with stream-port operands (stream "
            "lanes carry raw elements, not scale-block payloads)")
    if (cfg.uncompressed_dtype != torch.float32
            or dtype_name(cfg.compressed_dtype) not in quant.WIRE_DTYPE_NAMES):
        raise ValueError(
            f"BLOCK_SCALED supports float32 operands over an int8/fp8 wire "
            f"dtype; got {dtype_name(cfg.uncompressed_dtype)} over "
            f"{dtype_name(cfg.compressed_dtype)}")


class ACCL:
    """One rank's handle to the collective engine.

    Args:
        device: the execution backend (a :class:`CudaDevice`).
        comm: the world communicator for this rank.
        timeout: receive timeout in seconds.
    """

    def __init__(self, device: Device, comm: Communicator,
                 timeout: float = 30.0):
        self.device = device
        self._arith_memo: dict = {}
        self.communicators: list[Communicator] = [comm]
        # one-sided windows this driver registered: id -> buffer
        self._next_window = itertools.count(1)
        self._windows: dict[int, ACCLBuffer] = {}
        # (op name, comm_id) -> calls issued, bytes of their uncompressed
        # operands; read by the metrics collector at snapshot time only
        self._call_counts: dict[tuple, int] = {}
        self._byte_counts: dict[tuple, int] = {}
        METRICS.register_collector(self, ACCL._metrics_rows)
        device.configure_communicator(comm)
        # bring-up through the call path, as the reference driver does
        self.set_timeout(timeout)
        self._config_call(CfgFunc.enable_pkt, 1)

    @property
    def comm(self) -> Communicator:
        return self.communicators[0]

    @property
    def rank(self) -> int:
        return self.comm.local_rank

    @property
    def world_size(self) -> int:
        return self.comm.size

    def _config_call(self, fn: CfgFunc, value: int, comm_id: int = 0):
        self._call(CallDescriptor(CCLOp.config, count=int(value),
                                  comm_id=comm_id, tag=int(fn)),
                   run_async=False, waitfor=())

    def set_timeout(self, timeout: float):
        self._config_call(CfgFunc.set_timeout, int(round(timeout * 1000)))
        self.device.timeout = timeout

    def deinit(self):
        # withdraw THIS driver's windows only: other drivers on the same
        # device keep theirs until they deinit
        for wid in list(self._windows):
            self.deregister_window(wid)
        self.device.deinit()

    def metrics_snapshot(self) -> dict:
        """Every counter, gauge and histogram of
        :data:`~accl_tpu_torch.tracing.METRICS`: this process's drivers'
        call and byte counts, the serving control plane's rows, and any
        direct writes."""
        return METRICS.snapshot()

    def _metrics_rows(self):
        """Collector rows of this driver's per-communicator call
        accounting. ``rank`` keeps one world's drivers apart, ``ctx``
        worlds of the same shape, whose comm ids agree."""
        labels = {"rank": self.rank}
        ctx = getattr(self.device, "ctx", None)
        if ctx is not None:
            labels["ctx"] = ctx.seq
        for (op, comm_id), n in list(self._call_counts.items()):
            yield ("counter", "accl_calls_total",
                   dict(labels, op=op, comm_id=comm_id), n)
        for (op, comm_id), n in list(self._byte_counts.items()):
            yield ("counter", "accl_bytes_total",
                   dict(labels, op=op, comm_id=comm_id), n)

    def soft_reset(self):
        """Rank-local soft reset through the call path: drops the parked
        sends and drains this rank's stream ports."""
        self._config_call(CfgFunc.reset_periph, 0)

    # -- buffers ------------------------------------------------------------
    def buffer(self, shape=None, dtype=torch.float32, data=None,
               device_resident: bool = False) -> ACCLBuffer:
        """Allocate a buffer registered with this rank's device.

        ``data`` may be a torch tensor or anything numpy takes. A tensor
        on a CUDA device, or any data with ``device_resident=True``,
        makes a device-resident buffer (homed on the rank's device; calls
        then read and write it in place with no host staging). Otherwise
        the buffer is a host mirror: a CPU tensor sharing memory with a
        contiguous ``data``."""
        if isinstance(data, torch.Tensor) and data.device.type != "cpu":
            device_resident = True
        if data is not None and not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data))
        if device_resident:
            t = (self.device.adopt_device_tensor(data) if data is not None
                 else self.device.make_device_tensor(
                     shape, to_torch_dtype(dtype)))
        elif data is not None:
            t = data.contiguous()
        else:
            t = torch.zeros(shape, dtype=to_torch_dtype(dtype))
        return ACCLBuffer(t, device=self.device,
                          device_resident=device_resident)

    # -- call plumbing --------------------------------------------------------
    def _quant_block_for(self, block_scale) -> int:
        if block_scale is True:
            return quant.DEFAULT_BLOCK
        return quant.clamp_block(int(block_scale))

    def _prepare(self, scenario: CCLOp, *, count: int, comm: Communicator,
                 root_src_dst: int = 0, func: ReduceFunc = ReduceFunc.SUM,
                 tag: int = TAG_ANY,
                 op0: ACCLBuffer | None = None, op1: ACCLBuffer | None = None,
                 res: ACCLBuffer | None = None,
                 compress_dtype=None, block_scale: bool | int = False,
                 stream_dtype=None,
                 stream_flags: StreamFlags = StreamFlags.NO_STREAM,
                 algorithm: CollectiveAlgorithm | str = (
                     CollectiveAlgorithm.AUTO)) -> CallDescriptor:
        """Resolve operand dtypes to an arith config + compression flags
        (the reference's prepare_call): mark each narrower-typed operand
        OP{0,1}/RES_COMPRESSED and request ETH_COMPRESSED when the caller
        asks for wire compression; ``block_scale`` upgrades the wire to
        block-scaled quantization. ``stream_dtype`` is the element type of
        a streamed operand, which has no buffer to take it from."""
        dtypes = {b.dtype for b in (op0, op1, res) if b is not None}
        if stream_dtype is not None:
            dtypes.add(to_torch_dtype(stream_dtype))
        compression = Compression.NONE
        if compress_dtype is not None:
            dtypes.add(to_torch_dtype(compress_dtype))
            compression |= Compression.ETH_COMPRESSED
            if block_scale:
                compression |= Compression.BLOCK_SCALED
        elif block_scale:
            raise ValueError(
                "block_scale needs a compress_dtype naming the quantized "
                "wire dtype (int8 / float8_e4m3fn / float8_e5m2)")
        if not dtypes:
            dtypes = {torch.float32}
        mk = frozenset(dtypes)
        cfg = self._arith_memo.get(mk)
        if cfg is None:
            cfg = resolve_arith_config(dtypes)
            self._arith_memo[mk] = cfg
        if compression & Compression.BLOCK_SCALED:
            qblock = self._quant_block_for(block_scale)
            bk = (mk, qblock)
            bcfg = self._arith_memo.get(bk)
            if bcfg is None:
                bcfg = self._arith_memo[bk] = dataclasses.replace(
                    cfg, quant_block=qblock)
            cfg = bcfg
        elif (compression & Compression.ETH_COMPRESSED
                and cfg.is_compressing
                and not cfg.compressed_dtype.is_floating_point
                and cfg.uncompressed_dtype.is_floating_point):
            raise ValueError(
                f"compress_dtype={dtype_name(cfg.compressed_dtype)} on "
                f"{dtype_name(cfg.uncompressed_dtype)} operands requires "
                f"block-scaled quantization (pass block_scale=): plain "
                f"dtype narrowing to an integer wire would truncate")
        if cfg.is_compressing:
            if op0 is not None and op0.dtype == cfg.compressed_dtype:
                compression |= Compression.OP0_COMPRESSED
            if op1 is not None and op1.dtype == cfg.compressed_dtype:
                compression |= Compression.OP1_COMPRESSED
            if res is not None and res.dtype == cfg.compressed_dtype:
                compression |= Compression.RES_COMPRESSED
        if compression & Compression.BLOCK_SCALED:
            _check_block_scaled(cfg, compression, stream_flags)
        if isinstance(algorithm, str):
            algorithm = CollectiveAlgorithm[algorithm.upper()]
        return CallDescriptor(
            scenario=scenario, count=count, comm_id=comm.comm_id,
            root_src_dst=root_src_dst, function=ReduceFunc(func), tag=tag,
            arithcfg=cfg, compression=compression, stream_flags=stream_flags,
            algorithm=CollectiveAlgorithm(algorithm),
            addr_0=op0.address if op0 is not None else 0,
            addr_1=op1.address if op1 is not None else 0,
            addr_2=res.address if res is not None else 0)

    def _call(self, desc: CallDescriptor, run_async: bool,
              waitfor: Sequence[CallHandle]) -> CallHandle:
        handle = self.device.call_async(desc, waitfor,
                                        inline_ok=not run_async)
        if desc.scenario != CCLOp.config:
            key = (desc.scenario.name, desc.comm_id)
            self._call_counts[key] = self._call_counts.get(key, 0) + 1
            nb = desc.count * (desc.arithcfg.uncompressed_dtype.itemsize
                               if desc.arithcfg is not None else 0)
            if nb:
                self._byte_counts[key] = self._byte_counts.get(key, 0) + nb
        if run_async:
            return handle
        handle.wait()
        return CompletedHandle(context=desc.scenario.name)

    # -- operations -----------------------------------------------------------
    def nop(self, run_async: bool = False,
            waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """No-op through the full call path (call-latency probe)."""
        return self._call(CallDescriptor(CCLOp.nop), run_async, waitfor)

    def allgather(self, srcbuf: ACCLBuffer, dstbuf: ACCLBuffer, count: int,
                  *, comm: Communicator | None = None,
                  algorithm: CollectiveAlgorithm | str = (
                      CollectiveAlgorithm.AUTO),
                  compress_dtype=None, block_scale: bool | int = False,
                  run_async: bool = False,
                  waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """count = per-rank chunk; dstbuf holds world_size*count."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.allgather, count=count, comm=comm,
                             op0=srcbuf, res=dstbuf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale, algorithm=algorithm)
        return self._call(desc, run_async, waitfor)

    def allreduce(self, srcbuf: ACCLBuffer, dstbuf: ACCLBuffer, count: int,
                  func: ReduceFunc = ReduceFunc.SUM, *,
                  comm: Communicator | None = None,
                  algorithm: CollectiveAlgorithm | str = (
                      CollectiveAlgorithm.AUTO),
                  compress_dtype=None, block_scale: bool | int = False,
                  run_async: bool = False,
                  waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """``compress_dtype`` names the wire dtype; with ``block_scale``
        the wire is block-scale quantized: per-block scales, f32
        accumulation, fresh scales on every hop."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.allreduce, count=count, comm=comm,
                             func=func, op0=srcbuf, res=dstbuf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale, algorithm=algorithm)
        return self._call(desc, run_async, waitfor)

    def reduce_scatter(self, srcbuf: ACCLBuffer, dstbuf: ACCLBuffer,
                       count: int, func: ReduceFunc = ReduceFunc.SUM, *,
                       comm: Communicator | None = None,
                       algorithm: CollectiveAlgorithm | str = (
                           CollectiveAlgorithm.AUTO),
                       compress_dtype=None, block_scale: bool | int = False,
                       run_async: bool = False,
                       waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """count = per-rank chunk; srcbuf holds world_size*count."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.reduce_scatter, count=count, comm=comm,
                             func=func, op0=srcbuf, res=dstbuf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale, algorithm=algorithm)
        return self._call(desc, run_async, waitfor)

    def alltoall(self, srcbuf: ACCLBuffer, dstbuf: ACCLBuffer, count: int,
                 *, comm: Communicator | None = None, compress_dtype=None,
                 block_scale: bool | int = False, run_async: bool = False,
                 waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """count = per-peer chunk; srcbuf and dstbuf hold world_size*count.
        Chunk j of srcbuf goes to rank j; a wire dtype casts every chunk
        that leaves its rank (fp8 too: no scale)."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.alltoall, count=count, comm=comm,
                             op0=srcbuf, res=dstbuf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale)
        return self._call(desc, run_async, waitfor)

    def bcast(self, buf: ACCLBuffer, count: int | None = None, root: int = 0,
              *, comm: Communicator | None = None,
              algorithm: CollectiveAlgorithm | str = CollectiveAlgorithm.AUTO,
              compress_dtype=None, block_scale: bool | int = False,
              run_async: bool = False,
              waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """In place: root's ``buf`` lands in every other rank's ``buf``
        (the root's stays exact; a wire dtype is a pure cast per hop)."""
        comm = comm or self.comm
        count = count if count is not None else buf.size
        desc = self._prepare(CCLOp.bcast, count=count, comm=comm,
                             root_src_dst=root, op0=buf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale, algorithm=algorithm)
        return self._call(desc, run_async, waitfor)

    def scatter(self, srcbuf: ACCLBuffer | None, dstbuf: ACCLBuffer,
                count: int, root: int = 0, *,
                comm: Communicator | None = None, compress_dtype=None,
                block_scale: bool | int = False, run_async: bool = False,
                waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """count = per-rank chunk size; srcbuf holds world_size*count at
        root (non-root ranks may pass None)."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.scatter, count=count, comm=comm,
                             root_src_dst=root, op0=srcbuf, res=dstbuf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale)
        return self._call(desc, run_async, waitfor)

    def gather(self, srcbuf: ACCLBuffer, dstbuf: ACCLBuffer | None,
               count: int, root: int = 0, *,
               comm: Communicator | None = None,
               algorithm: CollectiveAlgorithm | str = CollectiveAlgorithm.AUTO,
               compress_dtype=None, block_scale: bool | int = False,
               run_async: bool = False,
               waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """count = per-rank chunk; dstbuf holds world_size*count at root.
        Non-root ranks may pass None (their destination is never
        written)."""
        comm = comm or self.comm
        if comm.local_rank == root and dstbuf is None:
            raise ValueError("gather root requires a destination buffer")
        desc = self._prepare(CCLOp.gather, count=count, comm=comm,
                             root_src_dst=root, op0=srcbuf, res=dstbuf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale, algorithm=algorithm)
        return self._call(desc, run_async, waitfor)

    def reduce(self, srcbuf: ACCLBuffer, dstbuf: ACCLBuffer | None,
               count: int, root: int = 0, func: ReduceFunc = ReduceFunc.SUM,
               *, comm: Communicator | None = None,
               algorithm: CollectiveAlgorithm | str = CollectiveAlgorithm.AUTO,
               compress_dtype=None, block_scale: bool | int = False,
               run_async: bool = False,
               waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """The reduction of every rank's srcbuf lands in the root's
        dstbuf (non-root ranks may pass None)."""
        comm = comm or self.comm
        if comm.local_rank == root and dstbuf is None:
            raise ValueError("reduce root requires a destination buffer")
        desc = self._prepare(CCLOp.reduce, count=count, comm=comm,
                             root_src_dst=root, func=func, op0=srcbuf,
                             res=dstbuf, compress_dtype=compress_dtype,
                             block_scale=block_scale, algorithm=algorithm)
        return self._call(desc, run_async, waitfor)

    def barrier(self, *, comm: Communicator | None = None,
                waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """Rendezvous of all ranks of ``comm``."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.barrier, count=0, comm=comm)
        return self._call(desc, False, waitfor)

    # -- local and point-to-point operations ----------------------------------
    def copy(self, srcbuf: ACCLBuffer | None, dstbuf: ACCLBuffer | None,
             count: int | None = None, *, comm: Communicator | None = None,
             stream_flags: StreamFlags = StreamFlags.NO_STREAM,
             stream_dtype=None, run_async: bool = False,
             waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """Local copy. With OP0_STREAM the source is this rank's stream-in
        port (srcbuf may be None); with RES_STREAM the result goes to its
        stream-out port (dstbuf may be None). A fully streamed copy takes
        its element type from ``stream_dtype`` (default float32)."""
        if count is None:
            if srcbuf is not None:
                count = srcbuf.size
            elif dstbuf is not None:
                count = dstbuf.size
            else:
                raise ValueError("copy with both operands streamed "
                                 "requires an explicit count")
        desc = self._prepare(CCLOp.copy, count=count, comm=comm or self.comm,
                             op0=srcbuf, res=dstbuf,
                             stream_dtype=stream_dtype,
                             stream_flags=stream_flags)
        return self._call(desc, run_async, waitfor)

    def combine(self, count: int, func: ReduceFunc, op0: ACCLBuffer | None,
                op1: ACCLBuffer, res: ACCLBuffer | None, *,
                stream_dtype=None,
                stream_flags: StreamFlags = StreamFlags.NO_STREAM,
                run_async: bool = False,
                waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """res = func(op0, op1) elementwise, on the device (B1). With
        OP0_STREAM the first operand comes from the stream-in port (op0
        may be None); with RES_STREAM the result goes to the stream-out
        port (res may be None)."""
        desc = self._prepare(CCLOp.combine, count=count, comm=self.comm,
                             func=func, op0=op0, op1=op1, res=res,
                             stream_dtype=stream_dtype,
                             stream_flags=stream_flags)
        return self._call(desc, run_async, waitfor)

    def send(self, srcbuf: ACCLBuffer | None, count: int, dst: int,
             tag: int = TAG_ANY, *, comm: Communicator | None = None,
             compress_dtype=None, block_scale: bool | int = False,
             stream_dtype=None,
             stream_flags: StreamFlags = StreamFlags.NO_STREAM,
             run_async: bool = False,
             waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """Eager send: returns once the payload is snapshotted, before
        the matching recv is posted; the source may be overwritten at
        once. With OP0_STREAM the payload comes from the stream-in port
        (srcbuf may be None). ``block_scale`` (with ``compress_dtype``)
        sends block-scaled codes and scales; the receiver must post a
        block-scaled recv."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.send, count=count, comm=comm,
                             root_src_dst=dst, tag=tag, op0=srcbuf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale,
                             stream_dtype=stream_dtype,
                             stream_flags=stream_flags)
        return self._call(desc, run_async, waitfor)

    def recv(self, dstbuf: ACCLBuffer | None, count: int, src: int,
             tag: int = TAG_ANY, *, comm: Communicator | None = None,
             compress_dtype=None, block_scale: bool | int = False,
             stream_dtype=None,
             stream_flags: StreamFlags = StreamFlags.NO_STREAM,
             run_async: bool = False,
             waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """Receive ``count`` elements from ``src``, matched by tag in the
        order the sends were made. With RES_STREAM the payload lands on
        the stream-out port (dstbuf may be None)."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.recv, count=count, comm=comm,
                             root_src_dst=src, tag=tag, res=dstbuf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale,
                             stream_dtype=stream_dtype,
                             stream_flags=stream_flags)
        return self._call(desc, run_async, waitfor)

    def stream_put(self, srcbuf: ACCLBuffer, count: int, dst: int,
                   tag: int = TAG_ANY, *, run_async: bool = False,
                   waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """Send into rank ``dst``'s stream-in port instead of its receive
        matching (the reference's remote-stream send): no recv is posted
        for it and it consumes no sequence number."""
        desc = self._prepare(CCLOp.send, count=count, comm=self.comm,
                             root_src_dst=dst, tag=tag, op0=srcbuf,
                             stream_flags=StreamFlags.RES_STREAM)
        return self._call(desc, run_async, waitfor)

    # -- one-sided RMA ----------------------------------------------------------
    def register_window(self, buf: ACCLBuffer,
                        window: int | None = None) -> int:
        """Expose ``buf`` as a one-sided window peers can put/get
        against; returns the window id. When every rank registers its
        windows in the same order, the auto-assigned ids agree across
        ranks without a handshake; ``window=`` pins an id instead. The
        buffer stays usable locally; a remote put lands in it with no
        local call posted."""
        if window is None:
            # skip pinned ids: an auto registration must not redirect the
            # peers' puts at a pinned window into another buffer
            wid = next(self._next_window)
            while wid in self._windows:
                wid = next(self._next_window)
        else:
            wid = int(window)
        self.device.register_window(wid, buf.address, buf.nbytes)
        self._windows[wid] = buf
        return wid

    def deregister_window(self, window: int):
        """Withdraw a window registration: later puts/gets against it
        fail typed (``RMA_WINDOW_ERROR``) at the initiator."""
        self.device.deregister_window(int(window))
        self._windows.pop(int(window), None)

    def put(self, srcbuf: ACCLBuffer, count: int, dst: int, window: int,
            offset: int = 0, *, comm: Communicator | None = None,
            compress_dtype=None, notify: int | None = None,
            run_async: bool = False,
            waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """One-sided write: ``count`` elements of ``srcbuf`` land at byte
        ``offset`` inside window ``window`` on rank ``dst`` (comm-local),
        which posts no call. ``compress_dtype`` narrows the wire
        (decompressed on landing; a float8 wire is a plain cast, with no
        scale). The handle completes when the data is in the window.

        ``notify=token`` (u64, 0 = none) makes the TARGET enqueue one
        completion record on its notify queue once the put has landed
        (an error record when the window does not resolve), which it
        reads with :meth:`poll_notifications`."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.put, count=count, comm=comm,
                             root_src_dst=dst, tag=int(window), op0=srcbuf,
                             compress_dtype=compress_dtype)
        desc.addr_1 = int(offset)   # byte offset INTO the window
        if notify is not None:
            # a put has no result buffer: addr_2 carries the token
            desc.addr_2 = int(notify) & 0xFFFFFFFFFFFFFFFF
        return self._call(desc, run_async, waitfor)

    def get(self, dstbuf: ACCLBuffer, count: int, src: int, window: int,
            offset: int = 0, *, comm: Communicator | None = None,
            compress_dtype=None, run_async: bool = False,
            waitfor: Sequence[CallHandle] = ()) -> CallHandle:
        """One-sided read: ``count`` elements from byte ``offset`` of
        window ``window`` on rank ``src`` land in ``dstbuf``; the source
        posts no call."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.get, count=count, comm=comm,
                             root_src_dst=src, tag=int(window), res=dstbuf,
                             compress_dtype=compress_dtype)
        desc.addr_1 = int(offset)   # byte offset INTO the window
        return self._call(desc, run_async, waitfor)

    def poll_notifications(self, window: int | None = None,
                           max_records: int = 64):
        """Drain up to ``max_records`` put-with-notify records
        (:class:`~accl_tpu_torch.rma.NotifyRecord`) of ``window`` (every
        window when None) from this rank's queue. A direct device
        dequeue, not a call: it adds no ``accl_calls_total`` row."""
        wid = ANY_WINDOW if window is None else int(window)
        return self.device.poll_notifications(wid, int(max_records))

    def stream_push(self, data) -> None:
        """Feed this rank's stream-in port (a copy of ``data``, a tensor or
        anything numpy takes): the next OP0_STREAM operand comes from
        here."""
        self.device.push_stream(data)

    def stream_pop(self, timeout: float = 0.0, count: int | None = None):
        """Read this rank's stream-out port: ``count`` elements, across
        the entries that produced them, or the next entry whole when
        ``count`` is None. A tensor on the rank's device; IndexError when
        it does not fill within ``timeout`` seconds."""
        return self.device.pop_stream(timeout, count)
