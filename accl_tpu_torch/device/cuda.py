"""CUDA backend: the ACCL call surface executed by W ranks on one device.

The port of ``accl_tpu/device/tpu.py``. One process is the controller of
all ranks; each rank still gets its own ``CudaDevice`` view and ``ACCL``
driver, so the same rank-parallel code drives every tier. Collectives
rendezvous on the host: member ranks' calls are matched in per-rank
program order under the context lock, and the last rank to arrive
launches ONE collective over all ranks (:class:`RankCollectives`) and
completes every member's handle. Incomplete groups expire through a
deadline sweeper.

Point to point: ``send`` is eager. It snapshots the payload into memory
of its own (B5's codes and scales on the block-scaled wire, B2's
down-cast on a per-tensor wire, else one device copy) and parks it,
bounded by ``CudaContext.max_parked_sends``; torch tensors are written in
place, so the snapshot is what lets the caller reuse the source at once.
``recv`` matches parked sends by (comm, src, dst, tag) in MPI order and
moves the data through the context's exchange window
(``CudaContext.exchange_transfer``): transfers deposited while a batch
runs ride the next batch together, one permutation round of
``RankCollectives.exchange`` for those that do not conflict; a solo
transfer never waits. The received payload lands through B6 (block-scaled), B2 (per-
tensor wire) or the round's own copy. Each rank has a
:class:`DeviceStreamPort` for the streamed ``copy``, ``combine``,
``send`` and ``recv`` and the remote-stream ``stream_put``.

Buffers stage in two ways:

* host-mirror buffers (CPU tensors) are read to the device, reduced, and
  written back, with a synchronising copy before the handles complete;
* device-resident buffers (tensors on the context's device) are read and
  written in place with no host copy: the fast path. Its launches are
  asynchronous on the launching thread's current stream, as JAX's
  dispatch is; ``torch.cuda.synchronize()`` waits for them.

This package executes the collectives (allreduce, reduce_scatter,
allgather, alltoall, bcast, scatter, gather, reduce, barrier) on every
wire: full precision, the per-tensor lanes (f16, bf16, fp8 with one
scale per payload) and the block-scaled fp8/int8 lane. Rooted ops take
the 2D tree when the world folds into one (AUTO, or TREE where legal;
a compressed reduce never does). ``copy`` and ``combine`` run on the
device (``combine`` on B1, a compressed operand or result through B2).
RMA (``put``, ``get``) returns ``COLLECTIVE_NOT_IMPLEMENTED``.
"""

from __future__ import annotations

import collections
import functools
import queue
import threading
import time
import weakref
from typing import Sequence

import torch

from ..arith import dtype_name, to_torch_dtype
from ..buffer import ACCLBuffer
from ..call import CallDescriptor, CallHandle
from ..communicator import Communicator
from ..constants import (ACCLError, CCLOp, CollectiveAlgorithm, Compression,
                         DEFAULT_TIMEOUT_S, ErrorCode, StreamFlags, TAG_ANY,
                         check_algorithm)
from ..log import get_logger
from ..ops.combine import combine
from ..ops.compression import bs_dequant, bs_quant, cast
from ..parallel.collectives import WIRE_LANE_NAMES, RankCollectives
from ..parallel.mesh import RankGroup, make_group
from ..parallel.tree import Tree2DCollectives
from ..quant import DEFAULT_BLOCK, WIRE_DTYPE_NAMES, packed_nbytes
from .base import Device

log = get_logger(__name__)

_COLLECTIVES = {CCLOp.bcast, CCLOp.scatter, CCLOp.gather, CCLOp.reduce,
                CCLOp.allgather, CCLOp.allreduce, CCLOp.reduce_scatter,
                CCLOp.alltoall, CCLOp.barrier}

# (op) -> (input, output) elements per rank, in units of the call's count
_DENSE = {CCLOp.allreduce: (1, 1), CCLOp.allgather: (1, "W"),
          CCLOp.reduce_scatter: ("W", 1), CCLOp.alltoall: ("W", "W")}
_ROOTED = (CCLOp.bcast, CCLOp.scatter, CCLOp.gather, CCLOp.reduce)
# the local and point-to-point ops: they stream, and they run inline
# only for a caller that blocks on them at once
_P2P = {CCLOp.send, CCLOp.recv, CCLOp.copy, CCLOp.combine}
# dtypes a device-resident buffer may not take a result in, nor a streamed
# send carry (the reference's jax, with x64 off, would truncate them)
_WIDE = {torch.int64, torch.float64}
_LANE_DTYPES = {to_torch_dtype(n) for n in WIRE_LANE_NAMES}


def to_dtype(t: torch.Tensor, dtype: torch.dtype,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """``t`` in ``dtype`` (into ``out`` when given): B2
    (:func:`~accl_tpu_torch.ops.compression.cast`) between float32 and a
    wire lane dtype; a torch conversion between any other two dtypes,
    none of which a TPU kernel covers; ``t`` itself when the dtypes
    agree and there is no ``out``."""
    lane = t.dtype if dtype == torch.float32 else dtype
    if t.dtype != dtype and torch.float32 in (t.dtype, dtype) \
            and lane in _LANE_DTYPES:
        return cast([t], dtype, None if out is None else [out])[0]
    if out is None:
        return t if t.dtype == dtype else t.to(dtype)
    out.copy_(t)
    return out


class Parcel:
    """One message on the wire: memory of its own, which no later write to
    the sender's buffer reaches. ``data`` holds the elements (in the
    call's dtype, or the wire's after B2) or, on the block-scaled wire,
    B5's codes, beside their ``scales``, ``wire`` name and ``block``."""

    __slots__ = ("data", "scales", "wire", "block")

    def __init__(self, data: torch.Tensor, scales=None, wire=None,
                 block: int = 0):
        self.data, self.scales, self.wire, self.block = (data, scales, wire,
                                                         block)

    @property
    def count(self) -> int:
        return self.data.numel()

    @property
    def nbytes(self) -> int:
        """Logical wire bytes: the reference's packed segment on the
        block-scaled wire (``quant.packed_nbytes``), else the elements."""
        if self.scales is not None:
            return packed_nbytes(self.count, self.block)
        return self.count * self.data.element_size()

    def decode(self, dtype, out=None) -> torch.Tensor:
        """The elements in ``dtype`` (into ``out`` when given): B6 for
        the block-scaled wire, :func:`to_dtype` otherwise."""
        if self.scales is None:
            return to_dtype(self.data, dtype, out)
        if dtype != torch.float32:
            raise ValueError("the block-scaled wire decodes to float32")
        return bs_dequant([self.data], [self.scales], self.wire, self.block,
                          None if out is None else [out])[0]


class _XchgEntry:
    """One matched transfer waiting in the exchange window."""

    __slots__ = ("src", "dst", "parcel", "out", "result", "error", "done")

    def __init__(self, src: int, dst: int, parcel: Parcel, out):
        self.src, self.dst, self.parcel, self.out = src, dst, parcel, out
        self.result: Parcel | None = None
        self.error: BaseException | None = None
        self.done = False


class DeviceStreamPort:
    """One rank's stream ports: deques of 1-D tensors on the rank's
    device (the reference's ``DeviceStreamPort``, the AXIS bypass port of
    the original). A take may span entries and consume one partially; a
    shortfall blocks until the deadline and consumes nothing on timeout.
    Entries are memory of the port's own: ``push`` copies."""

    def __init__(self, device):
        self.dev = device
        self._in: collections.deque = collections.deque()
        self._in_off = 0                # consumed prefix of _in[0]
        self._out: collections.deque = collections.deque()
        self._out_off = 0
        self._cv = threading.Condition()

    def push(self, data) -> None:
        t = data.detach() if isinstance(data, torch.Tensor) \
            else torch.as_tensor(data)
        self.put_in(t.reshape(-1).to(self.dev, copy=True))

    @staticmethod
    def _avail(q, off) -> int:
        return sum(e.numel() for e in q) - off

    def _assemble(self, q, off, count, dtype):
        """Pop ``count`` elements off the front of ``q``: (tensor,
        new offset)."""
        pieces = []
        need = count
        while need:
            e = q[0]
            take = min(need, e.numel() - off)
            pieces.append(e if off == 0 and take == e.numel()
                          else e[off:off + take])
            need -= take
            off += take
            if off == e.numel():
                q.popleft()
                off = 0
        out = (pieces[0] if len(pieces) == 1 else torch.cat(pieces)) \
            if pieces else torch.empty(0, dtype=dtype or torch.float32,
                                       device=self.dev)
        if dtype is not None and out.dtype != dtype:
            out = out.to(dtype)
        return out, off

    def take(self, count: int, dtype, deadline: float):
        """Stream-in read of exactly ``count`` elements in ``dtype``;
        None on timeout (nothing consumed)."""
        with self._cv:
            while self._avail(self._in, self._in_off) < count:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(remaining):
                    return None
            out, self._in_off = self._assemble(self._in, self._in_off,
                                               count, dtype)
            return out

    def put_in(self, t: torch.Tensor) -> None:
        """Stream-in delivery: a push, or a peer's ``stream_put``."""
        with self._cv:
            self._in.append(t.reshape(-1))
            self._cv.notify_all()

    def put_out(self, t: torch.Tensor) -> None:
        with self._cv:
            self._out.append(t.reshape(-1))
            self._cv.notify_all()

    def pop(self, timeout: float = 0.0, count: int | None = None):
        """Stream-out read: ``count`` elements across entries, or the next
        entry whole (``count`` None or 0). IndexError when it does not
        fill within ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                if not count:
                    if self._out:
                        e = self._out.popleft()
                        if self._out_off:
                            e, self._out_off = e[self._out_off:], 0
                        return e
                elif self._avail(self._out, self._out_off) >= count:
                    out, self._out_off = self._assemble(
                        self._out, self._out_off, count, None)
                    return out
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(remaining):
                    raise IndexError("stream-out port empty")

    def reset(self) -> None:
        with self._cv:
            self._in.clear()
            self._out.clear()
            self._in_off = self._out_off = 0


class CudaContext:
    """Shared state of an N-rank world on one torch device."""

    def __init__(self, world_size: int, device="cuda",
                 algorithm: str = "xla"):
        self.group: RankGroup = make_group(world_size, device)
        self.device = self.group.device
        self.world_size = self.group.size
        self.coll = RankCollectives(self.group)
        # the rooted ops' 2D grid (None when the world does not fold)
        self.tree = Tree2DCollectives.fold(self.coll)
        self.algorithm = algorithm
        self.devices: list[CudaDevice | None] = [None] * self.world_size
        self._lock = threading.Condition()
        # (comm_id, op_index) -> {comm-local rank: (desc, handle, deadline)}
        self._pending: dict[tuple, dict] = {}
        self._sweeper: threading.Thread | None = None
        self._idle_scans = 0
        self._subcolls: dict[int, RankCollectives] = {}
        # -- point to point (all guarded by _lock) --------------------------
        # (comm_id, src_g, dst_g) -> deque of (tag, Parcel): eager sends
        # parked until a recv matches them. Each holds device memory, so
        # their number is bounded, like the emulator's spare-buffer pool:
        # an overflowing send fails with the pool's overflow error.
        self._sends: dict[tuple, collections.deque] = \
            collections.defaultdict(collections.deque)
        self.max_parked_sends = 1024
        self._parked_sends = 0
        # exchange window: comm_id -> queued _XchgEntry; comm_ids whose
        # batch is running
        self._xchg_pending: dict[int, list] = collections.defaultdict(list)
        self._xchg_running: set[int] = set()
        # permutation rounds run and logical wire bytes moved by them
        self.exchange_rounds = 0
        self.exchange_bytes = 0

    def device_of(self, rank: int) -> "CudaDevice":
        if self.devices[rank] is None:
            self.devices[rank] = CudaDevice(self, rank)
        return self.devices[rank]

    def coll_for(self, comm: Communicator) -> RankCollectives:
        """The collectives over a communicator's ranks (comm-local order;
        every rank shares the one device, so only the size matters)."""
        if comm.size == self.world_size:
            return self.coll
        with self._lock:
            coll = self._subcolls.get(comm.size)
            if coll is None:
                coll = self._subcolls[comm.size] = RankCollectives(
                    make_group(comm.size, self.device))
            return coll

    # -- the exchange window (tpu.py exchange_transfer) ---------------------
    def exchange_transfer(self, comm: Communicator, parcel: Parcel,
                          src: int, dst: int, out=None) -> Parcel:
        """Move one message from comm-local rank ``src`` to ``dst``: the
        received parcel; ``out``, when given, is the destination tensor
        the round copies the elements into.

        Transfers batch opportunistically, as in the reference: any
        thread whose entry is pending may claim the free leadership of
        its communicator, run the window present at claim time as one
        batch, and hand off. A solo transfer never waits for a window to
        fill; transfers deposited while a batch runs ride the next one
        together, in the rounds their conflicts need."""
        entry = _XchgEntry(src, dst, parcel, out)
        cid = comm.comm_id
        with self._lock:
            self._xchg_pending[cid].append(entry)
        while True:
            with self._lock:
                if entry.done:
                    break
                if cid in self._xchg_running:
                    # the leader notifies after every round and on handoff
                    self._lock.wait(0.05)
                    continue
                self._xchg_running.add(cid)
                batch, self._xchg_pending[cid] = self._xchg_pending[cid], []
            try:
                self._run_exchange_batch(comm, batch)
            except BaseException as exc:
                with self._lock:
                    for e in batch:
                        if not e.done:           # completed rounds stand
                            e.error, e.done = exc, True
            finally:
                with self._lock:
                    self._xchg_running.discard(cid)
                    self._lock.notify_all()
        if entry.error is not None:
            raise entry.error
        return entry.result

    def _run_exchange_batch(self, comm: Communicator, entries: list):
        """Entries group by payload geometry; each group splits greedily
        into permutation rounds (a source and a destination once a
        round), and each round is one ``RankCollectives.exchange``."""
        coll = self.coll_for(comm)
        groups: dict[tuple, list] = collections.defaultdict(list)
        for e in entries:
            d = e.parcel.data
            groups[(d.numel(), d.dtype, e.parcel.scales is None)].append(e)
        for remaining in groups.values():
            while remaining:
                rnd, nxt, srcs, dsts = [], [], set(), set()
                for e in remaining:
                    if e.src in srcs or e.dst in dsts:
                        nxt.append(e)     # conflicts ride the next round
                    else:
                        srcs.add(e.src)
                        dsts.add(e.dst)
                        rnd.append(e)
                remaining = nxt
                rows, outs = [None] * coll.W, [None] * coll.W
                for e in rnd:
                    rows[e.src], outs[e.dst] = e.parcel.data, e.out
                got = coll.exchange(rows, [(e.src, e.dst) for e in rnd],
                                    outs)
                with self._lock:
                    self.exchange_rounds += 1
                    for e in rnd:
                        p = e.parcel
                        self.exchange_bytes += p.nbytes
                        e.result = Parcel(got[e.dst], p.scales, p.wire,
                                          p.block)
                        e.done = True
                    self._lock.notify_all()

    # -- deadline sweeper ---------------------------------------------------
    def _ensure_sweeper(self):
        """Start the (single, lazy) deadline sweeper. Caller holds _lock.
        Members of an incomplete group park no thread; the sweeper fails
        each deposit whose deadline passed with RECEIVE_TIMEOUT_ERROR.
        The thread holds the context only weakly: a world whose ranks
        were deinit'ed and dropped is freed (with every rank's buffers)
        even while the sweeper still waits out its idle scans."""
        if self._sweeper is None:
            self._idle_scans = 0
            self._sweeper = threading.Thread(target=_sweep_loop,
                                             args=(weakref.ref(self),),
                                             daemon=True,
                                             name="cuda-coll-sweeper")
            self._sweeper.start()

    def _sweep_once(self) -> float | None:
        """One scan: fail the expired deposits; return the seconds to
        wait before the next scan, or None when the sweeper retires."""
        with self._lock:
            now = time.monotonic()
            expired = []
            next_dl = None
            for key, group in list(self._pending.items()):
                for r, (_d, h, dl) in list(group.items()):
                    if dl <= now:
                        group.pop(r)
                        expired.append(h)
                    elif next_dl is None or dl < next_dl:
                        next_dl = dl
                if not group:
                    self._pending.pop(key, None)
            if not self._pending and not expired:
                self._idle_scans += 1
                if self._idle_scans >= 10:
                    # idle for ~2 s: retire; the next incomplete
                    # deposit restarts the sweeper
                    self._sweeper = None
                    return None
            else:
                self._idle_scans = 0
        for h in expired:
            err = int(ErrorCode.RECEIVE_TIMEOUT_ERROR)
            h.complete(err, exception=ACCLError(
                err, "collective group incomplete at deadline"))
        # polls: 200 ms when idle, the earliest deadline when groups
        # are pending (a timeout may fire up to one poll late)
        now = time.monotonic()
        return (0.2 if next_dl is None
                else min(max(next_dl - now, 0.001), 0.2))


def _sweep_loop(ref: "weakref.ref[CudaContext]"):
    while True:
        ctx = ref()
        if ctx is None:
            return
        wait = ctx._sweep_once()
        del ctx
        if wait is None:
            return
        time.sleep(wait)


class CudaDevice(Device):
    """One rank's view of the world."""

    # nop/config are trivial and always run inline; collectives always
    # inline their deposit, and the launch runs inline only for callers
    # that will block on the handle anyway; the local and p2p ops do real
    # work (a recv may wait for its peer) and run inline only for such
    # callers too
    _TRIVIAL_OPS = {CCLOp.nop, CCLOp.config}

    def __init__(self, ctx: CudaContext, rank: int):
        super().__init__()
        self.ctx = ctx
        self.rank = rank
        self.host_bufs: dict[int, ACCLBuffer] = {}
        self.dev_bufs: dict[int, ACCLBuffer] = {}
        self.comms: dict[int, Communicator] = {}
        self.comm: Communicator | None = None
        self.timeout = DEFAULT_TIMEOUT_S
        self._coll_index: dict[int, int] = collections.defaultdict(int)
        self.sport = DeviceStreamPort(ctx.device)
        self._calls: queue.Queue = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=f"cuda-rank{rank}")
        self._worker.start()

    # -- Device interface ---------------------------------------------------
    def register_buffer(self, buf: ACCLBuffer):
        (self.dev_bufs if buf.is_device_resident
         else self.host_bufs)[buf.address] = buf

    def deregister_buffer(self, buf: ACCLBuffer):
        self.dev_bufs.pop(buf.address, None)
        self.host_bufs.pop(buf.address, None)

    def adopt_device_tensor(self, t: torch.Tensor) -> torch.Tensor:
        """Home a tensor on this rank's device (zero-copy when it already
        lives there and is contiguous)."""
        if t.device != self.ctx.device:
            t = t.to(self.ctx.device)
        return t.contiguous()

    def make_device_tensor(self, shape, dtype, init=None) -> torch.Tensor:
        if init is None:
            return torch.zeros(shape, dtype=dtype, device=self.ctx.device)
        t = torch.as_tensor(init).to(dtype).reshape(shape)
        return t.to(self.ctx.device, copy=True).contiguous()

    def configure_communicator(self, comm: Communicator):
        self.comms[comm.comm_id] = comm
        if self.comm is None:
            self.comm = comm

    def set_timeout(self, timeout: float):
        self.timeout = timeout

    def call_async(self, desc: CallDescriptor,
                   waitfor: Sequence[CallHandle] = (), *,
                   inline_ok: bool = False) -> CallHandle:
        handle = CallHandle(context=desc.scenario.name)
        op = desc.scenario
        # inline fast path whenever per-rank FIFO order is provable:
        # nothing queued or running on the worker, dependencies retired
        if (op in self._TRIVIAL_OPS or op in _COLLECTIVES
                or (op in _P2P and inline_ok)) \
                and self._inline_begin(waitfor):
            try:
                self._run_one(desc, waitfor, handle,
                              defer_launch=(op in _COLLECTIVES
                                            and not inline_ok))
            finally:
                self._inflight_done()
            return handle
        self._inflight_add()
        self._calls.put((desc, tuple(waitfor), handle))
        return handle

    def soft_reset(self):
        """Drop the world's parked sends, this rank's collective indices
        and its stream ports."""
        with self.ctx._lock:
            self.ctx._sends.clear()
            self.ctx._parked_sends = 0
        self._coll_index.clear()
        self.sport.reset()

    def push_stream(self, data):
        self.sport.push(data)

    def pop_stream(self, timeout: float = 0.0, count: int | None = None):
        return self.sport.pop(timeout, count)

    def deinit(self):
        """Retire the rank: its queued calls run, then its worker exits.
        Returns once it has, so that the rank's buffers are free for the
        collector when the caller drops them."""
        self._calls.put(None)
        if threading.current_thread() is not self._worker:
            self._worker.join()

    # -- worker -------------------------------------------------------------
    def _run(self):
        while True:
            item = self._calls.get()
            if item is None:
                return
            try:
                if callable(item):
                    item()  # deferred group launch (async last arrival)
                else:
                    desc, waitfor, handle = item
                    self._run_one(desc, waitfor, handle)
            finally:
                self._inflight_done()

    def _run_one(self, desc: CallDescriptor, waitfor, handle: CallHandle,
                 defer_launch: bool = False):
        """Retire one call in the current thread. Completes ``handle``
        unless the call parked in a rendezvous group."""
        try:
            if (desc.deadline is not None
                    and time.monotonic() >= desc.deadline):
                handle.complete(int(ErrorCode.RECEIVE_TIMEOUT_ERROR))
                return
            for dep in waitfor:
                dep.wait(self.timeout if desc.deadline is None
                         else max(0.0, desc.deadline - time.monotonic()))
            err = self._execute(desc, handle, defer_launch)
            if err is not None:
                handle.complete(err)
        except ACCLError as exc:
            handle.complete(exc.error_word, exception=exc)
        except TimeoutError as exc:
            handle.complete(int(ErrorCode.RECEIVE_TIMEOUT_ERROR),
                            exception=exc)
        except Exception as exc:  # noqa: BLE001
            handle.complete(int(ErrorCode.INVALID_CALL), exception=exc)

    # -- operand staging ----------------------------------------------------
    def _buffer(self, addr: int) -> ACCLBuffer | None:
        buf = self.dev_bufs.get(addr)
        return buf if buf is not None else self.host_bufs.get(addr)

    def _read_operand(self, addr: int, count: int, desc,
                      which: Compression = Compression.OP0_COMPRESSED
                      ) -> torch.Tensor:
        """``count`` elements of the buffer at ``addr`` on the context's
        device, in the call's uncompressed dtype: a device-resident
        buffer's own elements where its dtype is that one (no copy), else
        the buffer's elements moved in their stored dtype (the compressed
        one where the call flags ``which``) and widened on the device
        (:func:`to_dtype`: B2 from a wire dtype)."""
        cfg = desc.arithcfg
        if not addr:    # no buffer on this rank (a rooted op's non-root)
            return torch.zeros(count, dtype=cfg.uncompressed_dtype,
                               device=self.ctx.device)
        buf = self._buffer(addr)
        if buf is None:
            raise ACCLError(int(ErrorCode.INVALID_CALL),
                            f"no buffer at address {addr:#x}")
        if count > buf.size:
            raise ACCLError(int(ErrorCode.DMA_SIZE_ERROR),
                            f"read past buffer end ({count} > {buf.size})")
        if not buf.is_device_resident:
            stored = (cfg.compressed_dtype if desc.compression & which
                      else cfg.uncompressed_dtype)
            if buf.dtype != stored:
                raise ACCLError(int(ErrorCode.INVALID_CALL),
                                f"operand stored as {buf.dtype}, the call "
                                f"says {stored}")
        flat = buf.storage.reshape(-1)[:count]
        return to_dtype(flat.to(self.ctx.device), cfg.uncompressed_dtype)

    def _aliases(self, t: torch.Tensor, addr: int) -> bool:
        """True when ``t`` lies in the memory of the buffer at ``addr``."""
        buf = self._buffer(addr) if addr else None
        return buf is not None and (t.untyped_storage().data_ptr()
                                    == buf.storage.untyped_storage()
                                    .data_ptr())

    def _write_result(self, addr: int, data: torch.Tensor, desc):
        """Land a result in the buffer at ``addr``, in place, in the
        compressed dtype when the call says RES_COMPRESSED (B2 down from
        float32 to a wire dtype). A 64-bit result may not land in a
        device-resident buffer, as in the reference."""
        cfg = desc.arithcfg
        out = (cfg.compressed_dtype
               if desc.compression & Compression.RES_COMPRESSED
               else cfg.uncompressed_dtype)
        buf = self._buffer(addr)
        if buf is None:
            raise ACCLError(int(ErrorCode.INVALID_CALL),
                            f"no buffer at address {addr:#x}")
        n = data.numel()
        if n > buf.size:
            raise ACCLError(int(ErrorCode.DMA_SIZE_ERROR),
                            f"write past buffer end ({n} > {buf.size})")
        dst = buf.storage.reshape(-1)[:n]
        if buf.is_device_resident:
            if out in _WIDE:
                raise ACCLError(int(ErrorCode.INVALID_CALL),
                                f"a {out} result cannot land in a "
                                f"device-resident buffer; use a "
                                f"host-mirror buffer for 64-bit dtypes")
            if dst.dtype == out:
                to_dtype(data.reshape(-1), out, out=dst)
                return
        dst.copy_(to_dtype(data.reshape(-1), out))

    def _landing(self, desc) -> torch.Tensor | None:
        """The first ``count`` elements of the result buffer when it is
        device-resident and takes the call's uncompressed dtype as it is
        (the result then lands there directly), else None."""
        buf = self.dev_bufs.get(desc.addr_2)
        cfg = desc.arithcfg
        if (buf is None or buf.size < desc.count
                or desc.compression & Compression.RES_COMPRESSED
                or buf.dtype != cfg.uncompressed_dtype
                or buf.dtype in _WIDE):
            return None
        return buf.tensor.reshape(-1)[:desc.count]

    # -- execution ----------------------------------------------------------
    def _execute(self, desc: CallDescriptor, handle: CallHandle,
                 defer_launch: bool = False) -> int | None:
        """The call's error word, or None when it parked in a rendezvous
        group whose last arrival completes ``handle``."""
        op = desc.scenario
        if op == CCLOp.nop:
            return 0
        if op == CCLOp.config:
            return self.apply_config(desc)
        if desc.stream_flags and op not in _P2P:
            # a streamed operand of a collective belongs inside its
            # program: refused, never run as a memory-only variant
            return int(ErrorCode.STREAM_NOT_SUPPORTED)
        comm = self.comms.get(desc.comm_id)
        if comm is None:
            return int(ErrorCode.COMM_NOT_CONFIGURED)
        s_op0 = bool(desc.stream_flags & StreamFlags.OP0_STREAM)
        s_res = bool(desc.stream_flags & StreamFlags.RES_STREAM)
        if op == CCLOp.copy:
            if s_op0 or s_res:
                return self._streamed_local(desc, s_op0, s_res, None)
            self._write_result(desc.addr_2, self._read_operand(
                desc.addr_0, desc.count, desc), desc)
            return 0
        if op == CCLOp.combine:
            if s_op0 or s_res:
                return self._streamed_local(desc, s_op0, s_res,
                                            desc.function)
            a = self._read_operand(desc.addr_0, desc.count, desc)
            b = self._read_operand(desc.addr_1, desc.count, desc,
                                   Compression.OP1_COMPRESSED)
            dst = self._landing(desc)
            res = combine(a, b, desc.function, out=dst)     # B1
            if dst is None:
                self._write_result(desc.addr_2, res, desc)
            return 0
        if op == CCLOp.send:
            return self._do_send(desc, comm)
        if op == CCLOp.recv:
            return self._do_recv(desc, comm)
        if op in _COLLECTIVES:
            return self._do_collective(desc, comm, handle, defer_launch)
        # put and get: RMA is not in this package yet
        return int(ErrorCode.COLLECTIVE_NOT_IMPLEMENTED)

    # -- streamed local ops (the stream ports' datapath) --------------------
    def _deadline(self, desc) -> float:
        return (desc.deadline if desc.deadline is not None
                else time.monotonic() + self.timeout)

    def _streamed_local(self, desc: CallDescriptor, s_op0: bool,
                        s_res: bool, func) -> int:
        """copy / combine with the first operand from the stream-in port
        and/or the result to the stream-out port; the payload stays on the
        device (B1 for combine). A stalled stream fails with
        KRNL_TIMEOUT_STS_ERROR and consumes nothing."""
        uncomp = desc.arithcfg.uncompressed_dtype
        if s_op0:
            data = self.sport.take(desc.count, uncomp, self._deadline(desc))
            if data is None:
                return int(ErrorCode.KRNL_TIMEOUT_STS_ERROR)
        else:
            data = self._read_operand(desc.addr_0, desc.count, desc)
        if func is not None:
            b = self._read_operand(desc.addr_1, desc.count, desc,
                                   Compression.OP1_COMPRESSED)
            dst = None if s_res else self._landing(desc)
            data = combine(data, b, func, out=dst)          # B1
            if dst is not None:
                return 0
        if s_res:
            # the port holds memory of its own, not the caller's buffer
            self.sport.put_out(data.clone()
                               if self._aliases(data, desc.addr_0)
                               else data)
            return 0
        self._write_result(desc.addr_2, data, desc)
        return 0

    # -- send / recv (tpu.py _do_send, _match_send, _do_recv) ---------------
    def _encode(self, x: torch.Tensor, desc, owned: bool) -> Parcel:
        """The message of a send: B5 on the block-scaled wire, B2 down to
        a per-tensor wire, else ``x`` (copied unless ``owned``)."""
        cfg = desc.arithcfg
        wire = (cfg.compressed_dtype
                if desc.compression & Compression.ETH_COMPRESSED else None)
        if wire is not None and desc.compression & Compression.BLOCK_SCALED:
            name = dtype_name(wire)
            block = int(cfg.quant_block or DEFAULT_BLOCK)
            q, s = bs_quant([x], name, block)
            return Parcel(q[0], s[0], name, block)
        if wire is not None and wire != x.dtype:
            return Parcel(to_dtype(x, wire))
        return Parcel(x if owned else x.clone())

    def _do_send(self, desc: CallDescriptor, comm: Communicator) -> int:
        """Eager send: snapshot the payload (:meth:`_encode`) and park it
        for the matching recv. From the stream-in port with OP0_STREAM;
        to the peer's stream-in port with RES_STREAM (``stream_put``),
        which bypasses the matching and consumes no sequence number."""
        ctx = self.ctx
        uncomp = desc.arithcfg.uncompressed_dtype
        if desc.stream_flags & StreamFlags.OP0_STREAM:
            if uncomp in _WIDE:
                # refused before the stream is consumed, as the reference
                # refuses to carry a 64-bit payload between devices
                return int(ErrorCode.STREAM_NOT_SUPPORTED)
            x = self.sport.take(desc.count, uncomp, self._deadline(desc))
            if x is None:
                return int(ErrorCode.KRNL_TIMEOUT_STS_ERROR)
            parcel = self._encode(x, desc, owned=True)
        else:
            x = self._read_operand(desc.addr_0, desc.count, desc)
            parcel = self._encode(x, desc,
                                  owned=not self._aliases(x, desc.addr_0))
        dst = desc.root_src_dst
        if desc.stream_flags & StreamFlags.RES_STREAM:
            peer = ctx.devices[comm.ranks[dst].global_rank]
            if dst != comm.local_rank:
                parcel = ctx.exchange_transfer(comm, parcel,
                                               comm.local_rank, dst)
            peer.sport.put_in(parcel.decode(uncomp))
            return 0
        key = (desc.comm_id, comm.my_global_rank,
               comm.ranks[dst].global_rank)
        with ctx._lock:
            if ctx._parked_sends >= ctx.max_parked_sends:
                return int(ErrorCode.RECEIVE_OFFCHIP_SPARE_BUFF_OVERFLOW)
            ctx._parked_sends += 1
            ctx._sends[key].append((desc.tag, parcel))
            ctx._lock.notify_all()
        return 0

    def _match_send(self, key: tuple, tag: int) -> Parcel | None:
        """Pop the oldest parked send of ``key`` that ``tag`` matches
        (TAG_ANY on either side matches any). Caller holds the lock."""
        ctx = self.ctx
        pending = ctx._sends.get(key)
        if not pending:
            return None
        for i, (stag, parcel) in enumerate(pending):
            if tag == TAG_ANY or stag == tag or stag == TAG_ANY:
                del pending[i]
                ctx._parked_sends -= 1
                if not pending:
                    del ctx._sends[key]
                return parcel
        return None

    def _do_recv(self, desc: CallDescriptor, comm: Communicator) -> int:
        """Wait for a matching send until the deadline, check its format
        against the posted receive (the emulator tier's error words), then
        take it through the exchange and land it: in place in a device-
        resident buffer, on the stream-out port with RES_STREAM, else
        through the host. A self-send skips the exchange."""
        ctx = self.ctx
        src = desc.root_src_dst
        key = (desc.comm_id, comm.ranks[src].global_rank,
               comm.my_global_rank)
        deadline = self._deadline(desc)
        uncomp = desc.arithcfg.uncompressed_dtype
        s_res = bool(desc.stream_flags & StreamFlags.RES_STREAM)
        with ctx._lock:
            while True:
                parcel = self._match_send(key, desc.tag)
                if parcel is not None:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not ctx._lock.wait(remaining):
                    return int(ErrorCode.RECEIVE_TIMEOUT_ERROR)
            if parcel.scales is not None:
                if not desc.compression & Compression.BLOCK_SCALED:
                    # the packed segment is not ``count`` plain elements
                    return int(ErrorCode.DMA_MISMATCH_ERROR)
                if parcel.count != desc.count:
                    return int(ErrorCode.COMPRESSION_ERROR)
            elif desc.compression & Compression.BLOCK_SCALED:
                return int(ErrorCode.COMPRESSION_ERROR)   # not a packed one
            elif parcel.count != desc.count:
                return int(ErrorCode.DMA_MISMATCH_ERROR)
        dst = None if s_res else self._landing(desc)
        # the round copies the elements straight into the buffer when they
        # need no decoding
        direct = (dst is not None and parcel.scales is None
                  and parcel.data.dtype == uncomp)
        if src == comm.local_rank:         # a self-send: no hop
            if direct:
                dst.copy_(parcel.data)
                return 0
        else:
            parcel = ctx.exchange_transfer(comm, parcel, src,
                                           comm.local_rank,
                                           dst if direct else None)
            if direct:
                return 0
        data = parcel.decode(uncomp, dst)
        if s_res:
            self.sport.put_out(data)
        elif dst is None:
            self._write_result(desc.addr_2, data, desc)
        return 0

    def _do_collective(self, desc: CallDescriptor, comm: Communicator,
                       handle: CallHandle, defer_launch: bool = False):
        """Deposit this rank's call; the group-completing arrival launches
        and completes EVERY member's handle. No member blocks a thread
        waiting for results; an incomplete group expires member by member
        through the context's deadline sweeper."""
        ctx = self.ctx
        deadline = (desc.deadline if desc.deadline is not None
                    else time.monotonic() + self.timeout)
        with ctx._lock:
            # index assignment under the ctx lock: deposit order IS the
            # per-rank matching order (MPI program-order matching)
            idx = self._coll_index[desc.comm_id]
            self._coll_index[desc.comm_id] += 1
            key = (desc.comm_id, idx)
            group = ctx._pending.setdefault(key, {})
            # an expired member must not count toward completion: fail it
            # here (completion runs outside the lock)
            now = time.monotonic()
            expired = [group.pop(r)[1]
                       for r in [r for r, (_, _, dl) in group.items()
                                 if dl <= now]]
            group[comm.local_rank] = (desc, handle, deadline)
            is_last = len(group) == comm.size
            if is_last:
                del ctx._pending[key]
            else:
                ctx._ensure_sweeper()
        for h in expired:
            h.complete(int(ErrorCode.RECEIVE_TIMEOUT_ERROR),
                       exception=ACCLError(
                           int(ErrorCode.RECEIVE_TIMEOUT_ERROR),
                           "collective member deadline expired"))
        if not is_last:
            return None
        if defer_launch:
            # async last arrival: the launch must not run in the
            # submitter's thread; hop it to this rank's worker
            self._inflight_add()
            self._calls.put(lambda: self._finish_group(group, comm))
            return None
        self._finish_group(group, comm)
        return None

    def _finish_group(self, group: dict, comm: Communicator) -> None:
        """Launch a claimed group and complete EVERY member's handle."""
        err = int(ErrorCode.INVALID_CALL)
        exc_out: BaseException | None = None
        try:
            descs = [group[r][0] for r in range(comm.size)]
            err = self._launch(descs, comm)
        except Exception as exc:  # noqa: BLE001
            log.error("rank %s: collective group launch failed", self.rank,
                      exc_info=True, extra={"rank": self.rank})
            exc_out = exc
        finally:
            for _, h, _dl in group.values():
                h.complete(err, exception=exc_out)

    def _launch(self, descs: list, comm: Communicator) -> int:
        """Execute one collective for all member ranks (no locks held)."""
        ctx = self.ctx
        d0 = descs[0]
        op = d0.scenario
        if any(d.scenario != op or d.count != d0.count for d in descs):
            return int(ErrorCode.INVALID_CALL)
        count = d0.count
        W = comm.size
        cfg = d0.arithcfg
        wire = (cfg.compressed_dtype
                if d0.compression & Compression.ETH_COMPRESSED else None)
        devs = [ctx.devices[comm.ranks[r].global_rank] for r in range(W)]
        coll, alg = ctx.coll_for(comm), ctx.algorithm
        try:
            check_algorithm(op.name, d0.algorithm)
        except ValueError:
            return int(ErrorCode.INVALID_CALL)
        if d0.algorithm in (CollectiveAlgorithm.RING,
                            CollectiveAlgorithm.FUSED_RING):
            alg = "ring"
        elif d0.algorithm != CollectiveAlgorithm.AUTO:
            alg = "xla"
        # block-scaled quantized wire: the ring-shaped dense collectives
        # take the codec-kernel ring (qblock selects it and pins the
        # ring); other ops fall back to the full-precision wire
        qblock = 0
        if wire is not None and d0.compression & Compression.BLOCK_SCALED:
            if (op in (CCLOp.allreduce, CCLOp.reduce_scatter,
                       CCLOp.allgather)
                    and dtype_name(wire) in WIRE_DTYPE_NAMES):
                qblock = int(cfg.quant_block or DEFAULT_BLOCK)
                alg = "ring"
            else:
                wire = None
        if op == CCLOp.barrier:
            return 0  # the rendezvous above IS the barrier
        if op in _DENSE:
            return self._launch_dense(op, descs, devs, coll, alg, wire,
                                      qblock, cfg, count, W)
        if op in _ROOTED:
            # AUTO and TREE take the 2D tree when the world folds; of the
            # rooted ops only reduce differs there (bcast / scatter /
            # gather run the same binomial schedule over the flattened
            # grid). A compressed reduce keeps the 1-D path, whose
            # decompress-before-arith numerics are the contract.
            use_tree = (op == CCLOp.reduce and wire is None
                        and d0.algorithm in (CollectiveAlgorithm.AUTO,
                                             CollectiveAlgorithm.TREE))
            tree = ctx.tree if use_tree and W == ctx.world_size else None
            return self._launch_rooted(op, descs, devs, coll, tree, alg,
                                       wire, cfg, count, W)
        return int(ErrorCode.COLLECTIVE_NOT_IMPLEMENTED)

    def _launch_dense(self, op, descs, devs, coll, alg, wire, qblock, cfg,
                      count: int, W: int) -> int:
        n_in, n_out = (count * (W if m == "W" else m) for m in _DENSE[op])
        run = getattr(coll, op.name)
        kw = dict(wire_dtype=wire)
        if op != CCLOp.alltoall:
            kw.update(algorithm=alg, qblock=qblock)
        if op in (CCLOp.allreduce, CCLOp.reduce_scatter):
            kw["func"] = descs[0].function

        # -- device-resident fast path: no host copies at all ---------------
        srcs = self._resident(descs, devs, cfg, "addr_0", n_in)
        dsts = self._resident(descs, devs, cfg, "addr_2", n_out)
        if srcs is not None and dsts is not None:
            run(srcs, out=dsts, **kw)
            return 0

        # -- host-staged path ------------------------------------------------
        rows = [devs[r]._read_operand(d.addr_0, n_in, d)
                for r, d in enumerate(descs)]
        out = run(rows, **kw)
        self._land(out, descs, devs, "addr_2", range(W))
        return 0

    def _launch_rooted(self, op, descs, devs, coll, tree, alg, wire, cfg,
                       count: int, W: int) -> int:
        """bcast lands in place in every non-root's buffer; scatter in
        every rank's destination; gather and reduce in the root's only.
        Only the buffers a rank owns data in must exist: a scatter's
        non-root sources and a gather's or reduce's non-root destinations
        are never touched."""
        d0 = descs[0]
        root = d0.root_src_dst
        if not 0 <= root < W:
            return int(ErrorCode.INVALID_CALL)
        n_in = W * count if op == CCLOp.scatter else count
        n_out = W * count if op == CCLOp.gather else count
        if op == CCLOp.reduce and tree is None:
            call = functools.partial(coll.reduce, root=root,
                                     func=d0.function, wire_dtype=wire,
                                     algorithm=alg)
        elif op == CCLOp.reduce:
            call = functools.partial(tree.reduce, root=root,
                                     func=d0.function)
        else:
            call = functools.partial(getattr(coll, op.name), root=root,
                                     wire_dtype=wire)
        src_ranks, dst_addr, dst_ranks = {
            CCLOp.bcast: (range(W), "addr_0",
                          [r for r in range(W) if r != root]),
            CCLOp.scatter: ([root], "addr_2", range(W)),
            CCLOp.gather: (range(W), "addr_2", [root]),
            CCLOp.reduce: (range(W), "addr_2", [root]),
        }[op]

        # -- device-resident path: in place, no host copies -----------------
        srcs = self._resident(descs, devs, cfg, "addr_0", n_in, src_ranks)
        dsts = self._resident(descs, devs, cfg, dst_addr, n_out, dst_ranks)
        if srcs is not None and dsts is not None:
            if op == CCLOp.bcast:
                dsts[root] = srcs[root]
            call(srcs, out=dsts)
            return 0

        # -- host-staged path ------------------------------------------------
        rows = [devs[r]._read_operand(d.addr_0, n_in, d)
                for r, d in enumerate(descs)]
        out = call(rows)
        self._land(out, descs, devs, dst_addr, dst_ranks)
        return 0

    @staticmethod
    def _land(out, descs, devs, addr: str, ranks) -> None:
        """Write result rows ``ranks`` of ``out`` into each rank's buffer
        at ``addr`` (after the device finished computing them)."""
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        for r in ranks:
            devs[r]._write_result(getattr(descs[r], addr), out[r], descs[r])

    @staticmethod
    def _resident(descs, devs, cfg, addr: str, n: int, ranks=None):
        """The flat tensors of each listed rank's device-resident buffer
        at ``addr`` (a list over all ranks, None for unlisted ones), when
        every one has exactly ``n`` elements of the call's dtype; else
        None (the caller stages through the host). OP*/RES_COMPRESSED
        disqualify: a device buffer has one storage dtype."""
        bad = (Compression.OP0_COMPRESSED | Compression.OP1_COMPRESSED
               | Compression.RES_COMPRESSED)
        out = [None] * len(descs)
        for r in (range(len(descs)) if ranks is None else ranks):
            d = descs[r]
            if d.compression & bad:
                return None
            b = devs[r].dev_bufs.get(getattr(d, addr))
            if b is None or b.size != n or b.dtype != cfg.uncompressed_dtype:
                return None
            out[r] = b.tensor.reshape(-1)
        return out


def cuda_world(world_size: int, device="cuda", algorithm: str = "xla",
               timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """Create ``world_size`` ACCL drivers whose ranks share one torch
    device: the counterpart of ``tpu_world``. ``device`` defaults to
    ``"cuda"`` and raises when CUDA is unavailable; pass ``"cpu"`` to run
    the plain versions on the CPU."""
    from ..accl import ACCL
    from ..communicator import Rank
    ctx = CudaContext(world_size, device=device, algorithm=algorithm)
    W = ctx.world_size
    accls = []
    for r in range(W):
        comm = Communicator(ranks=[Rank(device=ctx.device)
                                   for _ in range(W)], local_rank=r)
        accls.append(ACCL(ctx.device_of(r), comm, timeout=timeout))
    return accls
