"""CUDA backend: the ACCL call surface executed by W ranks on one device.

The port of ``accl_tpu/device/tpu.py``. One process is the controller of
all ranks; each rank still gets its own ``CudaDevice`` view and ``ACCL``
driver, so the same rank-parallel code drives every tier. Collectives
rendezvous on the host: member ranks' calls are matched in per-rank
program order under the context lock, and the last rank to arrive
launches ONE collective over all ranks (:class:`RankCollectives`) and
completes every member's handle. Incomplete groups expire through a
deadline sweeper.

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
a compressed reduce never does). Every other operation returns
``COLLECTIVE_NOT_IMPLEMENTED``.
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

from ..arith import dtype_name
from ..buffer import ACCLBuffer
from ..call import CallDescriptor, CallHandle
from ..communicator import Communicator
from ..constants import (ACCLError, CCLOp, CollectiveAlgorithm, Compression,
                         DEFAULT_TIMEOUT_S, ErrorCode,
                         check_algorithm)
from ..log import get_logger
from ..parallel.collectives import RankCollectives
from ..parallel.mesh import RankGroup, make_group
from ..parallel.tree import Tree2DCollectives
from ..quant import DEFAULT_BLOCK, WIRE_DTYPE_NAMES
from .base import Device

log = get_logger(__name__)

_COLLECTIVES = {CCLOp.bcast, CCLOp.scatter, CCLOp.gather, CCLOp.reduce,
                CCLOp.allgather, CCLOp.allreduce, CCLOp.reduce_scatter,
                CCLOp.alltoall, CCLOp.barrier}

# (op) -> (input, output) elements per rank, in units of the call's count
_DENSE = {CCLOp.allreduce: (1, 1), CCLOp.allgather: (1, "W"),
          CCLOp.reduce_scatter: ("W", 1), CCLOp.alltoall: ("W", "W")}
_ROOTED = (CCLOp.bcast, CCLOp.scatter, CCLOp.gather, CCLOp.reduce)


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

    def device_of(self, rank: int) -> "CudaDevice":
        if self.devices[rank] is None:
            self.devices[rank] = CudaDevice(self, rank)
        return self.devices[rank]

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
    # that will block on the handle anyway
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
        if (op in self._TRIVIAL_OPS or op in _COLLECTIVES) \
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
        self._coll_index.clear()

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

    def _read_operand(self, addr: int, count: int,
                      desc) -> torch.Tensor:
        """``count`` elements of the buffer at ``addr`` on the context's
        device, in the call's uncompressed dtype."""
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
        flat = buf.storage.reshape(-1)[:count]
        return flat.to(self.ctx.device).to(cfg.uncompressed_dtype)

    def _write_result(self, addr: int, data: torch.Tensor, desc):
        """Land a result in the buffer at ``addr`` (in place; stored in
        the compressed dtype when the call says RES_COMPRESSED)."""
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
        buf.storage.reshape(-1)[:n].copy_(data.reshape(-1).to(out))

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
        if desc.stream_flags:
            return int(ErrorCode.STREAM_NOT_SUPPORTED)
        comm = self.comms.get(desc.comm_id)
        if comm is None:
            return int(ErrorCode.COMM_NOT_CONFIGURED)
        if op in _COLLECTIVES:
            return self._do_collective(desc, comm, handle, defer_launch)
        return int(ErrorCode.COLLECTIVE_NOT_IMPLEMENTED)

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
        coll, alg = ctx.coll, ctx.algorithm
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
