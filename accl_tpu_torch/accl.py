"""The ACCL driver: the user-facing host API.

The port of ``accl_tpu/accl.py``: buffers, the collectives
(``allreduce`` / ``reduce_scatter`` / ``allgather`` / ``alltoall``, the
rooted ``bcast`` / ``scatter`` / ``gather`` / ``reduce``, ``barrier``),
the local ops ``copy`` and ``combine``, point to point ``send`` and
``recv``, the stream ports (``stream_push``, ``stream_pop``, the
remote-stream ``stream_put`` and ``stream_flags`` on the local and p2p
ops), ``nop`` and ``soft_reset``, with the reference's dtype resolution
and wire-compression flags; the variable-count ``alltoallv`` and the
sharding change ``redistribute`` (:mod:`.hier`). ``compress_dtype``
names the wire dtype: f16, bf16 and fp8 ride the per-tensor lanes; with
``block_scale`` an int8/fp8 wire is block-scale quantized
(``block_scale=True`` means ``quant.DEFAULT_BLOCK`` — there is no tuner
yet — an int is clamped into the legal envelope), on the ring-shaped
collectives, alltoallv and send/recv;
the other collectives then take the full-precision wire, as the
reference does. One-sided RMA: ``register_window``, ``deregister_window``,
``put`` (with ``notify=``), ``get`` and ``poll_notifications``. Every call
but ``config`` is counted per (op, communicator) in ``accl_calls_total``
and ``accl_bytes_total`` (:meth:`ACCL.metrics_snapshot`).

The call contract: every data call takes ``retries=`` / ``retry_policy=``
(over the driver-wide ``retry_policy``, :mod:`.retry`), re-executing a
call whose failure the policy retries, synchronously or behind an async
handle, and ``chain=``, the pipelining hint this backend admits and
ignores. Membership: ``split_communicator``, ``revoke`` (later calls
refuse with PEER_FAILED; calls in flight abort), ``shrink_communicator``
and ``grow_communicator``; ``comm_of`` and ``dump_communicator``.

Not here yet: the tuner (``compress_dtype="auto"``, ``block_scale=True``
from it), the hierarchy (``configure_hierarchy``, ``compress_phases``),
``verify_integrity`` and ``fingerprint_of``, ``preflight``, custom arith
registries, ``max_segment_size``, tenants and the service, the profiling
and trace hooks, and ``plan_cache_stats``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Sequence

import numpy as np
import torch

from . import quant
from .arith import dtype_name, resolve_arith_config, to_torch_dtype
from .buffer import ACCLBuffer
from .call import CallDescriptor, CallHandle, CompletedHandle, wait_all
from .communicator import Communicator, Rank, grown_communicator
from .constants import (ACCLError, CCLOp, CfgFunc, CollectiveAlgorithm,
                        Compression, ErrorCode, ReduceFunc, StreamFlags,
                        TAG_ANY)
from .device.base import Device
from .log import get_logger
from .retry import RetryPolicy, resolve_policy
from .rma import ANY_WINDOW
from .tracing import METRICS

log = get_logger(__name__)


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


def _overlap(a: ACCLBuffer, b: ACCLBuffer) -> bool:
    """True when the two buffers' memory ranges intersect (a buffer and
    its sub-buffer views share their parent's memory)."""
    x, y = a.storage, b.storage
    if x.device != y.device or not a.nbytes or not b.nbytes:
        return False
    a0, b0 = x.data_ptr(), y.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes


class ACCL:
    """One rank's handle to the collective engine.

    Args:
        device: the execution backend (a :class:`CudaDevice`).
        comm: the world communicator for this rank.
        timeout: receive timeout in seconds.
        retry_policy: the driver-wide default :class:`RetryPolicy` of
            every data call (per-call ``retries=`` / ``retry_policy=``
            override it). Must be uniform across a communicator's ranks.
    """

    def __init__(self, device: Device, comm: Communicator,
                 timeout: float = 30.0,
                 retry_policy: RetryPolicy | None = None):
        self.device = device
        self.retry_policy = retry_policy
        self._arith_memo: dict = {}
        self.communicators: list[Communicator] = []
        # global rank -> the most recently registered Rank record of it
        # (grow_communicator resolves member records here)
        self._rank_book: dict[int, Rank] = {}
        self._scratch_bufs: dict[tuple, ACCLBuffer] = {}
        # redistribute: memoized plans, the sub-communicators of
        # ``members=``, and recycled async stage buffers (popped by the
        # driver thread, appended back by a completion callback)
        self._redist_plans: dict = {}
        self._redist_comms: dict = {}
        self._redist_stage_pool: dict = {}
        # one-sided windows this driver registered: id -> buffer
        self._next_window = itertools.count(1)
        self._windows: dict[int, ACCLBuffer] = {}
        # (op name, comm_id) -> calls issued, bytes of their uncompressed
        # operands; read by the metrics collector at snapshot time only
        self._call_counts: dict[tuple, int] = {}
        self._byte_counts: dict[tuple, int] = {}
        METRICS.register_collector(self, ACCL._metrics_rows)
        device.configure_communicator(comm)
        self._register_comm(comm)
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

    # -- communicators and membership ---------------------------------------
    def split_communicator(self, members: Sequence[int],
                           key: int = 0) -> Communicator:
        """Create and register a sub-communicator of world ranks
        ``members``. Every member calls this with the same ``members``:
        the comm id derives from the membership (and ``key``, which keeps
        several communicators over one member set apart), so the members
        agree without a handshake."""
        sub = self.comm.split(members, key=key)
        self.device.configure_communicator(sub)
        self._register_comm(sub)
        return sub

    def revoke(self, comm: Communicator | None = None):
        """Mark a communicator revoked: every later call on it raises
        ``PEER_FAILED`` at once, and this rank's calls already in flight
        on it fail with ``PEER_FAILED`` now (``device.abort_comm``)
        instead of riding out their deadline. Rank-local: each surviving
        rank revokes when it observes the failure, then rebuilds with
        :meth:`shrink_communicator`."""
        comm = comm or self.comm
        comm.revoked = True
        self.device.abort_comm(comm.comm_id, int(ErrorCode.PEER_FAILED))

    def shrink_communicator(self, dead_ranks: Sequence[int],
                            comm: Communicator | None = None,
                            key: int = 0x5A1D) -> Communicator:
        """Build and register the survivor communicator of ``comm`` minus
        ``dead_ranks`` (GLOBAL ranks). Every survivor calls this with the
        same ``dead_ranks``; the new comm id derives from the survivor
        membership, as :meth:`split_communicator`'s does."""
        comm = comm or self.comm
        dead = {int(d) for d in dead_ranks}
        if comm.my_global_rank in dead:
            raise ValueError("cannot shrink away the local rank")
        survivors = [i for i, r in enumerate(comm.ranks)
                     if r.global_rank not in dead]
        if len(survivors) == len(comm.ranks):
            raise ValueError(f"no member of comm {comm.comm_id} is in "
                             f"dead_ranks {sorted(dead)}")
        sub = comm.split(survivors, key=key)
        self.device.configure_communicator(sub)
        self._register_comm(sub)
        METRICS.inc("membership_shrink_total", rank=self.rank)
        return sub

    def grow_communicator(self, new_ranks: Sequence,
                          comm: Communicator | None = None,
                          base_members: Sequence[int] | None = None,
                          key: int = 0,
                          handshake_timeout: float | None = None,
                          retries: int | None = None,
                          retry_policy: RetryPolicy | None = None
                          ) -> Communicator:
        """Build, register and bootstrap the communicator of ``comm`` plus
        ``new_ranks`` (global rank ints, or :class:`Rank` records). Every
        member of the grown communicator calls this with the same
        membership: a survivor passes its communicator as ``comm``, a
        joiner (not a member of it) passes ``base_members``, the global
        ranks of the communicator it joins. Members are ordered by global
        rank and the comm id derives from (membership, key). A grown comm
        with the id of a registered one reconfigures it: its call
        sequence starts again on every member.

        The join handshake runs under the retry policy (``retries=`` /
        ``retry_policy=``, the driver default otherwise); one controller
        holds every rank here, so it succeeds at once. On a final failure
        the grown communicator is revoked and the error raises."""
        if base_members is not None:
            if comm is not None:
                raise ValueError(
                    "pass either comm= or base_members=, not both (a "
                    "joiner names the membership it joins with "
                    "base_members; members pass their communicator)")
            base = [int(g) for g in base_members]
        else:
            comm = comm or self.comm
            base = [r.global_rank for r in comm.ranks]
        explicit: dict[int, Rank] = {}
        new_globals: list[int] = []
        for entry in new_ranks:
            if isinstance(entry, Rank):
                explicit[entry.global_rank] = entry
                new_globals.append(entry.global_rank)
            else:
                new_globals.append(int(entry))
        members = sorted(set(base) | set(new_globals))
        joiners = sorted(set(new_globals) - set(base))
        me = self.comm.my_global_rank
        if me not in members:
            raise ValueError(
                f"local rank (global {me}) is not a member of the grown "
                f"communicator {members} — joiners list themselves in "
                f"new_ranks or base_members")
        if not joiners:
            raise ValueError(
                f"nothing to grow: {sorted(set(new_globals))} are all "
                f"members of the base {sorted(set(base))} already")
        records = []
        for g in members:
            rec = explicit.get(g) or self._rank_book.get(g)
            records.append(rec if rec is not None else Rank(global_rank=g))
        grown = grown_communicator(records, me,
                                   mesh_axis=self.comm.mesh_axis, key=key)
        # configure first, then handshake: a member that finishes its
        # handshake may issue a call on the grown comm at once
        self.device.configure_communicator(grown)
        policy = resolve_policy(retries, retry_policy, self.retry_policy)
        timeout = (handshake_timeout if handshake_timeout is not None
                   else getattr(self.device, "timeout", 5.0))
        attempt = 0
        while True:
            err = int(self.device.join_handshake(grown, timeout))
            if not err:
                break
            if policy is not None and policy.should_retry(err, attempt):
                METRICS.inc("membership_join_retries_total",
                            rank=self.rank)
                time.sleep(policy.backoff(attempt, grown.comm_id))
                attempt += 1
                continue
            grown.revoked = True
            METRICS.inc("membership_join_fail_total", rank=self.rank)
            raise ACCLError(err, f"grow_communicator{members}")
        self._register_comm(grown)
        METRICS.inc("membership_grow_total", rank=self.rank,
                    joiners=len(joiners))
        return grown

    def _register_comm(self, comm: Communicator):
        """Track a (re)built communicator, REPLACING a registered one of
        the same id (after a grow-back the old object and its revoked
        flag must not shadow the new one in :meth:`comm_of`), and record
        its ranks in the rank book."""
        for r in comm.ranks:
            if r.global_rank >= 0:
                self._rank_book[r.global_rank] = r
        for i, c in enumerate(self.communicators):
            if c.comm_id == comm.comm_id:
                self.communicators[i] = comm
                return
        self.communicators.append(comm)

    def comm_of(self, comm_id: int) -> Communicator:
        """Registered communicator by id (world or split)."""
        for c in self.communicators:
            if c.comm_id == comm_id:
                return c
        raise KeyError(f"no communicator with id {comm_id}")

    def dump_communicator(self) -> str:
        return self.comm.describe()

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

    def _scratch(self, like: ACCLBuffer) -> ACCLBuffer:
        """A reusable scratch buffer of ``like``'s size, dtype and
        residency (one per shape: sync calls only)."""
        key = (like.size, like.dtype, like.is_device_resident)
        buf = self._scratch_bufs.get(key)
        if buf is None:
            buf = self._scratch_bufs[key] = self.buffer(
                (like.size,), like.dtype,
                device_resident=like.is_device_resident)
        return buf

    def _stage(self, like: ACCLBuffer, run_async: bool):
        """(stage buffer, its pool or None) for an in-place exchange: the
        cached scratch for a sync call; for an async one a private buffer
        from a recycled pool, which a second exchange in flight cannot
        share (the caller returns it when its call retires)."""
        if not run_async:
            return self._scratch(like), None
        pool = self._redist_stage_pool.setdefault(
            (like.size, like.dtype, like.is_device_resident), [])
        buf = pool.pop() if pool else self.buffer(
            (like.size,), like.dtype, device_resident=like.is_device_resident)
        return buf, pool

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
        a streamed operand, which has no buffer to take it from. A revoked
        communicator refuses the call with PEER_FAILED."""
        if comm.revoked:
            raise ACCLError(int(ErrorCode.PEER_FAILED),
                            f"{scenario.name} on revoked communicator "
                            f"{comm.comm_id}")
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
              waitfor: Sequence[CallHandle], chain: bool = False,
              retries: int | None = None,
              retry_policy: RetryPolicy | None = None) -> CallHandle:
        """Issue a call under the resolved retry policy (per-call
        ``retries=`` / ``retry_policy=`` over the driver default). A
        failure the policy retries re-executes the whole call after the
        policy's backoff; once the attempts are spent the error word
        carries CALL_RETRIES_EXHAUSTED beside the last attempt's."""
        policy = resolve_policy(retries, retry_policy, self.retry_policy)
        if (policy is None or policy.retries <= 0
                or desc.scenario == CCLOp.config):
            return self._call_once(desc, run_async, waitfor, chain)
        if run_async:
            return self._call_async_retry(desc, waitfor, chain, policy)
        attempt = 0
        while True:
            try:
                return self._call_once(desc, run_async, waitfor, chain)
            except ACCLError as exc:
                if policy.should_retry(exc.error_word, attempt):
                    self._note_retry(desc, attempt, exc.error_word)
                    time.sleep(policy.backoff(attempt, desc.comm_id))
                    attempt += 1
                    continue
                if attempt and policy.should_retry(exc.error_word, 0):
                    # a retryable failure, attempts exhausted: say so
                    raise ACCLError(
                        exc.error_word
                        | int(ErrorCode.CALL_RETRIES_EXHAUSTED),
                        desc.scenario.name) from exc
                raise

    def _note_retry(self, desc: CallDescriptor, attempt: int, word: int):
        METRICS.inc("call_retries_total", op=desc.scenario.name,
                    comm_id=desc.comm_id, rank=self.rank)
        log.warning(
            "rank %d: %s on comm %d failed (0x%x) — retry %d", self.rank,
            desc.scenario.name, desc.comm_id, word, attempt + 1,
            extra={"rank": self.rank})

    def _call_async_retry(self, desc: CallDescriptor, waitfor,
                          chain: bool, policy: RetryPolicy) -> CallHandle:
        """The async retry loop: the returned handle completes when an
        attempt succeeds or the policy gives up; a re-issue runs off a
        timer thread, never on the backend's worker."""
        outer = CallHandle(context=desc.scenario.name)
        state = {"attempt": 0}

        def issue():
            try:
                inner = self._call_once(desc, True, waitfor, chain)
            except ACCLError as exc:
                outer.complete(exc.error_word, exception=exc)
                return
            except Exception as exc:  # noqa: BLE001 - surface, not hang
                outer.complete(int(ErrorCode.INVALID_CALL), exception=exc)
                return
            inner.add_done_callback(lambda err, h=inner: on_done(err, h))

        def on_done(err, inner):
            err = int(err)
            if err and policy.should_retry(err, state["attempt"]):
                a = state["attempt"]
                state["attempt"] = a + 1
                self._note_retry(desc, a, err)
                t = threading.Timer(policy.backoff(a, desc.comm_id), issue)
                t.daemon = True
                t.start()
                return
            if err and state["attempt"] and policy.should_retry(err, 0):
                err |= int(ErrorCode.CALL_RETRIES_EXHAUSTED)
            outer.complete(err, exception=inner._exception)

        issue()
        return outer

    def _call_once(self, desc: CallDescriptor, run_async: bool,
                   waitfor: Sequence[CallHandle],
                   chain: bool = False) -> CallHandle:
        if chain and run_async:
            desc.chain = True
        handle = self.device.call_async(desc, waitfor,
                                        inline_ok=not run_async)
        op = desc.scenario.name
        if desc.scenario != CCLOp.config:
            key = (op, desc.comm_id)
            self._call_counts[key] = self._call_counts.get(key, 0) + 1
            nb = desc.count * (desc.arithcfg.uncompressed_dtype.itemsize
                               if desc.arithcfg is not None else 0)
            if nb:
                self._byte_counts[key] = self._byte_counts.get(key, 0) + nb
        if run_async:
            comm_id = desc.comm_id

            def _retired(err):
                if err:
                    METRICS.inc("accl_call_errors_total", op=op,
                                comm_id=comm_id)

            handle.add_done_callback(_retired)
            return handle
        try:
            handle.wait()
        except ACCLError:
            METRICS.inc("accl_call_errors_total", op=op,
                        comm_id=desc.comm_id)
            raise
        return CompletedHandle(context=op)

    @contextlib.contextmanager
    def _retry_scope(self, retries, retry_policy):
        """Per-call ``retries=`` / ``retry_policy=`` of a composite call
        (redistribute): its sub-calls take it as the driver default for
        the issuing scope (one driver is used from one thread at a
        time)."""
        policy = resolve_policy(retries, retry_policy, self.retry_policy)
        prev = self.retry_policy
        self.retry_policy = policy
        try:
            yield
        finally:
            self.retry_policy = prev

    # -- operations -----------------------------------------------------------
    def nop(self, run_async: bool = False, chain: bool = False,
            waitfor: Sequence[CallHandle] = (),
            retries: int | None = None,
            retry_policy: RetryPolicy | None = None) -> CallHandle:
        """No-op through the full call path (call-latency probe)."""
        return self._call(CallDescriptor(CCLOp.nop), run_async, waitfor,
                          chain, retries, retry_policy)

    def allgather(self, srcbuf: ACCLBuffer, dstbuf: ACCLBuffer, count: int,
                  *, comm: Communicator | None = None,
                  algorithm: CollectiveAlgorithm | str = (
                      CollectiveAlgorithm.AUTO),
                  compress_dtype=None, block_scale: bool | int = False,
                  run_async: bool = False, chain: bool = False,
                  waitfor: Sequence[CallHandle] = (),
                  retries: int | None = None,
                  retry_policy: RetryPolicy | None = None) -> CallHandle:
        """count = per-rank chunk; dstbuf holds world_size*count."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.allgather, count=count, comm=comm,
                             op0=srcbuf, res=dstbuf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale, algorithm=algorithm)
        return self._call(desc, run_async, waitfor, chain, retries,
                          retry_policy)

    def allreduce(self, srcbuf: ACCLBuffer, dstbuf: ACCLBuffer, count: int,
                  func: ReduceFunc = ReduceFunc.SUM, *,
                  comm: Communicator | None = None,
                  algorithm: CollectiveAlgorithm | str = (
                      CollectiveAlgorithm.AUTO),
                  compress_dtype=None, block_scale: bool | int = False,
                  run_async: bool = False, chain: bool = False,
                  waitfor: Sequence[CallHandle] = (),
                  retries: int | None = None,
                  retry_policy: RetryPolicy | None = None) -> CallHandle:
        """``compress_dtype`` names the wire dtype; with ``block_scale``
        the wire is block-scale quantized: per-block scales, f32
        accumulation, fresh scales on every hop."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.allreduce, count=count, comm=comm,
                             func=func, op0=srcbuf, res=dstbuf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale, algorithm=algorithm)
        return self._call(desc, run_async, waitfor, chain, retries,
                          retry_policy)

    def reduce_scatter(self, srcbuf: ACCLBuffer, dstbuf: ACCLBuffer,
                       count: int, func: ReduceFunc = ReduceFunc.SUM, *,
                       comm: Communicator | None = None,
                       algorithm: CollectiveAlgorithm | str = (
                           CollectiveAlgorithm.AUTO),
                       compress_dtype=None, block_scale: bool | int = False,
                       run_async: bool = False, chain: bool = False,
                       waitfor: Sequence[CallHandle] = (),
                       retries: int | None = None,
                       retry_policy: RetryPolicy | None = None
                       ) -> CallHandle:
        """count = per-rank chunk; srcbuf holds world_size*count."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.reduce_scatter, count=count, comm=comm,
                             func=func, op0=srcbuf, res=dstbuf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale, algorithm=algorithm)
        return self._call(desc, run_async, waitfor, chain, retries,
                          retry_policy)

    def alltoall(self, srcbuf: ACCLBuffer, dstbuf: ACCLBuffer, count: int,
                 *, comm: Communicator | None = None, compress_dtype=None,
                 block_scale: bool | int = False, run_async: bool = False,
                 chain: bool = False, waitfor: Sequence[CallHandle] = (),
                 retries: int | None = None,
                 retry_policy: RetryPolicy | None = None) -> CallHandle:
        """count = per-peer chunk; srcbuf and dstbuf hold world_size*count.
        Chunk j of srcbuf goes to rank j; a wire dtype casts every chunk
        that leaves its rank (fp8 too: no scale)."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.alltoall, count=count, comm=comm,
                             op0=srcbuf, res=dstbuf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale)
        return self._call(desc, run_async, waitfor, chain, retries,
                          retry_policy)

    def alltoallv(self, srcbuf: ACCLBuffer, dstbuf: ACCLBuffer,
                  send_counts: Sequence[int], recv_counts: Sequence[int], *,
                  comm: Communicator | None = None, compress_dtype=None,
                  block_scale: bool | int = False,
                  run_async: bool = False, chain: bool = False,
                  waitfor: Sequence[CallHandle] = (),
                  retries: int | None = None,
                  retry_policy: RetryPolicy | None = None) -> CallHandle:
        """Variable-count all-to-all (MPI_Alltoallv with contiguous
        displacements): this rank sends ``send_counts[d]`` elements to
        rank d from the d-th interval of ``srcbuf`` (the intervals tile
        the buffer in rank order) and receives ``recv_counts[s]`` from
        rank s into the s-th interval of ``dstbuf``. The vectors must be
        pairwise consistent across ranks (rank i's ``send_counts[j]`` ==
        rank j's ``recv_counts[i]``); the one controller sees every
        member's vectors at launch and fails all of them with
        DMA_MISMATCH_ERROR when they are not. Zero-count peers exchange
        nothing. ``compress_dtype`` / ``block_scale`` take the wire of
        the chunks that leave their rank (a per-tensor cast, or the
        block-scaled codec, one message a chunk); the own chunk lands
        exact. Overlapping ``srcbuf`` / ``dstbuf`` (in place) are staged
        through a copy of the send region."""
        comm = comm or self.comm
        W = comm.size
        send_counts = tuple(int(c) for c in send_counts)
        recv_counts = tuple(int(c) for c in recv_counts)
        if len(send_counts) != W or len(recv_counts) != W:
            raise ValueError(
                f"alltoallv count vectors must have comm.size={W} "
                f"entries; got {len(send_counts)} send / "
                f"{len(recv_counts)} recv")
        if min(send_counts + recv_counts) < 0:
            raise ValueError("alltoallv counts must be non-negative")
        n_send, n_recv = sum(send_counts), sum(recv_counts)
        if srcbuf.size < n_send or dstbuf.size < n_recv:
            raise ValueError(
                f"count vectors overflow their buffers: send needs "
                f"{n_send} elems (srcbuf {srcbuf.size}), recv needs "
                f"{n_recv} (dstbuf {dstbuf.size})")
        count = max(n_send, n_recv)
        if block_scale and compress_dtype is None:
            raise ValueError(
                "block_scale needs a compress_dtype naming the quantized "
                "wire dtype (int8 / float8_e4m3fn / float8_e5m2)")
        # the count vectors' shape is what tells this op apart: the bytes
        # and the skew (largest peer chunk over the even share) make a
        # routing collapse visible without a trace
        METRICS.inc("alltoallv_total", rank=self.rank)
        METRICS.inc("alltoallv_bytes_total",
                    count * srcbuf.dtype.itemsize, rank=self.rank)
        zero_peers = (sum(1 for c in send_counts if not c)
                      + sum(1 for c in recv_counts if not c))
        if zero_peers:
            METRICS.inc("alltoallv_zero_peers_total", zero_peers,
                        rank=self.rank)
        if count:
            cmax = max(max(send_counts), max(recv_counts))
            METRICS.set_gauge("alltoallv_skew",
                              round(cmax * W / count, 3), rank=self.rank)
        src_arena, stage_pool = srcbuf, None
        if n_send and _overlap(srcbuf, dstbuf):
            src_arena, stage_pool = self._stage(srcbuf, run_async)
            cp = self.copy(srcbuf[0:n_send], src_arena[0:n_send], n_send,
                           comm=comm, run_async=True, waitfor=waitfor)
            waitfor = (cp,)
        desc = self._prepare(CCLOp.alltoallv, count=count, comm=comm,
                             op0=src_arena, res=dstbuf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale)
        desc.counts = (send_counts, recv_counts)
        ret = self._call(desc, run_async, waitfor, chain, retries,
                         retry_policy)
        if stage_pool is not None:
            pool, buf = stage_pool, src_arena
            ret.add_done_callback(lambda _err: pool.append(buf))
        return ret

    def redistribute(self, srcbuf: ACCLBuffer, src_spec,
                     dstbuf: ACCLBuffer, dst_spec, *,
                     comm: Communicator | None = None,
                     members: Sequence[int] | None = None,
                     compress_dtype=None, run_async: bool = False,
                     waitfor: Sequence[CallHandle] = (),
                     retries: int | None = None,
                     retry_policy: RetryPolicy | None = None
                     ) -> CallHandle:
        """Change an array's sharding: ``srcbuf`` holds this rank's shard
        under ``src_spec`` (:class:`~accl_tpu_torch.hier.ShardSpec`), and
        on completion ``dstbuf`` holds its shard under ``dst_spec``.

        :func:`~accl_tpu_torch.hier.plan_redistribute` lowers the spec
        pair to the least program it admits (local slice copies, one
        allgather, one alltoall, one alltoallv, or point-to-point sends
        and recvs), which this driver issues over ``comm`` (default: the
        world). ``members`` restricts the exchange to a world-rank
        subset through a cached sub-communicator. Overlapping src/dst
        buffers (in place) are staged through a copy of the source
        shard. Shard buffers are 1-D."""
        from .hier import plan_redistribute
        if members is not None:
            if comm is not None:
                raise ValueError(
                    "pass either comm= or members=, not both (members "
                    "derives its own sub-communicator of those world "
                    "ranks)")
            members = tuple(int(m) for m in members)
            comm = self._redist_comms.get(members)
            if comm is None:
                comm = self.split_communicator(list(members), key=0x52ED)
                self._redist_comms[members] = comm
        else:
            comm = comm or self.comm
        if src_spec.world != comm.size or dst_spec.world != comm.size:
            raise ValueError(
                f"spec worlds ({src_spec.world}, {dst_spec.world}) do "
                f"not match the communicator size {comm.size}")
        if srcbuf.dtype != dstbuf.dtype:
            raise ValueError(
                f"redistribute moves bytes, not values: src dtype "
                f"{dtype_name(srcbuf.dtype)} != dst dtype "
                f"{dtype_name(dstbuf.dtype)} (use compress_dtype for wire "
                f"compression)")
        me = comm.local_rank
        src_count = src_spec.local_count(me)
        dst_count = dst_spec.local_count(me)
        if srcbuf.size < src_count or dstbuf.size < dst_count:
            raise ValueError(
                f"shard does not fit its buffer: src needs {src_count} "
                f"elems (buffer {srcbuf.size}), dst needs {dst_count} "
                f"(buffer {dstbuf.size})")
        pk = (src_spec, dst_spec, me)
        plan = self._redist_plans.get(pk)
        if plan is None:
            plan = self._redist_plans[pk] = plan_redistribute(
                src_spec, dst_spec, me)
        key = ("redistribute", comm.comm_id)
        self._call_counts[key] = self._call_counts.get(key, 0) + 1
        METRICS.inc("reshard_total", rank=self.rank, kind=plan.kind)
        METRICS.inc("reshard_bytes_total",
                    src_spec.n * srcbuf.dtype.itemsize, rank=self.rank)
        # checked before anything is issued and the same on every rank:
        # a rank-local refusal halfway would strand its peers' recvs
        if plan.kind != "noop" and (len(srcbuf.shape) != 1
                                    or len(dstbuf.shape) != 1):
            raise ValueError(
                "redistribute addresses sub-ranges of the shard "
                "buffers; pass 1-D buffers (flat element layout)")

        def _slice(buf, off, n):
            if off == 0 and n == buf.size:
                return buf
            return buf[off:off + n]

        src_arena, stage_pool = srcbuf, None
        if plan.kind != "noop" and _overlap(srcbuf, dstbuf):
            src_arena, stage_pool = self._stage(srcbuf, run_async)
        handles: list[CallHandle] = []
        with self._retry_scope(retries, retry_policy):
            if src_arena is not srcbuf and src_count:
                handles.append(self.copy(
                    _slice(srcbuf, 0, src_count),
                    _slice(src_arena, 0, src_count), src_count,
                    comm=comm, run_async=True, waitfor=waitfor))
                waitfor = (handles[-1],)
            if plan.kind == "allgather":
                handles.append(self.allgather(
                    _slice(src_arena, 0, src_count), dstbuf,
                    plan.coll_count, comm=comm,
                    compress_dtype=compress_dtype, run_async=True,
                    waitfor=waitfor))
            elif plan.kind == "alltoall":
                handles.append(self.alltoall(
                    _slice(src_arena, 0, src_count),
                    _slice(dstbuf, 0, dst_count), plan.coll_count,
                    comm=comm, compress_dtype=compress_dtype,
                    run_async=True, waitfor=waitfor))
            elif plan.kind == "alltoallv":
                handles.append(self.alltoallv(
                    _slice(src_arena, 0, src_count),
                    _slice(dstbuf, 0, dst_count),
                    plan.send_counts, plan.recv_counts,
                    comm=comm, compress_dtype=compress_dtype,
                    run_async=True, waitfor=waitfor))
            else:
                for st in plan.steps:
                    if st.kind == "send":
                        handles.append(self.send(
                            _slice(src_arena, st.src_off, st.count),
                            st.count, dst=st.peer, comm=comm,
                            compress_dtype=compress_dtype,
                            run_async=True, waitfor=waitfor))
                    elif st.kind == "recv":
                        handles.append(self.recv(
                            _slice(dstbuf, st.dst_off, st.count),
                            st.count, src=st.peer, comm=comm,
                            compress_dtype=compress_dtype,
                            run_async=True, waitfor=waitfor))
                    else:
                        handles.append(self.copy(
                            _slice(src_arena, st.src_off, st.count),
                            _slice(dstbuf, st.dst_off, st.count),
                            st.count, comm=comm, run_async=True,
                            waitfor=waitfor))
        if not run_async:
            wait_all(handles if handles else list(waitfor))
            return CompletedHandle(context="redistribute")
        if not handles:
            # nothing issued (a noop plan): the handle still carries
            # the caller's waitfor ordering
            handles = list(waitfor)
        if not handles:
            return CompletedHandle(context="redistribute")
        if len(handles) == 1:
            ret = handles[0]
        else:
            # no one sub-call is sure to retire last: complete when every
            # one has, with the OR of their error words
            agg = CallHandle(context="redistribute")
            mu = threading.Lock()
            state = {"left": len(handles), "err": 0, "exc": None}

            def _one_done(h):
                def cb(err):
                    with mu:
                        state["err"] |= int(err)
                        if state["exc"] is None \
                                and h._exception is not None:
                            state["exc"] = h._exception
                        state["left"] -= 1
                        done = state["left"] == 0
                    if done:
                        agg.complete(state["err"], exception=state["exc"])
                return cb

            for h in handles:
                h.add_done_callback(_one_done(h))
            ret = agg
        if stage_pool is not None:
            # recycled only once the WHOLE program has retired
            pool, buf = stage_pool, src_arena
            ret.add_done_callback(lambda _err: pool.append(buf))
        return ret

    def bcast(self, buf: ACCLBuffer, count: int | None = None, root: int = 0,
              *, comm: Communicator | None = None,
              algorithm: CollectiveAlgorithm | str = CollectiveAlgorithm.AUTO,
              compress_dtype=None, block_scale: bool | int = False,
              run_async: bool = False, chain: bool = False,
              waitfor: Sequence[CallHandle] = (),
              retries: int | None = None,
              retry_policy: RetryPolicy | None = None) -> CallHandle:
        """In place: root's ``buf`` lands in every other rank's ``buf``
        (the root's stays exact; a wire dtype is a pure cast per hop)."""
        comm = comm or self.comm
        count = count if count is not None else buf.size
        desc = self._prepare(CCLOp.bcast, count=count, comm=comm,
                             root_src_dst=root, op0=buf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale, algorithm=algorithm)
        return self._call(desc, run_async, waitfor, chain, retries,
                          retry_policy)

    def scatter(self, srcbuf: ACCLBuffer | None, dstbuf: ACCLBuffer,
                count: int, root: int = 0, *,
                comm: Communicator | None = None, compress_dtype=None,
                block_scale: bool | int = False, run_async: bool = False,
                chain: bool = False, waitfor: Sequence[CallHandle] = (),
                retries: int | None = None,
                retry_policy: RetryPolicy | None = None) -> CallHandle:
        """count = per-rank chunk size; srcbuf holds world_size*count at
        root (non-root ranks may pass None)."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.scatter, count=count, comm=comm,
                             root_src_dst=root, op0=srcbuf, res=dstbuf,
                             compress_dtype=compress_dtype,
                             block_scale=block_scale)
        return self._call(desc, run_async, waitfor, chain, retries,
                          retry_policy)

    def gather(self, srcbuf: ACCLBuffer, dstbuf: ACCLBuffer | None,
               count: int, root: int = 0, *,
               comm: Communicator | None = None,
               algorithm: CollectiveAlgorithm | str = CollectiveAlgorithm.AUTO,
               compress_dtype=None, block_scale: bool | int = False,
               run_async: bool = False, chain: bool = False,
               waitfor: Sequence[CallHandle] = (),
               retries: int | None = None,
               retry_policy: RetryPolicy | None = None) -> CallHandle:
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
        return self._call(desc, run_async, waitfor, chain, retries,
                          retry_policy)

    def reduce(self, srcbuf: ACCLBuffer, dstbuf: ACCLBuffer | None,
               count: int, root: int = 0, func: ReduceFunc = ReduceFunc.SUM,
               *, comm: Communicator | None = None,
               algorithm: CollectiveAlgorithm | str = CollectiveAlgorithm.AUTO,
               compress_dtype=None, block_scale: bool | int = False,
               run_async: bool = False, chain: bool = False,
               waitfor: Sequence[CallHandle] = (),
               retries: int | None = None,
               retry_policy: RetryPolicy | None = None) -> CallHandle:
        """The reduction of every rank's srcbuf lands in the root's
        dstbuf (non-root ranks may pass None)."""
        comm = comm or self.comm
        if comm.local_rank == root and dstbuf is None:
            raise ValueError("reduce root requires a destination buffer")
        desc = self._prepare(CCLOp.reduce, count=count, comm=comm,
                             root_src_dst=root, func=func, op0=srcbuf,
                             res=dstbuf, compress_dtype=compress_dtype,
                             block_scale=block_scale, algorithm=algorithm)
        return self._call(desc, run_async, waitfor, chain, retries,
                          retry_policy)

    def barrier(self, *, comm: Communicator | None = None,
                waitfor: Sequence[CallHandle] = (),
                retries: int | None = None,
                retry_policy: RetryPolicy | None = None) -> CallHandle:
        """Rendezvous of all ranks of ``comm``."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.barrier, count=0, comm=comm)
        return self._call(desc, False, waitfor, False, retries,
                          retry_policy)

    # -- local and point-to-point operations ----------------------------------
    def copy(self, srcbuf: ACCLBuffer | None, dstbuf: ACCLBuffer | None,
             count: int | None = None, *, comm: Communicator | None = None,
             stream_flags: StreamFlags = StreamFlags.NO_STREAM,
             stream_dtype=None, run_async: bool = False,
             chain: bool = False, waitfor: Sequence[CallHandle] = (),
             retries: int | None = None,
             retry_policy: RetryPolicy | None = None) -> CallHandle:
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
        return self._call(desc, run_async, waitfor, chain, retries,
                          retry_policy)

    def combine(self, count: int, func: ReduceFunc, op0: ACCLBuffer | None,
                op1: ACCLBuffer, res: ACCLBuffer | None, *,
                stream_dtype=None,
                stream_flags: StreamFlags = StreamFlags.NO_STREAM,
                run_async: bool = False, chain: bool = False,
                waitfor: Sequence[CallHandle] = (),
                retries: int | None = None,
                retry_policy: RetryPolicy | None = None) -> CallHandle:
        """res = func(op0, op1) elementwise, on the device (B1). With
        OP0_STREAM the first operand comes from the stream-in port (op0
        may be None); with RES_STREAM the result goes to the stream-out
        port (res may be None)."""
        desc = self._prepare(CCLOp.combine, count=count, comm=self.comm,
                             func=func, op0=op0, op1=op1, res=res,
                             stream_dtype=stream_dtype,
                             stream_flags=stream_flags)
        return self._call(desc, run_async, waitfor, chain, retries,
                          retry_policy)

    def send(self, srcbuf: ACCLBuffer | None, count: int, dst: int,
             tag: int = TAG_ANY, *, comm: Communicator | None = None,
             compress_dtype=None, block_scale: bool | int = False,
             stream_dtype=None,
             stream_flags: StreamFlags = StreamFlags.NO_STREAM,
             run_async: bool = False, chain: bool = False,
             waitfor: Sequence[CallHandle] = (),
             retries: int | None = None,
             retry_policy: RetryPolicy | None = None) -> CallHandle:
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
        return self._call(desc, run_async, waitfor, chain, retries,
                          retry_policy)

    def recv(self, dstbuf: ACCLBuffer | None, count: int, src: int,
             tag: int = TAG_ANY, *, comm: Communicator | None = None,
             compress_dtype=None, block_scale: bool | int = False,
             stream_dtype=None,
             stream_flags: StreamFlags = StreamFlags.NO_STREAM,
             run_async: bool = False, chain: bool = False,
             waitfor: Sequence[CallHandle] = (),
             retries: int | None = None,
             retry_policy: RetryPolicy | None = None) -> CallHandle:
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
        return self._call(desc, run_async, waitfor, chain, retries,
                          retry_policy)

    def stream_put(self, srcbuf: ACCLBuffer, count: int, dst: int,
                   tag: int = TAG_ANY, *, run_async: bool = False,
                   chain: bool = False, waitfor: Sequence[CallHandle] = (),
                   retries: int | None = None,
                   retry_policy: RetryPolicy | None = None) -> CallHandle:
        """Send into rank ``dst``'s stream-in port instead of its receive
        matching (the reference's remote-stream send): no recv is posted
        for it and it consumes no sequence number."""
        desc = self._prepare(CCLOp.send, count=count, comm=self.comm,
                             root_src_dst=dst, tag=tag, op0=srcbuf,
                             stream_flags=StreamFlags.RES_STREAM)
        return self._call(desc, run_async, waitfor, chain, retries,
                          retry_policy)

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
            run_async: bool = False, waitfor: Sequence[CallHandle] = (),
            retries: int | None = None,
            retry_policy: RetryPolicy | None = None) -> CallHandle:
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
        return self._call(desc, run_async, waitfor, False, retries,
                          retry_policy)

    def get(self, dstbuf: ACCLBuffer, count: int, src: int, window: int,
            offset: int = 0, *, comm: Communicator | None = None,
            compress_dtype=None, run_async: bool = False,
            waitfor: Sequence[CallHandle] = (),
            retries: int | None = None,
            retry_policy: RetryPolicy | None = None) -> CallHandle:
        """One-sided read: ``count`` elements from byte ``offset`` of
        window ``window`` on rank ``src`` land in ``dstbuf``; the source
        posts no call."""
        comm = comm or self.comm
        desc = self._prepare(CCLOp.get, count=count, comm=comm,
                             root_src_dst=src, tag=int(window), res=dstbuf,
                             compress_dtype=compress_dtype)
        desc.addr_1 = int(offset)   # byte offset INTO the window
        return self._call(desc, run_async, waitfor, False, retries,
                          retry_policy)

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
