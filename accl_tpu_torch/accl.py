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
(``block_scale=True`` means the tuner's block, ``quant.DEFAULT_BLOCK``
without one; an int is clamped into the legal envelope), on the
ring-shaped collectives, alltoallv and send/recv; the other collectives
then take the full-precision wire, as the reference does. One-sided RMA: ``register_window``, ``deregister_window``,
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

Configuration: ``tuner=`` (:mod:`.tuner`) resolves every ``AUTO``
algorithm of the dense collectives and ``compress_dtype="auto"`` per
(op, world, size) and learns from retire-time measurements;
``configure_hierarchy`` (or a tuner whose topology is a
:class:`~accl_tpu_torch.hier.MeshTopology`) lowers ``HIERARCHICAL``
allreduce, allgather, reduce_scatter and bcast to phase programs over
per-tier sub-communicators (:mod:`.hier`), ``compress_phases=`` picking
the tiers that take the wire compression; ``verify_integrity=``
cross-checks a replicated result's crc32 (:meth:`ACCL.fingerprint_of`)
across the ranks; ``preflight``, ``arith_registry``,
``set_max_segment_size`` and ``plan_cache_stats`` (a stub: this tier
has no plan cache).

Observability: ``start_profiling`` / ``end_profiling`` arm this driver's
:class:`~accl_tpu_torch.tracing.Profiler` (one ``CallRecord`` per
retired call; the phases of a hierarchical program or a redistribute
carry the logical call's tag as ``parent``, beside one logical record);
``start_trace`` / ``stop_trace`` / ``export_trace`` drive the
process-wide flight recorder; ``metrics_text`` is the Prometheus
exposition. ``tenant=`` labels every communicator the driver registers
(the ``tenant`` label of its metric rows, ``CallRecord.tenant``).
Housekeeping: ``open_port``, ``init_connection``, ``close_connections``,
``set_stack_type`` (config calls this tier answers as no-ops) and
``dump_rx_buffers``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
import zlib
from typing import Sequence

import numpy as np
import torch

from . import quant
from .arith import (DEFAULT_ARITH_CONFIGS, dtype_name, resolve_arith_config,
                    to_torch_dtype)
from .buffer import ACCLBuffer
from .call import CallDescriptor, CallHandle, CompletedHandle, wait_all
from .communicator import Communicator, Rank, grown_communicator
from .constants import (ACCLError, CCLOp, CfgFunc, CollectiveAlgorithm,
                        Compression, DEFAULT_ALGORITHMS, ErrorCode,
                        HIERARCHICAL_OPS, ReduceFunc, StreamFlags, TAG_ANY,
                        VALID_ALGORITHMS)
from .device.base import Device
from .log import get_logger
from .retry import RetryPolicy, resolve_policy
from .rma import ANY_WINDOW
from .service import tenant_label, validate_tenant
from .tracing import METRICS, TRACE, CallRecord, Profiler

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


def _phases_strip_flat(compress_phases) -> bool:
    """Validate ``compress_phases`` of a call that runs FLAT and answer
    whether it drops the wire compression: "inter" compresses only the
    phases of a hierarchy that cross a boundary, and a flat call has
    none."""
    if compress_phases in (None, "all"):
        return False
    if compress_phases == "inter":
        return True
    raise ValueError(
        f"compress_phases must be None, 'all' or 'inter', got "
        f"{compress_phases!r}")


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
        max_segment_size: the segment size set at bring-up; None asks the
            tuner against the backend's ``preferred_segment_size()`` (no
            tuner: the preferred size).
        arith_registry: the dtype-pair registry calls resolve against
            (default: a copy of ``DEFAULT_ARITH_CONFIGS``).
        tuner: a :class:`~accl_tpu_torch.tuner.Tuner` resolving AUTO and
            ``compress_dtype="auto"``; the ranks of a world share ONE (all
            members of a collective must agree on its algorithm).
        tenant: a tenant label (:func:`~accl_tpu_torch.service.
            validate_tenant`) grouping every communicator this driver
            registers, for per-tenant metric rows, call records and trace
            tracks. Default: each communicator is its own tenant.
        retry_policy: the driver-wide default :class:`RetryPolicy` of
            every data call (per-call ``retries=`` / ``retry_policy=``
            override it). Must be uniform across a communicator's ranks.
        verify_integrity: cross-check the result fingerprints of every
            synchronous allreduce, allgather and bcast across the ranks
            (per-call ``verify_integrity=`` overrides it). Uniform across
            a communicator's ranks, like the retry policy.
    """

    def __init__(self, device: Device, comm: Communicator,
                 timeout: float = 30.0,
                 max_segment_size: int | None = None,
                 arith_registry=None, tuner=None,
                 tenant: str | None = None,
                 retry_policy: RetryPolicy | None = None,
                 verify_integrity: bool = False):
        self.device = device
        if tenant is not None:
            validate_tenant(tenant)
        self.tenant = tenant
        self.profiler = Profiler()
        self.retry_policy = retry_policy
        self.verify_integrity = bool(verify_integrity)
        self._preflight_warned: set = set()
        self._arith_memo: dict = {}
        self.arith_registry = (arith_registry if arith_registry is not None
                               else dict(DEFAULT_ARITH_CONFIGS))
        self.tuner = tuner
        # the hierarchy: configure_hierarchy(), or derived once from a
        # tuner's MeshTopology on the first AUTO-resolved collective
        self._hier = None
        self._hier_autoprobe = True
        # the barrier's 2-element f32 scratch (its allreduce's operands)
        self._barrier_buf: ACCLBuffer | None = None
        # set while the phases of one logical call (a hierarchy program)
        # are issued: they stay flat and skip their own verification
        self._parent_tag = ""
        # async calls issued and not retired: the tuner learns only on a
        # quiet device
        self._async_mu = threading.Lock()
        self._async_inflight = 0
        # int64 fingerprint exchange buffers (W -> (src, dst)) and the
        # pinned host buffer a device result is read back through
        self._fp_bufs: dict[int, tuple] = {}
        self._fp_host: torch.Tensor | None = None
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
        self._redist_seq = itertools.count(1)
        # one-sided windows this driver registered: id -> buffer
        self._next_window = itertools.count(1)
        self._windows: dict[int, ACCLBuffer] = {}
        # (op name, comm_id) -> calls issued, bytes of their uncompressed
        # operands; read by the metrics collector at snapshot time only
        self._call_counts: dict[tuple, int] = {}
        self._byte_counts: dict[tuple, int] = {}
        METRICS.register_collector(self, ACCL._metrics_rows)
        if tuner is not None:
            if tuner.topology is None:
                tuner.topology = device.topology()
            device.tuner = tuner
            # the env tuning table pins once per tuner, best effort (a
            # missing or stale table is not an error)
            from .tuner import cache as _tcache
            if (_tcache.default_cache_path()
                    and not getattr(tuner, "_env_cache_loaded", False)):
                tuner._env_cache_loaded = True
                try:
                    _tcache.load_into(tuner)
                except (OSError, ValueError):
                    pass
        device.configure_communicator(comm, tenant=tenant)
        self._register_comm(comm)
        # bring-up through the call path, as the reference driver does
        self.set_timeout(timeout)
        self._config_call(CfgFunc.enable_pkt, 1)
        if max_segment_size is None:
            max_segment_size = device.preferred_segment_size()
            if tuner is not None:
                max_segment_size = tuner.recommend_segment_size(
                    max_segment_size)
        self.set_max_segment_size(max_segment_size)

    @property
    def arith_registry(self) -> dict:
        """The dtype-pair registry. Rebinding it drops the resolution
        memo; after mutating it in place call
        :meth:`invalidate_arith_cache`."""
        return self._arith_registry

    @arith_registry.setter
    def arith_registry(self, registry: dict):
        self._arith_registry = registry
        self._arith_memo.clear()

    def invalidate_arith_cache(self):
        """Drop memoized arith-config resolutions (call after mutating
        ``arith_registry`` in place)."""
        self._arith_memo.clear()

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

    def set_max_segment_size(self, nbytes: int):
        self._config_call(CfgFunc.set_max_segment_size, int(nbytes))

    # -- connection housekeeping (config calls; no ports on this tier) ------
    def open_port(self):
        """Arm the fabric listener: a no-op config call here."""
        self._config_call(CfgFunc.open_port, 0)

    def init_connection(self, comm: Communicator | None = None):
        """Open sessions to every peer of ``comm`` (open_port, then
        open_con on that communicator): no-op config calls here, where
        every rank shares one process."""
        comm = comm or self.comm
        self._config_call(CfgFunc.open_port, 0, comm_id=comm.comm_id)
        self._config_call(CfgFunc.open_con, 0, comm_id=comm.comm_id)

    def close_connections(self):
        self._config_call(CfgFunc.close_con, 0)

    def set_stack_type(self, stack: str):
        """Select the transport stack, 'tcp' or 'udp' (a no-op config call
        here; any other name raises KeyError)."""
        code = {"tcp": 0, "udp": 1}[stack]
        self._config_call(CfgFunc.set_stack_type, code)

    # -- profiling, the flight recorder, the exposition ----------------------
    def start_profiling(self):
        """Arm per-call records: the config call through the call path,
        then this driver's profiler."""
        self._config_call(CfgFunc.start_profiling, 0)
        self.profiler.start()

    def end_profiling(self):
        self._config_call(CfgFunc.end_profiling, 0)
        self.profiler.stop()

    def start_trace(self):
        """Arm the process-wide flight recorder
        (:data:`~accl_tpu_torch.tracing.TRACE`); also armed by
        ``ACCL_TPU_TRACE=1``."""
        TRACE.start()

    def stop_trace(self):
        TRACE.stop()

    def export_trace(self, path: str) -> int:
        """Write the flight recorder's rings as Chrome/Perfetto trace-event
        JSON; returns the number of events."""
        return TRACE.export_chrome(path)

    def metrics_text(self) -> str:
        """Prometheus text exposition of :meth:`metrics_snapshot`."""
        return METRICS.to_prometheus()

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

    def _tenant_of(self, comm_id: int) -> str:
        """The tenant of this driver's calls on ``comm_id``: the driver's
        tenant, else the communicator's own."""
        return self.tenant or tenant_label(comm_id)

    def _metrics_rows(self):
        """Collector rows of this driver's per-communicator call
        accounting. ``rank`` keeps one world's drivers apart, ``ctx``
        worlds of the same shape, whose comm ids agree; ``tenant`` is the
        driver's tenant, else the communicator's own ("comm-<id>")."""
        labels = {"rank": self.rank}
        ctx = getattr(self.device, "ctx", None)
        if ctx is not None:
            labels["ctx"] = ctx.seq
        for (op, comm_id), n in list(self._call_counts.items()):
            yield ("counter", "accl_calls_total",
                   dict(labels, op=op, comm_id=comm_id,
                        tenant=self._tenant_of(comm_id)), n)
        for (op, comm_id), n in list(self._byte_counts.items()):
            yield ("counter", "accl_bytes_total",
                   dict(labels, op=op, comm_id=comm_id,
                        tenant=self._tenant_of(comm_id)), n)

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
        self.device.configure_communicator(sub, tenant=self.tenant)
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
        self.device.configure_communicator(sub, tenant=self.tenant)
        self._register_comm(sub)
        METRICS.inc("membership_shrink_total", rank=self.rank)
        if TRACE.enabled:
            TRACE.emit("membership_shrink", rank=self.rank,
                       nbytes=len(survivors), peer=-1)
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
        self.device.configure_communicator(grown, tenant=self.tenant)
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
        if TRACE.enabled:
            TRACE.emit("membership_grow", rank=self.rank,
                       nbytes=len(members), peer=-1)
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

    def dump_rx_buffers(self) -> str:
        """The rx pool's description; this tier has none."""
        pool = getattr(self.device, "pool", None)
        return pool.describe() if pool is not None else "<no rx pool>"

    def plan_cache_stats(self) -> dict:
        """Compiled-plan cache counters of this rank's backend, or the
        ``{"enabled": False}`` stub: this tier compiles no move plans."""
        cache = getattr(self.device, "plan_cache", None)
        if cache is None:
            return {"enabled": False, "entries": 0, "hits": 0, "misses": 0,
                    "bypasses": 0, "evictions": 0, "invalidations": {}}
        return cache.stats()

    # -- configuration checks and the N-tier hierarchy ----------------------
    def preflight(self, count: int, dtype=torch.float32,
                  op: str = "allreduce",
                  comm: Communicator | None = None) -> list[str]:
        """Resource warnings for a planned collective (empty = clear):
        the rx-pool check of a hierarchical lowering, on a backend that
        has an rx pool (``rx_capacity``). This tier parks no phase chunks
        in a finite pool, so it returns ``[]``, as the reference's device
        tier does."""
        comm = comm or self.comm
        nbytes = int(count) * to_torch_dtype(dtype).itemsize
        if comm is not self.comm or op not in HIERARCHICAL_OPS:
            return []
        return self._preflight_hier(op, nbytes)

    def _preflight_hier(self, op: str, nbytes: int) -> list[str]:
        """Price each boundary tier's exchange (blocks of about
        ``nbytes / groups(tier)``) against the backend's rx pool; the
        warning names the offending tier."""
        cap_fn = getattr(self.device, "rx_capacity", None)
        hier = self._hier
        if cap_fn is None or hier is None:
            return []
        nbufs, bufsize = cap_fn()
        pool_bytes = nbufs * bufsize
        warnings = []
        for k, grouping in enumerate(hier.nest):
            n_groups = max(1, len(grouping))
            chunk = -(-nbytes // n_groups)
            if pool_bytes >= 2 * chunk:
                continue
            tier = "inter" if k == 0 else f"inter{k + 1}"
            unit = "hosts" if k == 0 else "groups"
            warnings.append(
                f"rx pool ({nbufs} x {bufsize} B = {pool_bytes} B) cannot "
                f"hold 2 chunks ({2 * chunk} B) of a hierarchical {op} of "
                f"{nbytes} B on tier {tier} ({n_groups} {unit}): expect "
                f"timeout-shaped backpressure — raise nbufs/bufsize or "
                f"split the call")
        return warnings

    def configure_hierarchy(self, hosts: Sequence[int],
                            levels: Sequence[Sequence[int]] = ()):
        """Declare the world's tier structure: ``hosts[r]`` is the host
        id of world rank ``r`` (each host's ranks contiguous), and each
        entry of ``levels`` adds one coarser boundary (rack, pod, ...)
        as another rank->group-id map, innermost-first. Every rank
        configures the same mapping (the sub-communicator ids derive from
        membership, as :meth:`split_communicator`'s do). Returns the
        :class:`~accl_tpu_torch.hier.Hierarchy`."""
        from .hier import Hierarchy
        self._hier = Hierarchy(self, hosts, levels=levels)
        return self._hier

    @property
    def hierarchy(self):
        return self._hier

    def _ensure_hier(self):
        """Configure the hierarchy once from an attached tuner's
        MeshTopology (its coarser ``outer`` boundaries too): the same on
        every rank, since the ranks share the tuner."""
        if self._hier is not None or not self._hier_autoprobe:
            return self._hier
        self._hier_autoprobe = False
        topo = getattr(self.tuner, "topology", None)
        groups = getattr(topo, "groups", None)
        if groups and len(groups) > 1 \
                and sum(len(g) for g in groups) == self.comm.size:
            from .hier import Hierarchy
            if getattr(topo, "outer", ()):
                maps = topo.hosts_levels()
                self._hier = Hierarchy(self, maps[0], levels=maps[1:])
            else:
                self._hier = Hierarchy(self, topo.hosts_list())
        return self._hier

    def _hier_route(self, op: str, comm: Communicator, count: int,
                    elem_bytes: int, algorithm) -> bool:
        """True when this collective lowers to a hierarchical phase
        program instead of a flat descriptor: explicit HIERARCHICAL
        demands a configured hierarchy over the world communicator; AUTO
        routes when the shared tuner's cost model prefers the phase
        program to every flat schedule."""
        if isinstance(algorithm, str):
            algorithm = CollectiveAlgorithm[algorithm.upper()]
        alg = CollectiveAlgorithm(algorithm)
        H = CollectiveAlgorithm.HIERARCHICAL
        if alg == H:
            if self._ensure_hier() is None:
                raise ValueError(
                    "HIERARCHICAL requires a configured hierarchy: call "
                    "configure_hierarchy(hosts) on every rank (or attach "
                    "a tuner whose topology is a MeshTopology)")
            if comm is not self.comm:
                raise ValueError(
                    "hierarchical collectives run over the WORLD "
                    "communicator (the hierarchy's sub-communicators are "
                    "derived from it); got a split communicator")
            self._warn_preflight(op, count * elem_bytes)
            return True
        if (alg != CollectiveAlgorithm.AUTO or self.tuner is None
                or comm is not self.comm or op not in HIERARCHICAL_OPS):
            return False
        if self._parent_tag:
            # inside a logical program already (a hierarchy phase): stay
            # flat, or the phases would be re-chained under another call
            return False
        if self._ensure_hier() is None:
            return False
        routed = self.tuner.select(op, comm.size, count * elem_bytes) == H
        if routed:
            self._warn_preflight(op, count * elem_bytes)
        return routed

    def _warn_preflight(self, op: str, nbytes: int):
        """Log the preflight warnings once per (op, size) at hierarchical
        issue time (:meth:`preflight` is the query form)."""
        key = (op, nbytes)
        if key in self._preflight_warned:
            return
        self._preflight_warned.add(key)
        for w in self._preflight_hier(op, nbytes):
            log.warning("rank %d preflight: %s", self.rank, w,
                        extra={"rank": self.rank})

    @contextlib.contextmanager
    def _attributed(self, tag: str):
        """Scope marking every call issued inside it as a phase of one
        logical call (one driver is used from one thread at a time)."""
        prev = self._parent_tag
        self._parent_tag = tag
        try:
            yield
        finally:
            self._parent_tag = prev

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
    def _resolve_wire(self, op: str, comm: Communicator, count: int,
                      operand_dtype, compress_dtype, block_scale):
        """Resolve ``compress_dtype="auto"``: the tuner prices the
        block-scaled fp8-e4m3 wire against the full-precision one per
        (op, world, size) and picks it in the bandwidth-bound band; a
        latency-bound call, a call without a tuner and a non-f32 call
        stay uncompressed. AUTO algorithm selection alone never changes
        numerics: only the literal "auto" does."""
        if block_scale and compress_dtype is None:
            # _prepare raises this too; a hierarchical lowering never
            # reaches it with the caller's arguments
            raise ValueError(
                "block_scale needs a compress_dtype naming the quantized "
                "wire dtype (int8 / float8_e4m3fn / float8_e5m2)")
        if not (isinstance(compress_dtype, str)
                and compress_dtype == "auto"):
            return compress_dtype, block_scale
        if operand_dtype == torch.float32 and self.tuner is not None \
                and self.tuner.select_wire(op, comm.size,
                                           count * operand_dtype.itemsize):
            return torch.float8_e4m3fn, (block_scale if block_scale
                                         else True)
        return None, False

    def _quant_block_for(self, count: int, elem_bytes: int,
                         block_scale) -> int:
        """The call's scale-block size: an int is clamped into the legal
        envelope; ``True`` asks the tuner (the default block without
        one)."""
        if block_scale is True:
            if self.tuner is not None:
                return self.tuner.recommend_quant_block(count * elem_bytes)
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
        communicator refuses the call with PEER_FAILED. With a tuner, an
        AUTO algorithm of an op the backend lets it resolve
        (``auto_resolvable_ops``) takes the tuner's choice here; one that
        leans HIERARCHICAL (a call no hierarchy route intercepted, such
        as a phase of one) takes the flat default instead."""
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
            cfg = resolve_arith_config(dtypes, self.arith_registry)
            self._arith_memo[mk] = cfg
        if compression & Compression.BLOCK_SCALED:
            qblock = self._quant_block_for(
                count, cfg.uncompressed_dtype.itemsize, block_scale)
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
        algorithm = CollectiveAlgorithm(algorithm)
        if (algorithm == CollectiveAlgorithm.AUTO and self.tuner is not None
                and scenario.name in VALID_ALGORITHMS):
            resolvable = self.device.auto_resolvable_ops()
            if resolvable is None or scenario.name in resolvable:
                algorithm = self.tuner.select(
                    scenario.name, comm.size,
                    count * cfg.uncompressed_dtype.itemsize)
                if algorithm == CollectiveAlgorithm.HIERARCHICAL:
                    algorithm = DEFAULT_ALGORITHMS[scenario.name]
        return CallDescriptor(
            scenario=scenario, count=count, comm_id=comm.comm_id,
            root_src_dst=root_src_dst, function=ReduceFunc(func), tag=tag,
            arithcfg=cfg, compression=compression, stream_flags=stream_flags,
            algorithm=algorithm,
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
        if TRACE.enabled:
            TRACE.emit("call_retry", rank=self.rank, seqn=attempt,
                       nbytes=desc.count, peer=-1)
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
        op = desc.scenario.name
        profiling = self.profiler.enabled and desc.scenario != CCLOp.config
        tunable = (op in VALID_ALGORITHMS
                   and desc.algorithm != CollectiveAlgorithm.AUTO)
        # only a synchronous call without dependencies, issued while no
        # async call of any driver sharing the tuner is in flight, trains
        # it: otherwise the window measures queueing, not the algorithm
        observing = (self.tuner is not None and tunable
                     and not run_async and not waitfor
                     and self._async_inflight == 0
                     and self.tuner.quiescent())
        t0 = time.perf_counter() if (profiling or observing) else 0.0
        if run_async:
            # counted in flight before it launches: a sibling driver must
            # not train on a window this call already inflates
            with self._async_mu:
                self._async_inflight += 1
            if self.tuner is not None:
                self.tuner.note_async_issue()
        try:
            handle = self.device.call_async(desc, waitfor,
                                            inline_ok=not run_async)
        except BaseException:
            if run_async:
                self._async_retired()
            raise
        nb = desc.count * (desc.arithcfg.uncompressed_dtype.itemsize
                           if desc.arithcfg is not None else 0)
        if desc.scenario != CCLOp.config:
            key = (op, desc.comm_id)
            self._call_counts[key] = self._call_counts.get(key, 0) + 1
            if nb:
                self._byte_counts[key] = self._byte_counts.get(key, 0) + nb
        if profiling:
            if tunable:
                alg_label = desc.algorithm.name
            elif op in VALID_ALGORITHMS:
                # an AUTO descriptor: the driver can name the default only
                # where no tuner and no backend resolves it
                alg_label = (DEFAULT_ALGORITHMS[op].name
                             if (self.tuner is None and
                                 self.device.auto_resolvable_ops() is None)
                             else "AUTO")
            else:
                alg_label = ""
            self.profiler.attach(handle, op=op, count=desc.count,
                                 nbytes=nb, comm_id=desc.comm_id, t0=t0,
                                 algorithm=alg_label,
                                 tenant=self._tenant_of(desc.comm_id),
                                 parent=self._parent_tag)
        if observing:
            # the issue-to-retire window back to the tuner, per algorithm
            # and per wire variant
            tuner = self.tuner
            world = self.comm_of(desc.comm_id).size
            nbytes = desc.count * desc.arithcfg.uncompressed_dtype.itemsize
            alg = desc.algorithm
            quantized = bool(desc.compression & Compression.BLOCK_SCALED)

            def _feed(error_word: int, _t0=t0):
                dt = time.perf_counter() - _t0
                tuner.observe(op, world, nbytes, alg, dt, error_word)
                tuner.observe_wire(op, world, nbytes, quantized, dt,
                                   error_word)

            handle.add_done_callback(_feed)
        if run_async:
            comm_id = desc.comm_id

            def _retired(err):
                self._async_retired()
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

    def _async_retired(self):
        with self._async_mu:
            self._async_inflight -= 1
        if self.tuner is not None:
            self.tuner.note_async_retire()

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

    # -- result integrity: cross-rank fingerprints -------------------------
    def _want_verify(self, explicit: bool | None, run_async: bool,
                     compressing: bool = False) -> bool:
        """Per-call ``verify_integrity=`` over the driver default, for
        synchronous calls only (the check is a follow-up collective on
        the calling thread): an explicit request on an async call raises,
        the default skips it. A wire-compressed call is excluded the same
        way, since lossy narrowing legitimately leaves the result bytes of
        a bcast root and its receivers apart. The phases of a
        hierarchical program are never verified one by one: the logical
        call verifies its result once."""
        if explicit is None and self._parent_tag:
            return False
        want = self.verify_integrity if explicit is None else bool(explicit)
        if not want:
            return False
        if compressing:
            if explicit:
                raise ValueError(
                    "verify_integrity cannot cover a compress_dtype "
                    "call: lossy wire narrowing makes result bytes "
                    "legitimately differ across ranks (the root/owner "
                    "keeps original precision), so a fingerprint "
                    "mismatch would not mean corruption")
            return False
        if run_async:
            if explicit:
                raise ValueError(
                    "verify_integrity requires a synchronous call (the "
                    "fingerprint exchange is a follow-up collective on "
                    "the calling thread); wait the handle and verify "
                    "via a sync call, or use the driver-wide default")
            return False
        return True

    def fingerprint_of(self, buf: ACCLBuffer, nelems: int | None = None
                       ) -> int:
        """crc32 of the raw bytes of the first ``nelems`` elements of a
        result buffer (the reference's fingerprint for the same bytes).
        A device tensor is read back once, into a pinned host buffer this
        driver keeps (grown to the largest result verified)."""
        flat = buf.storage.reshape(-1)
        if nelems is not None:
            flat = flat[:nelems]
        raw = flat.view(torch.uint8)
        if raw.device.type != "cpu":
            n = raw.numel()
            if self._fp_host is None or self._fp_host.numel() < n:
                self._fp_host = torch.empty(n, dtype=torch.uint8,
                                            pin_memory=True)
            host = self._fp_host[:n]
            host.copy_(raw)         # synchronous: after the result's work
            raw = host
        return zlib.crc32(raw.numpy()) & 0xFFFFFFFF

    def _verify_result(self, op: str, buf: ACCLBuffer, nelems: int,
                       comm: Communicator):
        """Allgather every rank's result fingerprint and compare: a
        disagreement means some rank's RESULT bytes differ (local
        corruption no wire check sees) and raises DATA_INTEGRITY_ERROR
        naming the minority rank(s), or every rank when no strict
        majority exists. Never retried."""
        fp = self.fingerprint_of(buf, nelems)
        W = comm.size
        bufs = self._fp_bufs.get(W)
        if bufs is None:
            bufs = self._fp_bufs[W] = (self.buffer((1,), torch.int64),
                                       self.buffer((W,), torch.int64))
        src, dst = bufs
        src.storage[0] = fp
        self.allgather(src, dst, 1, comm=comm, verify_integrity=False)
        fps = dst.data[:W].copy()
        if TRACE.enabled:
            TRACE.emit("fingerprint", rank=self.rank, seqn=comm.comm_id,
                       peer=-1, nbytes=int(fp))
        if (fps == fp).all():
            METRICS.inc("integrity_verified_total", op=op,
                        comm_id=comm.comm_id, rank=self.rank)
            return
        vals, counts = np.unique(fps, return_counts=True)
        if counts.max() * 2 > W:
            majority = vals[counts.argmax()]
            bad = [r for r in range(W) if fps[r] != majority]
            what = f"rank(s) {bad} disagree"
        else:
            # no strict majority (always so at W=2): name every rank
            bad = list(range(W))
            what = (f"no majority fingerprint — the split is "
                    f"undecidable, any of rank(s) {bad} may hold the "
                    f"corrupt result")
        METRICS.inc("integrity_mismatch_total", op=op,
                    comm_id=comm.comm_id, rank=self.rank)
        log.error(
            "rank %d: %s result fingerprint mismatch on comm %d — "
            "%s (fingerprints %s). Local data "
            "corruption: NOT retried (a re-execution could mask it).",
            self.rank, op, comm.comm_id, what, [int(f) for f in fps],
            extra={"rank": self.rank})
        raise ACCLError(
            int(ErrorCode.DATA_INTEGRITY_ERROR),
            f"{op} on comm {comm.comm_id}: result fingerprint "
            f"mismatch — {what}")

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
                  compress_phases=None,
                  run_async: bool = False, chain: bool = False,
                  waitfor: Sequence[CallHandle] = (),
                  retries: int | None = None,
                  retry_policy: RetryPolicy | None = None,
                  verify_integrity: bool | None = None) -> CallHandle:
        """count = per-rank chunk; dstbuf holds world_size*count."""
        comm = comm or self.comm
        compress_dtype, block_scale = self._resolve_wire(
            "allgather", comm, count,
            srcbuf.dtype if srcbuf.dtype == dstbuf.dtype else None,
            compress_dtype, block_scale)
        routed = self._hier_route(
            "allgather", comm, count,
            max(srcbuf.dtype.itemsize, dstbuf.dtype.itemsize), algorithm)
        if not routed and _phases_strip_flat(compress_phases):
            compress_dtype, block_scale = None, False
        verify = self._want_verify(verify_integrity, run_async,
                                   compress_dtype is not None)
        if routed:
            with self._retry_scope(retries, retry_policy):
                handle = self._hier.run(
                    "allgather", count=count, src=srcbuf, dst=dstbuf,
                    compress_dtype=compress_dtype, block_scale=block_scale,
                    compress_phases=compress_phases, run_async=run_async,
                    waitfor=waitfor)
        else:
            desc = self._prepare(CCLOp.allgather, count=count, comm=comm,
                                 op0=srcbuf, res=dstbuf,
                                 compress_dtype=compress_dtype,
                                 block_scale=block_scale,
                                 algorithm=algorithm)
            handle = self._call(desc, run_async, waitfor, chain, retries,
                                retry_policy)
        if verify:
            # the replicated result is the whole gathered vector
            self._verify_result("allgather", dstbuf, count * comm.size,
                                comm)
        return handle

    def allreduce(self, srcbuf: ACCLBuffer, dstbuf: ACCLBuffer, count: int,
                  func: ReduceFunc = ReduceFunc.SUM, *,
                  comm: Communicator | None = None,
                  algorithm: CollectiveAlgorithm | str = (
                      CollectiveAlgorithm.AUTO),
                  compress_dtype=None, block_scale: bool | int = False,
                  compress_phases=None,
                  run_async: bool = False, chain: bool = False,
                  waitfor: Sequence[CallHandle] = (),
                  retries: int | None = None,
                  retry_policy: RetryPolicy | None = None,
                  verify_integrity: bool | None = None) -> CallHandle:
        """``compress_dtype`` names the wire dtype; with ``block_scale``
        the wire is block-scale quantized: per-block scales, f32
        accumulation, fresh scales on every hop. ``compress_dtype="auto"``
        lets the tuner pick the quantized wire in the bandwidth-bound
        band. ``compress_phases="inter"`` applies the wire compression
        only to the phases of a HIERARCHICAL lowering that cross a
        boundary; a flat call with "inter" runs uncompressed."""
        comm = comm or self.comm
        compress_dtype, block_scale = self._resolve_wire(
            "allreduce", comm, count,
            srcbuf.dtype if srcbuf.dtype == dstbuf.dtype else None,
            compress_dtype, block_scale)
        routed = self._hier_route(
            "allreduce", comm, count,
            max(srcbuf.dtype.itemsize, dstbuf.dtype.itemsize), algorithm)
        if not routed and _phases_strip_flat(compress_phases):
            # stripped BEFORE the verify decision: a flat "inter" call
            # runs uncompressed, where verification is valid
            compress_dtype, block_scale = None, False
        verify = self._want_verify(verify_integrity, run_async,
                                   compress_dtype is not None)
        if routed:
            with self._retry_scope(retries, retry_policy):
                handle = self._hier.run(
                    "allreduce", count=count, src=srcbuf, dst=dstbuf,
                    func=func, compress_dtype=compress_dtype,
                    block_scale=block_scale, compress_phases=compress_phases,
                    run_async=run_async, waitfor=waitfor)
        else:
            desc = self._prepare(CCLOp.allreduce, count=count, comm=comm,
                                 func=func, op0=srcbuf, res=dstbuf,
                                 compress_dtype=compress_dtype,
                                 block_scale=block_scale,
                                 algorithm=algorithm)
            handle = self._call(desc, run_async, waitfor, chain, retries,
                                retry_policy)
        if verify:
            self._verify_result("allreduce", dstbuf, count, comm)
        return handle

    def reduce_scatter(self, srcbuf: ACCLBuffer, dstbuf: ACCLBuffer,
                       count: int, func: ReduceFunc = ReduceFunc.SUM, *,
                       comm: Communicator | None = None,
                       algorithm: CollectiveAlgorithm | str = (
                           CollectiveAlgorithm.AUTO),
                       compress_dtype=None, block_scale: bool | int = False,
                       compress_phases=None,
                       run_async: bool = False, chain: bool = False,
                       waitfor: Sequence[CallHandle] = (),
                       retries: int | None = None,
                       retry_policy: RetryPolicy | None = None
                       ) -> CallHandle:
        """count = per-rank chunk; srcbuf holds world_size*count."""
        comm = comm or self.comm
        compress_dtype, block_scale = self._resolve_wire(
            "reduce_scatter", comm, count,
            srcbuf.dtype if srcbuf.dtype == dstbuf.dtype else None,
            compress_dtype, block_scale)
        if self._hier_route(
                "reduce_scatter", comm, count,
                max(srcbuf.dtype.itemsize, dstbuf.dtype.itemsize),
                algorithm):
            with self._retry_scope(retries, retry_policy):
                return self._hier.run(
                    "reduce_scatter", count=count, src=srcbuf, dst=dstbuf,
                    func=func, compress_dtype=compress_dtype,
                    block_scale=block_scale, compress_phases=compress_phases,
                    run_async=run_async, waitfor=waitfor)
        if _phases_strip_flat(compress_phases):
            compress_dtype, block_scale = None, False
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
        compress_dtype, block_scale = self._resolve_wire(
            "alltoallv", comm, count,
            srcbuf.dtype if srcbuf.dtype == dstbuf.dtype else None,
            compress_dtype, block_scale)
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
        tag = f"redist#{next(self._redist_seq)}"
        key = ("redistribute", comm.comm_id)
        self._call_counts[key] = self._call_counts.get(key, 0) + 1
        nbytes_global = src_spec.n * srcbuf.dtype.itemsize
        METRICS.inc("reshard_total", rank=self.rank, kind=plan.kind)
        METRICS.inc("reshard_bytes_total", nbytes_global, rank=self.rank)
        if TRACE.enabled:
            TRACE.emit("reshard", rank=self.rank, nbytes=nbytes_global,
                       peer=-1)
        t0 = time.perf_counter()
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
        with self._retry_scope(retries, retry_policy), \
                self._attributed(tag):
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
            if self.profiler.enabled:
                # the logical record: its phases carry the same tag
                self.profiler.record(CallRecord(
                    op="redistribute", count=src_spec.n,
                    nbytes=nbytes_global, comm_id=comm.comm_id,
                    t_start=t0, duration_s=time.perf_counter() - t0,
                    algorithm=plan.kind.upper(), parent=tag,
                    tenant=self._tenant_of(comm.comm_id)))
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
              compress_phases=None,
              run_async: bool = False, chain: bool = False,
              waitfor: Sequence[CallHandle] = (),
              retries: int | None = None,
              retry_policy: RetryPolicy | None = None,
              verify_integrity: bool | None = None) -> CallHandle:
        """In place: root's ``buf`` lands in every other rank's ``buf``
        (the root's stays exact; a wire dtype is a pure cast per hop)."""
        comm = comm or self.comm
        count = count if count is not None else buf.size
        compress_dtype, block_scale = self._resolve_wire(
            "bcast", comm, count, buf.dtype, compress_dtype, block_scale)
        routed = self._hier_route("bcast", comm, count, buf.dtype.itemsize,
                                  algorithm)
        if not routed and _phases_strip_flat(compress_phases):
            compress_dtype, block_scale = None, False
        verify = self._want_verify(verify_integrity, run_async,
                                   compress_dtype is not None)
        if routed:
            with self._retry_scope(retries, retry_policy):
                handle = self._hier.run(
                    "bcast", count=count, src=buf, root=root,
                    compress_dtype=compress_dtype, block_scale=block_scale,
                    compress_phases=compress_phases, run_async=run_async,
                    waitfor=waitfor)
        else:
            desc = self._prepare(CCLOp.bcast, count=count, comm=comm,
                                 root_src_dst=root, op0=buf,
                                 compress_dtype=compress_dtype,
                                 block_scale=block_scale,
                                 algorithm=algorithm)
            handle = self._call(desc, run_async, waitfor, chain, retries,
                                retry_policy)
        if verify:
            self._verify_result("bcast", buf, count, comm)
        return handle

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
        """Rendezvous of all ranks of ``comm``: a 1-element allreduce on a
        scratch buffer, accounted as an ``allreduce`` in the call counts
        and the profiler's records, as in the reference."""
        comm = comm or self.comm
        if self._barrier_buf is None:
            self._barrier_buf = self.buffer((2,), torch.float32)
        buf = self._barrier_buf
        desc = self._prepare(CCLOp.allreduce, count=1, comm=comm,
                             op0=buf[0:1], res=buf[1:2])
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
