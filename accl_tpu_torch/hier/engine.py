"""Hierarchical N-tier collectives: driver-level phase programs.

The port of ``accl_tpu/hier/engine.py``: the planner is the reference's,
field for field (``tests/test_torch_hier.py``); the engine binds its
phases to torch buffers, and its scratch is device-resident when the
call's operands are (a host-mirror scratch would cost two pageable
copies a phase on the card).

``CollectiveAlgorithm.HIERARCHICAL`` is not a move expansion — it is a
short program of FLAT collectives over sub-communicators, chained
through the existing async ``waitfor=`` path (each phase is admitted as
an ordinary call, so every phase rides the compiled-plan cache and the
streamed executor exactly like a user call). The lowering RECURSES over
a nest of contiguous groupings (host / rack / pod, innermost-first);
with a single grouping it reproduces the historical two-tier programs
byte-for-byte:

* **allreduce**, index-aligned groups (equal group size ``L`` dividing
  the count): ``reduce_scatter(inner) -> allreduce(outer_j) ->
  allgather(inner)`` — only ``n/L`` bytes cross the slow tier, and the
  ``L`` outer communicators (one per intra-group index ``j``) cross it
  CONCURRENTLY on disjoint pair links. The ``outer_j`` exchange is
  itself lowered recursively against the next coarser grouping, so an
  N-tier nest descends with reduce_scatter, exchanges once at the top
  tier, and ascends with allgather — each level moving ``1/L_level`` of
  the bytes of the one below. Uneven groups fall back (per level) to
  the leader shape ``reduce(inner) -> allreduce(leaders) ->
  bcast(inner)``.
* **bcast**: ``bcast(one representative per group) -> bcast(inner)``,
  the representative exchange again lowered recursively — the payload
  crosses each boundary once per group instead of once per rank.
* **allgather**: ``gather(inner->leader)`` ascending the nest, a top
  exchange of subtree blocks (allgather when equal, rotated
  point-to-point otherwise), then full-vector ``bcast(inner)``
  descending.
* **reduce_scatter**: ``reduce(inner->leader)`` ascending, a top
  ``reduce_scatter(leaders)`` (uneven: ``allreduce(leaders)``), then
  ``scatter(inner)`` descending.

The planner (:func:`plan_phases`) is pure — (op, nest, rank, count,
root) in, the rank's :class:`Phase` list out — so
the reference's ``scripts/check_blocking.py`` replays the exact programs
the engine issues, and the engine itself stays a thin buffer-binding
loop.

Phase ALGORITHM selection: with a
:class:`~accl_tpu.hier.topology.MeshTopology` available (the attached
tuner's), each phase gets an explicit flat algorithm ranked against its
OWN tier's link figures (``rank_algorithms`` on the tier's one-tier
Topology — the tier is the number of nest boundaries the phase's
members span) — deterministic across ranks, because every member
computes it from the same inputs. Without one, phases carry AUTO (the
static defaults; a tuner can never resolve a phase back to HIERARCHICAL
— the cost models price sub-mesh calls flat, and the engine/driver
guards besides).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Sequence

import torch

from ..call import CompletedHandle
from ..constants import (CollectiveAlgorithm, HIERARCHICAL_OPS, ReduceFunc,
                         VALID_ALGORITHMS)
from ..tracing import METRICS
from ..tuner.cost import rank_algorithms
from .topology import MeshTopology, groups_from_hosts, validate_nest

__all__ = ["Phase", "HierPlan", "plan_phases", "phase_tier_level",
           "Hierarchy"]

# split keys reserved for hierarchy sub-communicators (disambiguates
# their comm_ids from user splits over the same memberships)
KEY_INNER = 0x48E50
KEY_OUTER = 0x48E51
KEY_LEADERS = 0x48E52
KEY_REPS = 0x48E53

# default threshold for compress_phases="slow": tiers whose per-link
# beta falls below this quantize, faster tiers stay full-precision
SLOW_TIER_BETA_GBPS = 1.0


@dataclasses.dataclass(frozen=True)
class Phase:
    """One flat sub-call of a hierarchical program, for ONE rank.

    ``members`` is the sub-communicator membership in comm-rank order
    (world ranks); ``root`` is comm-LOCAL — for send/recv it is the
    comm-local PEER instead. ``src``/``dst`` are ``(role, elem_offset,
    elem_len)`` buffer bindings (len 0 = the whole role buffer): roles
    ``op0``/``res`` are the user call's buffers, everything else is an
    engine scratch sized by :attr:`HierPlan.scratch`.
    """

    scenario: str               # driver method name: "reduce_scatter", ...
    members: tuple[int, ...]
    count: int
    key: int
    root: int = 0
    src: tuple | None = None    # (role, off, len)
    dst: tuple | None = None
    uses_func: bool = False     # carries the call's ReduceFunc
    label: str = ""             # attribution tag ("inner-rs", "outer-ar")


@dataclasses.dataclass(frozen=True)
class HierPlan:
    mode: str                        # "aligned" | "leader" | op-specific
    phases: tuple[Phase, ...]        # THIS rank's phases, program order
    scratch: dict                    # role -> elem count (engine-allocated)


def _hostmap(groups) -> dict[int, int]:
    return {r: h for h, g in enumerate(groups) for r in g}


def _level_key(base: int, level: int) -> int:
    """Per-level split key: coarser levels shift to a fresh key block,
    so a deep nest's sub-communicators never collide with the two-tier
    ids (or each other) over equal memberships."""
    return base + level * 0x10000


def _role(name: str, level: int) -> str:
    """Scratch role name: level 0 keeps the historical bare names (the
    reference's role/address corpus and scratch-size pins); coarser
    frames suffix with their level."""
    return name if level == 0 else f"{name}_{level}"


def phase_tier_level(members, nest) -> int:
    """Tier index of a phase: the number of nest boundaries its members
    span (0 = intra-group, 1 = the host boundary, 2 = rack, ...). Pure
    in (members, nest), so every rank of the phase derives the same
    tier without a handshake."""
    lvl = 0
    for grouping in nest:
        gm = _hostmap(grouping)
        if len({gm[r] for r in members}) > 1:
            lvl += 1
    return lvl


class _Planner:
    """One rank's recursive lowering. Pure state driven by
    :func:`plan_phases`: appends :class:`Phase` entries in program
    order and accumulates scratch sizes."""

    def __init__(self, nest, me: int, total: int):
        self.nest = nest            # groupings innermost-first
        self.me = me
        self.total = total          # full result length in elements
        self.phases: list[Phase] = []
        self.scratch: dict = {}

    def restrict(self, level: int, members):
        """``members`` split by ``nest[level]`` (member order kept —
        contiguity of the groupings keeps each part a consecutive run).
        ``None`` when the level does not exist or does not split them
        (a strictly-coarsening nest cannot re-split deeper)."""
        if level >= len(self.nest):
            return None
        gm = _hostmap(self.nest[level])
        out: list[list[int]] = []
        cur = None
        for r in members:
            gid = gm[r]
            if gid != cur:
                out.append([])
                cur = gid
            out[-1].append(r)
        if len(out) < 2:
            return None
        return tuple(tuple(g) for g in out)

    # -- allreduce ----------------------------------------------------------
    def ar(self, M, count, level, src, dst, base_key, base_label) -> str:
        """Lower allreduce over ``M`` (inputs bound at ``src``, result
        at ``dst``); returns the shape taken at THIS level."""
        me = self.me
        G = self.restrict(level, M)
        if G is None:
            self.phases.append(Phase("allreduce", M, count, base_key,
                                     src=src, dst=dst, uses_func=True,
                                     label=base_label))
            return "flat"
        g = next(grp for grp in G if me in grp)
        sizes = {len(grp) for grp in G}
        aligned = len(sizes) == 1
        L = max(sizes)
        pre = "inner" if level == 0 else f"l{level}"
        if aligned and L > 1 and count % L == 0:
            j = g.index(me)
            m = count // L
            outer_j = tuple(grp[j] for grp in G)
            s1, s2 = _role("s1", level), _role("s2", level)
            self.phases.append(Phase("reduce_scatter", g, m,
                                     _level_key(KEY_INNER, level),
                                     src=src, dst=(s1, 0, 0),
                                     uses_func=True, label=f"{pre}-rs"))
            self.scratch[s1] = m
            self.scratch[s2] = m
            self.ar(outer_j, m, level + 1, (s1, 0, 0), (s2, 0, 0),
                    _level_key(KEY_OUTER, level), "outer-ar")
            self.phases.append(Phase("allgather", g, m,
                                     _level_key(KEY_INNER, level),
                                     src=(s2, 0, 0), dst=dst,
                                     label=f"{pre}-ag"))
            return "aligned"
        sn = _role("sn", level)
        self.phases.append(Phase("reduce", g, count,
                                 _level_key(KEY_INNER, level), root=0,
                                 src=src,
                                 dst=(sn, 0, 0) if me == g[0] else None,
                                 uses_func=True, label=f"{pre}-reduce"))
        if me == g[0]:
            self.scratch[sn] = count
            leaders = tuple(grp[0] for grp in G)
            self.ar(leaders, count, level + 1, (sn, 0, 0), dst,
                    _level_key(KEY_LEADERS, level), "leader-ar")
        if len(g) > 1:
            self.phases.append(Phase("bcast", g, count,
                                     _level_key(KEY_INNER, level), root=0,
                                     src=dst, label=f"{pre}-bcast"))
        return "leader"

    # -- bcast --------------------------------------------------------------
    def bc(self, M, count, level, root_rank, base_key, base_label):
        me = self.me
        G = self.restrict(level, M)
        if G is None:
            if len(M) > 1:
                self.phases.append(Phase("bcast", M, count, base_key,
                                         root=M.index(root_rank),
                                         src=("op0", 0, 0),
                                         label=base_label))
            return
        g = next(grp for grp in G if me in grp)
        # a group's representative is the root itself when the root is
        # inside it (so the root is ALWAYS its own subtree's rep, at
        # every level of the nest), else the group's first rank
        reps = tuple(root_rank if root_rank in grp else grp[0]
                     for grp in G)
        pre = "inner" if level == 0 else f"l{level}"
        if me in reps:
            self.bc(reps, count, level + 1, root_rank,
                    _level_key(KEY_REPS, level), "outer-bcast")
        if len(g) > 1:
            rep = root_rank if root_rank in g else g[0]
            self.phases.append(Phase("bcast", g, count,
                                     _level_key(KEY_INNER, level),
                                     root=g.index(rep), src=("op0", 0, 0),
                                     label=f"{pre}-bcast"))

    # -- allgather ----------------------------------------------------------
    def ag(self, M, level, blocks, base_key):
        """Each member of ``M`` owns one contiguous block of the result
        (``blocks``: (elem_off, elem_len) parallel to ``M``, ascending
        and gapless over the full vector); afterwards every rank below
        ``M`` holds the full vector in ``res``."""
        me = self.me
        i = M.index(me)
        off, ln = blocks[i]
        G = self.restrict(level, M)
        # descending a level needs an in-group gather, which needs equal
        # member blocks within each group; otherwise exchange the blocks
        # of M directly here (the remaining structure treated flat —
        # exactly the two-tier uneven fallback, generalized)
        feasible = G is not None and all(
            len({blocks[M.index(r)][1] for r in grp}) == 1 for grp in G)
        if not feasible:
            if len({b[1] for b in blocks}) == 1:
                self.phases.append(Phase("allgather", M, ln, base_key,
                                         src=("res", off, ln),
                                         dst=("res", 0, 0),
                                         label="leader-ag"))
            else:
                # rotated point-to-point block exchange: eager sends
                # first (they complete on emission — no rendezvous),
                # the matching recvs after
                n = len(M)
                for step in range(1, n):
                    to = (i + step) % n
                    self.phases.append(Phase("send", M, ln, base_key,
                                             root=to,
                                             src=("res", off, ln),
                                             label="leader-send"))
                for step in range(1, n):
                    frm = (i - step) % n
                    foff, fln = blocks[frm]
                    self.phases.append(Phase("recv", M, fln, base_key,
                                             root=frm,
                                             dst=("res", foff, fln),
                                             label="leader-recv"))
            return
        g = next(grp for grp in G if me in grp)
        pre = "inner" if level == 0 else f"l{level}"
        goff = blocks[M.index(g[0])][0]
        glen = sum(blocks[M.index(r)][1] for r in g)
        self.phases.append(Phase(
            "gather", g, ln, _level_key(KEY_INNER, level), root=0,
            src=(("op0", 0, 0) if level == 0 else ("res", off, ln)),
            dst=(("res", goff, glen) if me == g[0] else None),
            label=f"{pre}-gather"))
        if me == g[0]:
            leaders = tuple(grp[0] for grp in G)
            gblocks = tuple(
                (blocks[M.index(grp[0])][0],
                 sum(blocks[M.index(r)][1] for r in grp))
                for grp in G)
            self.ag(leaders, level + 1, gblocks,
                    _level_key(KEY_LEADERS, level))
        if len(g) > 1:
            self.phases.append(Phase("bcast", g, self.total,
                                     _level_key(KEY_INNER, level), root=0,
                                     src=("res", 0, 0),
                                     label=f"{pre}-bcast"))

    # -- reduce_scatter -----------------------------------------------------
    def rs(self, M, level, src, blocks, out, base_key):
        """Each member of ``M`` holds the full partial vector in its
        ``src`` binding; afterwards member r's block is reduced and
        delivered to its return binding (``out`` at the user-facing
        level, a scratch at coarser frames). Returns MY block's
        binding."""
        me = self.me
        i = M.index(me)
        off, ln = blocks[i]
        G = self.restrict(level, M)
        # the descending scatter needs equal member blocks within each
        # group; otherwise exchange here over M, treated flat
        feasible = G is not None and all(
            len({blocks[M.index(r)][1] for r in grp}) == 1 for grp in G)
        if not feasible:
            if len({b[1] for b in blocks}) == 1:
                sb = _role("sb", max(level - 1, 0))
                self.phases.append(Phase("reduce_scatter", M, ln,
                                         base_key, src=src,
                                         dst=(sb, 0, 0), uses_func=True,
                                         label="leader-rs"))
                self.scratch[sb] = ln
                return (sb, 0, 0)
            sn2 = _role("sn2", max(level - 1, 0))
            self.phases.append(Phase("allreduce", M, self.total,
                                     base_key, src=src, dst=(sn2, 0, 0),
                                     uses_func=True, label="leader-ar"))
            self.scratch[sn2] = self.total
            return (sn2, off, ln)
        g = next(grp for grp in G if me in grp)
        pre = "inner" if level == 0 else f"l{level}"
        sn = _role("sn", level)
        self.phases.append(Phase("reduce", g, self.total,
                                 _level_key(KEY_INNER, level), root=0,
                                 src=src,
                                 dst=(sn, 0, 0) if me == g[0] else None,
                                 uses_func=True, label=f"{pre}-reduce"))
        blk = None
        if me == g[0]:
            self.scratch[sn] = self.total
            leaders = tuple(grp[0] for grp in G)
            gblocks = tuple(
                (blocks[M.index(grp[0])][0],
                 sum(blocks[M.index(r)][1] for r in grp))
                for grp in G)
            blk = self.rs(leaders, level + 1, (sn, 0, 0), gblocks, None,
                          _level_key(KEY_LEADERS, level))
        if out is not None:
            dstb = out
        else:
            sc = _role("sc", level)
            self.scratch[sc] = ln
            dstb = (sc, 0, 0)
        self.phases.append(Phase("scatter", g, ln,
                                 _level_key(KEY_INNER, level), root=0,
                                 src=blk, dst=dstb,
                                 label=f"{pre}-scatter"))
        return dstb


def plan_phases(op: str, groups, me: int, count: int,
                root: int = 0, nest=()) -> HierPlan | None:
    """Compile one rank's hierarchical phase program.

    ``groups``: contiguous host groups (:func:`groups_from_hosts`);
    ``nest``: optional COARSER groupings above it, innermost-first
    (each a tuple of rank tuples — rack, pod, ...), validated as a
    strict contiguous coarsening chain. With ``nest=()`` the lowering
    is the historical two-tier program, byte-for-byte.
    ``count`` follows the driver's per-op convention (total elements for
    allreduce/bcast, per-rank chunk for allgather/reduce_scatter).
    Returns ``None`` when the hierarchy is degenerate (fewer than two
    hosts) — the caller should fall back to a flat call.
    """
    groups = tuple(tuple(g) for g in groups)
    H = len(groups)
    if H < 2:
        return None
    if op not in HIERARCHICAL_OPS:
        raise ValueError(f"{op} has no hierarchical lowering "
                         f"(HIERARCHICAL_OPS: {sorted(HIERARCHICAL_OPS)})")
    full_nest = (groups,) + tuple(
        tuple(tuple(g) for g in grouping) for grouping in nest)
    if len(full_nest) > 1:
        validate_nest(full_nest)
    W = sum(len(g) for g in groups)
    ranks = tuple(range(W))
    top_spans = {len(g) for g in full_nest[-1]}

    if op == "allreduce":
        p = _Planner(full_nest, me, count)
        mode = p.ar(ranks, count, 0, ("op0", 0, 0), ("res", 0, 0),
                    KEY_OUTER, "outer-ar")
        return HierPlan(mode, tuple(p.phases), p.scratch)

    if op == "bcast":
        p = _Planner(full_nest, me, count)
        p.bc(ranks, count, 0, root, KEY_REPS, "outer-bcast")
        return HierPlan("reps", tuple(p.phases), p.scratch)

    if op == "allgather":
        p = _Planner(full_nest, me, W * count)
        blocks = tuple((r * count, count) for r in ranks)
        p.ag(ranks, 0, blocks, KEY_LEADERS)
        return HierPlan("aligned" if len(top_spans) == 1 else "p2p",
                        tuple(p.phases), p.scratch)

    if op == "reduce_scatter":
        p = _Planner(full_nest, me, W * count)
        blocks = tuple((r * count, count) for r in ranks)
        p.rs(ranks, 0, ("op0", 0, 0), blocks, ("res", 0, 0), KEY_LEADERS)
        return HierPlan("aligned" if len(top_spans) == 1 else "leader",
                        tuple(p.phases), p.scratch)

    raise AssertionError(op)




class Hierarchy:
    """One driver's tier structure: nested groups + cached sub-comms.

    Built by ``ACCL.configure_hierarchy(hosts, levels=...)`` (or
    auto-configured from an attached tuner's MeshTopology — including
    its coarser ``outer`` boundaries). All ranks of the world must
    configure the SAME mapping — sub-communicator ids are derived
    deterministically from membership, so members agree without a
    handshake, exactly like ``split_communicator``.
    """

    def __init__(self, accl, hosts, levels=()):
        self.accl = accl
        self.hosts = list(hosts)
        self.groups = groups_from_hosts(self.hosts)
        if len(self.hosts) != accl.comm.size:
            raise ValueError(
                f"hierarchy maps {len(self.hosts)} ranks but the world "
                f"communicator has {accl.comm.size}")
        if len(self.groups) < 2:
            raise ValueError(
                "hierarchy needs at least two hosts — a one-host world "
                "is the flat (degenerate one-tier) case")
        self.levels = [list(lv) for lv in levels]
        for lv in self.levels:
            if len(lv) != accl.comm.size:
                raise ValueError(
                    f"hierarchy level maps {len(lv)} ranks but the "
                    f"world communicator has {accl.comm.size}")
        self.nest = (self.groups,) + tuple(
            groups_from_hosts(lv) for lv in self.levels)
        if len(self.nest) > 1:
            validate_nest(self.nest)
        self._subcomms: dict = {}
        self._scratch: dict = {}
        # recycled private scratch SETS for async programs (see
        # _scratch_buf): popped by the (single) driver thread at issue,
        # appended back by the completion callback
        self._async_scratch_pool: list = []
        self._seq = itertools.count(1)
        self._alg_memo: dict = {}

    # -- wiring -------------------------------------------------------------
    def _comm(self, members: tuple, key: int):
        c = self._subcomms.get((members, key))
        if c is None:
            if len(members) == self.accl.comm.size:
                c = self.accl.comm  # full-world phase: no split needed
            else:
                c = self.accl.split_communicator(list(members), key=key)
            self._subcomms[(members, key)] = c
        return c

    def _mesh_topology(self) -> MeshTopology | None:
        t = getattr(self.accl.tuner, "topology", None)
        if isinstance(t, MeshTopology) and t.two_tier:
            return t
        return None

    def _phase_algorithm(self, ph: Phase, elem_bytes: int):
        """Explicit flat algorithm for one phase, ranked against the
        phase's OWN tier (the slowest boundary its members span).
        Deterministic across ranks: every member computes from the same
        inputs."""
        if ph.scenario not in VALID_ALGORITHMS:
            return CollectiveAlgorithm.AUTO
        mesh = self._mesh_topology()
        if mesh is None:
            return CollectiveAlgorithm.AUTO
        key = (ph.scenario, ph.members, ph.count * elem_bytes)
        got = self._alg_memo.get(key)
        if got is not None:
            return got
        lvl = phase_tier_level(ph.members, self.nest)
        topo = mesh.tier_topology(min(lvl, mesh.n_tiers - 1),
                                  len(ph.members))
        ranked = [(a, c) for a, c in rank_algorithms(
            ph.scenario, topo, ph.count * elem_bytes, len(ph.members))
            if a != CollectiveAlgorithm.HIERARCHICAL]
        alg = ranked[0][0] if ranked else CollectiveAlgorithm.AUTO
        self._alg_memo[key] = alg
        return alg

    def _scratch_buf(self, role: str, elems: int, dtype, resident: bool,
                     private: dict | None):
        """Scratch for one role, device-resident when the call's operands
        are: cached across calls for SYNC programs (each sync call fully
        drains before the next can touch it), but PRIVATE per call for
        async ones — two concurrent async programs run their same-comm
        phases FIFO, yet a phase pair on DISTINCT comms (call 2's inner
        write vs call 1's still-draining outer read — reachable with
        singleton-host leader plans) has no ordering, so a shared buffer
        would race."""
        key = (role, elems, dtype, resident)
        store = self._scratch if private is None else private
        b = store.get(key)
        if b is None:
            b = store[key] = self.accl.buffer((elems,), dtype,
                                              device_resident=resident)
        return b

    def _bind(self, spec, src, dst, scratch_sizes, dtype, resident: bool,
              private: dict | None = None):
        """Resolve a (role, off, len) binding to an ACCLBuffer."""
        if spec is None:
            return None
        role, off, length = spec
        if role == "op0":
            b = src
        elif role == "res":
            b = dst
        else:
            b = self._scratch_buf(role, scratch_sizes[role], dtype,
                                  resident, private)
        if off or (length and length < b.size):
            if len(b.shape) != 1:
                raise ValueError(
                    "hierarchical collectives address sub-ranges of the "
                    "result buffer; pass 1-D buffers (flat element "
                    "layout) for hierarchical calls")
            return b[off:off + length] if length else b[off:]
        return b

    def _phase_level(self, ph: Phase) -> int:
        """Numeric tier of a phase: boundaries its members span (0 =
        intra). Pure in the nest, so every rank of the phase derives
        the same tier."""
        return phase_tier_level(ph.members, self.nest)

    def _compress_predicate(self, compress_phases):
        """Per-tier quantize predicate from the ``compress_phases``
        argument: None/"all" = every phase (the uniform behavior),
        "inter" = every phase above the intra tier, "slow" = tiers whose
        beta is below ``SLOW_TIER_BETA_GBPS``, a number = that beta
        threshold in GB/s, a callable = ``pred(level, beta_gbps) ->
        bool``. Threshold forms never quantize the intra tier (level 0),
        keeping in-group phases bit-identical."""
        if compress_phases is None or compress_phases == "all":
            return lambda lvl: True
        if compress_phases == "inter":
            return lambda lvl: lvl >= 1
        mesh = self._mesh_topology()
        n = mesh.n_tiers if mesh is not None else None

        def beta_of(lvl):
            if mesh is None:
                return None
            return mesh.tier_beta_gbps(min(lvl, n - 1))

        if compress_phases == "slow" or (
                isinstance(compress_phases, (int, float))
                and not isinstance(compress_phases, bool)):
            thresh = (SLOW_TIER_BETA_GBPS if compress_phases == "slow"
                      else float(compress_phases))

            def slow(lvl):
                if lvl < 1:
                    return False
                b = beta_of(lvl)
                # no mesh figures: every boundary tier is presumed slow
                # (the "inter" semantics)
                return True if b is None else b < thresh

            return slow
        if callable(compress_phases):
            return lambda lvl: bool(compress_phases(lvl, beta_of(lvl)))
        raise ValueError(
            f"compress_phases must be None, 'all', 'inter', 'slow', a "
            f"beta threshold in GB/s or a callable(level, beta_gbps) -> "
            f"bool, got {compress_phases!r}")

    # -- execution ----------------------------------------------------------
    def run(self, op: str, *, count: int, src=None, dst=None,
            func: ReduceFunc = ReduceFunc.SUM, root: int = 0,
            compress_dtype=None, block_scale: bool | int = False,
            compress_phases=None, run_async: bool = False,
            waitfor: Sequence = ()):
        """Issue one hierarchical collective as a waitfor-chained phase
        program; returns the final phase's handle (async) or a completed
        handle (sync).

        ``compress_phases`` selects WHICH tiers apply
        ``compress_dtype``/``block_scale`` (see
        :meth:`_compress_predicate`): slow tiers ride the fp8/int8
        scale-block wire while fast phases run full precision and stay
        bit-identical to the uncompressed program. Tier choice is pure in
        (nest, members), so all ranks agree without a handshake. Each
        phase with a ``compress_dtype`` counts one
        ``hier_phase_wire_total`` row by tier and wire."""
        accl = self.accl
        me = accl.comm.local_rank
        plan = plan_phases(op, self.groups, me, count, root,
                           nest=self.nest[1:])
        if plan is None:  # the ctor guarantees >= 2 hosts
            raise AssertionError("degenerate hierarchy")
        dtype = (torch.promote_types(src.dtype, dst.dtype)
                 if (src is not None and dst is not None)
                 else (src if src is not None else dst).dtype)
        resident = any(b.is_device_resident for b in (src, dst)
                       if b is not None)
        ebytes = dtype.itemsize
        tag = f"hier:{op}#{next(self._seq)}"
        nbytes = count * ebytes
        # tuner-training hygiene, mirroring ACCL._call: only a sync,
        # dependency-free call issued on a quiet device measures the
        # algorithm rather than its queueing context (checked at issue
        # time; by retirement the storm that inflated it may have
        # drained)
        observing = (accl.tuner is not None and not run_async
                     and not waitfor and accl._async_inflight == 0
                     and accl.tuner.quiescent())
        t0 = time.perf_counter()
        key = (op, accl.comm.comm_id)
        accl._call_counts[key] = accl._call_counts.get(key, 0) + 1
        # validate buffer shapes BEFORE issuing anything, and uniformly
        # across ranks: a mid-program shape error after phase 1 left
        # async would orphan an in-flight inner collective, and only
        # LEADER plans slice the result buffer, so a rank-local check
        # would raise on leaders while the others wait for them
        if op == "allgather" and dst is not None \
                and len(dst.shape) != 1:
            raise ValueError(
                "hierarchical allgather addresses host-block "
                "sub-ranges of the result buffer; pass a 1-D result "
                "buffer (flat element layout)")
        for ph in plan.phases:
            for spec in (ph.src, ph.dst):
                if spec is None:
                    continue
                role, off, length = spec
                b = (src if role == "op0"
                     else dst if role == "res" else None)
                if b is None:
                    continue  # engine scratch is always flat
                if (off or (length and length < b.size)) \
                        and len(b.shape) != 1:
                    raise ValueError(
                        "hierarchical collectives address sub-ranges "
                        "of the user buffers; pass 1-D buffers (flat "
                        "element layout) for hierarchical calls")
        prev = list(waitfor)
        last = None
        private = None
        if run_async:
            private = (self._async_scratch_pool.pop()
                       if self._async_scratch_pool else {})
        quantize_tier = self._compress_predicate(compress_phases)
        with accl._attributed(tag):
            for ph in plan.phases:
                comm = self._comm(ph.members, ph.key)
                sb = self._bind(ph.src, src, dst, plan.scratch, dtype,
                                resident, private)
                db = self._bind(ph.dst, src, dst, plan.scratch, dtype,
                                resident, private)
                alg = self._phase_algorithm(ph, ebytes)
                lvl = self._phase_level(ph)
                tier = ("intra" if lvl == 0
                        else "inter" if lvl == 1 else f"inter{lvl}")
                # phase-selective wire: slow tiers compress, fast tiers
                # stay full-precision bit-identical
                cd = compress_dtype if quantize_tier(lvl) else None
                bsc = block_scale if cd is not None else False
                if compress_dtype is not None:
                    METRICS.inc(
                        "hier_phase_wire_total", tier=tier,
                        wire=("quantized" if bsc
                              else "narrowed" if cd is not None
                              else "full"))
                kw = dict(run_async=True, waitfor=prev, comm=comm,
                          compress_dtype=cd, block_scale=bsc)
                if ph.scenario == "reduce_scatter":
                    h = accl.reduce_scatter(sb, db, ph.count, func,
                                            algorithm=alg, **kw)
                elif ph.scenario == "allreduce":
                    h = accl.allreduce(sb, db, ph.count, func,
                                       algorithm=alg, **kw)
                elif ph.scenario == "allgather":
                    h = accl.allgather(sb, db, ph.count, algorithm=alg,
                                       **kw)
                elif ph.scenario == "gather":
                    h = accl.gather(sb, db, ph.count, root=ph.root,
                                    algorithm=alg, **kw)
                elif ph.scenario == "reduce":
                    h = accl.reduce(sb, db, ph.count, root=ph.root,
                                    func=func, algorithm=alg, **kw)
                elif ph.scenario == "scatter":
                    h = accl.scatter(sb, db, ph.count, root=ph.root, **kw)
                elif ph.scenario == "bcast":
                    h = accl.bcast(sb, ph.count, root=ph.root,
                                   algorithm=alg, **kw)
                elif ph.scenario == "send":
                    h = accl.send(sb, ph.count, dst=ph.root, **kw)
                elif ph.scenario == "recv":
                    h = accl.recv(db, ph.count, src=ph.root, **kw)
                else:
                    raise AssertionError(ph.scenario)
                prev = [h]
                last = h
        if last is None:  # a rank in no phase (cannot happen today)
            return CompletedHandle(context=op)
        if run_async:
            # recycle the private scratch set once the LAST phase retires
            # (every earlier phase is waitfor-ordered before it)
            pool = self._async_scratch_pool

            def _recycle(_err, _p=private):
                pool.append(_p)

            last.add_done_callback(_recycle)
            return last
        last.wait()
        if observing:
            accl.tuner.observe(op, accl.comm.size, nbytes,
                               CollectiveAlgorithm.HIERARCHICAL,
                               time.perf_counter() - t0)
        return CompletedHandle(context=op)
