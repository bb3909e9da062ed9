"""The redistribution compiler: sharding change -> minimal program.

A copy of ``accl_tpu/hier/redistribute.py`` (pure geometry; the oracle
stays in numpy). ``ACCL.redistribute(srcbuf, src_spec, dstbuf,
dst_spec)`` lowers an arbitrary
:class:`~accl_tpu_torch.hier.sharding.ShardSpec` change to the cheapest
program the spec pair admits:

* identical specs, or a replicated source -> pure local **slice**
  copies (every byte is already on-rank; nothing crosses the wire);
* even blocks -> replicated -> one **allgather**;
* even blocks <-> uniform block-cyclic of matching grain -> one
  **alltoall** (both directions reduce to exactly the alltoall op's
  send-chunk-j-to-rank-j / chunk-from-i-lands-at-i*c layout — proved in
  the plan tests);
* uneven blocks whose exchange is DENSE (off-diagonal overlap pairs
  >= W across the whole world) -> one **alltoallv**: for block->block
  every rank's per-peer pieces tile its local shard contiguously in
  ascending peer order — exactly the alltoallv count-vector layout —
  so the whole interval-ownership p2p program collapses onto a single
  laned collective (pipelined segment streaming, one plan-cache entry
  keyed on the count signature, fp8 wire eligible);
* anything else (sparse shifts, permutations, subsets, grain changes)
  -> **point-to-point** sends/recvs computed from interval ownership,
  rotated by peer distance to spread incast, eager sends before recvs
  so no rendezvous cycle exists.  The density rule is computed from
  the spec pair alone, so every rank lowers identically; a single
  boundary shift stays exactly one p2p transfer (minimality pinned).

The planner is pure geometry (specs + rank in, steps out), so a test
replays exactly what the driver issues; :func:`redistribute_oracle` is
the serial gather-reshard-scatter reference every execution must match
bit-identically.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .sharding import ShardSpec

__all__ = ["RedistStep", "RedistPlan", "plan_redistribute",
           "redistribute_oracle"]


@dataclasses.dataclass(frozen=True)
class RedistStep:
    """One action of rank-local program order.

    ``peer`` is the comm-local counterpart for send/recv; offsets are
    ELEMENTS into the rank's local src/dst shard buffers.
    """

    kind: str                # "copy" | "send" | "recv"
    count: int
    src_off: int = 0         # copy/send: offset into the local src shard
    dst_off: int = 0         # copy/recv: offset into the local dst shard
    peer: int = -1


@dataclasses.dataclass(frozen=True)
class RedistPlan:
    """One rank's compiled program.

    ``kind`` names the fast path taken: "noop" (nothing to do),
    "local" (slice copies only), "allgather" / "alltoall" (one
    collective, ``coll_count`` elements per chunk), "alltoallv" (one
    variable-count collective; ``send_counts`` / ``recv_counts`` are
    this rank's per-peer element vectors, prefix-sums of which tile
    the local src/dst shards), or "p2p" (the generic ``steps``
    program)."""

    kind: str
    steps: tuple[RedistStep, ...] = ()
    coll_count: int = 0      # allgather/alltoall per-chunk elements
    send_counts: tuple[int, ...] = ()   # alltoallv per-peer vectors
    recv_counts: tuple[int, ...] = ()
    rank: int = -1           # alltoallv: whose vectors (self chunk = rank)

    @property
    def wire_transfers(self) -> int:
        """Cross-rank transfers this rank issues/receives."""
        if self.kind == "alltoallv":
            return (sum(1 for j, c in enumerate(self.send_counts)
                        if c and j != self.rank)
                    + sum(1 for j, c in enumerate(self.recv_counts)
                          if c and j != self.rank))
        return sum(1 for s in self.steps if s.kind in ("send", "recv"))


def _check_pair(src: ShardSpec, dst: ShardSpec):
    if src.n != dst.n:
        raise ValueError(f"sharding change alters the global size: "
                         f"{src.n} -> {dst.n} elements")
    if src.world != dst.world:
        raise ValueError(f"src and dst specs span different worlds: "
                         f"{src.world} vs {dst.world}")


def _owner_pieces(src: ShardSpec, j: int, g0: int, cnt: int):
    """Split dst-interval [g0, g0+cnt) by SOURCE ownership: yields
    ``(owner_rank, gstart, count, src_local_off)`` pieces. Replicated
    sources prefer the local replica (rank j) — the minimality rule
    that turns replicated->anything into pure slices."""
    if src.kind == "replicated":
        yield (j, g0, cnt, g0)
        return
    if src.kind == "block":
        off = 0
        for r, c in enumerate(src.counts):
            lo, hi = max(g0, off), min(g0 + cnt, off + c)
            if lo < hi:
                yield (r, lo, hi - lo, lo - off)
            off += c
        return
    if src.kind not in ("cyclic", "block_cyclic"):
        # an unhandled kind must fail loud: the arithmetic below would
        # silently misattribute ownership (data corruption, not a crash)
        raise ValueError(f"unknown shard kind {src.kind!r}")
    # (block-)cyclic: walk chunk-aligned subpieces. Chunk k's owner is
    # k % W (cyclic) or order[k % len(order)] (block_cyclic's deal
    # sequence — possibly a strict subset of the world); the local
    # offset is whole preceding owned chunks either way, since only the
    # LAST global chunk can be partial and every chunk before k is
    # therefore full.
    ch = src.chunk
    order = src.order if src.kind == "block_cyclic" else None
    period = len(order) if order is not None else src.world
    g = g0
    end = g0 + cnt
    while g < end:
        k = g // ch                       # global chunk index
        take = min(end, (k + 1) * ch) - g
        owner = order[k % period] if order is not None else k % period
        src_loc = (k // period) * ch + (g - k * ch)
        yield (owner, g, take, src_loc)
        g += take


def _is_even_block(spec: ShardSpec) -> bool:
    return (spec.kind == "block" and len(set(spec.counts)) == 1
            and spec.counts[0] > 0)


def _block_offdiag_pairs(src: ShardSpec, dst: ShardSpec) -> int:
    """Number of (src rank r, dst rank j), r != j, whose intervals
    overlap — the whole exchange's cross-rank transfer count. A merge
    walk over the two sorted boundary lists (O(W)); pure geometry of
    the spec pair, so every rank computes the same number and the
    dense-lowering decision below is world-uniform by construction."""
    W = src.world
    soff = [0]
    doff = [0]
    for r in range(W):
        soff.append(soff[-1] + src.counts[r])
        doff.append(doff[-1] + dst.counts[r])
    pairs = 0
    j = 0
    for r in range(W):
        if soff[r + 1] == soff[r]:
            continue
        # advance to the first dst interval reaching into src's
        while doff[j + 1] <= soff[r]:
            j += 1
        k = j
        while k < W and doff[k] < soff[r + 1]:
            if doff[k + 1] > doff[k] and k != r:
                pairs += 1
            k += 1
    return pairs


def _alltoallv_vectors(src: ShardSpec, dst: ShardSpec, me: int):
    """Rank ``me``'s per-peer (send_counts, recv_counts) for a
    block->block change. Valid because each rank's src/dst shard is one
    contiguous global interval: the pieces bound for ascending peers
    tile the local shard contiguously in ascending order — exactly the
    prefix-sum layout ``expand_alltoallv`` addresses. Pairwise
    consistency (my send_counts[j] == j's recv_counts[me]) holds by
    construction: both sides are |src_me ∩ dst_j|."""
    W = src.world
    soff = [0] * (W + 1)
    doff = [0] * (W + 1)
    for r in range(W):
        soff[r + 1] = soff[r] + src.counts[r]
        doff[r + 1] = doff[r] + dst.counts[r]
    s0, s1 = soff[me], soff[me + 1]
    d0, d1 = doff[me], doff[me + 1]
    send = tuple(max(0, min(s1, doff[j + 1]) - max(s0, doff[j]))
                 for j in range(W))
    recv = tuple(max(0, min(d1, soff[r + 1]) - max(d0, soff[r]))
                 for r in range(W))
    return send, recv


def _plan_block_block(src: ShardSpec, dst: ShardSpec,
                      me: int) -> RedistPlan:
    """Direct overlap walk for a block->block sharding change: rank
    ``me``'s single contiguous src/dst intervals against the peer
    boundaries. Emits steps in exactly the generic path's order (sends
    then recvs then copies, rotated-peer-sorted), so the two planners
    are interchangeable — the differential test holds them identical."""
    W = src.world
    soff = [0] * (W + 1)
    doff = [0] * (W + 1)
    for r in range(W):
        soff[r + 1] = soff[r] + src.counts[r]
        doff[r + 1] = doff[r] + dst.counts[r]
    s0, s1 = soff[me], soff[me + 1]
    d0, d1 = doff[me], doff[me + 1]
    sends: list[tuple] = []
    recvs: list[tuple] = []
    copies: list[RedistStep] = []
    if s1 > s0:
        for j in range(W):
            lo, hi = max(s0, doff[j]), min(s1, doff[j + 1])
            if lo >= hi:
                continue
            if j == me:
                copies.append(RedistStep("copy", hi - lo,
                                         src_off=lo - s0,
                                         dst_off=lo - d0))
            else:
                sends.append(((j - me) % W, lo,
                              RedistStep("send", hi - lo,
                                         src_off=lo - s0, peer=j)))
    if d1 > d0:
        for r in range(W):
            if r == me:
                continue
            lo, hi = max(d0, soff[r]), min(d1, soff[r + 1])
            if lo >= hi:
                continue
            recvs.append(((me - r) % W, lo,
                          RedistStep("recv", hi - lo,
                                     dst_off=lo - d0, peer=r)))
    sends.sort(key=lambda t: (t[0], t[1]))
    recvs.sort(key=lambda t: (t[0], t[1]))
    steps = tuple([s for _, _, s in sends] + [r for _, _, r in recvs]
                  + copies)
    if not steps:
        return RedistPlan("noop")
    if all(s.kind == "copy" for s in steps):
        return RedistPlan("local", steps)
    return RedistPlan("p2p", steps)


def plan_redistribute(src: ShardSpec, dst: ShardSpec,
                      me: int) -> RedistPlan:
    """Compile rank ``me``'s program for the sharding change."""
    _check_pair(src, dst)
    W = src.world
    # -- collective fast paths (spec-shape keyed; the plan tests prove
    #    each reduces to exactly the op's data movement) ------------------
    if src == dst:
        c = src.local_count(me)
        if not c:
            return RedistPlan("noop")
        return RedistPlan("local",
                          (RedistStep("copy", c, src_off=0, dst_off=0),))
    if src.kind == "replicated":
        steps = tuple(
            RedistStep("copy", cnt, src_off=g0, dst_off=l0)
            for g0, cnt, l0 in dst.intervals(me))
        return RedistPlan("local" if steps else "noop", steps)
    if dst.kind == "replicated" and _is_even_block(src):
        return RedistPlan("allgather", coll_count=src.counts[0])
    if (_is_even_block(src) and dst.kind == "cyclic"
            and src.counts[0] == W * dst.chunk):
        return RedistPlan("alltoall", coll_count=dst.chunk)
    if (_is_even_block(dst) and src.kind == "cyclic"
            and dst.counts[0] == W * src.chunk):
        return RedistPlan("alltoall", coll_count=src.chunk)
    if src.kind == "block" and dst.kind == "block":
        # dense uneven exchange -> one alltoallv: when at least W
        # off-diagonal interval pairs overlap (i.e. on average every
        # rank owns a cross-rank transfer), the rotated p2p program is
        # just an alltoallv spelled out move-by-move — lower it onto
        # the collective so the engine lanes and pipelines the uneven
        # segments like a fixed-size alltoall (and the wire gets one
        # plan-cache entry keyed on the count signature instead of W
        # p2p programs). BELOW the threshold the p2p path is kept: a
        # boundary shift of k elements must stay exactly one k-element
        # transfer per affected pair (minimality tests pin this), and
        # a W-wide collective admission would be pure overhead for it.
        if _block_offdiag_pairs(src, dst) >= W:
            send, recv = _alltoallv_vectors(src, dst, me)
            if not (any(send) or any(recv)):
                return RedistPlan("noop")
            return RedistPlan("alltoallv", send_counts=send,
                              recv_counts=recv, rank=me)
        # block->block boundary shift — the membership grow/shrink
        # reshard shape (elastic world: ShardSpec.balanced over the old
        # and new member counts): computed from THIS rank's own
        # boundaries in O(W) instead of the generic whole-world
        # interval-ownership walk below (O(W^2) per rank — a real cost
        # when a 1024-way reshard plans on every rank). The emitted
        # program is bit-identical to the generic path's (differential-
        # tested), so plan minimality facts carry over: a boundary shift
        # of k elements stays exactly one k-element transfer per
        # affected pair.
        return _plan_block_block(src, dst, me)
    return _plan_generic_p2p(src, dst, me)


def _plan_generic_p2p(src: ShardSpec, dst: ShardSpec,
                      me: int) -> RedistPlan:
    """The generic interval-ownership program (any spec pair). Kept
    callable on block pairs too so the fast-path differential test can
    hold `_plan_block_block` identical to it."""
    W = src.world
    # -- generic point-to-point program ----------------------------------
    copies: list[RedistStep] = []
    recvs: list[tuple] = []
    sends: list[tuple] = []
    for j in range(W):
        for g0, cnt, l0 in dst.intervals(j):
            for owner, gs, c, src_loc in _owner_pieces(src, j, g0, cnt):
                dst_loc = l0 + (gs - g0)
                if j == me and owner == me:
                    copies.append(RedistStep("copy", c, src_off=src_loc,
                                             dst_off=dst_loc))
                elif owner == me:
                    sends.append(((j - me) % W, gs,
                                  RedistStep("send", c, src_off=src_loc,
                                             peer=j)))
                elif j == me:
                    recvs.append(((me - owner) % W, gs,
                                  RedistStep("recv", c, dst_off=dst_loc,
                                             peer=owner)))
    # rotated peer order spreads incast; per-pair order is ascending
    # global offset on BOTH sides, so seqn matching pairs up by
    # construction. All sends precede all recvs: sends are eager (they
    # complete on emission into the peer's rx pool), so no rendezvous
    # cycle exists for the pool to deadlock on.
    sends.sort(key=lambda t: (t[0], t[1]))
    recvs.sort(key=lambda t: (t[0], t[1]))
    steps = tuple([s for _, _, s in sends] + [r for _, _, r in recvs]
                  + copies)
    if not steps:
        return RedistPlan("noop")
    if all(s.kind == "copy" for s in steps):
        return RedistPlan("local", steps)
    return RedistPlan("p2p", steps)


def redistribute_oracle(src_shards, src: ShardSpec,
                        dst: ShardSpec) -> list[np.ndarray]:
    """Serial gather-reshard-scatter reference: assemble the global
    vector from every rank's source shard, then slice each rank's
    destination shard out of it. Pure numpy — the differential suite
    requires every engine execution to match this bit-identically."""
    _check_pair(src, dst)
    dtype = np.asarray(src_shards[0]).dtype
    glob = np.zeros(src.n, dtype=dtype)
    for r in range(src.world):
        arr = np.asarray(src_shards[r])
        for g0, cnt, l0 in src.intervals(r):
            glob[g0:g0 + cnt] = arr[l0:l0 + cnt]
    out = []
    for r in range(dst.world):
        buf = np.zeros(dst.local_count(r), dtype=dtype)
        for g0, cnt, l0 in dst.intervals(r):
            buf[l0:l0 + cnt] = glob[g0:g0 + cnt]
        out.append(buf)
    return out
