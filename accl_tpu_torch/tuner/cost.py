"""Alpha-beta analytic cost models per (collective, algorithm).

The port of ``accl_tpu/tuner/cost.py``: pure Python floats, the same
formulas in the same order, so every prediction equals the reference's
bit for bit (``tests/test_torch_tuner.py``). The move expansions named
below are the reference's; the CUDA tier prices its collectives with the
same models over its own :class:`Topology` figures.

The model follows the classic Hockney formulation the collective-selection
literature keys on (NCCL's tuner, EQuARX's size/topology-keyed XLA
decisions — PAPERS.md): a move costs ``alpha`` microseconds of fixed
per-hop overhead (software expansion, tag matching, rendezvous) plus its
wire bytes over a ``beta`` GB/s link. Every formula below models OUR move
expansions (moveengine.py), not textbook ideals:

* ring/daisy algorithms serialize ``W-1`` dependency hops, each paying a
  full ``alpha`` — cheap per-hop payloads, expensive in hop count;
* direct (round-robin) algorithms pay one ``alpha`` of critical-path
  latency but funnel ``W-1`` payloads through one endpoint, modeled with
  an ``incast`` congestion factor on the wire term;
* the fused ring allreduce does ``2(W-1)`` blocking steps of ``n/W``
  bytes; the non-fused variant is a daisy-chain reduce of the full
  payload plus a broadcast whose root-side sends are non-blocking
  (expand_broadcast marks them ``blocking=False``) and therefore overlap
  down to one ``alpha`` plus serialized injection.

The crossovers these shapes produce are the point of the subsystem:
latency-bound (small ``n``) calls favor few-alpha algorithms, bandwidth-
bound (large ``n``) calls favor low-wire-volume ones. Absolute numbers
only need to be *ordered* correctly per topology tier; the online
measurement path (tuner.py) refines where the model is wrong.

``nbytes`` everywhere is the call's ``count * uncompressed_elem_bytes`` —
the same convention the driver computes, so model and measurement index
the same quantity (NOTE: for chunked ops — gather/allgather/scatter/
reduce_scatter/alltoall — ``count`` is the per-rank chunk, so ``nbytes``
is chunk bytes, not aggregate payload).
"""

from __future__ import annotations

import dataclasses
import math

from ..constants import CollectiveAlgorithm, VALID_ALGORITHMS

__all__ = ["Topology", "predict_us", "rank_algorithms",
           "recommend_segment_size", "LEGACY_ALGORITHM_PAIRS",
           "predict_quantized_us", "rank_wire", "wire_byte_ratio",
           "predict_alltoallv_us", "WIRE_PRICED_OPS"]


# (op, algorithm) pairs every execution tier has always implemented —
# the reference-derived ring/round-robin families plus the bcast tree.
# A tier whose peer engine may lack the log-depth family (the socket
# client can face the native C++ daemon, which validates and expands
# only these) advertises this set as Topology.supported so AUTO never
# resolves to an algorithm the peer would reject; explicit selectors
# still pass through (and fail loudly at the peer's validation).
_A = CollectiveAlgorithm
LEGACY_ALGORITHM_PAIRS: frozenset = frozenset({
    ("bcast", _A.ROUND_ROBIN), ("bcast", _A.TREE),
    ("scatter", _A.ROUND_ROBIN),
    ("gather", _A.RING), ("gather", _A.ROUND_ROBIN),
    ("reduce", _A.RING), ("reduce", _A.ROUND_ROBIN),
    ("allgather", _A.RING), ("allgather", _A.ROUND_ROBIN),
    ("allreduce", _A.RING), ("allreduce", _A.FUSED_RING),
    ("allreduce", _A.NON_FUSED),
    ("reduce_scatter", _A.RING),
})


@dataclasses.dataclass(frozen=True)
class Topology:
    """Link-level descriptor of one fabric tier.

    Each :class:`~accl_tpu_torch.device.base.Device` backend exposes its own via
    ``Device.topology()``; the numbers are calibrated order-of-magnitude
    figures for that tier (thread handoff vs socket RPC vs device hop), good
    enough to order algorithms — measurement refines the rest.
    """

    world_size: int = 0        # ranks on the fabric (0 = not yet known)
    alpha_us: float = 50.0     # per-hop latency + per-move software cost
    beta_gbps: float = 1.0     # per-link bandwidth, GB/s
    incast: float = 2.0        # fan-in congestion factor at a hot receiver
    tier: str = "generic"
    # Segment-pipeline overlap depth: how many segments the dataplane
    # keeps concurrently in flight (recv-match / combine / relay of
    # different lanes). 1.0 = store-and-forward (no overlap). With depth
    # d, per-segment alpha amortizes across the lanes in flight, so the
    # *effective* overhead of choosing smaller segments shrinks by ~d —
    # equivalently the pipeline sustains an effective beta close to the
    # wire beta down to segments d× smaller (see recommend_segment_size).
    pipeline_depth: float = 1.0
    # (op, algorithm) pairs this tier's execution engines implement;
    # None = everything in VALID_ALGORITHMS. AUTO resolution
    # (rank_algorithms / Tuner) never selects outside this set — the
    # socket tier advertises LEGACY_ALGORITHM_PAIRS because its peer may
    # be the native daemon, which lacks the log-depth family.
    supported: frozenset | None = None
    # Quantized-wire pricing (accl_tpu_torch/quant.py; ACCL+ arXiv 2312.11742
    # frames compression plugins exactly this way — a beta multiplier
    # bought with compute): throughput of the tier's quantize/dequantize
    # passes in GB/s of UNCOMPRESSED payload (the gamma term's
    # denominator) and the fixed per-call cost of arming the quantized
    # lane (scale/header bookkeeping — what keeps small latency-bound
    # calls on the full-precision wire).
    quant_gbps: float = 6.0
    quant_alpha_us: float = 15.0

    def wire_us(self, nbytes: float) -> float:
        """Microseconds to move ``nbytes`` over one link."""
        return float(nbytes) / (self.beta_gbps * 1e3)  # GB/s == bytes/us*1e3


# -- per-(op, algorithm) models ---------------------------------------------
# Each takes (topo, W, nbytes) and returns predicted microseconds.

def _ring_chain(topo: Topology, w: int, nbytes: float) -> float:
    """W-1 serialized hops of the full per-hop payload (gather/allgather
    relays, daisy-chain reduce, ring reduce-scatter)."""
    return (w - 1) * (topo.alpha_us + topo.wire_us(nbytes))


def _direct_fanin(topo: Topology, w: int, nbytes: float) -> float:
    """One hop of latency; W-1 payloads squeezed through one endpoint."""
    return topo.alpha_us + topo.incast * (w - 1) * topo.wire_us(nbytes)


def _bcast_rr(topo: Topology, w: int, nbytes: float) -> float:
    """Root's sends are non-blocking (one alpha on the critical path) but
    serialize at its injection port."""
    return topo.alpha_us + (w - 1) * topo.wire_us(nbytes)


def _bcast_tree(topo: Topology, w: int, nbytes: float) -> float:
    """ceil(log2 W) dependent rounds, full payload each."""
    rounds = max(1, math.ceil(math.log2(max(w, 2))))
    return rounds * (topo.alpha_us + topo.wire_us(nbytes))


def _allreduce_fused(topo: Topology, w: int, nbytes: float) -> float:
    """2(W-1) blocking fused-recv-reduce/relay steps of n/W bytes each."""
    return 2 * (w - 1) * (topo.alpha_us + topo.wire_us(nbytes / w))


def _allreduce_nonfused(topo: Topology, w: int, nbytes: float) -> float:
    """Daisy-chain reduce to rank 0 + round-robin bcast of the result."""
    return _ring_chain(topo, w, nbytes) + _bcast_rr(topo, w, nbytes)


# -- log-depth family (modeled on OUR expansions, moveengine.py) ------------
#
# Alpha terms: ceil(log2 W) dependency rounds (+2 barrier phases for the
# non-power-of-2 vrank fold). Wire terms: the same aggregate volume as
# the ring algorithms, but paid in per-round bursts to a DIFFERENT
# partner each round, where the ring trickles fixed-size chunks to one
# fixed neighbor — the streamed executor's per-peer egress, the arrival
# listener, and the fabric coalescing path all sustain a lower effective
# beta on the bursty pattern, and the halving/doubling phases split the
# ring's single fused recv-reduce-relay move into separate recv-reduce
# and send moves (twice the per-byte move software cost). The factors
# below fold that into the wire term; the emulator benchmark ladder
# (benchmarks/algorithms.py) measures the resulting crossover, and the
# online path (tuner.py) refines wherever a real host disagrees.
_RD_WIRE_FACTOR = 1.3       # doubling allgather relays (recv + re-send)
_RD_FUSE_FACTOR = 1.5       # halving phases (unfused recv-reduce + send)
# Rabenseifner's rounds are PAIRWISE-SYNCHRONIZED: every rank wakes and
# issues a send + a separate fused recv-reduce each round, where the
# chain algorithms keep one active hop at a time — per-round software
# cost runs ~1.4 alpha on the measured ladder. This keeps the few-move
# NON_FUSED variant the small-n winner (it measures 3-4x faster than
# Rabenseifner below ~4 KiB on the emulator tier) while Rabenseifner
# owns the mid band up to the ring crossover.
_RD_SYNC_FACTOR = 1.4


def _rd_rounds(w: int) -> int:
    """Pairwise-exchange rounds over p = 2^floor(log2 w) vranks."""
    return max(1, (max(w, 2)).bit_length() - 1)


def _rd_fold(w: int) -> float:
    """1.0 when the vrank fold-in/fold-out barrier phases exist."""
    return 0.0 if w & (w - 1) == 0 else 1.0


def _allgather_rd(topo: Topology, w: int, nbytes: float) -> float:
    """log2(p) exchange rounds moving (w-1)*n total; the fold ships the
    whole w*n result to extras in the post phase."""
    return (_rd_rounds(w) * topo.alpha_us
            + _RD_WIRE_FACTOR * (w - 1) * topo.wire_us(nbytes)
            + _rd_fold(w) * (2 * topo.alpha_us + w * topo.wire_us(nbytes)))


def _reduce_scatter_rh(topo: Topology, w: int, nbytes: float) -> float:
    """log2(p) halving rounds moving (w-1)*n total partials; the fold
    pre-phase ships extras' whole w*n input vectors."""
    return (_rd_rounds(w) * topo.alpha_us
            + _RD_FUSE_FACTOR * (w - 1) * topo.wire_us(nbytes)
            + _rd_fold(w) * (2 * topo.alpha_us
                             + (w + 1) * topo.wire_us(nbytes)))


def _allreduce_rd(topo: Topology, w: int, nbytes: float) -> float:
    """Rabenseifner: halving reduce-scatter + doubling allgather —
    2*log2(p) synchronized rounds at the fused ring's ~2n(w-1)/w wire
    volume."""
    return (_RD_SYNC_FACTOR * 2 * _rd_rounds(w) * topo.alpha_us
            + _RD_FUSE_FACTOR * 2 * (w - 1) / w * topo.wire_us(nbytes)
            + _rd_fold(w) * (2 * topo.alpha_us + 2 * topo.wire_us(nbytes)))


def _allgather_direct(topo: Topology, w: int, nbytes: float) -> float:
    """Direct fan-out allgather: one alpha of dependency depth, but OUR
    expansion has every rank burst-inject w-1 eager sends before any of
    its w-1 recvs can progress — the burst serializes in the executor
    ahead of recv-matching (unlike gather's direct variant, where the
    non-roots each issue a single send), modeled as a per-extra-send
    alpha fraction on top of the incast wire term."""
    return (topo.alpha_us * (1 + 0.4 * max(0, w - 2))
            + topo.incast * (w - 1) * topo.wire_us(nbytes))


# -- algorithm-less wire-priced ops (alltoall / alltoallv) ------------------
#
# Neither op has an algorithm axis (VALID_ALGORITHMS omits them; only
# AUTO is legal), but both still need a price so the WIRE decision
# ("auto" compress_dtype -> fp8 block-scaled vs full precision) can rank
# the quantized variant. The exchange is balanced across endpoints, so
# no incast factor applies; the round-robin step schedule pipelines in
# the streamed executor, so per-step software cost amortizes like the
# allgather burst model (0.4 alpha per extra step).

WIRE_PRICED_OPS = frozenset({"alltoall", "alltoallv"})


def _alltoall_us(topo: Topology, w: int, nbytes: float) -> float:
    """Balanced exchange, ``nbytes`` = per-pair chunk (the chunked-op
    convention): W-1 pipelined steps, W-1 chunks through this rank's
    injection port."""
    return (topo.alpha_us * (1 + 0.4 * max(0, w - 2))
            + (w - 1) * topo.wire_us(nbytes))


def _alltoallv_us(topo: Topology, w: int, nbytes: float) -> float:
    """Uneven exchange, ``nbytes`` = this rank's PORT bytes — the driver
    keys the wire decision on max(sum(send), sum(recv)) elements (the
    descriptor's ``count``), which is already the aggregate through the
    port, not a per-pair chunk. Vector-aware pricing (zero-peer alpha
    skipping) lives in :func:`predict_alltoallv_us`."""
    return (topo.alpha_us * (1 + 0.4 * max(0, w - 2))
            + topo.wire_us(nbytes))


def predict_alltoallv_us(topo: Topology, send_counts, recv_counts,
                         elem_bytes: int) -> float:
    """Per-rank price of one uneven exchange given its count vectors:
    one pipelined alpha per NONZERO peer interval (zero-count peers
    expand to no moves at all — the skew case this op exists for) plus
    this rank's port bytes (send and recv directions overlap on a
    full-duplex port, so the max of the two totals bounds the wire
    term). Deterministic in its inputs; the uneven-reshard fast path
    and the tuner's wire ranking share this one formula."""
    peers = (sum(1 for c in send_counts if c)
             + sum(1 for c in recv_counts if c))
    if peers == 0:
        return 0.0
    port_bytes = max(sum(send_counts), sum(recv_counts)) * elem_bytes
    return (topo.alpha_us * (1 + 0.4 * max(0, peers - 1))
            + topo.wire_us(port_bytes))


def _reduce_tree(topo: Topology, w: int, nbytes: float) -> float:
    """ceil(log2 W) dependent rounds, full payload each (the bcast-tree
    shape run in reverse, with the folds spread across internal nodes)."""
    return _bcast_tree(topo, w, nbytes)


def _gather_tree(topo: Topology, w: int, nbytes: float) -> float:
    """log-depth hop chain; the root still ingests all w-1 chunks, but
    spread over subtree-sized messages instead of the direct algorithm's
    w-1-way incast. Internal nodes store-and-forward their whole subtree
    (scratch write + re-send — an extra local pass the ring relay does
    not pay), the same re-read overhead as the doubling relays."""
    rounds = max(1, math.ceil(math.log2(max(w, 2))))
    return (rounds * topo.alpha_us
            + _RD_WIRE_FACTOR * (w - 1) * topo.wire_us(nbytes))


# -- N-tier hierarchical family (accl_tpu_torch/hier) -----------------------------
#
# HIERARCHICAL is a DRIVER-level phase program over sub-communicators
# (hier/engine.py): e.g. allreduce = reduce-scatter descending the
# nest -> allreduce(top tier) -> allgather ascending. Its cost is the
# sum over nest levels of the cheapest FLAT phase cost on each level's
# own tier Topology — the same per-tier selection the engine performs —
# plus a small per-phase driver-chaining overhead that grows with nest
# depth. On a one-tier Topology (no ``groups`` attribute, or a single
# host) the models price themselves out (infinite), so AUTO picks
# hierarchical exactly when a MeshTopology says a boundary tier's link
# is worth avoiding; a two-tier mesh (no ``outer`` entries) prices to
# the same number as before the nest generalization. Flat algorithms
# on a MeshTopology are priced against its ``flat_equivalent()``
# (per-tier ring-hop weighted alpha / harmonic beta), so the crossover
# the selection produces is the boundary-vs-intra beta ratio — the
# point of the subsystem.

_HIER_PHASE_ALPHAS = 3.0   # driver-side phase chaining (waitfor hops)


def _hier_mesh(topo: Topology, w: int):
    """The MeshTopology behind ``topo`` IF the call spans its full mesh
    (duck-typed — cost.py must not import the hier package). Sub-communicator
    calls (w != mesh world) are flat by definition."""
    groups = getattr(topo, "groups", None)
    if not groups or len(groups) < 2:
        return None
    if sum(len(g) for g in groups) != w:
        return None
    return topo


def _best_flat(op: str, topo: Topology, nbytes: float, w: int) -> float:
    """Cheapest FLAT algorithm's predicted cost for one phase on one
    tier — mirrors the engine's per-phase selection (hier/engine.py)."""
    if w <= 1:
        return 0.0
    best = math.inf
    for a in VALID_ALGORITHMS.get(op, ()):  # noqa: B007
        if a == _A.HIERARCHICAL:
            continue
        if topo.supported is not None and (op, a) not in topo.supported:
            continue
        model = _MODELS.get((op, a))
        if model is None:
            continue
        best = min(best, model(topo, w, float(nbytes)))
    return best


def _hier_tiers(mesh):
    intra = mesh.intra_topology()
    inter = mesh.inter_topology()
    L = max(len(g) for g in mesh.groups)
    return intra, inter, L, mesh.n_hosts


def _hier_ladder(mesh):
    """The pricing skeleton of the recursive lowering: per grouping
    level a ``(fanout, tier Topology, aligned)`` triple innermost-first,
    plus the top-tier exchange's ``(group count, tier Topology)``.
    Fanout at the innermost level is the largest group size; deeper it
    is the largest number of sub-groups merged per group. Duck-typed:
    a mesh without ``nest()`` prices as the historical intra/inter
    pair."""
    nest_fn = getattr(mesh, "nest", None)
    tier_fn = getattr(mesh, "tier_topology", None)
    if not (callable(nest_fn) and callable(tier_fn)):
        intra, inter, L, H = _hier_tiers(mesh)
        return ([(L, intra, bool(getattr(mesh, "aligned", False)))],
                (H, inter))
    nest = nest_fn()
    levels = []
    prev = None
    for lvl, grouping in enumerate(nest):
        if prev is None:
            sizes = [len(g) for g in grouping]
        else:
            owner = {r: gi for gi, g in enumerate(grouping) for r in g}
            sizes = [0] * len(grouping)
            for p in prev:
                sizes[owner[p[0]]] += 1
        levels.append((max(sizes), tier_fn(lvl), len(set(sizes)) == 1))
        prev = grouping
    return levels, (len(nest[-1]), tier_fn(len(nest)))


def _allreduce_hier(topo: Topology, w: int, nbytes: float) -> float:
    """Aligned nests: reduce-scatter descending every level ->
    allreduce(top tier) -> allgather ascending (each boundary tier only
    ever carries its subtree's shrunk chunk, concurrently per inner
    index); otherwise reduce-to-leader descending -> allreduce(top
    leaders) -> bcast ascending (full n over each slow boundary, but
    once instead of the flat ring's repeated crossings)."""
    mesh = _hier_mesh(topo, w)
    if mesh is None:
        return math.inf
    levels, (H, top) = _hier_ladder(mesh)
    over = levels[0][1].alpha_us * (
        _HIER_PHASE_ALPHAS + 2.0 * (len(levels) - 1))
    fans = [f for f, _t, _a in levels]
    prod = 1
    for f in fans:
        prod *= f
    # the cheap aligned shape additionally needs the ELEMENT count to
    # divide by the fanout product (plan_phases falls back to the
    # leader shape per level otherwise). The model only sees bytes;
    # byte divisibility is the necessary-condition proxy (element
    # divisibility implies it), so byte-indivisible sizes are priced at
    # the leader cost they will actually pay. A byte-divisible but
    # element-indivisible size still mispredicts toward the aligned
    # cost — a bounded misprediction the EWMA refinement corrects from
    # real retire times.
    if (all(a for _f, _t, a in levels) and all(f > 1 for f in fans)
            and nbytes % prod == 0):
        cost = over
        m = float(nbytes)
        for f, tp, _a in levels:
            m = m / f
            cost += (_best_flat("reduce_scatter", tp, m, f)
                     + _best_flat("allgather", tp, m, f))
        return cost + _best_flat("allreduce", top, m, H)
    cost = over
    for f, tp, _a in levels:
        cost += (_best_flat("reduce", tp, nbytes, f)
                 + _best_flat("bcast", tp, nbytes, f))
    return cost + _best_flat("allreduce", top, nbytes, H)


def _allgather_hier(topo: Topology, w: int, nbytes: float) -> float:
    """gather ascending (leader chunks grow by the fanout per level) ->
    allgather(top tier, subtree blocks) -> bcast of the whole vector
    descending. ``nbytes`` is the per-rank chunk (the chunked-op
    convention, module docstring)."""
    mesh = _hier_mesh(topo, w)
    if mesh is None:
        return math.inf
    levels, (H, top) = _hier_ladder(mesh)
    cost = levels[0][1].alpha_us * (
        _HIER_PHASE_ALPHAS + 2.0 * (len(levels) - 1))
    m = float(nbytes)
    for f, tp, _a in levels:
        cost += _best_flat("gather", tp, m, f)
        m *= f
    cost += _best_flat("allgather", top, m, H)
    for f, tp, _a in levels:
        cost += _best_flat("bcast", tp, w * float(nbytes), f)
    return cost


def _reduce_scatter_hier(topo: Topology, w: int, nbytes: float) -> float:
    """reduce of the whole vector ascending -> reduce_scatter(top tier,
    subtree blocks) [uneven nests: allreduce(top leaders)] -> scatter
    descending (leader chunks shrink by the fanout per level).
    ``nbytes`` is the per-rank chunk."""
    mesh = _hier_mesh(topo, w)
    if mesh is None:
        return math.inf
    levels, (H, top) = _hier_ladder(mesh)
    cost = levels[0][1].alpha_us * (
        _HIER_PHASE_ALPHAS + 2.0 * (len(levels) - 1))
    total = w * float(nbytes)
    for f, tp, _a in levels:
        cost += _best_flat("reduce", tp, total, f)
    if all(a for _f, _t, a in levels):
        cost += _best_flat("reduce_scatter", top, total / H, H)
    else:
        cost += _best_flat("allreduce", top, total, H)
    m = float(nbytes)
    for f, tp, _a in levels:
        cost += _best_flat("scatter", tp, m, f)
        m *= f
    return cost


def _bcast_hier(topo: Topology, w: int, nbytes: float) -> float:
    """bcast(root -> one representative per top-tier group over the
    slowest tier) -> bcast descending the nest: the payload crosses
    each boundary tier (groups - 1) times instead of up to W - 1."""
    mesh = _hier_mesh(topo, w)
    if mesh is None:
        return math.inf
    levels, (H, top) = _hier_ladder(mesh)
    cost = levels[0][1].alpha_us * (
        _HIER_PHASE_ALPHAS + (len(levels) - 1))
    cost += _best_flat("bcast", top, nbytes, H)
    for f, tp, _a in levels:
        cost += _best_flat("bcast", tp, nbytes, f)
    return cost


_MODELS = {
    ("bcast", _A.ROUND_ROBIN): _bcast_rr,
    ("bcast", _A.TREE): _bcast_tree,
    ("scatter", _A.ROUND_ROBIN): _bcast_rr,   # strided rr sends from root
    ("gather", _A.RING): _ring_chain,
    ("gather", _A.ROUND_ROBIN): _direct_fanin,
    ("gather", _A.TREE): _gather_tree,
    ("reduce", _A.RING): _ring_chain,
    ("reduce", _A.ROUND_ROBIN): _direct_fanin,
    ("reduce", _A.TREE): _reduce_tree,
    ("allgather", _A.RING): _ring_chain,
    ("allgather", _A.ROUND_ROBIN): _allgather_direct,
    ("allgather", _A.RECURSIVE_DOUBLING): _allgather_rd,
    # RING and FUSED_RING share one expansion (expand_allreduce_ring);
    # the epsilon nudge makes AUTO surface the canonical FUSED_RING name
    ("allreduce", _A.RING): lambda t, w, n: 1.0001 * _allreduce_fused(
        t, w, n),
    ("allreduce", _A.FUSED_RING): _allreduce_fused,
    ("allreduce", _A.NON_FUSED): _allreduce_nonfused,
    ("allreduce", _A.RECURSIVE_DOUBLING): _allreduce_rd,
    ("reduce_scatter", _A.RING): _ring_chain,
    ("reduce_scatter", _A.RECURSIVE_DOUBLING): _reduce_scatter_rh,
    # algorithm-less ops carry AUTO on every tier; keyed so predict_us /
    # predict_quantized_us / rank_wire price them without special cases
    ("alltoall", _A.AUTO): _alltoall_us,
    ("alltoallv", _A.AUTO): _alltoallv_us,
    ("bcast", _A.HIERARCHICAL): _bcast_hier,
    ("allgather", _A.HIERARCHICAL): _allgather_hier,
    ("allreduce", _A.HIERARCHICAL): _allreduce_hier,
    ("reduce_scatter", _A.HIERARCHICAL): _reduce_scatter_hier,
}


def predict_us(op: str, algorithm: CollectiveAlgorithm, topo: Topology,
               nbytes: int, world_size: int | None = None) -> float:
    """Predicted call time in microseconds for one (op, algorithm) pair.

    On a two-tier MeshTopology, FLAT algorithms are priced against the
    mesh's ``flat_equivalent()`` link figures when the call spans the
    full mesh (a tier-blind schedule pays the slow tier on the hops
    that cross hosts), and against the intra tier for sub-communicator
    calls (the hierarchical engine's phases run inside one tier; the
    outer phase is priced explicitly by the hierarchical models).
    HIERARCHICAL itself sees the raw mesh."""
    w = world_size if world_size is not None else topo.world_size
    if w <= 1:
        return 0.0
    alg = _A(algorithm)
    model = _MODELS.get((op, alg))
    if model is None:
        raise KeyError(f"no cost model for ({op}, "
                       f"{_A(algorithm).name})")
    groups = getattr(topo, "groups", None)
    if groups and len(groups) > 1 and alg != _A.HIERARCHICAL:
        topo = (topo.flat_equivalent()
                if sum(len(g) for g in groups) == w
                else topo.intra_topology(w))
    return model(topo, w, float(nbytes))


# -- quantized-wire variants (accl_tpu_torch/quant.py, EQuARX arXiv 2506.17615) --
#
# A quantized variant of any algorithm moves ``1/wire_ratio`` of the
# bytes (beta scales UP by the ratio — the ACCL+ framing of compression
# as bandwidth) and pays a gamma term: the quantize/dequantize passes
# over the uncompressed payload at ``quant_gbps`` plus a fixed
# ``quant_alpha_us``. On a mesh only the BOUNDARY tiers' betas scale
# (the host boundary plus any coarser ``outer`` levels) — the per-tier
# quantize predicate never compresses intra phases (full precision by
# contract), so the model prices what the engine runs. The resulting
# crossover is the
# point: quantized wire wins exactly where wire bytes dominate, never
# in the alpha-dominated small-call band (pinned by tests/test_quantize).

def wire_byte_ratio(u_bytes: int = 4, q_bytes: int = 1,
                    block: int = 128) -> float:
    """Uncompressed-to-quantized wire byte ratio including the per-block
    f32 scale overhead (~3.87x for f32 -> fp8 at block 128)."""
    return float(u_bytes) / (float(q_bytes) + 4.0 / float(block))


def _scale_boundary_betas(topo: Topology, r: float) -> Topology:
    """Every boundary tier's beta scaled by the wire ratio — the
    ``inter_*`` host boundary plus any coarser ``outer`` TierSpec
    levels (duck-typed; plain two-tier meshes have ``outer == ()``)."""
    topo = dataclasses.replace(
        topo, inter_beta_gbps=getattr(topo, "inter_beta_gbps", 0.1) * r)
    outer = getattr(topo, "outer", ())
    if outer:
        topo = dataclasses.replace(
            topo, outer=tuple(
                dataclasses.replace(s, beta_gbps=s.beta_gbps * r)
                for s in outer))
    return topo


def predict_quantized_us(op: str, algorithm: CollectiveAlgorithm,
                         topo: Topology, nbytes: int,
                         world_size: int | None = None,
                         ratio: float | None = None) -> float:
    """Predicted microseconds for the BLOCK_SCALED variant of one
    (op, algorithm) pair."""
    r = wire_byte_ratio() if ratio is None else float(ratio)
    w = world_size if world_size is not None else topo.world_size
    if w <= 1:
        return 0.0
    groups = getattr(topo, "groups", None)
    if _A(algorithm) == _A.HIERARCHICAL and groups and len(groups) > 1:
        # per-tier quantized mode: only the boundary tiers' wires
        # quantize (intra phases stay full precision by contract), and
        # only the boundary phases' payload pays the codec
        topo_q = _scale_boundary_betas(topo, r)
        L = max(len(g) for g in groups)
        outer_bytes = (float(nbytes) / L
                       if getattr(topo, "aligned", False) and L > 1
                       else float(nbytes))
        gamma = 2.0 * outer_bytes / (topo.quant_gbps * 1e3)
    else:
        topo_q = dataclasses.replace(topo, beta_gbps=topo.beta_gbps * r)
        if groups:
            topo_q = _scale_boundary_betas(topo_q, r)
        gamma = 2.0 * float(nbytes) / (topo.quant_gbps * 1e3)
    return (predict_us(op, algorithm, topo_q, nbytes, world_size)
            + topo.quant_alpha_us + gamma)


def rank_wire(op: str, topo: Topology, nbytes: int,
              world_size: int | None = None, ratio: float | None = None
              ) -> tuple[bool, CollectiveAlgorithm | None]:
    """(quantize?, best algorithm under that wire): True exactly when
    the cheapest quantized variant beats the cheapest full-precision
    one. Deterministic in its inputs — every rank of a collective must
    agree."""
    if op in WIRE_PRICED_OPS:
        # no algorithm axis: rank the one AUTO-priced variant directly
        plain = [(_A.AUTO, predict_us(op, _A.AUTO, topo, nbytes,
                                      world_size))]
    else:
        plain = rank_algorithms(op, topo, nbytes, world_size)
    if not plain:
        return False, None
    scored = []
    for a, _c in plain:
        q = predict_quantized_us(op, a, topo, nbytes, world_size, ratio)
        if math.isfinite(q):
            scored.append((q, int(a), a))
    if not scored:
        return False, plain[0][0]
    scored.sort()
    best_q = scored[0]
    if best_q[0] < plain[0][1]:
        return True, best_q[2]
    return False, plain[0][0]


def rank_algorithms(op: str, topo: Topology, nbytes: int,
                    world_size: int | None = None
                    ) -> list[tuple[CollectiveAlgorithm, float]]:
    """Every legal algorithm of ``op`` the topology's engines implement,
    with its predicted cost, cheapest first. Ties break toward the lower
    enum value (deterministic across runs and ranks — every rank of a
    collective must pick the same algorithm from the same inputs)."""
    valid = VALID_ALGORITHMS.get(op)
    if not valid:
        return []
    scored = [(a, predict_us(op, a, topo, nbytes, world_size))
              for a in sorted(valid)
              if topo.supported is None or (op, a) in topo.supported]
    scored.sort(key=lambda p: (p[1], int(p[0])))
    return scored


def recommend_segment_size(topo: Topology, preferred: int,
                           overhead_fraction: float = 0.1,
                           floor: int = 4096,
                           overlap_depth: float | None = None) -> int:
    """Smallest power-of-two segment whose per-segment ``alpha`` overhead
    is at most ``overhead_fraction`` of its wire time, clamped to
    ``[floor, preferred]``.

    ``preferred`` is the backend's ``preferred_segment_size()`` — the
    largest segment it can accept (rx-buffer bound on the emulator tiers).
    High-alpha fabrics want segments as large as allowed; low-alpha/high-
    beta fabrics can afford smaller segments (better pipelining overlap,
    reference dma_mover segmentation) without drowning in per-segment cost.

    Overlap-aware effective beta: with a segment-streamed dataplane
    (``overlap_depth``, defaulting to ``topo.pipeline_depth``) the
    per-segment alpha of ~depth lanes is paid concurrently, so the
    *effective* per-segment overhead is ``alpha/depth`` — the pipeline
    sustains close to wire beta down to segments depth× smaller. Smaller
    segments in turn deepen the recv→combine→relay overlap, which is
    exactly what the streamed executor converts into throughput; a
    store-and-forward engine (depth 1) keeps the conservative sizing.
    """
    depth = max(1.0, (topo.pipeline_depth if overlap_depth is None
                      else overlap_depth))
    if preferred <= floor:
        return preferred
    target = (topo.alpha_us / depth) / overhead_fraction \
        * topo.beta_gbps * 1e3
    seg = 1 << max(1, math.ceil(math.log2(max(target, 1.0))))
    return max(floor, min(seg, preferred))
