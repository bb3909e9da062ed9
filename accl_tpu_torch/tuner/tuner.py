"""The Tuner: cost-model + measurement-driven AUTO resolution.

The port of ``accl_tpu/tuner/tuner.py``; exploration keeps an explicit
``random.Random(seed)``, so one seed draws the reference's picks.

NCCL-tuner-shaped selection for the ACCL call path: ``AUTO`` resolves per
``(op, world_size, nbytes-bucket)`` key from the alpha-beta cost model
(cost.py) seeded with the device's :class:`~accl_tpu_torch.tuner.cost.Topology`,
and is refined online from retire-time measurements — the driver feeds
every tuned call's issue->retire duration back via :meth:`observe` (the
same done-callback mechanism :class:`~accl_tpu_torch.tracing.Profiler` records
through), and :meth:`ingest_records` bulk-loads a Profiler's
``CallRecord`` history.

Selection policy per key:

1. a pinned entry (loaded tuning table, cache.py) wins outright;
2. a cached decision from an earlier ``select`` on the same key;
3. otherwise a fresh decision is computed (under the lock) and cached:
   with probability ``epsilon`` a uniformly random legal algorithm
   (exploration — its measurements then land against it), else the
   argmin over per-algorithm scores — the EWMA of measured durations
   when an algorithm has ``min_samples`` observations, the cost-model
   prediction when it does not. Mixing the two scales works because
   both are microseconds of the same call.

Decisions are STICKY until :meth:`refresh` drops them: every rank of a
collective must expand the same algorithm or the move programs mismatch
(a ring member rendezvousing with a direct sender hangs in recv), so a
decision may not flip while calls are in flight just because a new
measurement landed between two ranks' selects. Share ONE tuner across
the ranks of an in-process world (``testing.emu_world(tuner=...)`` does)
and call :meth:`refresh` at quiesced points — after a profiled phase, an
epoch boundary — to fold the accumulated measurements (and re-roll
exploration) for subsequent phases.

Thread safety: one lock guards all mutable state; ``select`` and
``observe`` are called concurrently from every rank's worker/callback
threads of an in-process world.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import weakref

from ..constants import (CollectiveAlgorithm, DEFAULT_ALGORITHMS,
                         VALID_ALGORITHMS)
from .cost import Topology, predict_us, rank_algorithms, \
    recommend_segment_size

__all__ = ["Tuner", "nbytes_bucket"]


def nbytes_bucket(nbytes: int) -> int:
    """Power-of-two bucket index: all sizes in ``(2^(k-1), 2^k]`` share
    bucket ``k`` (0 for empty calls). Coarse enough that one measurement
    generalizes, fine enough to separate latency- from bandwidth-bound."""
    return max(0, int(nbytes) - 1).bit_length()


class _Stat:
    """EWMA + count of one (key, algorithm)'s measured durations."""

    __slots__ = ("ewma_us", "n")

    def __init__(self):
        self.ewma_us = 0.0
        self.n = 0

    def update(self, us: float, weight: float):
        self.n += 1
        if self.n == 1:
            self.ewma_us = us
        else:
            self.ewma_us += weight * (us - self.ewma_us)


class Tuner:
    """Thread-safe per-(op, world, size-bucket) algorithm selector.

    Args:
        topology: link descriptor for the cost model; when ``None`` the
            first :class:`~accl_tpu_torch.accl.ACCL` this tuner is attached to
            binds its device's ``topology()``.
        epsilon: exploration probability (0 disables exploration; keep 0
            for deterministic multi-rank programs unless every rank shares
            ONE tuner instance — diverging per-rank choices would hang a
            rendezvous-matched tier).
        min_samples: measurements an algorithm needs before its EWMA
            replaces the cost-model prediction in scoring.
        ewma_weight: weight of the newest sample in the running average.
        seed: exploration RNG seed (deterministic tests).
    """

    def __init__(self, topology: Topology | None = None,
                 epsilon: float = 0.0, min_samples: int = 2,
                 ewma_weight: float = 0.25, seed: int = 0):
        self.topology = topology
        self.epsilon = float(epsilon)
        self.min_samples = int(min_samples)
        self.ewma_weight = float(ewma_weight)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # (op, world, bucket) -> {algorithm: _Stat}
        self._measured: dict[tuple, dict[CollectiveAlgorithm, _Stat]] = {}
        # (op, world, bucket) -> algorithm, from a loaded tuning table
        self._pinned: dict[tuple, CollectiveAlgorithm] = {}
        # (op, world, bucket) -> algorithm: sticky decisions, valid until
        # refresh() (see module docstring: rank agreement)
        self._decisions: dict[tuple, CollectiveAlgorithm] = {}
        # compiled-plan caches to invalidate when decisions may flip
        # (refresh / pin / clear_pins). Weak refs: a tuner can outlive
        # the worlds whose device caches registered with it.
        self._plan_caches: list = []
        # async calls in flight across EVERY driver sharing this tuner:
        # multi-tenant worlds share one tuner across tenants, and one
        # tenant's async storm inflating another tenant's synchronous
        # issue->retire window must not be credited to the algorithm
        # (cross-tenant EWMA contamination). Drivers bump the counter on
        # async issue/retire; training requires quiescent() — the
        # driver-local check alone only sees its OWN calls.
        self._async_inflight = 0

    # -- cross-driver quiescence (multi-tenant measurement hygiene) --------
    def note_async_issue(self):
        with self._lock:
            self._async_inflight += 1

    def note_async_retire(self):
        with self._lock:
            self._async_inflight -= 1

    def quiescent(self) -> bool:
        """True when no driver sharing this tuner has an async call in
        flight — the only state in which a synchronous call's measured
        window is attributable to its algorithm alone."""
        return self._async_inflight == 0

    # -- selection ---------------------------------------------------------
    def _topo(self, world_size: int) -> Topology:
        base = self.topology or Topology()
        if base.world_size != world_size:
            base = dataclasses.replace(base, world_size=world_size)
        return base

    def select(self, op: str, world_size: int,
               nbytes: int) -> CollectiveAlgorithm:
        """Resolve AUTO for one call. Returns AUTO itself for ops without
        an algorithm axis (send, recv, copy, ...) and for 1-rank worlds —
        the caller's static default applies."""
        valid = VALID_ALGORITHMS.get(op)
        if not valid or world_size <= 1:
            return CollectiveAlgorithm.AUTO
        key = (op, int(world_size), nbytes_bucket(nbytes))
        with self._lock:
            pinned = self._pinned.get(key)
            if pinned is not None:
                return pinned
            decided = self._decisions.get(key)
            if decided is None:
                decided = self._decide(key, op, world_size, nbytes, valid)
                self._decisions[key] = decided
            return decided

    def _decide(self, key: tuple, op: str, world_size: int, nbytes: int,
                valid) -> CollectiveAlgorithm:
        """Compute one key's decision (lock held)."""
        topo = self._topo(world_size)
        if self.epsilon > 0 and self._rng.random() < self.epsilon:
            # exploration draws only from algorithms the tier's engines
            # implement (Topology.supported) — exploring an algorithm the
            # peer daemon rejects would fail every call of the bucket —
            # AND whose predicted cost is finite: an infinite price
            # marks an algorithm no execution path can honor here
            # (HIERARCHICAL on a one-tier topology / sub-communicator),
            # which the driver would silently substitute with the flat
            # default, wasting the exploration epoch on a mislabeled
            # measurement stream
            import math as _math
            cands = sorted(a for a in valid
                           if (topo.supported is None
                               or (op, a) in topo.supported)
                           and _math.isfinite(predict_us(
                               op, a, topo, nbytes, world_size)))
            if cands:
                pick = self._rng.choice(cands)
                # exploration cost is observable process-wide: each pick
                # shows up in ACCL.metrics_snapshot() next to the plan
                # cache invalidations/misses it may trigger at refresh
                from ..tracing import METRICS
                METRICS.inc("tuner_exploration_picks_total", op=op,
                            world=world_size, algorithm=pick.name)
                return pick
        stats = self._measured.get(key, {})
        best, best_score = None, None
        for alg, predicted in rank_algorithms(op, topo, nbytes,
                                              world_size):
            st = stats.get(alg)
            score = (st.ewma_us if st is not None
                     and st.n >= self.min_samples else predicted)
            if best_score is None or score < best_score:
                best, best_score = alg, score
        if best is None:  # no cost model either: static default
            best = DEFAULT_ALGORITHMS.get(op, CollectiveAlgorithm.AUTO)
        return best

    # -- quantized-wire selection (accl_tpu_torch/quant.py) ----------------------
    def select_wire(self, op: str, world_size: int, nbytes: int,
                    ratio: float | None = None) -> bool:
        """True when the block-scaled quantized wire variant wins for
        this (op, world, size): measured wire EWMAs (both variants
        sampled >= min_samples, fed by :meth:`observe_wire` /
        benchmarks/tune.py's wire sweep) beat the cost model, which
        otherwise prices the variants analytically (rank_wire, cost.py)
        — bandwidth-bound calls quantize, latency-bound calls never do.
        Sticky per bucket like algorithm decisions (every rank of a
        collective must agree), dropped by :meth:`refresh`."""
        from .cost import WIRE_PRICED_OPS, rank_wire
        if (op not in VALID_ALGORITHMS and op not in WIRE_PRICED_OPS) \
                or world_size <= 1:
            # algorithm-less exchanges (alltoall/alltoallv) have no
            # VALID_ALGORITHMS row but still carry a wire decision
            return False
        key = ("wire", op, int(world_size), nbytes_bucket(nbytes))
        with self._lock:
            decided = self._decisions.get(key)
            if decided is None:
                stats = self._measured.get(key, {})
                qs, ps = stats.get(True), stats.get(False)
                if (qs is not None and ps is not None
                        and qs.n >= self.min_samples
                        and ps.n >= self.min_samples):
                    decided = qs.ewma_us < ps.ewma_us
                else:
                    decided = rank_wire(op, self._topo(world_size),
                                        nbytes, world_size, ratio)[0]
                self._decisions[key] = decided
            return bool(decided)

    def observe_wire(self, op: str, world_size: int, nbytes: int,
                     quantized: bool, duration_s: float,
                     error_word: int = 0) -> bool:
        """Feed one retired call's duration under its wire variant
        (quantized = BLOCK_SCALED ran). The per-bucket EWMA pair
        replaces the analytic crossover once both variants have
        evidence. Failed calls are ignored, like :meth:`observe`."""
        from .cost import WIRE_PRICED_OPS
        if (error_word or world_size <= 1
                or (op not in VALID_ALGORITHMS
                    and op not in WIRE_PRICED_OPS)):
            return False
        key = ("wire", op, int(world_size), nbytes_bucket(nbytes))
        with self._lock:
            stats = self._measured.setdefault(key, {})
            stats.setdefault(bool(quantized), _Stat()).update(
                duration_s * 1e6, self.ewma_weight)
        return True

    def recommend_quant_block(self, nbytes: int) -> int:
        """Scale-block size for a block-scaled call of ``nbytes``
        (uncompressed payload): larger payloads amortize toward larger
        blocks (the 4-byte scale per block is pure overhead), small
        ones keep fine-grained scales for dynamic-range tracking.
        Deterministic in nbytes, so every rank derives the same block."""
        if nbytes >= 8 << 20:
            return 256
        if nbytes >= 128 << 10:
            return 128
        return 64

    # -- RMA eager/rendezvous crossover (accl_tpu_torch/rma) ---------------------
    RMA_EAGER_MIN_B = 4 << 10
    RMA_EAGER_MAX_B = 256 << 10

    def recommend_rma_eager_max(self) -> int:
        """Byte threshold below which a one-sided put should go EAGER
        (single frame through the target's rx pool) instead of
        RENDEZVOUS (RTS/CTS, then segments landing directly in the
        window). Priced analytically from the topology — rendezvous
        pays one extra control round trip (~2*alpha_us) before any
        payload moves, eager pays the rx-pool staging copy (~nbytes at
        the link's beta) — and refined by measured put latencies fed
        through :meth:`observe_rma_put`: once both variants of a size
        bucket have ``min_samples`` observations, the measured winner
        moves the crossover. Clamped to [4 KiB, 256 KiB], floored to a
        power of two, sticky until :meth:`refresh` (the engine reads it
        per transfer; a mid-flight flip is harmless — the plan kind is
        carried in the opening frame — but determinism helps tests).
        ``$ACCL_TPU_RMA_EAGER_MAX`` still wins when set: the engine
        consults the tuner only when neither the constructor nor the
        environment pinned a threshold."""
        key = ("rma_eager_max",)
        with self._lock:
            decided = self._decisions.get(key)
            if decided is not None:
                return int(decided)
            topo = self.topology or Topology()
            cross = 2.0 * topo.alpha_us * topo.beta_gbps * 1e3
            eager_win, rdv_win = [], []
            for k, stats in self._measured.items():
                if not (len(k) == 2 and k[0] == "rma_eager"):
                    continue
                e, r = stats.get(True), stats.get(False)
                if (e is None or r is None or e.n < self.min_samples
                        or r.n < self.min_samples):
                    continue
                size = 1 << int(k[1])  # bucket upper bound, bytes
                (eager_win if e.ewma_us <= r.ewma_us
                 else rdv_win).append(size)
            if rdv_win:
                # conservative: stay below the smallest size where
                # rendezvous measurably wins, whatever the model says
                cross = min(cross, min(rdv_win) / 2)
            clean = [s for s in eager_win
                     if not rdv_win or s < min(rdv_win)]
            if clean:
                cross = max(cross, max(clean))
            cross = max(self.RMA_EAGER_MIN_B,
                        min(self.RMA_EAGER_MAX_B, int(cross)))
            cross = 1 << (cross.bit_length() - 1)  # power-of-two floor
            self._decisions[key] = cross
            return cross

    def observe_rma_put(self, nbytes: int, eager: bool,
                        duration_s: float, error_word: int = 0) -> bool:
        """Feed one retired put's issue->land latency under the variant
        it actually ran (True = eager). The engine feeds only CLEAN
        zero-retry puts — a retried transfer's latency measures the
        fault, not the variant. Evidence moves the crossover at the
        next quiesced :meth:`refresh`, not mid-decision."""
        if error_word or nbytes <= 0 or duration_s < 0:
            return False
        key = ("rma_eager", nbytes_bucket(nbytes))
        with self._lock:
            stats = self._measured.setdefault(key, {})
            stats.setdefault(bool(eager), _Stat()).update(
                duration_s * 1e6, self.ewma_weight)
        return True

    def refresh(self):
        """Drop cached decisions: the next ``select`` per key re-scores
        with the measurements accumulated so far (and re-rolls
        exploration). Call only at quiesced points — no collective may be
        in flight while decisions flip (module docstring). Registered
        compiled-plan caches are invalidated: a flipped decision expands
        a different program, and stale entries for the old algorithm
        must not accumulate (they can never be SERVED stale — plan keys
        carry the concrete algorithm — but observability wants the
        re-resolution counted)."""
        with self._lock:
            self._decisions.clear()
        self._invalidate_plan_caches("tuner")

    # -- compiled-plan cache coupling --------------------------------------
    def register_plan_cache(self, cache):
        """Attach a device's :class:`~accl_tpu_torch.plancache.PlanCache`: it is
        invalidated whenever this tuner's decisions may change
        (``refresh``, ``pin``, ``clear_pins``), and its counters surface
        through :meth:`plan_cache_stats`. Held weakly — caches die with
        their worlds."""
        ref = weakref.ref(cache)
        with self._lock:
            if any(r() is cache for r in self._plan_caches):
                return
            self._plan_caches = [r for r in self._plan_caches
                                 if r() is not None]
            self._plan_caches.append(ref)

    def _invalidate_plan_caches(self, reason: str):
        with self._lock:
            refs = list(self._plan_caches)
        for r in refs:
            cache = r()
            if cache is not None:
                cache.invalidate(reason)

    def plan_cache_stats(self) -> dict:
        """Aggregate counters over every live registered plan cache —
        the tuner-side observability of exploration cost (each
        epsilon-greedy re-roll that flips an algorithm shows up as an
        invalidation plus a run of misses)."""
        agg = {"caches": 0, "entries": 0, "hits": 0, "misses": 0,
               "bypasses": 0, "evictions": 0, "invalidations": {}}
        with self._lock:
            refs = list(self._plan_caches)
        for r in refs:
            cache = r()
            if cache is None:
                continue
            st = cache.stats()
            agg["caches"] += 1
            for k in ("entries", "hits", "misses", "bypasses",
                      "evictions"):
                agg[k] += st[k]
            for reason, n in st["invalidations"].items():
                agg["invalidations"][reason] = \
                    agg["invalidations"].get(reason, 0) + n
        return agg

    # -- online refinement -------------------------------------------------
    def observe(self, op: str, world_size: int, nbytes: int,
                algorithm: CollectiveAlgorithm, duration_s: float,
                error_word: int = 0) -> bool:
        """Feed one retired call's measured duration. Failed calls and
        AUTO-labeled records (nothing concrete to credit) are ignored.
        Returns True iff the measurement was credited."""
        alg = CollectiveAlgorithm(algorithm)
        if (error_word or alg == CollectiveAlgorithm.AUTO
                or op not in VALID_ALGORITHMS or world_size <= 1):
            return False
        key = (op, int(world_size), nbytes_bucket(nbytes))
        with self._lock:
            stats = self._measured.setdefault(key, {})
            stats.setdefault(alg, _Stat()).update(duration_s * 1e6,
                                                  self.ewma_weight)
        return True

    def ingest_records(self, records, world_size: int,
                       world_by_comm: dict[int, int] | None = None) -> int:
        """Bulk-load :class:`~accl_tpu_torch.tracing.CallRecord` history (records
        carry the concrete algorithm the call ran; "AUTO"/"" labels are
        skipped). Returns how many records were usable.

        Records only carry ``comm_id``, not the communicator's size —
        pass ``world_by_comm`` (comm_id -> size, e.g. built from
        ``ACCL.communicators``) when the history includes split-
        communicator collectives, or their durations would be mis-keyed
        under the world size. Unknown comm_ids fall back to
        ``world_size``."""
        world_by_comm = world_by_comm or {}
        n = 0
        for r in records:
            alg_name = getattr(r, "algorithm", "")
            try:
                alg = CollectiveAlgorithm[alg_name]
            except KeyError:
                continue
            if alg == CollectiveAlgorithm.AUTO:
                continue  # backend-internal choice: nothing to credit
            w = world_by_comm.get(getattr(r, "comm_id", 0), world_size)
            if self.observe(r.op, w, r.nbytes, alg, r.duration_s,
                            getattr(r, "error_word", 0)):
                n += 1
        return n

    # -- segment sizing ----------------------------------------------------
    def recommend_segment_size(self, preferred: int) -> int:
        """Segment size for this tuner's topology, bounded by the
        backend's ``preferred_segment_size()`` (passed as ``preferred``)."""
        return recommend_segment_size(self.topology or Topology(),
                                      preferred)

    # -- table import/export (cache.py serializes these) -------------------
    def pin(self, op: str, world_size: int, bucket: int,
            algorithm: CollectiveAlgorithm):
        """Force one key's selection (loaded tuning-table entry). The
        (op, algorithm) pair must be legal — a pin that check_algorithm
        would reject later must fail HERE, at load time, not on every
        call of the op."""
        alg = CollectiveAlgorithm(algorithm)
        if alg not in VALID_ALGORITHMS.get(op, frozenset()):
            raise ValueError(
                f"cannot pin {alg.name} for {op}: not a legal algorithm")
        with self._lock:
            self._pinned[(op, int(world_size), int(bucket))] = alg
        self._invalidate_plan_caches("tuner")

    def clear_pins(self):
        """Drop loaded tuning-table pins (a re-tune must measure from
        scratch, not echo the stale table back)."""
        with self._lock:
            self._pinned.clear()
        self._invalidate_plan_caches("tuner")

    def entries(self) -> list[dict]:
        """Current decisions as serializable rows: one per key that has a
        pin or at least one measured algorithm, ``expected_us`` being the
        winning score (pinned entries re-export with their measured EWMA
        when one exists, else 0)."""
        with self._lock:
            # 3-tuple algorithm keys and 4-tuple ("wire", ...) keys sort
            # together safely: position 0 is a string either way and no
            # op is named "wire"
            keys = sorted(set(self._pinned) | set(self._measured))
            out = []
            for key in keys:
                if len(key) != 3:
                    continue  # ("wire", ...) variant stats: not a table
                    # row (select_wire reads them directly)
                op, world, bucket = key
                stats = self._measured.get(key, {})
                pinned = self._pinned.get(key)
                if pinned is not None:
                    st = stats.get(pinned)
                    choice, score = pinned, (st.ewma_us if st else 0.0)
                    samples = st.n if st else 0
                else:
                    choice, score, samples = None, None, 0
                    for alg in sorted(stats):
                        st = stats[alg]
                        if st.n >= self.min_samples and (
                                score is None or st.ewma_us < score):
                            choice, score, samples = alg, st.ewma_us, st.n
                    if choice is None:
                        continue  # nothing trustworthy to persist
                out.append({"op": op, "world": world, "bucket": bucket,
                            "algorithm": choice.name,
                            "expected_us": round(float(score), 3),
                            "samples": samples})
            return out

    def clear_measurements(self):
        with self._lock:
            self._measured.clear()

    def describe(self) -> str:
        rows = [f"{'op':<16}{'W':>4}{'bucket':>8}{'algorithm':>14}"
                f"{'us':>12}{'n':>5}"]
        for e in self.entries():
            rows.append(f"{e['op']:<16}{e['world']:>4}{e['bucket']:>8}"
                        f"{e['algorithm']:>14}{e['expected_us']:>12.1f}"
                        f"{e['samples']:>5}")
        return "\n".join(rows)
