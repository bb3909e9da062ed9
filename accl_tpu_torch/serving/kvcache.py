"""KV-block placement, prefix reuse, and eviction over RMA windows.

The port's copy of ``accl_tpu/serving/kvcache.py`` (pure host code).

The decode side of a disaggregated deployment registers one window per
rank (the paged KV arena: ``blocks_per_rank`` fixed-size slots). This
manager is the host-side control plane over those arenas:

* **Placement** — a request lands on the decode rank holding its
  longest cached prefix (maximizing reuse); ties break to the
  least-loaded rank by the live ``kv_blocks_in_use`` gauge, so fresh
  traffic spreads by actual occupancy, not round-robin.
* **Prefix sharing** — blocks are keyed by ``(token-prefix hash,
  rank)`` (the hash chain :func:`prefix_hashes` computes): two requests
  sharing a system prompt on the same decode rank share its blocks by
  REFERENCE. The first request pays the transfer (a put-with-notify per
  missing block); every later request's hit is a refcount bump — ZERO
  wire bytes, the invariant the serving path checks
  (``kv_wire_bytes_saved_total`` counts what sharing avoided). The rank
  in the key matters: a block's bytes live in ONE rank's window, so a
  request placed elsewhere pays its own copy rather than aliasing a
  table entry it cannot address.
* **Eviction** — releasing a request decrefs its blocks; at refcount 0
  a block stays CACHED (it may hit again) on an LRU list, and is
  evicted only when an allocation on its rank finds no free slot.
  In-use blocks are never evicted: a decode step's addresses stay
  valid without pinning calls.

The manager moves no bytes itself: :meth:`acquire` returns the hit and
miss block references and the caller executes one put-with-notify per
miss into ``(ref.rank, window, ref.offset)``. That split keeps the
whole policy — placement, sharing, eviction — a pure data structure the
tests drive without a world.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict

from ..tracing import METRICS

__all__ = ["BlockRef", "KVBlockManager", "prefix_hashes"]


def prefix_hashes(tokens, block_tokens: int) -> tuple[int, ...]:
    """Hash chain of ``tokens`` in ``block_tokens`` steps: element i
    identifies the prefix ``tokens[:(i+1)*block_tokens]`` (the last,
    possibly partial block included). Chained — each hash folds in the
    previous block's state — so block i can only ever be shared between
    requests whose ENTIRE prefix up to i agrees, which is what makes a
    by-hash block table safe to share by reference."""
    if block_tokens <= 0:
        raise ValueError(f"block_tokens must be positive, got "
                         f"{block_tokens}")
    out = []
    h = hashlib.blake2b(digest_size=8)
    toks = list(tokens)
    for i in range(0, len(toks), block_tokens):
        h.update(b"".join(int(t).to_bytes(8, "little", signed=True)
                          for t in toks[i:i + block_tokens]))
        out.append(int.from_bytes(h.digest(), "little"))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class BlockRef:
    """One KV block's location: slot ``slot`` of rank ``rank``'s arena
    (byte offset ``offset`` inside that rank's registered window)."""

    key: int      # prefix hash identifying the block's contents
    rank: int     # decode rank holding it
    slot: int     # arena slot index on that rank
    offset: int   # byte offset into the rank's KV window


class _Entry:
    __slots__ = ("key", "rank", "slot", "refs")

    def __init__(self, key, rank, slot):
        self.key = key
        self.rank = rank
        self.slot = slot
        self.refs = 0


class KVBlockManager:
    """Thread-safe block table over the decode pool's KV windows.

    Args:
        block_nbytes: bytes per KV block (= slot stride in each window).
        blocks_per_rank: arena slots per decode rank.
        ranks: decode ranks (comm-local indices) the pool spans.
        name: metrics label (one manager per serving deployment).
    """

    def __init__(self, block_nbytes: int, blocks_per_rank: int,
                 ranks, name: str = "kv"):
        if block_nbytes <= 0 or blocks_per_rank <= 0:
            raise ValueError("block_nbytes and blocks_per_rank must be "
                             "positive")
        self.block_nbytes = int(block_nbytes)
        self.blocks_per_rank = int(blocks_per_rank)
        self.ranks = tuple(ranks)
        if not self.ranks:
            raise ValueError("decode pool must contain at least one rank")
        self.name = name
        self._mu = threading.Lock()
        # free slots per rank, ascending pop order (determinism in tests)
        self._free: dict[int, list[int]] = {
            r: list(range(self.blocks_per_rank - 1, -1, -1))
            for r in self.ranks}
        self._cached: dict[tuple[int, int], _Entry] = {}  # (hash, rank)
        # refcount-0 entries in eviction order (oldest first)
        self._lru: "OrderedDict[tuple[int, int], _Entry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.wire_bytes_saved = 0
        METRICS.register_collector(self, KVBlockManager._metrics_rows)

    # -- placement ---------------------------------------------------------
    def _in_use_locked(self, rank: int) -> int:
        """Blocks holding live (refs>0) data on ``rank`` — allocated
        minus retained-but-evictable."""
        allocated = self.blocks_per_rank - len(self._free[rank])
        cached0 = sum(1 for k in self._lru if k[1] == rank)
        return allocated - cached0

    def blocks_in_use(self, rank: int) -> int:
        with self._mu:
            return self._in_use_locked(rank)

    def _place_locked(self, hashes) -> int:
        """Longest-cached-prefix rank; ties (including 'nothing cached')
        break to the smallest in-use gauge — the live least-loaded
        choice."""
        def cached_len(r):
            n = 0
            for h in hashes:
                if (h, r) not in self._cached:
                    break
                n += 1
            return n
        return min(self.ranks,
                   key=lambda r: (-cached_len(r),
                                  self._in_use_locked(r), r))

    # -- allocation --------------------------------------------------------
    def _alloc_locked(self, rank: int) -> int | None:
        free = self._free[rank]
        if free:
            return free.pop()
        # evict the oldest refcount-0 block ON THIS RANK (other ranks'
        # retained blocks are not this allocation's problem)
        for key, e in self._lru.items():
            if key[1] == rank:
                del self._lru[key]
                del self._cached[key]
                self.evictions += 1
                return e.slot
        return None

    def acquire(self, hashes) -> tuple[int, list[BlockRef], list[BlockRef]]:
        """Admit one request's prefix chain. Returns ``(rank, hits,
        misses)``: the placement rank, the blocks already cached there
        (refcount bumped — zero wire bytes), and freshly allocated slots
        the caller must fill with one put-with-notify each. Raises
        ``MemoryError`` when the rank cannot hold the request even after
        evicting every refcount-0 block (the admission loop's signal to
        defer the request, mirroring rx-pool backpressure)."""
        hashes = tuple(hashes)
        with self._mu:
            rank = self._place_locked(hashes)
            hits: list[BlockRef] = []
            misses: list[BlockRef] = []
            taken_hits: list[tuple[tuple[int, int], _Entry]] = []
            for h in hashes:
                key = (h, rank)
                e = self._cached.get(key)
                if e is not None:
                    if e.refs == 0:
                        self._lru.pop(key, None)
                    e.refs += 1
                    taken_hits.append((key, e))
                    hits.append(BlockRef(h, e.rank, e.slot,
                                         e.slot * self.block_nbytes))
                    continue
                slot = self._alloc_locked(rank)
                if slot is None:
                    # roll back: admission is all-or-nothing, a
                    # half-admitted request would leak refcounts.
                    # Fresh (miss) entries are DELETED outright — they
                    # hold no data yet, so they must not linger as
                    # evictable cache entries
                    for kk, ee in taken_hits:
                        ee.refs -= 1
                        if ee.refs == 0:
                            self._lru[kk] = ee
                    for m in misses:
                        self._free[rank].append(m.slot)
                        del self._cached[(m.key, rank)]
                    raise MemoryError(
                        f"decode rank {rank}: {len(hashes)} blocks do "
                        f"not fit ({self.blocks_per_rank} slots, "
                        f"{self._in_use_locked(rank)} in use)")
                e = _Entry(h, rank, slot)
                e.refs = 1
                self._cached[key] = e
                misses.append(BlockRef(h, rank, slot,
                                       slot * self.block_nbytes))
            self.hits += len(hits)
            self.misses += len(misses)
            self.wire_bytes_saved += len(hits) * self.block_nbytes
            return rank, hits, misses

    def release(self, hashes, rank: int):
        """Retire one request's references (``rank`` = its placement
        rank from :meth:`acquire`): each block's refcount drops; at 0
        the block moves to the LRU tail — still cached, evictable."""
        with self._mu:
            for h in hashes:
                key = (h, rank)
                e = self._cached.get(key)
                if e is None:
                    continue
                e.refs = max(0, e.refs - 1)
                if e.refs == 0:
                    self._lru[key] = e
                    self._lru.move_to_end(key)

    def lookup(self, hashes, rank: int) -> list[BlockRef]:
        """Resolve a HELD request's block addresses on its placement
        rank — what the decode step feeds its kernel (and what the
        serving path reads back to check the landed bytes).
        Raises ``KeyError`` for a block the caller does not hold (a
        refcount bug: held blocks are never evicted)."""
        with self._mu:
            out = []
            for h in hashes:
                e = self._cached[(h, rank)]
                out.append(BlockRef(h, e.rank, e.slot,
                                    e.slot * self.block_nbytes))
            return out

    def drop_rank(self, rank: int) -> list[int]:
        """Forget every block on ``rank`` (the rank died or left the
        pool). Returns the orphaned prefix hashes — the requests holding
        them must re-acquire (their placement rank is gone; the data is
        not). The rank stops being a placement candidate."""
        with self._mu:
            orphans = [k[0] for k in self._cached if k[1] == rank]
            for h in orphans:
                self._lru.pop((h, rank), None)
                del self._cached[(h, rank)]
            self._free.pop(rank, None)
            self.ranks = tuple(r for r in self.ranks if r != rank)
            return orphans

    def add_rank(self, rank: int):
        """Grow the pool: ``rank`` joins with an empty arena and
        immediately competes as the least-loaded placement choice."""
        with self._mu:
            if rank in self._free:
                return
            self._free[rank] = list(range(self.blocks_per_rank - 1,
                                          -1, -1))
            self.ranks = tuple(sorted((*self.ranks, rank)))

    def cached_blocks(self, rank: int | None = None) -> int:
        with self._mu:
            return sum(1 for k in self._cached
                       if rank is None or k[1] == rank)

    # -- observability: the kv_* family ----------------------------------------
    def _metrics_rows(self):
        labels = {"pool": self.name}
        yield ("counter", "kv_prefix_hits_total", labels, self.hits)
        yield ("counter", "kv_prefix_misses_total", labels, self.misses)
        yield ("counter", "kv_evictions_total", labels, self.evictions)
        yield ("counter", "kv_wire_bytes_saved_total", labels,
               self.wire_bytes_saved)
        with self._mu:
            per_rank = {r: self._in_use_locked(r) for r in self.ranks}
            cached0 = len(self._lru)
        for r, n in per_rank.items():
            yield ("gauge", "kv_blocks_in_use",
                   dict(labels, rank=r), n)
        yield ("gauge", "kv_blocks_cached", labels, cached0)

    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
