"""Sharding specs: how a 1-D global vector is laid out across ranks.

A copy of ``accl_tpu/hier/sharding.py`` (pure geometry, no framework).
The redistribution engine needs only a small spec algebra: every layout
a serving or resharding layer asks for is some combination of

* **block** — contiguous per-rank blocks (possibly uneven, possibly
  zero on non-participating ranks);
* **cyclic** — equal chunks dealt round-robin (rank r holds chunks
  r, r+W, ...), the block-cyclic family's degenerate case;
* **block_cyclic** — chunks dealt round-robin over a rank PERMUTATION
  (``order``), dropping cyclic's divisibility constraints: the chunk
  count need not divide evenly over ranks and the last chunk may be
  partial, so per-rank element counts are UNEVEN. The serving layer's
  KV-block layout: blocks deal across decode ranks in placement-
  preference order, and an elastic grow/shrink reshards block->
  block_cyclic without padding;
* **replicated** — every participating rank holds the full vector.

A spec is hashable and pure-geometry: :meth:`intervals` maps a rank to
its ``(global_offset, count, local_offset)`` triples, which is all the
compiler (redistribute.py) consumes. Specs are independent of dtype and
of the communicator object — they bind at plan time.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ShardSpec"]


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Layout of an ``n``-element vector over ``world`` comm ranks."""

    kind: str        # "block" | "cyclic" | "block_cyclic" | "replicated"
    world: int
    n: int
    counts: tuple[int, ...] = ()    # block: per-rank elements (sum == n)
    chunk: int = 0                  # (block_)cyclic: elements per chunk
    order: tuple[int, ...] = ()     # block_cyclic: deal permutation —
    # chunk k lands on rank order[k % world]

    # -- constructors -------------------------------------------------------
    @classmethod
    def block(cls, counts) -> "ShardSpec":
        """Contiguous blocks, ``counts[r]`` elements on rank r (0 = rank
        holds nothing)."""
        counts = tuple(int(c) for c in counts)
        if any(c < 0 for c in counts):
            raise ValueError(f"negative block count in {counts}")
        return cls(kind="block", world=len(counts), n=sum(counts),
                   counts=counts)

    @classmethod
    def even(cls, n: int, world: int) -> "ShardSpec":
        """Equal blocks (n must divide evenly)."""
        if n % world:
            raise ValueError(f"{n} elements do not split evenly over "
                             f"{world} ranks — use ShardSpec.block or "
                             f"ShardSpec.balanced")
        return cls.block((n // world,) * world)

    @classmethod
    def balanced(cls, n: int, world: int) -> "ShardSpec":
        """Near-even blocks of a NON-divisible vector: explicit per-rank
        counts differing by at most one element (the first ``n % world``
        ranks carry the extra). This is the canonical membership-driven
        layout for elastic grow/shrink reshards — a world-size change of
        arbitrary state compiles to the block->block boundary-shift
        program (a handful of minimal transfers) instead of requiring
        divisibility or padding."""
        if world <= 0:
            raise ValueError(f"world must be positive, got {world}")
        q, r = divmod(int(n), world)
        return cls.block(tuple(q + 1 if i < r else q
                               for i in range(world)))

    @classmethod
    def cyclic(cls, n: int, world: int, chunk: int) -> "ShardSpec":
        """Round-robin deal of ``chunk``-element pieces: rank r holds
        chunks r, r+world, ... . ``n`` must be a whole number of chunks
        and each rank must get the same number of them (the uniform
        block-cyclic case the alltoall fast path keys on)."""
        if chunk <= 0 or n % chunk:
            raise ValueError(f"{n} elements are not a whole number of "
                             f"{chunk}-element chunks")
        if (n // chunk) % world:
            raise ValueError(
                f"{n // chunk} chunks do not deal evenly over {world} "
                f"ranks")
        return cls(kind="cyclic", world=world, n=n, chunk=chunk)

    @classmethod
    def block_cyclic(cls, n: int, world: int, chunk: int,
                     order=None) -> "ShardSpec":
        """Round-robin deal of ``chunk``-element pieces over a rank
        SEQUENCE: chunk k (global elements ``[k*chunk, (k+1)*chunk)``)
        lands on rank ``order[k % len(order)]``. Unlike :meth:`cyclic`
        there are NO divisibility constraints — the last chunk may be
        partial and ranks early in ``order`` may own one chunk more
        than ranks late in it (uneven per-rank counts). ``order`` may
        also be a strict SUBSET of the world (distinct ranks; the rest
        own nothing) — how an elastic reshard expresses the old pool's
        layout inside the grown communicator. ``order=None`` deals over
        every rank in index order (cyclic's placement with cyclic's
        constraints dropped)."""
        if chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        if n < 0 or world <= 0:
            raise ValueError(f"bad geometry: n={n}, world={world}")
        order = (tuple(range(world)) if order is None
                 else tuple(int(r) for r in order))
        if not order or len(set(order)) != len(order) \
                or any(r < 0 or r >= world for r in order):
            raise ValueError(
                f"order {order} must be distinct ranks within "
                f"world {world}")
        return cls(kind="block_cyclic", world=world, n=n, chunk=chunk,
                   order=order)

    @classmethod
    def replicated(cls, n: int, world: int) -> "ShardSpec":
        return cls(kind="replicated", world=world, n=n)

    # -- geometry -----------------------------------------------------------
    def local_count(self, rank: int) -> int:
        """Elements rank ``rank`` stores (its buffer must hold these)."""
        if self.kind == "block":
            return self.counts[rank]
        if self.kind == "cyclic":
            return self.n // self.world
        if self.kind == "block_cyclic":
            return sum(c for _, c, _ in self.intervals(rank))
        return self.n

    def intervals(self, rank: int) -> list[tuple[int, int, int]]:
        """``(global_offset, count, local_offset)`` runs of rank's shard,
        ascending in both global and local offset (the invariant the
        per-pair transfer ordering relies on)."""
        if self.kind == "replicated":
            return [(0, self.n, 0)] if self.n else []
        if self.kind == "block":
            off = sum(self.counts[:rank])
            c = self.counts[rank]
            return [(off, c, 0)] if c else []
        if self.kind == "block_cyclic":
            # chunk k -> rank order[k % len(order)]; only the LAST
            # global chunk can be partial, so local offsets are whole
            # chunks. Ranks outside the deal sequence own nothing.
            if rank not in self.order:
                return []
            pos = self.order.index(rank)
            period = len(self.order)
            out = []
            loc = 0
            for g in range(pos * self.chunk, self.n,
                           period * self.chunk):
                c = min(self.chunk, self.n - g)
                out.append((g, c, loc))
                loc += c
            return out
        out = []
        loc = 0
        for g in range(rank * self.chunk, self.n,
                       self.world * self.chunk):
            out.append((g, self.chunk, loc))
            loc += self.chunk
        return out

    def participants(self) -> tuple[int, ...]:
        """Ranks that hold at least one element."""
        return tuple(r for r in range(self.world)
                     if self.local_count(r) > 0)

    def describe(self) -> str:
        if self.kind == "block":
            return f"block{list(self.counts)}"
        if self.kind == "cyclic":
            return f"cyclic(n={self.n}, chunk={self.chunk}, W={self.world})"
        if self.kind == "block_cyclic":
            return (f"block_cyclic(n={self.n}, chunk={self.chunk}, "
                    f"W={self.world}, order={list(self.order)})")
        return f"replicated(n={self.n}, W={self.world})"
