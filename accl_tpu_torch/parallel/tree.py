"""Rooted collectives over W ranks on one device: binomial trees and the
2D tree reduction.

The counterpart of ``accl_tpu/parallel/tree.py``. The reference runs the
rooted ops as binomial ppermute rounds over the (flattened) rank axis;
here each round is one batch of transfers between rank rows, in the
same order, with the same blocks, so wire bytes equal the reference
schedule's (:func:`gather_rounds` / :func:`scatter_rounds`).

A per-tensor wire dtype is a PURE cast per hop for every wire dtype,
fp8 included (the reference's ``_wire_permute``): the payload goes down
to the wire dtype and back to f32 (two B2 launches per round, covering
all of the round's pairs). Casts are idempotent, so a relayed chunk
lands as if quantized once, and the root's own data stays exact.

:class:`Tree2DCollectives` is the reference's ``Tree2DCollectives`` over
a rank grid folded to (outer, inner) = :func:`factor_2d`. Its bcast,
scatter and gather are the binomial schedules above over the flattened
grid, so only ``reduce`` differs from the 1-D path: the two-phase
reduction (outer, then inner) through the B1 combine kernel.
"""

from __future__ import annotations

import torch

from ..constants import ReduceFunc
from .collectives import KERNELS, Kernels


def factor_2d(w: int) -> tuple[int, int]:
    """Largest divisor pair (outer, inner) with outer <= inner; (1, w)
    means the world has no 2D structure."""
    o = int(w ** 0.5)
    while o > 1 and w % o:
        o -= 1
    return o, w // o


def _bit_rounds(W: int) -> int:
    return max(1, (W - 1).bit_length())


def gather_rounds(W: int) -> list[tuple[int, int, list[int]]]:
    """Static (subtree_size, block_chunks, sender_vranks) per doubling
    round; a single-sender round's block truncates to the sender's real
    span (the reference's schedule, byte for byte)."""
    rounds = []
    for k in range(_bit_rounds(W)):
        size = 1 << k
        vs = list(range(size, W, 2 * size))
        if not vs:
            break
        block = size if len(vs) > 1 else min(size, W - vs[0])
        rounds.append((size, block, vs))
    return rounds


def scatter_rounds(W: int) -> list[tuple[int, int, list[int]]]:
    """Static (subtree_size, block_chunks, sender_vranks) per halving
    round (consumed largest-size first)."""
    rounds = []
    for k in range(_bit_rounds(W)):
        size = 1 << k
        vs = [v for v in range(0, W, 2 * size) if v + size < W]
        if not vs:
            continue
        block = size if len(vs) > 1 else min(size, W - (vs[0] + size))
        rounds.append((size, block, vs))
    return rounds


def transit(srcs, dsts, k: Kernels, wire) -> None:
    """One round's transfers: ``dsts[i]`` receives ``srcs[i]``, through
    a pure cast to ``wire`` and back (two B2 launches) when one is
    given, else as a copy."""
    if wire is None:
        for s, d in zip(srcs, dsts):
            d.copy_(s)
        return
    k.cast(k.cast(srcs, wire), torch.float32, dsts)


def binomial_bcast(rows, root: int, out_rows, k: Kernels = KERNELS,
                   wire=None):
    """Binomial broadcast: ceil(log2 W) rounds, round j sends from vranks
    [0, 2^j) to [2^j, 2^(j+1)); (W-1)|x| wire bytes. ``rows[root]`` is
    the source; ``out_rows[r]`` receives it (the root's row is its exact
    input). Non-root input rows are never read, so ``out_rows`` may be
    ``rows`` (an in-place broadcast)."""
    W = len(rows)
    if out_rows[root].data_ptr() != rows[root].data_ptr():
        out_rows[root].copy_(rows[root])
    held = {root: rows[root]}
    for j in range(_bit_rounds(W)):
        stride = 1 << j
        pairs = [((v + root) % W, (v + stride + root) % W)
                 for v in range(stride) if v + stride < W]
        if not pairs:
            break
        transit([held[s] for s, _ in pairs], [out_rows[d] for _, d in pairs],
                k, wire)
        for _, d in pairs:
            held[d] = out_rows[d]
    return out_rows


def binomial_gather(rows, root: int, out_rows, k: Kernels = KERNELS,
                    wire=None):
    """Binomial gather: ``rows[r]`` (c elements) -> ``out_rows[root]``
    (W*c, chunk j from rank j). Doubling blocks: round j moves blocks of
    up to 2^j chunks from odd-subtree roots to their parents. Every rank
    holds its subtree in vrank space, padded to a power of two (as the
    reference, so no block is clamped). Non-root ``out_rows`` entries are
    zeroed, or skipped when None."""
    W = len(rows)
    c = rows[0].numel()
    for r, o in enumerate(out_rows):
        if o is not None and r != root:
            o.zero_()
    if W == 1:
        out_rows[0].copy_(rows[0])
        return out_rows
    P = 1 << _bit_rounds(W)
    vr = [(r - root) % W for r in range(W)]
    acc = torch.zeros((W, P, c), dtype=rows[0].dtype, device=rows[0].device)
    for r in range(W):
        acc[r, vr[r]].copy_(rows[r])
    for size, bs, senders in gather_rounds(W):
        pairs = [((v + root) % W, (v - size + root) % W) for v in senders]
        transit([acc[s, vr[s]:vr[s] + bs].reshape(-1) for s, _ in pairs],
                [acc[d, vr[d] + size:vr[d] + size + bs].reshape(-1)
                 for _, d in pairs], k, wire)
    # acc[root][v] is the chunk of rank (v + root) % W
    out = out_rows[root].view(W, c)
    out[root:].copy_(acc[root, :W - root])
    out[:root].copy_(acc[root, W - root:W])
    return out_rows


def binomial_scatter(rows, root: int, out_rows, k: Kernels = KERNELS,
                     wire=None):
    """Binomial scatter: ``rows[root]`` (W*c) -> ``out_rows[r]`` (its
    chunk r). Halving blocks from the top: round j hands each subtree
    root the block for its far subtree. Every rank holds W chunks in
    vrank space, its own operand rotated in (None: zeros); a block near
    the top of a world that is not a power of two clamps to the same
    start on both sides, as the reference's dynamic slices do."""
    W = len(rows)
    src = rows[root]
    c = src.numel() // W
    if W == 1:
        out_rows[0].copy_(src)
        return out_rows
    vr = [(r - root) % W for r in range(W)]
    buf = torch.zeros((W, W, c), dtype=src.dtype, device=src.device)
    for r, x in enumerate(rows):
        if x is not None:
            x = x.view(W, c)
            buf[r, :W - root].copy_(x[root:])
            buf[r, W - root:].copy_(x[:root])
    for size, bs, senders in reversed(scatter_rounds(W)):
        starts = [min(v + size, W - bs) for v in senders]
        pairs = [((v + root) % W, (v + size + root) % W) for v in senders]
        transit([buf[s, a:a + bs].reshape(-1)
                 for (s, _), a in zip(pairs, starts)],
                [buf[d, a:a + bs].reshape(-1)
                 for (_, d), a in zip(pairs, starts)], k, wire)
    for r in range(W):
        out_rows[r].copy_(buf[r, vr[r]])
    return out_rows


class Tree2DCollectives:
    """The 2D tree reduction over the W ranks of a
    :class:`RankCollectives` folded row-major into an (outer, inner) grid
    (rank = o * inner + i). The reference's tree bcast / scatter / gather
    are the binomial schedules over the flattened grid, which
    ``RankCollectives`` runs as they are."""

    def __init__(self, coll, outer: int, inner: int):
        if outer * inner != coll.W or outer < 2:
            raise ValueError(f"a {outer}x{inner} grid does not fold "
                             f"{coll.W} ranks")
        self.coll = coll
        self.O, self.I, self.W = outer, inner, coll.W

    @classmethod
    def fold(cls, coll) -> "Tree2DCollectives | None":
        """The grid of ``coll``'s world, or None without 2D structure."""
        o, i = factor_2d(coll.W)
        return cls(coll, o, i) if o >= 2 else None

    def reduce(self, x, root: int = 0, func: ReduceFunc = ReduceFunc.SUM,
               out=None):
        """Columns reduce along ``outer`` (one combine launch per outer
        step over all ``inner`` columns), then the row of partials along
        ``inner`` into the root. Only the root's row of ``out`` gets the
        result; other rows are zeroed (skipped when None)."""
        coll = self.coll
        rows = coll._rows(x)
        n = rows[0].numel()
        ret, out_rows = coll._out(out, rows, n)
        O, I, k = self.O, self.I, coll.kernels
        func = ReduceFunc(func)
        partial = list(torch.empty((I, n), dtype=rows[0].dtype,
                                   device=rows[0].device))
        k.combine(rows[:I], rows[I:2 * I], func, partial)
        for o in range(2, O):
            k.combine(partial, rows[o * I:(o + 1) * I], func, partial)
        full = out_rows[root]
        k.combine(partial[0], partial[1], func, full)
        for i in range(2, I):
            k.combine(full, partial[i], func, full)
        for r, o in enumerate(out_rows):
            if o is not None and r != root:
                o.zero_()
        return ret
