"""Ulysses sequence parallelism: alltoall head/sequence re-sharding.

The counterpart of ``accl_tpu/parallel/ulysses.py``. Instead of rotating
K/V around the ranks, one alltoall re-shards the activations from
sequence-parallel (every rank: all heads, S/W tokens) to head-parallel
(every rank: H/W heads, all tokens), attention runs locally per head
group, and a second alltoall restores sequence sharding.

Operands are rank rows (W, B, h, S_l, D), as in :mod:`.ring_attention`.
``seq_to_heads`` lays each rank's shard out as W head chunks, chunk j
for rank j (``RankCollectives.alltoall``), and concatenates the chunks
it receives along the sequence: the reference's
``lax.all_to_all(split_axis=1, concat_axis=2, tiled=True)``;
``heads_to_seq`` is its inverse. Both are pure data movement and
differentiable (each one's backward is the other).
"""

from __future__ import annotations

import torch

from ..ops.attention import flash_attention
from .collectives import RankCollectives
from .ring_attention import _check, from_rank_rows, to_rank_rows


def _to_heads(x, coll: RankCollectives):
    W = coll.W
    _, B, H, S, D = x.shape
    if H % W:
        raise ValueError(f"heads {H} not divisible by axis size {W}")
    rows = x.reshape(W, B, W, H // W, S, D).transpose(1, 2).reshape(W, -1)
    got = coll.alltoall(rows)       # row r, chunk j: rank j's heads group r
    return got.view(W, W, B, H // W, S, D).permute(0, 2, 3, 1, 4, 5) \
        .reshape(W, B, H // W, W * S, D)


def _to_seq(x, coll: RankCollectives):
    W = coll.W
    _, B, h, S, D = x.shape
    if S % W:
        raise ValueError(f"sequence length {S} not divisible by axis size "
                         f"{W}")
    rows = x.reshape(W, B, h, W, S // W, D).permute(0, 3, 1, 2, 4, 5) \
        .reshape(W, -1)
    got = coll.alltoall(rows)       # row r, chunk j: rank j's slice r
    return got.view(W, W, B, h, S // W, D).transpose(1, 2) \
        .reshape(W, B, W * h, S // W, D)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll):
        ctx.coll = coll
        return _to_heads(x, coll)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _to_seq(g, ctx.coll), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll):
        ctx.coll = coll
        return _to_seq(x, coll)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _to_heads(g, ctx.coll), None


def seq_to_heads(x, coll: RankCollectives) -> torch.Tensor:
    """(W, B, H, S_l, D) sequence-sharded rank rows -> (W, B, H/W, W*S_l,
    D) head-sharded: rank r gets heads r*H/W .. over the whole
    sequence. Requires H % W == 0."""
    return _SeqToHeads.apply(x, coll)


def heads_to_seq(x, coll: RankCollectives) -> torch.Tensor:
    """Inverse of :func:`seq_to_heads`: (W, B, H/W, S, D) -> (W, B, H,
    S/W, D)."""
    return _HeadsToSeq.apply(x, coll)


def ulysses_attention(q, k, v, coll: RankCollectives, causal: bool = True,
                      sm_scale: float | None = None) -> torch.Tensor:
    """Attention over the whole sequence through head-parallel
    re-sharding. q (W, B, H, S_l, D); k/v (W, B, Hkv, S_l, D) with Hkv
    dividing H. GQA K/V ride the alltoall un-repeated when Hkv splits
    over the W ranks; otherwise they repeat minimally (to one head a rank
    when W % Hkv == 0, else to H), the reference's rule. The attention
    is one ``flash_attention`` call over all ranks, the rank a batch
    axis (B8 or B9; B10 and B11 under autograd). Returns (W, B, H, S_l,
    D)."""
    _check(q, k, v, coll)
    W = coll.W
    H, Hkv = q.shape[2], k.shape[2]
    qh = seq_to_heads(q, coll)
    if Hkv % W and H != Hkv:
        rep = (W // Hkv) if W % Hkv == 0 else (H // Hkv)
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    kh = seq_to_heads(k, coll)
    vh = seq_to_heads(v, coll)
    _, B, h, S, D = qh.shape
    out = flash_attention(qh.reshape(W * B, h, S, D),
                          kh.reshape(W * B, kh.shape[2], S, D),
                          vh.reshape(W * B, vh.shape[2], S, D),
                          causal=causal, sm_scale=sm_scale)
    return heads_to_seq(out.reshape(W, B, h, S, D), coll)


def ulysses_attention_sharded(q, k, v, mesh, axis_name: str = "sp",
                              causal: bool = True,
                              sm_scale: float | None = None) -> torch.Tensor:
    """Global-tensor wrapper mirroring
    :func:`.ring_attention.ring_attention_sharded`."""
    coll = RankCollectives(mesh.group(axis_name))
    rows = [to_rank_rows(t, coll.W) for t in (q, k, v)]
    return from_rank_rows(ulysses_attention(*rows, coll, causal, sm_scale))
