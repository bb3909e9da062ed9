"""Megatron-style tensor parallelism over the T ranks of a tp axis.

The counterpart of the shardings ``accl_tpu/models/llama.py`` puts on
its Llama (``param_specs``) and of the psums GSPMD inserts for them. The
port keeps the single controller: the T ranks share one device, and an
operand is a (T, ...) tensor whose row r is rank r's.

* Weights: a column-parallel weight (D, N) is held as T shards (T, D,
  N/T), a row-parallel one (N, D) as (T, N/T, D), the embedding as (T,
  V/T, D): :func:`shard_view` gives each as a rank-major view of the one
  master tensor, so no weight is copied and gradients land on the
  master.
* GEMMs: :func:`rank_matmul` runs every rank's product as one batched
  GEMM over the rank axis. A column GEMM leaves each rank its slice of
  the output features; a row GEMM leaves T partial sums, which
  :func:`tp_allreduce` adds up.
* ``tp_allreduce`` is an autograd Function over
  ``RankCollectives.allreduce`` with its default "xla" algorithm, the
  psum counterpart: the forward sums the T partial rows into every row,
  the backward sums the T gradient rows the same way.
* The vocabulary: :func:`vocab_parallel_embed` looks up each token at the
  rank whose vocabulary slice holds it (zeros at the others) and sums
  the rows, which is exact in any dtype; :func:`vocab_parallel_logits`
  gathers the T logit shards by vocabulary into one f32 tensor.

``allreduce_calls`` counts the tp all-reduces run, forward and backward.
"""

from __future__ import annotations

import torch

from .collectives import RankCollectives

allreduce_calls = 0


def shard_view(p: torch.Tensor, dim: int, T: int) -> torch.Tensor:
    """``p`` split into T equal slices along ``dim``, as a rank-major view
    (T, ...): row r is slice r. A (D, N) weight split on dim 1 gives (T,
    D, N/T) with strides (N/T, N, 1); split on dim 0, (T, N/T, D),
    contiguous. Raises ValueError when T does not divide the dimension."""
    n = p.shape[dim]
    if n % T:
        raise ValueError(f"dimension {dim} of a {tuple(p.shape)} parameter "
                         f"does not split into {T} tp shards")
    return p.unflatten(dim, (T, n // T)).movedim(dim, 0)


def rank_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (T, ..., K) @ w (T, K, N) -> (T, ..., N): rank r's rows times
    rank r's shard, one batched GEMM over the rank axis."""
    T = w.shape[0]
    out = torch.bmm(x.reshape(T, -1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _sum_rows(x: torch.Tensor, coll: RankCollectives) -> torch.Tensor:
    global allreduce_calls
    allreduce_calls += 1
    return coll.allreduce(x.reshape(coll.W, -1)).view(x.shape)


class _TPAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll):
        ctx.coll = coll
        return _sum_rows(x, coll)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _sum_rows(g, ctx.coll), None


def tp_allreduce(x: torch.Tensor, coll: RankCollectives) -> torch.Tensor:
    """Rank rows (T, ...) -> (T, ...), every row the sum of the T rows
    (the reference's psum). Differentiable: the gradient of every input
    row is the sum of the T gradient rows."""
    if x.shape[0] != coll.W:
        raise ValueError(f"tp_allreduce: {x.shape[0]} rows for {coll.W} "
                         f"ranks")
    return _TPAllReduce.apply(x, coll)


def vocab_parallel_embed(tokens: torch.Tensor, shards: torch.Tensor,
                         coll: RankCollectives,
                         dtype: torch.dtype) -> torch.Tensor:
    """Token ids (B, S) through an embedding table held as T vocabulary
    shards (T, V/T, D), rank r holding rows r*V/T ..: each rank looks up
    the ids in its range and writes zeros for the others, and
    :func:`tp_allreduce` sums the rows. Returns (T, B, S, D) in
    ``dtype``, every row the embedding (one value plus zeros: exact)."""
    T, Vr = shards.shape[:2]
    ranks = torch.arange(T, device=tokens.device)
    local = tokens[None] - Vr * ranks[:, None, None]             # (T, B, S)
    mine = (local >= 0) & (local < Vr)
    rows = shards[ranks[:, None, None], local.clamp(0, Vr - 1)].to(dtype)
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=dtype,
                                                          device=rows.device))
    return tp_allreduce(rows, coll)


def vocab_parallel_logits(x: torch.Tensor, shards: torch.Tensor
                          ) -> torch.Tensor:
    """Rank rows x (T, ..., D) through an lm_head held as T vocabulary
    shards (T, D, V/T): rank r's logits for its slice of the vocabulary,
    gathered by vocabulary into one (..., V) f32 tensor. The ranks share
    one device, so the all-gathered logits, the same at every rank, are
    one copy; the backward hands each shard its slice of the gradient."""
    part = rank_matmul(x, shards)                              # (T, ..., V/T)
    order = (*range(1, part.dim() - 1), 0, part.dim() - 1)
    return part.permute(order).to(
        torch.float32, memory_format=torch.contiguous_format).flatten(-2)
