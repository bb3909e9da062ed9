"""Bucketed data-parallel gradient all-reduce (DDP-style).

The port of ``accl_tpu/parallel/bucketing.py``. A :class:`BucketPlan`
packs the leaves of a parameter tree (a dict, list or tuple of tensors,
flattened in JAX's order: dict keys sorted, sequences in order) into
fused buffers of about ``bucket_bytes``, walking the leaves in reverse
(the last layers' gradients are ready first in a backward pass), one
bucket list per dtype. :func:`bucketed_allreduce` takes W per-rank
gradient trees (rank rows: the ranks of a
:class:`~accl_tpu_torch.parallel.RankGroup` share one device) and, bucket
by bucket, flattens the W rows, all-reduces them through
:class:`~accl_tpu_torch.parallel.RankCollectives` ("ring": B1 combines
hop by hop, and a wire dtype adds B2's casts on every hop; "xla": one
reduction over the rank axis), divides by W and scatters the rows back.
:func:`make_ddp_train_step` runs one data-parallel step on one set of
parameters: each rank's loss and backward on its batch shard into its
own gradient row, the bucketed all-reduce, then one optimizer update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from ..arith import dtype_name, to_torch_dtype
from ..constants import ReduceFunc
from .collectives import RankCollectives

__all__ = ["Bucket", "BucketPlan", "bucketed_allreduce",
           "make_bucket_plan", "make_ddp_train_step",
           "plan_from_buckets", "tree_flatten", "tree_unflatten"]


# -- trees ---------------------------------------------------------------------

def tree_flatten(tree) -> tuple[list, object]:
    """(leaves, treedef) in JAX's leaf order: a dict's values by sorted
    key, a list's or tuple's in order, anything else a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [tree_flatten(tree[k]) for k in keys]
        return ([leaf for ls, _ in subs for leaf in ls],
                (dict, keys, [d for _, d in subs]))
    if isinstance(tree, (list, tuple)):
        subs = [tree_flatten(x) for x in tree]
        return ([leaf for ls, _ in subs for leaf in ls],
                (type(tree), None, [d for _, d in subs]))
    return [tree], None


def tree_unflatten(treedef, leaves: Sequence):
    """The inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, subs = d
        vals = [build(s) for s in subs]
        return dict(zip(keys, vals)) if kind is dict else kind(vals)

    return build(treedef)


def _dtype(leaf) -> torch.dtype:
    return to_torch_dtype(leaf.dtype)


# -- plans ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Slot:
    leaf_index: int
    offset: int
    size: int
    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class Bucket:
    slots: tuple[_Slot, ...]
    nbytes: int
    dtype: torch.dtype

    @property
    def numel(self) -> int:
        return sum(s.size for s in self.slots)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Assignment of tree leaves to fused all-reduce buckets."""

    buckets: tuple[Bucket, ...]
    treedef: object
    n_leaves: int

    @property
    def total_bytes(self) -> int:
        return sum(b.nbytes for b in self.buckets)

    def describe(self) -> str:
        lines = [f"BucketPlan: {len(self.buckets)} buckets, "
                 f"{self.total_bytes / 1e6:.1f} MB total"]
        for i, b in enumerate(self.buckets):
            lines.append(f"  [{i}] {len(b.slots)} leaves, "
                         f"{b.nbytes / 1e6:.2f} MB, {dtype_name(b.dtype)}")
        return "\n".join(lines)


def _slots(leaves, idxs) -> tuple[list[_Slot], int]:
    out, nbytes = [], 0
    for idx in idxs:
        leaf, dt = leaves[idx], _dtype(leaves[idx])
        size = leaf.numel()
        out.append(_Slot(idx, nbytes // dt.itemsize, size,
                         tuple(leaf.shape), dt))
        nbytes += size * dt.itemsize
    return out, nbytes


def make_bucket_plan(tree, bucket_bytes: int = 25 << 20) -> BucketPlan:
    """A plan over ``tree`` (tensors, or anything with ``shape``, ``dtype``
    and ``numel()``): leaves in reverse order, grouped by dtype, a bucket
    closed once it holds at least ``bucket_bytes``."""
    leaves, treedef = tree_flatten(tree)
    by_dtype: dict = {}
    for idx in reversed(range(len(leaves))):
        by_dtype.setdefault(_dtype(leaves[idx]), []).append(idx)
    buckets: list[Bucket] = []
    for dt, idxs in by_dtype.items():
        cur: list[int] = []
        cur_bytes = 0
        for idx in idxs:
            cur.append(idx)
            cur_bytes += leaves[idx].numel() * dt.itemsize
            if cur_bytes >= bucket_bytes:
                buckets.append(Bucket(tuple(_slots(leaves, cur)[0]),
                                      cur_bytes, dt))
                cur, cur_bytes = [], 0
        if cur:
            buckets.append(Bucket(tuple(_slots(leaves, cur)[0]),
                                  cur_bytes, dt))
    return BucketPlan(tuple(buckets), treedef, len(leaves))


def plan_from_buckets(tree: dict, buckets: Sequence[Sequence[str]]
                      ) -> BucketPlan:
    """A plan over the dict ``tree`` whose buckets are the given lists of
    its keys, fused in the order listed (``Llama.grad_buckets``: the
    reference's buckets of stacked layer leaves). Every key once; one
    dtype a bucket."""
    leaves, treedef = tree_flatten(tree)
    index = {k: i for i, k in enumerate(sorted(tree))}
    listed = [k for b in buckets for k in b]
    if sorted(listed) != sorted(index):
        raise ValueError("the buckets must list every key of the tree "
                         "exactly once")
    out = []
    for names in buckets:
        slots, nbytes = _slots(leaves, [index[k] for k in names])
        dts = {s.dtype for s in slots}
        if len(dts) != 1:
            raise ValueError(f"bucket {list(names)} mixes dtypes "
                             f"{sorted(dtype_name(d) for d in dts)}")
        out.append(Bucket(tuple(slots), nbytes, dts.pop()))
    return BucketPlan(tuple(out), treedef, len(leaves))


# -- the all-reduce ------------------------------------------------------------

def _flatten_bucket(bucket: Bucket, rows: Sequence[Sequence[torch.Tensor]]
                    ) -> torch.Tensor:
    """(W, numel): row r is rank r's bucket leaves, concatenated."""
    like = rows[0][bucket.slots[0].leaf_index]
    fused = torch.empty((len(rows), bucket.numel), dtype=bucket.dtype,
                        device=like.device)
    for r, leaves in enumerate(rows):
        for s in bucket.slots:
            fused[r, s.offset:s.offset + s.size].copy_(
                leaves[s.leaf_index].reshape(-1))
    return fused


def _scatter_bucket(bucket: Bucket, fused: torch.Tensor,
                    out: Sequence[list]):
    """Rank r's slice of ``fused`` back into its leaves of ``out``
    (written in place where a tensor stands, else placed)."""
    for r, leaves in enumerate(out):
        for s in bucket.slots:
            piece = fused[r, s.offset:s.offset + s.size].view(s.shape)
            if leaves[s.leaf_index] is None:
                leaves[s.leaf_index] = piece.clone()
            else:
                leaves[s.leaf_index].copy_(piece)


def bucketed_allreduce(grads: Sequence, coll: RankCollectives,
                       plan: BucketPlan | None = None,
                       bucket_bytes: int = 25 << 20,
                       wire_dtype=None,
                       average: bool = True,
                       algorithm: str = "xla",
                       func: ReduceFunc = ReduceFunc.SUM,
                       out: Sequence | None = None) -> list:
    """All-reduce W per-rank gradient trees (``grads[r]`` is rank r's)
    across the ranks of ``coll`` in fused buckets; returns W trees of the
    results, new tensors unless ``out`` (W trees of the same structure,
    ``grads`` itself for in place) receives them.

    ``algorithm="ring"`` runs the ring schedule of B1 combines, with
    ``wire_dtype`` crossing every hop (B2); ``"xla"`` reduces over the
    rank axis, in ``wire_dtype`` when one is given (cast there and back,
    as the reference's ``psum`` of the cast buffer). ``average`` divides
    a SUM by W."""
    W = coll.W
    if len(grads) != W:
        raise ValueError(f"expected {W} rank gradient trees, got "
                         f"{len(grads)}")
    if plan is None:
        plan = make_bucket_plan(grads[0], bucket_bytes)
    rows = [tree_flatten(g)[0] for g in grads]
    if any(len(leaves) != plan.n_leaves for leaves in rows):
        raise ValueError(
            f"plan built for {plan.n_leaves} leaves, got "
            f"{sorted({len(leaves) for leaves in rows})}")
    outs = ([tree_flatten(o)[0] for o in out] if out is not None
            else [[None] * plan.n_leaves for _ in range(W)])
    wire = None if wire_dtype is None else to_torch_dtype(wire_dtype)
    for bucket in plan.buckets:
        fused = _flatten_bucket(bucket, rows)
        if algorithm == "ring":
            reduced = coll.allreduce(fused, func, algorithm="ring",
                                     wire_dtype=wire)
        elif algorithm == "xla":
            if wire is not None and fused.dtype != wire:
                reduced = coll.allreduce(fused.to(wire), func,
                                         algorithm="xla").to(fused.dtype)
            else:
                reduced = coll.allreduce(fused, func, algorithm="xla")
        else:
            raise ValueError(f"unknown algorithm {algorithm!r}")
        del fused
        if average and ReduceFunc(func) == ReduceFunc.SUM:
            reduced.div_(W)
        _scatter_bucket(bucket, reduced, outs)
    if out is not None:
        return list(out)
    return [tree_unflatten(plan.treedef, leaves) for leaves in outs]


# -- the data-parallel step ----------------------------------------------------

def make_ddp_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                        params, mesh, axis_name: str = "dp",
                        plan: BucketPlan | None = None,
                        bucket_bytes: int = 25 << 20,
                        wire_dtype=None, algorithm: str = "xla"):
    """A DDP step over the ``axis_name`` ranks of ``mesh`` (a
    :class:`~accl_tpu_torch.parallel.RankMesh`) with an explicit bucketed
    gradient all-reduce.

    ``params`` is the tree of parameters (tensors that ``optimizer``
    updates; the plan is built over it unless given); ``loss_fn(shard)``
    is the loss of one rank's batch shard. The ranks share one copy of
    the parameters: ``train_step(batch)`` splits the batch into W shards
    along its first dimension, runs each rank's loss and backward in
    turn, moving its gradients into its own row before the next rank's
    backward, all-reduces the W rows in buckets, sets the averaged
    gradients and takes one ``optimizer.step()``. It returns the mean of
    the ranks' losses, detached."""
    W = mesh.shape[axis_name]
    coll = RankCollectives(mesh.group(axis_name))
    leaves, _ = tree_flatten(params)
    if plan is None:
        plan = make_bucket_plan(params, bucket_bytes)
    for p in leaves:
        p.requires_grad_(True)

    def train_step(batch: torch.Tensor) -> torch.Tensor:
        if batch.shape[0] % W:
            raise ValueError(f"batch {batch.shape[0]} not divisible by "
                             f"the {axis_name} axis size {W}")
        rows, losses = [], []
        for shard in batch.chunk(W):
            for p in leaves:
                p.grad = None
            loss = loss_fn(shard)
            loss.backward()
            rows.append([torch.zeros_like(p) if p.grad is None else p.grad
                         for p in leaves])
            losses.append(loss.detach())
        for p in leaves:
            p.grad = None
        bucketed_allreduce(rows, coll, plan=plan, wire_dtype=wire_dtype,
                           algorithm=algorithm, out=rows)
        for p, g in zip(leaves, rows[0]):
            p.grad = g
        del rows
        optimizer.step()
        return torch.stack(losses).sum() / W

    return train_step
