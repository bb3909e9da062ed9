"""Elastic decode-pool scale-out: KV layouts whose reshard is cheap.

The port of ``accl_tpu/serving/elastic.py``. Growing the decode pool
under traffic takes three steps:

1. ``ACCL.grow_communicator`` admits the joiner (accl.py);
2. the KV arena reshards from the old pool's layout to the new pool's
   via ``ACCL.redistribute`` — the block-cyclic specs below make that a
   minimal-transfer program under the redistribute engine's shard+chunk
   memory bound (each rank holds its shard plus at most one chunk in
   flight — never a gathered copy of the global arena);
3. :meth:`KVBlockManager.add_rank` opens the joiner for placement.

Shrink (a decode rank dies mid-stream) runs the mirror image:
``shrink_communicator``, reshard survivors' blocks, ``drop_rank`` +
requeue of the dead rank's requests.

:func:`kv_shard_spec` builds the layout: one chunk per KV block, dealt
round-robin over the pool in placement-preference ``order`` — so the
spec IS the block table's rank mapping, and a pool-size change is a
``block_cyclic -> block_cyclic`` spec pair the planner compiles to
exactly the blocks that must move (most blocks stay put; a
gather-reshard-scatter oracle would move everything through one rank).
"""

from __future__ import annotations

from ..hier.sharding import ShardSpec
from ..hier.redistribute import plan_redistribute

__all__ = ["kv_shard_spec", "reshard_plan_counts"]


def kv_shard_spec(total_blocks: int, block_elems: int, world: int,
                  order=None) -> ShardSpec:
    """The decode pool's KV arena as a shard spec: ``total_blocks``
    chunks of ``block_elems`` elements dealt block-cyclically over
    ``world`` ranks in ``order`` (placement preference; None =
    identity). Uneven by design — with 10 blocks over 4 ranks, the
    first two ranks of the deal hold 3 blocks, the rest 2."""
    if total_blocks <= 0 or block_elems <= 0:
        raise ValueError(f"bad arena geometry: {total_blocks} blocks "
                         f"x {block_elems} elems")
    return ShardSpec.block_cyclic(total_blocks * block_elems, world,
                                  block_elems, order=order)


def reshard_plan_counts(src: ShardSpec, dst: ShardSpec) -> dict:
    """Whole-exchange accounting of a reshard ``src -> dst``: elements
    moved cross-rank vs copied locally vs left in place, plus the peak
    per-rank transfer count — the numbers the benchmark differences
    against the gather-reshard-scatter oracle (which moves EVERY
    element through rank 0 twice). Pure geometry: every rank computes
    the same dict."""
    moved = copied = 0
    peak_steps = 0
    for me in range(src.world):
        plan = plan_redistribute(src, dst, me)
        steps = 0
        if plan.kind == "alltoallv":
            moved += sum(c for j, c in enumerate(plan.send_counts)
                         if j != me)
            copied += plan.send_counts[me]
            steps = plan.wire_transfers
        else:
            for s in plan.steps:
                if s.kind == "send":
                    moved += s.count
                    steps += 1
                elif s.kind == "recv":
                    steps += 1
                elif s.kind == "copy":
                    copied += s.count
        peak_steps = max(peak_steps, steps)
    return {"moved_elems": moved, "local_elems": copied,
            "peak_rank_transfers": peak_steps,
            # the oracle's cost for the same exchange: gather everything
            # to one rank, scatter everything back out
            "oracle_moved_elems": 2 * src.n}
