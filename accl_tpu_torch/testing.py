"""Test harness helpers."""

from __future__ import annotations

import concurrent.futures
from typing import Callable, Sequence

from .accl import ACCL
from .communicator import Communicator, Rank


def add_tenant(accls: Sequence[ACCL], tenant: str, key: int = 1,
               timeout: float = 30.0,
               max_segment_size: int | None = None,
               tuner=None) -> list[ACCL]:
    """Attach another tenant's driver set to an existing world: one new
    ACCL per rank SHARING that rank's device, over its own communicator
    of the same membership (``key`` keeps its comm id apart: each
    attached tenant takes a distinct key)."""
    ctx = accls[0].device.ctx
    W = ctx.world_size
    out = []
    for r in range(W):
        comm = Communicator(ranks=[Rank(device=ctx.device)
                                   for _ in range(W)], local_rank=r, key=key)
        out.append(ACCL(ctx.device_of(r), comm, timeout=timeout,
                        max_segment_size=max_segment_size, tuner=tuner,
                        tenant=tenant))
    return out


def run_ranks(accls: Sequence[ACCL], fn: Callable[[ACCL], object],
              timeout: float = 60.0) -> list[object]:
    """Run ``fn(accl)`` concurrently on every rank (one thread per rank,
    like one process per rank under mpirun); propagate the first
    exception."""
    with concurrent.futures.ThreadPoolExecutor(len(accls)) as pool:
        futs = [pool.submit(fn, a) for a in accls]
        return [f.result(timeout) for f in futs]
