"""Test harness helpers."""

from __future__ import annotations

import concurrent.futures
from typing import Callable, Sequence

from .accl import ACCL


def run_ranks(accls: Sequence[ACCL], fn: Callable[[ACCL], object],
              timeout: float = 60.0) -> list[object]:
    """Run ``fn(accl)`` concurrently on every rank (one thread per rank,
    like one process per rank under mpirun); propagate the first
    exception."""
    with concurrent.futures.ThreadPoolExecutor(len(accls)) as pool:
        futs = [pool.submit(fn, a) for a in accls]
        return [f.result(timeout) for f in futs]
