"""The tuning-table producer: a measurement sweep over ``cuda_world``.

The port of ``benchmarks/tune.py``'s ``run_tune``: drive the real ACCL
call path, forcing every legal algorithm of every swept collective
(HIERARCHICAL excluded: it is a phase program over a configured
hierarchy, not a flat algorithm) across a size ladder, feed the measured
durations to a :class:`~accl_tpu_torch.tuner.Tuner`, and save its table
(:mod:`.cache`, schema 1). A run that points ``ACCL_TPU_TUNING_CACHE`` at
the table then resolves every ``AUTO`` from measurements.

Each rep's window closes with a device synchronize on the card, so a
duration covers the kernels and not only their launch (a call with
device-resident operands retires once they are enqueued). A collective
ends when its slowest rank does: rep i's duration is the maximum over
the ranks.

The rows record, for each point, the algorithm that ran and whether the
sweep ``forced`` it or the refreshed tuner ``chosen`` it. Sizes are
bytes a rank; a call's ``count`` is ``nbytes // 4`` f32 elements (the
chunk of a reduce_scatter or allgather), and its key is
``count * 4``, as in the reference.
"""

from __future__ import annotations

import json
import os
import time

import torch

from ..constants import CollectiveAlgorithm, VALID_ALGORITHMS
from .tuner import Tuner, nbytes_bucket
from . import cache

__all__ = ["DEFAULT_OPS", "DEFAULT_SIZES", "WIRE_OPS", "format_rows",
           "run_tune", "write_rows"]

DEFAULT_SIZES = [1 << 8, 1 << 12, 1 << 16, 1 << 20]
DEFAULT_OPS = ["allreduce", "allgather", "reduce_scatter", "gather",
               "reduce", "bcast"]
# the ops swept on the fp8 block-scaled wire beside the full one
WIRE_OPS = ("allreduce", "allgather", "reduce_scatter")
_ELEM = 4  # float32 sweeps


def _rank_body(op: str, count: int, W: int, alg, reps: int,
               keep: bool = False, sources=None, **callkw):
    """Per-rank closure: device-resident buffers for ``op``, its source
    seeded random (``sources[rank]`` when given), one warm-up call, then
    ``reps`` timed synchronous calls, each window closed by a device
    synchronize; the buffers are freed at the end. Returns the durations
    and, with ``keep``, ``(source, output)`` copies taken around the
    warm-up, else None. ``callkw`` carries the wire options."""

    def body(a):
        dev = a.device.ctx.device
        bufs = []

        def buf(n, src=False):
            if not src:
                data = torch.zeros(n, device=dev)
            elif sources is not None:
                data = sources[a.rank].clone()
            else:
                g = torch.Generator(device=dev).manual_seed(a.rank)
                data = torch.randn(n, generator=g, device=dev)
            bufs.append(a.buffer(data=data, device_resident=True))
            return bufs[-1]

        if op in ("allreduce", "reduce"):
            src, dst = buf(count, True), buf(count)
            call = {"allreduce": lambda: a.allreduce(src, dst, count,
                                                     algorithm=alg,
                                                     **callkw),
                    "reduce": lambda: a.reduce(src, dst, count,
                                               algorithm=alg)}[op]
        elif op == "bcast":
            src = dst = buf(count, True)
            call = lambda: a.bcast(src, count, algorithm=alg)  # noqa: E731
        elif op == "allgather":
            src, dst = buf(count, True), buf(W * count)
            call = lambda: a.allgather(src, dst, count,  # noqa: E731
                                       algorithm=alg, **callkw)
        elif op == "gather":
            src, dst = buf(count, True), buf(W * count)
            call = lambda: a.gather(src, dst, count,  # noqa: E731
                                    algorithm=alg)
        elif op == "reduce_scatter":
            src, dst = buf(W * count, True), buf(count)
            call = lambda: a.reduce_scatter(src, dst, count,  # noqa: E731
                                            algorithm=alg, **callkw)
        else:
            raise ValueError(op)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        try:
            before = src.tensor.clone() if keep else None
            call()
            sync()
            kept = (before, dst.tensor.clone()) if keep else None
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                call()
                sync()
                ts.append(time.perf_counter() - t0)
        finally:
            for b in bufs:
                b.free_buffer()
        return ts, kept

    return body


def run_tune(world: int = 4, sizes=None, ops=None, reps: int = 3,
             cache_path: str | None = None, device="cuda",
             check=None) -> dict:
    """The sweep on ``cuda_world(world, device=device)``. Returns
    ``{"tuner", "rows", "cache_path"}``; ``rows`` is the forced/chosen
    record. The table is saved to ``cache_path`` (default: the
    ``ACCL_TPU_TUNING_CACHE`` path; neither: not saved).

    ``check(op, count, algorithm, callkw, kept)``, when given, sees the
    warm-up of each (op, algorithm, wire) once, at the first swept size,
    before any rep of it is timed: ``kept[rank]`` is that rank's
    ``(source, output)``; it raises to stop the sweep."""
    from ..device.cuda import cuda_world
    from ..testing import run_ranks
    sizes = [int(s) for s in (sizes or DEFAULT_SIZES)]
    ops = list(ops or DEFAULT_OPS)
    # the tuner stays detached from the measured world: every call forces
    # its algorithm, and attaching would feed it the warm-ups and reload
    # the very table being regenerated. Entries from however many reps
    # ran are trusted.
    tuner = Tuner()
    tuner.min_samples = min(tuner.min_samples, reps)
    accls = cuda_world(world, device=device)
    tuner.topology = accls[0].device.topology()   # saved with the table
    rows = []
    checked = set()

    def measure(op, count, alg, **kw):
        point = (op, alg, tuple(sorted(kw)))
        keep = check is not None and point not in checked
        per_rank = run_ranks(accls, _rank_body(op, count, world, alg, reps,
                                               keep=keep, **kw))
        if keep:
            checked.add(point)
            check(op, count, alg, kw, [kept for _, kept in per_rank])
        return [max(ts[i] for ts, _ in per_rank) for i in range(reps)]

    def row(op, count, algorithm, source, seconds):
        return {"op": op, "world": world, "count": count,
                "nbytes": count * _ELEM,
                "bucket": nbytes_bucket(count * _ELEM),
                "algorithm": algorithm, "source": source,
                "seconds_per_op": seconds}

    try:
        for op in ops:
            algos = sorted(a for a in VALID_ALGORITHMS[op]
                           if a != CollectiveAlgorithm.HIERARCHICAL)
            for nbytes in sizes:
                count = max(1, nbytes // _ELEM)
                for alg in algos:
                    durs = measure(op, count, alg)
                    for d in durs:
                        tuner.observe(op, world, count * _ELEM, alg, d)
                    rows.append(row(op, count, alg.name, "forced",
                                    min(durs)))
        # the fp8 block-scaled wire beside the full one: the wire EWMAs
        # that select_wire reads
        for op in [o for o in ops if o in WIRE_OPS]:
            for nbytes in sizes:
                count = max(1, nbytes // _ELEM)
                for quantized in (False, True):
                    kw = ({"compress_dtype": torch.float8_e4m3fn,
                           "block_scale": True} if quantized else {})
                    durs = measure(op, count, CollectiveAlgorithm.AUTO,
                                   **kw)
                    for d in durs:
                        tuner.observe_wire(op, world, count * _ELEM,
                                           quantized, d)
                    rows.append(row(op, count, "AUTO+fp8-bs" if quantized
                                    else "AUTO", "forced", min(durs)))
        tuner.refresh()
        for op in ops:
            for nbytes in sizes:
                count = max(1, nbytes // _ELEM)
                chosen = tuner.select(op, world, count * _ELEM)
                wire = (tuner.select_wire(op, world, count * _ELEM)
                        if op in WIRE_OPS else False)
                rows.append(row(op, count, CollectiveAlgorithm(chosen).name
                                + ("+fp8-bs" if wire else ""), "chosen",
                                None))
    finally:
        for a in accls:
            a.deinit()
    path = cache_path or cache.default_cache_path()
    if path:
        cache.save(tuner, path)
    return {"tuner": tuner, "rows": rows, "cache_path": path}


def write_rows(rows: list[dict], out_dir: str,
               name: str = "tune.json") -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump({"rows": rows}, f, indent=1)
        f.write("\n")
    return path


def format_rows(rows: list[dict]) -> str:
    lines = ["{:<16} {:>4} {:>10} {:>14} {:>8} {:>12}".format(
        "op", "W", "nbytes", "algorithm", "source", "us/op")]
    for r in rows:
        us = ("" if r["seconds_per_op"] is None
              else f"{r['seconds_per_op'] * 1e6:.1f}")
        lines.append("{:<16} {:>4} {:>10} {:>14} {:>8} {:>12}".format(
            r["op"], r["world"], r["nbytes"], r["algorithm"],
            r["source"], us))
    return "\n".join(lines)
