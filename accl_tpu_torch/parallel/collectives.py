"""Dense collectives over W ranks on one device: the port's dataplane.

The counterpart of ``accl_tpu/parallel/collectives.py``. Two algorithm
families, as there:

* ``ring`` — the reference's ring schedules, hop for hop: decreasing-
  rank flow (rank i sends to i-1), rank r starts with chunk r+1, round i
  handles chunk r+1+i and the last round keeps chunk r. On one device a
  hop is rank r reading rank (r+1)%W's partial, and one kernel launch
  covers the hop for all W ranks. Every rank advances together, so the
  partials are double-buffered (ping-pong): hop i reads one buffer and
  writes the other, never a partial another rank still has to read.
  With a block-scaled wire (``qblock`` and an int8/fp8 wire dtype) each
  hop's payload is (codes, per-block scales): reduce-scatter requantizes
  against fresh scales on every hop but the last, which dequantizes and
  combines without requantizing; allgather lands the bytes its source
  quantized once (relays forward them unchanged), and the own chunk
  lands exact.
* ``xla`` — what ``psum`` / ``psum_scatter`` / ``all_gather`` compute,
  written as plain torch reductions over the rank axis. PROD has no
  such reduction in the reference and falls back to the ring.

Operands: a (W, n) tensor (row r is rank r's operand, the reference's
global layout) or a list of W tensors. Results land in ``out`` (same
forms) or in a fresh (W, n_out) tensor. Wire bytes between ranks are a
logical count: the ranks share one device's memory.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..arith import dtype_name
from ..constants import ReduceFunc
from ..ops.combine import combine, combine_ref
from ..ops.compression import (bs_combine, bs_combine_ref, bs_dequant,
                               bs_dequant_ref, bs_quant, bs_quant_ref)
from ..quant import WIRE_DTYPE_NAMES, n_blocks
from .mesh import RankGroup


class Kernels(NamedTuple):
    """The per-hop kernels a ring runs through."""

    combine: Callable
    bs_quant: Callable
    bs_dequant: Callable
    bs_combine: Callable


# the hand-written kernels (plain versions on CPU tensors) ...
KERNELS = Kernels(combine, bs_quant, bs_dequant, bs_combine)
# ... and the plain PyTorch versions on any device, the yardstick the
# kernels are held to on the card
PLAIN = Kernels(combine_ref, bs_quant_ref, bs_dequant_ref, bs_combine_ref)

_PSUM_LIKE = (ReduceFunc.SUM, ReduceFunc.MAX, ReduceFunc.MIN)


def _axis_reduce(x: torch.Tensor, func: ReduceFunc) -> torch.Tensor:
    if func == ReduceFunc.SUM:
        return torch.sum(x, dim=0, dtype=x.dtype)
    if func == ReduceFunc.MAX:
        return torch.amax(x, dim=0)
    return torch.amin(x, dim=0)


# -- ring family (per-rank row lists) ---------------------------------------

def ring_reduce_scatter(rows, func: ReduceFunc, out_rows,
                        k: Kernels = KERNELS):
    """Ring reduce-scatter. ``rows``: W tensors of W*c elements;
    ``out_rows[r]`` receives rank r's fully reduced chunk r (c elements).
    Round i: rank r combines the partial received from rank r+1 with its
    chunk r+1+i (received partial first, as the reference)."""
    W = len(rows)
    c = rows[0].numel() // W

    def chunk(r, j):
        return rows[r][j * c:(j + 1) * c]

    if W == 1:
        out_rows[0].copy_(rows[0])
        return out_rows
    bufs = (torch.empty((2, W, c), dtype=rows[0].dtype,
                        device=rows[0].device) if W > 2 else None)
    acc = [chunk(r, (r + 1) % W) for r in range(W)]
    for i in range(1, W):
        dst = out_rows if i == W - 1 else list(bufs[i % 2])
        k.combine([acc[(r + 1) % W] for r in range(W)],
                  [chunk(r, (r + 1 + i) % W) for r in range(W)], func, dst)
        acc = dst
    return out_rows


def ring_allgather(rows, out_rows):
    """Ring allgather. ``rows``: W tensors of c elements; ``out_rows[r]``
    (W*c) receives chunk j of rank j in slot j. Round i lands, at rank r,
    the chunk that left rank r+i i hops earlier (round 0: its own)."""
    W = len(rows)
    c = rows[0].numel()
    for i in range(W):
        for r in range(W):
            j = (r + i) % W
            out_rows[r][j * c:(j + 1) * c].copy_(rows[j])
    return out_rows


def _pad_rows(rows, W: int):
    n = rows[0].numel()
    pad = (-n) % W
    if pad:
        rows = [F.pad(r, (0, pad)) for r in rows]
    return rows, n, pad


def _finish_padded(full, out_rows, n: int):
    for f, o in zip(full, out_rows):
        o.copy_(f[:n])
    return out_rows


def ring_allreduce(rows, func: ReduceFunc, out_rows, k: Kernels = KERNELS):
    """Ring allreduce = ring reduce-scatter + ring allgather over W chunks
    of each rank's flattened operand (zero-padded to a multiple of W)."""
    W = len(rows)
    rows, n, pad = _pad_rows(rows, W)
    c = rows[0].numel() // W
    mine = list(torch.empty((W, c), dtype=rows[0].dtype,
                            device=rows[0].device))
    ring_reduce_scatter(rows, func, mine, k)
    if not pad:
        return ring_allgather(mine, out_rows)
    full = list(torch.empty((W, W * c), dtype=rows[0].dtype,
                            device=rows[0].device))
    return _finish_padded(ring_allgather(mine, full), out_rows, n)


def ring_reduce_scatter_bs(rows, func: ReduceFunc, wire: str, qblock: int,
                           out_rows, k: Kernels = KERNELS):
    """Block-scaled ring reduce-scatter over f32 rows (W*c elements each):
    the first chunk is quantized, every middle hop dequantizes, combines
    in f32 and requantizes against fresh scales in one kernel, and the
    round-closing hop combines without requantizing into ``out_rows``."""
    W = len(rows)
    c = rows[0].numel() // W

    def chunk(r, j):
        return rows[r][j * c:(j + 1) * c]

    if W == 1:
        out_rows[0].copy_(rows[0])
        return out_rows
    dev = rows[0].device
    nb = n_blocks(c, qblock)
    qs = torch.empty((2, W, c), dtype=torch.uint8, device=dev)
    ss = torch.empty((2, W, nb), dtype=torch.float32, device=dev)
    q, s = list(qs[0]), list(ss[0])
    k.bs_quant([chunk(r, (r + 1) % W) for r in range(W)], wire, qblock, q, s)
    for i in range(1, W):
        recv_q = [q[(r + 1) % W] for r in range(W)]
        recv_s = [s[(r + 1) % W] for r in range(W)]
        other = [chunk(r, (r + 1 + i) % W) for r in range(W)]
        if i < W - 1:
            q, s = list(qs[i % 2]), list(ss[i % 2])
            k.bs_combine(recv_q, recv_s, other, func, wire, qblock,
                         q_out=q, s_out=s)
        else:
            k.bs_combine(recv_q, recv_s, other, func, wire, qblock,
                         out=out_rows, requant=False)
    return out_rows


def ring_allgather_bs(rows, wire: str, qblock: int, out_rows,
                      k: Kernels = KERNELS):
    """Block-scaled ring allgather over f32 rows (c elements each): each
    rank quantizes its chunk once; round i lands, at rank r, the bytes
    rank r+i quantized (relays forward them unchanged); the own chunk
    lands exact."""
    W = len(rows)
    c = rows[0].numel()
    for r in range(W):
        out_rows[r][r * c:(r + 1) * c].copy_(rows[r])
    if W == 1:
        return out_rows
    q, s = k.bs_quant(rows, wire, qblock)
    for i in range(1, W):
        src = [(r + i) % W for r in range(W)]
        k.bs_dequant([q[j] for j in src], [s[j] for j in src], wire, qblock,
                     [out_rows[r][j * c:(j + 1) * c]
                      for r, j in enumerate(src)])
    return out_rows


def ring_allreduce_bs(rows, func: ReduceFunc, wire: str, qblock: int,
                      out_rows, k: Kernels = KERNELS):
    """Block-scaled ring allreduce = quantized reduce-scatter + quantized
    allgather over W chunks of each rank's flattened f32 operand."""
    W = len(rows)
    rows, n, pad = _pad_rows(rows, W)
    c = rows[0].numel() // W
    mine = list(torch.empty((W, c), dtype=torch.float32,
                            device=rows[0].device))
    ring_reduce_scatter_bs(rows, func, wire, qblock, mine, k)
    if not pad:
        return ring_allgather_bs(mine, wire, qblock, out_rows, k)
    full = list(torch.empty((W, W * c), dtype=torch.float32,
                            device=rows[0].device))
    return _finish_padded(ring_allgather_bs(mine, wire, qblock, full, k),
                          out_rows, n)


# -- "xla" family: plain reductions over the rank axis ----------------------

def xla_allreduce(rows, func: ReduceFunc, out_rows):
    red = _axis_reduce(torch.stack(rows), func)
    for o in out_rows:
        o.copy_(red)
    return out_rows


def xla_reduce_scatter(rows, func: ReduceFunc, out_rows):
    W = len(rows)
    red = _axis_reduce(torch.stack(rows).view(W, W, -1), func)
    for r, o in enumerate(out_rows):
        o.copy_(red[r])
    return out_rows


def xla_allgather(rows, out_rows):
    full = torch.cat(rows)
    for o in out_rows:
        o.copy_(full)
    return out_rows


# -- the wrapper ------------------------------------------------------------

def _shares_storage(a_rows, b_rows) -> bool:
    ptrs = {t.untyped_storage().data_ptr() for t in a_rows}
    return any(t.untyped_storage().data_ptr() in ptrs for t in b_rows)


class RankCollectives:
    """Dense collectives over the W ranks of a :class:`RankGroup`.

    ``kernels=PLAIN`` runs the rings through the plain PyTorch versions
    instead of the hand-written kernels (the card-side yardstick)."""

    def __init__(self, group: RankGroup, kernels: Kernels = KERNELS):
        self.group = group
        self.W = group.size
        self.device = group.device
        self.kernels = kernels

    @staticmethod
    def _bs_eligible(op: str, wire: str | None, qblock: int) -> bool:
        """The block-scaled ring lane exists for the ring-shaped dense
        collectives and the quantizable wire dtypes only."""
        return bool(qblock) and wire in WIRE_DTYPE_NAMES and op in (
            "allreduce", "reduce_scatter", "allgather")

    def _rows(self, x) -> list:
        rows = list(x) if not isinstance(x, torch.Tensor) or x.dim() > 1 \
            else None
        if rows is None or len(rows) != self.W:
            raise ValueError(f"expected {self.W} rank operands")
        return [r.reshape(-1) for r in rows]

    def _run(self, op: str, x, func: ReduceFunc, algorithm: str, wire,
             qblock: int, out):
        rows = self._rows(x)
        W = self.W
        n_in = rows[0].numel()
        n_out = {"allreduce": n_in, "reduce_scatter": n_in // W,
                 "allgather": n_in * W}[op]
        if op == "reduce_scatter" and n_in % W:
            raise ValueError(f"reduce_scatter operand of {n_in} elements "
                             f"does not split into {W} chunks")
        dtype = rows[0].dtype
        ret = (torch.empty((W, n_out), dtype=dtype, device=rows[0].device)
               if out is None else out)
        out_rows = self._rows(ret)
        wire = None if wire is None else dtype_name(wire)
        bs = self._bs_eligible(op, wire, qblock)
        if wire is not None and not bs:
            raise NotImplementedError(
                f"{op} with a {wire} wire needs the per-tensor wire lanes, "
                "which this package does not have yet")
        # results computed in f32 (block-scaled lane) or into rows that
        # alias an input land through temporaries
        work_dtype = torch.float32 if bs else dtype
        staged = work_dtype != dtype or _shares_storage(rows, out_rows)
        dst = (list(torch.empty((W, n_out), dtype=work_dtype,
                                device=rows[0].device))
               if staged else out_rows)
        if bs:
            rows = [r.to(torch.float32) for r in rows]
        func = ReduceFunc(func)
        if func not in _PSUM_LIKE and algorithm == "xla" and op in (
                "allreduce", "reduce_scatter"):
            algorithm = "ring"
        k = self.kernels
        if bs:
            if op == "allreduce":
                ring_allreduce_bs(rows, func, wire, qblock, dst, k)
            elif op == "reduce_scatter":
                ring_reduce_scatter_bs(rows, func, wire, qblock, dst, k)
            else:
                ring_allgather_bs(rows, wire, qblock, dst, k)
        elif algorithm == "ring":
            if op == "allreduce":
                ring_allreduce(rows, func, dst, k)
            elif op == "reduce_scatter":
                ring_reduce_scatter(rows, func, dst, k)
            else:
                ring_allgather(rows, dst)
        elif algorithm == "xla":
            if op == "allreduce":
                xla_allreduce(rows, func, dst)
            elif op == "reduce_scatter":
                xla_reduce_scatter(rows, func, dst)
            else:
                xla_allgather(rows, dst)
        else:
            raise ValueError(f"unknown algorithm {algorithm!r}")
        if staged:
            for o, d in zip(out_rows, dst):
                o.copy_(d)
        return ret

    def allreduce(self, x, func: ReduceFunc = ReduceFunc.SUM,
                  algorithm: str = "xla", wire_dtype=None, qblock: int = 0,
                  out=None):
        return self._run("allreduce", x, func, algorithm, wire_dtype,
                         qblock, out)

    def reduce_scatter(self, x, func: ReduceFunc = ReduceFunc.SUM,
                       algorithm: str = "xla", wire_dtype=None,
                       qblock: int = 0, out=None):
        return self._run("reduce_scatter", x, func, algorithm, wire_dtype,
                         qblock, out)

    def allgather(self, x, algorithm: str = "xla", wire_dtype=None,
                  qblock: int = 0, out=None):
        return self._run("allgather", x, ReduceFunc.SUM, algorithm,
                         wire_dtype, qblock, out)
