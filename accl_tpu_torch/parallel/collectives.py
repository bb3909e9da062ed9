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
  With a per-tensor wire dtype (f16, bf16, or fp8 with one absmax scale
  per hop payload) every hop sends its payload down to the wire dtype
  and lands it back in f32 before the combine; the allgather's relays
  re-encode what they forward on every hop (a fresh fp8 scale each
  time), and the own chunk lands exact. With a block-scaled wire
  (``qblock`` and an int8/fp8 wire dtype) each hop's payload is (codes,
  per-block scales): reduce-scatter requantizes against fresh scales on
  every hop but the last, which dequantizes and combines without
  requantizing; allgather lands the bytes its source quantized once
  (relays forward them unchanged), and the own chunk lands exact.
* ``xla`` — what ``psum`` / ``psum_scatter`` / ``all_gather`` compute,
  written as plain torch reductions over the rank axis. PROD has no
  such reduction in the reference and falls back to the ring. With a
  per-tensor wire: the exchange moves wire payloads (fp8 with one scale
  per (rank, chunk) on the reduce-scatter, one per rank on the
  allgather, the own chunk encoded too) and the W contributions reduce
  in f32.

``alltoall`` casts every chunk for transit (fp8 too: a pure cast, no
scale) and restores each rank's own chunk exact. ``alltoallv`` moves
chunks of per-pair counts (prefix-sum intervals of each rank's count
vectors): the own chunk exact, each of the W(W-1) cross chunks through
the wire (a cast, or the block-scaled codec as one message), the codec
launched once for each distinct chunk length; zero-count pairs launch
nothing. The rooted collectives
(bcast, scatter, gather, reduce) live in :mod:`.tree`.

Operands: a (W, n) tensor (row r is rank r's operand, the reference's
global layout) or a list of W tensors. Results land in ``out`` (same
forms) or in a fresh (W, n_out) tensor. Wire bytes between ranks are a
logical count: the ranks share one device's memory.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..arith import dtype_name, to_torch_dtype
from ..constants import ReduceFunc
from ..ops.combine import combine, combine_ref
from ..ops.compression import (FP8_DTYPE_NAMES, bs_combine, bs_combine_ref,
                               bs_dequant, bs_dequant_ref, bs_quant,
                               bs_quant_ref, cast, cast_ref, fp8_dequant,
                               fp8_dequant_ref, fp8_quant, fp8_quant_ref,
                               fp8_scale, fp8_scale_ref)
from ..quant import WIRE_DTYPE_NAMES, n_blocks, packed_nbytes
from .mesh import RankGroup


class Kernels(NamedTuple):
    """The per-hop kernels a ring runs through."""

    combine: Callable
    bs_quant: Callable
    bs_dequant: Callable
    bs_combine: Callable
    cast: Callable
    fp8_scale: Callable
    fp8_quant: Callable
    fp8_dequant: Callable


# the hand-written kernels (plain versions on CPU tensors) ...
KERNELS = Kernels(combine, bs_quant, bs_dequant, bs_combine, cast,
                  fp8_scale, fp8_quant, fp8_dequant)
# ... and the plain PyTorch versions on any device, the yardstick the
# kernels are held to on the card
PLAIN = Kernels(combine_ref, bs_quant_ref, bs_dequant_ref, bs_combine_ref,
                cast_ref, fp8_scale_ref, fp8_quant_ref, fp8_dequant_ref)

_PSUM_LIKE = (ReduceFunc.SUM, ReduceFunc.MAX, ReduceFunc.MIN)
# per-tensor wire dtypes (the block-scaled lane adds int8 under qblock)
WIRE_LANE_NAMES = ("float16", "bfloat16") + FP8_DTYPE_NAMES


class Wire:
    """The per-tensor wire of one collective: payload rows of ``n`` f32
    elements go down to the wire dtype (B2 cast, or B3 with one fp8 scale
    per row) into the slots of a wire buffer, and land back in f32 (B2,
    or B4 with the slot's scale)."""

    def __init__(self, wire: str, k: Kernels, n: int, slots: int, dev):
        self.name, self.k = wire, k
        self.dtype = to_torch_dtype(wire)
        self.fp8 = wire in FP8_DTYPE_NAMES
        self.q = list(torch.empty((slots, n), dtype=self.dtype, device=dev))
        if self.fp8:
            self.s, self.inv = (
                list(torch.empty((slots, 1), dtype=torch.float32,
                                 device=dev)) for _ in range(2))

    def send(self, rows):
        """Encode ``rows[i]`` into slot i."""
        m = len(rows)
        if self.fp8:
            self.k.fp8_scale(rows, self.name, self.s[:m], self.inv[:m])
            self.k.fp8_quant(rows, self.inv[:m], self.name, self.q[:m])
        else:
            self.k.cast(rows, self.dtype, self.q[:m])

    def land(self, slots, out_rows):
        """Decode slot ``slots[i]`` into ``out_rows[i]`` (f32)."""
        q = [self.q[i] for i in slots]
        if self.fp8:
            self.k.fp8_dequant(q, [self.s[i] for i in slots], self.name,
                               out_rows)
        else:
            self.k.cast(q, torch.float32, out_rows)


def _axis_reduce(x: torch.Tensor, func: ReduceFunc) -> torch.Tensor:
    if func == ReduceFunc.SUM:
        return torch.sum(x, dim=0, dtype=x.dtype)
    if func == ReduceFunc.MAX:
        return torch.amax(x, dim=0)
    return torch.amin(x, dim=0)


# -- ring family (per-rank row lists) ---------------------------------------

def _next(W: int) -> list[int]:
    """Who each rank receives from on the ring: rank r from r+1."""
    return [(r + 1) % W for r in range(W)]


def ring_reduce_scatter(rows, func: ReduceFunc, out_rows,
                        k: Kernels = KERNELS, wire: str | None = None):
    """Ring reduce-scatter. ``rows``: W tensors of W*c elements;
    ``out_rows[r]`` receives rank r's fully reduced chunk r (c elements).
    Round i: rank r combines the partial received from rank r+1 with its
    chunk r+1+i (received partial first, as the reference). ``wire``: a
    per-tensor wire dtype; each hop's partial crosses it (down, then
    back to f32) before the combine."""
    W = len(rows)
    c = rows[0].numel() // W

    def chunk(r, j):
        return rows[r][j * c:(j + 1) * c]

    if W == 1:
        out_rows[0].copy_(rows[0])
        return out_rows
    dev = rows[0].device
    bufs = (torch.empty((2, W, c), dtype=rows[0].dtype, device=dev)
            if W > 2 else None)
    if wire is not None:
        lane = Wire(wire, k, c, W, dev)
        landed = list(torch.empty((W, c), dtype=torch.float32, device=dev))
    acc = [chunk(r, (r + 1) % W) for r in range(W)]
    for i in range(1, W):
        dst = out_rows if i == W - 1 else list(bufs[i % 2])
        if wire is None:
            recv = [acc[j] for j in _next(W)]
        else:
            lane.send(acc)
            lane.land(_next(W), landed)
            recv = landed
        k.combine(recv, [chunk(r, (r + 1 + i) % W) for r in range(W)],
                  func, dst)
        acc = dst
    return out_rows


def ring_allgather(rows, out_rows, k: Kernels = KERNELS,
                   wire: str | None = None):
    """Ring allgather. ``rows``: W tensors of c elements; ``out_rows[r]``
    (W*c) receives chunk j of rank j in slot j. Round i lands, at rank r,
    the chunk that left rank r+i i hops earlier (round 0: its own). With
    a per-tensor ``wire`` every relay re-encodes what it forwards (the
    reference's ``_hop`` on the relayed buffer): a cast is idempotent,
    the fp8 codec takes a fresh scale per hop; the own chunk is exact."""
    W = len(rows)
    c = rows[0].numel()

    def slot(r, j):
        return out_rows[r][j * c:(j + 1) * c]

    if wire is None:
        for i in range(W):
            for r in range(W):
                j = (r + i) % W
                slot(r, j).copy_(rows[j])
        return out_rows
    for r in range(W):
        slot(r, r).copy_(rows[r])
    lane = Wire(wire, k, c, W, rows[0].device)
    buf = list(rows)
    for i in range(1, W):
        lane.send(buf)
        dst = [slot(r, (r + i) % W) for r in range(W)]
        lane.land(_next(W), dst)
        buf = dst
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


def ring_allreduce(rows, func: ReduceFunc, out_rows, k: Kernels = KERNELS,
                   wire: str | None = None):
    """Ring allreduce = ring reduce-scatter + ring allgather over W chunks
    of each rank's flattened operand (zero-padded to a multiple of W)."""
    W = len(rows)
    rows, n, pad = _pad_rows(rows, W)
    c = rows[0].numel() // W
    mine = list(torch.empty((W, c), dtype=rows[0].dtype,
                            device=rows[0].device))
    ring_reduce_scatter(rows, func, mine, k, wire)
    if not pad:
        return ring_allgather(mine, out_rows, k, wire)
    full = list(torch.empty((W, W * c), dtype=rows[0].dtype,
                            device=rows[0].device))
    return _finish_padded(ring_allgather(mine, full, k, wire), out_rows, n)


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


def xla_compressed_reduce_scatter(rows, func: ReduceFunc, wire: str,
                                  out_rows, k: Kernels = KERNELS):
    """Reduce-scatter with a compressed wire and f32 accumulation (the
    reference's fused path): every (rank, chunk) payload crosses the wire
    (fp8: one scale per (rank, chunk)), then rank r reduces the W chunks
    r it received, its own included, over the rank axis."""
    W = len(rows)
    c = rows[0].numel() // W
    lane = Wire(wire, k, c, W * W, rows[0].device)
    # slot j*W + r: chunk r of rank j
    lane.send([rows[j][r * c:(r + 1) * c] for j in range(W)
               for r in range(W)])
    landed = torch.empty((W, W, c), dtype=torch.float32,
                         device=rows[0].device)
    lane.land([j * W + r for r in range(W) for j in range(W)],
              list(landed.view(W * W, c)))
    red = _axis_reduce(landed.transpose(0, 1), func)
    for r, o in enumerate(out_rows):
        o.copy_(red[r])
    return out_rows


def xla_compressed_allgather(rows, wire: str, out_rows,
                             k: Kernels = KERNELS):
    """Allgather with a compressed wire: every rank's chunk (fp8: one
    scale per rank) crosses the wire and lands at every rank, its own
    included."""
    W = len(rows)
    c = rows[0].numel()
    lane = Wire(wire, k, c, W, rows[0].device)
    lane.send(rows)
    lane.land([j for _ in range(W) for j in range(W)],
              [o[j * c:(j + 1) * c] for o in out_rows for j in range(W)])
    return out_rows


def xla_compressed_allreduce(rows, func: ReduceFunc, wire: str, out_rows,
                             k: Kernels = KERNELS):
    """Compressed reduce-scatter + compressed allgather over W chunks of
    each rank's flattened operand (zero-padded to a multiple of W)."""
    W = len(rows)
    rows, n, pad = _pad_rows(rows, W)
    c = rows[0].numel() // W
    dev = rows[0].device
    mine = list(torch.empty((W, c), dtype=torch.float32, device=dev))
    xla_compressed_reduce_scatter(rows, func, wire, mine, k)
    if not pad:
        return xla_compressed_allgather(mine, wire, out_rows, k)
    full = list(torch.empty((W, W * c), dtype=torch.float32, device=dev))
    return _finish_padded(xla_compressed_allgather(mine, wire, full, k),
                          out_rows, n)


def alltoall(rows, out_rows, k: Kernels = KERNELS, wire: str | None = None):
    """``out_rows[r]`` chunk j = ``rows[j]`` chunk r. With a wire dtype
    every chunk crosses it as a pure cast (fp8 too: no scale); the own
    chunk, which never left its rank, is restored exact."""
    W = len(rows)
    c = rows[0].numel() // W

    def chunk(t, j):
        return t[j * c:(j + 1) * c]

    if wire is not None:
        q = k.cast(rows, wire)
        pairs = [(r, j) for r in range(W) for j in range(W) if j != r]
        k.cast([chunk(q[j], r) for r, j in pairs], torch.float32,
               [chunk(out_rows[r], j) for r, j in pairs])
    for r in range(W):
        for j in range(W) if wire is None else (r,):
            chunk(out_rows[r], j).copy_(chunk(rows[j], r))
    return out_rows


def _prefix(counts) -> list[int]:
    off = [0]
    for c in counts:
        off.append(off[-1] + int(c))
    return off


def alltoallv(rows, out_rows, send_counts, recv_counts,
              k: Kernels = KERNELS, wire: str | None = None,
              qblock: int = 0) -> int:
    """Variable-count all-to-all: rank r sends ``send_counts[r][j]``
    elements to rank j from the j-th prefix-sum interval of ``rows[r]``,
    and the chunk lands in the r-th interval of ``out_rows[j]`` (whose
    ``recv_counts[j][r]`` must equal it). The own chunk is copied exact;
    a cross chunk crosses ``wire``: a pure cast (B2 down and up), or with
    ``qblock`` the block-scaled codec (B5, then B6) with the chunk as one
    message. The codec launches once for each distinct chunk length (its
    rows share one length); zero-count pairs launch nothing. Returns the
    logical wire bytes of the cross chunks."""
    W = len(rows)
    for i in range(W):
        for j in range(W):
            if int(send_counts[i][j]) != int(recv_counts[j][i]):
                raise ValueError(
                    f"alltoallv count vectors disagree: rank {i} sends "
                    f"{send_counts[i][j]} to rank {j}, which expects "
                    f"{recv_counts[j][i]}")
    soff = [_prefix(c) for c in send_counts]
    roff = [_prefix(c) for c in recv_counts]

    def src(r, j):
        return rows[r][soff[r][j]:soff[r][j + 1]]

    def dst(r, j):                # the chunk of rank r at rank j
        return out_rows[j][roff[j][r]:roff[j][r + 1]]

    for r in range(W):
        if send_counts[r][r]:
            dst(r, r).copy_(src(r, r))
    cross = [(r, j) for r in range(W) for j in range(W)
             if j != r and send_counts[r][j]]
    if wire is None:
        for r, j in cross:
            dst(r, j).copy_(src(r, j))
        return sum(src(r, j).nbytes for r, j in cross)
    by_len: dict[int, list] = {}
    for r, j in cross:
        by_len.setdefault(int(send_counts[r][j]), []).append((r, j))
    nbytes = 0
    for n, pairs in by_len.items():
        xs = [src(r, j) for r, j in pairs]
        outs = [dst(r, j) for r, j in pairs]
        if qblock:
            q, s = k.bs_quant(xs, wire, qblock)
            k.bs_dequant(q, s, wire, qblock, outs)
            nbytes += len(pairs) * packed_nbytes(n, qblock)
        else:
            q = k.cast(xs, wire)
            k.cast(q, torch.float32, outs)
            nbytes += len(pairs) * n * q[0].element_size()
    return nbytes


# -- the wrapper ------------------------------------------------------------

def _shares_storage(a_rows, b_rows) -> bool:
    ptrs = {t.untyped_storage().data_ptr() for t in a_rows if t is not None}
    return any(t.untyped_storage().data_ptr() in ptrs
               for t in b_rows if t is not None)


def _memory_overlaps(a_rows, b_rows) -> bool:
    """True when an element range of ``a_rows`` and one of ``b_rows``
    intersect in memory (finer than :func:`_shares_storage`: disjoint
    views of one tensor do not)."""
    spans = [(t.data_ptr(), t.data_ptr() + t.nbytes) for t in b_rows
             if t is not None and t.nbytes]
    return any(a0 < b1 and b0 < a0 + t.nbytes
               for t in a_rows if t is not None and t.nbytes
               for a0 in (t.data_ptr(),) for b0, b1 in spans)


_DENSE = ("allreduce", "reduce_scatter", "allgather", "alltoall")


class RankCollectives:
    """Collectives over the W ranks of a :class:`RankGroup`.

    ``kernels=PLAIN`` runs every collective through the plain PyTorch
    versions instead of the hand-written kernels (the card-side
    yardstick). ``wire_dtype`` names a per-tensor wire (f16, bf16,
    e4m3fn, e5m2) or, with ``qblock``, the block-scaled one.

    Counters of the sequence-parallel dataplane: ``exchange_rounds``
    (permutation rounds run) and ``wire_bytes``, the logical bytes that
    left their rank in those rounds and in alltoalls (a rank's own
    chunk stays and is not counted; the other collectives count
    nothing here). They are plain counters, kept by whichever thread
    calls; the device tier counts its own rounds under its lock
    (``CudaContext.exchange_rounds``)."""

    def __init__(self, group: RankGroup, kernels: Kernels = KERNELS):
        self.group = group
        self.W = group.size
        self.device = group.device
        self.kernels = kernels
        self.exchange_rounds = 0
        self.wire_bytes = 0

    @staticmethod
    def _bs_eligible(op: str, wire: str | None, qblock: int) -> bool:
        """The block-scaled ring lane exists for the ring-shaped dense
        collectives and the quantizable wire dtypes only."""
        return bool(qblock) and wire in WIRE_DTYPE_NAMES and op in (
            "allreduce", "reduce_scatter", "allgather")

    @staticmethod
    def _lane_wire(wire, dtype) -> str | None:
        """The per-tensor wire a payload of ``dtype`` takes: None when
        there is none or it is the payload's own dtype."""
        if wire is None:
            return None
        wire = dtype_name(wire)
        if wire == dtype_name(dtype):
            return None
        if wire not in WIRE_LANE_NAMES:
            raise NotImplementedError(
                f"a {wire} wire without qblock: the per-tensor lanes carry "
                f"{', '.join(WIRE_LANE_NAMES)} (int8 is block-scaled only)")
        if dtype != torch.float32:
            raise TypeError(f"a {wire} wire carries float32 payloads, "
                            f"not {dtype}")
        return wire

    def _rows(self, x, allow_none: bool = False) -> list:
        rows = list(x) if not isinstance(x, torch.Tensor) or x.dim() > 1 \
            else None
        if rows is None or len(rows) != self.W:
            raise ValueError(f"expected {self.W} rank operands")
        if not allow_none and any(r is None for r in rows):
            raise ValueError("a rank operand is missing")
        return [None if r is None else r.reshape(-1) for r in rows]

    def _out(self, out, rows, n_out: int):
        """(return value, output rows): a fresh zeroed (W, n_out) tensor,
        or the caller's tensor / rows (None rows are not written)."""
        like = next(r for r in rows if r is not None)
        if out is None:
            out = torch.zeros((self.W, n_out), dtype=like.dtype,
                              device=like.device)
        return out, self._rows(out, allow_none=True)

    def _run(self, op: str, x, func: ReduceFunc, algorithm: str, wire,
             qblock: int, out):
        if op not in _DENSE:
            raise NotImplementedError(
                f"{op}: not a dense collective of this package")
        rows = self._rows(x)
        W = self.W
        n_in = rows[0].numel()
        n_out = {"allreduce": n_in, "reduce_scatter": n_in // W,
                 "allgather": n_in * W, "alltoall": n_in}[op]
        if op in ("reduce_scatter", "alltoall") and n_in % W:
            raise ValueError(f"{op} operand of {n_in} elements does not "
                             f"split into {W} chunks")
        dtype = rows[0].dtype
        ret = (torch.empty((W, n_out), dtype=dtype, device=rows[0].device)
               if out is None else out)
        out_rows = self._rows(ret)
        wire = None if wire is None else dtype_name(wire)
        bs = self._bs_eligible(op, wire, qblock)
        if not bs:
            wire = self._lane_wire(wire, dtype)
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
        if op == "alltoall":
            alltoall(rows, dst, k, wire)
            esize = (to_torch_dtype(wire) if wire else dtype).itemsize
            self.wire_bytes += (W - 1) * n_in * esize
        elif bs:
            if op == "allreduce":
                ring_allreduce_bs(rows, func, wire, qblock, dst, k)
            elif op == "reduce_scatter":
                ring_reduce_scatter_bs(rows, func, wire, qblock, dst, k)
            else:
                ring_allgather_bs(rows, wire, qblock, dst, k)
        elif algorithm == "ring":
            if op == "allreduce":
                ring_allreduce(rows, func, dst, k, wire)
            elif op == "reduce_scatter":
                ring_reduce_scatter(rows, func, dst, k, wire)
            else:
                ring_allgather(rows, dst, k, wire)
        elif algorithm == "xla" and wire is not None:
            if op == "allreduce":
                xla_compressed_allreduce(rows, func, wire, dst, k)
            elif op == "reduce_scatter":
                xla_compressed_reduce_scatter(rows, func, wire, dst, k)
            else:
                xla_compressed_allgather(rows, wire, dst, k)
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

    def alltoall(self, x, wire_dtype=None, out=None):
        """x: W rows of W*c; out row r, chunk j = row j, chunk r."""
        return self._run("alltoall", x, ReduceFunc.SUM, "xla", wire_dtype,
                         0, out)

    def alltoallv(self, x, send_counts, recv_counts, wire_dtype=None,
                  qblock: int = 0, out=None):
        """Rank r's row sends ``send_counts[r][j]`` elements to rank j
        (prefix-sum intervals); ``out`` row j receives them in its r-th
        interval. ``out`` rows must hold at least sum(recv_counts[j]);
        a fresh (W, max) tensor when None. ``wire_dtype`` names a
        per-tensor wire or, with ``qblock``, the block-scaled one."""
        rows = self._rows(x)
        dtype = rows[0].dtype
        if out is None:
            n = max(sum(int(c) for c in rc) for rc in recv_counts)
            out = torch.zeros((self.W, n), dtype=dtype,
                              device=rows[0].device)
        out_rows = self._rows(out)
        wire = None if wire_dtype is None else dtype_name(wire_dtype)
        if not (qblock and wire in WIRE_DTYPE_NAMES):
            qblock, wire = 0, self._lane_wire(wire, dtype)
        if _memory_overlaps(rows, out_rows):
            rows = [r.clone() for r in rows]
        self.wire_bytes += alltoallv(rows, out_rows, send_counts,
                                     recv_counts, self.kernels, wire,
                                     qblock)
        return out

    # -- point to point (the reference's send_recv / exchange) --------------

    def exchange(self, rows, pairs, out=None) -> list:
        """One permutation round: for each ``(src, dst)`` of ``pairs``
        (every source and every destination at most once), rank dst
        receives ``rows[src]``. Where ``out[dst]`` is a tensor the row is
        copied into it (one device copy); elsewhere the received row is
        ``rows[src]`` itself: the W ranks share one device's memory, so a
        receiver that decodes the payload reads it where it lies. A row
        may be a tuple of tensors that travel together in the round (the
        ring's K and V; only without ``out``). Returns W entries, None
        where nothing lands. The reference's ``exchange_flat`` is a
        ppermute, with no Pallas body."""
        srcs = [s for s, _ in pairs]
        dsts = [d for _, d in pairs]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise ValueError(f"exchange pairs are not a permutation: "
                             f"{list(pairs)}")
        if not all(0 <= r < self.W for r in srcs + dsts):
            raise ValueError(f"exchange pairs outside {self.W} ranks")
        got = [None] * self.W
        for s, d in pairs:
            tgt = None if out is None else out[d]
            if tgt is None:
                got[d] = rows[s]
            else:
                tgt.copy_(rows[s])
                got[d] = tgt
            if s != d:
                parts = rows[s] if isinstance(rows[s], tuple) else (rows[s],)
                self.wire_bytes += sum(t.nbytes for t in parts)
        self.exchange_rounds += 1
        return got

    # -- rooted collectives (binomial schedules, parallel/tree.py) ---------

    def bcast(self, x, root: int = 0, wire_dtype=None, out=None):
        """Every row receives ``x[root]``; ``out`` may be ``x`` itself
        (non-root input rows are never read)."""
        from .tree import binomial_bcast
        rows = self._rows(x, allow_none=True)
        src = rows[root]
        wire = self._lane_wire(wire_dtype, src.dtype)
        if out is None:
            out = torch.empty((self.W, src.numel()), dtype=src.dtype,
                              device=src.device)
        rows = [src if r is None else r for r in rows]
        binomial_bcast(rows, root, self._rows(out), self.kernels, wire)
        return out

    def scatter(self, x, root: int = 0, wire_dtype=None, out=None):
        """Row r receives chunk r of ``x[root]`` (W*c); non-root rows of
        ``x`` may be None (zeros)."""
        from .tree import binomial_scatter
        rows = self._rows(x, allow_none=True)
        src = rows[root]
        wire = self._lane_wire(wire_dtype, src.dtype)
        if src.numel() % self.W:
            raise ValueError(f"scatter operand of {src.numel()} elements "
                             f"does not split into {self.W} chunks")
        ret, out_rows = self._out(out, rows, src.numel() // self.W)
        binomial_scatter(rows, root, out_rows, self.kernels, wire)
        return ret

    def gather(self, x, root: int = 0, wire_dtype=None, out=None):
        """Row ``root`` receives every row of ``x`` (chunk j from rank
        j); other rows of the result are zero (None rows of ``out`` are
        not written)."""
        from .tree import binomial_gather
        rows = self._rows(x)
        wire = self._lane_wire(wire_dtype, rows[0].dtype)
        ret, out_rows = self._out(out, rows, rows[0].numel() * self.W)
        binomial_gather(rows, root, out_rows, self.kernels, wire)
        return ret

    def reduce(self, x, root: int = 0, func: ReduceFunc = ReduceFunc.SUM,
               wire_dtype=None, algorithm: str = "xla", out=None):
        """The reference's 1-D rooted reduce: an allreduce (ring, or the
        xla family: compressed with a wire) whose result only the root
        keeps; other rows of the result are zero (None rows of ``out``
        are not written). The 2D tree reduction is
        :meth:`Tree2DCollectives.reduce`."""
        rows = self._rows(x)
        ret, out_rows = self._out(out, rows, rows[0].numel())
        full = self.allreduce(rows, func, algorithm, wire_dtype)
        out_rows[root].copy_(full[root])
        for r, o in enumerate(out_rows):
            if o is not None and r != root:
                o.zero_()
        return ret
