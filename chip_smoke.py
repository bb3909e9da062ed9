#!/usr/bin/env python3
"""Drive accl_tpu_torch on an NVIDIA GPU: build, kernel phases, main path.

Run from the root of a checkout:  python3 chip_smoke.py

1. Device and build: requires CUDA, prints the card's name and power
   limit, builds the CUDA kernels from ``accl_tpu_torch/csrc`` (one
   nvcc per source, all started together).
2. Kernel phases: each kernel (B1 combine, B2 cast, B3 fp8_quant with
   its fp8_scale step, B4 fp8_dequant, B5 bs_quant, B6 bs_dequant, B7
   bs_combine) against its plain PyTorch version on the same CUDA
   inputs, bitwise (a NaN matches a NaN; every other value bit for bit),
   over an edge corpus (NaN, +-inf, +-0, f32 denormals, values past every
   wire's max, all-zero blocks, ragged tails and unaligned rows, every
   wire dtype, func and block size; every 16- and 8-bit code for the
   up-casts) and at the main path's hop shape (8 rank rows of one 8 Mi-
   element ring chunk), where each is timed with CUDA events (median of
   many launches after warm-up). B1 and B2 (one tile a block,
   ``csrc/stream.cuh``) first show 128-bit global accesses in their
   SASS and no ptxas spills, then meet the edges of their tiles: row
   lengths 0, 1, one step - 1, one tile - 1, one tile, one tile + 1 and
   one past what the card holds at once, 1, 7, 8, 32 and 33 rows, a
   second operand or output one element off, out aliasing a and b; all
   bitwise. B7 (one tile a block, ``csrc/bs_codec.cu``) shows 128-bit
   loads of ``other`` (and round-closing stores) in the SASS of every
   instantiation and no spills, then meets its own edges in both modes
   (``bs_edge_cases``): every wire and block size 32-4096, lengths 0,
   1, 3, one scale block - 1, + 0, + 1 and one tile - 1, + 0, + 1, the
   same row counts, ``other`` or the code rows one element off, blocks
   whose amax is NaN, inf, 0, denormal or just above FLT_MIN * qmax,
   rounding ties; guard bytes around every output row. B1's record times
   the ring's out-of-place call; B1 in place in f32 and bf16 is timed
   beside ``torch.add(a, b, out=a)``, B2 in six directions beside
   ``.to(dtype)``, B7's round-closing mode beside its requant record,
   each with its bound, beside the ``copy_`` rate of the same bytes.
3. Main path: ``cuda_world(8)`` with device-resident buffers of 64 Mi
   fp32 per rank, through ``ACCL``: ring allreduce, reduce_scatter and
   allgather (fp32), the fp8-e4m3 block-scaled (block 128) ring
   allreduce, the ring allreduce on the f16, bf16 and per-tensor
   fp8-e4m3 wires, the xla-family allreduce on per-tensor fp8-e4m3,
   bcast (root 3, bf16 wire), reduce (root 5, fp32, AUTO: the 2x4 tree),
   scatter and gather (root 3, f16 wire, 8 Mi per rank) and alltoall
   (fp8-e4m3 pure cast, 8 Mi per peer). Every result is held against
   the plain path (the same schedule through the plain versions) bitwise
   (the xla family within rtol=1e-6, atol=1e-6: its rank-axis sum is a
   torch reduction) and against a float64 golden within a bound printed
   beside the measured error (see ``golden_bound``). Every kernel's
   launch count must rise during this run.
4. Where the time goes: each call of the main path once more under
   torch.profiler, device time summed per kernel family, beside the
   call's host-clock time (the rest is the device's idle share); then
   the combine (B1) and cast (B2) families' ms per call on one line.
4b. Point-to-point and local ops: ``cuda_world(8)`` with device-resident
   buffers of 64 Mi fp32 a rank, through ``ACCL``: a ring shift (rank r
   sends to r+1, receives from r-1, every call async) on the fp32, f16,
   bf16 and fp8-e4m3 block-128 wires, a conflicting set (8 transfers,
   every source twice), a host-mirror ring of 8 Mi, ``copy``, ``combine``
   SUM and MAX in f32 and bf16, and at 8 Mi the stream ports: copy and
   combine from ``stream_push``, recv to the stream-out port and
   ``stream_pop``, ``stream_put``. Every result bitwise against the same
   work through the plain versions and against numpy (exact, or within
   the block codec's bound, printed beside the error); B1, B2, B5 and B6
   must launch; a call takes at most one exchange round a transfer, and
   with the exchange held busy until all its transfers wait, the ring
   shift takes one round, the conflicting set two. Then phase 4's lines
   for each call, with the library's share of its host time, its
   logical wire bytes, exchange rounds and launches.
5. Attention kernels: B8 (``attn_fwd``), B9 (``attn_fwd_single``) and
   B12 (``attn_decode``, ``attn_prefill``) against their plain versions
   on the same CUDA inputs: the CPU tests' shapes, single-block B9 cases
   (Skv 40 to 2048, MHA/GQA/MQA, causal and not, Sq != Skv), NaN in the
   cache past ``kv_len`` with ``kv_len`` at 1, one key tile -1, +0, +1
   and T, chunks of 3, 64 and 65 new tokens after a filled prefix,
   single-token decode with more key slices than filled tiles, and the
   full-width shapes of Llama-3-8B (H=32, Hkv=8, D=128) in bf16 and f32
   (B9 at S=128 and at the serving path's S=512), each timed with CUDA
   events beside the same function through PyTorch's
   ``scaled_dot_product_attention`` (timed only; the port never calls
   it). bf16 B8, bf16 B9 and bf16 B12 chunks run on the tensor cores
   (``attention_sm90.cu``) and are held under the limit of their
   rounding of P (``FWD_TOL``); single-token decode runs the split-KV
   kernels (``attention_decode.cu``) in both dtypes, its ``n_split``
   printed.
6. Llama model, f32, full width, 4 layers: the same random weights
   through ``attention="flash"`` (the kernels) and ``"dense"`` (the
   reference's plain path): ``forward`` on (2, 2048) (B8) and (4, 128)
   (B9), ``forward_cached`` over a 1000-token prefill and 8 decode steps
   (B12), held within a stated tolerance.
7. Serving: Llama-3-8B as published (32 layers, bf16 weights), four
   random 1024-token prompts through ``generate(max_new=32)``, and
   ``forward`` on their first 512 tokens (B9: one key block); the
   prefill logits of ``forward_cached`` against ``forward``, every
   logit against the dense path; forward, prefill and per-step decode
   time, tokens/s, the device's busy share per kernel family under
   torch.profiler and the peak memory. The attention launch counters are
   zeroed before phase 6 and again before phase 7's pass: every
   attention kernel must have run there, every bf16 B8, B9 and B12
   prefill launch on the tensor-core route and no f32 one, and every
   single-token decode on the split-KV kernel (the route counters).
8. Attention backward: the bf16 route's kernels (``attention_sm90.cu``:
   B8, B9 and B12 prefill; ``attention_bwd_sm90.cu``) hold HGMMA
   instructions in their SASS (``cuobjdump -sass``), with no ptxas spills
   and no wgmma that ptxas serialized (the split-KV decode kernel's
   registers and spills printed beside them); B10 (``attn_bwd_dkv``) and
   B11 (``attn_bwd_dq``) against their plain versions on an edge corpus
   (MHA/GQA/MQA, causal and not, ragged S, Sq != Skv both ways, D 16-128,
   f32 and bf16) and at the full Llama-3-8B width (B=4, H=32, Hkv=8,
   S=2048, D=128) in bf16 and f32, timed beside PyTorch's SDPA backward
   (timed only), bf16 under the limit of its rounding of P and dS
   (``BWD_TOL``); the autograd Function's gradients (B8 + B10 + B11)
   against torch autograd through dense attention at the same shape, bf16
   (relative L2, SDPA's beside it) and f32. Then a gradient check: a
   2-layer f32 Llama-3-8B, flash against dense, on (1, 2048): the loss
   and every parameter's gradient.
9. Training: Llama-3-8B width, 8 of 32 layers, f32 parameters and bf16
   activations, ``make_train_step`` with Adam(lr=1e-4), 4 steps on one
   (2, 2048) batch: finite losses that fall, B8/B10/B11 once per layer
   per step (B8 on the tensor-core route), the first and last layer's
   B10 and B11 calls of the first step and B8 calls of one more forward
   against their plain versions, step time,
   tokens/s, model FLOPs, the busy share and kernels by family under
   torch.profiler, peak memory. Less than 2 GiB
   may be allocated when it starts.

Each phase starts with a line of the device memory allocated.

Prints per-kernel and per-call lines, then one JSON line of kernel
records, then ``{"ok": true, "device": {...}}`` as the last line. Any
failure raises: the exit code is then not 0 and no result line prints.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import gc
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

W = 8                      # ranks
N = 64 << 20               # fp32 elements per rank (256 MiB)
QBLOCK = 128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
SEED = 20261016
T_START = time.perf_counter()   # the phase lines' clock
# tests/test_pallas_quant.py holds the W=4 quantized allreduce within
# 0.07 * max(sum_r |x_r|) + 1e-3: an allreduce quantizes each element W
# times (W-1 on the reduce-scatter, once for the allgather), so per
# quantization that is 0.07 / 4 of max(sum_r |x_r|)
FP8_BOUND_PER_QUANT = 0.07 / 4
ROOT = 3                   # bcast / scatter / gather
REDUCE_ROOT = 5
# per-tensor wires: unit roundoff u (half an ulp at 1), and the largest
# absolute error of one rounding in the wire's denormal range, in units
# of the payload's scale (1 for a pure cast; amax / fp8_max for the
# scaled fp8 codec)
WIRE_U = {"float16": 2.0 ** -11, "bfloat16": 2.0 ** -8,
          "float8_e4m3fn": 2.0 ** -4, "float8_e5m2": 2.0 ** -3}
WIRE_DENORMAL = {"float16": 2.0 ** -25, "bfloat16": 0.0,
                 "float8_e4m3fn": 2.0 ** -10, "float8_e5m2": 2.0 ** -17}
FP8_MAX = {"float8_e4m3fn": 448.0, "float8_e5m2": 57344.0}


class SmokeFailure(RuntimeError):
    pass


def need(cond, what: str):
    if not cond:
        raise SmokeFailure(what)


HEAD_START_CYCLES = 50_000_000   # ~25 ms of GPU sleep at the H100's clock
# ahead of one p2p call of phase 4b, whose host part takes 10-30 ms
CALL_HEAD_START_CYCLES = 400_000_000


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call).
    The calls are enqueued behind a GPU sleep of ``HEAD_START_CYCLES``,
    so the host runs ahead of the device and each event pair times the
    kernels alone, not the host's Python between two short launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HEAD_START_CYCLES)
    evs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        evs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def bound_ms(nbytes: int, nops: int,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def same_bits(a, b) -> tuple[bool, float]:
    """(bitwise equal with NaN matching NaN, max |a-b| over non-NaN)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False, float("inf")
    if a.element_size() == 1:           # fp8 and int8 codes: as bytes
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        if not torch.equal(na, nb):
            return False, float("inf")
        ia = a.masked_fill(na, 0).contiguous()
        ib = b.masked_fill(nb, 0).contiguous()
        iv = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[a.element_size()]
        eq = torch.equal(ia.view(iv), ib.view(iv))
        fin = torch.isfinite(ia) & torch.isfinite(ib)
        d = (ia.double() - ib.double()).abs()[fin]
        err = float(d.max()) if d.numel() else 0.0
        return eq, err
    eq = torch.equal(a, b)
    return eq, float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def check_rows(got, ref, what: str) -> float:
    worst = 0.0
    for g, r in zip(got, ref):
        eq, err = same_bits(g, r)
        need(eq, f"{what}: kernel and plain version differ "
                 f"(max abs err {err})")
        worst = max(worst, err)
    return worst


def edge_corpus(rng, n: int) -> np.ndarray:
    x = (rng.standard_normal(n).astype(np.float32)
         * np.float32(10.0) ** rng.integers(-24, 24, n).astype(np.float32))
    specials = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-40, -3e-42,
                         500.0, -1e5, 7e4, 448.0, 57344.0, 6e4] * 8,
                        np.float32)
    x[:specials.size] = specials
    rng.shuffle(x)
    x[:4096] = 0.0                      # an all-zero block at every size
    return x


# -- phases ------------------------------------------------------------------

def phase_device():
    import torch
    need(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    need(smi.returncode == 0 and smi.stdout.strip(),
         f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])   # name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    from accl_tpu_torch import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds})")
    regs = [ln.strip() for ln in _build.build_log.splitlines()
            if "registers" in ln]
    spills = [ln.strip() for ln in _build.build_log.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes")
              and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    print(f"ptxas: {len(regs)} kernels; spill lines: {len(spills)}")
    for ln in spills[:5]:
        print(f"  {ln}")


def corpus_combine(rng):
    import torch
    from accl_tpu_torch.constants import ReduceFunc
    from accl_tpu_torch.ops.combine import combine, combine_ref
    n = 100_003
    for dtype in (torch.float32, torch.float16, torch.bfloat16,
                  torch.float64, torch.int32, torch.int64, torch.int8):
        for func in ReduceFunc:
            rows_a, rows_b = [], []
            for _ in range(3):
                if dtype.is_floating_point:
                    a = torch.from_numpy(edge_corpus(rng, n)).to(dtype)
                    b = torch.from_numpy(edge_corpus(rng, n)).to(dtype)
                else:
                    info = torch.iinfo(dtype)
                    a = torch.from_numpy(rng.integers(
                        info.min, info.max, n)).to(dtype)
                    b = torch.from_numpy(rng.integers(
                        info.min, info.max, n)).to(dtype)
                rows_a.append(a.cuda())
                rows_b.append(b.cuda())
            ref = combine_ref(rows_a, rows_b, func)
            check_rows(combine(rows_a, rows_b, func), ref,
                       f"combine {dtype} {func.name}")
            # unaligned rows (scalar path) and in place (out aliases a)
            ua = [r[1:] for r in rows_a]
            ub = [r[1:] for r in rows_b]
            check_rows(combine(ua, ub, func), combine_ref(ua, ub, func),
                       f"combine {dtype} {func.name} unaligned")
            combine(rows_a, rows_b, func, out=rows_a)
            check_rows(rows_a, ref, f"combine {dtype} {func.name} in place")
    print("combine: edge corpus bitwise over 7 dtypes x 4 funcs")


def corpus_codec(rng):
    import torch
    from accl_tpu_torch.constants import ReduceFunc
    from accl_tpu_torch.ops import compression as C
    n = 3 * 4096 + 1001                 # ragged for every block size
    for wire in ("int8", "float8_e4m3fn", "float8_e5m2"):
        for block in (32, 128, 4096):
            xs = [torch.from_numpy(edge_corpus(rng, n)).cuda()
                  for _ in range(3)]
            q, s = C.bs_quant(xs, wire, block)
            rq, rs = C.bs_quant_ref(xs, wire, block)
            check_rows(q, rq, f"bs_quant codes {wire}/{block}")
            check_rows(s, rs, f"bs_quant scales {wire}/{block}")
            check_rows(C.bs_dequant(q, s, wire, block),
                       C.bs_dequant_ref(q, s, wire, block),
                       f"bs_dequant {wire}/{block}")
            for func in ReduceFunc:
                others = [torch.from_numpy(edge_corpus(rng, n)).cuda()
                          for _ in range(3)]
                q2, s2 = C.bs_combine(q, s, others, func, wire, block)
                rq2, rs2 = C.bs_combine_ref(q, s, others, func, wire, block)
                what = f"bs_combine {wire}/{block} {func.name}"
                check_rows(q2, rq2, what + " codes")
                check_rows(s2, rs2, what + " scales")
                check_rows(C.bs_combine(q, s, others, func, wire, block,
                                        requant=False),
                           C.bs_combine_ref(q, s, others, func, wire, block,
                                            requant=False),
                           what + " f32")
    print("bs codec: edge corpus bitwise over 3 wires x 3 blocks "
          "(x 4 funcs for bs_combine)")


LANE_WIRES = ("float16", "bfloat16", "float8_e4m3fn", "float8_e5m2")


def corpus_lanes(rng):
    """B2-B4 over the edge corpus, unaligned rows, every code, and
    payloads whose amax is NaN, 0, tiny or huge."""
    import torch
    from accl_tpu_torch.ops import compression as C
    n = 3 * 4096 + 1001
    for wire in LANE_WIRES:
        dt = getattr(torch, wire)
        xs = [torch.from_numpy(edge_corpus(rng, n)).cuda() for _ in range(3)]
        down = C.cast(xs, dt)
        check_rows(down, C.cast_ref(xs, dt), f"cast f32->{wire}")
        check_rows(C.cast(down, torch.float32),
                   C.cast_ref(down, torch.float32), f"cast {wire}->f32")
        ua = [x[1:] for x in xs]
        check_rows(C.cast(ua, dt), C.cast_ref(ua, dt),
                   f"cast f32->{wire} unaligned")
        bits = 8 if dt.itemsize == 1 else 16
        codes = torch.arange(1 << bits, device="cuda").to(
            torch.uint8 if bits == 8 else torch.int32)
        if bits == 16:
            codes = (codes - (codes >= 1 << 15).int() * (1 << 16)).to(
                torch.int16)
        every = [codes.view(dt)]
        check_rows(C.cast(every, torch.float32),
                   C.cast_ref(every, torch.float32), f"cast every {wire}")
        if wire not in C.FP8_DTYPE_NAMES:
            continue
        clean = torch.from_numpy(edge_corpus(rng, n)).cuda()
        clean = torch.where(torch.isfinite(clean), clean,
                            torch.zeros_like(clean))
        rows = [xs[0], clean, torch.zeros(n, device="cuda"),
                clean * 1e-30, clean * 1e-38, clean[:1].expand(n) + 0]
        s, inv = C.fp8_scale(rows, wire)
        rs, rinv = C.fp8_scale_ref(rows, wire)
        check_rows(s, rs, f"fp8_scale {wire} scales")
        check_rows(inv, rinv, f"fp8_scale {wire} inverses")
        q = C.fp8_quant(rows, inv, wire)
        check_rows(q, C.fp8_quant_ref(rows, inv, wire), f"fp8_quant {wire}")
        check_rows(C.fp8_dequant(q, s, wire),
                   C.fp8_dequant_ref(q, s, wire), f"fp8_dequant {wire}")
        uq = C.fp8_quant([r[3:] for r in rows], inv, wire)
        check_rows(uq, C.fp8_quant_ref([r[3:] for r in rows], inv, wire),
                   f"fp8_quant {wire} unaligned")
        check_rows(C.fp8_dequant(uq, s, wire),
                   C.fp8_dequant_ref(uq, s, wire),
                   f"fp8_dequant {wire} unaligned")
    print("wire lanes: edge corpus bitwise over 4 wires (casts both ways, "
          "every code; fp8 scale/quant/dequant incl. NaN, zero, tiny and "
          "unaligned rows)")


COMBINE_DTYPES = ("float32", "float16", "bfloat16", "float64", "int32",
                  "int64", "int8")
CAST_PAIRS = tuple((a, b) for w in LANE_WIRES
                   for a, b in (("float32", w), (w, "float32")))
EDGE_ROWS = (1, 7, 8, 32, 33)        # 33: two launches of 32 and 1 row


# B1's and B2's tiles (csrc/stream.cuh: STREAM_THREADS thread-steps a
# block; a step is 16 bytes of each B1 operand, CAST_STEP elements of B2)
STREAM_THREADS = 256
CAST_STEP = 4


def combine_step(itemsize: int) -> int:
    """Elements of one B1 thread-step: a 16-byte vector."""
    return 16 // itemsize


def edge_lengths(vec: int, tile: int, rows: int) -> list:
    """Row lengths at the tiles' edges: 0, 1, one vector step - 1, one
    tile - 1, one tile, one tile + 1, and one that gives a launch of
    ``rows`` rows more blocks than the card holds at once (132 SMs of at
    most 8 such blocks) with a ragged last tile."""
    return [0, 1, vec - 1, tile - 1, tile, tile + 1,
            (2048 // rows + 1) * tile - 3]


def stream_operands(make, nrows: int, n: int, shift: int = 0):
    """``nrows`` rows of ``n`` elements as views into one buffer, as the
    ring's chunks are (a row is 16-byte aligned only where its offset
    is), each starting ``shift`` elements into its slot."""
    buf = make((nrows, n + shift))
    return [r[shift:] for r in buf]


def edge_values(rng, shape):
    """f32 edge-corpus values of ``shape`` on the card, at any size: the
    tail of a corpus longer than its leading zero block."""
    import torch
    n = shape[0] * shape[1]
    x = edge_corpus(rng, n + 8192)[8192:]
    return torch.from_numpy(x).cuda().view(shape)


def stream_edges(rng):
    """B1 and B2 at the edges of their tiles (csrc/stream.cuh), bitwise
    against their plain versions: row lengths 0, 1, one vector step - 1,
    one tile - 1, one tile, one tile + 1 and one past what the card
    holds at once; nrows 1, 7, 8, 32 and 33 (two launches); rows whose
    second operand (B1) or output (B2) is one element off; out aliasing
    a and aliasing b."""
    import torch
    from accl_tpu_torch.constants import ReduceFunc
    from accl_tpu_torch.ops import compression as C
    from accl_tpu_torch.ops.combine import combine, combine_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    cases = 0
    for di, name in enumerate(COMBINE_DTYPES):
        dt = getattr(torch, name)
        vec = combine_step(dt.itemsize)

        def make(shape, dt=dt):
            if dt.is_floating_point:
                return edge_values(rng, shape).to(dt)
            info = torch.iinfo(dt)
            return torch.randint(info.min, info.max, shape, dtype=dt,
                                 device="cuda", generator=gen)

        for ni, nrows in enumerate(EDGE_ROWS):
            func = ReduceFunc((di + ni) % 4)
            for n in edge_lengths(vec, STREAM_THREADS * vec, min(nrows, 32)):
                what = f"combine edge {name} {func.name} {nrows}x{n}"
                a = stream_operands(make, nrows, n)
                b = stream_operands(make, nrows, n, shift=1)
                ref = combine_ref(a, b, func)
                check_rows(combine(a, b, func), ref, what)
                a2 = [t.clone() for t in a]
                combine(a2, b, func, out=a2)
                check_rows(a2, ref, what + " out=a")
                b2 = [t.clone() for t in b]
                combine(a, b2, func, out=b2)
                check_rows(b2, ref, what + " out=b")
                cases += 1
    for src, dst in CAST_PAIRS:
        sdt, ddt = getattr(torch, src), getattr(torch, dst)

        def make(shape, sdt=sdt):
            if sdt == torch.float32:
                return edge_values(rng, shape)
            if sdt.itemsize == 1:           # every code, NaNs included
                return torch.randint(0, 1 << 8, shape, dtype=torch.uint8,
                                     device="cuda", generator=gen).view(sdt)
            return torch.randint(-(1 << 15), 1 << 15, shape,
                                 dtype=torch.int16, device="cuda",
                                 generator=gen).view(sdt)

        for nrows in EDGE_ROWS:
            for n in edge_lengths(CAST_STEP, STREAM_THREADS * CAST_STEP,
                                  min(nrows, 32)):
                what = f"cast edge {src}->{dst} {nrows}x{n}"
                x = stream_operands(make, nrows, n)
                ref = C.cast_ref(x, ddt)
                check_rows(C.cast(x, ddt), ref, what)
                y = stream_operands(lambda shape: torch.empty(
                    shape, dtype=ddt, device="cuda"), nrows, n, shift=1)
                check_rows(C.cast(x, ddt, y), ref, what + " output off")
                cases += 1
    print(f"stream edges: B1 and B2 bitwise over {cases} (dtype or lane "
          f"pair, nrows, length) cases, aligned, one element off and in "
          f"place")


# B7's tiles (csrc/bs_codec.cu: BS_THREADS thread-steps of BS_STEP
# elements a block, S = block / tile steps a thread where a scale block is
# larger than one step of every thread, so that a tile holds whole scale
# blocks); every block size the codec takes, its three amax reductions
# (shuffles within a warp, shared memory, several steps a thread)
BS_THREADS = 256
BS_STEP = 4
BS_BLOCKS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
BS_WIRES = ("int8", "float8_e4m3fn", "float8_e5m2")
# where the rows lie: all at their slots; `other` one element off (its
# scalar path); the code rows in and out one byte off
BS_LAYOUTS = ("aligned", "other off", "codes off")
# what block 0 of a row holds, rotated over the rows: the edge values as
# they are; an amax that is NaN, inf, 0 or an f32 denormal (the scale
# falls back to 1, the integer encoder); a scale just above FLT_MIN (the
# largest inverse the hardware conversion meets); the wire's rounding
# ties at scale 1
BS_KINDS = (None, "nan", "inf", "zero", "denormal", "tiny", "ties")
# values halfway between two codes of each wire at scale 1, the wire's
# denormal range included (qmax itself sits in the block to fix s = 1),
# and f32 denormals of either sign (codes +-0)
BS_TIES = {"int8": (0.5, 1.5, 2.5, -2.5, 126.5, -0.5, -1e-40),
           "float8_e4m3fn": (1.0625, 1.1875, -1.0625, 2.0 ** -10,
                             3 * 2.0 ** -10, -(2.0 ** -10), 432.0, 232.0,
                             -1e-40, 3e-42),
           "float8_e5m2": (1.125, 1.375, -1.125, 2.0 ** -17, 3 * 2.0 ** -17,
                           -(2.0 ** -17), 53248.0, 26624.0, -1e-40, 3e-42)}


def bs_tile(block: int) -> int:
    """Elements of one B7 tile: one step of every thread, or one scale
    block where that is larger."""
    return max(BS_THREADS * BS_STEP, block)


def bs_edge_lengths(block: int) -> list:
    """Row lengths at B7's edges: 0, 1, 3 (less than one step), one
    scale block - 1, + 0 and + 1, one tile - 1, + 0 and + 1."""
    tile = bs_tile(block)
    return sorted({0, 1, 3, block - 1, block, block + 1, tile - 1, tile,
                   tile + 1})


def bs_edge_cases() -> list:
    """(wire, block, nrows, n, func, layout) of B7's tile-edge check:
    every wire, block size, row count and edge length; the four funcs
    and the layouts rotated over them, as ``stream_edges`` rotates its
    funcs. Each case runs both modes (requant and round-closing)."""
    cases = []
    for wi, wire in enumerate(BS_WIRES):
        for bi, block in enumerate(BS_BLOCKS):
            for ni, nrows in enumerate(EDGE_ROWS):
                for li, n in enumerate(bs_edge_lengths(block)):
                    cases.append((wire, block, nrows, n,
                                  (wi + bi + ni + li) % 4,
                                  BS_LAYOUTS[(ni + li) % len(BS_LAYOUTS)]))
    return cases


def bs_edge_payload(rng, wire: str, block: int, nrows: int, n: int,
                    salt: int, device: str = "cuda"):
    """The f32 rows that are quantized into the received codes, and the
    local ``other`` rows, (nrows, n) edge values on ``device``; block 0
    of row r holds BS_KINDS[(r + salt) % len(BS_KINDS)] in ``other``,
    over a payload of zeros (codes 0: the combined value is func(other,
    0))."""
    import torch
    from accl_tpu_torch.quant import _FLT_MIN, _QMAX
    x, other = (edge_corpus(rng, nrows * n + 8192)[8192:].reshape(nrows, n)
                for _ in range(2))
    b = min(block, n)
    for r in range(nrows if b else 0):
        kind = BS_KINDS[(r + salt) % len(BS_KINDS)]
        if kind is None:
            continue
        x[r, :b] = 0.0
        mag = rng.uniform(1.0, 2.0, b) * rng.choice([-1.0, 1.0], b)
        if kind == "nan":
            other[r, b // 2] = np.nan
        elif kind == "inf":
            other[r, b - 1] = -np.inf
        elif kind == "zero":
            other[r, :b] = 0.0
        elif kind == "denormal":
            other[r, :b] = mag * 1e-40
        elif kind == "tiny":
            other[r, :b] = mag * (_FLT_MIN * _QMAX[wire])
        else:
            ties = BS_TIES[wire]
            other[r, :b] = [ties[i % len(ties)] for i in range(b)]
            other[r, 0] = _QMAX[wire]
    return (torch.from_numpy(x).to(device), torch.from_numpy(other).to(device))


def bs_edges(rng):
    """B7 at the edges of its tiles (csrc/bs_codec.cu), bitwise against
    ``bs_combine_ref`` in both modes (``bs_edge_cases``): outputs in
    buffers of their own, with guard bytes around every row that must
    stay as they were."""
    import torch
    from accl_tpu_torch.constants import ReduceFunc
    from accl_tpu_torch.ops import compression as C
    from accl_tpu_torch.quant import n_blocks
    cases = bs_edge_cases()
    for ci, (wire, block, nrows, n, func, layout) in enumerate(cases):
        func = ReduceFunc(func)
        what = f"bs_combine edge {wire}/{block} {func.name} {nrows}x{n} {layout}"
        nb = n_blocks(n, block)
        x, xo = bs_edge_payload(rng, wire, block, nrows, n, ci)
        q0, s = C.bs_quant(list(x), wire, block)
        qs = 1 if layout == "codes off" else 0
        xs = 1 if layout == "other off" else 0
        q = stream_operands(lambda shape: torch.empty(
            shape, dtype=torch.uint8, device="cuda"), nrows, n, shift=qs)
        other = stream_operands(lambda shape: torch.empty(
            shape, device="cuda"), nrows, n, shift=xs)
        for r in range(nrows):
            q[r].copy_(q0[r])
            other[r].copy_(xo[r])
        q2buf = torch.full((nrows, n + qs + 4), 0xA5, dtype=torch.uint8,
                           device="cuda")
        s2buf = torch.full((nrows, nb + 1), -7.5, device="cuda")
        obuf = torch.full((nrows, n + qs + 4), 12345.0, device="cuda")
        q2 = list(q2buf[:, qs:qs + n])
        s2 = list(s2buf[:, :nb])
        out = list(obuf[:, qs:qs + n])
        C.bs_combine(q, s, other, func, wire, block, q2, s2)
        C.bs_combine(q, s, other, func, wire, block, out=out, requant=False)
        rq2, rs2 = C.bs_combine_ref(q, s, other, func, wire, block)
        check_rows(q2, rq2, what + " codes")
        check_rows(s2, rs2, what + " scales")
        check_rows(out, C.bs_combine_ref(q, s, other, func, wire, block,
                                         requant=False), what + " f32")
        guard = torch.ones_like(q2buf, dtype=torch.bool)
        guard[:, qs:qs + n] = False
        need(bool((q2buf[guard] == 0xA5).all())
             and bool((s2buf[:, nb] == -7.5).all())
             and bool((obuf[guard] == 12345.0).all()),
             f"{what}: a store outside the rows")
    print(f"bs edges: B7 bitwise in both modes over {len(cases)} (wire, "
          f"block, nrows, length) cases, {len(BS_BLOCKS)} block sizes, "
          f"funcs and layouts ({', '.join(BS_LAYOUTS)}) rotated; amax NaN, "
          f"inf, 0, denormal, just above FLT_MIN and rounding ties")


def kernel_records():
    """Each kernel at the main path's shape (W rows of one 32 MiB ring
    chunk: the per-hop launch), against its plain version, timed."""
    import torch
    from accl_tpu_torch.constants import ReduceFunc
    from accl_tpu_torch.ops import compression as C
    from accl_tpu_torch.ops.combine import combine, combine_ref
    g = torch.Generator(device="cuda").manual_seed(SEED)
    c = N // W
    nb = c // QBLOCK
    wire = "float8_e4m3fn"
    a = torch.randn(W, c, device="cuda", generator=g)
    b = torch.randn(W, c, device="cuda", generator=g)
    out = torch.empty_like(a)
    ra, rb, ro = list(a), list(b), list(out)
    recs = []

    def rec(name, source, replaces, err, ms, plain_ms, nbytes, nops,
            library_ms=None):
        bms, by = bound_ms(nbytes, nops)
        recs.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by,
                     "library_ms": library_ms})
        print(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"bound {bms:.4f} ms by {by}, {100 * bms / ms:.1f} % of it"
              + (f", library {library_ms:.4f} ms" if library_ms else "")
              + f"), max abs err vs plain {err}")

    copy_ms = time_ms(lambda: out.copy_(a))
    print(f"copy_ ceiling: {copy_ms:.4f} ms for 8 x 8 Mi f32 (bound "
          f"{bound_ms(8 * N, 0)[0]:.4f} ms)")

    def variant(ms, library_ms, nbytes):
        bms = bound_ms(nbytes, 0)[0]
        return {"ms": ms, "library_ms": library_ms, "bound_ms": bms,
                "pct_of_bound": 100 * bms / ms}

    err = check_rows(combine(ra, rb, ReduceFunc.SUM, out=ro),
                     combine_ref(ra, rb, ReduceFunc.SUM), "combine main")
    flat_a, flat_b = a.view(-1), b.view(-1)
    library_ms = time_ms(lambda: torch.add(flat_a, flat_b, out=flat_a))
    # out of place, as the ring calls it (parallel/collectives.py)
    rec("combine", "accl_tpu_torch/csrc/combine.cu",
        "accl_tpu/ops/combine.py:71", err,
        time_ms(lambda: combine(ra, rb, ReduceFunc.SUM, out=ro)),
        time_ms(lambda: combine_ref(ra, rb, ReduceFunc.SUM, out=ro)),
        3 * 4 * N, N, library_ms=library_ms)
    a16, b16 = a.bfloat16(), b.bfloat16()
    r16, s16 = list(a16), list(b16)
    check_rows(combine(r16, s16, ReduceFunc.SUM),
               combine_ref(r16, s16, ReduceFunc.SUM), "combine main bf16")
    f16a, f16b = a16.view(-1), b16.view(-1)
    # in place beside torch.add(out=a): the same call on the same bytes
    recs[-1]["variants"] = {
        "SUM float32 in place": variant(
            time_ms(lambda: combine(ra, rb, ReduceFunc.SUM, out=ra)),
            library_ms, 3 * 4 * N),
        "SUM bfloat16 in place": variant(
            time_ms(lambda: combine(r16, s16, ReduceFunc.SUM, out=r16)),
            time_ms(lambda: torch.add(f16a, f16b, out=f16a)), 3 * 2 * N)}
    recs[-1]["copy_ceiling_ms"] = copy_ms
    del a16, b16, r16, s16, f16a, f16b
    a.copy_(torch.randn(W, c, device="cuda", generator=g))

    q = list(torch.empty(W, c, dtype=torch.uint8, device="cuda"))
    s = list(torch.empty(W, nb, device="cuda"))
    C.bs_quant(ra, wire, QBLOCK, q, s)
    rq, rs = C.bs_quant_ref(ra, wire, QBLOCK)
    err = max(check_rows(q, rq, "bs_quant main codes"),
              check_rows(s, rs, "bs_quant main scales"))
    rec("bs_quant", "accl_tpu_torch/csrc/bs_codec.cu",
        "accl_tpu/ops/compression.py:358", err,
        time_ms(lambda: C.bs_quant(ra, wire, QBLOCK, q, s)),
        time_ms(lambda: C.bs_quant_ref(ra, wire, QBLOCK, q, s), reps=5),
        4 * N + N + 4 * N // QBLOCK, 4 * N)

    err = check_rows(C.bs_dequant(q, s, wire, QBLOCK, ro),
                     C.bs_dequant_ref(q, s, wire, QBLOCK), "bs_dequant main")
    rec("bs_dequant", "accl_tpu_torch/csrc/bs_codec.cu",
        "accl_tpu/ops/compression.py:382", err,
        time_ms(lambda: C.bs_dequant(q, s, wire, QBLOCK, ro)),
        time_ms(lambda: C.bs_dequant_ref(q, s, wire, QBLOCK, ro), reps=5),
        N + 4 * N // QBLOCK + 4 * N, N)

    q2 = list(torch.empty(W, c, dtype=torch.uint8, device="cuda"))
    s2 = list(torch.empty(W, nb, device="cuda"))
    C.bs_combine(q, s, rb, ReduceFunc.SUM, wire, QBLOCK, q2, s2)
    rq2, rs2 = C.bs_combine_ref(q, s, rb, ReduceFunc.SUM, wire, QBLOCK)
    err = max(check_rows(q2, rq2, "bs_combine main codes"),
              check_rows(s2, rs2, "bs_combine main scales"))
    rec("bs_combine", "accl_tpu_torch/csrc/bs_codec.cu",
        "accl_tpu/ops/compression.py:439", err,
        time_ms(lambda: C.bs_combine(q, s, rb, ReduceFunc.SUM, wire, QBLOCK,
                                     q2, s2)),
        time_ms(lambda: C.bs_combine_ref(q, s, rb, ReduceFunc.SUM, wire,
                                         QBLOCK, q2, s2), reps=5),
        2 * (N + 4 * N // QBLOCK) + 4 * N, 8 * N)
    # the ring's round-closing hop: f32 out, 9 bytes an element + scales
    check_rows(C.bs_combine(q, s, rb, ReduceFunc.SUM, wire, QBLOCK, out=ro,
                            requant=False),
               C.bs_combine_ref(q, s, rb, ReduceFunc.SUM, wire, QBLOCK,
                                requant=False), "bs_combine main f32")
    recs[-1]["variants"] = {"round-closing f32": variant(
        time_ms(lambda: C.bs_combine(q, s, rb, ReduceFunc.SUM, wire, QBLOCK,
                                     out=ro, requant=False)),
        None, 9 * N + 4 * N // QBLOCK)}
    del q, s, q2, s2, rq, rs, rq2, rs2

    h = list(torch.empty(W, c, dtype=torch.float16, device="cuda"))
    err = check_rows(C.cast(ra, torch.float16, h),
                     C.cast_ref(ra, torch.float16), "cast main")
    rec("cast", "accl_tpu_torch/csrc/wire_lanes.cu",
        "accl_tpu/ops/compression.py:65", err,
        time_ms(lambda: C.cast(ra, torch.float16, h)),
        time_ms(lambda: C.cast_ref(ra, torch.float16, h), reps=5),
        6 * N, N, library_ms=time_ms(lambda: flat_a.to(torch.float16)))
    del h
    variants = {}
    for wire in (torch.float16, torch.bfloat16, torch.float8_e4m3fn):
        low = torch.empty(W, c, dtype=wire, device="cuda")
        rl, flat_l = list(low), low.view(-1)
        nbytes = (4 + wire.itemsize) * N
        check_rows(C.cast(ra, wire, rl), C.cast_ref(ra, wire),
                   f"cast main f32->{wire}")
        check_rows(C.cast(rl, torch.float32, ro),
                   C.cast_ref(rl, torch.float32), f"cast main {wire}->f32")
        name = str(wire).split(".")[1]
        if wire != torch.float16:
            variants[f"float32->{name}"] = variant(
                time_ms(lambda: C.cast(ra, wire, rl)),     # noqa: B023
                time_ms(lambda: flat_a.to(wire)), nbytes)  # noqa: B023
        variants[f"{name}->float32"] = variant(
            time_ms(lambda: C.cast(rl, torch.float32, ro)),   # noqa: B023
            time_ms(lambda: flat_l.to(torch.float32)), nbytes)  # noqa: B023
        del low, rl, flat_l
    recs[-1]["variants"] = variants
    recs[-1]["copy_ceiling_ms"] = copy_ms
    for r in recs:
        for k, v in r.get("variants", {}).items():
            lib = v["library_ms"]
            print(f"kernel {r['name']} {k}: {v['ms']:.4f} ms ("
                  + (f"library {lib:.4f} ms, " if lib else "")
                  + f"bound {v['bound_ms']:.4f} ms, "
                  f"{v['pct_of_bound']:.1f} % of bound)")

    sc = list(torch.empty(W, 1, device="cuda"))
    iv = list(torch.empty(W, 1, device="cuda"))
    C.fp8_scale(ra, wire, sc, iv)
    rsc, riv = C.fp8_scale_ref(ra, wire)
    err = max(check_rows(sc, rsc, "fp8_scale main scales"),
              check_rows(iv, riv, "fp8_scale main inverses"))
    rec("fp8_scale", "accl_tpu_torch/csrc/wire_lanes.cu",
        "accl_tpu/ops/compression.py:149", err,
        time_ms(lambda: C.fp8_scale(ra, wire, sc, iv)),
        time_ms(lambda: C.fp8_scale_ref(ra, wire, sc, iv), reps=5),
        4 * N + 8 * W, 2 * N)

    q8 = list(torch.empty(W, c, dtype=torch.float8_e4m3fn, device="cuda"))
    err = check_rows(C.fp8_quant(ra, iv, wire, q8),
                     C.fp8_quant_ref(ra, iv, wire), "fp8_quant main")
    rec("fp8_quant", "accl_tpu_torch/csrc/wire_lanes.cu",
        "accl_tpu/ops/compression.py:154", err,
        time_ms(lambda: C.fp8_quant(ra, iv, wire, q8)),
        time_ms(lambda: C.fp8_quant_ref(ra, iv, wire, q8), reps=5),
        5 * N + 4 * W, N)

    err = check_rows(C.fp8_dequant(q8, sc, wire, ro),
                     C.fp8_dequant_ref(q8, sc, wire), "fp8_dequant main")
    rec("fp8_dequant", "accl_tpu_torch/csrc/wire_lanes.cu",
        "accl_tpu/ops/compression.py:175", err,
        time_ms(lambda: C.fp8_dequant(q8, sc, wire, ro)),
        time_ms(lambda: C.fp8_dequant_ref(q8, sc, wire, ro), reps=5),
        5 * N + 4 * W, N)
    del a, b, out, ra, rb, ro, q8, sc, iv, rsc, riv
    torch.cuda.empty_cache()
    return recs


# kernel family <- a substring of the device kernel's name (first match)
FAMILIES = (("bs_quant", "bs_quant_kernel"),
            ("bs_dequant", "bs_dequant_kernel"),
            ("bs_combine", "bs_combine_kernel"),
            ("combine", "combine_kernel"),
            ("cast", "cast_kernel"),
            ("fp8_scale", "amax_partial_kernel"),
            ("fp8_scale", "scale_finish_kernel"),
            ("fp8_quant", "fp8_quant_kernel"),
            ("fp8_dequant", "fp8_dequant_kernel"),
            ("attn_fwd_single", "attn_fwd_single_kernel"),
            # bf16 B9: its tensor-core kernel
            ("attn_fwd_single", "attn_fwd_single_wgmma_kernel"),
            ("attn_fwd", "attn_fwd_kernel"),
            # bf16 B8 and B12 prefill: the tensor-core route's one kernel
            ("attn_fwd_wgmma", "attn_fwd_wgmma_kernel"),
            ("attn_bwd_dkv", "attn_bwd_dkv_"),   # both routes' kernels
            ("attn_bwd_dq", "attn_bwd_dq_"),
            ("attn_decode", "attn_decode_kernel"),
            # single-token decode: the split-KV kernel
            ("attn_decode", "attn_decode_split_kernel"),
            ("optimizer", "multi_tensor_apply"),
            ("gemm", "gemm"), ("gemm", "gemv"), ("gemm", "nvjet"),
            ("gemm", "cutlass"), ("gemm", "xmma"),
            ("torch_reduce", "reduce_kernel"),
            ("copy", "copy"), ("copy", "Memcpy"), ("fill", "Memset"),
            ("fill", "Fill"))


def device_ms_by_family(fn, counts: dict | None = None) -> dict:
    """Device time in ms of the kernels ``fn`` runs, summed per family,
    from torch.profiler's CUDA activity; empty when it saw none. GPU-side
    user annotations (``Optimizer.step#Adam.step`` spans the optimizer's
    kernels) are ranges, not kernels, and are skipped. ``counts``, when
    given, receives the number of kernel records per family."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fams = collections.defaultdict(float)
    for ev in prof.events():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.is_user_annotation):
            continue
        fam = next((f for f, key in FAMILIES if key in ev.name), "other")
        fams[fam] += ev.time_range.elapsed_us() / 1e3
        if counts is not None:
            counts[fam] = counts.get(fam, 0) + 1
    return dict(fams)


def counters():
    from accl_tpu_torch.ops import combine
    from accl_tpu_torch.ops import compression as C
    return {"combine": combine, "bs_quant": C.bs_quant,
            "bs_dequant": C.bs_dequant, "bs_combine": C.bs_combine,
            "cast": C.cast, "fp8_scale": C.fp8_scale,
            "fp8_quant": C.fp8_quant, "fp8_dequant": C.fp8_dequant}


def golden_bound(absum, k32: int, wire=None, kw: int = 0, amax=None):
    """Per-element bound on |result - float64 golden| for a result whose
    every intermediate value is at most sum_r |x_r| (``absum``) in
    magnitude and which took ``kw`` roundings to the wire dtype and
    ``k32`` f32 roundings: ((1+u)^kw (1+2^-24)^k32 - 1) * absum, plus
    ``kw`` times the wire's denormal-range error, which for the scaled
    fp8 codec is in units of its scale (``amax`` / fp8_max, amax grown
    by the same factor)."""
    u = WIRE_U[wire] if wire else 0.0
    grow = (1 + u) ** kw * (1 + 2.0 ** -24) ** k32
    floor = 0.0
    if wire:
        unit = 1.0 if amax is None else amax * grow / FP8_MAX[wire]
        floor = kw * WIRE_DENORMAL[wire] * unit
    return (grow - 1) * absum + floor


def main_path(recs):
    import torch
    from accl_tpu_torch import cuda_world
    from accl_tpu_torch.parallel.collectives import PLAIN, RankCollectives
    from accl_tpu_torch.parallel.tree import (Tree2DCollectives,
                                              gather_rounds, scatter_rounds)
    from accl_tpu_torch.testing import run_ranks
    c = N // W
    accls = cuda_world(W)            # device="cuda": no CPU fallback
    try:
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        xs = [torch.randn(N, device="cuda", generator=g) for _ in range(W)]
        ags = [torch.randn(c, device="cuda", generator=g) for _ in range(W)]
        bufs = {}

        def setup(a):
            r = a.rank

            def dev(n):
                return a.buffer((n,), torch.float32, device_resident=True)

            bufs[r] = {
                "src": a.buffer(data=xs[r]),
                "ar": dev(N), "rs": dev(c),
                "ag_src": a.buffer(data=ags[r]), "ag": dev(N), "bs": dev(N),
                "ar_f16": dev(N), "ar_bf16": dev(N), "ar_fp8": dev(N),
                "xla_fp8": dev(N),
                "bc": (a.buffer(data=xs[r].clone(), device_resident=True)
                       if r == ROOT
                       else dev(N)),
                "rd": dev(N) if r == REDUCE_ROOT else None,
                "sc": dev(c), "ga": dev(N) if r == ROOT else None,
                "a2a": dev(N),
            }
        run_ranks(accls, setup)

        def ring_wire(key, wire):
            return lambda a, b: a.allreduce(b["src"], b[key], N,
                                            algorithm="ring",
                                            compress_dtype=wire)

        calls = {
            "allreduce": lambda a, b: a.allreduce(
                b["src"], b["ar"], N, algorithm="ring"),
            "reduce_scatter": lambda a, b: a.reduce_scatter(
                b["src"], b["rs"], c, algorithm="ring"),
            "allgather": lambda a, b: a.allgather(
                b["ag_src"], b["ag"], c, algorithm="ring"),
            "allreduce_fp8bs": lambda a, b: a.allreduce(
                b["src"], b["bs"], N, algorithm="ring",
                compress_dtype=torch.float8_e4m3fn, block_scale=QBLOCK),
            "allreduce_f16": ring_wire("ar_f16", torch.float16),
            "allreduce_bf16": ring_wire("ar_bf16", torch.bfloat16),
            "allreduce_fp8": ring_wire("ar_fp8", torch.float8_e4m3fn),
            "allreduce_xla_fp8": lambda a, b: a.allreduce(
                b["src"], b["xla_fp8"], N,
                compress_dtype=torch.float8_e4m3fn),
            "bcast_bf16": lambda a, b: a.bcast(
                b["bc"], N, root=ROOT, compress_dtype=torch.bfloat16),
            "reduce": lambda a, b: a.reduce(
                b["src"], b["rd"], N, root=REDUCE_ROOT),
            "scatter_f16": lambda a, b: a.scatter(
                b["src"] if a.rank == ROOT else None, b["sc"], c, root=ROOT,
                compress_dtype=torch.float16),
            "gather_f16": lambda a, b: a.gather(
                b["ag_src"], b["ga"], c, root=ROOT,
                compress_dtype=torch.float16),
            "alltoall_fp8": lambda a, b: a.alltoall(
                b["src"], b["a2a"], c, compress_dtype=torch.float8_e4m3fn),
        }

        def drive(name):
            run_ranks(accls, lambda a: calls[name](a, bufs[a.rank]))

        torch.cuda.synchronize()
        cnt = counters()
        for k in cnt.values():
            k.launches = 0
        for name in calls:                       # the main path, once
            drive(name)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in cnt.items()}
        print(f"main path launches: {launches}")
        for r in recs:
            r["launches"] = launches[r["name"]]
            need(r["launches"] > 0,
                 f"kernel {r['name']} was never launched on the main path")

        # -- correctness ----------------------------------------------------
        plain = RankCollectives(accls[0].device.ctx.group, kernels=PLAIN)
        plain_tree = Tree2DCollectives.fold(plain)
        out = lambda key: [bufs[r][key].tensor for r in range(W)]  # noqa
        x64 = torch.zeros(N, dtype=torch.float64, device="cuda")
        absum = torch.zeros(N, dtype=torch.float64, device="cuda")
        for x in xs:
            x64 += x.double()
            absum += x.double().abs()
        tol = W * 2.0 ** -24 * absum

        ref = plain.allreduce(xs, algorithm="ring")
        check_rows(out("ar"), list(ref), "allreduce vs plain path")
        del ref
        for t in out("ar"):
            need(bool(torch.isfinite(t).all()), "allreduce: non-finite")
            need(bool(((t.double() - x64).abs() <= tol).all()),
                 "allreduce: outside the fp32 bound of the f64 golden")

        ref = plain.reduce_scatter(xs, algorithm="ring")
        check_rows(out("rs"), list(ref), "reduce_scatter vs plain path")
        for r, t in enumerate(out("rs")):
            sl = slice(r * c, (r + 1) * c)
            need(bool(((t.double() - x64[sl]).abs() <= tol[sl]).all()),
                 "reduce_scatter: outside the fp32 bound")

        ref = plain.allgather(ags, algorithm="ring")
        check_rows(out("ag"), list(ref), "allgather vs plain path")
        gold = torch.cat(ags)
        for t in out("ag"):
            need(torch.equal(t, gold), "allgather: not the exact gather")
        del ref, gold

        ref = plain.allreduce(xs, algorithm="ring",
                              wire_dtype="float8_e4m3fn", qblock=QBLOCK)
        check_rows(out("bs"), list(ref), "fp8 allreduce vs plain path")
        del ref
        amax = float(absum.max())
        bound = FP8_BOUND_PER_QUANT * W * amax + 1e-3
        errmax = 0.0
        for t in out("bs"):
            need(bool(torch.isfinite(t).all()), "fp8 allreduce: non-finite")
            err = float((t.double() - x64).abs().max())
            need(0 < err < bound, f"fp8 allreduce: error {err} not in "
                                  f"(0, {bound}) (0: wire not quantized)")
            errmax = max(errmax, err)
        print(f"main path results: bitwise vs plain path, within golden "
              f"bounds; fp8 max err {errmax} < {bound} "
              f"(0.07*(W/4)*max sum|x| + 1e-3; the unscaled W=4 bound "
              f"would be {amax * 0.07 + 1e-3})")

        def hold(name, got, gold, bound, wired=True):
            """Every element of ``got`` within ``bound`` of ``gold`` (f64
            rows or tensors); a wired call must differ somewhere."""
            worst, err_max, ratio = 0.0, 0.0, 0.0
            for t, g64, bd in zip(got, gold, bound):
                need(bool(torch.isfinite(t).all()), f"{name}: non-finite")
                err = (t.double() - g64).abs()
                need(bool((err <= bd).all()),
                     f"{name}: outside its float64-golden bound")
                err_max = max(err_max, float(err.max()))
                ratio = max(ratio, float((err / bd.clamp_min(1e-300)).max()))
                worst = max(worst, float(bd.max()))
            need(err_max > 0 or not wired,
                 f"{name}: no error at all (the wire was not used)")
            print(f"golden {name}: max err {err_max:.6g}, bound up to "
                  f"{worst:.6g}, worst err/bound {ratio:.4f}")

        for wire in ("float16", "bfloat16", "float8_e4m3fn"):
            key = {"float16": "ar_f16", "bfloat16": "ar_bf16",
                   "float8_e4m3fn": "ar_fp8"}[wire]
            ref = plain.allreduce(xs, algorithm="ring", wire_dtype=wire)
            check_rows(out(key), list(ref), f"ring {wire} vs plain path")
            del ref
            if wire == "float8_e4m3fn":   # W-1 hops + W-1 relay requants,
                kw, k32 = 2 * W - 2, (W - 1) + 3 * (2 * W - 2)
                bd = golden_bound(absum, k32, wire, kw, amax)
            else:                         # W-1 hops + one idempotent cast
                bd = golden_bound(absum, W - 1, wire, W)
            hold(f"allreduce ring {wire}", out(key), [x64] * W, [bd] * W)

        ref = plain.allreduce(xs, algorithm="xla", wire_dtype="float8_e4m3fn")
        for t, r in zip(out("xla_fp8"), ref):
            need(torch.allclose(t, r, rtol=1e-6, atol=1e-6),
                 "xla fp8 allreduce: outside rtol=1e-6, atol=1e-6 of the "
                 "plain path")
        xla_diff = max(float((t - r).abs().max())
                       for t, r in zip(out("xla_fp8"), ref))
        del ref
        bd = golden_bound(absum, (W - 1) + 6, "float8_e4m3fn", 2, amax)
        hold("allreduce xla float8_e4m3fn", out("xla_fp8"), [x64] * W,
             [bd] * W)
        print(f"xla fp8 allreduce vs plain path: max abs diff {xla_diff}")
        del x64, tol

        ref = plain_tree.reduce(xs, REDUCE_ROOT)
        rd = bufs[REDUCE_ROOT]["rd"].tensor
        check_rows([rd], [ref[REDUCE_ROOT]], "reduce (2x4 tree) vs plain")
        del ref
        gsum = torch.zeros(N, dtype=torch.float64, device="cuda")
        for x in xs:
            gsum += x.double()
        hold("reduce tree fp32", [rd], [gsum],
             [golden_bound(absum, W - 1)], wired=False)
        del gsum, absum

        ref = plain.bcast(xs, ROOT, "bfloat16")
        bc = out("bc")
        check_rows([bc[r] for r in range(W) if r != ROOT],
                   [ref[r] for r in range(W) if r != ROOT],
                   "bcast bf16 vs plain path")
        need(torch.equal(bc[ROOT], xs[ROOT]), "bcast: root's buffer changed")
        del ref
        g64 = xs[ROOT].double()
        bd = golden_bound(g64.abs(), 0, "bfloat16", 1)
        hold("bcast bfloat16", [bc[r] for r in range(W) if r != ROOT],
             [g64] * (W - 1), [bd] * (W - 1))
        del g64, bd

        ref = plain.scatter([xs[ROOT] if r == ROOT else None
                             for r in range(W)], ROOT, "float16")
        check_rows(out("sc"), list(ref), "scatter f16 vs plain path")
        del ref
        chunks = [xs[ROOT][r * c:(r + 1) * c].double() for r in range(W)]
        need(torch.equal(out("sc")[ROOT], xs[ROOT][ROOT * c:(ROOT + 1) * c]),
             "scatter: the root's own chunk is not exact")
        hold("scatter float16", out("sc"), chunks,
             [golden_bound(ch.abs(), 0, "float16", 1) for ch in chunks])
        del chunks

        ga = bufs[ROOT]["ga"].tensor
        ref = plain.gather(ags, ROOT, "float16")
        check_rows([ga], [ref[ROOT]], "gather f16 vs plain path")
        del ref
        need(torch.equal(ga[ROOT * c:(ROOT + 1) * c], ags[ROOT]),
             "gather: the root's own chunk is not exact")
        g64 = torch.cat(ags).double()
        hold("gather float16", [ga], [g64],
             [golden_bound(g64.abs(), 0, "float16", 1)])
        del g64

        ref = plain.alltoall(xs, "float8_e4m3fn")
        check_rows(out("a2a"), list(ref), "alltoall fp8 vs plain path")
        del ref
        for r, t in enumerate(out("a2a")):
            sl = slice(r * c, (r + 1) * c)
            need(torch.equal(t[sl], xs[r][sl]),
                 "alltoall: the own chunk is not exact")
        gold = [torch.cat([xs[j][r * c:(r + 1) * c] for j in range(W)])
                .double() for r in range(W)]
        hold("alltoall float8_e4m3fn (pure cast)", out("a2a"), gold,
             [golden_bound(gd.abs(), 0, "float8_e4m3fn", 1) for gd in gold])
        del gold
        torch.cuda.empty_cache()

        # -- timing -----------------------------------------------------------
        nbq = -(-c // QBLOCK)

        def tree_bytes(rounds, b):
            return sum(len(vs) * bs for _, bs, vs in rounds) * c * b

        # logical wire bytes of one call, all ranks together
        wire_bytes = {
            "allreduce": W * 2 * (W - 1) * c * 4,
            "reduce_scatter": W * (W - 1) * c * 4,
            "allgather": W * (W - 1) * c * 4,
            "allreduce_fp8bs": W * 2 * (W - 1) * (c + 4 * nbq),
            "allreduce_f16": W * 2 * (W - 1) * c * 2,
            "allreduce_bf16": W * 2 * (W - 1) * c * 2,
            "allreduce_fp8": W * 2 * (W - 1) * (c + 4),
            "allreduce_xla_fp8": W * 2 * (W - 1) * (c + 4),
            "bcast_bf16": (W - 1) * N * 2,
            "reduce": 7 * N * 4,          # 2x4 tree: 4 outer + 3 inner
            "scatter_f16": tree_bytes(scatter_rounds(W), 2),
            "gather_f16": tree_bytes(gather_rounds(W), 2),
            "alltoall_fp8": W * (W - 1) * c,
        }
        timing = {}
        for name in calls:
            ts = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                drive(name)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            timing[name] = statistics.median(ts[1:])
            print(f"call {name}: {timing[name]:.3f} ms per call (host "
                  f"clock, median of 3 after one warm-up); "
                  f"{wire_bytes[name] // W} logical wire bytes per rank")

        # -- where the time goes ---------------------------------------------
        streams = {}
        for name in calls:
            fams = device_ms_by_family(lambda: drive(name))
            if not fams:
                print(f"device {name}: not measured (the profiler saw no "
                      f"device activity)")
                continue
            busy = sum(fams.values())
            print(f"device {name}: {busy:.3f} ms of kernels in a "
                  f"{timing[name]:.3f} ms call, idle share "
                  f"{1 - busy / timing[name]:.3f}; " + ", ".join(
                      f"{f} {ms:.3f} ms" for f, ms in sorted(fams.items())))
            streams[name] = {f: round(fams[f], 4) for f in ("combine", "cast")
                             if f in fams}
        print(f"B1 combine and B2 cast families, ms per call: {streams}")
        return timing
    finally:
        for a in accls:
            a.deinit()


# -- phase 4b: point-to-point and local ops ---------------------------------

P2P_N = 8 << 20            # host-mirror sendrecv and the streamed variants
# the block-scaled codec's bound per element (accl_tpu/quant.py's error
# model): half an e4m3 step at the block's scale, amax * 2^-4 / (1 - 2^-4)
BS_BOUND_PER_AMAX = 2.0 ** -4 / (1 - 2.0 ** -4)
# B1, B2, B5 and B6: the kernels the p2p path must launch
P2P_KERNELS = ("combine", "cast", "bs_quant", "bs_dequant")


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 -> float32, round to nearest even (finite
    values, whose bits plus 0x8000 stay below 2^32; numpy has no
    bfloat16)."""
    b = x.view(np.uint32)
    return ((b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1)))
            & np.uint32(0xFFFF0000)).view(np.float32)


def hold_exchange(ctx, cid: int, k: int, timeout: float = 60.0):
    """Keep the exchange of communicator ``cid`` busy, as a running batch
    does, until ``k`` transfers wait in its window; they then ride the
    next batch together. Returns the thread that frees it."""
    with ctx._lock:
        ctx._xchg_running.add(cid)

    def free():
        end = time.monotonic() + timeout
        with ctx._lock:
            while (len(ctx._xchg_pending[cid]) < k
                   and time.monotonic() < end):
                ctx._lock.wait(0.01)
            ctx._xchg_running.discard(cid)
            ctx._lock.notify_all()

    th = threading.Thread(target=free, daemon=True)
    th.start()
    return th


def p2p_path(recs):
    """Phase 4b: send/recv, copy, combine and the stream ports through
    ``ACCL`` on ``cuda_world(8)``, device-resident buffers of 64 Mi fp32
    a rank. Every result is held bitwise against the same work through
    the plain versions (``PLAIN``) and against a numpy golden; B1, B2, B5
    and B6 must launch; with the exchange held busy until every transfer
    waits, the ring shift takes one exchange round, the conflicting set
    two. Then each call's host time (the library's own, slowest rank),
    device time by family, idle share, logical wire bytes a rank and
    launches."""
    import torch
    from accl_tpu_torch import StreamFlags, cuda_world
    from accl_tpu_torch.constants import ReduceFunc
    from accl_tpu_torch.parallel.collectives import PLAIN
    from accl_tpu_torch.testing import run_ranks
    wire8 = "float8_e4m3fn"
    accls = cuda_world(W)            # device="cuda": no CPU fallback
    ctx = accls[0].device.ctx
    try:
        g = torch.Generator(device="cuda").manual_seed(SEED + 2)
        xs = [torch.randn(N, device="cuda", generator=g) for _ in range(W)]
        ys = [torch.randn(N, device="cuda", generator=g) for _ in range(W)]
        hosts = [x[:P2P_N].cpu() for x in xs]
        bufs = {}

        def setup(a):
            r = a.rank

            def dev(n=N, dtype=torch.float32):
                return a.buffer((n,), dtype, device_resident=True)

            def res(x):
                return a.buffer(data=x, device_resident=True)

            bufs[r] = {
                "src": res(xs[r]), "y": res(ys[r]),
                "src16": res(xs[r].bfloat16()), "y16": res(ys[r].bfloat16()),
                "hsrc": a.buffer(data=hosts[r].clone()),
                "hdst": a.buffer((P2P_N,), torch.float32),
                "fp32": dev(), "float16": dev(), "bfloat16": dev(),
                wire8: dev(), "cf1": dev(), "cf2": dev(), "copy": dev(),
                "sum": dev(), "max": dev(), "sum16": dev(N, torch.bfloat16),
                "max16": dev(N, torch.bfloat16),
                "s_copy": dev(P2P_N), "s_comb": dev(P2P_N),
                "s_put": dev(P2P_N), "s_pop": None,
            }
        run_ranks(accls, setup)

        def ring(key, tag, **kw):
            def fn(a, b):
                r = a.rank
                src = b["hsrc"] if key == "hdst" else b["src"]
                n = src.size
                hs = a.send(src, n, dst=(r + 1) % W, tag=tag, run_async=True,
                            **kw)
                hr = a.recv(b[key], n, src=(r - 1) % W, tag=tag,
                            run_async=True, **kw)
                hs.wait()
                hr.wait()
            return fn

        def conflicting(a, b):
            """Ranks 0-3 send twice, to r+4 and to (r+1) % 4: 8 transfers,
            every source twice, every destination once."""
            r = a.rank
            hs = ([a.send(b["src"], N, dst=(r + 4), tag=20, run_async=True),
                   a.send(b["src"], N, dst=(r + 1) % 4, tag=21,
                          run_async=True)] if r < 4 else [])
            hr = (a.recv(b["cf1"], N, src=r - 4, tag=20, run_async=True)
                  if r >= 4 else
                  a.recv(b["cf2"], N, src=(r - 1) % 4, tag=21,
                         run_async=True))
            for h in hs + [hr]:
                h.wait()

        def combine_call(func, key, dt=""):
            return lambda a, b: a.combine(N, func, b["src" + dt],
                                          b["y" + dt], b[key])

        def streamed_local(a, b):
            a.stream_push(xs[a.rank][:P2P_N])
            a.copy(None, b["s_copy"], P2P_N,
                   stream_flags=StreamFlags.OP0_STREAM)
            a.stream_push(xs[a.rank][:P2P_N])
            a.combine(P2P_N, ReduceFunc.SUM, None, b["y"], b["s_comb"],
                      stream_flags=StreamFlags.OP0_STREAM)

        def streamed_p2p(a, b):
            r = a.rank
            hs = a.send(b["src"], P2P_N, dst=(r + 1) % W, tag=30,
                        run_async=True)
            a.recv(None, P2P_N, src=(r - 1) % W, tag=30,
                   stream_flags=StreamFlags.RES_STREAM)
            hs.wait()
            b["s_pop"] = a.stream_pop(30.0)
            a.stream_put(b["src"], P2P_N, dst=(r + 1) % W)
            a.copy(None, b["s_put"], P2P_N,
                   stream_flags=StreamFlags.OP0_STREAM)

        calls = {
            "sendrecv_fp32": ring("fp32", 1),
            "sendrecv_f16": ring("float16", 2, compress_dtype=torch.float16),
            "sendrecv_bf16": ring("bfloat16", 3,
                                  compress_dtype=torch.bfloat16),
            "sendrecv_fp8bs": ring(wire8, 4,
                                   compress_dtype=torch.float8_e4m3fn,
                                   block_scale=QBLOCK),
            "sendrecv_conflicting": conflicting,
            "sendrecv_host_8Mi": ring("hdst", 5),
            "copy": lambda a, b: a.copy(b["src"], b["copy"], N),
            "combine_sum_f32": combine_call(ReduceFunc.SUM, "sum"),
            "combine_max_f32": combine_call(ReduceFunc.MAX, "max"),
            "combine_sum_bf16": combine_call(ReduceFunc.SUM, "sum16", "16"),
            "combine_max_bf16": combine_call(ReduceFunc.MAX, "max16", "16"),
            "streamed_copy_combine_8Mi": streamed_local,
            "streamed_recv_pop_put_8Mi": streamed_p2p,
        }
        # exchange rounds with the window held until every transfer of
        # the call waits (one batch), and the transfers of a call
        want_rounds = {"sendrecv_fp32": 1, "sendrecv_f16": 1,
                       "sendrecv_bf16": 1, "sendrecv_fp8bs": 1,
                       "sendrecv_conflicting": 2, "sendrecv_host_8Mi": 1}
        transfers = {"streamed_recv_pop_put_8Mi": 2 * W,
                     **{name: W for name in want_rounds}}
        lib = {}

        def drive(name, hold=False):
            """One call on every rank: (exchange rounds, logical wire bytes
            a rank) it took; the slowest rank's seconds inside the library
            land in ``lib[name]``. ``hold`` keeps the exchange busy, as a
            running batch does, until every transfer of the call waits."""
            def fn(a):
                t0 = time.perf_counter()
                calls[name](a, bufs[a.rank])
                return time.perf_counter() - t0
            r0, b0 = ctx.exchange_rounds, ctx.exchange_bytes
            freer = (hold_exchange(ctx, accls[0].comm.comm_id,
                                   transfers[name]) if hold else None)
            lib[name] = max(run_ranks(accls, fn))
            if freer is not None:
                freer.join()
            return ctx.exchange_rounds - r0, (ctx.exchange_bytes - b0) // W

        for name in calls:                 # warm-up: the allocator's blocks
            drive(name)
        torch.cuda.synchronize()
        cnt = counters()
        for k in cnt.values():
            k.launches = 0
        rounds, wire = {}, {}
        for name in calls:                 # the p2p path, once
            rounds[name], wire[name] = drive(name)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in cnt.items()}
        print(f"p2p path launches: {launches}")
        print(f"p2p exchange rounds (batches as the transfers arrived): "
              f"{rounds}")
        for name, n in transfers.items():
            need(1 <= rounds[name] <= n,
                 f"{name}: {rounds[name]} exchange rounds for {n} transfers")
        held = {name: drive(name, hold=True)[0] for name in want_rounds}
        print(f"p2p exchange rounds, the window held until every transfer "
              f"waits: {held}")
        for name, n in want_rounds.items():
            need(held[name] == n,
                 f"{name}: {held[name]} exchange rounds held, expected {n}")
        for k in P2P_KERNELS:
            need(launches[k] > 0, f"kernel {k} never launched on the p2p path")
        for r in recs:
            if r["name"] in launches:
                r["launches_by_path"] = {"collectives": r["launches"],
                                         "p2p": launches[r["name"]]}

        # -- correctness: the plain versions on the card -------------------
        def t(key, r):
            return bufs[r][key].tensor

        for r in range(W):
            s = (r - 1) % W
            for wire_name in ("float16", "bfloat16"):
                wd = getattr(torch, wire_name)
                check_rows([t(wire_name, r)],
                           PLAIN.cast(PLAIN.cast([xs[s]], wd), torch.float32),
                           f"sendrecv {wire_name} vs plain")
            q, sc = PLAIN.bs_quant([xs[s]], wire8, QBLOCK)
            check_rows([t(wire8, r)], PLAIN.bs_dequant(q, sc, wire8, QBLOCK),
                       "sendrecv fp8 block 128 vs plain")
            del q, sc
            for key, func, dt in (("sum", ReduceFunc.SUM, ""),
                                  ("max", ReduceFunc.MAX, ""),
                                  ("sum16", ReduceFunc.SUM, "16"),
                                  ("max16", ReduceFunc.MAX, "16")):
                check_rows([t(key, r)], [PLAIN.combine(
                    t("src" + dt, r), t("y" + dt, r), func)],
                    f"combine {key} vs plain")
            check_rows([t("s_comb", r)], [PLAIN.combine(
                xs[r][:P2P_N], ys[r][:P2P_N], ReduceFunc.SUM)],
                "combine from stream vs plain")
        torch.cuda.empty_cache()

        # -- correctness: a numpy golden, one host thread a rank -----------
        def golden(r):
            """fp32, copy and the streams are the inputs themselves
            (checked on the card, below); the rest against numpy."""
            s = (r - 1) % W

            def got(key):
                x = t(key, r)
                if x.dtype == torch.bfloat16:     # widened on the host
                    u = x.view(torch.int16).cpu().numpy().view(np.uint16)
                    return (u.astype(np.uint32) << 16).view(np.float32)
                return x.cpu().numpy()

            gx = xs[s].cpu().numpy()
            need(np.array_equal(got("float16"),
                                gx.astype(np.float16).astype(np.float32)),
                 "sendrecv f16: not numpy's round trip")
            need(np.array_equal(got("bfloat16"), bf16_round(gx)),
                 "sendrecv bf16: not the bf16 round trip")
            amax = np.abs(gx).reshape(-1, QBLOCK).max(axis=1)
            bound = (amax * BS_BOUND_PER_AMAX)[:, None]
            err = np.abs(got(wire8) - gx).reshape(-1, QBLOCK)
            need(bool(np.isfinite(err).all() and (err <= bound).all()),
                 "sendrecv fp8 block 128: outside the codec's bound")
            need(float(err.max()) > 0, "sendrecv fp8: the wire was exact")
            ratio = float((err / np.maximum(bound, 1e-30)).max())
            del gx, err
            mine, y = xs[r].cpu().numpy(), ys[r].cpu().numpy()
            need(np.array_equal(got("sum"), mine + y), "combine sum f32")
            need(np.array_equal(got("max"), np.maximum(mine, y)),
                 "combine max f32")
            need(np.array_equal(got("s_comb"),
                                mine[:P2P_N] + y[:P2P_N]),
                 "combine from stream: not numpy's")
            del mine, y
            a16, b16 = got("src16"), got("y16")
            need(np.array_equal(got("sum16"), bf16_round(a16 + b16)),
                 "combine sum bf16: not the rounded f32 sum")
            need(np.array_equal(got("max16"), np.maximum(a16, b16)),
                 "combine max bf16")
            need(np.array_equal(bufs[r]["hdst"].storage.numpy(),
                                hosts[s].numpy()),
                 "host-mirror sendrecv: not exact")
            return ratio

        with concurrent.futures.ThreadPoolExecutor(W) as pool:
            ratios = list(pool.map(golden, range(W)))
        for r in range(W):
            s = (r - 1) % W
            for got, want, what in (
                    (t("fp32", r), xs[s], "sendrecv fp32"),
                    (t("copy", r), xs[r], "copy"),
                    (t("s_copy", r), xs[r][:P2P_N], "copy from stream"),
                    (bufs[r]["s_pop"], xs[s][:P2P_N], "recv to stream"),
                    (t("s_put", r), xs[s][:P2P_N], "stream_put"),
                    (t("cf1" if r >= 4 else "cf2", r),
                     xs[r - 4 if r >= 4 else (r - 1) % 4],
                     "the conflicting set")):
                need(torch.equal(got, want), f"{what}: not exact")
        print(f"p2p path results: bitwise vs the plain versions; fp32, "
              f"copy and the streams exact; against numpy: the f16 and bf16 "
              f"round trips and combine exact, fp8-e4m3 block {QBLOCK} "
              f"worst err/bound {max(ratios):.4f} (bound amax(block) * 2^-4 "
              f"/ (1 - 2^-4) per element); checks done at "
              f"{time.perf_counter() - T_START:.1f} s")

        # -- timing and where the time goes -------------------------------
        for name in calls:
            ts, libs = [], []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                drive(name)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
                libs.append(lib[name] * 1e3)
            ms = statistics.median(ts[1:])
            lib_ms = statistics.median(libs[1:])
            msgs = {"sendrecv_conflicting": 8}.get(name, W)
            line = (f"call {name}: {ms:.3f} ms per call (host clock, median "
                    f"of 3 after one warm-up, {msgs} messages or local calls "
                    f"over the 8 ranks; {lib_ms:.3f} ms of it inside the "
                    f"library, slowest rank); {wire[name]} logical wire "
                    f"bytes per rank; exchange rounds {rounds[name]}")
            for k in cnt.values():
                k.launches = 0
            seen = {}
            fams = device_ms_by_family(lambda: drive(name),   # noqa: B023
                                       seen)
            per = {k: f.launches for k, f in cnt.items() if f.launches}
            print(line)
            # the same call enqueued behind a GPU sleep: the events time
            # its kernels back to back (a call that waits for the host,
            # as the host-mirror ring does, still shows its gaps)
            torch.cuda.synchronize()
            torch.cuda._sleep(CALL_HEAD_START_CYCLES)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            drive(name)
            host = (time.perf_counter() - t0) * 1e3
            e1.record()
            torch.cuda.synchronize()
            dev = e0.elapsed_time(e1)
            print(f"device {name}: {dev:.3f} ms of device work behind a GPU "
                  f"sleep ({dev / msgs:.4f} ms a message; the host enqueued "
                  f"it in {host:.1f} ms), idle share {1 - dev / ms:.3f} of "
                  f"the call, {1 - dev / lib_ms:.3f} of the library's time; "
                  f"launches {per or 'none'}")
            if not fams:
                print(f"device {name} by family: not measured (the profiler "
                      f"saw no device activity)")
                continue
            busy = sum(fams.values())
            print(f"device {name} by family (torch.profiler): {busy:.3f} ms "
                  f"in {sum(seen.values())} kernel records: " + ", ".join(
                      f"{f} {v:.3f} ms ({seen[f]})"
                      for f, v in sorted(fams.items())))
    finally:
        for a in accls:
            a.deinit()


# -- attention and the Llama serving path ----------------------------------

ATTN_SRC = "accl_tpu_torch/csrc/attention.cu"              # CUDA cores
ATTN_SM90_SRC = "accl_tpu_torch/csrc/attention_sm90.cu"  # bf16 B8, B9, prefill
ATTN_DECODE_SRC = "accl_tpu_torch/csrc/attention_decode.cu"  # S_new == 1
# one attention tolerance, stated once and held element by element:
# f32 |got - plain| <= 2e-5 + 2e-5 * |plain| (one f32 softmax summed in
# another order); bf16 <= 2^-7 * |plain| + 2^-7 * median |plain|: one
# bf16 ulp of each element (both round an f32 value, which may sit on
# either side of a rounding boundary), with a floor of one ulp of the
# typical output for elements near zero; the LSE is f32 always
F32_RTOL = F32_ATOL = 2e-5
BF16_REL = 2.0 ** -7
ATTN_TOL = ("f32 2e-5 + 2e-5*|plain|; bf16 2^-7*|plain| + "
            "2^-7*median|plain|, per element")
# the forward's bf16 tensor-core route (B8, B9, B12 with S_new > 1) rounds P
# to bf16 (8 significant bits) as the first operand of P V, which moves
# each term p*v by less than 2^-8 of its magnitude, so an output moves by
# less than 2^-8 * m, m = sum_j p_ij |v_j| / l_i
# (``fwd_rounding_magnitudes``), on top of the bf16 output limit; its
# LSE keeps the f32 limit
FWD_BF16_MARGIN = 2.0 ** -8
FWD_TOL = ("bf16 tensor-core route 2^-8*m + 2^-7*|plain| + "
           "2^-7*median|plain|, m the magnitude of the rounded sum P V; "
           "LSE 2e-5 + 2e-5*|lse|; per element")
KEY_TILE = 64               # csrc/attention.cu BK
# flash against dense, f32, 4 layers: the two attentions sum in other
# orders (about 1e-7 relative per output), amplified through 4 layers and
# the lm_head's 4096-term products: max |diff| <= 1e-4 * max |logit|
MODEL_F32_RTOL = 1e-4
# serving prefill, bf16, forward_cached (B12) against forward (B8): both
# run 64-row query tiles over the same 64-key tiles in the same order, so
# their f32 results agree but for rare roundings that 32 bf16 layers may
# carry: max |diff| <= one bf16 ulp of the logit scale (2^-7 * max|logit|)
# and the greedy token the same at 99 % of the positions
SERVE_BF16_RTOL = 2.0 ** -7
SERVE_MIN_AGREE = 0.99
# serving, bf16, 32 layers, flash (the kernels) against dense (the plain
# path) on the same weights: dense rounds its probabilities to bf16
# before the PV product (2^-9 relative per term), flash keeps them f32;
# that difference, about 2^-9 of each attention output, reaches the
# logits through 32 residual layers as a random walk (sqrt(32) * 2^-9 =
# 0.011 relative). A wiring fault (a head, a cache row, a rope position)
# moves the logits by O(1) relative. Limit: ||flash - dense|| <= 2^-4 *
# ||dense|| (Frobenius norms over all logits)
SERVE_DENSE_REL = 2.0 ** -4
# the path each attention record's ``launches`` is read from: serving
# runs B9 in its forward on the prompts' first 512 tokens (one key block)
SERVE_B9_LEN = 512
LAUNCH_PATH = {"attn_fwd": "serving", "attn_fwd_single": "serving",
               "attn_decode": "serving", "attn_prefill": "serving",
               "attn_bwd_dkv": "training", "attn_bwd_dq": "training"}


def attention_counters() -> dict:
    from accl_tpu_torch.ops import attention as A
    return {"attn_fwd": A.fwd_launches,
            "attn_fwd_single": A.fwd_single_launches,
            "attn_bwd_dkv": A.bwd_dkv_launches,
            "attn_bwd_dq": A.bwd_dq_launches,
            "attn_decode": A.decode_launches,
            "attn_prefill": A.prefill_launches,
            "attn_fwd_wgmma": A.fwd_wgmma_launches,
            "attn_fwd_single_wgmma": A.fwd_single_wgmma_launches,
            "attn_prefill_wgmma": A.prefill_wgmma_launches,
            "attn_decode_split": A.decode_split_launches}


def zero_attention_counters():
    from accl_tpu_torch.ops import attention as A
    A.fwd_launches = A.fwd_single_launches = 0
    A.bwd_dkv_launches = A.bwd_dq_launches = 0
    A.decode_launches = A.prefill_launches = 0
    A.fwd_wgmma_launches = A.prefill_wgmma_launches = 0
    A.fwd_single_wgmma_launches = A.decode_split_launches = 0


def need_routes(launches: dict, bf16: bool, what: str):
    """Every B8, B9 and B12 prefill launch of a path took the tensor-core
    route when the path runs bf16, none when it runs f32; every
    single-token decode launch took the split-KV kernel (both dtypes)."""
    from accl_tpu_torch.ops import attention as A
    keys = ("attn_fwd", "attn_fwd_single", "attn_prefill")
    for key in keys:
        want = launches[key] if bf16 else 0
        need(launches[key + "_wgmma"] == want,
             f"{what}: {launches[key + '_wgmma']} of {launches[key]} "
             f"{key} launches on the tensor-core route, want {want}")
    need(launches["attn_decode_split"] == launches["attn_decode"],
         f"{what}: {launches['attn_decode_split']} of "
         f"{launches['attn_decode']} decode launches on the split-KV route")
    print(f"{what} routes: " + ", ".join(
        f"{k} {launches[k + '_wgmma']} of {launches[k]}" for k in keys)
        + f" launches on the tensor-core route ({ATTN_SM90_SRC}), the rest "
        f"on the CUDA cores ({ATTN_SRC}); attn_decode "
        f"{launches['attn_decode_split']} of {launches['attn_decode']} on "
        f"the split-KV kernel ({ATTN_DECODE_SRC}"
        + (f", n_split {A.last_decode_splits} at the last"
           if launches["attn_decode"] else "") + ")")


def attn_limit(plain, mag=None):
    """Per-element limit of |kernel - plain| (see ATTN_TOL); ``mag``, the
    magnitude of the rounded P V, selects the bf16 tensor-core route's
    (FWD_TOL)."""
    import torch
    p = plain.float().abs()
    if plain.dtype == torch.bfloat16:
        lim = BF16_REL * p + BF16_REL * float(p.median())
        return lim if mag is None else lim + FWD_BF16_MARGIN * mag
    return F32_ATOL + F32_RTOL * p


def fwd_route_mag(kind: str, args, kwargs=None):
    """For a bf16 call of B8, B9 or B12 with S_new > 1 (the tensor-core
    route), the magnitudes its limit takes (``fwd_rounding_magnitudes``);
    None for every other call. ``kind`` "fwd": args as
    ``flash_attention_fwd``'s; "decode": as ``flash_decode``'s."""
    import torch
    from accl_tpu_torch.ops import attention as A
    kwargs = kwargs or {}
    q = args[0]
    if q.dtype != torch.bfloat16:
        return None
    if kind == "fwd":
        k, v = args[1], args[2]
        causal = args[3] if len(args) > 3 else kwargs.get("causal", True)
        scale = args[4] if len(args) > 4 else kwargs.get("sm_scale")
        return A.fwd_rounding_magnitudes(q, k, v, causal, scale)
    kv_len = args[3] if len(args) > 3 else kwargs["kv_len"]
    if q.shape[2] == 1:
        return None                            # decode: split-KV, f32
    k, v = A.cache_prefix(args[1], args[2], kv_len)
    return A.fwd_rounding_magnitudes(q, k, v, True, kwargs.get("sm_scale"),
                                     kv_len - q.shape[2])


def hold_attn(got, plain, what: str, lse=None, plain_lse=None,
              mag=None) -> tuple[float, float]:
    """Kernel output within the stated tolerance of its plain version,
    element by element; returns (max abs error, largest ratio of an
    error to its element's limit), over O and, where given, the LSE.
    ``mag`` (see ``fwd_route_mag``) selects the tensor-core route's
    limit."""
    import torch
    need(got.shape == plain.shape and got.dtype == plain.dtype,
         f"{what}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
         f"{tuple(plain.shape)} {plain.dtype}")
    need(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    d = (got.float() - plain.float()).abs()
    ratio = float((d / attn_limit(plain, mag)).max())
    err = float(d.max())
    need(ratio <= 1.0, f"{what}: max abs err {err}, {ratio:.3g} times "
         f"its element's limit ({ATTN_TOL if mag is None else FWD_TOL})")
    if lse is not None:
        dl = (lse - plain_lse).abs()
        r = float((dl / (F32_ATOL + F32_RTOL * plain_lse.abs())).max())
        need(r <= 1.0, f"{what}: LSE max abs err {float(dl.max())}")
        err, ratio = max(err, float(dl.max())), max(ratio, r)
    return err, ratio


def attn_work(B, H, Hkv, Sq, Skv, D, esize, s_new=None):
    """(bytes, operations) causal attention needs: q, k, v read once (for
    decode only the kv_len prefix of the cache), O (and the f32 LSE of the
    forward) written once; 4*D operations per score entry a query sees."""
    if s_new is None:              # forward: query i sees keys 0..i
        n = min(Sq, Skv)
        seen = n * (n + 1) // 2 + (Sq - n) * Skv
        nbytes = (2 * B * H * Sq * D + 2 * B * Hkv * Skv * D) * esize \
            + 4 * B * H * Sq
    else:                          # decode: kv_len = Skv, s_new new rows
        seen = s_new * (Skv - s_new) + s_new * (s_new + 1) // 2
        nbytes = (2 * B * H * s_new * D + 2 * B * Hkv * Skv * D) * esize
    return nbytes, 4 * D * B * H * seen


def attn_source(kind: str, dtype, s_new: int = 0) -> str:
    """The source of the kernel a call of ``kind`` ("fwd" for B8 and B9,
    "decode" for B12) runs in ``dtype`` with ``s_new`` new tokens."""
    import torch
    if kind == "decode" and s_new == 1:
        return ATTN_DECODE_SRC
    return ATTN_SM90_SRC if dtype == torch.bfloat16 else ATTN_SRC


def attention_edges(rng):
    """The CPU tests' shapes, single-block B9 cases and the decode and
    chunked-prefill edge cases, f32 and bf16 (bf16 B8, B9 and B12 chunks
    on the tensor-core route, under FWD_TOL; single-token decode on the
    split-KV kernel)."""
    import torch
    from accl_tpu_torch.ops import attention as A
    fwd_cases = [  # B, H, Hkv, Sq, Skv, D, causal, block_k
        (1, 2, 2, 64, 64, 16, True, None), (1, 2, 2, 130, 130, 32, False, None),
        (1, 4, 2, 96, 96, 16, True, 32), (2, 4, 1, 96, 96, 16, False, None),
        (1, 4, 2, 40, 96, 16, True, 32), (2, 8, 2, 300, 300, 64, True, None),
        (1, 8, 1, 513, 513, 128, False, None)]
    # one key block (B9): Skv 40, 128, 130 (block_k 256), 256, 512 and
    # 2048 (block_k 2048); MHA/GQA/MQA, causal and not, Sq != Skv
    single_cases = [
        (1, 4, 4, 40, 40, 64, True, None), (2, 4, 2, 128, 128, 128, True, None),
        (1, 8, 1, 130, 130, 32, False, 256),
        (1, 8, 2, 256, 256, 16, True, None),
        (2, 4, 4, 512, 512, 128, True, None),
        (1, 4, 1, 512, 512, 64, False, None),
        (1, 4, 2, 96, 40, 128, True, None), (1, 4, 2, 40, 256, 32, True, None),
        (1, 4, 2, 200, 512, 64, False, None),
        (1, 2, 1, 64, 2048, 128, False, 2048),
        (1, 4, 2, 2048, 2048, 64, True, 2048)]
    T = 3 * KEY_TILE + 8
    # (S_new, kv_len, D, generator): decode and chunks of new tokens, the
    # whole prefill (kv_len = S_new) and after a filled prefix (kv_len >
    # S_new). The chunks of 64 and 65 and the other head dims draw from a
    # generator of their own, so that the phases after this one see the
    # inputs they saw before these cases were added.
    more = np.random.default_rng(SEED + 13)
    dec_cases = [(s, n, 32, rng) for s in (1, 3)
                 for n in (s, KEY_TILE - 1, KEY_TILE, KEY_TILE + 1, T)]
    dec_cases += [(s, n, d, more) for d in (16, 64, 128) for s, n in (
        (3, 3), (3, KEY_TILE + 1), (KEY_TILE, KEY_TILE), (KEY_TILE, T),
        (KEY_TILE + 1, KEY_TILE + 1), (KEY_TILE + 1, 2 * KEY_TILE + 3))]
    # single-token decode through the split-KV kernel: NaN past kv_len,
    # kv_len 1, 63, 64, 65 and T at D 16-128, MHA/GQA/MQA (groups 1, 2, 4,
    # 8), and a long cache whose 64 slices outnumber the filled tiles
    # (B, H, Hkv, T, kv_len, D)
    split_cases = [(2, 8, 2, T, n, d) for d in (16, 64, 128)
                   for n in (1, KEY_TILE - 1, KEY_TILE, KEY_TILE + 1, T)]
    split_cases += [(1, 4, 4, T, 65, 32), (2, 6, 3, T, T, 64),
                    (1, 8, 1, T, 130, 128), (1, 8, 2, 4096, 1, 128),
                    (1, 8, 2, 4096, 100, 128), (1, 8, 2, 4096, 4000, 64),
                    (1, 8, 2, 4096, 4096, 128)]
    split_rng = np.random.default_rng(SEED + 14)
    worst = {}              # route -> (max abs err, largest error/limit)
    splits = set()
    for dt in (torch.float32, torch.bfloat16):
        for B, H, Hkv, Sq, Skv, D, causal, bk in fwd_cases:
            q = torch.from_numpy(rng.standard_normal((B, H, Sq, D))).to(
                "cuda", dt)
            k, v = (torch.from_numpy(rng.standard_normal(
                (B, Hkv, Skv, D))).to("cuda", dt) for _ in range(2))
            o, lse = A.flash_attention_fwd(q, k, v, causal, block_k=bk)
            ro, rl = A.flash_attention_ref(q, k, v, causal)
            mag = fwd_route_mag("fwd", (q, k, v, causal, None, None, bk))
            route = "tensor cores" if mag is not None else "CUDA cores"
            worst[route] = max_pair(worst.get(route, (0.0, 0.0)), hold_attn(
                o, ro, f"attn fwd {dt} {(B, H, Hkv, Sq, Skv, D, causal, bk)}",
                lse, rl, mag))
        for B, H, Hkv, Sq, Skv, D, causal, bk in single_cases:
            need(A.is_single_block(Skv, bk), f"B9 case {Skv}/{bk}: not one "
                 f"key block")
            q = torch.from_numpy(split_rng.standard_normal(
                (B, H, Sq, D))).to("cuda", dt)
            k, v = (torch.from_numpy(split_rng.standard_normal(
                (B, Hkv, Skv, D))).to("cuda", dt) for _ in range(2))
            before = A.fwd_single_launches
            o, lse = A.flash_attention_fwd(q, k, v, causal, block_k=bk)
            need(A.fwd_single_launches == before + 1, "B9 case: not B9")
            ro, rl = A.flash_attention_ref(q, k, v, causal)
            mag = fwd_route_mag("fwd", (q, k, v, causal, None, None, bk))
            route = ("B9 tensor cores" if mag is not None
                     else "B9 CUDA cores")
            worst[route] = max_pair(worst.get(route, (0.0, 0.0)), hold_attn(
                o, ro, f"attn B9 {dt} {(B, H, Hkv, Sq, Skv, D, causal, bk)}",
                lse, rl, mag))
        for B, H, Hkv, Tc, kv_len, D in split_cases:
            q = torch.from_numpy(split_rng.standard_normal(
                (B, H, 1, D))).to("cuda", dt)
            kc, vc = (torch.from_numpy(split_rng.standard_normal(
                (B, Tc, Hkv, D))).to("cuda", dt) for _ in range(2))
            kc[:, kv_len:] = float("nan")
            vc[:, kv_len:] = float("nan")
            before = A.decode_split_launches
            o = A.flash_decode(q, kc, vc, kv_len)
            need(A.decode_split_launches == before + 1, "decode: not split")
            n = A.last_decode_splits
            filled = sum(hi > lo for lo, hi in A.decode_split_ranges(kv_len, n))
            splits.add((n, filled))
            worst["split-KV"] = max_pair(worst.get("split-KV", (0.0, 0.0)),
                                         hold_attn(
                o, A.flash_decode_ref(q, kc, vc, kv_len),
                f"attn decode {dt} {(B, H, Hkv, Tc, kv_len, D)} n_split {n}"))
        for s_new, kv_len, D, gen in dec_cases:
            q = torch.from_numpy(gen.standard_normal(
                (2, 8, s_new, D))).to("cuda", dt)
            kc, vc = (torch.from_numpy(gen.standard_normal(
                (2, T, 2, D))).to("cuda", dt) for _ in range(2))
            kc[:, kv_len:] = float("nan")
            vc[:, kv_len:] = float("nan")
            mag = fwd_route_mag("decode", (q, kc, vc, kv_len))
            route = ("tensor cores" if mag is not None else
                     "split-KV" if s_new == 1 else "CUDA cores")
            worst[route] = max_pair(worst.get(route, (0.0, 0.0)), hold_attn(
                A.flash_decode(q, kc, vc, kv_len),
                A.flash_decode_ref(q, kc, vc, kv_len),
                f"attn decode {dt} s_new={s_new} kv_len={kv_len} D={D}",
                mag=mag))
    print(f"attention edges: {2 * len(fwd_cases)} forward cases (B8 and "
          f"B9, MHA/GQA/MQA, ragged, straddling blocks, Sq != Skv), "
          f"{2 * len(single_cases)} single-block B9 cases (Skv 40-2048, "
          f"MHA/GQA/MQA, causal and not, Sq != Skv), "
          f"{2 * len(dec_cases)} decode and chunked-prefill cases (NaN past "
          f"kv_len, S_new 1/3/64/65, kv_len = S_new and past it, D 16-128) "
          f"and {2 * len(split_cases)} single-token decode cases on the "
          f"split-KV kernel (NaN past kv_len, kv_len 1 to T, groups 1-8, D "
          f"16-128; (n_split, filled slices) {sorted(splits)}) within "
          f"tolerance")
    for route, (err, ratio) in sorted(worst.items()):
        print(f"  {route}: max abs err {err}, largest error/limit "
              f"{ratio:.3f} ({FWD_TOL if 'tensor' in route else ATTN_TOL})")


def max_pair(a, b):
    """Element-wise max of two (max abs error, error/limit) pairs."""
    return max(a[0], b[0]), max(a[1], b[1])


def attention_records():
    """B8, B9 and B12 at the full-width shapes, bf16 (the table's rows)
    and f32 (checked and printed), against their plain versions and
    PyTorch's SDPA, timed. B9 at S=128 (printed) and at the serving
    path's S=512 (the record)."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    H, Hkv, D = 32, 8, 128          # Llama-3-8B attention geometry
    recs = []
    shapes = [  # name, replaces, B, Sq/S_new, Skv/kv_len, T (decode)
        ("attn_fwd", "accl_tpu/ops/attention.py:285", 4, 2048, 2048, None),
        ("attn_fwd_single", "accl_tpu/ops/attention.py:252", 4, 128, 128,
         None),
        ("attn_fwd_single", "accl_tpu/ops/attention.py:252", 4,
         SERVE_B9_LEN, SERVE_B9_LEN, None),
        ("attn_decode", "accl_tpu/ops/attention.py:689", 4, 1, 2047, 4096),
        ("attn_prefill", "accl_tpu/ops/attention.py:689", 4, 1024, 1024,
         1024)]
    for name, replaces, B, sq, skv, T in shapes:
        for dt in (torch.bfloat16, torch.float32):
            q = torch.randn(B, H, sq, D, device="cuda", generator=g).to(dt)
            if T is None:
                k = torch.randn(B, Hkv, skv, D, device="cuda",
                                generator=g).to(dt)
                v = torch.randn_like(k)
                o, lse = A.flash_attention_fwd(q, k, v, True)
                ref, rl = A.flash_attention_ref(q, k, v, True)
                mag = fwd_route_mag("fwd", (q, k, v, True))
                err, ratio = hold_attn(o, ref, f"{name} {dt}", lse, rl, mag)
                kern = lambda: A.flash_attention_fwd(q, k, v, True)  # noqa
                plain = lambda: A.flash_attention_ref(q, k, v, True)  # noqa
                lib = lambda: F.scaled_dot_product_attention(  # noqa
                    q, k, v, is_causal=True, enable_gqa=True)
                nbytes, nops = attn_work(B, H, Hkv, sq, skv, D,
                                         q.element_size())
            else:
                kc = torch.randn(B, T, Hkv, D, device="cuda",
                                 generator=g).to(dt)
                vc = torch.randn_like(kc)
                kc[:, skv:] = float("nan")
                vc[:, skv:] = float("nan")
                o = A.flash_decode(q, kc, vc, skv)
                ref = A.flash_decode_ref(q, kc, vc, skv)
                mag = fwd_route_mag("decode", (q, kc, vc, skv))
                err, ratio = hold_attn(o, ref, f"{name} {dt}", mag=mag)
                kern = lambda: A.flash_decode(q, kc, vc, skv)  # noqa
                plain = lambda: A.flash_decode_ref(q, kc, vc, skv)  # noqa
                kt = kc[:, :skv].transpose(1, 2)
                vt = vc[:, :skv].transpose(1, 2)
                # q at the end of the prefix: causal (square) or no mask
                lib = lambda: F.scaled_dot_product_attention(  # noqa
                    q, kt, vt, is_causal=sq > 1, enable_gqa=True)
                nbytes, nops = attn_work(B, H, Hkv, sq, skv, D,
                                         q.element_size(), s_new=sq)
            ms = time_ms(kern)
            plain_ms = time_ms(plain, reps=5)
            library_ms = time_ms(lib)
            rate = BF16_OPS_PER_S if dt == torch.bfloat16 else F32_OPS_PER_S
            bms, by = bound_ms(nbytes, nops, rate)
            src = attn_source("fwd" if T is None else "decode", dt, sq)
            n_split = A.last_decode_splits if name == "attn_decode" else None
            print(f"kernel {name} {str(dt)[6:]} ({src}) B={B} H={H} "
                  f"Hkv={Hkv} D={D} "
                  f"{'Sq' if T is None else 'S_new'}={sq} "
                  f"{'Skv' if T is None else 'kv_len'}={skv}"
                  f"{'' if T is None else f' T={T}'}"
                  f"{'' if n_split is None else f' n_split={n_split}'}: "
                  f"{ms:.4f} ms (plain "
                  f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms = "
                  f"{ms / library_ms:.2f}x sdpa, bound "
                  f"{bms:.4f} ms by {by}, {bms / ms:.1%} of bound), max abs "
                  f"err vs plain {err}, largest error/limit {ratio:.3f} "
                  f"({ATTN_TOL if mag is None else FWD_TOL})")
            # the table's rows: bf16; B9 at the serving path's length
            if dt == torch.bfloat16 and not (name == "attn_fwd_single"
                                             and sq != SERVE_B9_LEN):
                recs.append({"name": name, "route": "cuda",
                             "source": src, "replaces": replaces,
                             "launches": 0, "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bms,
                             "bound_by": by, "library_ms": library_ms})
                if n_split is not None:
                    recs[-1]["n_split"] = n_split
            del q, o, ref, mag
            torch.cuda.empty_cache()
    return recs


def llama_model_phase():
    """Flash (the kernels) against dense (the plain path), f32, full
    width, 4 layers, the same weights."""
    import dataclasses
    import torch
    from accl_tpu_torch.models import Llama, LlamaConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"model phase: allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=4,
                              dtype=torch.float32,
                              param_dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    flash = Llama(cfg).init(g)
    dense = Llama(dataclasses.replace(cfg, attention="dense"))
    dense.load_state_dict(flash.state_dict())
    print(f"model: Llama-3-8B geometry, 4 of 32 layers, f32, "
          f"{flash.param_count()} parameters")
    tg = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def toks(b, s):
        return torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                             generator=tg)

    def compare(a, b, what):
        need(bool(torch.isfinite(a).all()), f"model {what}: non-finite")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        tol = MODEL_F32_RTOL * scale
        print(f"model {what}: max abs diff flash vs dense {err:.3g} "
              f"(logit scale {scale:.3g}, tolerance {tol:.3g})")
        need(err <= tol, f"model {what}: flash and dense differ by {err}")

    with torch.no_grad(), attention_calls(cfg.n_layers) as calls:
        for b, s in ((2, 2048), (4, 128)):
            t = toks(b, s)
            compare(flash(t), dense(t), f"forward ({b}, {s})")
        t = toks(2, 1008)
        cf, cd = flash.init_kv_cache(2, 1008), dense.init_kv_cache(2, 1008)
        compare(flash.forward_cached(t[:, :1000], cf)[0],
                dense.forward_cached(t[:, :1000], cd)[0],
                "forward_cached prefill 1000")
        for i in range(1000, 1008):
            compare(flash.forward_cached(t[:, i:i + 1], cf)[0],
                    dense.forward_cached(t[:, i:i + 1], cd)[0],
                    f"decode step at {i}")
    with torch.no_grad():
        hold_path_calls(calls, "model")
    del calls, flash, dense
    torch.cuda.empty_cache()


@contextlib.contextmanager
def attention_calls(n_layers: int):
    """Record the Llama path's attention calls of its first and last
    layer as (wrapper name, args, kwargs, output), so that the kernels'
    outputs can be held against the plain versions at exactly the
    shapes the path gave them. The wrappers are the model module's own
    names; the kernels still count their launches."""
    from accl_tpu_torch.models import llama as L
    calls = []
    seen = {"flash_attention": 0, "flash_decode": 0}
    wrapped = {name: getattr(L, name) for name in seen}

    def recorder(name):
        def call(*args, **kwargs):
            out = wrapped[name](*args, **kwargs)
            if seen[name] % n_layers in (0, n_layers - 1):
                calls.append((name, args, kwargs, out.clone()))
            seen[name] += 1
            return out
        return call

    for name in seen:
        setattr(L, name, recorder(name))
    try:
        yield calls
    finally:
        for name, fn in wrapped.items():
            setattr(L, name, fn)


def hold_path_calls(calls, what: str):
    """Each recorded kernel output against its plain version on the same
    inputs; one line per kernel with its shapes and kv_len range."""
    from accl_tpu_torch.ops import attention as A
    kinds = {}
    for name, args, kwargs, out in calls:
        q = args[0]
        if name == "flash_attention":
            kind = ("B9" if A.is_single_block(args[1].shape[2]) else "B8")
            plain = A.flash_attention_ref(*args, **kwargs)[0]
            at = args[1].shape[2]
            mag = fwd_route_mag("fwd", args, kwargs)
        else:
            kind = ("B12 decode (split-KV)" if q.shape[2] == 1
                    else "B12 prefill")
            plain = A.flash_decode_ref(*args, **kwargs)
            at = kwargs["kv_len"]
            mag = fwd_route_mag("decode", args, kwargs)
        if mag is not None:
            kind += " (tensor cores)"
        pair = hold_attn(out, plain, f"{what} {kind} q {tuple(q.shape)} "
                         f"keys {at}", mag=mag)
        k = kinds.setdefault(kind, {"n": 0, "q": tuple(q.shape),
                                    "dtype": q.dtype, "keys": set(),
                                    "worst": (0.0, 0.0)})
        k["n"] += 1
        k["keys"].add(at)
        k["worst"] = max_pair(k["worst"], pair)
        del plain, mag
    for kind, k in sorted(kinds.items()):
        print(f"{what} {kind}: {k['n']} calls of the first and last layer "
              f"held against the plain version at the path's own shapes "
              f"(q {k['q']} {k['dtype']}, keys {min(k['keys'])}.."
              f"{max(k['keys'])}); max abs err {k['worst'][0]}, largest "
              f"error/limit {k['worst'][1]:.3f} "
              f"({FWD_TOL if 'tensor' in kind else ATTN_TOL})")
    return kinds


def serving_phase():
    """Llama-3-8B as published (32 layers, bf16 weights): generate for
    four 1024-token prompts, held against the plain path, timed and
    profiled. Returns the serving path's launch counts."""
    import dataclasses
    import torch
    from accl_tpu_torch.models import Llama, LlamaConfig
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              param_dtype=torch.bfloat16)
    B, S, NEW = 4, 1024, 32
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    t0 = time.perf_counter()
    model = Llama(cfg).init(g)
    torch.cuda.synchronize()
    print(f"serving: Llama-3-8B, {cfg.n_layers} layers, bf16, "
          f"{model.param_count()} parameters, init "
          f"{time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                            generator=g)
    short = prompts[:, :SERVE_B9_LEN]      # one key block: B9

    def against_dense(what, flash, dense):
        """``flash`` logits against ``dense()`` on the same weights with
        attention="dense" (the plain path), ||diff|| <= SERVE_DENSE_REL *
        ||dense||."""
        model.config = dataclasses.replace(cfg, attention="dense")
        try:
            ref = dense()
        finally:
            model.config = cfg
        rel = float(torch.linalg.vector_norm(flash - ref)
                    / torch.linalg.vector_norm(ref))
        agree = float((flash.argmax(-1) == ref.argmax(-1)).float().mean())
        print(f"serving {what}, flash vs dense (bf16, 32 layers): relative "
              f"diff {rel:.4g} (limit {SERVE_DENSE_REL}), max abs diff "
              f"{float((flash - ref).abs().max()):.4g}, greedy agreement "
              f"{agree:.4f}")
        need(rel <= SERVE_DENSE_REL, f"serving {what}: flash and dense "
             f"differ")

    # the serving path, once: generate, a forward on the prompts' first
    # 512 tokens (checked and freed at once, so that the phase's peak
    # memory stays that of the 1024-token checks), then one more prefill,
    # a decode step and a full forward for the checks below
    with torch.no_grad(), attention_calls(cfg.n_layers) as calls:
        zero_attention_counters()
        out = model.generate(prompts, max_new=NEW)
        full_short = model(short)
        need(full_short.shape == (B, SERVE_B9_LEN, cfg.vocab_size)
             and bool(torch.isfinite(full_short).all()),
             f"serving forward {B}x{SERVE_B9_LEN}: shape "
             f"{tuple(full_short.shape)} or non-finite logits")
        against_dense(f"forward {B}x{SERVE_B9_LEN} (B9)", full_short,
                      lambda: model(short))
        del full_short
        cache = model.init_kv_cache(B, S + NEW)
        cached, _ = model.forward_cached(prompts, cache)
        tok = cached[:, -1].argmax(-1)[:, None]
        step, _ = model.forward_cached(tok, cache)
        full = model(prompts)
        torch.cuda.synchronize()
        launches = attention_counters()
    print(f"serving phase launches: {launches}")
    need(launches["attn_fwd"] > 0 and launches["attn_decode"] > 0
         and launches["attn_prefill"] > 0,
         "serving: B8 or B12 (decode or prefill) not launched")
    need(launches["attn_fwd_single"] == cfg.n_layers,
         f"serving: B9 launched {launches['attn_fwd_single']} times on the "
         f"{B}x{SERVE_B9_LEN} forward, not once per layer ({cfg.n_layers})")
    need_routes(launches, True, "serving")
    with torch.no_grad():
        need(out.shape == (B, NEW), f"generate: shape {tuple(out.shape)}")
        need(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
             "generate: token outside the vocabulary")
        need(bool(torch.isfinite(cached).all() and torch.isfinite(full).all()
                  and torch.isfinite(step).all()),
             "serving: non-finite logits")
        err = float((cached - full).abs().max())
        scale = float(full.abs().max())
        agree = float((cached.argmax(-1) == full.argmax(-1)).float().mean())
        print(f"serving prefill logits, forward_cached (B12) vs forward (B8): "
              f"max abs diff {err:.4g} (logit scale {scale:.4g}, tolerance "
              f"{SERVE_BF16_RTOL * scale:.4g}); greedy agreement {agree:.4f} "
              f"(at least {SERVE_MIN_AGREE}); bitwise equal: "
              f"{torch.equal(cached, full)}")
        need(err <= SERVE_BF16_RTOL * scale and agree >= SERVE_MIN_AGREE,
             "serving: forward_cached prefill and forward disagree")
        hold_path_calls(calls, "serving")
        del calls
        # the plain path on the same weights: dense attention
        dcache = model.init_kv_cache(B, S + NEW)
        for what, flash, dense in (
                ("prefill (forward_cached)", cached,
                 lambda: model.forward_cached(prompts, dcache)[0]),
                ("decode step at 1024", step,
                 lambda: model.forward_cached(tok, dcache)[0]),
                ("forward", full, lambda: model(prompts))):
            against_dense(what, flash, dense)
        del cached, full, step, cache, dcache
        # the timing and profiling below drive the path again; its
        # launch counts were read above

        def prefill():
            c = model.init_kv_cache(B, S + NEW)
            return model.forward_cached(prompts, c)

        def decode_steps(state, n):
            """n greedy steps from ``state`` = (logits, cache); each
            step's host-clock ms."""
            logits, c = state
            ts = []
            for _ in range(n):
                t1 = time.perf_counter()
                tok = logits[:, -1].argmax(-1)
                logits, c = model.forward_cached(tok[:, None], c)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t1) * 1e3)
            return ts

        def host_ms(fn):
            """Median host-clock ms of 3 calls that end synchronised."""
            ts = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t1) * 1e3)
            return statistics.median(ts)

        fwd_ms = host_ms(lambda: model(prompts))
        short_ms = host_ms(lambda: model(short))
        pre_ms = host_ms(prefill)
        state = prefill()
        dec_ms = statistics.median(decode_steps(state, 16))
        print(f"serving forward (B8): {fwd_ms:.2f} ms for {B}x{S} tokens "
              f"({B * S / fwd_ms * 1e3:.0f} tokens/s; host clock, median "
              f"of 3)")
        print(f"serving forward {B}x{SERVE_B9_LEN} (B9): {short_ms:.2f} ms "
              f"({B * SERVE_B9_LEN / short_ms * 1e3:.0f} tokens/s; host "
              f"clock, median of 3)")
        print(f"serving prefill: {pre_ms:.2f} ms for {B}x{S} tokens "
              f"({B * S / pre_ms * 1e3:.0f} tokens/s; host clock, median "
              f"of 3)")
        print(f"serving decode: {dec_ms:.3f} ms per step of {B} tokens "
              f"({B / dec_ms * 1e3:.1f} tokens/s; median of 16 steps at "
              f"positions {S}..{S + 15})")
        state = prefill()
        for what, fn, window in (
                ("forward", lambda: model(prompts), fwd_ms),
                (f"forward {B}x{SERVE_B9_LEN}", lambda: model(short),
                 short_ms),
                ("prefill", prefill, pre_ms),
                ("decode x8", lambda: decode_steps(state, 8), 8 * dec_ms)):
            fams = device_ms_by_family(fn)
            if not fams:
                print(f"serving {what}: busy share not measured (the "
                      f"profiler saw no device activity)")
                continue
            busy = sum(fams.values())
            print(f"serving {what}: {busy:.2f} ms of kernels in a "
                  f"{window:.2f} ms host-clock window, busy share "
                  f"{busy / window:.3f}; " + ", ".join(
                      f"{f} {ms:.2f} ms" for f, ms in sorted(fams.items())))
        del state
    print(f"serving peak memory: "
          f"{(torch.cuda.max_memory_allocated() - held) / 2 ** 30:.2f} GiB "
          f"above the {held / 2 ** 30:.2f} GiB held before the phase")
    del model, short
    torch.cuda.empty_cache()
    return launches


# -- attention backward and the Llama training path --------------------------

ATTN_BWD_SRC = "accl_tpu_torch/csrc/attention_bwd.cu"          # f32 route
ATTN_BWD_SM90_SRC = "accl_tpu_torch/csrc/attention_bwd_sm90.cu"  # bf16 route
WGMMA_KERNELS = ("attn_fwd_wgmma_kernel", "attn_fwd_single_wgmma_kernel",
                 "attn_bwd_dkv_wgmma_kernel", "attn_bwd_dq_wgmma_kernel")
# the single-token decode route: CUDA-core code, its registers printed
SPLIT_KERNEL = "attn_decode_split_kernel"
# B10/B11 against their plain versions, per element. f32 inputs: the same
# f32 FlashAttention-2 backward summed in another order over up to S*D
# terms per output, whose error scales with the largest gradient of the
# tensor, not with each element: |got - plain| <= 2e-5*|plain| +
# 2e-5*max|plain|. bf16 inputs (the tensor-core route): P and dS are
# rounded to bf16 (8 significant bits) as the first operand of dV, dK
# and dQ, which moves each term of those sums by less than 2^-8 of its
# magnitude, so an output moves by less than 2^-8 * m, m the sum of the
# terms' magnitudes (``bwd_rounding_magnitudes``); the floor
# 2e-5*max|plain| covers the f32 order of the sums, dP's acting on dS
# where dP ~ delta: dk, dv (f32) 2^-8*m + 2e-5*max|plain|; dq (bf16 out)
# 2^-8*m + 2^-7*|plain| + 2^-7*median|plain| (one bf16 ulp of the
# element, floored at one ulp of the median, as the forward)
BWD_REL = 2e-5
BWD_BF16_MARGIN = 2.0 ** -8
BWD_TOL = ("f32 2e-5*|plain| + 2e-5*max|plain|; bf16 dk, dv 2^-8*m + "
           "2e-5*max|plain|, dq 2^-8*m + 2^-7*|plain| + 2^-7*median|plain|, "
           "m the magnitude of the rounded sum; per element")
# the Function's gradients (B8 + B10 + B11) against torch autograd through
# dense attention, f32: two algorithms (a dense softmax backward against
# the recomputation from the LSE with delta from O), each rounding at its
# own places: 5x the kernel-vs-plain limit, 1e-4*|dense| + 1e-4*max|dense|
FN_DENSE_REL = 1e-4
# the bf16 Function against f32 dense autograd on the same bf16-valued
# inputs: O, P, dS and the gradients round to bf16 (under 2^-8 each),
# so each gradient within 1e-2 relative L2; SDPA's bf16 backward is
# printed beside it as the yardstick
FN_BF16_REL_L2 = 1e-2
# flash against dense, 2-layer f32 Llama-3-8B, B=1, S=2048: the attention
# outputs differ by ~1e-7 relative (phase 6 read ~6e-6 relative on 4
# layers' logits); the loss within 1e-5 relative, every parameter's
# gradient within 1e-4 relative L2 (||g_flash - g_dense|| / ||g_dense||)
GRAD_LOSS_REL = 1e-5
GRAD_REL_L2 = 1e-4
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 2, 2048, 4
TRAIN_MAX_PEAK = 75 * 2 ** 30


def bwd_limit(plain, part: str, mag=None):
    """Per-element limit of a B10/B11 output ``part`` ("dk", "dv", "dq")
    against its plain version (see BWD_TOL); ``mag``, the rounded sum's
    magnitude, selects the bf16 route's rule."""
    p = plain.float().abs()
    if mag is None:
        return BWD_REL * p + BWD_REL * float(p.max())
    if part == "dq":
        return (BWD_BF16_MARGIN * mag + BF16_REL * p
                + BF16_REL * float(p.median()))
    return BWD_BF16_MARGIN * mag + BWD_REL * float(p.max())


def hold_bwd(got, plain, what: str, part: str,
             mag=None) -> tuple[float, float]:
    """(max abs error, largest error/limit) of a B10/B11 output against
    its plain version under BWD_TOL; fails past the limit."""
    import torch
    need(got.shape == plain.shape and got.dtype == plain.dtype,
         f"{what}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
         f"{tuple(plain.shape)} {plain.dtype}")
    need(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    d = (got.float() - plain.float()).abs()
    ratio = float((d / bwd_limit(plain, part, mag)).max())
    err = float(d.max())
    need(ratio <= 1.0, f"{what}: max abs err {err}, {ratio:.3g} times its "
         f"element's limit ({BWD_TOL})")
    return err, ratio


def hold_bwd_outputs(args, outs, what: str) -> tuple[float, float]:
    """B10's (dk, dv) or B11's (dq,) on ``args`` (the wrappers' operands)
    against the plain versions, under the rule of the inputs' dtype."""
    import torch
    from accl_tpu_torch.ops import attention as A
    bf16 = args[0].dtype == torch.bfloat16
    if len(outs) == 2:
        plain, parts = A.flash_attention_bwd_dkv_ref(*args), ("dk", "dv")
    else:
        plain, parts = (A.flash_attention_bwd_dq_ref(*args),), ("dq",)
    mags = dict(zip(("dk", "dv", "dq"), A.bwd_rounding_magnitudes(*args))) \
        if bf16 else {}
    w = (0.0, 0.0)
    for got, want, part in zip(outs, plain, parts):
        w = max_pair(w, hold_bwd(got, want, f"{what} {part}", part,
                                 mags.get(part)))
    return w


def sass_and_ptxas():
    """The built library's SASS, one string per function (its first line
    the mangled name), and ptxas's report of each kernel from the build
    log: mangled name -> [registers, spill bytes]."""
    import re
    import shutil
    from accl_tpu_torch import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.build())],
                          capture_output=True, text=True, timeout=300)
    need(sass.returncode == 0, f"cuobjdump failed: {sass.stderr.strip()}")
    funcs = re.split(r"\n\s*Function : ", sass.stdout)[1:]
    ptx = {}
    name = None
    for ln in _build.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            ptx.setdefault(name, [0, 0])[1] = int(m.group(1)) + int(
                m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            ptx.setdefault(name, [0, 0])[0] = int(m.group(1))
    return funcs, ptx


# B1 and B2's stream kernels (csrc/stream.cuh): the mangled names hold the
# name's length before it, which keeps bs_combine_kernel out
STREAM_KERNELS = {"combine": r"\d+combine_kernel", "cast": r"\d+cast_kernel"}


BS_COMBINE_KERNEL = "17bs_combine_kernel"


def bs_combine_instantiations() -> set:
    """(wire, func, requant, steps) of every B7 kernel accl_bs_combine
    launches: the round-closing mode one step a thread at every block,
    requant as many as bs_tile needs."""
    steps = sorted({bs_tile(b) // (BS_THREADS * BS_STEP) for b in BS_BLOCKS})
    return ({(w, f, True, s) for w in range(3) for f in range(4)
             for s in steps}
            | {(w, f, False, 1) for w in range(3) for f in range(4)})


def stream_kernels_checked():
    """B1's and B2's kernels carry 128-bit global accesses (LDG.E...128,
    STG.E...128) where their design puts them: every B1 instantiation
    loads and stores 16-byte vectors, every B2 instantiation reads or
    writes its f32 side in 16-byte vectors (the wire codes' side in 8 or
    4 bytes: a thread-step is 4 elements); ptxas reports no spills for
    them. So does B7 (``bs_combine_kernel``, every instantiation that
    accl_bs_combine launches): 16-byte loads of ``other``, and in the
    round-closing mode 16-byte f32 stores. Prints the counts and the
    registers; fails otherwise."""
    import re
    funcs, ptx = sass_and_ptxas()
    ldg, stg = r"LDG\.E(?:\.\w+)*\.128", r"STG\.E(?:\.\w+)*\.128"
    for name, pat in STREAM_KERNELS.items():
        bodies = {f.split("\n", 1)[0].strip(): f for f in funcs
                  if re.search(pat, f.split("\n", 1)[0])}
        need(bodies, f"{name}: no {pat} kernel in the library's SASS")
        counts = []
        for head, body in bodies.items():
            nl, ns = len(re.findall(ldg, body)), len(re.findall(stg, body))
            # cast_kernel<SRC, DST>: lane 0 is f32
            m = re.search(r"cast_kernelILi(\d)ELi(\d)E", head)
            want_l = m is None or m.group(1) == "0"
            want_s = m is None or m.group(2) == "0"
            need((nl > 0 or not want_l) and (ns > 0 or not want_s),
                 f"{head}: 128-bit loads {nl}, stores {ns}")
            counts.append((nl, ns))
        info = {k: v for k, v in ptx.items() if re.search(pat, k)}
        need(len(info) == len(bodies),
             f"{name}: {len(info)} ptxas reports for {len(bodies)} kernels")
        spills = {k: v for k, v in info.items() if v[1]}
        need(not spills, f"{name}: ptxas spills {spills}")
        regs = [v[0] for v in info.values()]
        print(f"{name}_kernel: {len(bodies)} instantiations, 128-bit "
              f"(LDG, STG) per instantiation {sorted(set(counts))}; ptxas "
              f"registers {min(regs)}-{max(regs)}, no spills")
    # B7: bs_combine_kernel<WIRE, F, REQUANT, S>
    bodies = {f.split("\n", 1)[0].strip(): f for f in funcs
              if BS_COMBINE_KERNEL in f.split("\n", 1)[0]}
    need(len(bodies) == len(bs_combine_instantiations()),
         f"bs_combine_kernel: {len(bodies)} instantiations in the SASS, "
         f"expected {len(bs_combine_instantiations())}")
    counts = {}
    for head, body in bodies.items():
        m = re.search(BS_COMBINE_KERNEL + r"ILi(\d)ELi(\d)ELb([01])ELi(\d)E",
                      head)
        need(m, f"{head}: not bs_combine_kernel<WIRE, F, REQUANT, S>")
        requant = m.group(3) == "1"
        nl, ns = len(re.findall(ldg, body)), len(re.findall(stg, body))
        need(nl > 0 and (ns > 0 or requant),
             f"{head}: 128-bit loads {nl}, stores {ns}")
        counts.setdefault("requant" if requant else "round-closing",
                          set()).add((nl, ns))
    info = {k: v for k, v in ptx.items() if BS_COMBINE_KERNEL in k}
    need(len(info) == len(bodies),
         f"bs_combine_kernel: {len(info)} ptxas reports for {len(bodies)}")
    spills = {k: v for k, v in info.items() if v[1]}
    need(not spills, f"bs_combine_kernel: ptxas spills {spills}")
    by_mode = {}
    for k, v in info.items():
        m = re.search(BS_COMBINE_KERNEL + r"ILi\dELi\dELb([01])ELi(\d)E", k)
        key = f"S={m.group(2)}" if m.group(1) == "1" else "round-closing"
        by_mode.setdefault(key, []).append(v[0])
    print(f"bs_combine_kernel: {len(bodies)} instantiations, 128-bit (LDG, "
          f"STG) {dict((k, sorted(v)) for k, v in counts.items())}; ptxas "
          f"registers {dict((k, f'{min(v)}-{max(v)}') for k, v in sorted(by_mode.items()))}, "
          f"no spills")


def wgmma_kernels_checked():
    """The bf16 route's kernels in the built library (B8, B9 and B12's
    prefill route, B10, B11): their SASS holds HGMMA (Hopper's warpgroup
    MMA: the tensor cores) and ptxas reports no spills. Prints both, and
    each instantiation's registers by head dim; fails otherwise. Then the
    split-KV decode kernels' registers and spill bytes (printed)."""
    import re
    from accl_tpu_torch import _build
    funcs, ptx = sass_and_ptxas()
    for kern in WGMMA_KERNELS:
        bodies = [f for f in funcs if kern in f.split("\n", 1)[0]]
        need(bodies, f"{kern}: not in the library's SASS")
        counts = [f.count("HGMMA") for f in bodies]
        need(min(counts) > 0, f"{kern}: an instantiation without HGMMA "
             f"(counts {counts})")
        info = [v for k, v in ptx.items() if kern in k]
        need(info, f"{kern}: no ptxas report in the build log")
        need(all(v[1] == 0 for v in info), f"{kern}: ptxas spills {info}")
        # the mangled name holds the head dim: ...ILi128EE...
        by_d = {int(m.group(1)): v[0] for k, v in ptx.items() if kern in k
                for m in [re.search(r"ILi(\d+)E", k)] if m}
        print(f"{kern}: {len(bodies)} instantiations (D 16/32/64/128), "
              f"HGMMA instructions {counts}; ptxas registers "
              f"{[v[0] for v in info]} (by head dim "
              f"{dict(sorted(by_d.items()))}), spill bytes "
              f"{[v[1] for v in info]}")
    info = [v for k, v in ptx.items() if SPLIT_KERNEL in k]
    need(info, f"{SPLIT_KERNEL}: no ptxas report in the build log")
    print(f"{SPLIT_KERNEL}: {len(info)} instantiations (f32/bf16 x D 16-128 "
          f"x rows 1/2/4); ptxas registers {sorted(v[0] for v in info)}, "
          f"spill bytes {sorted(v[1] for v in info)}")
    for ln in _build.build_log.splitlines():
        if "wgmma" in ln.lower() and ("warning" in ln.lower()
                                      or "Performance" in ln):
            print(f"  ptxas: {ln.strip()}")
            # ptxas waits out each wgmma before the next (C7515)
            need("serialized" not in ln or not any(
                k in ln for k in WGMMA_KERNELS),
                "a tensor-core kernel's wgmma were serialized by ptxas")


def bwd_operands(q, k, v, do, causal):
    """The forward's O and LSE (B8/B9) and delta = rowsum(do * o) from O
    in q's dtype, as ``_FlashAttention.backward`` forms them."""
    from accl_tpu_torch.ops import attention as A
    B, H, Sq, _ = q.shape
    o, lse = A.flash_attention_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).reshape(B * H, Sq)
    return o, lse, delta


def hold_bwd_call(q, do, k, v, lse, delta, causal, what):
    """B10 and B11 on one set of operands against their plain versions."""
    from accl_tpu_torch.ops import attention as A
    args = (q, do, k, v, lse, delta, causal, q.shape[-1] ** -0.5)
    w = hold_bwd_outputs(args, A.flash_attention_bwd_dkv(*args),
                         f"{what} B10")
    return max_pair(w, hold_bwd_outputs(
        args, (A.flash_attention_bwd_dq(*args),), f"{what} B11"))


def attention_bwd_edges(rng):
    """B10 and B11 against their plain versions over an edge corpus:
    MHA/GQA/MQA, causal and not, ragged S, Sq != Skv both ways, every
    head dim, f32 and bf16."""
    import torch
    cases = [  # B, H, Hkv, Sq, Skv, D, causal
        (1, 4, 4, 130, 130, 16, True), (1, 4, 4, 130, 130, 32, False),
        (2, 8, 2, 300, 300, 64, True), (1, 8, 2, 300, 300, 64, False),
        (1, 8, 1, 513, 513, 128, True), (1, 8, 1, 513, 513, 128, False),
        (1, 4, 2, 40, 96, 16, True), (1, 4, 2, 40, 96, 32, False),
        (1, 4, 2, 200, 70, 64, True), (2, 4, 4, 96, 40, 128, False)]
    for dt in (torch.float32, torch.bfloat16):
        worst, ratios = (0.0, 0.0), []
        for B, H, Hkv, Sq, Skv, D, causal in cases:
            q, do = (torch.from_numpy(rng.standard_normal(
                (B, H, Sq, D))).to("cuda", dt) for _ in range(2))
            k, v = (torch.from_numpy(rng.standard_normal(
                (B, Hkv, Skv, D))).to("cuda", dt) for _ in range(2))
            _o, lse, delta = bwd_operands(q, k, v, do, causal)
            case = (B, H, Hkv, Sq, Skv, D, causal)
            w = hold_bwd_call(q, do, k, v, lse, delta, causal,
                              f"attn bwd {dt} {case}")
            worst = max_pair(worst, w)
            ratios.append(round(w[1], 3))
        src = ATTN_BWD_SM90_SRC if dt == torch.bfloat16 else ATTN_BWD_SRC
        print(f"attention backward edges, {str(dt)[6:]} ({src}): "
              f"{len(cases)} cases (B10 and B11; MHA/GQA/MQA, causal and "
              f"not, ragged 130/300/513, Sq != Skv both ways, D 16-128) "
              f"within tolerance; max abs err {worst[0]}, largest "
              f"error/limit {worst[1]:.3f}, per case {ratios} ({BWD_TOL})")


def dense_topleft(q, k, v, causal=True):
    """Dense f32 attention with the reference's top-left causal mask, GQA
    by repeating KV: differentiable by torch autograd."""
    import torch
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        Sq, Skv = q.shape[2], k.shape[2]
        rows = torch.arange(Sq, device=q.device)
        mask = torch.arange(Skv, device=q.device)[None, :] <= rows[:, None]
        s = torch.where(mask, s, torch.finfo(torch.float32).min)
    return torch.matmul(torch.softmax(s, dim=-1), v)


def attention_bwd_records():
    """B10 and B11 at the full Llama-3-8B width (B=4, H=32, Hkv=8, S=2048,
    D=128, causal), bf16 (the table's rows) and f32, against their plain
    versions, timed beside PyTorch's SDPA backward (dq, dk and dv
    together: the library time of the pair; timed only). Then the whole
    Function's gradients against torch autograd through dense attention
    at the same shape: bf16 (relative L2, SDPA's beside it) and f32."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"attention backward: allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    B, H, Hkv, S, D = 4, 32, 8, 2048, 128
    n = S * (S + 1) // 2 * B * H           # visible scores, causal
    recs = []
    for dt in (torch.bfloat16, torch.float32):
        q, do = (torch.randn(B, H, S, D, device="cuda", generator=g).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, Hkv, S, D, device="cuda", generator=g).to(dt)
                for _ in range(2))
        _o, lse, delta = bwd_operands(q, k, v, do, True)
        err, ratio = hold_bwd_call(q, do, k, v, lse, delta, True,
                                   f"full width {dt}")
        scale = D ** -0.5
        args = (q, do, k, v, lse, delta, True, scale)
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                            enable_gqa=True)
        library_ms = time_ms(lambda: torch.autograd.grad(  # noqa: B023
            lo, (lq, lk, lv), do, retain_graph=True))
        del lo, lq, lk, lv
        es = q.element_size()
        qbytes, kvbytes = B * H * S * D * es, B * Hkv * S * D * es
        rate = BF16_OPS_PER_S if dt == torch.bfloat16 else F32_OPS_PER_S
        for name, fn, plain, ops_per, out_bytes in (
                ("attn_bwd_dkv", A.flash_attention_bwd_dkv,
                 A.flash_attention_bwd_dkv_ref, 8, 2 * B * H * S * D * 4),
                ("attn_bwd_dq", A.flash_attention_bwd_dq,
                 A.flash_attention_bwd_dq_ref, 6, qbytes)):
            ms = time_ms(lambda: fn(*args))  # noqa: B023
            plain_ms = time_ms(lambda: plain(*args), reps=5)  # noqa: B023
            nbytes = 2 * qbytes + 2 * kvbytes + 2 * 4 * B * H * S + out_bytes
            bms, by = bound_ms(nbytes, ops_per * D * n, rate)
            src = ATTN_BWD_SM90_SRC if dt == torch.bfloat16 else ATTN_BWD_SRC
            print(f"kernel {name} {str(dt)[6:]} ({src}) B={B} H={H} "
                  f"Hkv={Hkv} D={D} "
                  f"S={S} causal: {ms:.4f} ms (plain {plain_ms:.4f} ms, sdpa "
                  f"backward (dq, dk, dv together) {library_ms:.4f} ms, bound "
                  f"{bms:.4f} ms by {by}, {bms / ms:.1%} of bound); B10+B11 "
                  f"max abs err vs plain {err}, largest error/limit "
                  f"{ratio:.3f} ({BWD_TOL})")
            if dt == torch.bfloat16:
                recs.append({"name": name, "route": "cuda",
                             "source": ATTN_BWD_SM90_SRC,
                             "replaces": {"attn_bwd_dkv":
                                          "accl_tpu/ops/attention.py:461",
                                          "attn_bwd_dq":
                                          "accl_tpu/ops/attention.py:492"}[
                                              name],
                             "launches": 0, "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bms,
                             "bound_by": by, "library_ms": library_ms})
        del q, do, k, v, lse, delta, args
        torch.cuda.empty_cache()

    # the bf16 Function (B8 + B10 + B11 on the tensor-core route) and
    # SDPA's bf16 backward against f32 dense autograd on the same
    # bf16-valued inputs, relative L2
    x = [torch.randn(B, h, S, D, device="cuda", generator=g).to(
        torch.bfloat16) for h in (H, Hkv, Hkv, H)]
    do = x[3]
    leaves = [t.float().requires_grad_() for t in x[:3]]
    want = torch.autograd.grad(dense_topleft(*leaves), leaves, do.float())
    del leaves
    torch.cuda.empty_cache()
    fl = [t.clone().requires_grad_() for t in x[:3]]
    got = torch.autograd.grad(A.flash_attention(*fl, causal=True), fl, do)
    sl = [t.clone().requires_grad_() for t in x[:3]]
    lib = torch.autograd.grad(F.scaled_dot_product_attention(
        *sl, is_causal=True, enable_gqa=True), sl, do)
    del fl, sl
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, lib):
        need(a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()),
             f"bf16 Function {name}: dtype {a.dtype} or non-finite")
        norm = torch.linalg.vector_norm(b)
        rel = float(torch.linalg.vector_norm(a.float() - b) / norm)
        rel_sdpa = float(torch.linalg.vector_norm(c.float() - b) / norm)
        print(f"bf16 Function {name} (B8 + B10 + B11, tensor-core route) vs "
              f"f32 dense autograd on the same bf16 inputs, (4, 32/8, 2048, "
              f"128) causal: relative L2 {rel:.4g} (limit {FN_BF16_REL_L2}); "
              f"SDPA bf16 backward {rel_sdpa:.4g}")
        need(rel <= FN_BF16_REL_L2, f"bf16 Function {name}: relative L2 "
             f"{rel:.4g} past {FN_BF16_REL_L2}")
    del x, do, got, want, lib
    torch.cuda.empty_cache()

    # the Function (B8 + B10 + B11) against dense autograd, f32
    q, k, v = (torch.randn(B, h, S, D, device="cuda", generator=g)
               .requires_grad_() for h in (H, Hkv, Hkv))
    do = torch.randn(B, H, S, D, device="cuda", generator=g)
    got = torch.autograd.grad(A.flash_attention(q, k, v, causal=True),
                              (q, k, v), do)
    want = torch.autograd.grad(dense_topleft(q, k, v), (q, k, v), do)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        need(bool(torch.isfinite(a).all()), f"Function {name}: non-finite")
        lim = FN_DENSE_REL * b.abs() + FN_DENSE_REL * float(b.abs().max())
        r = float(((a - b).abs() / lim).max())
        print(f"Function {name} (B8 + B10 + B11) vs dense autograd, f32, "
              f"(4, 32/8, 2048, 128) causal: max abs diff "
              f"{float((a - b).abs().max()):.4g}, largest error/limit "
              f"{r:.3f} (1e-4*|dense| + 1e-4*max|dense|)")
        need(r <= 1.0, f"Function {name}: flash and dense gradients differ")
    del q, k, v, do, got, want
    torch.cuda.empty_cache()
    return recs


def grad_check_phase():
    """Flash against dense, f32, full width, 2 layers, B=1, S=2048: one
    model, its config switched between the two; the loss and every
    parameter's gradient."""
    import dataclasses
    import torch
    from accl_tpu_torch.models import Llama, LlamaConfig
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2,
                              dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    model = Llama(cfg).init(g).requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), device="cuda",
                           generator=g)
    runs = {}
    for attention in ("flash", "dense"):
        model.config = dataclasses.replace(cfg, attention=attention)
        model.zero_grad(set_to_none=True)
        loss = model.loss(tokens)
        loss.backward()
        runs[attention] = (loss.item(), {k: p.grad for k, p in
                                         model.named_parameters()})
    model.config = cfg
    (lf, gf), (ld, gd) = runs["flash"], runs["dense"]
    need(np.isfinite(lf) and np.isfinite(ld), "grad check: non-finite loss")
    loss_rel = abs(lf - ld) / abs(ld)
    rels = {k: float(torch.linalg.vector_norm(gf[k] - gd[k])
                     / torch.linalg.vector_norm(gd[k])) for k in gd}
    worst = max(rels, key=rels.get)
    print(f"grad check, Llama-3-8B width, 2 layers, f32, (1, 2048), flash "
          f"vs dense: loss {lf:.7f} vs {ld:.7f} (relative {loss_rel:.3g}, "
          f"limit {GRAD_LOSS_REL}); worst gradient {worst} relative L2 "
          f"{rels[worst]:.3g} (limit {GRAD_REL_L2}); median "
          f"{statistics.median(rels.values()):.3g} over {len(rels)} "
          f"parameters")
    need(loss_rel <= GRAD_LOSS_REL, "grad check: flash and dense losses differ")
    need(rels[worst] <= GRAD_REL_L2,
         f"grad check: {worst} gradients of flash and dense differ")
    del model, runs, gf, gd
    torch.cuda.empty_cache()


@contextlib.contextmanager
def recorded_calls(names, n_layers: int):
    """Record the calls of the attention module's wrappers ``names`` that
    the first and last layer of one model pass make (the first n_layers
    calls of each) as (wrapper name, args, outputs). The model and
    ``_FlashAttention`` look these names up at each call."""
    from accl_tpu_torch.ops import attention as A
    calls = []
    seen = dict.fromkeys(names, 0)
    wrapped = {name: getattr(A, name) for name in names}

    def recorder(name):
        def call(*args):
            out = wrapped[name](*args)
            if seen[name] in (0, n_layers - 1):
                kept = tuple(t.clone() for t in (out if isinstance(out, tuple)
                                                 else (out,)))
                calls.append((name, args, kept))
            seen[name] += 1
            return out
        return call

    for name in names:
        setattr(A, name, recorder(name))
    try:
        yield calls
    finally:
        for name, fn in wrapped.items():
            setattr(A, name, fn)


def training_phase():
    """Llama-3-8B width, 8 of 32 layers, f32 parameters and bf16
    activations: ``make_train_step`` with Adam(lr=1e-4), 4 steps on one
    batch of (2, 2048) random tokens. Returns the path's launch counts."""
    import dataclasses
    import torch
    from accl_tpu_torch.models import Llama, LlamaConfig
    from accl_tpu_torch.ops import attention as A
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=TRAIN_LAYERS)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    model = Llama(cfg).init(g)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = model.make_train_step(opt)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                           device="cuda", generator=g)
    N = model.param_count()
    n_mat = N - model.embed.numel() - (2 * cfg.n_layers + 1) * cfg.dim
    logits = TRAIN_B * TRAIN_S * cfg.vocab_size * 4
    est = 16 * N + 2 * n_mat + 3 * logits + cfg.n_layers * 10 ** 9
    print(f"training: Llama-3-8B width, {cfg.n_layers} of 32 layers, f32 "
          f"parameters, bf16 activations, B={TRAIN_B}, S={TRAIN_S}, Adam "
          f"lr=1e-4; {N} parameters. Memory reckoning: weights, gradients "
          f"and Adam's two moments 16 B x N = {16 * N / 2 ** 30:.1f} GiB; "
          f"bf16 weight casts saved for backward "
          f"{2 * n_mat / 2 ** 30:.1f} GiB; activations ~1 GB per layer; f32 "
          f"logits, their slice and gradient 3 x {logits / 2 ** 30:.1f} GiB;"
          f" about {est / 2 ** 30:.1f} GiB in all")
    zero_attention_counters()
    losses, times = [], []
    with recorded_calls(("flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
                        cfg.n_layers) as calls:
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(tokens)))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    launches = attention_counters()
    peak = torch.cuda.max_memory_allocated()
    print(f"training losses {losses}; step ms (host clock) {times}")
    print(f"training phase launches: {launches}")
    per_run = cfg.n_layers * TRAIN_STEPS
    need(all(np.isfinite(x) for x in losses), "training: non-finite loss")
    need(losses[-1] < losses[0], "training: the loss did not fall")
    for key in ("attn_fwd", "attn_bwd_dkv", "attn_bwd_dq"):
        need(launches[key] == per_run, f"training: {key} launched "
             f"{launches[key]} times, not once per layer per step "
             f"({per_run})")
    need_routes(launches, True, "training")
    print(f"training peak memory: {peak / 2 ** 30:.2f} GiB (the "
          f"{held / 2 ** 30:.2f} GiB held before the phase included; limit "
          f"{TRAIN_MAX_PEAK / 2 ** 30:.0f} GiB)")
    need(peak <= TRAIN_MAX_PEAK, "training: peak memory past the limit")
    kinds = {}
    with torch.no_grad():
        # B8 on the training model and batch once more (after the steps,
        # so that holding its outputs adds nothing to the peak above)
        with recorded_calls(("flash_attention_fwd",), cfg.n_layers) as fwd:
            model(tokens)
        calls += fwd
        for name, args, outs in calls:
            what = f"training {name} q {tuple(args[0].shape)}"
            if name == "flash_attention_fwd":
                plain, plain_lse = A.flash_attention_ref(*args[:5])
                w = hold_attn(outs[0], plain, what, outs[1], plain_lse,
                              fwd_route_mag("fwd", args))
                del plain, plain_lse
            else:
                w = hold_bwd_outputs(args, outs, what)
            kinds[name] = max_pair(kinds.get(name, (0.0, 0.0)), w)
    for name, w in sorted(kinds.items()):
        when = ("a forward after the steps" if name == "flash_attention_fwd"
                else "the first step")
        print(f"training {name}: the first and last layer's calls of "
              f"{when} held against the plain version at the path's "
              f"shapes ({TRAIN_B}, 32/8, {TRAIN_S}, 128) bf16; max abs err "
              f"{w[0]}, largest error/limit {w[1]:.3f} "
              f"({FWD_TOL if name == 'flash_attention_fwd' else BWD_TOL})")
    need(len(calls) == 6, f"training: {len(calls)} attention calls recorded")
    del calls
    step_ms = statistics.median(times[1:])
    tokens_n = TRAIN_B * TRAIN_S
    visible = TRAIN_S * (TRAIN_S + 1) // 2 * TRAIN_B * cfg.n_heads
    flops = 6 * n_mat * tokens_n + 12 * cfg.head_dim * visible * cfg.n_layers
    print(f"training step: {step_ms:.2f} ms (host clock, median of steps "
          f"2-{TRAIN_STEPS}), {tokens_n / step_ms * 1e3:.0f} tokens/s; "
          f"model FLOPs per step {flops:.4g} (6 x {n_mat} matmul "
          f"parameters x {tokens_n} tokens + 12 x D per visible attention "
          f"score), {flops / (step_ms / 1e3) / 1e12:.1f} TFLOP/s = "
          f"{flops / (step_ms / 1e3) / BF16_OPS_PER_S:.1%} of 989 TFLOP/s")
    # the step's two halves on CUDA events (one more step, by hand as
    # train_step runs it): loss and backward, then the optimizer
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    opt.zero_grad(set_to_none=True)
    evs[0].record()
    model.loss(tokens).backward()
    evs[1].record()
    opt.step()
    evs[2].record()
    torch.cuda.synchronize()
    fb_ms, opt_ms = evs[0].elapsed_time(evs[1]), evs[1].elapsed_time(evs[2])
    print(f"training step halves (CUDA events): loss + backward "
          f"{fb_ms:.2f} ms, Adam step {opt_ms:.2f} ms")
    fams = device_ms_by_family(lambda: step(tokens))
    if fams:
        busy = sum(fams.values())
        print(f"training step under the profiler: {busy:.2f} ms of "
              f"kernels; busy "
              f"share {busy / step_ms:.3f} of the unprofiled {step_ms:.2f} "
              f"ms step; " + ", ".join(f"{f} {ms:.2f} ms" for f, ms in
                                       sorted(fams.items(),
                                              key=lambda x: -x[1])))
    else:
        print("training step: busy share not measured (the profiler saw no "
              "device activity)")
    del model, opt, step, tokens
    torch.cuda.empty_cache()
    return launches


def phase(name: str):
    """One line at the start of each phase: the seconds since the script
    started and what the device holds."""
    import torch
    print(f"== {name} at {time.perf_counter() - T_START:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    phase("phase 1: device and build")
    phase_device()
    rng = np.random.default_rng(SEED)
    phase("phase 2: kernel corpora and records")
    corpus_combine(rng)
    corpus_codec(rng)
    corpus_lanes(rng)
    stream_kernels_checked()
    stream_edges(rng)
    bs_edges(rng)
    recs = kernel_records()
    phase("phases 3-4: collectives main path")
    main_path(recs)
    gc.collect()                      # the rank worlds' buffers sit in cycles
    torch.cuda.empty_cache()
    phase("phase 4b: point-to-point and local ops")
    p2p_path(recs)
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 5: attention kernels")
    attention_edges(rng)
    attn_recs = attention_records()
    zero_attention_counters()         # the f32 model path's own counts
    phase("phase 6: f32 model, flash vs dense")
    llama_model_phase()
    by_path = {"model_f32": attention_counters()}
    print(f"model phase launches: {by_path['model_f32']}")
    need(by_path["model_f32"]["attn_fwd_single"] > 0,
         "model phase: B9 never launched")
    need_routes(by_path["model_f32"], False, "model phase")
    phase("phase 7: serving")
    by_path["serving"] = serving_phase()     # zeroes the counts itself
    phase("phase 8: attention backward kernels")
    wgmma_kernels_checked()
    attention_bwd_edges(rng)
    attn_recs += attention_bwd_records()
    phase("gradient check: flash vs dense, f32")
    grad_check_phase()
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 9: training")
    held = torch.cuda.memory_allocated()
    need(held < 2 * 2 ** 30, f"{held / 2 ** 30:.2f} GiB still allocated "
         f"before the training phase (limit 2 GiB)")
    by_path["training"] = training_phase()   # zeroes the counts itself
    for r in attn_recs:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
        r["launches"] = r["launches_by_path"][LAUNCH_PATH[r["name"]]]
        need(r["launches"] > 0, f"kernel {r['name']} was never launched on "
             f"the {LAUNCH_PATH[r['name']]} path")
    recs += attn_recs
    print(f"total: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
