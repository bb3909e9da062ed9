#!/usr/bin/env python3
"""Compare checkouts of the port on one card: the stream kernels B1-B7,
B9, B12 decode, the 32-layer Llama-3-8B forward on 4x512 tokens (the
serving path's B9 call), the attention backward B10, B11 (and their f32
route past head dim 256) and the attention forward's f32 route (B8, B9,
B12 prefill).

Run from the root of a checkout:

    python3 chip_compare.py [--part all|stream|model|bwd|bwd_wide|fwd32|fwd_wide|wide16|band16] [TREE ...]

``--part stream`` times the stream kernels only (no model is built);
``--part model`` B9, decode and the forward only; ``--part bwd`` B10
and B11 only; ``--part bwd_wide`` the f32 B10 and B11 past head dim 256;
``--part fwd32`` the forward's f32 route beside SDPA's f32 forward, with
the bf16 routes and decode at the same shapes as controls; ``--part
fwd_wide`` the f32 forward past head dim 256; ``--part wide16`` the
16-bit B8, B9, B12 (chunks and single-token decode), B10 and B11 past
head dim 256; ``--part band16`` the 16-bit B8, B9 and B11 at the head
dims past 256 where the dispatch keeps the column groups, on the
cluster forms' measurement entry points where the tree has them; the
default
is all but ``bwd_wide``, ``fwd32``, ``fwd_wide``, ``wide16`` and
``band16``.

Each TREE is the root of a checkout of this repository (default: this
one). Each runs in a process of its own, in the order given, so that
``python3 chip_compare.py old . . old`` times two versions in turns on
one card. A process imports that tree's ``accl_tpu_torch`` (building its
kernels into that tree's ``build/``) and prints one JSON line with the
card's name and power limit and:

- the stream part, at the collectives' hop shape (W=8 rank rows of one
  8 Mi-element ring chunk): B1 ``combine`` SUM in f32 and bf16 in place
  beside ``torch.add(a, b, out=a)`` on the same bytes, and in f32 out of
  place as the ring calls it (``combine_sum_f32_out``, beside
  ``torch.add(a, b, out=o)``); B1 on fp8 payloads (e4m3fn and e5m2,
  random codes, SUM, MAX, MIN and PROD, out of place; bound 3 bytes an
  element, no library call: ``torch.add`` takes no fp8; ``b1_sass``
  counts the SASS instructions of its eight fp8 instantiations and of
  the bf16 SUM's); B2 ``cast`` in
  six directions (f32 <-> f16, bf16, e4m3fn) beside ``.to(dtype)`` on
  the same rows; B3 (``fp8_scale``, its amax step, and ``fp8_quant``),
  B4 ``fp8_dequant``, B5 ``bs_quant``, B6 ``bs_dequant`` and B7
  ``bs_combine`` (e4m3fn, block 128, SUM) in its requant mode (a middle
  hop) and its round-closing mode (``bs_combine_f32``, f32 out, bound
  9 bytes an element plus scales); and ``dst.copy_(src)`` over the
  same 8 x 8 Mi f32, the stream rate the card reaches on a plain copy.
  Each is the median device time of 20 launches behind the GPU sleep,
  beside its bound (the bytes it must move over 3.35 TB/s), and
  ``sha`` holds a SHA-256 of each kernel's outputs (B1 f32 and bf16 out
  of place, B1 fp8, B2-B7), so two trees whose kernels compute the same
  bits print the same. The ptxas report of the B1, B2 and B7 kernels is
  printed from the build log;
- B9 (``flash_attention_fwd``, bf16, causal, one key block; H=32,
  Hkv=8, D=128) at B=4, S=128 and S=512, and B12 single-token decode
  (``flash_decode``, bf16 and f32) at B=4, kv_len 2047 of T=4096: the
  median device time of 20 launches on CUDA events after warm-up, and
  the largest error against the plain version on the same inputs;
- the 32-layer bf16 Llama-3-8B ``forward`` (random weights from a seed)
  on 4x512 random tokens, which runs B9 once per layer: host-clock ms
  (median of 3 after one warm-up), then one more call under
  torch.profiler: its kernel time, and B9's share of it;
- the backward part, at phase 8's shape of ``chip_smoke.py`` (B=4,
  H=32, Hkv=8, S=2048, D=128, causal): B10 ``flash_attention_bwd_dkv``
  and B11 ``flash_attention_bwd_dq`` in f32 and bf16 on the operands the
  forward gives (its LSE, delta from O), the median device time of 20
  launches, the largest error against the plain version and a SHA-256
  of the outputs' bits, and
  PyTorch's SDPA backward (dq, dk and dv together, f32 and bf16, with
  ``allow_tf32`` off), the pair's yardstick;
- the bwd_wide part, at phase 17a's shapes past head dim 256 (Gemma-2B's
  heads, H=8, Hkv=1, B=4, causal; D=264 and D=512 at S=2048, D=1024,
  1032, 2048 and 4096 at S=1024; D=4104 at B=1, S=1024, past the cluster
  form): f32 B10 and B11 on the operands the
  plain forward gives (``flash_attention_ref``: the same O and LSE in
  every tree), each the median device time of 5 launches behind the
  GPU sleep beside its bound (three TF32 products of 8*D (B10) or 6*D
  (B11) operations a visible score at 495 TFLOP/s), the pair's sum, the
  largest error against the plain versions, a SHA-256 of the outputs'
  bits (the inputs come from one seed, so two trees whose kernels sum
  in the same order print the same), the plain versions' pair (median
  of 3), and PyTorch's SDPA f32 backward
  (dq, dk and dv together, ``allow_tf32`` off; its math backend, the one
  that takes these head dims), timed only; the route the last launch
  reported; where the tree has the
  cluster form at that head dim, its cluster size, the clusters of it
  the card holds at once and the SMs they fill; and where the tree has
  the band form's measurement entry points, the band form at D 2056 and
  4096 (B 4, S 1024) beside them (``band_d<D>_s1024``: times, errors
  and SHA-256s);
- the fwd32 part, at phase 5's shapes of ``chip_smoke.py`` (B=4, H=32,
  Hkv=8, D=128, causal): ``flash_attention_fwd`` in f32 as B9 at S=128
  and S=512 and as B8 at S=2048, and the f32 prefill (``flash_decode``,
  S_new = kv_len = 1024 of T = 1024), each the median device time of 20
  launches behind the GPU sleep, the largest error against the plain
  version on the same inputs, a SHA-256 of the outputs' bits, and
  PyTorch's SDPA forward on the same f32
  inputs with ``allow_tf32`` off (timed only); then the same calls in
  bf16 and the single-token decode (bf16 and f32, kv_len 2047 of T =
  4096), whose kernels the f32 route does not share;
- the fwd_wide part, at phase 17a's shapes past head dim 256 (Gemma-2B's
  heads, H=8, Hkv=1, B=4, causal; ``FWD_WIDE_CASES``): f32 B8 at D 264
  and 512 (S 2048) and 1024, 2048, 4096 (S 1024), B9 at S 512, the B12
  prefill (S_new = kv_len = 1024), the single-token decode (kv_len 2047
  of 4096 at D 264 and 512, 1023 of 1024 at 1024, 2048, 2056 and 4096),
  the D 512 Llama's B8 and B9 at B 1, S 1024 and 512, and at B 1, D 4104
  (past the cluster form) B8, B9 (S 512), the prefill and the decode
  (kv_len 1023 of 1024): each the median device
  time of 5 launches (decode 20) behind the GPU sleep beside its bound
  (three TF32 products of 4*D operations a visible score at 495
  TFLOP/s; the decode: its K and V prefix over 3.35 TB/s), the route it
  reported, the largest error against the plain version, a SHA-256 of
  the outputs' bits, the plain version (median of 3) and PyTorch's SDPA
  f32 forward (``allow_tf32`` off; its math backend at these head dims),
  and the cluster size at that head dim; then, where the tree has it,
  the band form's B8 through ``accl_attn_fwd_band`` at D 2056 and 4096
  (B 4, S 1024) beside the dispatch's cluster form on the same inputs;
- the wide16 part, at phase 17a's shapes past head dim 256 (Gemma-2B's
  heads, H=8, Hkv=1, B=4, causal; ``WIDE16_CASES``) and at the D 512
  Llama's (B=1): bf16 B8 (S 2048 at D 264 and 512, S 1024 at D 1024 and
  2048; the Llama's S 2048), B9 (S 512), the B12 chunk (S_new 1024 over
  as many cached keys; the Llama's 2048 of a 2064-row cache), B10 and
  B11 (S 2048 at D 264 and 512, S 1024 at D 1024 and 2048; the Llama's
  S 2048) on the operands the plain forward gives, and the bf16
  single-token decode (kv_len 2047 of 4096 at D 264 and 512, 1023 of
  1024 at D 1024 and 2048; the Llama's 2063 of 2064): each the median
  device time of 5 launches (decode 20) behind the GPU sleep beside its
  bound (B8, B9 and the chunk 4*D, B10 8*D, B11 6*D operations a visible
  score at 989 TFLOP/s; the decode its K and V prefix over 3.35 TB/s),
  the route it reported, the largest error against the plain version, a
  SHA-256 of the outputs' bits, the plain version (median of 3),
  PyTorch's SDPA (the forward, the backward's three gradients together,
  or the decode's forward; its math backend at these head dims and
  heads) and, where the tree has a 16-bit cluster form at that head dim,
  the clusters of it the card holds.

It uses only the entry points every version of the port has
(``ops.combine.combine``, ``ops.compression.cast``, ``fp8_scale``,
``fp8_quant``, ``fp8_dequant``, ``bs_quant``, ``bs_dequant``,
``bs_combine``, ``ops.attention``, ``models.Llama``), and it needs CUDA:
without it, it exits with 1 and prints nothing.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

SEED = 20261017
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
PARTS = ("all", "stream", "model", "bwd", "bwd_wide", "fwd32", "fwd_wide",
         "wide16", "band16")
BF16_OPS_PER_S = 989e12     # H100 SXM data sheet, dense bf16
TF32_OPS_PER_S = 495e12     # H100 SXM data sheet, dense TF32
# the bwd_wide part's (head dim, sequence length, batch): the cluster
# form's tiers of 2 (D 264 to 1024), 4 (1032, 2048) and 8 (4096) slices a
# block, and past it (4104, the band form; 17a's B 1)
BWD_WIDE_CASES = ((264, 2048, 4), (512, 2048, 4), (1024, 1024, 4),
                  (1032, 1024, 4), (2048, 1024, 4), (4096, 1024, 4),
                  (4104, 1024, 1))
# the head dims at which the bwd_wide part also times the band form
# through its measurement entry points, where the tree has them
BAND_MEASURE_DIMS = (2056, 4096)
# the fwd_wide part's calls at Gemma-2B's heads (H 8, Hkv 1), B 4 unless
# given: (name, kind, D, S or S_new, kv length, cache T, B)
FWD_WIDE_CASES = (
    ("b8_d264_s2048", "fwd", 264, 2048, 2048, None, 4),
    ("b8_d512_s2048", "fwd", 512, 2048, 2048, None, 4),
    ("b8_d1024_s1024", "fwd", 1024, 1024, 1024, None, 4),
    ("b8_d2048_s1024", "fwd", 2048, 1024, 1024, None, 4),
    ("b8_d4096_s1024", "fwd", 4096, 1024, 1024, None, 4),
    ("b9_d264_s512", "fwd_single", 264, 512, 512, None, 4),
    ("b9_d512_s512", "fwd_single", 512, 512, 512, None, 4),
    ("prefill_d264_s1024", "prefill", 264, 1024, 1024, 1024, 4),
    ("prefill_d512_s1024", "prefill", 512, 1024, 1024, 1024, 4),
    ("decode_d264_kv2047", "decode", 264, 1, 2047, 4096, 4),
    ("decode_d512_kv2047", "decode", 512, 1, 2047, 4096, 4),
    ("decode_d1024_kv1023", "decode", 1024, 1, 1023, 1024, 4),
    ("decode_d2048_kv1023", "decode", 2048, 1, 1023, 1024, 4),
    ("llama_d512_b8_s1024", "fwd", 512, 1024, 1024, None, 1),
    ("llama_d512_b9_s512", "fwd_single", 512, 512, 512, None, 1),
    # past the cluster form (the band form) and the wide split (the band
    # decode): 17a's B 1 at D 4104, the decode also at B 4, D 2056, 4096
    ("b8_d4104_s1024_b1", "fwd", 4104, 1024, 1024, None, 1),
    ("b9_d4104_s512_b1", "fwd_single", 4104, 512, 512, None, 1),
    ("prefill_d4104_s1024_b1", "prefill", 4104, 1024, 1024, 1024, 1),
    ("decode_d4104_kv1023_b1", "decode", 4104, 1, 1023, 1024, 1),
    ("decode_d2056_kv1023", "decode", 2056, 1, 1023, 1024, 4),
    ("decode_d4096_kv1023", "decode", 4096, 1, 1023, 1024, 4))
# the head dims at which the fwd_wide part also times the f32 B8 on the
# band form through its measurement entry point, where the tree has it,
# beside the dispatch's cluster form (B 4, S 1024)
FWD_BAND_MEASURE_DIMS = (2056, 4096)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device ms of ``fn`` on CUDA events around each call, the
    calls enqueued behind a GPU sleep so that the host runs ahead and
    each event pair times the kernels alone."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
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


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of every B1, B2 and B7 kernel
    instantiation (mangled name -> [registers, spill bytes]) from nvcc's
    -Xptxas -v."""
    import re
    rep, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            keep = re.search(r"\d(combine|cast|bs_combine)_kernel", name)
            name = name if keep else None
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            rep.setdefault(name, [0, 0])[0] = int(m.group(1))
        elif name and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            rep.setdefault(name, [0, 0])[1] = int(m.group(1)) + int(
                m.group(2))
    return rep


def b1_sass_counts(lib: str) -> dict:
    """SASS instructions (NOPs left out) of B1's fp8 instantiations
    (``combine_kernel<OpFP8<F, W>>``) and of its bf16 SUM, read with
    cuobjdump from the tree's built library."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300).stdout
    funcs = ("SUM", "MAX", "MIN", "PROD")
    counts = {}
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        head = f.split("\n", 1)[0]
        m = re.search(r"combine_kernelI5OpFP8ILi(\d)ELi(\d)E", head)
        wire = m and ("e4m3fn" if m.group(2) == "1" else "e5m2")
        name = (f"{funcs[int(m.group(1))]}_{wire}" if m else "SUM_bf16"
                if "combine_kernelI6OpBF16ILi0E" in head else None)
        if name:
            counts[name] = sum(
                1 for o in re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                                      r"([A-Z][A-Z0-9_.]*)", f) if o != "NOP")
    return dict(sorted(counts.items()))


def sha_of(ts) -> str:
    """The first 16 hex digits of a SHA-256 of the tensors' bits."""
    import torch
    d = hashlib.sha256()
    for t in ts:
        d.update(t.contiguous().view(torch.int16 if t.element_size() == 2
                                     else torch.int32).cpu().numpy()
                 .tobytes())
    return d.hexdigest()[:16]


def timed(ms: float, nbytes: int, library_ms: float | None = None) -> dict:
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    rec = {"ms": ms, "bound_ms": bound, "pct_of_bound": 100 * bound / ms}
    if library_ms is not None:
        rec["library_ms"] = library_ms
        rec["vs_library"] = ms / library_ms
    return rec


def stream_part(out: dict) -> None:
    """B1-B7 and a plain copy at the ring's hop shape (module docstring)."""
    import torch
    from accl_tpu_torch import _build
    from accl_tpu_torch.constants import ReduceFunc
    from accl_tpu_torch.ops import compression as C
    from accl_tpu_torch.ops.combine import combine
    W, c = 8, 8 << 20
    N = W * c
    g = torch.Generator(device="cuda").manual_seed(SEED)
    _build.library()
    out["ptxas"] = ptxas_report(_build.build_log)
    out["b1_sass"] = b1_sass_counts(str(_build.build()))
    sha = out["sha"] = {}
    src = torch.randn(W, c, device="cuda", generator=g)
    dst = torch.empty_like(src)
    out["copy"] = timed(time_ms(lambda: dst.copy_(src)), 8 * N)
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        a = torch.randn(W, c, device="cuda", generator=g).to(dt)
        b = torch.randn(W, c, device="cuda", generator=g).to(dt)
        ra, rb = list(a), list(b)
        fa, fb = a.view(-1), b.view(-1)
        sha[f"combine_sum_{name}"] = sha_of(combine(ra, rb, ReduceFunc.SUM))
        out[f"combine_sum_{name}"] = timed(
            time_ms(lambda: combine(ra, rb, ReduceFunc.SUM, out=ra)),
            3 * a.element_size() * N,
            time_ms(lambda: torch.add(fa, fb, out=fa)))
        if name == "f32":
            rd = list(dst)
            fd = dst.view(-1)
            out["combine_sum_f32_out"] = timed(
                time_ms(lambda: combine(ra, rb, ReduceFunc.SUM, out=rd)),
                3 * 4 * N, time_ms(lambda: torch.add(fa, fb, out=fd)))
        del a, b, ra, rb, fa, fb
    # B1 on fp8 payloads: random codes (NaN codes included), out of
    # place as the ring calls it; bound 3 bytes an element
    for dt, name in ((torch.float8_e4m3fn, "e4m3fn"),
                     (torch.float8_e5m2, "e5m2")):
        a, b = (torch.randint(0, 256, (W, c), dtype=torch.uint8,
                              device="cuda", generator=g).view(dt)
                for _ in range(2))
        ra, rb, ro = list(a), list(b), list(torch.empty_like(a))
        for func in ReduceFunc:
            key = f"combine_{func.name.lower()}_{name}"
            out[key] = timed(
                time_ms(lambda: combine(ra, rb, func, out=ro)), 3 * N)  # noqa: B023
            sha[key] = sha_of(ro)
        del a, b, ra, rb, ro
    rs = list(src)
    for wire, name in ((torch.float16, "f16"), (torch.bfloat16, "bf16"),
                       (torch.float8_e4m3fn, "e4m3")):
        nbytes = (4 + torch.empty((), dtype=wire).element_size()) * N
        low = torch.empty(W, c, dtype=wire, device="cuda")
        rl, rd = list(low), list(dst)
        out[f"cast_f32_{name}"] = timed(
            time_ms(lambda: C.cast(rs, wire, rl)), nbytes,
            time_ms(lambda: src.to(wire)))
        sha[f"cast_f32_{name}"] = sha_of(rl)
        out[f"cast_{name}_f32"] = timed(
            time_ms(lambda: C.cast(rl, torch.float32, rd)), nbytes,
            time_ms(lambda: low.to(torch.float32)))
        sha[f"cast_{name}_f32"] = sha_of(rd)
        del low, rl, rd
    wire, block = "float8_e4m3fn", 128
    nb = c // block
    rd = list(dst)
    sc = list(torch.empty(W, 1, device="cuda"))
    iv = list(torch.empty(W, 1, device="cuda"))
    q8 = list(torch.empty(W, c, dtype=torch.float8_e4m3fn, device="cuda"))
    out["fp8_scale"] = timed(time_ms(lambda: C.fp8_scale(rs, wire, sc, iv)),
                             4 * N + 8 * W)
    out["fp8_quant"] = timed(time_ms(lambda: C.fp8_quant(rs, iv, wire, q8)),
                             5 * N + 4 * W)
    out["fp8_dequant"] = timed(
        time_ms(lambda: C.fp8_dequant(q8, sc, wire, rd)), 5 * N + 4 * W)
    sha["fp8_dequant"] = sha_of(rd)
    q = list(torch.empty(W, c, dtype=torch.uint8, device="cuda"))
    s = list(torch.empty(W, nb, device="cuda"))
    q2 = list(torch.empty(W, c, dtype=torch.uint8, device="cuda"))
    s2 = list(torch.empty(W, nb, device="cuda"))
    other = list(torch.randn(W, c, device="cuda", generator=g))
    out["bs_quant"] = timed(
        time_ms(lambda: C.bs_quant(rs, wire, block, q, s)),
        5 * N + 4 * N // block)
    out["bs_dequant"] = timed(
        time_ms(lambda: C.bs_dequant(q, s, wire, block, rd)),
        5 * N + 4 * N // block)
    sha["bs_dequant"] = sha_of(rd)
    out["bs_combine"] = timed(
        time_ms(lambda: C.bs_combine(q, s, other, ReduceFunc.SUM, wire,
                                     block, q2, s2)),
        2 * (N + 4 * N // block) + 4 * N)
    sha["fp8_scale"] = sha_of(sc + iv)
    sha["fp8_quant"], sha["bs_quant"] = sha_of(q8), sha_of(q + s)
    sha["bs_combine"] = sha_of(q2 + s2)
    out["bs_combine_f32"] = timed(
        time_ms(lambda: C.bs_combine(q, s, other, ReduceFunc.SUM, wire,
                                     block, out=rd, requant=False)),
        9 * N + 4 * N // block)
    sha["bs_combine_f32"] = sha_of(rd)
    del src, dst, rs, rd, sc, iv, q8, q, s, q2, s2, other
    torch.cuda.empty_cache()


def model_part(out: dict) -> None:
    """B9, B12 decode and the 4x512 forward (module docstring)."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from accl_tpu_torch.models import Llama, LlamaConfig
    from accl_tpu_torch.ops import attention as A
    out["module"] = A.__file__
    g = torch.Generator(device="cuda").manual_seed(SEED)
    H, Hkv, D, B = 32, 8, 128, 4
    for S in (128, 512):
        q = torch.randn(B, H, S, D, device="cuda", generator=g).bfloat16()
        k, v = (torch.randn(B, Hkv, S, D, device="cuda", generator=g)
                .bfloat16() for _ in range(2))
        o = A.flash_attention_fwd(q, k, v, True)[0]
        err = float((o.float() - A.flash_attention_ref(q, k, v, True)[0]
                     .float()).abs().max())
        out[f"b9_s{S}"] = {"ms": time_ms(
            lambda: A.flash_attention_fwd(q, k, v, True)),  # noqa: B023
            "max_abs_err": err}
    T, kv_len = 4096, 2047
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn(B, H, 1, D, device="cuda", generator=g).to(dt)
        kc, vc = (torch.randn(B, T, Hkv, D, device="cuda", generator=g)
                  .to(dt) for _ in range(2))
        o = A.flash_decode(q, kc, vc, kv_len)
        err = float((o.float() - A.flash_decode_ref(q, kc, vc, kv_len)
                     .float()).abs().max())
        out[f"decode_{str(dt)[6:]}"] = {"ms": time_ms(
            lambda: A.flash_decode(q, kc, vc, kv_len)),  # noqa: B023
            "max_abs_err": err}
        del q, kc, vc
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              param_dtype=torch.bfloat16)
    model = Llama(cfg).init(torch.Generator(device="cuda").manual_seed(SEED))
    tokens = torch.randint(0, cfg.vocab_size, (B, 512), device="cuda",
                           generator=g)
    with torch.no_grad():
        before = A.fwd_single_launches
        model(tokens)
        torch.cuda.synchronize()
        launches = A.fwd_single_launches - before
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            model(tokens)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(tokens)
            torch.cuda.synchronize()
    kern = b9 = 0.0
    for ev in prof.events():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.is_user_annotation):
            continue
        ms = ev.time_range.elapsed_us() / 1e3
        kern += ms
        if "attn_fwd_single" in ev.name:
            b9 += ms
    out["forward_4x512"] = {"host_ms": statistics.median(ts),
                            "kernel_ms": kern, "b9_ms": b9,
                            "b9_launches": launches}


def bwd_part(out: dict) -> None:
    """B10, B11 and SDPA's backward at phase 8's shape (module
    docstring)."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)
    B, H, Hkv, S, D = 4, 32, 8, 2048, 128
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        q, do = (torch.randn(B, H, S, D, device="cuda", generator=g).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, Hkv, S, D, device="cuda", generator=g).to(dt)
                for _ in range(2))
        o, lse = A.flash_attention_fwd(q, k, v, True)
        delta = (do.float() * o.float()).sum(-1).reshape(B * H, S)
        args = (q, do, k, v, lse, delta, True, D ** -0.5)
        for key, fn, ref in (
                ("b10", A.flash_attention_bwd_dkv,
                 A.flash_attention_bwd_dkv_ref),
                ("b11", lambda *a: (A.flash_attention_bwd_dq(*a),),
                 lambda *a: (A.flash_attention_bwd_dq_ref(*a),))):
            got = fn(*args)
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, ref(*args)))
            out[f"{key}_{name}"] = {"ms": time_ms(
                lambda: fn(*args)), "max_abs_err": err,  # noqa: B023
                "sha256": sha_of(got)}
            del got
        out[f"pair_{name}_ms"] = (out[f"b10_{name}"]["ms"]
                                  + out[f"b11_{name}"]["ms"])
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                            enable_gqa=True)
        out[f"sdpa_bwd_{name}_ms"] = time_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True))  # noqa: B023
        del q, do, k, v, o, lse, delta, args, lq, lk, lv, lo
        torch.cuda.empty_cache()


def bwd_wide_part(out: dict) -> None:
    """The f32 B10 and B11 past head dim 256 and SDPA's f32 backward at
    phase 17a's shapes (module docstring)."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch import _build
    from accl_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)
    # the cluster form's size and occupancy, where the tree has one
    lib = _build.library()
    size = getattr(lib, "accl_attn_bwd_cluster_size", None)
    clusters = getattr(lib, "accl_attn_bwd_active_clusters", None)
    H, Hkv = 8, 1
    for D, S, B in BWD_WIDE_CASES:
        q, do = (torch.randn(B, H, S, D, device="cuda", generator=g)
                 for _ in range(2))
        k, v = (torch.randn(B, Hkv, S, D, device="cuda", generator=g)
                for _ in range(2))
        # O and the LSE from the plain forward, the same in every tree, so
        # that two trees' B10 and B11 take the same bits
        o, lse = A.flash_attention_ref(q, k, v, True)
        delta = (do * o).sum(-1).reshape(B * H, S)
        args = (q, do, k, v, lse, delta, True, D ** -0.5)
        visible = S * (S + 1) // 2 * B * H
        rec = {}
        for key, fn, ref, ops in (
                ("b10", A.flash_attention_bwd_dkv,
                 A.flash_attention_bwd_dkv_ref, 8),
                ("b11", lambda *a: (A.flash_attention_bwd_dq(*a),),
                 lambda *a: (A.flash_attention_bwd_dq_ref(*a),), 6)):
            got = fn(*args)
            err = max(float((a - b).abs().max())
                      for a, b in zip(got, ref(*args)))
            digest = hashlib.sha256()
            for t in got:
                digest.update(t.contiguous().view(torch.int32).cpu()
                              .numpy().tobytes())
            del got
            ms = time_ms(lambda: fn(*args), reps=5)  # noqa: B023
            bound = 3 * ops * D * visible / TF32_OPS_PER_S * 1e3
            rec[key] = {"ms": ms, "bound_ms": bound,
                        "pct_of_bound": 100 * bound / ms,
                        "max_abs_err": err,
                        "sha256": digest.hexdigest()[:16]}
            torch.cuda.empty_cache()
        rec["pair_ms"] = rec["b10"]["ms"] + rec["b11"]["ms"]
        rec["plain_pair_ms"] = time_ms(lambda: (  # noqa: B023
            A.flash_attention_bwd_dkv_ref(*args),  # noqa: B023
            A.flash_attention_bwd_dq_ref(*args)), reps=3)  # noqa: B023
        torch.cuda.empty_cache()
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                            enable_gqa=True)
        rec["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True), reps=5)  # noqa: B023
        rec["pair_vs_sdpa"] = rec["pair_ms"] / rec["sdpa_bwd_ms"]
        if size is not None and clusters is not None and size(D) > 0:
            n = clusters(1, D)
            rec["active_clusters"] = n
            rec["sms_in_clusters"] = n * size(D)
            rec["cluster_size"] = size(D)
        code = lib.accl_attn_last_route()
        rec["route"] = f"{A.ROUTES.get(code >> 16, code >> 16)}/{code & 0xFFF}"
        out[f"d{D}_s{S}" + ("" if B == 4 else f"_b{B}")] = rec
        del q, do, k, v, o, lse, delta, args, lq, lk, lv, lo
        torch.cuda.empty_cache()
    band_measure(out, g)


def band_measure(out: dict, g) -> None:
    """The f32 B10 and B11 on the band form through the tree's measurement
    entry points (``accl_attn_bwd_{dkv,dq}_band``), where it has them, at
    ``BAND_MEASURE_DIMS`` (B 4, H 8/1, S 1024, causal; the cluster form's
    shapes): each the median device time of 5 launches, the largest
    error against the plain version and a SHA-256 of the outputs."""
    import torch
    from accl_tpu_torch import _build
    from accl_tpu_torch.ops import attention as A
    lib = _build.library()
    hooks = (getattr(lib, "accl_attn_bwd_dkv_band", None),
             getattr(lib, "accl_attn_bwd_dq_band", None))
    if None in hooks:
        return
    B, H, Hkv, S = 4, 8, 1, 1024
    for D in BAND_MEASURE_DIMS:
        q, do = (torch.randn(B, H, S, D, device="cuda", generator=g)
                 for _ in range(2))
        k, v = (torch.randn(B, Hkv, S, D, device="cuda", generator=g)
                for _ in range(2))
        o, lse = A.flash_attention_ref(q, k, v, True)
        delta = (do * o).sum(-1).reshape(B * H, S)
        args = (q, do, k, v, lse, delta, True, D ** -0.5)
        st = _build.stream_of(q)
        rec = {}
        for key, hook, dkv, ref in (
                ("b10", hooks[0], True, A.flash_attention_bwd_dkv_ref),
                ("b11", hooks[1], False,
                 lambda *a: (A.flash_attention_bwd_dq_ref(*a),))):
            ws = torch.empty(A.band_workspace_floats(dkv, B, H, S, S, D),
                             device="cuda")
            outs = ((torch.empty(B * H, S, D, device="cuda"),
                     torch.empty(B * H, S, D, device="cuda")) if dkv
                    else (torch.empty_like(q),))

            def fn():
                _build.check(hook(  # noqa: B023
                    0, D, q.data_ptr(), do.data_ptr(), k.data_ptr(),
                    v.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    *(t.data_ptr() for t in outs), ws.data_ptr(),  # noqa: B023
                    B, H, Hkv, S, S, 1, D ** -0.5, st), key)  # noqa: B023
                return outs  # noqa: B023
            got = fn()
            err = max(float((a - b).abs().max())
                      for a, b in zip(got, ref(*args)))
            rec[key] = {"ms": time_ms(fn, reps=5), "max_abs_err": err,
                        "sha256": sha_of(got)}
            del ws, outs, got
            torch.cuda.empty_cache()
        rec["pair_ms"] = rec["b10"]["ms"] + rec["b11"]["ms"]
        out[f"band_d{D}_s{S}"] = rec
        del q, do, k, v, o, lse, delta, args
        torch.cuda.empty_cache()


def fwd32_part(out: dict) -> None:
    """The forward's f32 route beside SDPA, the bf16 routes and decode
    as controls (module docstring)."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)
    B, H, Hkv, D = 4, 32, 8, 128

    def err_of(got, want) -> float:
        return float((got.float() - want.float()).abs().max())

    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        for key, S in (("b9_s128", 128), ("b9_s512", 512), ("b8_s2048", 2048)):
            q = torch.randn(B, H, S, D, device="cuda", generator=g).to(dt)
            k, v = (torch.randn(B, Hkv, S, D, device="cuda", generator=g)
                    .to(dt) for _ in range(2))
            o, lse = A.flash_attention_fwd(q, k, v, True)
            ro, rl = A.flash_attention_ref(q, k, v, True)
            rec = {"ms": time_ms(lambda: A.flash_attention_fwd(
                q, k, v, True)),  # noqa: B023
                "max_abs_err": max(err_of(o, ro), err_of(lse, rl)),
                "sha256": sha_of((o, lse))}
            if dt == torch.float32:
                rec["sdpa_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(  # noqa: B023
                        q, k, v, is_causal=True, enable_gqa=True))
            out[f"{key}_{name}"] = rec
            del q, k, v, o, lse, ro, rl
        for key, s_new, T, kv_len in (("prefill_1024", 1024, 1024, 1024),
                                      ("decode_2047", 1, 4096, 2047)):
            q = torch.randn(B, H, s_new, D, device="cuda", generator=g).to(dt)
            kc, vc = (torch.randn(B, T, Hkv, D, device="cuda", generator=g)
                      .to(dt) for _ in range(2))
            o = A.flash_decode(q, kc, vc, kv_len)
            rec = {"ms": time_ms(lambda: A.flash_decode(
                q, kc, vc, kv_len)),  # noqa: B023
                "max_abs_err": err_of(o, A.flash_decode_ref(q, kc, vc,
                                                            kv_len)),
                "sha256": sha_of((o,))}
            if dt == torch.float32 and s_new > 1:
                kt, vt = A.cache_prefix(kc, vc, kv_len)
                rec["sdpa_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(  # noqa: B023
                        q, kt, vt, is_causal=True, enable_gqa=True))
            out[f"{key}_{name}"] = rec
            del q, kc, vc, o
        torch.cuda.empty_cache()


def fwd_wide_part(out: dict) -> None:
    """The f32 forward past head dim 256 (B8, B9, the B12 prefill and
    decode) and SDPA's f32 forward at phase 17a's shapes (module
    docstring)."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch import _build
    from accl_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)
    lib = _build.library()
    size = getattr(lib, "accl_attn_bwd_cluster_size", None)
    H, Hkv = 8, 1
    for name, kind, D, sq, kv, T, B in FWD_WIDE_CASES:
        q = torch.randn(B, H, sq, D, device="cuda", generator=g)
        if T is None:                         # B8 (block_k 16) and B9
            k, v = (torch.randn(B, Hkv, kv, D, device="cuda", generator=g)
                    for _ in range(2))
            bk = 16 if kind == "fwd" else None
            assert A.is_single_block(kv, bk) == (kind == "fwd_single")
            fn = lambda: A.flash_attention_fwd(  # noqa: E731
                q, k, v, True, block_k=bk)  # noqa: B023
            ref = lambda: A.flash_attention_ref(q, k, v, True)  # noqa
            lib_call = lambda: F.scaled_dot_product_attention(  # noqa
                q, k, v, is_causal=True, enable_gqa=True)
            visible = sq * (sq + 1) // 2 * B * H
        else:                                 # B12 over a (B, T, Hkv) cache
            kc, vc = (torch.randn(B, T, Hkv, D, device="cuda", generator=g)
                      for _ in range(2))
            fn = lambda: A.flash_decode(q, kc, vc, kv)  # noqa
            ref = lambda: A.flash_decode_ref(q, kc, vc, kv)  # noqa
            kt, vt = A.cache_prefix(kc, vc, kv)
            lib_call = lambda: F.scaled_dot_product_attention(  # noqa
                q, kt, vt, is_causal=sq > 1, enable_gqa=True)  # noqa: B023
            # query i of the S_new sees kv - S_new + i + 1 keys
            visible = (sq * (kv - sq) + sq * (sq + 1) // 2) * B * H
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        want = ref()
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        digest = hashlib.sha256()
        for t in got:
            digest.update(t.contiguous().view(torch.int32).cpu().numpy()
                          .tobytes())
        del got, want
        ms = time_ms(fn, reps=5 if kind != "decode" else 20)
        ops = 4 * D * visible
        if kind == "decode":       # bytes: the filled prefix of K and V
            bound = 2 * B * Hkv * kv * D * 4 / HBM_BYTES_PER_S * 1e3
        else:                      # three TF32 products an operation
            bound = 3 * ops / TF32_OPS_PER_S * 1e3
        rec = {"ms": ms, "bound_ms": bound, "pct_of_bound": 100 * bound / ms,
               "max_abs_err": err, "sha256": digest.hexdigest()[:16],
               "route": A.ROUTES.get(lib.accl_attn_last_route() >> 16),
               "tier": lib.accl_attn_last_route() & 0xFFF}
        rec["plain_ms"] = time_ms(ref, reps=3)
        rec["sdpa_ms"] = time_ms(lib_call, reps=5 if kind != "decode"
                                 else 20)
        rec["vs_sdpa"] = ms / rec["sdpa_ms"]
        if kind != "decode" and size is not None and size(D) > 0:
            rec["cluster_size"] = size(D)   # the forward's as B10's
        out[name] = rec
        del q, fn, ref, lib_call
        torch.cuda.empty_cache()
    fwd_band_measure(out, g)


def fwd_band_measure(out: dict, g) -> None:
    """The f32 B8 on the band form through the tree's measurement entry
    point (``accl_attn_fwd_band``), where it has one, at
    ``FWD_BAND_MEASURE_DIMS`` (B 4, H 8/1, S 1024, causal), beside the
    dispatch's cluster form on the same inputs: each the median device
    time of 5 launches, the band form's largest error against the plain
    version and a SHA-256 of its outputs."""
    import torch
    from accl_tpu_torch import _build
    from accl_tpu_torch.ops import attention as A
    lib = _build.library()
    hook = getattr(lib, "accl_attn_fwd_band", None)
    if hook is None:
        return
    B, H, Hkv, S = 4, 8, 1, 1024
    for D in FWD_BAND_MEASURE_DIMS:
        q = torch.randn(B, H, S, D, device="cuda", generator=g)
        k, v = (torch.randn(B, Hkv, S, D, device="cuda", generator=g)
                for _ in range(2))
        ws = torch.empty(A.fwd_band_workspace_floats(B * H, S, S, D),
                         device="cuda")
        o = torch.empty_like(q)
        lse = torch.empty(B * H, S, device="cuda")
        st = _build.stream_of(q)

        def fn():
            _build.check(hook(0, D, q.data_ptr(), k.data_ptr(),  # noqa: B023
                              v.data_ptr(), o.data_ptr(),  # noqa: B023
                              lse.data_ptr(), ws.data_ptr(),  # noqa: B023
                              B, H, Hkv, S, S, 1, D ** -0.5, st),  # noqa: B023
                         "band forward")
            return o, lse  # noqa: B023
        got = fn()
        code = lib.accl_attn_last_route()
        ro, rl = A.flash_attention_ref(q, k, v, True)
        rec = {"ms": time_ms(fn, reps=5),
               "max_abs_err": max(float((got[0] - ro).abs().max()),
                                  float((got[1] - rl).abs().max())),
               "sha256": sha_of(got),
               "route": f"{A.ROUTES.get(code >> 16)}/{code & 0xFFF}"}
        rec["cluster_ms"] = time_ms(lambda: A.flash_attention_fwd(  # noqa
            q, k, v, True, block_k=16), reps=5)  # noqa: B023
        code = lib.accl_attn_last_route()
        rec["cluster_route"] = f"{A.ROUTES.get(code >> 16)}/{code & 0xFFF}"
        rec["band_vs_cluster"] = rec["ms"] / rec["cluster_ms"]
        out[f"band_d{D}_s{S}"] = rec
        del q, k, v, ws, o, lse, got, ro, rl
        torch.cuda.empty_cache()


# the wide16 part's calls, bf16, H 8, Hkv 1: (name, kind, D, S or S_new,
# kv length, cache T, B)
WIDE16_CASES = (
    ("b8_d264_s2048", "fwd", 264, 2048, 2048, None, 4),
    ("b8_d512_s2048", "fwd", 512, 2048, 2048, None, 4),
    ("b8_d1024_s1024", "fwd", 1024, 1024, 1024, None, 4),
    ("b8_d2048_s1024", "fwd", 2048, 1024, 1024, None, 4),
    ("b9_d264_s512", "fwd_single", 264, 512, 512, None, 4),
    ("b9_d512_s512", "fwd_single", 512, 512, 512, None, 4),
    ("prefill_d264_s1024", "prefill", 264, 1024, 1024, 1024, 4),
    ("prefill_d512_s1024", "prefill", 512, 1024, 1024, 1024, 4),
    ("llama_d512_b8_s2048", "fwd", 512, 2048, 2048, None, 1),
    ("llama_d512_b9_s512", "fwd_single", 512, 512, 512, None, 1),
    ("llama_d512_prefill_s2048", "prefill", 512, 2048, 2048, 2064, 1),
    ("bwd_d264_s2048", "bwd", 264, 2048, 2048, None, 4),
    ("bwd_d512_s2048", "bwd", 512, 2048, 2048, None, 4),
    ("bwd_d1024_s1024", "bwd", 1024, 1024, 1024, None, 4),
    ("bwd_d2048_s1024", "bwd", 2048, 1024, 1024, None, 4),
    ("llama_d512_bwd_s2048", "bwd", 512, 2048, 2048, None, 1),
    ("decode_d264_kv2047", "decode", 264, 1, 2047, 4096, 4),
    ("decode_d512_kv2047", "decode", 512, 1, 2047, 4096, 4),
    ("decode_d1024_kv1023", "decode", 1024, 1, 1023, 1024, 4),
    ("decode_d2048_kv1023", "decode", 2048, 1, 1023, 1024, 4),
    ("llama_d512_decode_kv2063", "decode", 512, 1, 2063, 2064, 1))


def wide16_part(out: dict) -> None:
    """The bf16 B8, B9, B12, B10 and B11 past head dim 256 (module
    docstring)."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch import _build
    from accl_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(SEED)
    lib = _build.library()
    clusters = getattr(lib, "accl_attn_bwd_dkv16_active_clusters", None)
    fwd_clusters = getattr(lib, "accl_attn_fwd16_active_clusters", None)
    dq_clusters = getattr(lib, "accl_attn_bwd_dq16_active_clusters", None)
    dt, H, Hkv = torch.bfloat16, 8, 1

    def digest_of(ts) -> str:
        d = hashlib.sha256()
        for t in ts:
            d.update(t.contiguous().view(torch.int16 if t.element_size() == 2
                                         else torch.int32).cpu().numpy()
                     .tobytes())
        return d.hexdigest()[:16]

    def route() -> str:
        code = lib.accl_attn_last_route()
        return f"{A.ROUTES.get(code >> 16, code >> 16)}/{code & 0xFFF}"

    def active(fn, D) -> dict:
        """The clusters of a 16-bit cluster form the card holds at D (a
        multiple of 128), where the tree has that form."""
        n = fn(-(-D // 128) * 128) if fn is not None else 0
        return {"active_clusters": n} if n > 0 else {}

    for name, kind, D, sq, kv, T, B in WIDE16_CASES:
        q = torch.randn(B, H, sq, D, device="cuda", generator=g).to(dt)
        rec = {}
        if kind in ("fwd", "fwd_single", "prefill"):
            if T is None:                     # B8 (block_k 16) and B9
                k, v = (torch.randn(B, Hkv, kv, D, device="cuda",
                                    generator=g).to(dt) for _ in range(2))
                bk = 16 if kind == "fwd" else None
                assert A.is_single_block(kv, bk) == (kind == "fwd_single")
                fn = lambda: A.flash_attention_fwd(  # noqa: E731
                    q, k, v, True, block_k=bk)  # noqa: B023
                ref = lambda: A.flash_attention_ref(q, k, v, True)  # noqa
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa
                    q, k, v, is_causal=True, enable_gqa=True)
                visible = sq * (sq + 1) // 2 * B * H
            else:                             # a B12 chunk over the cache
                kc, vc = (torch.randn(B, T, Hkv, D, device="cuda",
                                      generator=g).to(dt) for _ in range(2))
                fn = lambda: (A.flash_decode(q, kc, vc, kv),)  # noqa
                ref = lambda: (A.flash_decode_ref(q, kc, vc, kv),)  # noqa
                kt, vt = A.cache_prefix(kc, vc, kv)
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa
                    q, kt, vt, is_causal=True, enable_gqa=True)  # noqa: B023
                visible = (sq * (kv - sq) + sq * (sq + 1) // 2) * B * H
            got = fn()
            r = route()
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, ref()))
            sha = digest_of(got)
            del got
            ms = time_ms(fn, reps=5)
            bound = 4 * D * visible / BF16_OPS_PER_S * 1e3
            rec = {"ms": ms, "bound_ms": bound,
                   "pct_of_bound": 100 * bound / ms, "route": r,
                   "max_abs_err": err, "sha256": sha,
                   "plain_ms": time_ms(ref, reps=3),
                   "sdpa_ms": time_ms(sdpa, reps=5),
                   **(active(fwd_clusters, D) if "cluster" in r else {})}
            rec["vs_sdpa"] = ms / rec["sdpa_ms"]
            out[name] = rec
            del q, fn, ref, sdpa
            torch.cuda.empty_cache()
            continue
        if kind == "bwd":
            do = torch.randn(q.shape, device="cuda", generator=g).to(dt)
            k, v = (torch.randn(B, Hkv, kv, D, device="cuda", generator=g)
                    .to(dt) for _ in range(2))
            # O and the LSE from the plain forward, the same in every tree
            o, lse = A.flash_attention_ref(q, k, v, True)
            delta = (do.float() * o.float()).sum(-1).reshape(B * H, sq)
            args = (q, do, k, v, lse, delta, True, D ** -0.5)
            visible = sq * (sq + 1) // 2 * B * H
            for key, fn, ref, ops in (
                    ("b10", A.flash_attention_bwd_dkv,
                     A.flash_attention_bwd_dkv_ref, 8),
                    ("b11", lambda *a: (A.flash_attention_bwd_dq(*a),),
                     lambda *a: (A.flash_attention_bwd_dq_ref(*a),), 6)):
                got = fn(*args)
                r = route()
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, ref(*args)))
                sha = digest_of(got)
                del got
                ms = time_ms(lambda: fn(*args), reps=5)  # noqa: B023
                bound = ops * D * visible / BF16_OPS_PER_S * 1e3
                rec[key] = {"ms": ms, "bound_ms": bound,
                            "pct_of_bound": 100 * bound / ms, "route": r,
                            "max_abs_err": err, "sha256": sha,
                            "plain_ms": time_ms(lambda: ref(*args),  # noqa: B023
                                                reps=3)}
                if key == "b11" and "cluster" in r:
                    rec[key].update(active(dq_clusters, D))
                torch.cuda.empty_cache()
            rec["pair_ms"] = rec["b10"]["ms"] + rec["b11"]["ms"]
            lq, lk, lv = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                                enable_gqa=True)
            rec["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                lo, (lq, lk, lv), do, retain_graph=True), reps=5)  # noqa: B023
            rec["pair_vs_sdpa"] = rec["pair_ms"] / rec["sdpa_bwd_ms"]
            if clusters is not None:
                n = clusters(-(-D // 128) * 128)
                if n > 0:
                    rec["active_clusters"] = n
                    rec["cluster_size"] = -(-D // 128)
            del do, k, v, o, lse, delta, args, lq, lk, lv, lo
        else:
            kc, vc = (torch.randn(B, T, Hkv, D, device="cuda", generator=g)
                      .to(dt) for _ in range(2))
            got = A.flash_decode(q, kc, vc, kv)
            r = route()
            err = float((got.float() - A.flash_decode_ref(q, kc, vc, kv)
                         .float()).abs().max())
            sha = digest_of((got,))
            ms = time_ms(lambda: A.flash_decode(q, kc, vc, kv))  # noqa: B023
            bound = 2 * B * Hkv * kv * D * 2 / HBM_BYTES_PER_S * 1e3
            kt, vt = A.cache_prefix(kc, vc, kv)
            rec = {"ms": ms, "bound_ms": bound,
                   "pct_of_bound": 100 * bound / ms, "route": r,
                   "max_abs_err": err, "sha256": sha,
                   "plain_ms": time_ms(lambda: A.flash_decode_ref(  # noqa: B023
                       q, kc, vc, kv), reps=3),  # noqa: B023
                   "sdpa_ms": time_ms(lambda: F.scaled_dot_product_attention(  # noqa: B023
                       q, kt, vt, enable_gqa=True))}  # noqa: B023
            rec["vs_sdpa"] = ms / rec["sdpa_ms"]
            del kc, vc, got, kt, vt
        out[name] = rec
        del q
        torch.cuda.empty_cache()


# the band16 part's calls, bf16, H 8, Hkv 1, causal: (name, kind, D, S, B):
# the head dims past 256 where the dispatch keeps the column groups
BAND16_CASES = (
    ("b8_d640_s1024", "fwd", 640, 1024, 4),
    ("b8_d768_s1024", "fwd", 768, 1024, 4),
    ("b9_d264_s512", "fwd_single", 264, 512, 4),
    ("b11_d264_s2048", "bwd_dq", 264, 2048, 4),
    ("b11_d512_s2048", "bwd_dq", 512, 2048, 4),
    ("b11_d640_s1024", "bwd_dq", 640, 1024, 4),
    ("llama_d512_b11_s2048", "bwd_dq", 512, 2048, 1))


def band16_part(out: dict) -> None:
    """The 16-bit B8, B9 and B11 at the head dims past 256 where the
    dispatch keeps the column groups (module docstring): a tree with the
    cluster forms' measurement entry points (``accl_attn_fwd16_cluster``,
    ``accl_attn_bwd_dq16_cluster``) runs the cluster form there, any
    other tree its wrapper's route; each the median device time of 5
    launches behind the GPU sleep, the route and the largest error
    against the plain version."""
    import torch
    from accl_tpu_torch import _build
    from accl_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(SEED)
    lib = _build.library()
    fwd_hook = getattr(lib, "accl_attn_fwd16_cluster", None)
    dq_hook = getattr(lib, "accl_attn_bwd_dq16_cluster", None)
    dt, H, Hkv = torch.bfloat16, 8, 1
    for name, kind, D, S, B in BAND16_CASES:
        q, do = (torch.randn(B, H, S, D, device="cuda", generator=g).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, Hkv, S, D, device="cuda", generator=g).to(dt)
                for _ in range(2))
        st = _build.stream_of(q)
        # the entry points' calls do the wrapper's work too: the padding of
        # D to a multiple of 128 and the outputs sliced back
        if kind != "bwd_dq":
            bk = 16 if kind == "fwd" else None

            def fn():
                if fwd_hook is None:
                    return A.flash_attention_fwd(q, k, v, True, block_k=bk)
                qp, kp, vp = A._pad_d(q, k, v)
                o = torch.empty_like(qp)
                lse = torch.empty(B * H, S, dtype=torch.float32,
                                  device="cuda")
                _build.check(fwd_hook(
                    1, qp.shape[-1], qp.data_ptr(), kp.data_ptr(),
                    vp.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H, Hkv,
                    S, S, 1, D ** -0.5, st), name)
                return (o if o.shape[-1] == D
                        else o[..., :D].contiguous()), lse
            got = fn()[0]
            want = A.flash_attention_ref(q, k, v, True)[0]
        else:
            _o, rl = A.flash_attention_ref(q, k, v, True)
            delta = (do.float() * _o.float()).sum(-1).reshape(B * H, S)
            args = (q, do, k, v, rl, delta, True, D ** -0.5)

            def fn():
                if dq_hook is None:
                    return A.flash_attention_bwd_dq(*args)
                qp, dop, kp, vp = A._pad_d(q, do, k, v)
                dq = torch.empty_like(qp)
                _build.check(dq_hook(
                    1, qp.shape[-1], qp.data_ptr(), dop.data_ptr(),
                    kp.data_ptr(), vp.data_ptr(), rl.data_ptr(),
                    delta.data_ptr(), dq.data_ptr(), B, H, Hkv, S, S, 1,
                    D ** -0.5, st), name)
                return dq if dq.shape[-1] == D else dq[..., :D].contiguous()
            got = fn()
            want = A.flash_attention_bwd_dq_ref(*args)
        code = lib.accl_attn_last_route()
        out[name] = {"ms": time_ms(fn, reps=5),
                     "route": f"{A.ROUTES.get(code >> 16, code >> 16)}/"
                              f"{code & 0xFFF}",
                     "max_abs_err": float((got.float() - want.float())
                                          .abs().max())}
        del q, do, k, v, got, want
        torch.cuda.empty_cache()


def one(tree: str, part: str) -> dict:
    """The measurements of one tree's port (in this process)."""
    sys.path.insert(0, os.path.abspath(tree))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out = {"tree": tree, "card": smi.stdout.strip().splitlines()[0]}
    if part in ("all", "stream"):
        stream_part(out)
    if part in ("all", "model"):
        model_part(out)
    if part in ("all", "bwd"):
        bwd_part(out)
    if part == "bwd_wide":
        bwd_wide_part(out)
    if part == "fwd32":
        fwd32_part(out)
    if part == "fwd_wide":
        fwd_wide_part(out)
    if part == "wide16":
        wide16_part(out)
    if part == "band16":
        band16_part(out)
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_compare: CUDA is not available", file=sys.stderr)
        return 1
    part = "all"
    if argv[:1] == ["--part"]:
        part, argv = argv[1], argv[2:]
    if part not in PARTS:
        print(f"chip_compare: --part is one of {PARTS}", file=sys.stderr)
        return 2
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1], part)))
        return 0
    for tree in argv or ["."]:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--part", part, "--one", tree],
                             capture_output=True, text=True)
        print(run.stdout, end="")
        if run.returncode:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
