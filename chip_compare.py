#!/usr/bin/env python3
"""Compare checkouts of the port on one card: the stream kernels B1-B7,
B9, B12 decode and the 32-layer Llama-3-8B forward on 4x512 tokens (the
serving path's B9 call).

Run from the root of a checkout:

    python3 chip_compare.py [--part all|stream|model] [TREE ...]

``--part stream`` times the stream kernels only (no model is built);
``--part model`` B9, decode and the forward only; the default is both.

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
  ``torch.add(a, b, out=o)``); B2 ``cast`` in
  six directions (f32 <-> f16, bf16, e4m3fn) beside ``.to(dtype)`` on
  the same rows; B3 (``fp8_scale``, its amax step, and ``fp8_quant``),
  B4 ``fp8_dequant``, B5 ``bs_quant``, B6 ``bs_dequant`` and B7
  ``bs_combine`` (e4m3fn, block 128, SUM) in its requant mode (a middle
  hop) and its round-closing mode (``bs_combine_f32``, f32 out, bound
  9 bytes an element plus scales); and ``dst.copy_(src)`` over the
  same 8 x 8 Mi f32, the stream rate the card reaches on a plain copy.
  Each is the median device time of 20 launches behind the GPU sleep,
  beside its bound (the bytes it must move over 3.35 TB/s). The ptxas
  report of the B1, B2 and B7 kernels is printed from the build log;
- B9 (``flash_attention_fwd``, bf16, causal, one key block; H=32,
  Hkv=8, D=128) at B=4, S=128 and S=512, and B12 single-token decode
  (``flash_decode``, bf16 and f32) at B=4, kv_len 2047 of T=4096: the
  median device time of 20 launches on CUDA events after warm-up, and
  the largest error against the plain version on the same inputs;
- the 32-layer bf16 Llama-3-8B ``forward`` (random weights from a seed)
  on 4x512 random tokens, which runs B9 once per layer: host-clock ms
  (median of 3 after one warm-up), then one more call under
  torch.profiler: its kernel time, and B9's share of it.

It uses only the entry points every version of the port has
(``ops.combine.combine``, ``ops.compression.cast``, ``fp8_scale``,
``fp8_quant``, ``fp8_dequant``, ``bs_quant``, ``bs_dequant``,
``bs_combine``, ``ops.attention``, ``models.Llama``), and it needs CUDA:
without it, it exits with 1 and prints nothing.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

SEED = 20261017
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
PARTS = ("all", "stream", "model")


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
    src = torch.randn(W, c, device="cuda", generator=g)
    dst = torch.empty_like(src)
    out["copy"] = timed(time_ms(lambda: dst.copy_(src)), 8 * N)
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        a = torch.randn(W, c, device="cuda", generator=g).to(dt)
        b = torch.randn(W, c, device="cuda", generator=g).to(dt)
        ra, rb = list(a), list(b)
        fa, fb = a.view(-1), b.view(-1)
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
    rs = list(src)
    for wire, name in ((torch.float16, "f16"), (torch.bfloat16, "bf16"),
                       (torch.float8_e4m3fn, "e4m3")):
        nbytes = (4 + torch.empty((), dtype=wire).element_size()) * N
        low = torch.empty(W, c, dtype=wire, device="cuda")
        rl, rd = list(low), list(dst)
        out[f"cast_f32_{name}"] = timed(
            time_ms(lambda: C.cast(rs, wire, rl)), nbytes,
            time_ms(lambda: src.to(wire)))
        out[f"cast_{name}_f32"] = timed(
            time_ms(lambda: C.cast(rl, torch.float32, rd)), nbytes,
            time_ms(lambda: low.to(torch.float32)))
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
    out["bs_combine"] = timed(
        time_ms(lambda: C.bs_combine(q, s, other, ReduceFunc.SUM, wire,
                                     block, q2, s2)),
        2 * (N + 4 * N // block) + 4 * N)
    out["bs_combine_f32"] = timed(
        time_ms(lambda: C.bs_combine(q, s, other, ReduceFunc.SUM, wire,
                                     block, out=rd, requant=False)),
        9 * N + 4 * N // block)
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
