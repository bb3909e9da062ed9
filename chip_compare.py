#!/usr/bin/env python3
"""Compare checkouts of the port on one card: B9, B12 decode and the
32-layer Llama-3-8B forward on 4x512 tokens (the serving path's B9 call).

Run from the root of a checkout:  python3 chip_compare.py [TREE ...]

Each TREE is the root of a checkout of this repository (default: this
one). Each runs in a process of its own, in the order given, so that
``python3 chip_compare.py old . . old`` times two versions in turns on
one card. A process imports that tree's ``accl_tpu_torch`` (building its
kernels into that tree's ``build/``) and prints one JSON line with the
card's name and power limit and:

- B9 (``flash_attention_fwd``, bf16, causal, one key block; H=32,
  Hkv=8, D=128) at B=4, S=128 and S=512, and B12 single-token decode
  (``flash_decode``, bf16 and f32) at B=4, kv_len 2047 of T=4096: the
  median device time of 20 launches on CUDA events after warm-up, and
  the largest error against the plain version on the same inputs;
- the 32-layer bf16 Llama-3-8B ``forward`` (random weights from a seed)
  on 4x512 random tokens, which runs B9 once per layer: host-clock ms
  (median of 3 after one warm-up), then one more call under
  torch.profiler: its kernel time, and B9's share of it.

It uses only the entry points every version of the port has, and it
needs CUDA: without it, it exits with 1 and prints nothing.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

SEED = 20261017


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


def one(tree: str) -> dict:
    """The measurements of one tree's port (in this process)."""
    sys.path.insert(0, os.path.abspath(tree))
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from accl_tpu_torch.models import Llama, LlamaConfig
    from accl_tpu_torch.ops import attention as A
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out = {"tree": tree, "card": smi.stdout.strip().splitlines()[0],
           "module": A.__file__}
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
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_compare: CUDA is not available", file=sys.stderr)
        return 1
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])))
        return 0
    for tree in argv or ["."]:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree], capture_output=True, text=True)
        print(run.stdout, end="")
        if run.returncode:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
