"""Build and load the package's CUDA kernels.

The kernels in ``csrc/*.cu`` compile with ``nvcc`` into one shared
library with a plain C interface, loaded with ``ctypes``. The build
runs at first use (never at import: a machine without ``nvcc`` imports
the package and uses the plain versions on CPU tensors), into
``build/accl_tpu_torch/`` at the repository root, keyed by a hash of
the sources and flags: an edited source rebuilds, an unchanged one
loads the existing library. Each source compiles in its own ``nvcc``
process, all started together, then one link step.

Flags: ``sm_90a``, ``-O3``, ``--fmad=false`` (no multiply-add
contraction; the codec must match the reference bit for bit), no
``--use_fast_math``, so divisions are IEEE and denormals are kept.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "accl_tpu_torch"

ARCH = "-gencode=arch=compute_90a,code=sm_90a"
CFLAGS = [ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None   # wall time of the last build (None: loaded)
build_log = ""                       # nvcc's messages (-Xptxas -v) of the build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "accl_combine": [_I, _I, _I, _L, _P, _P, _P, _P],
    "accl_bs_quant": [_I, _I, _I, _L, _P, _P, _P, _P],
    "accl_bs_dequant": [_I, _I, _I, _L, _P, _P, _P, _P],
    "accl_bs_combine": [_I, _I, _I, _I, _I, _L, _P, _P, _P, _P, _P, _P,
                        _P],
    "accl_cast": [_I, _I, _I, _L, _P, _P, _P],
    "accl_fp8_scale": [_I, _I, _L, _P, _P, _P, _P, _P],
    "accl_fp8_quant": [_I, _I, _L, _P, _P, _P, _P],
    "accl_fp8_dequant": [_I, _I, _L, _P, _P, _P, _P],
    # dtype, head_dim, q, k, v, o, lse, workspace, B, H, Hkv, Sq, Skv,
    # causal, scale, stream
    "accl_attn_fwd": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _F, _P],
    "accl_attn_fwd_single": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _F, _P],
    # the f32 B8 on the band form at any head dim past 256 (measurements
    # beside the dispatch's choice): as accl_attn_fwd
    "accl_attn_fwd_band": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _F, _P],
    # dtype, head_dim, q, k_cache, v_cache, o, workspace, counters, B, H,
    # Hkv, T, s_new, kv_len, n_split, scale, stream
    "accl_attn_decode": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _F, _P],
    # dtype, head_dim, q, dout, k, v, lse, delta, dk, dv, workspace, B, H,
    # Hkv, Sq, Skv, causal, scale, stream
    "accl_attn_bwd_dkv": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _I, _I, _F, _P],
    # dtype, head_dim, q, dout, k, v, lse, delta, dq, workspace, B, H, Hkv,
    # Sq, Skv, causal, scale, stream
    "accl_attn_bwd_dq": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _F, _P],
    # the f32 B10 and B11 on the band form at any head dim past 256
    # (measurements beside the dispatch's choice): as the two above
    "accl_attn_bwd_dkv_band": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _F, _P],
    "accl_attn_bwd_dq_band": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _I, _I, _F, _P],
    # the route the last attention launch took (kind << 16 | dtype << 12 |
    # column tier)
    "accl_attn_last_route": [],
    # head_dim: the blocks of the f32 backward's clusters (0: no clusters)
    "accl_attn_bwd_cluster_size": [_I],
    # dkv, head_dim: the f32 backward's clusters the card holds at once
    "accl_attn_bwd_active_clusters": [_I, _I],
    # head_dim: the 16-bit B10's, forward's and B11's clusters the card
    # holds at once
    "accl_attn_bwd_dkv16_active_clusters": [_I],
    "accl_attn_fwd16_active_clusters": [_I],
    "accl_attn_bwd_dq16_active_clusters": [_I],
    # the 16-bit B8 and B11 on their cluster forms at any head dim of the
    # forms' range (measurements beside the dispatch's choice): as
    # accl_attn_fwd without the workspace, and accl_attn_bwd_dq
    "accl_attn_fwd16_cluster": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _F, _P],
    "accl_attn_bwd_dq16_cluster": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                   _I, _I, _I, _I, _I, _F, _P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Start every command at once, wait for all; raise on any failure,
    with the output of every command that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [f"{' '.join(c)}\n{o}" for c, p, o in zip(cmds, procs, outs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return "".join(outs)


def build() -> Path:
    """Compile the library if the current sources have none; return its
    path."""
    global build_seconds, build_log
    out_dir = BUILD_DIR / _digest()
    lib = out_dir / "libaccl_kernels.so"
    if lib.exists():
        log = out_dir / "build.log"
        if not build_log and log.exists():
            build_log = log.read_text()
        return lib
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    objs = [out_dir / (src.stem + ".o") for src in _sources()]
    log = _run_all([[nvcc, *CFLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
                     str(obj)] for src, obj in zip(_sources(), objs)])
    tmp = out_dir / f"libaccl_kernels.{os.getpid()}.so"
    log += _run_all([[nvcc, ARCH, "-shared", "-o", str(tmp),
                      *map(str, objs)]])
    (out_dir / "build.log").write_text(log)
    os.replace(tmp, lib)
    build_seconds = time.perf_counter() - t0
    build_log = log
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                handle = ctypes.CDLL(str(build()))
                for name, args in _SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = args
                    fn.restype = ctypes.c_int
                _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a launch error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def ptr_array(tensors) -> ctypes.Array:
    """Host array of device pointers, one per rank row (None -> 0)."""
    arr = (ctypes.c_ulonglong * len(tensors))()
    for i, t in enumerate(tensors):
        arr[i] = 0 if t is None else t.data_ptr()
    return arr


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as a raw handle."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
