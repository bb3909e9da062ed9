"""Kernel B1: fused two-operand elementwise reduction.

Replaces ``accl_tpu/ops/combine.py`` (``_combine_kernel`` via
``combine_pallas``), the per-hop reduction of the ring collectives.

``combine`` is the wrapper: on CUDA tensors it launches the hand-written
kernel (``csrc/combine.cu``), on CPU tensors it runs ``combine_ref``,
the plain PyTorch version of the same arithmetic. It takes one operand
pair, or lists of per-rank rows: one launch then covers every row (a
ring hop over all W ranks). ``combine.launches`` counts the kernel's
launches.

fp8 operands (e4m3fn, e5m2) are decoded to f32, combined as f32 and
encoded once with the reference's rounding (round to nearest even;
e4m3fn overflow to NaN, e5m2 overflow to inf). The NaN codes are the
reference's (XLA's): an e5m2 NaN result is 0x7F whatever its operands;
an e4m3fn SUM or PROD returns a NaN operand as it is (the first one when
both are), and MAX (MIN) of two NaNs is the negative (positive) one.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import _build
from ..constants import ReduceFunc

# dtype -> the kernel's dtype code (csrc/combine.cu)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
                torch.float64: 3, torch.int32: 4, torch.int64: 5,
                torch.int8: 6, torch.float8_e4m3fn: 7, torch.float8_e5m2: 8}
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
MAX_ROWS = 32   # ACCL_MAX_ROWS of csrc/common.cuh


def nan_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise maximum as jnp.maximum defines it: a NaN operand is
    returned as it is, and -0 orders below +0."""
    if not a.is_floating_point():
        return torch.maximum(a, b)
    tie = torch.where(torch.signbit(a), b, a)
    out = torch.where(a > b, a, torch.where(b > a, b, tie))
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, out))


def nan_minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum as jnp.minimum defines it (see nan_maximum)."""
    if not a.is_floating_point():
        return torch.minimum(a, b)
    tie = torch.where(torch.signbit(a), a, b)
    out = torch.where(a < b, a, torch.where(b < a, b, tie))
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, out))


FUNCS = {
    ReduceFunc.SUM: torch.add,
    ReduceFunc.MAX: nan_maximum,
    ReduceFunc.MIN: nan_minimum,
    ReduceFunc.PROD: torch.mul,
}


def _rows(x) -> list:
    return [x] if isinstance(x, torch.Tensor) else list(x)


def _fp8_apply(a: torch.Tensor, b: torch.Tensor,
               func: ReduceFunc) -> torch.Tensor:
    """func(a, b) of two fp8 tensors as the kernel computes it: in f32
    from the decoded codes, encoded once, with the NaN codes of the
    module docstring."""
    from .compression import decode_ref, encode_ref
    name = str(a.dtype).removeprefix("torch.")
    ca, cb = a.view(torch.uint8), b.view(torch.uint8)
    fa, fb = decode_ref(ca, name), decode_ref(cb, name)
    r = FUNCS[func](fa, fb)
    code = encode_ref(r, name)
    if a.dtype == torch.float8_e5m2:
        code = torch.where(torch.isnan(r), 0x7F, code)
    else:
        na, nb = torch.isnan(fa), torch.isnan(fb)
        if func in (ReduceFunc.SUM, ReduceFunc.PROD):
            code = torch.where(na, ca, torch.where(nb, cb, code))
        else:
            both = ca | cb if func == ReduceFunc.MAX else ca & cb
            code = torch.where(na & nb, both, code)
    return code.to(torch.uint8).view(a.dtype)


def combine_ref(a, b, func: ReduceFunc = ReduceFunc.SUM, out=None):
    """Plain PyTorch version of :func:`combine` (any device)."""
    single = isinstance(a, torch.Tensor)
    a_rows, b_rows = _rows(a), _rows(b)
    func = ReduceFunc(func)
    op = _fp8_apply if a_rows[0].dtype in FP8_DTYPES else \
        (lambda x, y, f: FUNCS[f](x, y))
    res = [op(x, y, func) for x, y in zip(a_rows, b_rows)]
    if out is not None:
        for o, r in zip(_rows(out), res):
            o.copy_(r)
        res = _rows(out)
    return res[0] if single else res


def _check_rows(a_rows: Sequence, b_rows: Sequence, out_rows: Sequence):
    t0 = a_rows[0]
    if not (len(a_rows) == len(b_rows) == len(out_rows)):
        raise ValueError("combine: row lists differ in length")
    for t in (*a_rows, *b_rows, *out_rows):
        if t.shape != t0.shape or t.dtype != t0.dtype:
            raise ValueError(
                f"combine: operands differ in shape/dtype "
                f"({tuple(t.shape)} {t.dtype} vs {tuple(t0.shape)} "
                f"{t0.dtype})")
        if t.device != t0.device:
            raise ValueError("combine: operands on different devices")
        if not t.is_contiguous():
            raise ValueError("combine: operands must be contiguous")


def combine(a, b, func: ReduceFunc = ReduceFunc.SUM, out=None):
    """res = func(a, b) elementwise. ``a``/``b``: tensors of one shape,
    or equal-length lists of such tensors (rank rows). ``out`` (same
    form) may alias ``a`` for in-place use; fresh outputs otherwise.
    Returns the result in the form of ``a``."""
    single = isinstance(a, torch.Tensor)
    a_rows, b_rows = _rows(a), _rows(b)
    out_rows = ([torch.empty_like(x) for x in a_rows] if out is None
                else _rows(out))
    _check_rows(a_rows, b_rows, out_rows)
    dev = a_rows[0].device
    if dev.type == "cpu":
        combine_ref(a_rows, b_rows, func, out_rows)
    elif dev.type == "cuda":
        _launch(a_rows, b_rows, ReduceFunc(func), out_rows)
    else:
        raise ValueError(f"combine: no kernel for device {dev}")
    return out_rows[0] if single else out_rows


combine.launches = 0


def _launch(a_rows, b_rows, func: ReduceFunc, out_rows):
    code = _DTYPE_CODES.get(a_rows[0].dtype)
    if code is None:
        raise TypeError(f"combine kernel: unsupported dtype "
                        f"{a_rows[0].dtype}")
    lib = _build.library()
    n = a_rows[0].numel()
    stream = _build.stream_of(a_rows[0])
    for i in range(0, len(a_rows), MAX_ROWS):
        sl = slice(i, i + MAX_ROWS)
        rows = len(a_rows[sl])
        _build.check(lib.accl_combine(
            int(func), code, rows, n, _build.ptr_array(a_rows[sl]),
            _build.ptr_array(b_rows[sl]), _build.ptr_array(out_rows[sl]),
            stream), "combine")
        combine.launches += 1
