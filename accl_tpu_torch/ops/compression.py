"""Kernels B5-B7: the block-scaled quantized wire codec.

Replaces ``accl_tpu/ops/compression.py`` ``_bs_quant_call`` (B5),
``_bs_dequant_call`` (B6) and ``_bs_combine_call`` (B7), the per-hop
kernels of the quantized ring collectives. Semantics are those of
:mod:`accl_tpu_torch.quant`.

Each kernel has a wrapper (``bs_quant``, ``bs_dequant``, ``bs_combine``)
over lists of per-rank rows (one launch covers every row), a plain
PyTorch version of the same arithmetic (``*_ref``), and a launch counter
(``bs_quant.launches`` ...). A wrapper launches its kernel
(``csrc/bs_codec.cu``) for CUDA tensors and runs the plain version for
CPU tensors. Wire codes travel as raw bytes (uint8 rows); the public
functions ``bs_quantize`` / ``bs_dequantize`` / ``bs_combine_requant`` /
``bs_dequant_combine`` keep the reference's signatures and return codes
in the wire dtype.

The plain fp8 encoder is integer bit-math on int64 tensors: torch's own
f32 -> fp8 cast saturates where the reference makes NaN (e4m3fn) and
picks another NaN code (e5m2). Divisions take tensor divisors: torch's
CUDA division by a Python scalar multiplies by the reciprocal, one ulp
off IEEE.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from ..arith import dtype_name
from ..constants import ReduceFunc
from ..quant import _FLT_MIN, _QMAX, WIRE_CODES, WIRE_DTYPES, n_blocks
from .combine import FUNCS, MAX_ROWS

# (mantissa shift, exponent rebias in code units, min-normal f32 bits,
#  clamp code, denormal scale 2^(bias+mant-1), NaN code or None)
_FP8 = {
    "float8_e4m3fn": (20, 960, 0x3C800000, 0x7F, 512.0, None),
    "float8_e5m2": (21, 448, 0x38800000, 0x7C, 65536.0, 0x7E),
}


def wire_name(wire) -> str:
    name = dtype_name(wire)
    if name not in _QMAX:
        raise ValueError(f"{name} is not a block-scaled wire dtype "
                         f"({', '.join(_QMAX)})")
    return name


# -- plain PyTorch versions -------------------------------------------------

def _f32_bits(v: torch.Tensor) -> torch.Tensor:
    return v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _bits_f32(bits: torch.Tensor) -> torch.Tensor:
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def encode_ref(v: torch.Tensor, wire: str) -> torch.Tensor:
    """f32 -> wire codes (uint8), the reference's rules."""
    a = _f32_bits(v) & 0x7FFFFFFF
    if wire == "int8":
        r = torch.clamp(torch.round(v), -127.0, 127.0)
        r = torch.where(a < 0x7F800000, r, torch.zeros_like(r))
        return r.to(torch.int8).view(torch.uint8)
    shift, rebias, nmin, clamp, dscale, nan_code = _FP8[wire]
    sign = (_f32_bits(v) >> 31) << 7
    lsb = (a >> shift) & 1
    rne = (a + ((1 << (shift - 1)) - 1) + lsb) >> shift
    code = torch.clamp(rne - rebias, max=clamp)
    code_d = torch.round(v.abs() * dscale).to(torch.int64)
    code = torch.where(a < nmin, code_d, code)
    if nan_code is not None:
        code = torch.where(a > 0x7F800000, torch.full_like(code, nan_code),
                           code)
    return (sign | code).to(torch.uint8)


def decode_ref(c: torch.Tensor, wire: str) -> torch.Tensor:
    """wire codes (uint8) -> f32, exact; NaN codes give sign|0x7FC00000."""
    if wire == "int8":
        return c.view(torch.int8).to(torch.float32)
    c = c.view(torch.uint8).to(torch.int64)
    sign = (c & 0x80) << 24
    if wire == "float8_e4m3fn":
        e, m = (c >> 3) & 0xF, c & 7
        nan = (e == 15) & (m == 7)
        inf = torch.zeros_like(nan)
        bits = sign | ((e + 120) << 23) | (m << 20)
        den = m.to(torch.float32) * 0.001953125
    else:
        e, m = (c >> 2) & 0x1F, c & 3
        nan = (e == 31) & (m != 0)
        inf = (e == 31) & (m == 0)
        bits = sign | ((e + 112) << 23) | (m << 21)
        den = m.to(torch.float32) * 1.52587890625e-05
    bits = torch.where(nan, sign | 0x7FC00000, bits)
    bits = torch.where(inf, sign | 0x7F800000, bits)
    den = torch.where(sign != 0, -den, den)
    return torch.where(e == 0, den, _bits_f32(bits))


def _quant_one(x: torch.Tensor, wire: str, block: int):
    n = x.numel()
    nb = n_blocks(n, block)
    xp = F.pad(x, (0, nb * block - n)).view(nb, block)
    amax = xp.abs().amax(dim=1)                     # NaN propagates
    s = amax / torch.full_like(amax, _QMAX[wire])
    good = (s >= _FLT_MIN) & (s < float("inf"))
    s = torch.where(good, s, torch.ones_like(s))
    inv = torch.ones_like(s) / s
    v = (xp * inv[:, None]).reshape(-1)[:n]
    return encode_ref(v, wire), s


def _deq_one(q: torch.Tensor, s: torch.Tensor, wire: str, block: int):
    n = q.numel()
    return decode_ref(q, wire) * s.repeat_interleave(block)[:n]


def bs_quant_ref(x_rows, wire, block: int, q_rows=None, s_rows=None):
    """Plain version of :func:`bs_quant`."""
    wire = wire_name(wire)
    outs = [_quant_one(x, wire, block) for x in x_rows]
    return _land(outs, q_rows, s_rows)


def bs_dequant_ref(q_rows, s_rows, wire, block: int, out_rows=None):
    """Plain version of :func:`bs_dequant`."""
    wire = wire_name(wire)
    res = [_deq_one(q, s, wire, block) for q, s in zip(q_rows, s_rows)]
    if out_rows is None:
        return res
    for o, r in zip(out_rows, res):
        o.copy_(r)
    return list(out_rows)


def bs_combine_ref(q_rows, s_rows, other_rows, func: ReduceFunc, wire,
                   block: int, q_out=None, s_out=None, out=None,
                   requant: bool = True):
    """Plain version of :func:`bs_combine`."""
    wire = wire_name(wire)
    op = FUNCS[ReduceFunc(func)]
    accs = [op(x, _deq_one(q, s, wire, block))
            for q, s, x in zip(q_rows, s_rows, other_rows)]
    if requant:
        return _land([_quant_one(a, wire, block) for a in accs],
                     q_out, s_out)
    if out is None:
        return accs
    for o, a in zip(out, accs):
        o.copy_(a)
    return list(out)


def _land(outs, q_rows, s_rows):
    if q_rows is None:
        return [q for q, _ in outs], [s for _, s in outs]
    for (q, s), qo, so in zip(outs, q_rows, s_rows):
        qo.view(torch.uint8).copy_(q)
        so.copy_(s)
    return list(q_rows), list(s_rows)


# -- kernel wrappers --------------------------------------------------------

def _device_of(rows) -> torch.device:
    dev = rows[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"block-scale codec: no kernel for device {dev}")
    return dev


def _check(rows, n: int, dtype, dev, what: str):
    for t in rows:
        if t.device != dev:
            raise ValueError(f"{what}: rows on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: rows must be contiguous")
        if t.numel() != n:
            raise ValueError(f"{what}: row of {t.numel()} elements, "
                             f"expected {n}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{what}: {t.dtype} row, expected {dtype}")
        if dtype is None and t.element_size() != 1:
            raise TypeError(f"{what}: code rows must be 1-byte")


def _empty_codes(n: int, rows: int, dev):
    return ([torch.empty(n, dtype=torch.uint8, device=dev)
             for _ in range(rows)])


def bs_quant(x_rows, wire, block: int, q_rows=None, s_rows=None):
    """B5: block-scale quantize each f32 row: codes (n bytes) and scales
    (nb f32) per row. Returns (q_rows, s_rows); given output rows are
    filled in place."""
    wire, x_rows = wire_name(wire), list(x_rows)
    dev = _device_of(x_rows)
    n = x_rows[0].numel()
    nb = n_blocks(n, block)
    if q_rows is None:
        q_rows = _empty_codes(n, len(x_rows), dev)
        s_rows = [torch.empty(nb, dtype=torch.float32, device=dev)
                  for _ in x_rows]
    _check(x_rows, n, torch.float32, dev, "bs_quant")
    _check(q_rows, n, None, dev, "bs_quant")
    _check(s_rows, nb, torch.float32, dev, "bs_quant")
    if dev.type == "cpu":
        return bs_quant_ref(x_rows, wire, block, q_rows, s_rows)
    lib = _build.library()
    stream = _build.stream_of(x_rows[0])
    for i in range(0, len(x_rows), MAX_ROWS):
        sl = slice(i, i + MAX_ROWS)
        _build.check(lib.accl_bs_quant(
            WIRE_CODES[wire], block, len(x_rows[sl]), n,
            _build.ptr_array(x_rows[sl]), _build.ptr_array(q_rows[sl]),
            _build.ptr_array(s_rows[sl]), stream), "bs_quant")
        bs_quant.launches += 1
    return list(q_rows), list(s_rows)


def bs_dequant(q_rows, s_rows, wire, block: int, out_rows=None):
    """B6: f32(q) * scale per row, one rounding."""
    wire, q_rows, s_rows = wire_name(wire), list(q_rows), list(s_rows)
    dev = _device_of(q_rows)
    n = q_rows[0].numel()
    nb = n_blocks(n, block)
    if out_rows is None:
        out_rows = [torch.empty(n, dtype=torch.float32, device=dev)
                    for _ in q_rows]
    _check(q_rows, n, None, dev, "bs_dequant")
    _check(s_rows, nb, torch.float32, dev, "bs_dequant")
    _check(out_rows, n, torch.float32, dev, "bs_dequant")
    if dev.type == "cpu":
        return bs_dequant_ref(q_rows, s_rows, wire, block, out_rows)
    lib = _build.library()
    stream = _build.stream_of(q_rows[0])
    for i in range(0, len(q_rows), MAX_ROWS):
        sl = slice(i, i + MAX_ROWS)
        _build.check(lib.accl_bs_dequant(
            WIRE_CODES[wire], block, len(q_rows[sl]), n,
            _build.ptr_array(q_rows[sl]), _build.ptr_array(s_rows[sl]),
            _build.ptr_array(out_rows[sl]), stream), "bs_dequant")
        bs_dequant.launches += 1
    return list(out_rows)


def bs_combine(q_rows, s_rows, other_rows, func: ReduceFunc, wire,
               block: int, q_out=None, s_out=None, out=None,
               requant: bool = True):
    """B7: acc = func(other, f32(q) * s) in f32 per row. ``requant``:
    quantize acc against fresh scales into (q_out, s_out) — the f32
    partial is never stored; else write acc into ``out``. Returns
    (q_out, s_out) or out."""
    wire = wire_name(wire)
    q_rows, s_rows, other_rows = list(q_rows), list(s_rows), list(other_rows)
    dev = _device_of(q_rows)
    n = q_rows[0].numel()
    nb = n_blocks(n, block)
    W = len(q_rows)
    if requant and q_out is None:
        q_out = _empty_codes(n, W, dev)
        s_out = [torch.empty(nb, dtype=torch.float32, device=dev)
                 for _ in range(W)]
    if not requant and out is None:
        out = [torch.empty(n, dtype=torch.float32, device=dev)
               for _ in range(W)]
    _check(q_rows, n, None, dev, "bs_combine")
    _check(s_rows, nb, torch.float32, dev, "bs_combine")
    _check(other_rows, n, torch.float32, dev, "bs_combine")
    if requant:
        _check(q_out, n, None, dev, "bs_combine")
        _check(s_out, nb, torch.float32, dev, "bs_combine")
    else:
        _check(out, n, torch.float32, dev, "bs_combine")
    if dev.type == "cpu":
        return bs_combine_ref(q_rows, s_rows, other_rows, func, wire, block,
                              q_out, s_out, out, requant)
    lib = _build.library()
    stream = _build.stream_of(q_rows[0])
    for i in range(0, W, MAX_ROWS):
        sl = slice(i, i + MAX_ROWS)
        none = [None] * len(q_rows[sl])
        _build.check(lib.accl_bs_combine(
            int(ReduceFunc(func)), WIRE_CODES[wire], block, int(requant),
            len(q_rows[sl]), n, _build.ptr_array(q_rows[sl]),
            _build.ptr_array(s_rows[sl]), _build.ptr_array(other_rows[sl]),
            _build.ptr_array(q_out[sl] if requant else none),
            _build.ptr_array(s_out[sl] if requant else none),
            _build.ptr_array(none if requant else out[sl]), stream),
            "bs_combine")
        bs_combine.launches += 1
    return (list(q_out), list(s_out)) if requant else list(out)


bs_quant.launches = 0
bs_dequant.launches = 0
bs_combine.launches = 0


# -- reference-shaped entry points ----------------------------------------

def bs_quantize(x: torch.Tensor, wire_dtype, block: int):
    """Block-scale quantize a payload: (q ``x.shape`` in the wire dtype,
    scales (nb,) f32), nb = ceil(n / block)."""
    wire = wire_name(wire_dtype)
    flat = x.reshape(-1).to(torch.float32).contiguous()
    (q,), (s,) = bs_quant([flat], wire, block)
    return q.view(WIRE_DTYPES[wire]).reshape(x.shape), s


def bs_dequantize(q: torch.Tensor, scales: torch.Tensor, block: int):
    """Inverse of :func:`bs_quantize`: f32, one rounding per element."""
    wire = wire_name(q.dtype)
    (out,) = bs_dequant([q.reshape(-1).contiguous()],
                        [scales.reshape(-1).contiguous()], wire, block)
    return out.reshape(q.shape)


def bs_combine_requant(q, scales, other, func: ReduceFunc, wire_dtype,
                       block: int):
    """One quantized ring hop: ``func(other, dequant(q, scales))`` in f32,
    requantized against fresh scales. Returns (q', scales')."""
    wire = wire_name(wire_dtype)
    (q2,), (s2,) = bs_combine(
        [q.reshape(-1).contiguous()], [scales.reshape(-1).contiguous()],
        [other.reshape(-1).to(torch.float32).contiguous()], func, wire,
        block)
    return q2.view(WIRE_DTYPES[wire]).reshape(q.shape), s2


def bs_dequant_combine(q, scales, other, func: ReduceFunc, block: int):
    """The round-closing hop: ``func(other, dequant(q, scales))`` in f32,
    no requantization."""
    wire = wire_name(q.dtype)
    (out,) = bs_combine(
        [q.reshape(-1).contiguous()], [scales.reshape(-1).contiguous()],
        [other.reshape(-1).to(torch.float32).contiguous()], func, wire,
        block, requant=False)
    return out.reshape(other.shape)
