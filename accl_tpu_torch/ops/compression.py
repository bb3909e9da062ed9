"""The wire codecs: kernels B2-B4 (per-tensor lanes) and B5-B7 (block-
scaled lanes).

Replaces ``accl_tpu/ops/compression.py``:

* the per-tensor lanes of every compressed hop: ``_cast_kernel`` (B2,
  f32 <-> f16 / bf16 / fp8 casts), ``_quant_kernel`` (B3, q = x * inv
  cast to fp8, one scale per tensor) and ``_dequant_kernel`` (B4,
  f32(q) * scale);
* the block-scaled codec of the quantized rings: ``_bs_quant_call``
  (B5), ``_bs_dequant_call`` (B6) and ``_bs_combine_call`` (B7), with the
  semantics of :mod:`accl_tpu_torch.quant`.

Each kernel has a wrapper over lists of per-rank rows (one launch covers
every row), a plain PyTorch version of the same arithmetic (``*_ref``),
and a launch counter (``cast.launches`` ...). A wrapper launches its
kernel (``csrc/wire_lanes.cu``, ``csrc/bs_codec.cu``) for CUDA tensors
and runs the plain version for CPU tensors. The reference-shaped
functions on top (``cast_lane``, ``fp8_quantize``, ``compress_fp8``,
``wire_compress``, ``bs_quantize`` ...) keep the reference's signatures.

The plain encoders are integer bit-math on int64 tensors: torch's own
f32 -> fp8 cast saturates where the reference makes NaN (e4m3fn) and
picks another NaN code (e5m2), and NaN payloads follow XLA's rules only
when written by hand. Divisions take tensor divisors: torch's CUDA
division by a Python scalar multiplies by the reciprocal, one ulp off
IEEE.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from ..arith import dtype_name, to_torch_dtype
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


# -- per-tensor wire lanes: kernels B2-B4 -------------------------------------

FP8_DTYPE_NAMES = ("float8_e4m3fn", "float8_e5m2")
# f32(1 / finfo(wire).max): under jit XLA folds the reference's division
# by the constant into a multiply by this reciprocal
_FP8_RCP = {"float8_e4m3fn": 1.0 / 448.0, "float8_e5m2": 1.0 / 57344.0}
_SCALE_FLOOR = 1e-30
# dtype -> lane code of csrc/wire_lanes.cu
_LANES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
          torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}
_PARTIALS = 2048          # amax scratch per launch (csrc/wire_lanes.cu)


def fp8_name(wire) -> str:
    name = dtype_name(wire)
    if name not in FP8_DTYPE_NAMES:
        raise ValueError(f"{name} is not a per-tensor fp8 wire dtype "
                         f"({', '.join(FP8_DTYPE_NAMES)})")
    return name


def _bits16(v: torch.Tensor) -> torch.Tensor:
    return v.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF


def _as16(code: torch.Tensor, dtype) -> torch.Tensor:
    code = torch.where(code >= 2 ** 15, code - 2 ** 16, code)
    return code.to(torch.int16).view(dtype)


def _encode_f16(v: torch.Tensor) -> torch.Tensor:
    """f32 -> f16, round to nearest even, overflow to inf; a NaN stays
    quiet with its top payload bits (XLA's conversion)."""
    u = _f32_bits(v)
    a = u & 0x7FFFFFFF
    lsb = (a >> 13) & 1
    code = torch.clamp(((a + 0xFFF + lsb) >> 13) - (112 << 10), max=0x7C00)
    code_d = torch.round(v.abs() * 2.0 ** 24).to(torch.int64)
    code = torch.where(a < 0x38800000, code_d, code)     # f16 denormals
    code = torch.where(a > 0x7F800000, 0x7E00 | ((a & 0x7FFFFF) >> 13), code)
    return _as16(((u >> 16) & 0x8000) | code, torch.float16)


def _decode_f16(h: torch.Tensor) -> torch.Tensor:
    h = _bits16(h)
    sign = (h & 0x8000) << 16
    e, m = (h >> 10) & 0x1F, h & 0x3FF
    bits = sign | ((e + 112) << 23) | (m << 13)
    special = sign | 0x7F800000 | (m << 13) | torch.where(m != 0, 0x400000, 0)
    bits = torch.where(e == 31, special, bits)
    den = m.to(torch.float32) * 2.0 ** -24
    den = torch.where(sign != 0, -den, den)
    return torch.where(e == 0, den, _bits_f32(bits))


def _encode_bf16(v: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16, round to nearest even (denormals kept); a NaN becomes
    the canonical quiet NaN, sign kept."""
    u = _f32_bits(v)
    a = u & 0x7FFFFFFF
    code = (a + 0x7FFF + ((a >> 16) & 1)) >> 16
    code = torch.where(a > 0x7F800000, 0x7FC0, code)
    return _as16(((u >> 16) & 0x8000) | code, torch.bfloat16)


def _decode_bf16(h: torch.Tensor) -> torch.Tensor:
    return _bits_f32(_bits16(h) << 16)


def _cast_one(x: torch.Tensor, dtype) -> torch.Tensor:
    if x.dtype == torch.float32:
        if dtype == torch.float16:
            return _encode_f16(x)
        if dtype == torch.bfloat16:
            return _encode_bf16(x)
        return encode_ref(x, dtype_name(dtype)).view(dtype)
    if x.dtype == torch.float16:
        return _decode_f16(x)
    if x.dtype == torch.bfloat16:
        return _decode_bf16(x)
    return decode_ref(x.view(torch.uint8), dtype_name(x.dtype))


def cast_ref(x_rows, dtype, out_rows=None):
    """Plain version of :func:`cast`."""
    dtype = to_torch_dtype(dtype)
    res = [_cast_one(x, dtype) for x in x_rows]
    if out_rows is None:
        return res
    for o, r in zip(out_rows, res):
        o.copy_(r)
    return list(out_rows)


def fp8_scale_ref(x_rows, wire, scale_rows=None, inv_rows=None):
    """Plain version of :func:`fp8_scale`."""
    wire = fp8_name(wire)
    dev = x_rows[0].device
    rcp = torch.tensor(_FP8_RCP[wire], dtype=torch.float32, device=dev)
    floor = torch.tensor(_SCALE_FLOOR, dtype=torch.float32, device=dev)
    one = torch.ones(1, dtype=torch.float32, device=dev)
    scales, invs = [], []
    for x in x_rows:
        amax = (x.abs().amax() if x.numel()
                else torch.zeros((), dtype=torch.float32, device=dev))
        s = torch.maximum(amax * rcp, floor).reshape(1)   # NaN propagates
        scales.append(s)
        invs.append(one / s)
    if scale_rows is None:
        return scales, invs
    for so, io, s, i in zip(scale_rows, inv_rows, scales, invs):
        so.copy_(s)
        io.copy_(i)
    return list(scale_rows), list(inv_rows)


def fp8_quant_ref(x_rows, inv_rows, wire, q_rows=None):
    """Plain version of :func:`fp8_quant`."""
    wire = fp8_name(wire)
    res = [encode_ref(x * i, wire).view(WIRE_DTYPES[wire])
           for x, i in zip(x_rows, inv_rows)]
    if q_rows is None:
        return res
    for o, r in zip(q_rows, res):
        o.view(torch.uint8).copy_(r.view(torch.uint8))
    return list(q_rows)


def fp8_dequant_ref(q_rows, scale_rows, wire, out_rows=None):
    """Plain version of :func:`fp8_dequant`."""
    wire = fp8_name(wire)
    res = [decode_ref(q.view(torch.uint8), wire) * s
           for q, s in zip(q_rows, scale_rows)]
    if out_rows is None:
        return res
    for o, r in zip(out_rows, res):
        o.copy_(r)
    return list(out_rows)


def _lane(dtype) -> int:
    code = _LANES.get(dtype)
    if code is None:
        raise TypeError(f"wire lanes: no lane for {dtype}")
    return code


def cast(x_rows, dtype, out_rows=None):
    """B2: convert each row between f32 and a wire dtype (f16, bf16,
    e4m3fn, e5m2), either direction. Returns the output rows; given rows
    are filled in place."""
    dtype = to_torch_dtype(dtype)
    x_rows = list(x_rows)
    dev = _device_of(x_rows)
    src = x_rows[0].dtype
    if torch.float32 not in (src, dtype) or src == dtype:
        raise TypeError(f"cast: {src} -> {dtype}; one side must be "
                        "float32, the other a wire dtype")
    lanes = _lane(src), _lane(dtype)
    n = x_rows[0].numel()
    if out_rows is None:
        out_rows = [torch.empty(n, dtype=dtype, device=dev) for _ in x_rows]
    _check(x_rows, n, src, dev, "cast")
    _check(out_rows, n, dtype, dev, "cast")
    if dev.type == "cpu":
        return cast_ref(x_rows, dtype, out_rows)
    lib = _build.library()
    stream = _build.stream_of(x_rows[0])
    for i in range(0, len(x_rows), MAX_ROWS):
        sl = slice(i, i + MAX_ROWS)
        _build.check(lib.accl_cast(
            *lanes, len(x_rows[sl]), n,
            _build.ptr_array(x_rows[sl]), _build.ptr_array(out_rows[sl]),
            stream), "cast")
        cast.launches += 1
    return list(out_rows)


def fp8_scale(x_rows, wire, scale_rows=None, inv_rows=None):
    """The scale of B3, per f32 row: amax = max |x| (NaN propagates),
    scale = max(amax * f32(1/fp8_max), 1e-30), inv = 1 / scale. Each
    scale and inverse row is one f32 element in device memory; nothing
    syncs the host. Returns (scale_rows, inv_rows)."""
    wire, x_rows = fp8_name(wire), list(x_rows)
    dev = _device_of(x_rows)
    n = x_rows[0].numel()
    if scale_rows is None:
        scale_rows = list(torch.empty((len(x_rows), 1), device=dev))
        inv_rows = list(torch.empty((len(x_rows), 1), device=dev))
    _check(x_rows, n, torch.float32, dev, "fp8_scale")
    _check(scale_rows, 1, torch.float32, dev, "fp8_scale")
    _check(inv_rows, 1, torch.float32, dev, "fp8_scale")
    if dev.type == "cpu":
        return fp8_scale_ref(x_rows, wire, scale_rows, inv_rows)
    lib = _build.library()
    stream = _build.stream_of(x_rows[0])
    partial = torch.empty(_PARTIALS, dtype=torch.float32, device=dev)
    for i in range(0, len(x_rows), MAX_ROWS):
        sl = slice(i, i + MAX_ROWS)
        _build.check(lib.accl_fp8_scale(
            WIRE_CODES[wire], len(x_rows[sl]), n,
            _build.ptr_array(x_rows[sl]), _build.ptr_array(scale_rows[sl]),
            _build.ptr_array(inv_rows[sl]), partial.data_ptr(), stream),
            "fp8_scale")
        fp8_scale.launches += 1
    return list(scale_rows), list(inv_rows)


def fp8_quant(x_rows, inv_rows, wire, q_rows=None):
    """B3: q = encode(x * inv) per f32 row, inv one f32 per row (from
    :func:`fp8_scale`). Returns the code rows (1-byte)."""
    wire, x_rows, inv_rows = fp8_name(wire), list(x_rows), list(inv_rows)
    dev = _device_of(x_rows)
    n = x_rows[0].numel()
    if q_rows is None:
        q_rows = [torch.empty(n, dtype=WIRE_DTYPES[wire], device=dev)
                  for _ in x_rows]
    _check(x_rows, n, torch.float32, dev, "fp8_quant")
    _check(inv_rows, 1, torch.float32, dev, "fp8_quant")
    _check(q_rows, n, None, dev, "fp8_quant")
    if dev.type == "cpu":
        return fp8_quant_ref(x_rows, inv_rows, wire, q_rows)
    lib = _build.library()
    stream = _build.stream_of(x_rows[0])
    for i in range(0, len(x_rows), MAX_ROWS):
        sl = slice(i, i + MAX_ROWS)
        _build.check(lib.accl_fp8_quant(
            WIRE_CODES[wire], len(x_rows[sl]), n,
            _build.ptr_array(x_rows[sl]), _build.ptr_array(inv_rows[sl]),
            _build.ptr_array(q_rows[sl]), stream), "fp8_quant")
        fp8_quant.launches += 1
    return list(q_rows)


def fp8_dequant(q_rows, scale_rows, wire, out_rows=None):
    """B4: f32(q) * scale per code row, one rounding; scale one f32 per
    row. Returns the f32 rows."""
    wire, q_rows, scale_rows = fp8_name(wire), list(q_rows), list(scale_rows)
    dev = _device_of(q_rows)
    n = q_rows[0].numel()
    if out_rows is None:
        out_rows = [torch.empty(n, dtype=torch.float32, device=dev)
                    for _ in q_rows]
    _check(q_rows, n, None, dev, "fp8_dequant")
    _check(scale_rows, 1, torch.float32, dev, "fp8_dequant")
    _check(out_rows, n, torch.float32, dev, "fp8_dequant")
    if dev.type == "cpu":
        return fp8_dequant_ref(q_rows, scale_rows, wire, out_rows)
    lib = _build.library()
    stream = _build.stream_of(q_rows[0])
    for i in range(0, len(q_rows), MAX_ROWS):
        sl = slice(i, i + MAX_ROWS)
        _build.check(lib.accl_fp8_dequant(
            WIRE_CODES[wire], len(q_rows[sl]), n,
            _build.ptr_array(q_rows[sl]), _build.ptr_array(scale_rows[sl]),
            _build.ptr_array(out_rows[sl]), stream), "fp8_dequant")
        fp8_dequant.launches += 1
    return list(out_rows)


cast.launches = 0
fp8_scale.launches = 0
fp8_quant.launches = 0
fp8_dequant.launches = 0


# -- reference-shaped entry points: the per-tensor lanes -------------------

def cast_lane(x: torch.Tensor, dtype) -> torch.Tensor:
    """Streamed dtype cast between f32 and a wire dtype (both directions:
    the down and up lanes)."""
    dtype = to_torch_dtype(dtype)
    if x.dtype == dtype:
        return x
    (out,) = cast([x.reshape(-1).contiguous()], dtype)
    return out.reshape(x.shape)


def fp8_quantize(x: torch.Tensor, wire_dtype, axes=None):
    """The per-tensor scaled fp8 codec: (fp8 payload, f32 scale). ``axes``
    None gives one scale (shape ()); the trailing axes (1, ..., ndim-1)
    give one scale per leading index (the per-(rank, chunk) scales of the
    fused reduce-scatter)."""
    wire = fp8_name(wire_dtype)
    if x.dtype != torch.float32:
        raise TypeError(f"fp8_quantize: {x.dtype} payload, expected "
                        "float32")
    if axes is None:
        rows = [x.reshape(-1).contiguous()]
    elif tuple(axes) == tuple(range(1, x.dim())):
        rows = list(x.reshape(x.shape[0], -1).contiguous())
    else:
        raise ValueError(f"fp8_quantize: axes {axes} unsupported (None or "
                         "the trailing axes)")
    s, inv = (torch.empty((len(rows), 1), dtype=torch.float32,
                          device=x.device) for _ in range(2))
    fp8_scale(rows, wire, list(s), list(inv))
    q = torch.empty((len(rows), rows[0].numel()), dtype=WIRE_DTYPES[wire],
                    device=x.device)
    fp8_quant(rows, list(inv), wire, list(q))
    return q.reshape(x.shape), s.reshape(() if axes is None else (-1,))


def fp8_dequantize(q: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`fp8_quantize`; the scale broadcasts over the
    payload's trailing axes."""
    wire = fp8_name(q.dtype)
    nr = max(1, scale.numel())
    rows = list(q.reshape(nr, -1))
    out = torch.empty((nr, rows[0].numel()), dtype=torch.float32,
                      device=q.device)
    fp8_dequant(rows, list(scale.reshape(nr, 1).to(torch.float32)), wire,
                list(out))
    return cast_lane(out.reshape(q.shape), dtype)


def compress_fp8(x: torch.Tensor, wire_dtype=torch.float8_e4m3fn):
    """x -> (fp8 payload, (1, 1) f32 scale): the standalone lane."""
    q, s = fp8_quantize(x, wire_dtype)
    return q, s.reshape(1, 1)


def decompress_fp8(q: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    return fp8_dequantize(q, scale.reshape(()), dtype)


def wire_compress(x: torch.Tensor, wire_dtype):
    """Encode a hop payload for the wire: (payload, aux), aux the fp8
    scale or None. Cast lanes for f16/bf16; the scaled codec for fp8."""
    wd = to_torch_dtype(wire_dtype)
    if wd == x.dtype:
        return x, None
    if dtype_name(wd) in FP8_DTYPE_NAMES:
        return compress_fp8(x, wd)
    return cast_lane(x, wd), None


def wire_decompress(payload: torch.Tensor, aux, dtype) -> torch.Tensor:
    if aux is not None:
        return decompress_fp8(payload, aux, dtype)
    return cast_lane(payload, dtype)
