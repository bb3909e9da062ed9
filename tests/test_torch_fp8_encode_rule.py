"""The rules B1's fp8 kernel (``csrc/fp8_hw.cuh``) relies on, on the CPU.

The kernel encodes with the hardware's ``cvt.rn.satfinite`` conversion,
which rounds to nearest even as the reference's encoder does but clamps
to the largest finite code where the reference overflows (e4m3fn to NaN,
e5m2 to inf). It puts the reference's codes back with thresholds, and it
takes SUM and PROD in f16, MAX and MIN on the codes. Each rule is held
here against the port's plain version for every pair of codes (65,536 a
format), so the card's every-pair check (``chip_smoke.py``) has a
counterpart that runs without the card:

* the encode rule: ``encode_ref`` (held against the JAX package by
  ``test_torch_fp8_payload.py``) equals clamp to +-448 (e4m3fn) or
  +-57344 (e5m2), encode, then the threshold fixups, on every f32 result
  of a SUM or PROD of two codes and on every decoded code (MAX, MIN);
* the kernel's SUM and PROD, emulated word by word (four codes a 32-bit
  word, two f16 lanes a half): one f16 rounding, the clamped encode, the
  masks from the f16 bits and the NaN-operand selects, against
  ``combine_ref``, bitwise;
* the kernel's MAX and MIN on the codes (a sign-magnitude byte compare
  and byte masks), emulated the same way, against ``combine_ref``;
* the constants the emulation uses are the ones in the kernel's source.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from accl_tpu_torch.constants import ReduceFunc  # noqa: E402
from accl_tpu_torch.ops.combine import FUNCS, combine_ref  # noqa: E402
from accl_tpu_torch.ops.compression import decode_ref, encode_ref  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and /dev/shm is shared by every worker of a
    parallel run, so the sweep would count another worker's live
    segments against this module's tests."""
    yield


SOURCE = (Path(__file__).resolve().parent.parent / "accl_tpu_torch" / "csrc"
          / "fp8_hw.cuh")
FORMATS = ("float8_e4m3fn", "float8_e5m2")
# largest finite value; the reference's overflow code; its threshold in
# f32 (e4m3fn: above, e5m2: at or above) and in f16 bits
LIMITS = {"float8_e4m3fn": (448.0, 0x7F, 464.0, 0x5F40),
          "float8_e5m2": (57344.0, 0x7C, 61440.0, 0x7B80)}
F16_NAN_ABOVE = 0x7C00
ARITH = (ReduceFunc.SUM, ReduceFunc.PROD)
ORDER = (ReduceFunc.MAX, ReduceFunc.MIN)
U32 = np.uint32


def _pairs():
    codes = torch.arange(256, dtype=torch.uint8)
    return codes.repeat_interleave(256), codes.repeat(256)


def _clamped_encode(r: torch.Tensor, fmt: str) -> torch.Tensor:
    """The hardware's satfinite encode on a non-NaN value: clamp to the
    largest finite value, then round to nearest even."""
    top = LIMITS[fmt][0]
    return encode_ref(r.clamp(-top, top), fmt)


def _rule(r: torch.Tensor, fmt: str) -> torch.Tensor:
    """The kernel's rule in f32: the clamped encode, then sign | the
    overflow code past the threshold."""
    _, code, thr, _ = LIMITS[fmt]
    c = _clamped_encode(r, fmt)
    big = r.abs() > thr if fmt == "float8_e4m3fn" else r.abs() >= thr
    return torch.where(big, (c & 0x80) | code, c)


@pytest.mark.parametrize("func", ARITH + ORDER, ids=lambda f: f.name)
@pytest.mark.parametrize("fmt", FORMATS)
def test_encode_rule(fmt, func):
    """clamp, encode, fix past the threshold == encode_ref, for every f32
    result of SUM and PROD of two codes and every decoded code (MAX and
    MIN return one); NaN results are the NaN rules' (tested below)."""
    a, b = _pairs()
    fa, fb = decode_ref(a, fmt), decode_ref(b, fmt)
    r = FUNCS[func](fa, fb) if func in ARITH else fa
    keep = ~torch.isnan(r)
    r = r[keep]
    want, got = encode_ref(r, fmt), _rule(r, fmt)
    bad = torch.nonzero(want != got).flatten()
    assert bad.numel() == 0, (
        f"{fmt} {func.name}: {bad.numel()} results differ, e.g. "
        + ", ".join(f"{float(r[i])!r}: {int(got[i]):02x} vs "
                    f"{int(want[i]):02x}" for i in bad[:4]))
    if func in ARITH or fmt == "float8_e5m2":     # e5m2's inf codes
        assert (r.abs() > LIMITS[fmt][0]).any(), "nothing past the clamp"


# -- word-level emulation of csrc/fp8_hw.cuh ---------------------------------

def prmt(a: np.ndarray, b: np.ndarray, sel: int) -> np.ndarray:
    """PTX prmt.b32 (default mode): byte k of the result is byte
    sel[4k+2:4k] of {b, a} (a the low word), or its bit 7 spread over
    the byte where sel's bit 4k+3 is set."""
    src = (a.astype(np.uint64) | (b.astype(np.uint64) << np.uint64(32)))
    out = np.zeros(a.shape, np.uint64)
    for k in range(4):
        nib = (sel >> (4 * k)) & 0xF
        byte = (src >> np.uint64(8 * (nib & 7))) & np.uint64(0xFF)
        if nib & 8:
            byte = np.where(byte & np.uint64(0x80), np.uint64(0xFF),
                            np.uint64(0))
        out |= byte << np.uint64(8 * k)
    return out.astype(U32)


def byte_sign_mask(x):
    return prmt(x, np.zeros_like(x), 0xBA98)


def lane_sign_mask(x01, x23):
    return prmt(x01, x23, 0xFDB9)


def lanes_at_least(x, t: int):
    return (x + U32(((0x8000 - t) * 0x00010001) & 0xFFFFFFFF)).astype(U32)


def nan_bits(w, fmt: str):
    step = 0x01010101 if fmt == "float8_e4m3fn" else 0x03030303
    return ((w & U32(0x7F7F7F7F)) + U32(step)).astype(U32)


def words(codes: torch.Tensor) -> np.ndarray:
    """uint8 codes -> uint32 words, code k of a word in byte k."""
    return codes.numpy().copy().view("<u4").astype(U32)


def f16_lanes(h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f16 values, four a word of codes -> (h01, h23) f16x2 words."""
    bits = h.view(np.uint16).astype(U32).reshape(-1, 4)
    return (bits[:, 0] | (bits[:, 1] << U32(16)),
            bits[:, 2] | (bits[:, 3] << U32(16)))


def kernel_arith(a: torch.Tensor, b: torch.Tensor, fmt: str,
                 func: ReduceFunc) -> np.ndarray:
    """fp8_arith4 on every word: the codes decoded exactly, one f16
    rounding of the exact sum or product (float64 holds it), the clamped
    encode of each f16 lane, the masks from the f16 bits, the NaN
    selects."""
    _, code, _, thr_h = LIMITS[fmt]
    x, y = (decode_ref(t, fmt).double().numpy() for t in (a, b))
    with np.errstate(all="ignore"):
        exact = x + y if func == ReduceFunc.SUM else x * y
        h = exact.astype(np.float16)
    r = torch.from_numpy(h.astype(np.float32))
    sat = torch.where(torch.isnan(r), encode_ref(r, fmt),
                      _clamped_encode(r, fmt))
    c = words(sat.to(torch.uint8))
    h01, h23 = f16_lanes(h)
    m01, m23 = h01 & U32(0x7FFF7FFF), h23 & U32(0x7FFF7FFF)
    wa, wb = words(a), words(b)
    if fmt == "float8_e4m3fn":
        over = lane_sign_mask(lanes_at_least(m01, thr_h + 1),
                              lanes_at_least(m23, thr_h + 1))
        fixed = c | (over & U32(0x7F7F7F7F))
        na = byte_sign_mask(nan_bits(wa, fmt))
        nb = byte_sign_mask(nan_bits(wb, fmt))
        out = (wa & na) | (~na & ((wb & nb) | (fixed & ~nb)))
    else:
        over = lane_sign_mask(lanes_at_least(m01, thr_h),
                              lanes_at_least(m23, thr_h)) & U32(0x7F7F7F7F)
        nan = lane_sign_mask(lanes_at_least(m01, F16_NAN_ABOVE + 1),
                             lanes_at_least(m23, F16_NAN_ABOVE + 1))
        inf = (c & ~over) | (over & U32(code * 0x01010101))
        out = (inf & ~nan) | (nan & U32(0x7F7F7F7F))
    return out.astype("<u4").view(np.uint8)


def kernel_order(a: torch.Tensor, b: torch.Tensor, fmt: str,
                 func: ReduceFunc) -> np.ndarray:
    """fp8_minmax4 on every word."""
    wa, wb = words(a), words(b)
    ge = ((wa | U32(0x80808080)) - (wb & U32(0x7F7F7F7F))).astype(U32)
    s = wa ^ wb
    amax = (s & ~wa) | (~s & (ge ^ wa))
    na, nb = nan_bits(wa, fmt), nan_bits(wb, fmt)
    take_a = amax if func == ReduceFunc.MAX else ~amax
    if fmt == "float8_e4m3fn":
        neg = wa if func == ReduceFunc.MAX else ~wa
        take_a = (na & (~nb | neg)) | (~na & ~nb & take_a)
    m = byte_sign_mask(take_a.astype(U32))
    r = (wa & m) | (wb & ~m)
    if fmt == "float8_e5m2":
        n = byte_sign_mask((na | nb).astype(U32))
        r = (r & ~n) | (n & U32(0x7F7F7F7F))
    return r.astype("<u4").view(np.uint8)


def _held(got: np.ndarray, a, b, fmt, func):
    dt = getattr(torch, fmt)
    want = combine_ref(a.view(dt), b.view(dt), func).view(torch.uint8).numpy()
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, (
        f"{fmt} {func.name}: {bad.size} pairs differ, e.g. "
        + ", ".join(f"{int(a[i]):02x}.{int(b[i]):02x}: {got[i]:02x} vs "
                    f"{want[i]:02x}" for i in bad[:4]))


@pytest.mark.parametrize("func", ARITH, ids=lambda f: f.name)
@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel_arith_every_pair(fmt, func):
    """SUM and PROD as the kernel computes them (f16 once, encode once,
    fixups) give the plain version's code for every pair."""
    a, b = _pairs()
    _held(kernel_arith(a, b, fmt, func), a, b, fmt, func)


@pytest.mark.parametrize("func", ORDER, ids=lambda f: f.name)
@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel_order_every_pair(fmt, func):
    """MAX and MIN on the codes give the plain version's code for every
    pair, +-0 ties and NaN codes included."""
    a, b = _pairs()
    _held(kernel_order(a, b, fmt, func), a, b, fmt, func)


def test_constants_are_the_kernels():
    """The thresholds and prmt selectors emulated here are the ones in
    csrc/fp8_hw.cuh."""
    src = SOURCE.read_text()
    defs = dict(re.findall(r"#define (\w+) (0x[0-9A-Fa-f]+)u", src))
    assert int(defs["E4M3_NAN_ABOVE_H"], 16) == LIMITS["float8_e4m3fn"][3]
    assert int(defs["E5M2_INF_FROM_H"], 16) == LIMITS["float8_e5m2"][3]
    assert int(defs["F16_NAN_ABOVE_H"], 16) == F16_NAN_ABOVE
    assert np.float16(LIMITS["float8_e4m3fn"][2]).view(np.uint16) == 0x5F40
    assert np.float16(LIMITS["float8_e5m2"][2]).view(np.uint16) == 0x7B80
    sels = set(re.findall(r"prmt\.b32 %0, %1, %2, (0x[0-9A-F]+);", src))
    assert sels == {"0xBA98", "0xFDB9"}
    assert "0x01010101u : 0x03030303u" in src
    for op in ("add.rn.f16x2", "mul.rn.f16x2", "cvt.rn.f16x2.e4m3x2",
               "cvt.rn.satfinite.e4m3x2.f16x2",
               "cvt.rn.satfinite.e5m2x2.f16x2"):
        assert op in src, op
