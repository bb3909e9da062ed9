// B1 on fp8 payloads (combine.cu `OpFP8`) on the H100's fp8
// conversions, four codes a 32-bit word (code k in byte k).
//
// common.cuh's software decode and encode (B2-B7 keep them) take some
// 40-60 instructions a value, with branches on the code: too many for a
// kernel that moves 3 bytes a value. Here a value takes a few:
//
// * SUM and PROD: decode to f16, exact for all 256 codes (e4m3fn pairs
//   through cvt.rn.f16x2.e4m3x2, an e5m2 code as the top byte of its
//   f16), one add.rn / mul.rn.f16x2 for two values, and one
//   cvt.rn.satfinite.{e4m3x2,e5m2x2}.f16x2 to encode them. The f16
//   result rounds once, the encode once more, and that gives the codes
//   the reference's f32 route gives (decode, f32 arithmetic, one
//   round-to-nearest-even encode) for every pair of codes of both
//   formats: f16 holds every fp8 rounding midpoint, and a sum or product
//   of two fp8 values that is not a midpoint never rounds onto one in
//   f16. That every-pair identity is checked, not derived: on the card
//   against the plain version (chip_smoke.py phase 3b), on the CPU
//   by tests/test_torch_fp8_encode_rule.py. satfinite clamps where the
//   reference overflows, so byte masks from the f16 result's bits put the
//   reference's codes back: e4m3fn |r| > 464 gives NaN (sign | 0x7F; 448
//   is the largest finite value and the tie at 464 rounds to it, its
//   mantissa even), e5m2 |r| >= 61440 gives inf (sign | 0x7C; the tie at
//   61440 rounds up, 57344's mantissa odd) and a NaN result 0x7F. An
//   e4m3fn NaN operand's code is returned as it is, a's first (XLA's
//   rule);
// * MAX and MIN never leave the codes: the result is an operand's code
//   (every finite code and e5m2's inf encode to themselves), chosen by a
//   sign-magnitude comparison of the bytes in which -0 orders below +0,
//   as nan_max and nan_min order them. NaN operands as XLA: e5m2 gives
//   0x7F, e4m3fn the NaN operand, and of two NaNs the negative (MAX) or
//   positive (MIN) one.
//
// Every selection is a byte mask, never a branch.
#pragma once

#include "common.cuh"

// f16 bits of the thresholds: |r| > 464 (0x5F40) is e4m3fn's NaN, |r| >=
// 61440 (0x7B80) e5m2's inf, |r| > 0x7C00 an f16 NaN. A lane's magnitude
// plus 0x8000 - threshold (- 1 for ">") carries into bit 15 exactly
// when the test holds, never out of the lane.
#define E4M3_NAN_ABOVE_H 0x5F40u
#define E5M2_INF_FROM_H 0x7B80u
#define F16_NAN_ABOVE_H 0x7C00u

// per 16-bit lane: x + (0x8000 - t), bit 15 set where the lane >= t
__device__ __forceinline__ uint32_t lanes_at_least(uint32_t x, uint32_t t) {
  return x + (0x8000u - t) * 0x00010001u;
}

// 0xFF in each byte whose bit 7 is set, else 0 (prmt's sign replication)
__device__ __forceinline__ uint32_t byte_sign_mask(uint32_t x) {
  uint32_t m;
  asm("prmt.b32 %0, %1, %2, 0xBA98;" : "=r"(m) : "r"(x), "r"(0u));
  return m;
}

// 0xFF in byte k where bit 15 of 16-bit lane k is set (lanes 0, 1 in x01,
// lanes 2, 3 in x23), else 0
__device__ __forceinline__ uint32_t lane_sign_mask(uint32_t x01,
                                                   uint32_t x23) {
  uint32_t m;
  asm("prmt.b32 %0, %1, %2, 0xFDB9;" : "=r"(m) : "r"(x01), "r"(x23));
  return m;
}

// bit 7 of each byte set where the code is NaN: e4m3fn S.1111.111, e5m2
// S.11111.mm with mm != 0 (the low seven bits plus one or three carry
// into bit 7 exactly then, never into the next byte)
template <int W>
__device__ __forceinline__ uint32_t nan_bits(uint32_t w) {
  return (w & 0x7F7F7F7Fu) + (W == W_E4M3 ? 0x01010101u : 0x03030303u);
}

// four codes -> two f16x2 words, exact (codes 0, 1 in h01 and 2, 3 in
// h23, code 2k in the low half)
template <int W>
__device__ __forceinline__ void decode4(uint32_t w, uint32_t& h01,
                                        uint32_t& h23) {
  if (W == W_E4M3) {
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h01)
        : "h"(static_cast<unsigned short>(w)));
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h23)
        : "h"(static_cast<unsigned short>(w >> 16)));
  } else {             // an e5m2 code is the top byte of its f16
    h01 = __byte_perm(w, 0, 0x1404);
    h23 = __byte_perm(w, 0, 0x3424);
  }
}

// two f16x2 words -> four codes, rounded to nearest even, clamped to the
// largest finite code (satfinite)
template <int W>
__device__ __forceinline__ uint32_t encode4_sat(uint32_t h01, uint32_t h23) {
  unsigned short lo, hi;
  if (W == W_E4M3) {
    asm("cvt.rn.satfinite.e4m3x2.f16x2 %0, %1;" : "=h"(lo) : "r"(h01));
    asm("cvt.rn.satfinite.e4m3x2.f16x2 %0, %1;" : "=h"(hi) : "r"(h23));
  } else {
    asm("cvt.rn.satfinite.e5m2x2.f16x2 %0, %1;" : "=h"(lo) : "r"(h01));
    asm("cvt.rn.satfinite.e5m2x2.f16x2 %0, %1;" : "=h"(hi) : "r"(h23));
  }
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// F_SUM or F_PROD of two f16x2 words, each lane rounded once
template <int F>
__device__ __forceinline__ uint32_t f16x2_apply(uint32_t x, uint32_t y) {
  uint32_t r;
  if (F == F_SUM)
    asm("add.rn.f16x2 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  else
    asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}

// SUM (F_SUM) or PROD (F_PROD) of four code pairs
template <int F, int W>
__device__ __forceinline__ uint32_t fp8_arith4(uint32_t a, uint32_t b) {
  uint32_t a01, a23, b01, b23;
  decode4<W>(a, a01, a23);
  decode4<W>(b, b01, b23);
  const uint32_t r01 = f16x2_apply<F>(a01, b01);
  const uint32_t r23 = f16x2_apply<F>(a23, b23);
  const uint32_t c = encode4_sat<W>(r01, r23);
  const uint32_t m01 = r01 & 0x7FFF7FFFu, m23 = r23 & 0x7FFF7FFFu;
  if (W == W_E4M3) {
    const uint32_t over =
        lane_sign_mask(lanes_at_least(m01, E4M3_NAN_ABOVE_H + 1),
                       lanes_at_least(m23, E4M3_NAN_ABOVE_H + 1));
    const uint32_t fixed = c | (over & 0x7F7F7F7Fu);
    const uint32_t na = byte_sign_mask(nan_bits<W>(a));
    const uint32_t nb = byte_sign_mask(nan_bits<W>(b));
    return (a & na) | (~na & ((b & nb) | (fixed & ~nb)));
  }
  // e5m2: over holds inf and NaN results too; a NaN then gives 0x7F
  const uint32_t over =
      lane_sign_mask(lanes_at_least(m01, E5M2_INF_FROM_H),
                     lanes_at_least(m23, E5M2_INF_FROM_H)) & 0x7F7F7F7Fu;
  const uint32_t nan =
      lane_sign_mask(lanes_at_least(m01, F16_NAN_ABOVE_H + 1),
                     lanes_at_least(m23, F16_NAN_ABOVE_H + 1));
  const uint32_t inf = (c & ~over) | (over & 0x7C7C7C7Cu);
  return (inf & ~nan) | (nan & 0x7F7F7F7Fu);
}

// MAX (F_MAX) or MIN (F_MIN) of four code pairs, on the codes
template <int F, int W>
__device__ __forceinline__ uint32_t fp8_minmax4(uint32_t a, uint32_t b) {
  // bit 7 of each byte: |a| >= |b| (no borrow leaves a byte)
  const uint32_t ge = (a | 0x80808080u) - (b & 0x7F7F7F7Fu);
  // bit 7: a is the maximum. Signs differ: a if it is positive (+0 over
  // -0); both positive: the larger magnitude; both negative: the smaller
  const uint32_t s = a ^ b;
  const uint32_t amax = (s & ~a) | (~s & (ge ^ a));
  const uint32_t na = nan_bits<W>(a), nb = nan_bits<W>(b);
  uint32_t take_a = F == F_MAX ? amax : ~amax;
  if (W == W_E4M3)     // a NaN operand wins; of two, a if it is the
                       // negative (MAX) or positive (MIN) one
    take_a = (na & (~nb | (F == F_MAX ? a : ~a))) | (~na & ~nb & take_a);
  const uint32_t m = byte_sign_mask(take_a);
  const uint32_t r = (a & m) | (b & ~m);
  if (W == W_E4M3) return r;
  const uint32_t n = byte_sign_mask(na | nb);   // e5m2: NaN gives 0x7F
  return (r & ~n) | (n & 0x7F7F7F7Fu);
}

template <int F, int W>
__device__ __forceinline__ uint32_t fp8_apply4(uint32_t a, uint32_t b) {
  return (F == F_SUM || F == F_PROD) ? fp8_arith4<F, W>(a, b)
                                     : fp8_minmax4<F, W>(a, b);
}
