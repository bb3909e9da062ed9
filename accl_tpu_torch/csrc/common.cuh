// Shared definitions of the accl_tpu_torch kernels (CUDA C++, sm_90a).
//
// Every kernel covers up to ACCL_MAX_ROWS rank rows in one launch: the
// rows' pointers travel by value in the kernel's parameter block
// (grid.y = row), so a ring hop over W ranks is one launch, and rank r
// can read rank (r+1)%W's partial simply by being handed its pointer.
//
// Rounding is explicit throughout (the _rn intrinsics; the library is
// also built with --fmad=false): the codec must match the reference
// bit for bit, and a contracted multiply-add or an approximate divide
// is one ulp off.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ACCL_MAX_ROWS 32

struct Rows {
  const void* p[ACCL_MAX_ROWS];
};

struct MutRows {
  void* p[ACCL_MAX_ROWS];
};

enum { F_SUM = 0, F_MAX = 1, F_MIN = 2, F_PROD = 3 };
enum { W_INT8 = 0, W_E4M3 = 1, W_E5M2 = 2 };

typedef unsigned long long u64;

static inline Rows make_rows(const u64* ptrs, int n) {
  Rows r;
  for (int i = 0; i < ACCL_MAX_ROWS; ++i)
    r.p[i] = i < n ? reinterpret_cast<const void*>(ptrs[i]) : nullptr;
  return r;
}

static inline MutRows make_mut_rows(const u64* ptrs, int n) {
  MutRows r;
  for (int i = 0; i < ACCL_MAX_ROWS; ++i)
    r.p[i] = (ptrs != nullptr && i < n) ? reinterpret_cast<void*>(ptrs[i])
                                        : nullptr;
  return r;
}

// Grid width per row: enough blocks to cover `work` items at `per_block`
// items each, capped so all rows together stay near 2048 blocks.
static inline dim3 row_grid(long long work, long long per_block, int nrows) {
  long long need = (work + per_block - 1) / per_block;
  long long cap = 2048 / nrows;
  if (cap < 1) cap = 1;
  if (need < 1) need = 1;
  return dim3(static_cast<unsigned>(need < cap ? need : cap), nrows);
}

__device__ __forceinline__ bool sign_of(float a) {
  return (__float_as_uint(a) >> 31) != 0;
}

__device__ __forceinline__ bool sign_of(double a) {
  return __double_as_longlong(a) < 0;
}

// Maximum and minimum as jnp.maximum/jnp.minimum define them: a NaN
// operand is returned as it is (NaN propagates; fmaxf would drop it),
// and -0 orders below +0.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a > b) return a;
  if (b > a) return b;
  return sign_of(a) ? b : a;
}

template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a < b) return a;
  if (b < a) return b;
  return sign_of(a) ? a : b;
}

template <int F>
__device__ __forceinline__ float apply_f32(float a, float b) {
  if (F == F_SUM) return __fadd_rn(a, b);
  if (F == F_PROD) return __fmul_rn(a, b);
  if (F == F_MAX) return nan_max(a, b);
  return nan_min(a, b);
}

template <int F>
__device__ __forceinline__ double apply_f64(double a, double b) {
  if (F == F_SUM) return __dadd_rn(a, b);
  if (F == F_PROD) return __dmul_rn(a, b);
  if (F == F_MAX) return nan_max(a, b);
  return nan_min(a, b);
}

// -- wire codes ---------------------------------------------------------------
// f32 -> int8 / fp8 wire code with the reference's rules (accl_tpu/ops/
// compression.py `_bs_encode`, ml_dtypes' casts): fp8 by integer round-
// to-nearest-even on the f32 bits, e4m3fn overflow, inf and NaN -> NaN
// (0x7F), e5m2 overflow -> inf and NaN -> 0x7E, the sign kept; int8
// rounds half to even, clips to +-127 and maps non-finite values to 0.
// The hardware cvt is not used: its satfinite form clamps instead.
__device__ __forceinline__ uint32_t encode(float v, int wire) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t a = u & 0x7FFFFFFFu;
  if (wire == W_INT8) {
    if (a >= 0x7F800000u) return 0;  // non-finite -> 0
    float r = rintf(v);
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    return static_cast<uint32_t>(static_cast<uint8_t>(
        static_cast<int8_t>(static_cast<int>(r))));
  }
  const uint32_t sign = (u >> 31) << 7;
  const bool e4 = wire == W_E4M3;
  const int shift = e4 ? 20 : 21;
  const uint32_t rebias = e4 ? 960u : 448u;
  const uint32_t nmin = e4 ? 0x3C800000u : 0x38800000u;
  const uint32_t clamp = e4 ? 0x7Fu : 0x7Cu;
  const float dscale = e4 ? 512.0f : 65536.0f;
  uint32_t code;
  if (a < nmin) {
    // target denormal: scale into code units (exact) and round to even
    code = static_cast<uint32_t>(rintf(__fmul_rn(__uint_as_float(a), dscale)));
  } else {
    const uint32_t lsb = (a >> shift) & 1u;
    const uint32_t rne = (a + ((1u << (shift - 1)) - 1u) + lsb) >> shift;
    code = rne - rebias;
    if (code > clamp) code = clamp;
    if (!e4 && a > 0x7F800000u) code = 0x7Eu;  // e5m2 NaN
  }
  return sign | code;
}

__device__ __forceinline__ float decode(uint32_t c, int wire) {
  if (wire == W_INT8) return static_cast<float>(static_cast<int8_t>(c));
  const uint32_t sign = (c & 0x80u) << 24;
  uint32_t bits;
  if (wire == W_E4M3) {
    const uint32_t e = (c >> 3) & 0xFu, m = c & 7u;
    if (e == 15u && m == 7u) {
      bits = sign | 0x7FC00000u;
    } else if (e == 0u) {
      const float f = __fmul_rn(static_cast<float>(m), 0.001953125f);
      return sign ? -f : f;
    } else {
      bits = sign | ((e + 120u) << 23) | (m << 20);
    }
  } else {
    const uint32_t e = (c >> 2) & 0x1Fu, m = c & 3u;
    if (e == 31u) {
      bits = sign | (m ? 0x7FC00000u : 0x7F800000u);
    } else if (e == 0u) {
      const float f = __fmul_rn(static_cast<float>(m), 1.52587890625e-05f);
      return sign ? -f : f;
    } else {
      bits = sign | ((e + 112u) << 23) | (m << 21);
    }
  }
  return __uint_as_float(bits);
}

// running amax with NaN propagation: once m is NaN it stays NaN
__device__ __forceinline__ float amax_step(float m, float v) {
  v = fabsf(v);
  return (v > m || v != v) ? v : m;
}

__device__ __forceinline__ float warp_amax(float m) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    m = amax_step(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}
