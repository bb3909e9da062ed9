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
