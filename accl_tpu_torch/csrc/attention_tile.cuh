// Helpers shared by the attention kernels outside the 16-bit tensor-core
// routes (attention.cu: f32 B8, B9, B12 prefill; attention_decode.cu: B12
// decode; attention_bwd.cu: f32 B10, B11): the masked score, stores and
// 16-byte unpacking as f32, the shared-memory opt-in, the dtype x
// head-dim tier dispatches.
#pragma once

#include <float.h>

#include "common.cuh"

#include "attention_route.cuh"

namespace {

constexpr int NT = 256;  // threads per block of the backward (8 warps)
constexpr float NEG = -FLT_MAX;  // jnp.finfo(jnp.float32).min
// the last head dim of the single-token decode's split-KV route, every
// dtype (attention_decode.cu's wide kernel past 256); ops/attention.py
// DECODE_SPLIT_MAX_D
constexpr int DECODE_SPLIT_MAX_D = 2048;

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void st(__half* p, float v) {
  *p = __float2half_rn(v);
}

__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
// bf16 -> f32 is exact: the bf16 bits are the top half of the f32
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
// f16 -> f32 is exact
__device__ __forceinline__ void unpack(const uint4& u, float* f, __half) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// the largest dynamic shared memory a block may ask for on sm_90
constexpr int MAX_SMEM = 232448;

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// the power-of-two column tier (16 .. 256) that holds head dim d
__host__ __device__ constexpr int pow2_tier(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// dtype code (0 f32, 1 bf16, 2 f16) x the head dim's power-of-two tier
// -> one instantiation FN<T, DP>
#define POW2_DISPATCH(FN, ...)                                        \
  switch (dtype * 1000 + pow2_tier(head_dim)) {                       \
    case 16: return FN<float, 16>(__VA_ARGS__);                       \
    case 32: return FN<float, 32>(__VA_ARGS__);                       \
    case 64: return FN<float, 64>(__VA_ARGS__);                       \
    case 128: return FN<float, 128>(__VA_ARGS__);                     \
    case 256: return FN<float, 256>(__VA_ARGS__);                     \
    case 1016: return FN<__nv_bfloat16, 16>(__VA_ARGS__);             \
    case 1032: return FN<__nv_bfloat16, 32>(__VA_ARGS__);             \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);             \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);            \
    case 1256: return FN<__nv_bfloat16, 256>(__VA_ARGS__);            \
    case 2016: return FN<__half, 16>(__VA_ARGS__);                    \
    case 2032: return FN<__half, 32>(__VA_ARGS__);                    \
    case 2064: return FN<__half, 64>(__VA_ARGS__);                    \
    case 2128: return FN<__half, 128>(__VA_ARGS__);                   \
    case 2256: return FN<__half, 256>(__VA_ARGS__);                   \
    default: return cudaErrorInvalidValue;                            \
  }

// the f32 route's head dim (a multiple of 8, at most 256) -> the
// instantiation FN<DP> of its power-of-two tier
#define F32_DISPATCH(FN, ...)                                         \
  switch (pow2_tier(head_dim)) {                                      \
    case 16: return FN<16>(__VA_ARGS__);                              \
    case 32: return FN<32>(__VA_ARGS__);                              \
    case 64: return FN<64>(__VA_ARGS__);                              \
    case 128: return FN<128>(__VA_ARGS__);                            \
    case 256: return FN<256>(__VA_ARGS__);                            \
    default: return cudaErrorInvalidValue;                            \
  }
