// Helpers shared by the attention kernels outside the bf16 tensor-core
// route (attention.cu: f32 B8, B9, B12 prefill; attention_decode.cu: B12
// decode; attention_bwd.cu: f32 B10, B11): the masked score, stores and
// 16-byte unpacking as f32, the shared-memory opt-in, the dtype x
// head-dim dispatches.
#pragma once

#include <float.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block of the backward (8 warps)
constexpr float NEG = -FLT_MAX;  // jnp.finfo(jnp.float32).min

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

// dtype code (0 f32, 1 bf16) x head dim -> one instantiation
#define ATTN_DISPATCH(FN, ...)                                        \
  switch (dtype * 1000 + head_dim) {                                  \
    case 16: return FN<float, 16>(__VA_ARGS__);                       \
    case 32: return FN<float, 32>(__VA_ARGS__);                       \
    case 64: return FN<float, 64>(__VA_ARGS__);                       \
    case 128: return FN<float, 128>(__VA_ARGS__);                     \
    case 1016: return FN<__nv_bfloat16, 16>(__VA_ARGS__);             \
    case 1032: return FN<__nv_bfloat16, 32>(__VA_ARGS__);             \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);             \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);            \
    default: return cudaErrorInvalidValue;                            \
  }

// head dim -> the f32 instantiation
#define F32_DISPATCH(FN, ...)                                         \
  switch (head_dim) {                                                 \
    case 16: return FN<float, 16>(__VA_ARGS__);                       \
    case 32: return FN<float, 32>(__VA_ARGS__);                       \
    case 64: return FN<float, 64>(__VA_ARGS__);                       \
    case 128: return FN<float, 128>(__VA_ARGS__);                     \
    default: return cudaErrorInvalidValue;                            \
  }
