// Tile helpers shared by the CUDA-core attention kernels (attention.cu: f32
// B8, B9, B12 prefill; attention_decode.cu: B12 decode; attention_bwd.cu:
// B10, B11): 16-byte vector loads of row tiles into shared memory as f32,
// warp reductions, the dtype x head-dim dispatches.
#pragma once

#include <float.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block: 16 row groups x 16 lanes
constexpr int BK = 64;   // keys per tile
constexpr float NEG = -FLT_MAX;  // jnp.finfo(jnp.float32).min

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
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

// R rows of D elements (row r at src + r * stride), fetched as 16-byte
// vectors into registers, then stored to shared memory with row pitch P
// as f32. Splitting the two lets a block issue the next tile's global
// loads before the compute that hides their latency. Rows at or past n
// are zero: nothing past them is read.
template <typename T, int D, int R>
struct TileRegs {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int CHUNKS = R * D / VEC;
  static constexpr int PER = (CHUNKS + NT - 1) / NT;
  uint4 u[PER];

  __device__ __forceinline__ void fetch(const T* src, long long stride,
                                        int n) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = threadIdx.x + p * NT;
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      u[p] = (i < CHUNKS && r < n)
                 ? *reinterpret_cast<const uint4*>(src + r * stride + c)
                 : make_uint4(0, 0, 0, 0);
    }
  }

  template <int P>
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = threadIdx.x + p * NT;
      if (i >= CHUNKS) continue;
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      float f[VEC];
      unpack(u[p], f, T());
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[r * P + c + e] = f[e];
    }
  }
};

template <typename T, int D, int R, int P>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int n) {
  TileRegs<T, D, R> t;
  t.fetch(src, stride, n);
  t.template store<P>(dst);
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
