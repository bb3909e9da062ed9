// Kernels B5-B7: the block-scaled wire codec of the quantized ring.
//
//   B5 accl_bs_quant   replaces accl_tpu/ops/compression.py `_bs_quant_call`
//                      (body `_bs_quant_rows`, `_bs_encode`, `_bs_fp8_cast`)
//   B6 accl_bs_dequant replaces `_bs_dequant_call`
//   B7 accl_bs_combine replaces `_bs_combine_call` (dequant -> f32 combine
//                      [-> requantize against fresh scales])
//
// Per scale block of `block` elements (32..4096, a power of two):
//   amax = max |x| (NaN propagates), s = amax / qmax, s = 1 unless
//   FLT_MIN <= s < inf, q = encode(x * (1/s)); x' = float(q) * s.
//
// Bound on the H100: bytes (a handful of operations per 5 bytes moved).
// Design: one warp per scale block, grid-stride over the blocks of every
// rank row. Each lane takes 4 consecutive elements (one 16-byte load, one
// 4-byte code store) per step, so the warp covers 128 elements per step.
// B5 and B7 read the block twice: once for the amax, once to encode;
// the second read hits L1/L2. B7 recomputes the f32 partial in the
// second pass rather than storing it: the partial never reaches memory.
//
// Bit-exactness with the reference: every division is __fdiv_rn, every
// product __fmul_rn, every sum __fadd_rn, and the library is built with
// --fmad=false. fp8 is encoded with integer round-to-nearest-even on the
// f32 bits (common.cuh `encode`), never with the hardware cvt, whose
// satfinite form clamps where the reference makes NaN (e4m3fn) or inf
// (e5m2). A ragged last block reads zeros past the payload end:
// zeros cannot change the amax, which matches the reference's padding.

#include "common.cuh"

__device__ __forceinline__ float scale_of(float amax, float qmax) {
  const float s = __fdiv_rn(amax, qmax);
  const bool good = s >= __uint_as_float(0x00800000u) &&
                    s < __uint_as_float(0x7F800000u);
  return good ? s : 1.0f;
}

// 4 consecutive f32 starting at i (zeros past n)
__device__ __forceinline__ void load4(const float* p, long long i,
                                      long long n, bool vec, float v[4]) {
  if (vec && i + 3 < n) {
    const float4 f = *reinterpret_cast<const float4*>(p + i);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i + k < n ? p[i + k] : 0.0f;
  }
}

// 4 consecutive codes starting at i (zeros past n)
__device__ __forceinline__ void load4q(const uint8_t* p, long long i,
                                       long long n, bool vec, uint32_t c[4]) {
  if (vec && i + 3 < n) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p + i);
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = (w >> (8 * k)) & 0xFFu;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = i + k < n ? p[i + k] : 0u;
  }
}

__device__ __forceinline__ void store4q(uint8_t* p, long long i, long long n,
                                        bool vec, const uint32_t c[4]) {
  if (vec && i + 3 < n) {
    *reinterpret_cast<uint32_t*>(p + i) =
        c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k < n) p[i + k] = static_cast<uint8_t>(c[k]);
  }
}

__device__ __forceinline__ void store4f(float* p, long long i, long long n,
                                        bool vec, const float v[4]) {
  if (vec && i + 3 < n) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k < n) p[i + k] = v[k];
  }
}

__device__ __forceinline__ bool al(const void* p, unsigned m) {
  return (reinterpret_cast<uintptr_t>(p) & m) == 0;
}

struct WarpGrid {
  long long warp, nwarps;
  int lane;
  __device__ WarpGrid() {
    lane = threadIdx.x & 31;
    warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    nwarps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  }
};

// -- B5 ---------------------------------------------------------------------

template <int WIRE>
__global__ void bs_quant_kernel(Rows x, MutRows q, MutRows s, long long n,
                                int block, float qmax) {
  const int r = blockIdx.y;
  const float* px = static_cast<const float*>(x.p[r]);
  uint8_t* pq = static_cast<uint8_t*>(q.p[r]);
  float* ps = static_cast<float*>(s.p[r]);
  const bool vx = al(px, 15), vq = al(pq, 3);
  const long long nb = (n + block - 1) / block;
  WarpGrid g;
  for (long long blk = g.warp; blk < nb; blk += g.nwarps) {
    const long long base = blk * block;
    float m = 0.0f, v[4];
    for (int j = 4 * g.lane; j < block; j += 128) {
      load4(px, base + j, n, vx, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) m = amax_step(m, v[k]);
    }
    const float sc = scale_of(warp_amax(m), qmax);
    const float inv = __fdiv_rn(1.0f, sc);
    for (int j = 4 * g.lane; j < block; j += 128) {
      uint32_t c[4];
      load4(px, base + j, n, vx, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) c[k] = encode(__fmul_rn(v[k], inv), WIRE);
      store4q(pq, base + j, n, vq, c);
    }
    if (g.lane == 0) ps[blk] = sc;
  }
}

// -- B6 ---------------------------------------------------------------------

template <int WIRE>
__global__ void bs_dequant_kernel(Rows q, Rows s, MutRows o, long long n,
                                  int block) {
  const int r = blockIdx.y;
  const uint8_t* pq = static_cast<const uint8_t*>(q.p[r]);
  const float* ps = static_cast<const float*>(s.p[r]);
  float* po = static_cast<float*>(o.p[r]);
  const bool vq = al(pq, 3), vo = al(po, 15);
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // groups of 4 never straddle a scale block (block is a multiple of 4)
  for (long long i = 4 * tid; i < n; i += 4 * stride) {
    uint32_t c[4];
    float v[4];
    load4q(pq, i, n, vq, c);
    const float sc = ps[i / block];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __fmul_rn(decode(c[k], WIRE), sc);
    store4f(po, i, n, vo, v);
  }
}

// -- B7 ---------------------------------------------------------------------

template <int WIRE, int F>
__device__ __forceinline__ void combine4(const uint8_t* pq, const float* px,
                                         long long i, long long n, bool vq,
                                         bool vx, float sc, float acc[4]) {
  uint32_t c[4];
  float x[4];
  load4q(pq, i, n, vq, c);
  load4(px, i, n, vx, x);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    acc[k] = apply_f32<F>(x[k], __fmul_rn(decode(c[k], WIRE), sc));
}

template <int WIRE, int F, bool REQUANT>
__global__ void bs_combine_kernel(Rows q, Rows s, Rows other, MutRows q2,
                                  MutRows s2, MutRows out, long long n,
                                  int block, float qmax) {
  const int r = blockIdx.y;
  const uint8_t* pq = static_cast<const uint8_t*>(q.p[r]);
  const float* ps = static_cast<const float*>(s.p[r]);
  const float* px = static_cast<const float*>(other.p[r]);
  const bool vq = al(pq, 3), vx = al(px, 15);
  const long long nb = (n + block - 1) / block;
  WarpGrid g;
  for (long long blk = g.warp; blk < nb; blk += g.nwarps) {
    const long long base = blk * block;
    const float sc = ps[blk];
    float acc[4];
    if (!REQUANT) {
      float* po = static_cast<float*>(out.p[r]);
      for (int j = 4 * g.lane; j < block; j += 128) {
        combine4<WIRE, F>(pq, px, base + j, n, vq, vx, sc, acc);
        store4f(po, base + j, n, al(po, 15), acc);
      }
      continue;
    }
    uint8_t* pq2 = static_cast<uint8_t*>(q2.p[r]);
    float* ps2 = static_cast<float*>(s2.p[r]);
    float m = 0.0f;
    for (int j = 4 * g.lane; j < block; j += 128) {
      combine4<WIRE, F>(pq, px, base + j, n, vq, vx, sc, acc);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (base + j + k < n) m = amax_step(m, acc[k]);
    }
    const float sc2 = scale_of(warp_amax(m), qmax);
    const float inv = __fdiv_rn(1.0f, sc2);
    for (int j = 4 * g.lane; j < block; j += 128) {
      uint32_t c[4];
      combine4<WIRE, F>(pq, px, base + j, n, vq, vx, sc, acc);
#pragma unroll
      for (int k = 0; k < 4; ++k) c[k] = encode(__fmul_rn(acc[k], inv), WIRE);
      store4q(pq2, base + j, n, al(pq2, 3), c);
    }
    if (g.lane == 0) ps2[blk] = sc2;
  }
}

// -- C entry points -----------------------------------------------------------

static float qmax_of(int wire) {
  return wire == W_INT8 ? 127.0f : (wire == W_E4M3 ? 448.0f : 57344.0f);
}

static bool bad_args(int wire, int block, int nrows, long long n) {
  return wire < 0 || wire > 2 || block < 32 || block > 4096 ||
         (block & (block - 1)) != 0 || nrows < 1 || nrows > ACCL_MAX_ROWS ||
         n < 0;
}

// warps of 8 per 256-thread block: one scale block per warp and step
static dim3 warp_grid(long long nb, int nrows) { return row_grid(nb, 8, nrows); }

// x: nrows f32 rows of n; q: code rows (n bytes); s: scale rows (nb f32)
extern "C" int accl_bs_quant(int wire, int block, int nrows, long long n,
                             const u64* x, const u64* q, const u64* s,
                             void* stream) {
  if (bad_args(wire, block, nrows, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Rows rx = make_rows(x, nrows);
  MutRows rq = make_mut_rows(q, nrows), rs = make_mut_rows(s, nrows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid = warp_grid((n + block - 1) / block, nrows);
  const float qm = qmax_of(wire);
  switch (wire) {
    case W_INT8: bs_quant_kernel<W_INT8><<<grid, 256, 0, st>>>(rx, rq, rs, n, block, qm); break;
    case W_E4M3: bs_quant_kernel<W_E4M3><<<grid, 256, 0, st>>>(rx, rq, rs, n, block, qm); break;
    default: bs_quant_kernel<W_E5M2><<<grid, 256, 0, st>>>(rx, rq, rs, n, block, qm); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int accl_bs_dequant(int wire, int block, int nrows, long long n,
                               const u64* q, const u64* s, const u64* out,
                               void* stream) {
  if (bad_args(wire, block, nrows, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Rows rq = make_rows(q, nrows), rs = make_rows(s, nrows);
  MutRows ro = make_mut_rows(out, nrows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid = row_grid(n, 4 * 256, nrows);
  switch (wire) {
    case W_INT8: bs_dequant_kernel<W_INT8><<<grid, 256, 0, st>>>(rq, rs, ro, n, block); break;
    case W_E4M3: bs_dequant_kernel<W_E4M3><<<grid, 256, 0, st>>>(rq, rs, ro, n, block); break;
    default: bs_dequant_kernel<W_E5M2><<<grid, 256, 0, st>>>(rq, rs, ro, n, block); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <int WIRE, int F>
static void launch_combine(int requant, dim3 grid, cudaStream_t st,
                           const Rows& rq, const Rows& rs, const Rows& rx,
                           const MutRows& rq2, const MutRows& rs2,
                           const MutRows& ro, long long n, int block) {
  const float qm = qmax_of(WIRE);
  if (requant)
    bs_combine_kernel<WIRE, F, true><<<grid, 256, 0, st>>>(
        rq, rs, rx, rq2, rs2, ro, n, block, qm);
  else
    bs_combine_kernel<WIRE, F, false><<<grid, 256, 0, st>>>(
        rq, rs, rx, rq2, rs2, ro, n, block, qm);
}

template <int WIRE>
static int combine_func(int func, int requant, dim3 grid, cudaStream_t st,
                        const Rows& rq, const Rows& rs, const Rows& rx,
                        const MutRows& rq2, const MutRows& rs2,
                        const MutRows& ro, long long n, int block) {
  switch (func) {
    case F_SUM: launch_combine<WIRE, F_SUM>(requant, grid, st, rq, rs, rx, rq2, rs2, ro, n, block); break;
    case F_MAX: launch_combine<WIRE, F_MAX>(requant, grid, st, rq, rs, rx, rq2, rs2, ro, n, block); break;
    case F_MIN: launch_combine<WIRE, F_MIN>(requant, grid, st, rq, rs, rx, rq2, rs2, ro, n, block); break;
    case F_PROD: launch_combine<WIRE, F_PROD>(requant, grid, st, rq, rs, rx, rq2, rs2, ro, n, block); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q, s: received codes and scales; other: the local f32 operand. With
// requant != 0 the result is (q2, s2); else the f32 result lands in out.
extern "C" int accl_bs_combine(int func, int wire, int block, int requant,
                               int nrows, long long n, const u64* q,
                               const u64* s, const u64* other, const u64* q2,
                               const u64* s2, const u64* out, void* stream) {
  if (bad_args(wire, block, nrows, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Rows rq = make_rows(q, nrows), rs = make_rows(s, nrows),
       rx = make_rows(other, nrows);
  MutRows rq2 = make_mut_rows(q2, nrows), rs2 = make_mut_rows(s2, nrows),
          ro = make_mut_rows(out, nrows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid = warp_grid((n + block - 1) / block, nrows);
  switch (wire) {
    case W_INT8: return combine_func<W_INT8>(func, requant, grid, st, rq, rs, rx, rq2, rs2, ro, n, block);
    case W_E4M3: return combine_func<W_E4M3>(func, requant, grid, st, rq, rs, rx, rq2, rs2, ro, n, block);
    default: return combine_func<W_E5M2>(func, requant, grid, st, rq, rs, rx, rq2, rs2, ro, n, block);
  }
}
