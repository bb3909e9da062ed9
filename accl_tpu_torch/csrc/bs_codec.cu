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
// B5 and B6: one warp per scale block, grid-stride over the blocks of
// every rank row. Each lane takes 4 consecutive elements (one 16-byte
// load, one 4-byte code store) per step, so the warp covers 128 elements
// per step. B5 reads the block twice: once for the amax, once to encode;
// the second read hits L1/L2. B7 is a one-pass tile kernel: its own
// section below says how, and why it may use the hardware's fp8 cvt.
//
// Bit-exactness with the reference: every division is __fdiv_rn, every
// product __fmul_rn, every sum __fadd_rn, and the library is built with
// --fmad=false. B5 encodes fp8 with integer round-to-nearest-even on the
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
//
// One block of BS_THREADS threads for each tile of a row, on a (tiles,
// rows) grid as csrc/stream.cuh launches B1 and B2: no grid-stride loop
// and no cap. A thread-step is BS_STEP consecutive elements (one 16-byte
// load of `other`, one 4-byte load and store of codes); a tile is one
// step of every thread (BS_TILE elements), or S = block / BS_TILE steps
// when a scale block is larger, so a tile always holds whole scale
// blocks. Element j of thread t's step k is e0 + k * BS_TILE + BS_STEP *
// t + j, and its scale block is that index >> log2(block): no index is
// divided at run time.
//
// One pass: each element is loaded, decoded and combined once, into
// registers (acc). The requant mode takes the amax from those registers
// (segmented shuffles over block / BS_STEP lanes for blocks of at most
// 128; through shared memory, one barrier, for larger ones), computes
// the block's scale and its inverse once, encodes and stores. Positions
// past n stay out of the amax and are not stored.
//
// The encoder: in a scale block whose scale is good (FLT_MIN <= s < inf)
// every acc * inv is finite and at most qmax (1 + 3 * 2^-24), so the
// hardware's conversion (cvt.rn.satfinite.e4m3x2 / .e5m2x2, two values
// an instruction; int8 by round-to-nearest-even to int, no clamp needed)
// gives the integer encoder's codes, ties and denormals included. A
// block whose scale fell back to 1 (amax NaN, inf, 0 or below FLT_MIN *
// qmax) can hold NaN, inf or values past qmax, which satfinite would
// clamp: it keeps common.cuh's `encode`. The choice is made once per
// scale block.

#define BS_THREADS 256
#define BS_STEP 4
#define BS_TILE (BS_THREADS * BS_STEP)

// max with NaN propagation (any NaN wins; its bits do not matter: a NaN
// amax gives the scale 1, as amax_step's does)
__device__ __forceinline__ float nan_max_abs(float m, float v) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), "f"(fabsf(v)));
  return r;
}

// four products of a good scale block as one word of codes (element 0 in
// the low byte)
template <int WIRE>
__device__ __forceinline__ uint32_t encode4_good(const float v[4]) {
  if (WIRE == W_INT8) {
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w |= (static_cast<uint32_t>(__float2int_rn(v[k])) & 0xFFu) << (8 * k);
    return w;
  }
  // cvt's first source lands in the upper byte
  unsigned short lo, hi;
  if (WIRE == W_E4M3) {
    asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;" : "=h"(lo) : "f"(v[1]), "f"(v[0]));
    asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;" : "=h"(hi) : "f"(v[3]), "f"(v[2]));
  } else {
    asm("cvt.rn.satfinite.e5m2x2.f32 %0, %1, %2;" : "=h"(lo) : "f"(v[1]), "f"(v[0]));
    asm("cvt.rn.satfinite.e5m2x2.f32 %0, %1, %2;" : "=h"(hi) : "f"(v[3]), "f"(v[2]));
  }
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// thread-steps of one tile: one, or as many as a scale block larger than
// a tile needs
static int bs_steps(int block) { return block > BS_TILE ? block / BS_TILE : 1; }

// The tile's elements, decoded and combined: acc[k][j] = F(other, f32(q) *
// s) of element j of step k. FULL: a whole tile of rows aligned for the
// vector accesses; else bounds- and alignment-checked, zeros past n.
template <int WIRE, int F, int S, bool FULL>
__device__ __forceinline__ void combine_tile(const uint8_t* pq,
                                             const float* ps,
                                             const float* px, long long e0,
                                             long long n, int bshift,
                                             float acc[S][4]) {
  uint32_t c[S][4];
  float x[S][4], sc[S];
  const bool vq = al(pq, 3), vx = al(px, 15);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const long long i = e0 + k * BS_TILE + BS_STEP * threadIdx.x;
    if (FULL) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(pq + i);
      const float4 f = *reinterpret_cast<const float4*>(px + i);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[k][j] = (w >> (8 * j)) & 0xFFu;
      x[k][0] = f.x; x[k][1] = f.y; x[k][2] = f.z; x[k][3] = f.w;
      sc[k] = ps[(S > 1 ? e0 : i) >> bshift];
    } else {
      load4q(pq, i, n, vq, c[k]);
      load4(px, i, n, vx, x[k]);
      sc[k] = i < n ? ps[(S > 1 ? e0 : i) >> bshift] : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[k][j] = apply_f32<F>(x[k][j], __fmul_rn(decode(c[k][j], WIRE), sc[k]));
}

// The amax of each thread's scale block, from each thread's own m.
template <int S>
__device__ __forceinline__ float tile_amax(float m, int bshift, float* red) {
  const int lanes = S > 1 ? BS_THREADS : 1 << (bshift - 2);  // block / BS_STEP
  if (lanes <= 32) {
    for (int off = lanes >> 1; off; off >>= 1)
      m = nan_max_abs(m, __shfl_xor_sync(0xffffffffu, m, off));
    return m;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    m = nan_max_abs(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int warp = threadIdx.x >> 5, wpb = lanes >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = m;
  __syncthreads();
  const int w0 = warp & ~(wpb - 1);
  m = red[w0];
  for (int w = 1; w < wpb; ++w) m = nan_max_abs(m, red[w0 + w]);
  return m;
}

template <int WIRE, int F, bool REQUANT, int S, bool FULL>
__device__ __forceinline__ void bs_combine_tile(
    const Rows& q, const Rows& s, const Rows& other, const MutRows& q2,
    const MutRows& s2, const MutRows& out, long long n, int bshift,
    float qmax, long long e0) {
  const int r = blockIdx.y;
  float acc[S][4];
  combine_tile<WIRE, F, S, FULL>(static_cast<const uint8_t*>(q.p[r]),
                                 static_cast<const float*>(s.p[r]),
                                 static_cast<const float*>(other.p[r]), e0,
                                 n, bshift, acc);
  if (!REQUANT) {
    float* po = static_cast<float*>(out.p[r]);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const long long i = e0 + k * BS_TILE + BS_STEP * threadIdx.x;
      if (FULL)
        *reinterpret_cast<float4*>(po + i) =
            make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      else
        store4f(po, i, n, al(po, 15), acc[k]);
    }
    return;
  }
  __shared__ float red[BS_THREADS / 32];
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < S; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (FULL || e0 + k * BS_TILE + BS_STEP * threadIdx.x + j < n)
        m = nan_max_abs(m, acc[k][j]);
  m = tile_amax<S>(m, bshift, red);
  const float s0 = __fdiv_rn(m, qmax);
  const bool good = s0 >= __uint_as_float(0x00800000u) &&
                    s0 < __uint_as_float(0x7F800000u);
  const float sc2 = good ? s0 : 1.0f;
  const float inv = __fdiv_rn(1.0f, sc2);
  uint8_t* pq2 = static_cast<uint8_t*>(q2.p[r]);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const long long i = e0 + k * BS_TILE + BS_STEP * threadIdx.x;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(acc[k][j], inv);
    uint32_t w;
    if (good) {
      w = encode4_good<WIRE>(v);
    } else {
      w = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) w |= encode(v[j], WIRE) << (8 * j);
    }
    if (FULL) {
      *reinterpret_cast<uint32_t*>(pq2 + i) = w;
    } else {
      const uint32_t c[4] = {w & 0xFFu, (w >> 8) & 0xFFu, (w >> 16) & 0xFFu,
                             w >> 24};
      store4q(pq2, i, n, al(pq2, 3), c);
    }
  }
  // a scale block's first thread stores its scale
  const long long i0 = e0 + BS_STEP * threadIdx.x;
  if ((i0 & ((1LL << bshift) - 1)) == 0 && i0 < n)
    static_cast<float*>(s2.p[r])[i0 >> bshift] = sc2;
}

template <int WIRE, int F, bool REQUANT, int S>
__global__ void __launch_bounds__(BS_THREADS)
    bs_combine_kernel(Rows q, Rows s, Rows other, MutRows q2, MutRows s2,
                      MutRows out, long long n, int bshift, float qmax) {
  const int r = blockIdx.y;
  const long long e0 = static_cast<long long>(blockIdx.x) * BS_TILE * S;
  const bool aligned = al(q.p[r], 3) && al(other.p[r], 15) &&
                       (REQUANT ? al(q2.p[r], 3) : al(out.p[r], 15));
  if (aligned && e0 + BS_TILE * S <= n)
    bs_combine_tile<WIRE, F, REQUANT, S, true>(q, s, other, q2, s2, out, n,
                                               bshift, qmax, e0);
  else
    bs_combine_tile<WIRE, F, REQUANT, S, false>(q, s, other, q2, s2, out, n,
                                                bshift, qmax, e0);
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

template <int WIRE, int F, bool REQUANT, int S>
static void launch_tiles(cudaStream_t st, int nrows, const Rows& rq,
                         const Rows& rs, const Rows& rx, const MutRows& rq2,
                         const MutRows& rs2, const MutRows& ro, long long n,
                         int bshift) {
  constexpr long long TILE = static_cast<long long>(BS_TILE) * S;
  const dim3 grid(static_cast<unsigned>((n + TILE - 1) / TILE), nrows);
  bs_combine_kernel<WIRE, F, REQUANT, S><<<grid, BS_THREADS, 0, st>>>(
      rq, rs, rx, rq2, rs2, ro, n, bshift, qmax_of(WIRE));
}

// the round-closing mode needs no amax: one step a thread at every block
template <int WIRE, int F>
static void launch_combine(int requant, int block, cudaStream_t st,
                           int nrows, const Rows& rq, const Rows& rs,
                           const Rows& rx, const MutRows& rq2,
                           const MutRows& rs2, const MutRows& ro,
                           long long n) {
  const int bshift = __builtin_ctz(static_cast<unsigned>(block));
  if (!requant) {
    launch_tiles<WIRE, F, false, 1>(st, nrows, rq, rs, rx, rq2, rs2, ro, n, bshift);
    return;
  }
  switch (bs_steps(block)) {
    case 1: launch_tiles<WIRE, F, true, 1>(st, nrows, rq, rs, rx, rq2, rs2, ro, n, bshift); break;
    case 2: launch_tiles<WIRE, F, true, 2>(st, nrows, rq, rs, rx, rq2, rs2, ro, n, bshift); break;
    default: launch_tiles<WIRE, F, true, 4>(st, nrows, rq, rs, rx, rq2, rs2, ro, n, bshift); break;
  }
}

template <int WIRE>
static int combine_func(int func, int requant, int block, cudaStream_t st,
                        int nrows, const Rows& rq, const Rows& rs,
                        const Rows& rx, const MutRows& rq2,
                        const MutRows& rs2, const MutRows& ro, long long n) {
  switch (func) {
    case F_SUM: launch_combine<WIRE, F_SUM>(requant, block, st, nrows, rq, rs, rx, rq2, rs2, ro, n); break;
    case F_MAX: launch_combine<WIRE, F_MAX>(requant, block, st, nrows, rq, rs, rx, rq2, rs2, ro, n); break;
    case F_MIN: launch_combine<WIRE, F_MIN>(requant, block, st, nrows, rq, rs, rx, rq2, rs2, ro, n); break;
    case F_PROD: launch_combine<WIRE, F_PROD>(requant, block, st, nrows, rq, rs, rx, rq2, rs2, ro, n); break;
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
  switch (wire) {
    case W_INT8: return combine_func<W_INT8>(func, requant, block, st, nrows, rq, rs, rx, rq2, rs2, ro, n);
    case W_E4M3: return combine_func<W_E4M3>(func, requant, block, st, nrows, rq, rs, rx, rq2, rs2, ro, n);
    default: return combine_func<W_E5M2>(func, requant, block, st, nrows, rq, rs, rx, rq2, rs2, ro, n);
  }
}
