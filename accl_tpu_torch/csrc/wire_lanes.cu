// Kernels B2-B4: the per-tensor wire lanes of a collective hop.
//
//   B2 accl_cast        replaces accl_tpu/ops/compression.py `_cast_kernel`
//                       (`_cast_tiles`, `cast_lane`): f32 <-> f16, bf16,
//                       e4m3fn, e5m2, both directions
//   B3 accl_fp8_quant   replaces `_quant_kernel` (`compress_fp8`):
//                       q = encode(x * inv), one inv per row
//      accl_fp8_scale   the amax the reference reduces outside that kernel
//                       (`compress_fp8`, `fp8_quantize`): per row,
//                       amax = max |x| (NaN propagates),
//                       scale = max(amax * f32(1/fp8_max), 1e-30),
//                       inv = 1 / scale
//   B4 accl_fp8_dequant replaces `_dequant_kernel` (`decompress_fp8`):
//                       x' = float(q) * scale, one scale per row
//
// The scale is a reciprocal multiply, not a division: under jit XLA
// rewrites `amax / fp8_max` into `amax * (1 / fp8_max)`, so that is the
// reference's arithmetic. `1 / scale` divides by a runtime value and
// stays an IEEE division.
//
// Bound on the H100: bytes (one conversion per 5 or 6 bytes moved).
// B2 is a stream (stream.cuh): a thread-step converts 4 elements, one
// 16-byte f32 access and one 8- or 4-byte access of wire codes, a tile
// of 256 steps a block, one block for each tile of the launch's rows.
// (Wider steps, 16 bytes of codes a thread, measured slower: each
// warp-wide f32 access then covers every other 16 bytes, and the
// up-casts' strided stores cost most.) B3 and B4: grid-stride loops over
// every rank row of the launch (grid.y = row), 4 elements per thread and
// step: one 16-byte load of f32 and a 4-byte store of wire codes (or the
// reverse), where both row pointers allow it, else scalar accesses. The
// amax is a two-kernel reduction: per-block partial maxima into a
// scratch array (no atomics, so the result does not depend on block
// order), then one block per row folds them and writes the row's scale
// and inverse. The scale and the inverse stay in device memory: nothing
// syncs the host.
//
// Bit-exactness with the reference: f16 and bf16 round with
// __float2half_rn / __float2bfloat16_rn (round to nearest even, f16
// overflow to inf, bf16 denormals kept); NaNs are written by hand, as XLA
// writes them (f16: quiet, top payload bits kept; bf16: the canonical
// quiet NaN; back to f32 from f16: quiet, payload kept). fp8 uses the
// integer encoder of common.cuh; every product is __fmul_rn.

#include "stream.cuh"

enum { L_F32 = 0, L_F16 = 1, L_BF16 = 2, L_E4M3 = 3, L_E5M2 = 4 };

__device__ __forceinline__ uint32_t f16_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u)
    return ((u >> 16) & 0x8000u) | 0x7E00u | ((u & 0x7FFFFFu) >> 13);
  return __half_as_ushort(__float2half_rn(v));
}

__device__ __forceinline__ float f16_value(uint32_t h) {
  if ((h & 0x7FFFu) > 0x7C00u)
    return __uint_as_float(((h & 0x8000u) << 16) | 0x7FC00000u |
                           ((h & 0x3FFu) << 13));
  return __half2float(__ushort_as_half(static_cast<unsigned short>(h)));
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return ((u >> 16) & 0x8000u) | 0x7FC0u;
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// storage of one element of lane L and its conversions to and from f32
template <int L> struct Lane;

template <> struct Lane<L_F32> {
  typedef float S;
  static __device__ __forceinline__ float get(S s) { return s; }
  static __device__ __forceinline__ S put(float v) { return v; }
};

template <> struct Lane<L_F16> {
  typedef uint16_t S;
  static __device__ __forceinline__ float get(S s) { return f16_value(s); }
  static __device__ __forceinline__ S put(float v) {
    return static_cast<S>(f16_bits(v));
  }
};

template <> struct Lane<L_BF16> {
  typedef uint16_t S;
  static __device__ __forceinline__ float get(S s) {
    return __uint_as_float(static_cast<uint32_t>(s) << 16);
  }
  static __device__ __forceinline__ S put(float v) {
    return static_cast<S>(bf16_bits(v));
  }
};

template <int WIRE> struct Fp8Lane {
  typedef uint8_t S;
  static __device__ __forceinline__ float get(S s) { return decode(s, WIRE); }
  static __device__ __forceinline__ S put(float v) {
    return static_cast<S>(encode(v, WIRE));
  }
};

template <> struct Lane<L_E4M3> : Fp8Lane<W_E4M3> {};
template <> struct Lane<L_E5M2> : Fp8Lane<W_E5M2> {};

// a vector of 4 elements of `bytes` bytes each
template <int BYTES> struct Vec4;
template <> struct Vec4<4> { typedef uint4 T; };
template <> struct Vec4<2> { typedef uint2 T; };
template <> struct Vec4<1> { typedef uint32_t T; };

// 4 consecutive elements of lane L at i, as f32 (zeros past n)
template <int L>
__device__ __forceinline__ void get4(const void* p, long long i, long long n,
                                     bool vec, float v[4]) {
  typedef typename Lane<L>::S S;
  const S* s = static_cast<const S*>(p);
  if (vec && i + 3 < n) {
    const typename Vec4<sizeof(S)>::T w =
        *reinterpret_cast<const typename Vec4<sizeof(S)>::T*>(s + i);
    const S* e = reinterpret_cast<const S*>(&w);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = Lane<L>::get(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i + k < n ? Lane<L>::get(s[i + k]) : 0.0f;
  }
}

// store 4 f32 values as lane L at i (elements past n are not written)
template <int L>
__device__ __forceinline__ void put4(void* p, long long i, long long n,
                                     bool vec, const float v[4]) {
  typedef typename Lane<L>::S S;
  S* s = static_cast<S*>(p);
  if (vec && i + 3 < n) {
    typename Vec4<sizeof(S)>::T w;
    S* e = reinterpret_cast<S*>(&w);
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = Lane<L>::put(v[k]);
    *reinterpret_cast<typename Vec4<sizeof(S)>::T*>(s + i) = w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k < n) s[i + k] = Lane<L>::put(v[k]);
  }
}

template <int L>
__device__ __forceinline__ bool vec_ok(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(typename Lane<L>::S) - 1)) == 0;
}

struct Stride4 {
  long long first, step;
  __device__ Stride4() {
    first = 4 * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
    step = 4 * static_cast<long long>(gridDim.x) * blockDim.x;
  }
};

// -- B2 ---------------------------------------------------------------------

#define CAST_STEP 4   // elements a thread-step

template <int SRC, int DST>
__global__ void cast_kernel(Rows x, MutRows y, long long n) {
  typedef typename Lane<SRC>::S SS;
  typedef typename Lane<DST>::S DS;
  typedef Pack<SS, CAST_STEP> PI;
  typedef Pack<DS, CAST_STEP> PO;
  const SS* px = static_cast<const SS*>(x.p[blockIdx.y]);
  DS* py = static_cast<DS*>(y.p[blockIdx.y]);
  const bool vec = aligned_for<PI>(px) && aligned_for<PO>(py);
  stream_tile<CAST_STEP>(vec, n, [&](long long s) {
    const PI in = reinterpret_cast<const PI*>(px)[s];
    PO out;
#pragma unroll
    for (int k = 0; k < CAST_STEP; ++k)
      out.v[k] = Lane<DST>::put(Lane<SRC>::get(in.v[k]));
    reinterpret_cast<PO*>(py)[s] = out;
  }, [&](long long i) { py[i] = Lane<DST>::put(Lane<SRC>::get(px[i])); });
}

// -- B3: amax -> scale, inverse ----------------------------------------------

__device__ __forceinline__ float block_amax(float m) {
  __shared__ float part[32];
  m = warp_amax(m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = m;
  __syncthreads();
  m = 0.0f;
  if (warp == 0) {
    if (lane < (blockDim.x >> 5)) m = part[lane];
    m = warp_amax(m);
  }
  return m;  // valid in thread 0
}

__global__ void amax_partial_kernel(Rows x, float* partial, long long n) {
  const int r = blockIdx.y;
  const float* px = static_cast<const float*>(x.p[r]);
  const bool vec = vec_ok<L_F32>(px);
  Stride4 g;
  float m = 0.0f;
  for (long long i = g.first; i < n; i += g.step) {
    float v[4];
    get4<L_F32>(px, i, n, vec, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) m = amax_step(m, v[k]);
  }
  m = block_amax(m);
  if (threadIdx.x == 0) partial[r * gridDim.x + blockIdx.x] = m;
}

__global__ void scale_finish_kernel(const float* partial, int nparts,
                                    MutRows scale, MutRows inv, float rcp) {
  const int r = blockIdx.x;
  float m = 0.0f;
  for (int j = threadIdx.x; j < nparts; j += blockDim.x)
    m = amax_step(m, partial[r * nparts + j]);
  m = block_amax(m);
  if (threadIdx.x == 0) {
    // jnp.maximum: a NaN operand propagates
    float s = __fmul_rn(m, rcp);
    if (!(s != s) && s < 1e-30f) s = 1e-30f;
    static_cast<float*>(scale.p[r])[0] = s;
    static_cast<float*>(inv.p[r])[0] = __fdiv_rn(1.0f, s);
  }
}

// -- B3 / B4 -------------------------------------------------------------------

template <int WIRE>
__global__ void fp8_quant_kernel(Rows x, Rows inv, MutRows q, long long n) {
  const int r = blockIdx.y;
  const void* px = x.p[r];
  void* pq = q.p[r];
  const float iv = *static_cast<const float*>(inv.p[r]);
  const bool vec = vec_ok<L_F32>(px) && vec_ok<L_E4M3>(pq);
  Stride4 g;
  for (long long i = g.first; i < n; i += g.step) {
    float v[4];
    get4<L_F32>(px, i, n, vec, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __fmul_rn(v[k], iv);
    put4<WIRE == W_E4M3 ? L_E4M3 : L_E5M2>(pq, i, n, vec, v);
  }
}

template <int WIRE>
__global__ void fp8_dequant_kernel(Rows q, Rows scale, MutRows out,
                                   long long n) {
  const int r = blockIdx.y;
  const void* pq = q.p[r];
  void* po = out.p[r];
  const float sc = *static_cast<const float*>(scale.p[r]);
  const bool vec = vec_ok<L_E4M3>(pq) && vec_ok<L_F32>(po);
  Stride4 g;
  for (long long i = g.first; i < n; i += g.step) {
    float v[4];
    get4<WIRE == W_E4M3 ? L_E4M3 : L_E5M2>(pq, i, n, vec, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __fmul_rn(v[k], sc);
    put4<L_F32>(po, i, n, vec, v);
  }
}

// -- C entry points -----------------------------------------------------------

static dim3 grid4(long long n, int nrows) { return row_grid(n, 4 * 256, nrows); }

static bool bad_rows(int nrows, long long n) {
  return nrows < 1 || nrows > ACCL_MAX_ROWS || n < 0;
}

template <int SRC, int DST>
static void launch_cast(const Rows& x, const MutRows& y, int nrows,
                        long long n, cudaStream_t st) {
  cast_kernel<SRC, DST><<<stream_grid<CAST_STEP>(n, nrows), STREAM_THREADS,
                          0, st>>>(x, y, n);
}

// src, dst: lane codes (0 f32, 1 f16, 2 bf16, 3 e4m3fn, 4 e5m2); one of
// them is f32. x, y: host arrays of nrows device pointers of n elements.
extern "C" int accl_cast(int src, int dst, int nrows, long long n,
                         const u64* x, const u64* y, void* stream) {
  if (bad_rows(nrows, n)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Rows rx = make_rows(x, nrows);
  MutRows ry = make_mut_rows(y, nrows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pair = src * 8 + dst;
  switch (pair) {
    case L_F32 * 8 + L_F16: launch_cast<L_F32, L_F16>(rx, ry, nrows, n, st); break;
    case L_F32 * 8 + L_BF16: launch_cast<L_F32, L_BF16>(rx, ry, nrows, n, st); break;
    case L_F32 * 8 + L_E4M3: launch_cast<L_F32, L_E4M3>(rx, ry, nrows, n, st); break;
    case L_F32 * 8 + L_E5M2: launch_cast<L_F32, L_E5M2>(rx, ry, nrows, n, st); break;
    case L_F16 * 8 + L_F32: launch_cast<L_F16, L_F32>(rx, ry, nrows, n, st); break;
    case L_BF16 * 8 + L_F32: launch_cast<L_BF16, L_F32>(rx, ry, nrows, n, st); break;
    case L_E4M3 * 8 + L_F32: launch_cast<L_E4M3, L_F32>(rx, ry, nrows, n, st); break;
    case L_E5M2 * 8 + L_F32: launch_cast<L_E5M2, L_F32>(rx, ry, nrows, n, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// wire: 1 e4m3fn, 2 e5m2. x: nrows f32 rows of n; scale, inv: one f32
// each per row; partial: scratch of at least 2048 f32.
extern "C" int accl_fp8_scale(int wire, int nrows, long long n,
                              const u64* x, const u64* scale, const u64* inv,
                              void* partial, void* stream) {
  if (bad_rows(nrows, n) || (wire != W_E4M3 && wire != W_E5M2))
    return static_cast<int>(cudaErrorInvalidValue);
  Rows rx = make_rows(x, nrows);
  MutRows rs = make_mut_rows(scale, nrows), ri = make_mut_rows(inv, nrows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  const dim3 grid = grid4(n, nrows);
  amax_partial_kernel<<<grid, 256, 0, st>>>(rx, part, n);
  // f32(1 / fp8_max), an IEEE division on the host (the constant XLA
  // folds the reference's division into)
  const float rcp = 1.0f / (wire == W_E4M3 ? 448.0f : 57344.0f);
  scale_finish_kernel<<<nrows, 256, 0, st>>>(part, grid.x, rs, ri, rcp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int accl_fp8_quant(int wire, int nrows, long long n, const u64* x,
                              const u64* inv, const u64* q, void* stream) {
  if (bad_rows(nrows, n) || (wire != W_E4M3 && wire != W_E5M2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Rows rx = make_rows(x, nrows), ri = make_rows(inv, nrows);
  MutRows rq = make_mut_rows(q, nrows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wire == W_E4M3)
    fp8_quant_kernel<W_E4M3><<<grid4(n, nrows), 256, 0, st>>>(rx, ri, rq, n);
  else
    fp8_quant_kernel<W_E5M2><<<grid4(n, nrows), 256, 0, st>>>(rx, ri, rq, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int accl_fp8_dequant(int wire, int nrows, long long n,
                                const u64* q, const u64* scale,
                                const u64* out, void* stream) {
  if (bad_rows(nrows, n) || (wire != W_E4M3 && wire != W_E5M2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Rows rq = make_rows(q, nrows), rs = make_rows(scale, nrows);
  MutRows ro = make_mut_rows(out, nrows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wire == W_E4M3)
    fp8_dequant_kernel<W_E4M3><<<grid4(n, nrows), 256, 0, st>>>(rq, rs, ro, n);
  else
    fp8_dequant_kernel<W_E5M2><<<grid4(n, nrows), 256, 0, st>>>(rq, rs, ro, n);
  return static_cast<int>(cudaGetLastError());
}
