// Kernel B1: elementwise two-operand reduction, out[r] = func(a[r], b[r])
// for every rank row r of one launch.
//
// Replaces accl_tpu/ops/combine.py `_combine_kernel` (launched by
// `combine_pallas`), the per-hop reduction of the ring collectives.
//
// Bound on the H100: bytes. Each element is read twice and written once
// (12 bytes per f32 element) against one arithmetic operation, far
// below the card's ops-per-byte balance, so the kernel is a stream
// (stream.cuh): one 16-byte vector of each operand a thread, one tile of
// 256 such steps a block, one block for each tile of the launch's rows.
// Rows whose pointers are not all 16-byte aligned, and ragged tails,
// take scalar accesses. out may alias a or b (the tree reduce works in
// place): each element is read before it is written, by the same
// thread.
//
// f16 and bf16 compute in f32 and round once; integers wrap (two's
// complement), as XLA and torch do. fp8 (e4m3fn, e5m2) takes a
// thread-step as four 32-bit words of four codes each, on the hardware's
// fp8 conversions (fp8_hw.cuh): SUM and PROD in f16 and encoded once,
// which gives the reference's codes (f32 arithmetic, one encode) for
// every pair, with its overflow and NaN codes; MAX and MIN on the codes.

#include "fp8_hw.cuh"
#include "stream.cuh"

template <int F>
struct OpF32 {
  typedef float S;
  static __device__ __forceinline__ S apply(S a, S b) {
    return apply_f32<F>(a, b);
  }
};

template <int F>
struct OpF64 {
  typedef double S;
  static __device__ __forceinline__ S apply(S a, S b) {
    return apply_f64<F>(a, b);
  }
};

template <int F>
struct OpF16 {
  typedef uint16_t S;
  static __device__ __forceinline__ S apply(S a, S b) {
    float r = apply_f32<F>(__half2float(__ushort_as_half(a)),
                           __half2float(__ushort_as_half(b)));
    return __half_as_ushort(__float2half_rn(r));
  }
};

template <int F>
struct OpBF16 {
  typedef uint16_t S;
  static __device__ __forceinline__ S apply(S a, S b) {
    float r = apply_f32<F>(__bfloat162float(__ushort_as_bfloat16(a)),
                           __bfloat162float(__ushort_as_bfloat16(b)));
    return __bfloat16_as_ushort(__float2bfloat16_rn(r));
  }
};

// fp8 codes of wire W (W_E4M3, W_E5M2), four a word (fp8_hw.cuh); the
// scalar accesses of a ragged or unaligned row take a word's low byte
template <int F, int W>
struct OpFP8 {
  typedef uint8_t S;
  static __device__ __forceinline__ S apply(S a, S b) {
    return static_cast<S>(fp8_apply4<F, W>(a, b));
  }
};

// integers: sums and products in the unsigned type of at least the same
// width, so overflow wraps instead of being undefined
template <int F, typename T, typename U>
struct OpInt {
  typedef T S;
  static __device__ __forceinline__ S apply(S a, S b) {
    if (F == F_SUM) return static_cast<S>(static_cast<U>(a) + static_cast<U>(b));
    if (F == F_PROD) return static_cast<S>(static_cast<U>(a) * static_cast<U>(b));
    if (F == F_MAX) return a > b ? a : b;
    return a < b ? a : b;
  }
};

// Thread-step s of a vector row: 16 bytes of each operand, one access
// each, and one apply an element
template <typename Op, typename S>
__device__ __forceinline__ void vector_step(Op, const S* pa, const S* pb,
                                            S* po, long long s) {
  typedef Pack<S, 16 / sizeof(S)> P;
  P x = reinterpret_cast<const P*>(pa)[s];
  const P y = reinterpret_cast<const P*>(pb)[s];
#pragma unroll
  for (int k = 0; k < 16 / int(sizeof(S)); ++k)
    x.v[k] = Op::apply(x.v[k], y.v[k]);
  reinterpret_cast<P*>(po)[s] = x;
}

// fp8: the 16 bytes as four words of four codes
template <int F, int W>
__device__ __forceinline__ void vector_step(OpFP8<F, W>, const uint8_t* pa,
                                            const uint8_t* pb, uint8_t* po,
                                            long long s) {
  uint4 x = reinterpret_cast<const uint4*>(pa)[s];
  const uint4 y = reinterpret_cast<const uint4*>(pb)[s];
  x.x = fp8_apply4<F, W>(x.x, y.x);
  x.y = fp8_apply4<F, W>(x.y, y.y);
  x.z = fp8_apply4<F, W>(x.z, y.z);
  x.w = fp8_apply4<F, W>(x.w, y.w);
  reinterpret_cast<uint4*>(po)[s] = x;
}

template <typename Op>
__global__ void combine_kernel(Rows a, Rows b, MutRows o, long long n) {
  typedef typename Op::S S;
  constexpr int V = 16 / sizeof(S);
  typedef Pack<S, V> P;
  const S* pa = static_cast<const S*>(a.p[blockIdx.y]);
  const S* pb = static_cast<const S*>(b.p[blockIdx.y]);
  S* po = static_cast<S*>(o.p[blockIdx.y]);
  const bool vec =
      aligned_for<P>(pa) && aligned_for<P>(pb) && aligned_for<P>(po);
  stream_tile<V>(
      vec, n, [&](long long s) { vector_step(Op(), pa, pb, po, s); },
      [&](long long i) { po[i] = Op::apply(pa[i], pb[i]); });
}

template <typename Op>
static void launch(const Rows& a, const Rows& b, const MutRows& o,
                   int nrows, long long n, cudaStream_t st) {
  constexpr int V = 16 / sizeof(typename Op::S);
  combine_kernel<Op><<<stream_grid<V>(n, nrows), STREAM_THREADS, 0, st>>>(
      a, b, o, n);
}

template <int F>
static int launch_dtype(int dtype, const Rows& a, const Rows& b,
                        const MutRows& o, int nrows, long long n,
                        cudaStream_t st) {
  switch (dtype) {
    case 0: launch<OpF32<F> >(a, b, o, nrows, n, st); break;
    case 1: launch<OpF16<F> >(a, b, o, nrows, n, st); break;
    case 2: launch<OpBF16<F> >(a, b, o, nrows, n, st); break;
    case 3: launch<OpF64<F> >(a, b, o, nrows, n, st); break;
    case 4: launch<OpInt<F, int32_t, uint32_t> >(a, b, o, nrows, n, st); break;
    case 5: launch<OpInt<F, long long, unsigned long long> >(a, b, o, nrows, n, st); break;
    case 6: launch<OpInt<F, int8_t, uint32_t> >(a, b, o, nrows, n, st); break;
    case 7: launch<OpFP8<F, W_E4M3> >(a, b, o, nrows, n, st); break;
    case 8: launch<OpFP8<F, W_E5M2> >(a, b, o, nrows, n, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// func: 0 SUM, 1 MAX, 2 MIN, 3 PROD. dtype: 0 f32, 1 f16, 2 bf16, 3 f64,
// 4 i32, 5 i64, 6 i8, 7 e4m3fn, 8 e5m2. a, b, out: host arrays of nrows device pointers,
// each row n elements. Returns cudaGetLastError() after the launch.
extern "C" int accl_combine(int func, int dtype, int nrows, long long n,
                            const u64* a, const u64* b, const u64* out,
                            void* stream) {
  if (nrows < 1 || nrows > ACCL_MAX_ROWS || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Rows ra = make_rows(a, nrows), rb = make_rows(b, nrows);
  MutRows ro = make_mut_rows(out, nrows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (func) {
    case F_SUM: return launch_dtype<F_SUM>(dtype, ra, rb, ro, nrows, n, st);
    case F_MAX: return launch_dtype<F_MAX>(dtype, ra, rb, ro, nrows, n, st);
    case F_MIN: return launch_dtype<F_MIN>(dtype, ra, rb, ro, nrows, n, st);
    case F_PROD: return launch_dtype<F_PROD>(dtype, ra, rb, ro, nrows, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
