// Helpers of the f32 attention routes on the tensor cores (attention.cu,
// attention_band_fwd.cu, attention_bwd.cu): 3xTF32 products on mma.sync m16n8k8, ldmatrix of
// 32-bit words, cp.async copies into shared memory, and the row-tile
// products of the backward and of the cluster forms.
//
// 3xTF32: an f32 operand a splits into hi = tf32(a) and lo = tf32(a - hi)
// (cvt.rna: 10 mantissa bits, ties away from zero), and a product a*b is
// formed as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b on the TF32 tensor cores,
// accumulated in f32: about the accuracy of an f32 product (the dropped
// lo_a*lo_b is below 2^-22 of it), at three tensor-core products.
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros, and nothing read, when !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
// 4 bytes from global to shared memory; zero when !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x4 tiles of 32-bit words from shared memory: lanes 8m..8m+7 give
// the row addresses of tile m (16-byte aligned), and register m of lane l
// receives tile m's word (l / 4, l % 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// hi = tf32(x) and lo = tf32(x - hi), rounded as cvt.rna.tf32.f32 rounds
// (half a TF32 ulp added to the bits, ties away from zero) on the integer
// pipe: hi with its 13 low bits cleared, so x - hi is exact; lo with them
// left for the tensor core, which reads the 19 high bits of a TF32
// operand. Finite values and infinities get cvt.rna's bits; a NaN x gives
// a NaN lo, so it still reaches the product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) + 0x1000u;
}

// An A operand (16 x 8, row major) split in two: a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4), g = lane / 4, t = lane % 4
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(int i, float x) {
    split_tf32(x, hi[i], lo[i]);
  }
};

// A B operand (8 x 8, column major) split in two: b0 (k t, n g), b1 (k t+4,
// n g)
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(int i, float x) {
    split_tf32(x, hi[i], lo[i]);
  }
};

// c += a * b, one TF32 tensor-core product; c (16 x 8): c0 (g, 2t), c1 (g,
// 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32: the two small products first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// R rows of `cols` floats (row r at src + r * stride) into shared memory
// at pitch P, DP columns, by 16-byte cp.async from NTH threads; rows at or
// past n and columns at or past cols are zeros, nothing past them read.
// UNROLL copies a thread are unrolled (all of them by default).
template <int DP, int R, int P, int NTH,
          int UNROLL = (R * DP / 4 + NTH - 1) / NTH>
__device__ __forceinline__ void cp_rows(float* dst, const float* src, int n,
                                        int cols, long long stride) {
  constexpr int CPR = DP / 4, N = R * CPR;
#pragma unroll(UNROLL)
  for (int p = 0; p < (N + NTH - 1) / NTH; ++p) {
    const int i = threadIdx.x + p * NTH;
    if (N % NTH != 0 && i >= N) break;
    const int r = i / CPR, c = (i % CPR) * 4;
    const bool ok = r < n && c < cols;
    cp_async16(dst + r * P + c, src + (ok ? r * stride + c : 0), ok);
  }
}

// x (16 x 32) = A B^T over the DP columns: A the 16 rows at a, B the 32
// rows at b (pitch DP + 4 each); x[j] holds columns 8j..8j+7. Operands by
// ldmatrix: A's tile m is rows 8*(m&1).., words 4*(m>>1)..; a pair of B's
// n-tiles is rows 8*(m>>1).., words 4*(m&1)... The column steps unrolled
// U at a time (all by default).
template <int DP, int U = DP / 8>
__device__ __forceinline__ void rows16_x_rows32(const float* a,
                                                const float* b,
                                                float (&x)[4][4]) {
  constexpr int P = DP + 4;
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  const float* pa = a + (r + 8 * (m & 1)) * P + 4 * (m >> 1);
  const float* pb = b + (r + 8 * (m >> 1)) * P + 4 * (m & 1);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.0f;
#pragma unroll(U)
  for (int c = 0; c < DP / 8; ++c) {
    uint32_t w[4];
    ldsm_x4(w, pa + 8 * c);
    FragA fa;
#pragma unroll
    for (int i = 0; i < 4; ++i) fa.set(i, __uint_as_float(w[i]));
#pragma unroll
    for (int jj = 0; jj < 4; jj += 2) {
      ldsm_x4(w, pb + 8 * jj * P + 8 * c);
      FragB f0, f1;
      f0.set(0, __uint_as_float(w[0]));
      f0.set(1, __uint_as_float(w[1]));
      f1.set(0, __uint_as_float(w[2]));
      f1.set(1, __uint_as_float(w[3]));
      mma_3xtf32(x[jj], fa, f0);
      mma_3xtf32(x[jj + 1], fa, f1);
    }
  }
}

// acc (16 x CW) += x (16 x 32) B, B the CW columns at b of 32 rows
// (pitch DP + 4). x is an accumulator (columns 2t, 2t+1 of a thread) and
// serves as the A operand with its columns standing as k = t, t + 4: B's
// rows are read in the same order, row 8j + 2t as k = t and 8j + 2t + 1
// as k = t + 4. The tile's 32 rows sum in a fresh accumulator, added to
// acc with an f32 add: the tensor core's accumulation (truncating) spans
// 12 products, not the whole sequence.
template <int DP, int CW>
__device__ __forceinline__ void rows_accumulate(float (&x)[4][4],
                                                const float* b,
                                                float (&acc)[CW / 8][4]) {
  constexpr int P = DP + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  FragA fa[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    fa[j].set(0, x[j][0]);
    fa[j].set(1, x[j][2]);
    fa[j].set(2, x[j][1]);
    fa[j].set(3, x[j][3]);
  }
  const float* row = b + 2 * t * P + g;
#pragma unroll
  for (int c = 0; c < CW / 8; ++c) {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragB fb;
      fb.set(0, row[8 * j * P + 8 * c]);
      fb.set(1, row[(8 * j + 1) * P + 8 * c]);
      mma_3xtf32(part, fa[j], fb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = __fadd_rn(acc[c][e], part[e]);
  }
}

}  // namespace
