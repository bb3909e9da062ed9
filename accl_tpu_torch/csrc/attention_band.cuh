// The band form's tiles and products, shared by the f32 attention kernels
// past head dim 4096 (attention_band_fwd.cu: B8, B9 and the B12 chunks;
// attention_bwd.cu: B10 and B11): a product over the whole head dim
// formed once a BTQ x BT tile of scores, in chunks of BCH columns, and
// kept in a workspace in device memory, from which a second product over
// SROWS reduced rows a step forms the outputs, BOUT columns a tile. Every
// warp holds 32 rows of its products (two 16-row MMA tiles on one B
// fragment, split once for both); each chunk's and each step's product is
// summed in a fresh accumulator and added in f32 (the tensor core
// truncates as it accumulates).
#pragma once

#include "attention_tile.cuh"
#include "tf32_mma.cuh"

namespace {

// streamed rows a stage: the backward's tiles below 4096 columns and the
// band form's product steps
constexpr int SROWS = 32;
constexpr int BT = 64;            // a score tile's keys; a band's granule
constexpr int BTQ = 128;          // a score tile's queries
constexpr int BCH = 32;           // head-dim columns a score chunk
constexpr int BCP = BCH + 4;      // their row pitch
constexpr int BSTAGE = 3;         // the score pass's cp.async stages
constexpr int BOUT = 128;         // output columns of a product tile
constexpr int BOP = BOUT + 8;     // their row pitch: rows t and t + 4 of a
                                  // B fragment in distinct banks
static_assert(BCH == SROWS, "a workspace tile's columns are a step's rows");

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// x[m] (16 x 32, rows a + 16m) += A B^T over DP columns for m = 0, 1: A's
// 32 rows at a, B's 32 rows at b (pitch DP + 4 each); each product in a
// fresh accumulator added in f32; B's fragments split once for both
template <int DP>
__device__ __forceinline__ void add_rows32_x_rows32(const float* a,
                                                    const float* b,
                                                    float (&x)[2][4][4]) {
  constexpr int P = DP + 4;
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  const float* pa = a + (r + 8 * (m & 1)) * P + 4 * (m >> 1);
  const float* pb = b + (r + 8 * (m >> 1)) * P + 4 * (m & 1);
  float part[2][4][4];
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mm][j][e] = 0.0f;
#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    FragA fa[2];
#pragma unroll
    for (int mm = 0; mm < 2; ++mm) {
      uint32_t w[4];
      ldsm_x4(w, pa + 16 * mm * P + 8 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) fa[mm].set(i, __uint_as_float(w[i]));
    }
#pragma unroll
    for (int jj = 0; jj < 4; jj += 2) {
      uint32_t w[4];
      ldsm_x4(w, pb + 8 * jj * P + 8 * c);
      FragB f0, f1;
      f0.set(0, __uint_as_float(w[0]));
      f0.set(1, __uint_as_float(w[1]));
      f1.set(0, __uint_as_float(w[2]));
      f1.set(1, __uint_as_float(w[3]));
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        mma_3xtf32(part[mm][jj], fa[mm], f0);
        mma_3xtf32(part[mm][jj + 1], fa[mm], f1);
      }
    }
  }
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[mm][j][e] = __fadd_rn(x[mm][j][e], part[mm][j][e]);
}

// acc[m] (16 x CW, rows 16m..) += A B over SROWS reduced rows for m = 0,
// 1: A the 32 rows at a (pitch BCP), B the SROWS rows at b (CW columns,
// pitch BOP); each 8 columns of acc summed over the rows in a fresh
// accumulator and added in f32. A by ldmatrix, its hi and lo parts kept
// over the columns; each B element read and split once for both m.
template <int CW>
__device__ __forceinline__ void band_accumulate(const float* a,
                                                const float* b,
                                                float (&acc)[2][CW / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m = lane >> 3, r = lane & 7;
  const float* pa = a + (r + 8 * (m & 1)) * BCP + 4 * (m >> 1);
  FragA fa[2][SROWS / 8];
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int kk = 0; kk < SROWS / 8; ++kk) {
      uint32_t w[4];
      ldsm_x4(w, pa + 16 * mm * BCP + 8 * kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) fa[mm][kk].set(i, __uint_as_float(w[i]));
    }
  const float* row = b + t * BOP + g;
#pragma unroll
  for (int c = 0; c < CW / 8; ++c) {
    float part[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < SROWS / 8; ++kk) {
      FragB fb;
      fb.set(0, row[8 * kk * BOP + 8 * c]);
      fb.set(1, row[(8 * kk + 4) * BOP + 8 * c]);
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) mma_3xtf32(part[mm], fa[mm][kk], fb);
    }
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mm][c][e] = __fadd_rn(acc[mm][c][e], part[mm][e]);
  }
}

}  // namespace
