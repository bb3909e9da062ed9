// Attention backward kernels B10 and B11 for 16-bit inputs (bf16 or f16,
// one template each) on Hopper's tensor cores (CUDA C++, sm_90a): wgmma
// with 16-bit operands and f32 accumulators, tiles brought into shared
// memory by TMA. The f32 inputs keep the kernels of attention_bwd.cu,
// whose C entry points send dtype codes 1 (bf16) and 2 (f16) here.
//
// Replace accl_tpu/ops/attention.py:
//   B10 attn_bwd_dkv_wgmma_kernel <- _bwd_dkv_kernel (pallas_call at :461):
//       per-q-head f32 partials of dK and dV (the GQA group sum runs
//       outside, as the reference's :522-523); past head dim 256
//       attn_bwd_dkv_cluster_wgmma_kernel (to 1024, a thread-block
//       cluster) and attn_bwd_dkv_cols_wgmma_kernel (past it).
//   B11 attn_bwd_dq_wgmma_kernel  <- _bwd_dq_kernel (:492): dQ in q's
//       dtype; past head dim 256 attn_bwd_dq_cluster_wgmma_kernel (past
//       640 to 2048, a thread-block cluster) and
//       attn_bwd_dq_cols_wgmma_kernel (the others).
//
// For a visible (query i, key j) pair, with s = q_i . k_j:
//   p = exp(scale*s - lse_i), dp = do_i . v_j, ds = p * (dp - delta_i),
//   dv_j += p * do_i, dk_j += scale * ds * q_i, dq_i += scale * ds * k_j.
// An invisible pair (key past Skv, query past Sq, or key j > query i
// under the top-left causal mask) takes p = 0 through the mask, never
// through exp of a masked score.
//
// Bound on an H100: 8*D (B10: S, dP, dV, dK) and 6*D (B11: S, dP, dQ)
// operations per visible score, against 989 TFLOP/s of 16-bit tensor
// cores; the bytes (q, do, k, v once, lse and delta, the outputs) are
// two orders of magnitude below that at S in the thousands, so both are
// bound by operations.
//
// What the design does about it: every product is a warpgroup MMA
// (wgmma m64nNk16, 16-bit x 16-bit -> f32), one warpgroup of 128 threads per
// block. The products are formed with the key tile as the M rows in B10
// (S^T = K Q^T, dP^T = V dO^T) and the q tile as the M rows in B11, so P
// and dS leave the accumulators as the 16-bit register operand A of the
// second products (dV += P^T dO, dK += dS^T Q; dQ += dS K) without a trip
// through shared memory. The second operand of those products is the
// same shared tile read MN-major (wgmma's transpose bit). Tiles are 64
// rows by 64-column blocks in the 128-byte swizzle that TMA writes and
// wgmma reads; TMA fills the columns past D < 64 and the rows past S of
// a head with zeros (a 3-D map: (B*H or B*Hkv, S, D)), which keeps the
// ragged and Sq != Skv cases inside their head.
//   B10: grid (B*H, key tiles), key tile 0, the heaviest under the causal
//   mask, dispatched first. K and V stay in shared memory; a loop over
//   64-row q tiles from the causal diagonal streams Q, dO (TMA) and LSE,
//   delta (cp.async) through a 2-stage ring, so the next tile loads while
//   this one computes. dK and dV (64 x D f32 each) stay in registers.
//   B11: grid (B*H, q tiles), the last q tile, the heaviest, dispatched
//   first. Q, dO, and the rows' LSE and delta stay resident; a loop over
//   64-key tiles up to the tile's causal frontier streams K and V through
//   a 2-stage ring. dQ (64 x D f32) stays in registers.
// Within a tile, S and dP are issued together and P is formed while dP
// completes. Only tiles on the causal diagonal or at a ragged edge apply
// the mask. Two blocks share an SM (about 98 KB of shared memory each at
// D = 128), so one block's exp and mask run beside the other's products.
//
// Head dims: instantiated on the column tiers DP of 64, 128, 192 and 256
// (sm90_tile.cuh Cols), the head dim D <= DP (a multiple of 8) at run
// time, the maps' extent D zero-filling the columns past it. B10 keeps
// dK and dV, 64 x NOUT f32 each, in one warpgroup's registers: NOUT = DP
// up to 128 (128 registers a thread at 128), but 64 x 256 twice would be
// 256 registers a thread. So at DP > 128 the output columns split across
// blocks (grid z): NOUT = 128 at DP = 256 (two blocks), 64 at DP = 192
// (three); each block forms S^T and dP^T over all DP columns and keeps
// its NOUT columns of dK and dV, which costs 12 instead of 8 products of
// D per score at DP = 256. B11 keeps dQ (64 x DP) whole: 128 registers a
// thread at DP = 256, as B10's pair at 128. Products over DP columns run
// one m64n128k16 for each 128 and one m64n64k16 for 64 left over.
// Rounding: q, do, k, v are 16-bit, so S and dP are exact products
// summed in f32. P and dS are f32 and are rounded to the input's type
// (round to nearest even) as the A operand of dV, dK and dQ, as
// FlashAttention-2 does; each term of those sums moves by less than one
// unit u of its magnitude, u = 2^-8 for bf16 and 2^-11 for f16, and for
// f16 a |dS| below 2^-14 (subnormal) by up to 2^-25 absolute. exp is
// ex2.approx with log2(e) folded into the scale and the LSE. The scale
// of dK and dQ is applied once, to the sums.
#include "sm90_tile.cuh"

namespace {

// 4 bytes from global to shared; zeros (nothing read) when !ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// ---- B10 ------------------------------------------------------------------

// the dK and dV columns a B10 block keeps at column tier DP
template <int DP>
__host__ __device__ constexpr int dkv_cols() {
  return DP <= 128 ? DP : DP % 128 == 0 ? 128 : 64;
}

// shared memory of B10: K, V (BKV rows), two stages of Q, dO (BQ rows) and
// of LSE, delta (BQ floats each), three barriers
template <int DP>
struct DkvSmem {
  static constexpr int KV = BKV * DP * 2;  // bytes of a K or V tile
  static constexpr int Q = BQ * DP * 2;    // bytes of a Q or dO tile
  static constexpr int STATS = 2 * KV + 4 * Q;      // offset of LSE, delta
  static constexpr int BARS = STATS + 4 * BQ * 4;
  static constexpr int BYTES = BARS + 3 * 8 + 1024;  // + alignment slack
};

// q/do maps: (B*H, Sq, D), box rows BQ; k/v maps: (B*Hkv, Skv, D), box
// rows BKV. lse/delta (B*H, Sq) f32; dk/dv (B*H, Skv, D) f32 per-q-head
// partials. Grid (B*H, key tiles, DP / NOUT): block z keeps columns
// z*NOUT .. z*NOUT + NOUT - 1.
template <typename T, int DP>
__global__ void __launch_bounds__(WG, 1)
    attn_bwd_dkv_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                              __grid_constant__ const CUtensorMap tdo,
                              __grid_constant__ const CUtensorMap tk,
                              __grid_constant__ const CUtensorMap tv,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int H, int Hkv, int Sq, int Skv, int causal,
                              int D, float scale) {
  using L = DkvSmem<DP>;
  constexpr int KS = Cols<DP>::KS, NOUT = dkv_cols<DP>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sK = base, sV = base + L::KV;
  float* stats = reinterpret_cast<float*>(gbase + L::STATS);  // [2][2][BQ]
  const uint32_t bar_kv = base + L::BARS;
  auto full = [&](int s) { return bar_kv + 8 + 8 * s; };
  auto sQ = [&](int s) { return base + 2 * L::KV + s * 2 * L::Q; };
  auto sDO = [&](int s) { return sQ(s) + L::Q; };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, k0 = blockIdx.y * BKV;
  const int c0 = blockIdx.z * NOUT;          // the block's first column
  const uint32_t cb = c0 / 64 * BQ * ROW;    // its offset in a Q/dO tile
  const int kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  // under the causal mask queries before k0 see none of these keys
  const int q_first = causal ? (k0 / BQ) * BQ : 0;
  const int n_it = q_first < Sq ? (Sq - q_first + BQ - 1) / BQ : 0;
  const float* lse_row = lse + static_cast<long long>(bh) * Sq;
  const float* delta_row = delta + static_cast<long long>(bh) * Sq;

  auto load_q = [&](int s, int q0) {  // one thread: Q, dO of stage s
    mbar_expect_tx(full(s), 2 * L::Q);
    tma_tile<DP, BQ>(sQ(s), &tq, full(s), q0, bh);
    tma_tile<DP, BQ>(sDO(s), &tdo, full(s), q0, bh);
  };
  auto load_stats = [&](int s, int q0) {  // every thread
    for (int i = tid; i < 2 * BQ; i += WG) {
      const int r = i % BQ, q = q0 + r;
      const float* src = (i < BQ ? lse_row : delta_row) + (q < Sq ? q : 0);
      cp_async4(smem_u32(stats + s * 2 * BQ + i), src, q < Sq);
    }
    cp_async_commit();
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(full(0), 1);
    mbar_init(full(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * L::KV);
    tma_tile<DP, BKV>(sK, &tk, bar_kv, k0, kvrow);
    tma_tile<DP, BKV>(sV, &tv, bar_kv, k0, kvrow);
    for (int s = 0; s < 2 && s < n_it; ++s) load_q(s, q_first + s * BQ);
  }
  for (int s = 0; s < 2; ++s) {
    if (s < n_it) load_stats(s, q_first + s * BQ);
    else cp_async_commit();
  }
  cp_async_wait<1>();  // stage 0's LSE and delta
  __syncthreads();

  float adk[NOUT / 2], adv[NOUT / 2];
#pragma unroll
  for (int i = 0; i < NOUT / 2; ++i) adk[i] = adv[i] = 0.0f;
  const float scale_log2 = scale * LOG2E;
  mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it & 1, q0 = q_first + it * BQ;
    mbar_wait(full(s), (it >> 1) & 1);
    float st[BQ / 2], dpt[BQ / 2];  // S^T and dP^T: keys x q rows
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.0f;
    fence_regs<BQ / 2>(st);
    fence_regs<BQ / 2>(dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<BQ>::ss<T>(st, desc_k<BKV>(sK, kk), desc_k<BQ>(sQ(s), kk),
                       kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<BQ>::ss<T>(dpt, desc_k<BKV>(sV, kk), desc_k<BQ>(sDO(s), kk),
                       kk > 0);
    wg_commit();

    const float* sl = stats + s * 2 * BQ;
    const float* sd = sl + BQ;
    wg_wait<1>();  // S^T; P^T is formed while dP^T completes
    fence_regs<BQ / 2>(st);
    if (k0 + BKV > Skv || q0 + BQ > Sq || (causal && k0 + BKV - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int key = k0 + frag_row(i), c = frag_col(i), q = q0 + c;
        st[i] = key < Skv && q < Sq && (!causal || key <= q)
                    ? ex2(fmaf(st[i], scale_log2, -sl[c] * LOG2E))
                    : 0.0f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        st[i] = ex2(fmaf(st[i], scale_log2, -sl[frag_col(i)] * LOG2E));
    }
    wg_wait<0>();  // dP^T
    fence_regs<BQ / 2>(dpt);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i)
      dpt[i] = __fmul_rn(st[i], __fsub_rn(dpt[i], sd[frag_col(i)]));
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    to_a<T, BQ>(st, pa);
    to_a<T, BQ>(dpt, da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      rs_cols<T, NOUT, BQ>(adv, pa[kk], sDO(s) + cb, kk);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      rs_cols<T, NOUT, BQ>(adk, da[kk], sQ(s) + cb, kk);
    wg_commit();
    wg_wait<0>();
    fence_regs<NOUT / 2>(adv);
    fence_regs<NOUT / 2>(adk);

    cp_async_wait<0>();  // the next stage's LSE and delta
    __syncthreads();     // every read of stage s is done
    if (it + 2 < n_it) {
      if (tid == 0) load_q(s, q0 + 2 * BQ);
      load_stats(s, q0 + 2 * BQ);
    }
  }

#pragma unroll
  for (int i = 0; i < NOUT / 2; i += 2) {
    const int key = k0 + frag_row(i), c = c0 + frag_col(i);
    if (key >= Skv || c >= D) continue;
    const long long o = (static_cast<long long>(bh) * Skv + key) * D + c;
    *reinterpret_cast<float2*>(dk + o) =
        make_float2(__fmul_rn(adk[i], scale), __fmul_rn(adk[i + 1], scale));
    *reinterpret_cast<float2*>(dv + o) = make_float2(adv[i], adv[i + 1]);
  }
}

// ---- B11 ------------------------------------------------------------------

// shared memory of B11: Q, dO (BQ rows), two stages of K, V (BKV rows),
// three barriers
template <int DP>
struct DqSmem {
  static constexpr int Q = BQ * DP * 2;
  static constexpr int KV = BKV * DP * 2;
  static constexpr int BARS = 2 * Q + 4 * KV;
  static constexpr int BYTES = BARS + 3 * 8 + 1024;
};

// two f32 as T, rounded to nearest even, into o[0], o[1]
__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* o, float a, float b) {
  *reinterpret_cast<__half2*>(o) = __floats2half2_rn(a, b);
}

// the same maps and operands as B10; dq (B*H, Sq, D) in T
template <typename T, int DP>
__global__ void __launch_bounds__(WG, 1)
    attn_bwd_dq_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                             __grid_constant__ const CUtensorMap tdo,
                             __grid_constant__ const CUtensorMap tk,
                             __grid_constant__ const CUtensorMap tv,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dq, int H, int Hkv, int Sq,
                             int Skv, int causal, int D, float scale) {
  using L = DqSmem<DP>;
  constexpr int KS = Cols<DP>::KS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base, sDO = base + L::Q;
  const uint32_t bar_q = base + L::BARS;
  auto full = [&](int s) { return bar_q + 8 + 8 * s; };
  auto sK = [&](int s) { return base + 2 * L::Q + s * 2 * L::KV; };
  auto sV = [&](int s) { return sK(s) + L::KV; };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  // the last q tile, the heaviest under the causal mask, first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int nq = min(BQ, Sq - q0);
  // causal frontier from the q tile's end: keys past its last row unseen
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;
  const int n_it = (kv_end + BKV - 1) / BKV;

  auto load_kv = [&](int s, int k0) {  // one thread: K, V of stage s
    mbar_expect_tx(full(s), 2 * L::KV);
    tma_tile<DP, BKV>(sK(s), &tk, full(s), k0, kvrow);
    tma_tile<DP, BKV>(sV(s), &tv, full(s), k0, kvrow);
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(full(0), 1);
    mbar_init(full(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * L::Q);
    tma_tile<DP, BQ>(sQ, &tq, bar_q, q0, bh);
    tma_tile<DP, BQ>(sDO, &tdo, bar_q, q0, bh);
    for (int s = 0; s < 2 && s < n_it; ++s) load_kv(s, s * BKV);
  }

  // this thread's two q rows: LSE (in log2 units) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + frag_row(2 * h);
    const long long o = static_cast<long long>(bh) * Sq + q;
    lse2[h] = q < Sq ? lse[o] * LOG2E : 0.0f;
    dl[h] = q < Sq ? delta[o] : 0.0f;
  }
  float adq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) adq[i] = 0.0f;
  const float scale_log2 = scale * LOG2E;
  mbar_wait(bar_q, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it & 1, k0 = it * BKV;
    mbar_wait(full(s), (it >> 1) & 1);
    float sc[BKV / 2], dp[BKV / 2];  // S and dP: q rows x keys
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = dp[i] = 0.0f;
    fence_regs<BKV / 2>(sc);
    fence_regs<BKV / 2>(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<BKV>::ss<T>(sc, desc_k<BQ>(sQ, kk), desc_k<BKV>(sK(s), kk),
                        kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<BKV>::ss<T>(dp, desc_k<BQ>(sDO, kk), desc_k<BKV>(sV(s), kk),
                        kk > 0);
    wg_commit();

    wg_wait<1>();  // S; P is formed while dP completes
    fence_regs<BKV / 2>(sc);
    if (k0 + BKV > Skv || q0 + BQ > Sq || (causal && k0 + BKV - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int q = q0 + frag_row(i), key = k0 + frag_col(i);
        sc[i] = key < Skv && q < Sq && (!causal || key <= q)
                    ? ex2(fmaf(sc[i], scale_log2, -lse2[(i >> 1) & 1]))
                    : 0.0f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i)
        sc[i] = ex2(fmaf(sc[i], scale_log2, -lse2[(i >> 1) & 1]));
    }
    wg_wait<0>();  // dP
    fence_regs<BKV / 2>(dp);
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i)
      dp[i] = __fmul_rn(sc[i], __fsub_rn(dp[i], dl[(i >> 1) & 1]));
    uint32_t da[BKV / 16][4];
    to_a<T, BKV>(dp, da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      rs_cols<T, DP, BKV>(adq, da[kk], sK(s), kk);
    wg_commit();
    wg_wait<0>();
    fence_regs<DP / 2>(adq);

    __syncthreads();  // every read of stage s is done
    if (it + 2 < n_it && tid == 0) load_kv(s, k0 + 2 * BKV);
  }

#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int r = frag_row(i), c = frag_col(i);
    if (r >= nq || c >= D) continue;
    const long long o = (static_cast<long long>(bh) * Sq + q0 + r) * D + c;
    store2(dq + o, __fmul_rn(adq[i], scale), __fmul_rn(adq[i + 1], scale));
  }
}

// ---- head dims past 256: the column-group form ------------------------------
//
// B11 at 256 < D <= BWD16_DQ_CLUSTER_MIN_D (640) and past
// BWD16_DQ_CLUSTER_MAX_D (2048), and B10 past BWD16_CLUSTER_MAX_D (1024; up
// to them both run the cluster forms below) (sm90_tile.cuh WCH, WGRP; D a
// multiple of WCH,
// which the wrapper pads it to, so every chunk and B10's groups are
// whole): grid z is a group of
// output columns (128 of dK and dV in B10, as B10 at DP = 256; WGRP of dQ
// in B11). For each streamed tile the block forms S and dP over the whole
// head dim, one WCH-column chunk a step (the chunks of Q, dO, K and V in
// one ring slot, read from shared memory), then the probabilities and dS
// as B10 and B11 do, and the second products on its group of columns (the
// next slot: Q's and dO's group in B10, K's in B11). Every group forms the
// same S and dP (the same chunks in the same order). LSE and delta are
// read from global memory.

constexpr int DKV_GRP = 128;  // dK, dV columns a B10 block keeps

// the steps of one streamed tile: the nch chunks, then the group's tiles;
// slot u & 1 holds step u, whose barrier completes phase (u >> 1) & 1
struct WideRing {
  uint32_t base;
  int n_steps;
  __device__ __forceinline__ uint32_t slot(int u) const {
    return base + (u & 1) * WSLOT;
  }
  __device__ __forceinline__ uint32_t bar(int u) const {
    return base + 2 * WSLOT + 8 * (u & 1);
  }
  __device__ __forceinline__ void wait(int u) const {
    mbar_wait(bar(u), (u >> 1) & 1);
  }
};

// S += A B^T over one chunk: A the RA-row chunk at sa, B the RB-row
// chunk at sb (both WCH columns)
template <typename T, int RA, int RB>
__device__ __forceinline__ void chunk_product(float* d, uint32_t sa,
                                              uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < Cols<WCH>::KS; ++kk)
    Wgmma<RB>::template ss<T>(d, desc_k<RA>(sa, kk), desc_k<RB>(sb, kk), 1);
}

// B10 at D > 256: the maps and operands of attn_bwd_dkv_wgmma_kernel;
// grid (B*H, key tiles, column groups of DKV_GRP)
template <typename T>
__global__ void __launch_bounds__(WG, 1)
    attn_bwd_dkv_cols_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                                   __grid_constant__ const CUtensorMap tdo,
                                   __grid_constant__ const CUtensorMap tk,
                                   __grid_constant__ const CUtensorMap tv,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   float* __restrict__ dk,
                                   float* __restrict__ dv, int H, int Hkv,
                                   int Sq, int Skv, int causal, int D,
                                   float scale) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t TB = BQ * WCH * 2;  // a 64-row chunk's bytes
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, k0 = blockIdx.y * BKV;
  const int c0 = blockIdx.z * DKV_GRP;
  const int kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int q_first = causal ? (k0 / BQ) * BQ : 0;
  const int n_it = q_first < Sq ? (Sq - q_first + BQ - 1) / BQ : 0;
  const int nch = wide_chunks(D), per = nch + 1;
  const WideRing ring{(smem_u32(smem_raw) + 1023) & ~1023u, n_it * per};
  const float* lse_row = lse + static_cast<long long>(bh) * Sq;
  const float* delta_row = delta + static_cast<long long>(bh) * Sq;

  // one thread: step u (chunk c of K, V, Q, dO; then Q's and dO's group)
  auto issue = [&](int u) {
    const int c = u % per, q0 = q_first + (u / per) * BQ;
    const uint32_t dst = ring.slot(u), b = ring.bar(u);
    if (c < nch) {
      const int col = c * WCH;
      mbar_expect_tx(b, 4 * TB);
      tma_tile<WCH, BKV>(dst, &tk, b, k0, kvrow, col);
      tma_tile<WCH, BKV>(dst + TB, &tv, b, k0, kvrow, col);
      tma_tile<WCH, BQ>(dst + 2 * TB, &tq, b, q0, bh, col);
      tma_tile<WCH, BQ>(dst + 3 * TB, &tdo, b, q0, bh, col);
    } else {
      mbar_expect_tx(b, 2 * TB);
      tma_tile<DKV_GRP, BQ>(dst, &tq, b, q0, bh, c0);
      tma_tile<DKV_GRP, BQ>(dst + TB, &tdo, b, q0, bh, c0);
    }
  };
  if (tid == 0) {
    mbar_init(ring.bar(0), 1);
    mbar_init(ring.bar(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int u = 0; u < 2 && u < ring.n_steps; ++u) issue(u);
  auto release = [&](int u) {
    __syncthreads();
    if (tid == 0 && u + 2 < ring.n_steps) issue(u + 2);
  };

  float adk[DKV_GRP / 2], adv[DKV_GRP / 2];
#pragma unroll
  for (int i = 0; i < DKV_GRP / 2; ++i) adk[i] = adv[i] = 0.0f;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    const int q0 = q_first + it * BQ;
    float st[BQ / 2], dpt[BQ / 2];  // S^T and dP^T: keys x q rows
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.0f;
    for (int c = 0; c < nch; ++c) {
      const int u = it * per + c;
      ring.wait(u);
      const uint32_t sl = ring.slot(u);
      fence_regs<BQ / 2>(st);
      fence_regs<BQ / 2>(dpt);
      wg_fence();
      chunk_product<T, BKV, BQ>(st, sl, sl + 2 * TB);
      chunk_product<T, BKV, BQ>(dpt, sl + TB, sl + 3 * TB);
      wg_commit();
      wg_wait<0>();
      fence_regs<BQ / 2>(st);
      fence_regs<BQ / 2>(dpt);
      release(u);
    }
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int key = k0 + frag_row(i), q = q0 + frag_col(i);
      const bool ok = key < Skv && q < Sq && (!causal || key <= q);
      st[i] = ok ? ex2(fmaf(st[i], scale_log2, -lse_row[q] * LOG2E)) : 0.0f;
      dpt[i] = __fmul_rn(st[i], __fsub_rn(dpt[i], ok ? delta_row[q] : 0.0f));
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    to_a<T, BQ>(st, pa);
    to_a<T, BQ>(dpt, da);
    const int u = it * per + nch;
    ring.wait(u);
    const uint32_t sq = ring.slot(u), sdo = sq + TB;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      rs_cols<T, DKV_GRP, BQ>(adv, pa[kk], sdo, kk);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      rs_cols<T, DKV_GRP, BQ>(adk, da[kk], sq, kk);
    wg_commit();
    wg_wait<0>();
    fence_regs<DKV_GRP / 2>(adv);
    fence_regs<DKV_GRP / 2>(adk);
    release(u);
  }

#pragma unroll
  for (int i = 0; i < DKV_GRP / 2; i += 2) {
    const int key = k0 + frag_row(i), c = c0 + frag_col(i);
    if (key >= Skv || c >= D) continue;
    const long long o = (static_cast<long long>(bh) * Skv + key) * D + c;
    *reinterpret_cast<float2*>(dk + o) =
        make_float2(__fmul_rn(adk[i], scale), __fmul_rn(adk[i + 1], scale));
    *reinterpret_cast<float2*>(dv + o) = make_float2(adv[i], adv[i + 1]);
  }
}

// ---- B10 at 256 < D <= 1024: the cluster form ---------------------------
//
// The column-group form above forms S^T and dP^T over the whole head dim
// in every group: (2C + 2) D products a tile for C groups where the work
// needs 4 D (2.5x at D 512, 4.5x at D 1024), and it reloads K and V with
// every q tile. Here a thread-block cluster of C = D / CSL blocks (grid z,
// clusters (1, 1, C), C from 3 to 8: the wrapper pads D to a multiple of
// CSL) owns one 64-key tile of one (b, h), and block c keeps one slice,
// columns CSL*c .. CSL*c + CSL - 1: the DP = 128 work of
// attn_bwd_dkv_wgmma_kernel on its slice, its register budget too (dK
// and dV, 64 x 128 f32 each, in the warpgroup's registers). K_c and V_c
// load once by TMA and stay resident; Q_c and dO_c stream through a ring
// of CRING stages, one 64-row q tile a stage from the causal diagonal,
// with the tile's LSE and delta. For each q tile:
//   1. the slice's partials S^T_c = K_c Q_c^T and dP^T_c = V_c dO_c^T
//      (m64n64k16, CSL / 16 k-steps each, exact 16-bit products summed in
//      f32);
//   2. the exchange. A thread's 32 + 32 accumulator registers form
//      CUNITS = 16 units, unit u = S^T's registers 2u, 2u + 1 and dP^T's
//      (one float4), and unit u of every thread belongs to block u % C,
//      its owner. Each block sends each unit it does not own to its owner
//      (st.async into the owner's receive slot for (unit, sender, thread),
//      counted on the owner's receive mbarrier); the owner's thread t sums
//      its own units over the C blocks in block order 0 .. C - 1 (its own
//      partial from its registers), so the bits do not depend on
//      arrival, forms P and dS at those two positions as the DP = 128
//      kernel does (exp2 of the scaled score less the LSE, dS = P (dP -
//      delta), the mask on the causal diagonal and ragged edges), rounds
//      them to T as the A operands of the second products take them, and
//      sends the two packed words to every other block (st.async into its
//      result slot for (unit, thread), counted on its result mbarrier);
//   3. every thread reads its other units' words from its own result
//      slots, and dV_c += P^T dO_c and dK_c += dS^T Q_c (m64n128k16) run
//      on the Q_c and dO_c tiles already in the ring.
// So S^T and dP^T are formed once a tile across the cluster, every block
// holds bitwise the same P and dS, and each position is summed and
// exponentiated once. What it costs instead: a block sends (C - 1) / C of
// 32 KB of partials and receives as much of 16 KB of results a tile over
// the cluster's network, and the tile's steps wait on each other, one
// warpgroup a block and one block an SM (about 190 KB of shared memory).
// Every remote access is a store (st.async, which does not wait for an
// answer as a remote load does), and no tile needs a cluster barrier:
// the mbarriers count the bytes, and one receive and one result buffer
// suffice, because a block sends tile i + 1's units only after it has
// every word of tile i, which each owner sends only after it has read
// tile i's units from its receive slots. The one cluster barrier before
// the loop makes sure every block's mbarriers are initialized before a
// peer stores to them; the one after it keeps every block resident until
// the cluster's last stores have landed. Thread 0 re-arms both mbarriers
// at the top of each tile (arrive plus the bytes expected), after its
// waits of the tile before: a peer's bytes that land first leave the
// phase pending until it does.
constexpr int CSL = 128;             // a block's slice of the head dim
constexpr int BWD16_CLUSTER_MAX_D = 8 * CSL;  // ops/attention.py's
constexpr int CUNITS = BQ / 4;       // a thread's units of S^T and dP^T
constexpr int CRING = 3;             // stages of Q_c and dO_c

// the receive slots of CUNITS units dealt over C blocks (ceil(16 / C)
// units an owner, a slot for each block), the most over C = 3 .. 8
__host__ __device__ constexpr int cl_slots() {
  int m = 0;
  for (int c = 3; c <= BWD16_CLUSTER_MAX_D / CSL; ++c)
    m = (CUNITS + c - 1) / c * c > m ? (CUNITS + c - 1) / c * c : m;
  return m;
}

// shared memory of the cluster B10: K_c, V_c; CRING stages of Q_c, dO_c;
// their LSE and delta; the receive slots (a float4 a thread); the result
// slots (two packed words a thread); the barriers (K/V, the stages,
// receive, result)
struct ClSmem {
  static constexpr int KV = BKV * CSL * 2;
  static constexpr int Q = BQ * CSL * 2;
  static constexpr int RING = 2 * KV;
  static constexpr int STATS = RING + CRING * 2 * Q;
  static constexpr int RCV = STATS + CRING * 2 * BQ * 4;
  static constexpr int RES = RCV + cl_slots() * WG * 16;
  static constexpr int BARS = RES + CUNITS * WG * 8;
  static constexpr int BYTES = BARS + (CRING + 3) * 8 + 1024;
  static_assert(BYTES <= 232448, "a block's shared memory");
};

// the maps and operands of attn_bwd_dkv_wgmma_kernel; grid (B*H, key
// tiles, C), clusters (1, 1, C), D = C * CSL
template <typename T>
__global__ void __launch_bounds__(WG, 1)
    attn_bwd_dkv_cluster_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                                      __grid_constant__ const CUtensorMap tdo,
                                      __grid_constant__ const CUtensorMap tk,
                                      __grid_constant__ const CUtensorMap tv,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta,
                                      float* __restrict__ dk,
                                      float* __restrict__ dv, int H, int Hkv,
                                      int Sq, int Skv, int causal, int D,
                                      float scale) {
  using L = ClSmem;
  constexpr int KS = Cols<CSL>::KS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sK = base, sV = base + L::KV;
  auto sQ = [&](int s) { return base + L::RING + s * 2 * L::Q; };
  auto sDO = [&](int s) { return sQ(s) + L::Q; };
  float* stats = reinterpret_cast<float*>(gbase + L::STATS);  // [s][2][BQ]
  const float4* rcv = reinterpret_cast<const float4*>(gbase + L::RCV);
  const uint2* res = reinterpret_cast<const uint2*>(gbase + L::RES);
  const uint32_t bar_kv = base + L::BARS;
  auto full = [&](int s) { return bar_kv + 8 + 8 * s; };
  const uint32_t bar_rcv = full(CRING), bar_res = bar_rcv + 8;

  const int tid = threadIdx.x;
  const int C = gridDim.z, rank = cluster_rank();
  const int bh = blockIdx.x, k0 = blockIdx.y * BKV, col0 = rank * CSL;
  const int kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  // under the causal mask queries before k0 see none of these keys
  const int q_first = causal ? (k0 / BQ) * BQ : 0;
  const int n_it = q_first < Sq ? (Sq - q_first + BQ - 1) / BQ : 0;
  const float* lse_row = lse + static_cast<long long>(bh) * Sq;
  const float* delta_row = delta + static_cast<long long>(bh) * Sq;
  const int own = (CUNITS - rank + C - 1) / C;  // the units this block owns

  auto load_q = [&](int s, int q0) {  // one thread: Q_c, dO_c of stage s
    mbar_expect_tx(full(s), 2 * L::Q);
    tma_tile<CSL, BQ>(sQ(s), &tq, full(s), q0, bh, col0);
    tma_tile<CSL, BQ>(sDO(s), &tdo, full(s), q0, bh, col0);
  };
  auto load_stats = [&](int s, int q0) {  // every thread
    for (int i = tid; i < 2 * BQ; i += WG) {
      const int r = i % BQ, q = q0 + r;
      const float* src = (i < BQ ? lse_row : delta_row) + (q < Sq ? q : 0);
      cp_async4(smem_u32(stats + s * 2 * BQ + i), src, q < Sq);
    }
    cp_async_commit();
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < CRING; ++s) mbar_init(full(s), 1);
    mbar_init(bar_rcv, 1);
    mbar_init(bar_res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * L::KV);
    tma_tile<CSL, BKV>(sK, &tk, bar_kv, k0, kvrow, col0);
    tma_tile<CSL, BKV>(sV, &tv, bar_kv, k0, kvrow, col0);
    for (int s = 0; s < CRING && s < n_it; ++s) load_q(s, q_first + s * BQ);
  }
  for (int s = 0; s < CRING; ++s) {
    if (s < n_it) load_stats(s, q_first + s * BQ);
    else cp_async_commit();
  }
  cp_async_wait<CRING - 1>();  // stage 0's LSE and delta
  cluster_sync();  // every block's barriers are set: its peers may store

  float adk[CSL / 2], adv[CSL / 2];
#pragma unroll
  for (int i = 0; i < CSL / 2; ++i) adk[i] = adv[i] = 0.0f;
  const float scale_log2 = scale * LOG2E;
  const uint32_t rcv_a = base + L::RCV, res_a = base + L::RES;
  mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % CRING, q0 = q_first + it * BQ;
    if (tid == 0) {  // this tile's phase of the receive and result bars
      mbar_expect_tx(bar_rcv, own * (C - 1) * WG * 16);
      mbar_expect_tx(bar_res, (CUNITS - own) * WG * 8);
    }
    mbar_wait(full(s), (it / CRING) & 1);
    float st[BQ / 2], dpt[BQ / 2];  // S^T_c and dP^T_c: keys x q rows
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.0f;
    fence_regs<BQ / 2>(st);
    fence_regs<BQ / 2>(dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<BQ>::ss<T>(st, desc_k<BKV>(sK, kk), desc_k<BQ>(sQ(s), kk),
                       kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<BQ>::ss<T>(dpt, desc_k<BKV>(sV, kk), desc_k<BQ>(sDO(s), kk),
                       kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs<BQ / 2>(st);
    fence_regs<BQ / 2>(dpt);

    // each unit this block does not own, to its owner's slot (unit,
    // sender, thread)
#pragma unroll
    for (int u = 0; u < CUNITS; ++u) {
      const int o = u % C;
      if (o != rank)
        st_async4(peer(rcv_a + (((u / C) * C + rank) * WG + tid) * 16, o),
                  st[2 * u], st[2 * u + 1], dpt[2 * u], dpt[2 * u + 1],
                  peer(bar_rcv, o));
    }
    const float* sl = stats + s * 2 * BQ;
    const float* sd = sl + BQ;
    const bool edge =
        k0 + BKV > Skv || q0 + BQ > Sq || (causal && k0 + BKV - 1 > q0);
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    mbar_wait_cluster(bar_rcv, it & 1);
    // the units this block owns: the C partials in block order, P and dS
#pragma unroll
    for (int u = 0; u < CUNITS; ++u) {
      if (u % C != rank) continue;
      const float4 mine = make_float4(st[2 * u], st[2 * u + 1], dpt[2 * u],
                                      dpt[2 * u + 1]);
      const float4* slot = rcv + (u / C) * C * WG + tid;  // block b's:
      float4 x = rank == 0 ? mine : slot[0];              // slot[b * WG]
#pragma unroll
      for (int b = 1; b < 8; ++b) {
        if (b >= C) break;
        const float4 y = b == rank ? mine : slot[b * WG];
        x = make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y),
                        __fadd_rn(x.z, y.z), __fadd_rn(x.w, y.w));
      }
      const float sx[2] = {x.x, x.y}, dx[2] = {x.z, x.w};
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * u + e, key = k0 + frag_row(i), c = frag_col(i);
        const int q = q0 + c;
        const bool ok =
            !edge || (key < Skv && q < Sq && (!causal || key <= q));
        p[e] = ok ? ex2(fmaf(sx[e], scale_log2, -sl[c] * LOG2E)) : 0.0f;
        ds[e] = __fmul_rn(p[e], __fsub_rn(dx[e], sd[c]));
      }
      const uint32_t pw = Elt<T>::pack(p[0], p[1]);
      const uint32_t dw = Elt<T>::pack(ds[0], ds[1]);
      pa[u / 4][u % 4] = pw;
      da[u / 4][u % 4] = dw;
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (b < C && b != rank)
          st_async2(peer(res_a + (u * WG + tid) * 8, b), pw, dw,
                    peer(bar_res, b));
    }
    mbar_wait_cluster(bar_res, it & 1);
#pragma unroll
    for (int u = 0; u < CUNITS; ++u) {
      if (u % C == rank) continue;
      const uint2 w = res[u * WG + tid];
      pa[u / 4][u % 4] = w.x;
      da[u / 4][u % 4] = w.y;
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      rs_cols<T, CSL, BQ>(adv, pa[kk], sDO(s), kk);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      rs_cols<T, CSL, BQ>(adk, da[kk], sQ(s), kk);
    wg_commit();
    wg_wait<0>();
    fence_regs<CSL / 2>(adv);
    fence_regs<CSL / 2>(adk);

    cp_async_wait<CRING - 2>();  // the next stage's LSE and delta
    __syncthreads();             // every read of stage s is done
    if (it + CRING < n_it) {
      if (tid == 0) load_q(s, q0 + CRING * BQ);
      load_stats(s, q0 + CRING * BQ);
    } else {
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  cluster_sync();  // the cluster's last stores have landed

#pragma unroll
  for (int i = 0; i < CSL / 2; i += 2) {
    const int key = k0 + frag_row(i), c = col0 + frag_col(i);
    if (key >= Skv) continue;
    const long long o = (static_cast<long long>(bh) * Skv + key) * D + c;
    *reinterpret_cast<float2*>(dk + o) =
        make_float2(__fmul_rn(adk[i], scale), __fmul_rn(adk[i + 1], scale));
    *reinterpret_cast<float2*>(dv + o) = make_float2(adv[i], adv[i + 1]);
  }
}

// B11 at D > 256: the maps and operands of attn_bwd_dq_wgmma_kernel; grid
// (B*H, q tiles, column groups of WGRP)
template <typename T>
__global__ void __launch_bounds__(WG, 1)
    attn_bwd_dq_cols_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                                  __grid_constant__ const CUtensorMap tdo,
                                  __grid_constant__ const CUtensorMap tk,
                                  __grid_constant__ const CUtensorMap tv,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  T* __restrict__ dq, int H, int Hkv, int Sq,
                                  int Skv, int causal, int D, float scale) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t TB = BQ * WCH * 2;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int c0 = blockIdx.z * WGRP;
  const int kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int nq = min(BQ, Sq - q0);
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;
  const int n_it = (kv_end + BKV - 1) / BKV;
  const int nch = wide_chunks(D), per = nch + 1;
  const WideRing ring{(smem_u32(smem_raw) + 1023) & ~1023u, n_it * per};

  // one thread: step u (chunk c of Q, dO, K, V; then K's group)
  auto issue = [&](int u) {
    const int c = u % per, kt = (u / per) * BKV;
    const uint32_t dst = ring.slot(u), b = ring.bar(u);
    if (c < nch) {
      const int col = c * WCH;
      mbar_expect_tx(b, 4 * TB);
      tma_tile<WCH, BQ>(dst, &tq, b, q0, bh, col);
      tma_tile<WCH, BQ>(dst + TB, &tdo, b, q0, bh, col);
      tma_tile<WCH, BKV>(dst + 2 * TB, &tk, b, kt, kvrow, col);
      tma_tile<WCH, BKV>(dst + 3 * TB, &tv, b, kt, kvrow, col);
    } else {
      mbar_expect_tx(b, live_bytes<WGRP, BKV>(c0, D));
      tma_tile_live<WGRP, BKV>(dst, &tk, b, kt, kvrow, c0, D);
    }
  };
  if (tid == 0) {
    mbar_init(ring.bar(0), 1);
    mbar_init(ring.bar(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int u = 0; u < 2 && u < ring.n_steps; ++u) issue(u);
  auto release = [&](int u) {
    __syncthreads();
    if (tid == 0 && u + 2 < ring.n_steps) issue(u + 2);
  };

  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + frag_row(2 * h);
    const long long o = static_cast<long long>(bh) * Sq + q;
    lse2[h] = q < Sq ? lse[o] * LOG2E : 0.0f;
    dl[h] = q < Sq ? delta[o] : 0.0f;
  }
  float adq[WGRP / 2];
#pragma unroll
  for (int i = 0; i < WGRP / 2; ++i) adq[i] = 0.0f;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    const int k0 = it * BKV;
    float sc[BKV / 2], dp[BKV / 2];  // S and dP: q rows x keys
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = dp[i] = 0.0f;
    for (int c = 0; c < nch; ++c) {
      const int u = it * per + c;
      ring.wait(u);
      const uint32_t sl = ring.slot(u);
      fence_regs<BKV / 2>(sc);
      fence_regs<BKV / 2>(dp);
      wg_fence();
      chunk_product<T, BQ, BKV>(sc, sl, sl + 2 * TB);
      chunk_product<T, BQ, BKV>(dp, sl + TB, sl + 3 * TB);
      wg_commit();
      wg_wait<0>();
      fence_regs<BKV / 2>(sc);
      fence_regs<BKV / 2>(dp);
      release(u);
    }
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int q = q0 + frag_row(i), key = k0 + frag_col(i);
      const bool ok = key < Skv && q < Sq && (!causal || key <= q);
      sc[i] = ok ? ex2(fmaf(sc[i], scale_log2, -lse2[(i >> 1) & 1])) : 0.0f;
      dp[i] = __fmul_rn(sc[i], __fsub_rn(dp[i], dl[(i >> 1) & 1]));
    }
    uint32_t da[BKV / 16][4];
    to_a<T, BKV>(dp, da);
    const int u = it * per + nch;
    ring.wait(u);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      rs_cols<T, WGRP, BKV>(adq, da[kk], ring.slot(u), kk);
    wg_commit();
    wg_wait<0>();
    fence_regs<WGRP / 2>(adq);
    release(u);
  }

#pragma unroll
  for (int i = 0; i < WGRP / 2; i += 2) {
    const int r = frag_row(i), c = c0 + frag_col(i);
    if (r >= nq || c >= D) continue;
    const long long o = (static_cast<long long>(bh) * Sq + q0 + r) * D + c;
    store2(dq + o, __fmul_rn(adq[i], scale), __fmul_rn(adq[i + 1], scale));
  }
}

// ---- B11 at 640 < D <= 2048: the cluster form --------------------------------
//
// The column-group form above forms S and dP over the whole head dim in
// every group: C (2 D + 256) products a tile for C groups where the work
// needs 3 D, and every group reloads all of Q's, dO's, K's and V's chunks.
// Here a thread-block cluster of C = ceil(D / DSL) blocks (grid z,
// clusters (1, 1, C), C from 2 to 8; D a multiple of WCH) owns one 64-row
// q tile of one (b, h), and block c keeps one slice, dQ's columns DSL*c ..
// DSL*c + DSL - 1 (64 x 256 f32, as B11 at DP = 256; the last block may
// hold only 128 live columns: TMA loads only the live 64-column blocks,
// and the others are zeros written once, zero_dead). Q_c and dO_c load
// once by TMA and stay resident; K_c streams through two stages and V_c
// through one, reloaded as soon as dP_c has read it (the shared memory
// holds no second V stage beside the exchange's slots). For each key tile:
//   1. the slice's partials S_c = Q_c K_c^T and dP_c = dO_c V_c^T
//      (m64n64k16, DSL / 16 k-steps each, exact 16-bit products summed in
//      f32);
//   2. the exchange. A thread's 32 + 32 accumulator registers form
//      DUNITS = 8 units, unit u = S's registers 4u .. 4u + 3 and dP's (two
//      float4), and unit u of every thread belongs to block u % C, its
//      owner. Each block sends each unit it does not own to its owner
//      (st.async into the owner's slot for (unit, sender), xch_slot); the
//      owner's thread t sums its units over the C blocks in block order
//      0 .. C - 1, forms P = exp2(S scale log2 e - LSE log2 e) and dS =
//      P (dP - delta) at those four positions as the DP <= 256 kernel
//      does (the mask on the causal diagonal and ragged edges), rounds dS
//      to T as the A operand of dQ takes it, and sends the two packed
//      words to every other block (st.async into its result slot for
//      (unit, thread)). B11 needs no P beside dS, so only dS goes back;
//   3. every thread reads its other units' words from its own result
//      slots, and dQ_c += dS K_c (m64n128k16, K_c read MN-major) runs on
//      the K tile still in its stage, retired within the tile.
// So S and dP are formed once a tile across the cluster, every block
// holds bitwise the same dS, and each position is summed and
// exponentiated once. A block moves about (C - 1) / C of 32 KB of
// partials and of 8 KB of words a tile over the cluster's network
// against 6.3 MFLOP. The buffers, barriers and their phases follow the
// cluster B10's rules above: stores only, one receive and one result
// buffer, thread 0 re-arming both after its waits of the tile before, a
// cluster barrier before the first remote store and one after the loop.
// The owner's loops over the other blocks run as loops: unrolled, the
// kernel ran slower on an H100 (PERF.md). The dispatch keeps the column
// groups up to BWD16_DQ_CLUSTER_MIN_D, where this form ran no faster
// (clusters of two, and of three with a half-filled last block); a
// one-round all-gather at C = 2 (two buffers of 32 KB) was slower still.
constexpr int DSL = WGRP;                          // a block's columns of dQ
// the head dims of the cluster form (ops/attention.py's):
// BWD16_DQ_CLUSTER_MIN_D < D <= BWD16_DQ_CLUSTER_MAX_D; up to the first,
// where the clusters of two and of three blocks with a half-filled last
// one ran no faster than the column groups on an H100 (PERF.md), those run
constexpr int BWD16_DQ_CLUSTER_MIN_D = 5 * WCH;   // 640
constexpr int BWD16_DQ_CLUSTER_MAX_D = 8 * DSL;
constexpr int DUNITS = BKV / 8;                   // a thread's units
constexpr int DUB = WG * 32;                      // a unit's bytes (S, dP)

// shared memory of the cluster B11: Q_c, dO_c; K_c of stages 0 and 1; V_c;
// the receive slots (two float4 a thread); the result slots (two packed
// words a thread); the barriers (Q and dO, K of both stages, V, receive,
// result)
struct DqClSmem {
  static constexpr int Q = BQ * DSL * 2;
  static constexpr int KV = BKV * DSL * 2;
  static constexpr int RCV = 2 * Q + 3 * KV;
  static constexpr int RES =
      RCV + xch_slots(DUNITS, BWD16_DQ_CLUSTER_MAX_D / DSL) * DUB;
  static constexpr int BARS = RES + DUNITS * WG * 8;
  static constexpr int BYTES = BARS + 6 * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "a block's shared memory");
};

// the maps and operands of attn_bwd_dq_wgmma_kernel; grid (B*H, q tiles,
// C), clusters (1, 1, C), C = ceil(D / DSL)
template <typename T>
__global__ void __launch_bounds__(WG, 1)
    attn_bwd_dq_cluster_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                                     __grid_constant__ const CUtensorMap tdo,
                                     __grid_constant__ const CUtensorMap tk,
                                     __grid_constant__ const CUtensorMap tv,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta,
                                     T* __restrict__ dq, int H, int Hkv,
                                     int Sq, int Skv, int causal, int D,
                                     float scale) {
  using L = DqClSmem;
  constexpr int KS = Cols<DSL>::KS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const float4* rcv = reinterpret_cast<const float4*>(gbase + L::RCV);
  const uint2* res = reinterpret_cast<const uint2*>(gbase + L::RES);
  const uint32_t sQ = base, sDO = base + L::Q, sV = base + 2 * L::Q + 2 * L::KV;
  const uint32_t rcv_a = base + L::RCV, res_a = base + L::RES;
  auto sK = [&](int s) { return base + 2 * L::Q + s * L::KV; };
  const uint32_t bar_q = base + L::BARS;
  auto full_k = [&](int s) { return bar_q + 8 + 8 * s; };
  const uint32_t full_v = bar_q + 24, bar_rcv = bar_q + 32,
                 bar_res = bar_q + 40;

  const int tid = threadIdx.x;
  const int C = gridDim.z, rank = cluster_rank();
  const int bh = blockIdx.x, col0 = rank * DSL;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the heaviest first
  const int kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int nq = min(BQ, Sq - q0);
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;
  const int n_it = (kv_end + BKV - 1) / BKV;
  const int own = (DUNITS - rank + C - 1) / C;  // the units this block owns

  // one thread: key tile j of K_c into stage j & 1, or of V_c, the live
  // column blocks only (the others hold the zeros zero_dead wrote)
  auto load_k = [&](int j) {
    mbar_expect_tx(full_k(j & 1), live_bytes<DSL, BKV>(col0, D));
    tma_tile_live<DSL, BKV>(sK(j & 1), &tk, full_k(j & 1), j * BKV, kvrow,
                            col0, D);
  };
  auto load_v = [&](int j) {
    mbar_expect_tx(full_v, live_bytes<DSL, BKV>(col0, D));
    tma_tile_live<DSL, BKV>(sV, &tv, full_v, j * BKV, kvrow, col0, D);
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(full_k(0), 1);
    mbar_init(full_k(1), 1);
    mbar_init(full_v, 1);
    mbar_init(bar_rcv, 1);
    mbar_init(bar_res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q_c's, dO_c's, both K_c stages' and V_c's column blocks past D: zeros,
  // once
  zero_dead<DSL, BQ>(gbase, col0, D);
  zero_dead<DSL, BQ>(gbase + L::Q, col0, D);
  for (int t = 0; t < 3; ++t)
    zero_dead<DSL, BKV>(gbase + 2 * L::Q + t * L::KV, col0, D);
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * live_bytes<DSL, BQ>(col0, D));
    tma_tile_live<DSL, BQ>(sQ, &tq, bar_q, q0, bh, col0, D);
    tma_tile_live<DSL, BQ>(sDO, &tdo, bar_q, q0, bh, col0, D);
    for (int j = 0; j < 2 && j < n_it; ++j) load_k(j);
    load_v(0);
  }

  // this thread's two q rows: LSE (in log2 units) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + frag_row(2 * h);
    const long long o = static_cast<long long>(bh) * Sq + q;
    lse2[h] = q < Sq ? lse[o] * LOG2E : 0.0f;
    dl[h] = q < Sq ? delta[o] : 0.0f;
  }
  float adq[DSL / 2];
#pragma unroll
  for (int i = 0; i < DSL / 2; ++i) adq[i] = 0.0f;
  const float scale_log2 = scale * LOG2E;
  cluster_sync();  // every block's barriers are set: its peers may store
  mbar_wait(bar_q, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it & 1, k0 = it * BKV;
    mbar_wait(full_k(s), (it >> 1) & 1);
    mbar_wait(full_v, it & 1);
    float sc[BKV / 2], dp[BKV / 2];  // S_c and dP_c: q rows x keys
    fence_regs<BKV / 2>(sc);
    fence_regs<BKV / 2>(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<BKV>::ss<T>(sc, desc_k<BQ>(sQ, kk), desc_k<BKV>(sK(s), kk),
                        kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<BKV>::ss<T>(dp, desc_k<BQ>(sDO, kk), desc_k<BKV>(sV, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs<BKV / 2>(sc);
    fence_regs<BKV / 2>(dp);
    __syncthreads();  // every read of V tile it is done
    if (tid == 0) {
      if (it + 1 < n_it) load_v(it + 1);
      // this tile's phase of the receive and result bars
      mbar_expect_tx(bar_rcv, own * (C - 1) * DUB);
      mbar_expect_tx(bar_res, (DUNITS - own) * WG * 8);
    }
    // each unit this block does not own to its owner's slot for (unit,
    // sender)
#pragma unroll
    for (int u = 0; u < DUNITS; ++u) {
      if (u % C == rank) continue;
      const uint32_t a =
          peer(rcv_a + xch_slot(u, rank, C) * DUB + tid * 32, u % C);
      const uint32_t bar = peer(bar_rcv, u % C);
      st_async4(a, sc[4 * u], sc[4 * u + 1], sc[4 * u + 2], sc[4 * u + 3],
                bar);
      st_async4(a + 16, dp[4 * u], dp[4 * u + 1], dp[4 * u + 2],
                dp[4 * u + 3], bar);
    }
    const bool edge =
        k0 + BKV > Skv || q0 + BQ > Sq || (causal && k0 + BKV - 1 > q0);
    uint32_t da[BKV / 16][4];
    mbar_wait_cluster(bar_rcv, it & 1);
    // the units this block owns: the C partials in block order, P and dS,
    // dS rounded to T
#pragma unroll
    for (int u = 0; u < DUNITS; ++u) {
      if (u % C != rank) continue;
      const float4 ms = make_float4(sc[4 * u], sc[4 * u + 1], sc[4 * u + 2],
                                    sc[4 * u + 3]);
      const float4 md = make_float4(dp[4 * u], dp[4 * u + 1], dp[4 * u + 2],
                                    dp[4 * u + 3]);
      // sender b's: slot[2 b' WG] (S), slot[2 b' WG + 1] (dP)
      const float4* slot = rcv + 2 * ((u / C) * (C - 1) * WG + tid);
      float4 xs = rank == 0 ? ms : slot[0];
      float4 xd = rank == 0 ? md : slot[1];
#pragma unroll 1
      for (int bb = 1; bb < C; ++bb) {
        const int j = 2 * (bb < rank ? bb : bb - 1) * WG;
        xs = add4(xs, bb == rank ? ms : slot[j]);
        xd = add4(xd, bb == rank ? md : slot[j + 1]);
      }
      const float sx[4] = {xs.x, xs.y, xs.z, xs.w};
      const float dx[4] = {xd.x, xd.y, xd.z, xd.w};
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * u + e, h = e >> 1;
        const int q = q0 + frag_row(i), key = k0 + frag_col(i);
        const bool ok =
            !edge || (key < Skv && q < Sq && (!causal || key <= q));
        const float p = ok ? ex2(fmaf(sx[e], scale_log2, -lse2[h])) : 0.0f;
        ds[e] = __fmul_rn(p, __fsub_rn(dx[e], dl[h]));
      }
      const uint32_t w0 = Elt<T>::pack(ds[0], ds[1]);
      const uint32_t w1 = Elt<T>::pack(ds[2], ds[3]);
      da[u / 2][2 * (u & 1)] = w0;
      da[u / 2][2 * (u & 1) + 1] = w1;
#pragma unroll 1
      for (int bb = 0; bb < C; ++bb)
        if (bb != rank)
          st_async2(peer(res_a + (u * WG + tid) * 8, bb), w0, w1,
                    peer(bar_res, bb));
    }
    mbar_wait_cluster(bar_res, it & 1);
#pragma unroll
    for (int u = 0; u < DUNITS; ++u) {
      if (u % C == rank) continue;
      const uint2 w = res[u * WG + tid];
      da[u / 2][2 * (u & 1)] = w.x;
      da[u / 2][2 * (u & 1) + 1] = w.y;
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      rs_cols<T, DSL, BKV>(adq, da[kk], sK(s), kk);
    wg_commit();
    wg_wait<0>();
    fence_regs<DSL / 2>(adq);
    __syncthreads();  // every read of K tile it is done
    if (tid == 0 && it + 2 < n_it) load_k(it + 2);
  }
  cluster_sync();  // the cluster's last stores have landed

#pragma unroll
  for (int i = 0; i < DSL / 2; i += 2) {
    const int r = frag_row(i), c = col0 + frag_col(i);
    if (r >= nq || c >= D) continue;
    const long long o = (static_cast<long long>(bh) * Sq + q0 + r) * D + c;
    store2(dq + o, __fmul_rn(adq[i], scale), __fmul_rn(adq[i + 1], scale));
  }
}

// ---- host -----------------------------------------------------------------

struct Maps {
  CUtensorMap q, dout, k, v;
};

// the operands of one launch besides the tiles
struct Args {
  const float* lse;
  const float* delta;
  void* out0;  // dk (B10) or dq (B11)
  void* out1;  // dv (B10)
  int B, H, Hkv, Sq, Skv, causal, D;
  float scale;
  cudaStream_t st;
};

template <typename T>
cudaError_t make_maps(Maps* m, const void* q, const void* dout,
                      const void* k, const void* v, const Args& a) {
  cudaError_t e = tile_map<T>(&m->q, q, a.B * a.H, a.Sq, a.D, BQ);
  if (e == cudaSuccess)
    e = tile_map<T>(&m->dout, dout, a.B * a.H, a.Sq, a.D, BQ);
  if (e == cudaSuccess) e = tile_map<T>(&m->k, k, a.B * a.Hkv, a.Skv, a.D, BKV);
  if (e == cudaSuccess) e = tile_map<T>(&m->v, v, a.B * a.Hkv, a.Skv, a.D, BKV);
  return e;
}

template <typename T, int DP>
cudaError_t launch_dkv(const void* q, const void* dout, const void* k,
                       const void* v, const Args& a) {
  Maps m;
  cudaError_t e = make_maps<T>(&m, q, dout, k, v, a);
  if (e != cudaSuccess) return e;
  constexpr int smem = DkvSmem<DP>::BYTES;
  auto kern = attn_bwd_dkv_wgmma_kernel<T, DP>;
  e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.H, (a.Skv + BKV - 1) / BKV, DP / dkv_cols<DP>());
  kern<<<grid, WG, smem, a.st>>>(m.q, m.dout, m.k, m.v, a.lse, a.delta,
                                 static_cast<float*>(a.out0),
                                 static_cast<float*>(a.out1), a.H, a.Hkv,
                                 a.Sq, a.Skv, a.causal, a.D, a.scale);
  e = cudaGetLastError();
  if (e == cudaSuccess)
    set_attn_route(ROUTE_BWD_DKV_WGMMA, Elt<T>::F16 ? 2 : 1, DP);
  return e;
}

template <typename T, int DP>
cudaError_t launch_dq(const void* q, const void* dout, const void* k,
                      const void* v, const Args& a) {
  Maps m;
  cudaError_t e = make_maps<T>(&m, q, dout, k, v, a);
  if (e != cudaSuccess) return e;
  constexpr int smem = DqSmem<DP>::BYTES;
  auto kern = attn_bwd_dq_wgmma_kernel<T, DP>;
  e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  kern<<<grid, WG, smem, a.st>>>(m.q, m.dout, m.k, m.v, a.lse, a.delta,
                                 static_cast<T*>(a.out0), a.H, a.Hkv, a.Sq,
                                 a.Skv, a.causal, a.D, a.scale);
  e = cudaGetLastError();
  if (e == cudaSuccess)
    set_attn_route(ROUTE_BWD_DQ_WGMMA, Elt<T>::F16 ? 2 : 1, DP);
  return e;
}

// the column-group form (D > 256) of B10 and B11
template <typename T>
cudaError_t launch_dkv_cols(const void* q, const void* dout, const void* k,
                            const void* v, const Args& a) {
  Maps m;
  cudaError_t e = make_maps<T>(&m, q, dout, k, v, a);
  if (e != cudaSuccess) return e;
  constexpr int smem = 2 * WSLOT + 2 * 8 + 1024;
  auto kern = attn_bwd_dkv_cols_wgmma_kernel<T>;
  e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.H, (a.Skv + BKV - 1) / BKV,
            (a.D + DKV_GRP - 1) / DKV_GRP);
  kern<<<grid, WG, smem, a.st>>>(m.q, m.dout, m.k, m.v, a.lse, a.delta,
                                 static_cast<float*>(a.out0),
                                 static_cast<float*>(a.out1), a.H, a.Hkv,
                                 a.Sq, a.Skv, a.causal, a.D, a.scale);
  e = cudaGetLastError();
  if (e == cudaSuccess)
    set_attn_route(ROUTE_BWD_DKV_COLS_WGMMA, Elt<T>::F16 ? 2 : 1, DKV_GRP);
  return e;
}

// the cluster form (256 < D <= BWD16_CLUSTER_MAX_D) of B10: clusters of D /
// CSL blocks, refused (cudaErrorLaunchOutOfResources) where the card
// cannot hold one; there is no fallback
template <typename T>
cudaError_t launch_dkv_cluster(const void* q, const void* dout, const void* k,
                               const void* v, const Args& a) {
  Maps m;
  cudaError_t e = make_maps<T>(&m, q, dout, k, v, a);
  if (e != cudaSuccess) return e;
  e = launch_cluster16(attn_bwd_dkv_cluster_wgmma_kernel<T>, a.B * a.H,
                       (a.Skv + BKV - 1) / BKV, a.D / CSL, ClSmem::BYTES,
                       a.st, m.q, m.dout, m.k, m.v, a.lse, a.delta,
                       static_cast<float*>(a.out0),
                       static_cast<float*>(a.out1), a.H, a.Hkv, a.Sq, a.Skv,
                       a.causal, a.D, a.scale);
  if (e == cudaSuccess)
    set_attn_route(ROUTE_BWD_DKV_WGMMA_CLUSTER, Elt<T>::F16 ? 2 : 1, CSL);
  return e;
}

template <typename T>
cudaError_t launch_dq_cols(const void* q, const void* dout, const void* k,
                           const void* v, const Args& a) {
  Maps m;
  cudaError_t e = make_maps<T>(&m, q, dout, k, v, a);
  if (e != cudaSuccess) return e;
  constexpr int smem = 2 * WSLOT + 2 * 8 + 1024;
  auto kern = attn_bwd_dq_cols_wgmma_kernel<T>;
  e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ, (a.D + WGRP - 1) / WGRP);
  kern<<<grid, WG, smem, a.st>>>(m.q, m.dout, m.k, m.v, a.lse, a.delta,
                                 static_cast<T*>(a.out0), a.H, a.Hkv, a.Sq,
                                 a.Skv, a.causal, a.D, a.scale);
  e = cudaGetLastError();
  if (e == cudaSuccess)
    set_attn_route(ROUTE_BWD_DQ_COLS_WGMMA, Elt<T>::F16 ? 2 : 1, WGRP);
  return e;
}


// the cluster form (256 < D <= BWD16_DQ_CLUSTER_MAX_D) of B11: clusters of
// ceil(D / DSL) blocks, refused (cudaErrorLaunchOutOfResources) where the
// card cannot hold one
template <typename T>
cudaError_t launch_dq_cluster(const void* q, const void* dout, const void* k,
                              const void* v, const Args& a) {
  Maps m;
  cudaError_t e = make_maps<T>(&m, q, dout, k, v, a);
  if (e != cudaSuccess) return e;
  e = launch_cluster16(attn_bwd_dq_cluster_wgmma_kernel<T>, a.B * a.H,
                       (a.Sq + BQ - 1) / BQ, (a.D + DSL - 1) / DSL,
                       DqClSmem::BYTES, a.st, m.q, m.dout, m.k, m.v, a.lse,
                       a.delta, static_cast<T*>(a.out0), a.H, a.Hkv, a.Sq,
                       a.Skv, a.causal, a.D, a.scale);
  if (e == cudaSuccess)
    set_attn_route(ROUTE_BWD_DQ_WGMMA_CLUSTER, Elt<T>::F16 ? 2 : 1, DSL);
  return e;
}

}  // namespace

// Called by the C entry points of attention_bwd.cu for 16-bit operands
// (dtype code 1 bf16, 2 f16).
int attn_bwd_dkv_wgmma(int dtype, int head_dim, const void* q,
                       const void* dout, const void* k, const void* v,
                       const void* lse, const void* delta, void* dk, void* dv,
                       int B, int H, int Hkv, int Sq, int Skv, int causal,
                       float scale, cudaStream_t st) {
  const Args a{static_cast<const float*>(lse), static_cast<const float*>(delta),
               dk, dv, B, H, Hkv, Sq, Skv, causal, head_dim, scale, st};
  if (head_dim > 256 && head_dim % WCH) return cudaErrorInvalidValue;
  if (head_dim > 256 && head_dim <= BWD16_CLUSTER_MAX_D)
    SM90_COLS_DISPATCH(launch_dkv_cluster, q, dout, k, v, a)
  if (head_dim > 256) SM90_COLS_DISPATCH(launch_dkv_cols, q, dout, k, v, a)
  SM90_DISPATCH(launch_dkv, q, dout, k, v, a)
}

// the clusters of the 16-bit B10's cluster form (bf16; the f16 kernel
// has the same shape) at head_dim that the card holds at once (for
// reports): 0 where B10 does not take that form, minus the CUDA error
// code if the query fails
extern "C" int accl_attn_bwd_dkv16_active_clusters(int head_dim) {
  if (head_dim <= 256 || head_dim > BWD16_CLUSTER_MAX_D || head_dim % CSL)
    return 0;
  int n = 0;
  const cudaError_t e =
      cluster16_active(attn_bwd_dkv_cluster_wgmma_kernel<__nv_bfloat16>,
                       head_dim / CSL, ClSmem::BYTES, &n);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

int attn_bwd_dq_wgmma(int dtype, int head_dim, const void* q,
                      const void* dout, const void* k, const void* v,
                      const void* lse, const void* delta, void* dq, int B,
                      int H, int Hkv, int Sq, int Skv, int causal,
                      float scale, cudaStream_t st) {
  const Args a{static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, B, H, Hkv, Sq, Skv, causal, head_dim, scale, st};
  if (head_dim > 256 && head_dim % WCH) return cudaErrorInvalidValue;
  if (head_dim > BWD16_DQ_CLUSTER_MIN_D && head_dim <= BWD16_DQ_CLUSTER_MAX_D)
    SM90_COLS_DISPATCH(launch_dq_cluster, q, dout, k, v, a)
  if (head_dim > 256) SM90_COLS_DISPATCH(launch_dq_cols, q, dout, k, v, a)
  SM90_DISPATCH(launch_dq, q, dout, k, v, a)
}

// the clusters of the 16-bit B11's cluster form (bf16; the f16 kernel has
// the same shape) at head_dim that the card holds at once (for reports): 0
// where B11 does not take that form, minus the CUDA error code if the
// query fails
extern "C" int accl_attn_bwd_dq16_active_clusters(int head_dim) {
  if (head_dim <= 256 || head_dim > BWD16_DQ_CLUSTER_MAX_D || head_dim % WCH)
    return 0;  // (also at the head dims that keep the column groups)
  int n = 0;
  const cudaError_t e = cluster16_active(
      attn_bwd_dq_cluster_wgmma_kernel<__nv_bfloat16>,
      (head_dim + DSL - 1) / DSL, DqClSmem::BYTES, &n);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// B11 on the cluster form at any 16-bit head dim past 256 up to
// BWD16_DQ_CLUSTER_MAX_D (a multiple of WCH), also where the dispatch keeps
// the column groups: for measuring the two forms side by side
// (chip_compare.py); attn_bwd_dq_wgmma dispatches
extern "C" int accl_attn_bwd_dq16_cluster(int dtype, int head_dim,
                                          const void* q, const void* dout,
                                          const void* k, const void* v,
                                          const void* lse, const void* delta,
                                          void* dq, int B, int H, int Hkv,
                                          int Sq, int Skv, int causal,
                                          float scale, void* stream) {
  if (head_dim <= 256 || head_dim > BWD16_DQ_CLUSTER_MAX_D || head_dim % WCH)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, B, H, Hkv, Sq, Skv, causal, head_dim, scale,
               static_cast<cudaStream_t>(stream)};
  SM90_COLS_DISPATCH(launch_dq_cluster, q, dout, k, v, a)
}
