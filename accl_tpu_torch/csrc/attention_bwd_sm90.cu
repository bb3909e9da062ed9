// Attention backward kernels B10 and B11 for bf16 inputs on Hopper's
// tensor cores (CUDA C++, sm_90a): wgmma with bf16 operands and f32
// accumulators, tiles brought into shared memory by TMA. The f32 inputs
// keep the CUDA-core kernels of attention_bwd.cu, whose C entry points
// send dtype code 1 (bf16) here.
//
// Replace accl_tpu/ops/attention.py:
//   B10 attn_bwd_dkv_wgmma_kernel <- _bwd_dkv_kernel (pallas_call at :461):
//       per-q-head f32 partials of dK and dV (the GQA group sum runs
//       outside, as the reference's :522-523).
//   B11 attn_bwd_dq_wgmma_kernel  <- _bwd_dq_kernel (:492): dQ in bf16.
//
// For a visible (query i, key j) pair, with s = q_i . k_j:
//   p = exp(scale*s - lse_i), dp = do_i . v_j, ds = p * (dp - delta_i),
//   dv_j += p * do_i, dk_j += scale * ds * q_i, dq_i += scale * ds * k_j.
// An invisible pair (key past Skv, query past Sq, or key j > query i
// under the top-left causal mask) takes p = 0 through the mask, never
// through exp of a masked score.
//
// Bound on an H100: 8*D (B10: S, dP, dV, dK) and 6*D (B11: S, dP, dQ)
// operations per visible score, against 989 TFLOP/s of bf16 tensor
// cores; the bytes (q, do, k, v once, lse and delta, the outputs) are
// two orders of magnitude below that at S in the thousands, so both are
// bound by operations.
//
// What the design does about it: every product is a warpgroup MMA
// (wgmma m64nNk16, bf16 x bf16 -> f32), one warpgroup of 128 threads per
// block. The products are formed with the key tile as the M rows in B10
// (S^T = K Q^T, dP^T = V dO^T) and the q tile as the M rows in B11, so P
// and dS leave the accumulators as the bf16 register operand A of the
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
// Rounding: q, do, k, v are bf16, so S and dP are exact products summed
// in f32. P and dS are f32 and are rounded to bf16 (round to nearest
// even) as the A operand of dV, dK and dQ, as FlashAttention-2 does; each
// term of those sums moves by less than 2^-8 of its magnitude. exp is
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

// shared memory of B10: K, V (BKV rows), two stages of Q, dO (BQ rows) and
// of LSE, delta (BQ floats each), three barriers
template <int D>
struct DkvSmem {
  static constexpr int KV = BKV * Cols<D>::DP * 2;  // bytes of a K or V tile
  static constexpr int Q = BQ * Cols<D>::DP * 2;    // bytes of a Q or dO tile
  static constexpr int STATS = 2 * KV + 4 * Q;      // offset of LSE, delta
  static constexpr int BARS = STATS + 4 * BQ * 4;
  static constexpr int BYTES = BARS + 3 * 8 + 1024;  // + alignment slack
};

// q/do maps: (B*H, Sq, D), box rows BQ; k/v maps: (B*Hkv, Skv, D), box
// rows BKV. lse/delta (B*H, Sq) f32; dk/dv (B*H, Skv, D) f32 per-q-head
// partials.
template <int D>
__global__ void __launch_bounds__(WG, 1)
    attn_bwd_dkv_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                              __grid_constant__ const CUtensorMap tdo,
                              __grid_constant__ const CUtensorMap tk,
                              __grid_constant__ const CUtensorMap tv,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int H, int Hkv, int Sq, int Skv, int causal,
                              float scale) {
  using L = DkvSmem<D>;
  constexpr int DP = Cols<D>::DP, KS = Cols<D>::KS;
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
  const int kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  // under the causal mask queries before k0 see none of these keys
  const int q_first = causal ? (k0 / BQ) * BQ : 0;
  const int n_it = q_first < Sq ? (Sq - q_first + BQ - 1) / BQ : 0;
  const float* lse_row = lse + static_cast<long long>(bh) * Sq;
  const float* delta_row = delta + static_cast<long long>(bh) * Sq;

  auto load_q = [&](int s, int q0) {  // one thread: Q, dO of stage s
    mbar_expect_tx(full(s), 2 * L::Q);
    tma_tile<D, BQ>(sQ(s), &tq, full(s), q0, bh);
    tma_tile<D, BQ>(sDO(s), &tdo, full(s), q0, bh);
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
    tma_tile<D, BKV>(sK, &tk, bar_kv, k0, kvrow);
    tma_tile<D, BKV>(sV, &tv, bar_kv, k0, kvrow);
    for (int s = 0; s < 2 && s < n_it; ++s) load_q(s, q_first + s * BQ);
  }
  for (int s = 0; s < 2; ++s) {
    if (s < n_it) load_stats(s, q_first + s * BQ);
    else cp_async_commit();
  }
  cp_async_wait<1>();  // stage 0's LSE and delta
  __syncthreads();

  float adk[DP / 2], adv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) adk[i] = adv[i] = 0.0f;
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
      Wgmma<BQ>::ss(st, desc_k<BKV>(sK, kk), desc_k<BQ>(sQ(s), kk), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<BQ>::ss(dpt, desc_k<BKV>(sV, kk), desc_k<BQ>(sDO(s), kk), kk > 0);
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
    to_a<BQ>(st, pa);
    to_a<BQ>(dpt, da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      Wgmma<DP>::rs(adv, pa[kk], desc_mn<BQ>(sDO(s), kk));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      Wgmma<DP>::rs(adk, da[kk], desc_mn<BQ>(sQ(s), kk));
    wg_commit();
    wg_wait<0>();
    fence_regs<DP / 2>(adv);
    fence_regs<DP / 2>(adk);

    cp_async_wait<0>();  // the next stage's LSE and delta
    __syncthreads();     // every read of stage s is done
    if (it + 2 < n_it) {
      if (tid == 0) load_q(s, q0 + 2 * BQ);
      load_stats(s, q0 + 2 * BQ);
    }
  }

#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int key = k0 + frag_row(i), c = frag_col(i);
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
template <int D>
struct DqSmem {
  static constexpr int Q = BQ * Cols<D>::DP * 2;
  static constexpr int KV = BKV * Cols<D>::DP * 2;
  static constexpr int BARS = 2 * Q + 4 * KV;
  static constexpr int BYTES = BARS + 3 * 8 + 1024;
};

// the same maps and operands as B10; dq (B*H, Sq, D) bf16
template <int D>
__global__ void __launch_bounds__(WG, 1)
    attn_bwd_dq_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                             __grid_constant__ const CUtensorMap tdo,
                             __grid_constant__ const CUtensorMap tk,
                             __grid_constant__ const CUtensorMap tv,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int H, int Hkv,
                             int Sq, int Skv, int causal, float scale) {
  using L = DqSmem<D>;
  constexpr int DP = Cols<D>::DP, KS = Cols<D>::KS;
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
    tma_tile<D, BKV>(sK(s), &tk, full(s), k0, kvrow);
    tma_tile<D, BKV>(sV(s), &tv, full(s), k0, kvrow);
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
    tma_tile<D, BQ>(sQ, &tq, bar_q, q0, bh);
    tma_tile<D, BQ>(sDO, &tdo, bar_q, q0, bh);
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
      Wgmma<BKV>::ss(sc, desc_k<BQ>(sQ, kk), desc_k<BKV>(sK(s), kk), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<BKV>::ss(dp, desc_k<BQ>(sDO, kk), desc_k<BKV>(sV(s), kk), kk > 0);
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
    to_a<BKV>(dp, da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      Wgmma<DP>::rs(adq, da[kk], desc_mn<BKV>(sK(s), kk));
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
    *reinterpret_cast<__nv_bfloat162*>(dq + o) = __floats2bfloat162_rn(
        __fmul_rn(adq[i], scale), __fmul_rn(adq[i + 1], scale));
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
  int B, H, Hkv, Sq, Skv, causal;
  float scale;
  cudaStream_t st;
};

cudaError_t make_maps(Maps* m, const void* q, const void* dout,
                      const void* k, const void* v, const Args& a, int D) {
  cudaError_t e = tile_map(&m->q, q, a.B * a.H, a.Sq, D, BQ);
  if (e == cudaSuccess) e = tile_map(&m->dout, dout, a.B * a.H, a.Sq, D, BQ);
  if (e == cudaSuccess) e = tile_map(&m->k, k, a.B * a.Hkv, a.Skv, D, BKV);
  if (e == cudaSuccess) e = tile_map(&m->v, v, a.B * a.Hkv, a.Skv, D, BKV);
  return e;
}

template <int D>
cudaError_t launch_dkv(const Maps& m, const Args& a) {
  constexpr int smem = DkvSmem<D>::BYTES;
  auto kern = attn_bwd_dkv_wgmma_kernel<D>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.H, (a.Skv + BKV - 1) / BKV);
  kern<<<grid, WG, smem, a.st>>>(m.q, m.dout, m.k, m.v, a.lse, a.delta,
                                 static_cast<float*>(a.out0),
                                 static_cast<float*>(a.out1), a.H, a.Hkv,
                                 a.Sq, a.Skv, a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Maps& m, const Args& a) {
  constexpr int smem = DqSmem<D>::BYTES;
  auto kern = attn_bwd_dq_wgmma_kernel<D>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  kern<<<grid, WG, smem, a.st>>>(m.q, m.dout, m.k, m.v, a.lse, a.delta,
                                 static_cast<__nv_bfloat16*>(a.out0), a.H,
                                 a.Hkv, a.Sq, a.Skv, a.causal, a.scale);
  return cudaGetLastError();
}

}  // namespace

// Called by the C entry points of attention_bwd.cu for bf16 operands.
int attn_bwd_dkv_wgmma(int head_dim, const void* q, const void* dout,
                       const void* k, const void* v, const void* lse,
                       const void* delta, void* dk, void* dv, int B, int H,
                       int Hkv, int Sq, int Skv, int causal, float scale,
                       cudaStream_t st) {
  const Args a{static_cast<const float*>(lse), static_cast<const float*>(delta),
               dk, dv, B, H, Hkv, Sq, Skv, causal, scale, st};
  Maps m;
  cudaError_t e = make_maps(&m, q, dout, k, v, a, head_dim);
  if (e != cudaSuccess) return e;
  switch (head_dim) {
    case 16: return launch_dkv<16>(m, a);
    case 32: return launch_dkv<32>(m, a);
    case 64: return launch_dkv<64>(m, a);
    case 128: return launch_dkv<128>(m, a);
    default: return cudaErrorInvalidValue;
  }
}

int attn_bwd_dq_wgmma(int head_dim, const void* q, const void* dout,
                      const void* k, const void* v, const void* lse,
                      const void* delta, void* dq, int B, int H, int Hkv,
                      int Sq, int Skv, int causal, float scale,
                      cudaStream_t st) {
  const Args a{static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, B, H, Hkv, Sq, Skv, causal, scale, st};
  Maps m;
  cudaError_t e = make_maps(&m, q, dout, k, v, a, head_dim);
  if (e != cudaSuccess) return e;
  switch (head_dim) {
    case 16: return launch_dq<16>(m, a);
    case 32: return launch_dq<32>(m, a);
    case 64: return launch_dq<64>(m, a);
    case 128: return launch_dq<128>(m, a);
    default: return cudaErrorInvalidValue;
  }
}
