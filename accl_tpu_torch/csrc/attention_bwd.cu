// Attention backward kernels B10 and B11 (CUDA C++, sm_90a), the f32
// route: the FlashAttention-2 backward on the CUDA cores, which rebuilds
// the probabilities from the forward's per-row log-sum-exp (LSE) instead
// of storing them. The C entry points below send bf16 operands (dtype
// code 1) to the tensor-core kernels of attention_bwd_sm90.cu and f32
// operands (code 0) to the kernels here: one kernel per route.
//
// Replace accl_tpu/ops/attention.py:
//   B10 attn_bwd_dkv_kernel <- _bwd_dkv_kernel (pallas_call at :461):
//       per-q-head f32 partials of dK and dV (the GQA group sum runs
//       outside, as the reference's :522-523).
//   B11 attn_bwd_dq_kernel  <- _bwd_dq_kernel (:492): dQ in q's dtype.
//
// For a score s = scale * q.k of a visible (query i, key j) pair:
//   p = exp(s - lse_i), dp = do_i . v_j, ds = p * (dp - delta_i),
//   dv_j += p * do_i, dk_j += scale * ds * q_i, dq_i += scale * ds * k_j,
// with delta_i = rowsum(do_i * o_i) computed by the caller from O in q's
// dtype (attention.py:433). An invisible pair (key past Skv, query past
// Sq, or key j > query i under the causal mask, top-left as the forward)
// takes p = 0 through the mask, never through exp of a masked score.
//
// What bounds them on an H100: 8*D (B10: four products) and 6*D (B11:
// three) operations per visible score against 2*D bytes per row, so at S
// in the thousands they are bound by operations: 67 TFLOP/s of f32 on
// the CUDA cores (f32 operands have no bf16 tensor-core route).
//
// Design: 256 threads per block, 64-key tiles (BK) against 32-row q tiles
// (BQB). Both kernels share one step, `p_ds`: each thread forms S = Q K^T
// and dP = dO V^T for 2 rows x 4 keys from shared memory, then p and ds
// in registers.
//   B10: one block per (q head row b*h, 64-key tile). K and V stay in
//   shared memory; a loop over 32-row q tiles (from the tile that holds
//   query k0 under the causal mask: the reference's first =
//   (kj*block_k)//block_q) loads Q, dO, LSE and delta, then accumulates
//   dV += P^T dO and dK += dS^T Q in registers (4 keys x D/16 columns per
//   thread each); P and then dS pass through one shared tile.
//   B11: one block per (b*h, 32-row q tile). Q and dO stay in shared
//   memory; a loop over 64-key tiles up to the tile's causal frontier
//   (from its END, attention.py:393) accumulates dQ += dS K in registers
//   (2 rows x D/16 columns per thread).
// Shared memory at D=128: K, V (2 x 33 KB), Q, dO (2 x 16.5 KB), one
// 32x65 tile and the LSE/delta rows: 105 KB, two blocks per SM. Rows are
// padded to an odd pitch so 16 threads reading 16 rows hit 16 banks. Rows
// past Sq and keys past Skv are never read (zero rows in shared memory).
//
// Arithmetic in f32: explicit fmaf (the library builds with
// --fmad=false), expf without intrinsics; the scale of dK and dQ is
// applied once to the sum.
#include "attention_tile.cuh"

namespace {

constexpr int BQB = 32;  // q rows per tile

template <int D>
constexpr int bwd_smem() {
  return (2 * BK * (D + 1) + 2 * BQB * (D + 1) + BQB * (BK + 1) + 2 * BQB) *
         4;
}

// The step shared by B10 and B11 on a BQB-row q tile (first row at query
// position q0, nq valid) against a BK-key tile (first key k0, nk valid):
// p and ds of this thread's rows ty*2+i and keys tx+16*j.
template <int D>
__device__ __forceinline__ void p_ds(const float* sQ, const float* sDO,
                                     const float* sK, const float* sV,
                                     const float* sLse, const float* sDelta,
                                     int q0, int nq, int k0, int nk,
                                     bool causal, float scale, float p[2][4],
                                     float ds[2][4]) {
  constexpr int QP = D + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[2][4], dp[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[2], oa[2], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qa[i] = sQ[(ty * 2 + i) * QP + d];
      oa[i] = sDO[(ty * 2 + i) * QP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = sK[(tx + 16 * j) * QP + d];
      vb[j] = sV[(tx + 16 * j) * QP + d];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty * 2 + i;
    const float lse = sLse[r], delta = sDelta[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool ok = r < nq && c < nk && (!causal || k0 + c <= q0 + r);
      p[i][j] = ok ? expf(__fsub_rn(__fmul_rn(s[i][j], scale), lse)) : 0.0f;
      ds[i][j] = __fmul_rn(p[i][j], __fsub_rn(dp[i][j], delta));
    }
  }
}

// LSE and delta of a q tile's rows into shared memory (0 past nq).
__device__ __forceinline__ void load_row_stats(float* sLse, float* sDelta,
                                               const float* lse,
                                               const float* delta, int nq) {
  if (threadIdx.x < BQB) {
    const int r = threadIdx.x;
    sLse[r] = r < nq ? lse[r] : 0.0f;
    sDelta[r] = r < nq ? delta[r] : 0.0f;
  }
}

// B10: grid (key tiles, B*H). q/dout (B*H, Sq, D); k/v (B*Hkv, Skv, D);
// lse/delta (B*H, Sq) f32; dk/dv (B*H, Skv, D) f32 per-q-head partials.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ dout,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int H, int Hkv, int Sq, int Skv,
                    int causal, float scale) {
  constexpr int QP = D + 1, SP = BK + 1, CPT = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;              // BK x QP
  float* sV = sK + BK * QP;      // BK x QP
  float* sQ = sV + BK * QP;      // BQB x QP
  float* sDO = sQ + BQB * QP;    // BQB x QP
  float* sP = sDO + BQB * QP;    // BQB x SP: p, then ds
  float* sLse = sP + BQB * SP;   // BQB
  float* sDelta = sLse + BQB;    // BQB
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const long long kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int nk = min(BK, Skv - k0);
  const long long koff = (kvrow * Skv + k0) * D;
  load_rows<T, D, BK, QP>(sK, k + koff, D, nk);
  load_rows<T, D, BK, QP>(sV, v + koff, D, nk);
  float adk[4][CPT], adv[4][CPT];  // keys ty*4+i, columns tx+16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) adk[i][j] = adv[i][j] = 0.0f;

  // under the causal mask queries before k0 see none of these keys
  const int q_first = causal ? (k0 / BQB) * BQB : 0;
  for (int q0 = q_first; q0 < Sq; q0 += BQB) {
    const int nq = min(BQB, Sq - q0);
    const long long qoff = (static_cast<long long>(bh) * Sq + q0) * D;
    const long long roff = static_cast<long long>(bh) * Sq + q0;
    __syncthreads();  // the previous tile's reads of sQ, sDO, sP are done
    load_rows<T, D, BQB, QP>(sQ, q + qoff, D, nq);
    load_rows<T, D, BQB, QP>(sDO, dout + qoff, D, nq);
    load_row_stats(sLse, sDelta, lse + roff, delta + roff, nq);
    __syncthreads();
    float p[2][4], ds[2][4];
    p_ds<D>(sQ, sDO, sK, sV, sLse, sDelta, q0, nq, k0, nk, causal != 0,
            scale, p, ds);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty * 2 + i) * SP + tx + 16 * j] = p[i][j];
    __syncthreads();
    // dV += P^T dO over the tile's rows
    for (int r = 0; r < nq; ++r) {
      float pa[4], ob[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sP[r * SP + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) ob[j] = sDO[r * QP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) adv[i][j] = fmaf(pa[i], ob[j], adv[i][j]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(ty * 2 + i) * SP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dK += dS^T Q (scaled once at the end)
    for (int r = 0; r < nq; ++r) {
      float da[4], qb[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = sP[r * SP + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) qb[j] = sQ[r * QP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) adk[i][j] = fmaf(da[i], qb[j], adk[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = ty * 4 + i;
    if (key >= nk) continue;
    const long long o = (static_cast<long long>(bh) * Skv + k0 + key) * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      dk[o + tx + 16 * j] = __fmul_rn(adk[i][j], scale);
      dv[o + tx + 16 * j] = adv[i][j];
    }
  }
}

// B11: grid (q tiles, B*H); the same operands; dq (B*H, Sq, D) in T.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ dout,
                   const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int H, int Hkv, int Sq, int Skv, int causal, float scale) {
  constexpr int QP = D + 1, SP = BK + 1, CPT = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;              // BK x QP
  float* sV = sK + BK * QP;      // BK x QP
  float* sQ = sV + BK * QP;      // BQB x QP
  float* sDO = sQ + BQB * QP;    // BQB x QP
  float* sDS = sDO + BQB * QP;   // BQB x SP
  float* sLse = sDS + BQB * SP;  // BQB
  float* sDelta = sLse + BQB;    // BQB
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQB;
  const long long kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int nq = min(BQB, Sq - q0);
  // causal frontier from the q tile's end: keys past its last row unseen
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;
  const long long qoff = (static_cast<long long>(bh) * Sq + q0) * D;
  const long long roff = static_cast<long long>(bh) * Sq + q0;
  load_rows<T, D, BQB, QP>(sQ, q + qoff, D, nq);
  load_rows<T, D, BQB, QP>(sDO, dout + qoff, D, nq);
  load_row_stats(sLse, sDelta, lse + roff, delta + roff, nq);
  float acc[2][CPT];  // rows ty*2+i, columns tx+16*j
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    const int nk = min(BK, kv_end - k0);
    const long long koff = (kvrow * Skv + k0) * D;
    __syncthreads();  // the previous tile's reads of sK, sDS are done
    load_rows<T, D, BK, QP>(sK, k + koff, D, nk);
    load_rows<T, D, BK, QP>(sV, v + koff, D, nk);
    __syncthreads();
    float p[2][4], ds[2][4];
    p_ds<D>(sQ, sDO, sK, sV, sLse, sDelta, q0, nq, k0, nk, causal != 0,
            scale, p, ds);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sDS[(ty * 2 + i) * SP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ += dS K (scaled once at the end)
    for (int c = 0; c < nk; ++c) {
      float da[2], kb[CPT];
#pragma unroll
      for (int i = 0; i < 2; ++i) da[i] = sDS[(ty * 2 + i) * SP + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kb[j] = sK[c * QP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(da[i], kb[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty * 2 + i;
    if (r >= nq) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      st(dq + qoff + r * D + tx + 16 * j, __fmul_rn(acc[i][j], scale));
  }
}

template <typename T, int D>
cudaError_t launch_bwd_dkv(const void* q, const void* dout, const void* k,
                           const void* v, const void* lse, const void* delta,
                           void* dk, void* dv, int B, int H, int Hkv, int Sq,
                           int Skv, int causal, float scale,
                           cudaStream_t st) {
  constexpr int smem = bwd_smem<D>();
  auto kern = attn_bwd_dkv_kernel<T, D>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Skv + BK - 1) / BK, B * H);
  kern<<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(dout),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv, Sq, Skv,
      causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_dq(const void* q, const void* dout, const void* k,
                          const void* v, const void* lse, const void* delta,
                          void* dq, int B, int H, int Hkv, int Sq, int Skv,
                          int causal, float scale, cudaStream_t st) {
  constexpr int smem = bwd_smem<D>();
  auto kern = attn_bwd_dq_kernel<T, D>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQB - 1) / BQB, B * H);
  kern<<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(dout),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Hkv, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// the bf16 route (attention_bwd_sm90.cu)
int attn_bwd_dkv_wgmma(int head_dim, const void* q, const void* dout,
                       const void* k, const void* v, const void* lse,
                       const void* delta, void* dk, void* dv, int B, int H,
                       int Hkv, int Sq, int Skv, int causal, float scale,
                       cudaStream_t st);
int attn_bwd_dq_wgmma(int head_dim, const void* q, const void* dout,
                      const void* k, const void* v, const void* lse,
                      const void* delta, void* dq, int B, int H, int Hkv,
                      int Sq, int Skv, int causal, float scale,
                      cudaStream_t st);

extern "C" {

int accl_attn_bwd_dkv(int dtype, int head_dim, const void* q,
                      const void* dout, const void* k, const void* v,
                      const void* lse, const void* delta, void* dk, void* dv,
                      int B, int H, int Hkv, int Sq, int Skv, int causal,
                      float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return attn_bwd_dkv_wgmma(head_dim, q, dout, k, v, lse, delta, dk, dv, B,
                              H, Hkv, Sq, Skv, causal, scale, st);
  if (dtype != 0) return cudaErrorInvalidValue;
  F32_DISPATCH(launch_bwd_dkv, q, dout, k, v, lse, delta, dk, dv, B, H, Hkv,
               Sq, Skv, causal, scale, st)
}

int accl_attn_bwd_dq(int dtype, int head_dim, const void* q,
                     const void* dout, const void* k, const void* v,
                     const void* lse, const void* delta, void* dq, int B,
                     int H, int Hkv, int Sq, int Skv, int causal,
                     float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return attn_bwd_dq_wgmma(head_dim, q, dout, k, v, lse, delta, dq, B, H,
                             Hkv, Sq, Skv, causal, scale, st);
  if (dtype != 0) return cudaErrorInvalidValue;
  F32_DISPATCH(launch_bwd_dq, q, dout, k, v, lse, delta, dq, B, H, Hkv, Sq,
               Skv, causal, scale, st)
}

}  // extern "C"
