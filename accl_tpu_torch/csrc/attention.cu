// Attention kernels B8, B9 and B12 on the CUDA cores (CUDA C++, sm_90a).
//
// Replace accl_tpu/ops/attention.py:
//   B8  attn_fwd_kernel        <- _fwd_kernel (pallas_call at :285): the
//       online-softmax forward that streams KV, with O and the per-row
//       log-sum-exp (LSE), the causal frontier skip and GQA routing.
//   B9  attn_fwd_single_kernel <- _fwd_kernel_single (:252): the same when
//       the whole padded KV is one reference block: plain softmax.
//   B12 attn_decode_kernel     <- _decode_kernel (:689): chunked prefill
//       over the KV cache in its native (B, T, Hkv, D) layout.
//
// Routes: the C entry points below send bf16 B8, bf16 B9 and bf16 B12
// chunks of S_new > 1 new tokens to the tensor-core kernels of
// attention_sm90.cu (wgmma, TMA), and every single-token decode (S_new ==
// 1, f32 or bf16) to the split-KV kernel of attention_decode.cu. f32 B8,
// f32 B9 and f32 B12 chunks run the kernels of this file.
//
// What bounds them on an H100: B8, B9 and a long prefill in B12 do about
// 4*S*D operations per score row against 2*D bytes per key, so at S in
// the thousands they are bound by operations. These kernels run on the
// CUDA cores in f32 (67 TFLOP/s on the data sheet, not the 989 TFLOP/s of
// the bf16 tensor cores), so they sit far above their bound at long S.
//
// Design: one thread block of 256 threads per (head row set, q tile). A
// loop over 64-key tiles stands in for the TPU's sequential grid axis;
// the running max m, normaliser l and accumulator stay on chip in f32
// (m, l in shared memory, acc in registers: a 64-row tile holds 64 x D
// f32 accumulators, D/16 x 4 per thread). K and V tiles share one
// shared-memory buffer (K, then V), so a 64-row, D=128 tile needs 83 KB
// and two blocks fit on an SM. Rows are padded to an odd pitch so that
// the 16 threads reading 16 keys (or rows) hit 16 banks. Only keys below
// the tile's causal frontier (from the q tile's END, as attention.py:159)
// or below the fill length are read; past them nothing is loaded.
//
// Arithmetic: q, k, v read as f32 and computed in f32. The library builds
// with --fmad=false, so the dot products are written as explicit fmaf.
// expf/logf (no intrinsics, no fast math), a true division o = acc / l.
// Masked scores take part as finfo(f32).min in the row max and contribute
// p = 0 (attention.py:617). A fully masked row cannot occur on these
// paths (causal rows always see key 0; chunk rows see their own
// position), but it is handled as the reference handles it: l is floored
// at 1e-30, so o = 0 and the LSE is finite.
#include <limits.h>

#include "attention_tile.cuh"

namespace {

constexpr int SINGLE_ROWS = 16;  // q rows per B9 block

// Query row r of a tile sits at absolute position pos_off + (row0 + r) %
// period: B8 passes period = INT_MAX (position = row), B12 the number of
// new tokens (row g * S_new + i of a KV head's group is token i).
struct QRows {
  int row0, nq, period, pos_off;
  __device__ __forceinline__ int pos(int r) const {
    return pos_off + (row0 + r) % period;
  }
};

// The online-softmax tile shared by B8 and B12: BQ query rows (the first
// nq valid, contiguous with pitch D) against keys [0, kv_end) of one KV
// head (key c at k + c * kstride). Writes O (pitch D) and, if lse is
// given, the LSE of each valid row.
template <typename T, int D, int BQ>
__device__ void flash_tile(const T* q, const T* k, const T* v,
                           long long kstride, int kv_end, bool causal,
                           QRows rows, float scale, T* o, float* lse,
                           float* smem) {
  constexpr int QP = D + 1, SP = BK + 1;
  constexpr int RPT = BQ / 16;  // rows per thread
  constexpr int CPT = D / 16;   // output columns per thread
  float* sQ = smem;              // BQ x QP
  float* sKV = sQ + BQ * QP;     // BK x QP: the K tile, then the V tile
  float* sP = sKV + BK * QP;     // BQ x SP: scores, then probabilities
  float* sM = sP + BQ * SP;      // BQ running max
  float* sL = sM + BQ;           // BQ running normaliser
  float* sA = sL + BQ;           // BQ rescale factor of this tile
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;

  TileRegs<T, D, BK> kr, vr;
  kr.fetch(k, kstride, min(BK, kv_end));
  load_rows<T, D, BQ, QP>(sQ, q, D, rows.nq);
  for (int r = tid; r < BQ; r += NT) {
    sM[r] = NEG;
    sL[r] = 0.0f;
  }
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < kv_end; kt += BK) {
    const int nk = min(BK, kv_end - kt);
    kr.template store<QP>(sKV);
    __syncthreads();
    // S = Q K^T for RPT rows x 4 keys per thread
    float s[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[RPT], kb[4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qa[i] = sQ[(ty * RPT + i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sKV[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(ty * RPT + i) * SP + tx + 16 * j] = __fmul_rn(s[i][j], scale);
    __syncthreads();
    // the K tile is consumed: V's loads fly while one warp per row turns
    // its scores into probabilities and updates m, l
    vr.fetch(v + kt * kstride, kstride, nk);
    for (int r = warp; r < BQ; r += NT / 32) {
      const int qpos = rows.pos(r);
      float sc[2], mx = NEG;
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = kt + lane + 32 * h;
        ok[h] = c < kv_end && (!causal || c <= qpos);
        sc[h] = ok[h] ? sP[r * SP + lane + 32 * h] : NEG;
        mx = fmaxf(mx, sc[h]);
      }
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p = ok[h] ? expf(__fsub_rn(sc[h], m_new)) : 0.0f;
        sP[r * SP + lane + 32 * h] = p;
        sum = __fadd_rn(sum, p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(__fsub_rn(m_old, m_new));
        sA[r] = alpha;
        sL[r] = __fadd_rn(__fmul_rn(sL[r], alpha), sum);
        sM[r] = m_new;
      }
    }
    vr.template store<QP>(sKV);
    __syncthreads();
    // the next K tile's loads fly during P V
    if (kt + BK < kv_end)
      kr.fetch(k + (kt + BK) * kstride, kstride, min(BK, kv_end - kt - BK));
    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float a = sA[ty * RPT + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = __fmul_rn(acc[i][j], a);
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[RPT], vb[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pa[i] = sP[(ty * RPT + i) * SP + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vb[j] = sKV[c * QP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
    __syncthreads();
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    if (r >= rows.nq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      st(o + r * D + tx + 16 * j, __fdiv_rn(acc[i][j], l));
  }
  if (lse != nullptr && tid < rows.nq)
    lse[tid] = __fadd_rn(sM[tid], logf(fmaxf(sL[tid], 1e-30f)));
}

template <int D, int BQ>
constexpr int tile_smem() {
  return ((BQ + BK) * (D + 1) + BQ * (BK + 1) + 3 * BQ) * 4;
}

// B8: grid (q tiles, B*H). q (B*H, Sq, D); k/v (B*Hkv, Skv, D); the
// q head bh reads KV row (bh / H) * Hkv + (bh % H) / group (_kv_head_row).
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, int H, int Hkv, int Sq, int Skv,
                int causal, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.y, row0 = blockIdx.x * BQ;
  const long long kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int nq = min(BQ, Sq - row0);
  // causal frontier from the q tile's end: keys past its last row unseen
  const int kv_end = causal ? min(Skv, row0 + nq) : Skv;
  const long long qoff = (static_cast<long long>(bh) * Sq + row0) * D;
  flash_tile<T, D, BQ>(q + qoff, k + kvrow * Skv * D, v + kvrow * Skv * D, D,
                       kv_end, causal != 0, QRows{row0, nq, INT_MAX, 0},
                       scale, o + qoff,
                       lse + static_cast<long long>(bh) * Sq + row0, smem);
}

// B12: grid (row tiles, Hkv, B). q (B, Hkv, rows, D) with rows = group *
// S_new (the q heads of one KV head, token-minor); the cache (B, T, Hkv,
// D) as it is: key c of head h at ((b * T + c) * Hkv + h) * D.
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(NT)
attn_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, T* __restrict__ o, int Hkv,
                   int Tlen, int nrows, int s_new, int kv_len, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * BQ;
  const int nq = min(BQ, nrows - row0);
  const QRows rows{row0, nq, s_new, kv_len - s_new};
  // last position among this tile's rows: kv_len - 1 once it wraps a group
  const int i0 = row0 % s_new;
  const int kv_end = i0 + nq - 1 >= s_new ? kv_len
                                          : kv_len - s_new + i0 + nq;
  const long long qoff =
      ((static_cast<long long>(b) * Hkv + h) * nrows + row0) * D;
  const long long koff = (static_cast<long long>(b) * Tlen * Hkv + h) * D;
  flash_tile<T, D, BQ>(q + qoff, kc + koff, vc + koff,
                       static_cast<long long>(Hkv) * D, kv_end, true, rows,
                       scale, o + qoff, nullptr, smem);
}

// B9: grid (q tiles of 16 rows, B*H); all keys of the row set at once.
// Pass 1 writes the scaled scores of the 16 rows to shared memory (pitch
// sp) a 64-key K chunk at a time and takes each row's max; pass 2 turns
// them into probabilities, sums them, and accumulates P V a 64-key V chunk
// at a time. No online rescaling.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
attn_fwd_single_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int H, int Hkv, int Sq,
                       int Skv, int causal, float scale, int sp) {
  constexpr int QP = D + 1, CPT = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                        // 16 x QP
  float* sKV = sQ + SINGLE_ROWS * QP;      // BK x QP
  float* sS = sKV + BK * QP;               // 16 x sp
  float* sM = sS + SINGLE_ROWS * sp;       // 16
  float* sL = sM + SINGLE_ROWS;            // 16
  const int tid = threadIdx.x, r = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, row0 = blockIdx.x * SINGLE_ROWS;
  const long long kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const T* kh = k + kvrow * Skv * D;
  const T* vh = v + kvrow * Skv * D;
  const int nq = min(SINGLE_ROWS, Sq - row0);
  const int kv_end = causal ? min(Skv, row0 + nq) : Skv;
  const long long qoff = (static_cast<long long>(bh) * Sq + row0) * D;

  load_rows<T, D, SINGLE_ROWS, QP>(sQ, q + qoff, D, nq);
  for (int kt = 0; kt < kv_end; kt += BK) {
    load_rows<T, D, BK, QP>(sKV, kh + static_cast<long long>(kt) * D, D,
                            min(BK, kv_end - kt));
    __syncthreads();
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qa = sQ[r * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = fmaf(qa, sKV[(tx + 16 * j) * QP + d],
                                              s[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sS[r * sp + kt + tx + 16 * j] = __fmul_rn(s[j], scale);
    __syncthreads();
  }
  // one warp per two rows: max, then p = exp(s - m) and the sum
  for (int rr = warp; rr < SINGLE_ROWS; rr += NT / 32) {
    const int qpos = row0 + rr;
    float mx = NEG;
    for (int c = lane; c < kv_end; c += 32)
      if (!causal || c <= qpos) mx = fmaxf(mx, sS[rr * sp + c]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int c = lane; c < kv_end; c += 32) {
      const bool ok = !causal || c <= qpos;
      const float p = ok ? expf(__fsub_rn(sS[rr * sp + c], mx)) : 0.0f;
      sS[rr * sp + c] = p;
      sum = __fadd_rn(sum, p);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      sM[rr] = mx;
      sL[rr] = sum;
    }
  }
  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.0f;
  for (int kt = 0; kt < kv_end; kt += BK) {
    const int nk = min(BK, kv_end - kt);
    __syncthreads();
    load_rows<T, D, BK, QP>(sKV, vh + static_cast<long long>(kt) * D, D, nk);
    __syncthreads();
    for (int c = 0; c < nk; ++c) {
      const float p = sS[r * sp + kt + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        acc[j] = fmaf(p, sKV[c * QP + tx + 16 * j], acc[j]);
    }
  }
  __syncthreads();
  if (r < nq) {
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      st(o + qoff + r * D + tx + 16 * j, __fdiv_rn(acc[j], l));
  }
  if (tid < nq)
    lse[static_cast<long long>(bh) * Sq + row0 + tid] =
        __fadd_rn(sM[tid], logf(fmaxf(sL[tid], 1e-30f)));
}

constexpr int single_smem(int D, int sp) {
  return ((SINGLE_ROWS + BK) * (D + 1) + SINGLE_ROWS * sp + 2 * SINGLE_ROWS) *
         4;
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Hkv, int Sq, int Skv,
                       int causal, float scale, cudaStream_t st) {
  constexpr int BQ = 64;
  constexpr int smem = tile_smem<D, BQ>();
  auto kern = attn_fwd_kernel<T, D, BQ>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Hkv, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_single(const void* q, const void* k, const void* v,
                          void* o, void* lse, int B, int H, int Hkv, int Sq,
                          int Skv, int causal, float scale,
                          cudaStream_t st) {
  const int sp = ((Skv + BK - 1) / BK) * BK + 1;  // odd pitch
  const int smem = single_smem(D, sp);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = attn_fwd_single_kernel<T, D>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + SINGLE_ROWS - 1) / SINGLE_ROWS, B * H);
  kern<<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Hkv, Sq, Skv, causal, scale, sp);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* kc, const void* vc,
                          void* o, int B, int H, int Hkv, int Tlen, int s_new,
                          int kv_len, float scale, cudaStream_t st) {
  constexpr int BQ = 64;
  constexpr int smem = tile_smem<D, BQ>();
  const int nrows = (H / Hkv) * s_new;
  auto kern = attn_decode_kernel<T, D, BQ>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((nrows + BQ - 1) / BQ, Hkv, B);
  kern<<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(o), Hkv, Tlen, nrows, s_new,
      kv_len, scale);
  return cudaGetLastError();
}

}  // namespace

// the bf16 tensor-core route (attention_sm90.cu)
int attn_fwd_wgmma(int head_dim, const void* q, const void* k, const void* v,
                   void* o, void* lse, int B, int H, int Hkv, int Sq, int Skv,
                   int causal, float scale, cudaStream_t st);
int attn_prefill_wgmma(int head_dim, const void* q, const void* kc,
                       const void* vc, void* o, int B, int H, int Hkv, int T,
                       int s_new, int kv_len, float scale, cudaStream_t st);
int attn_fwd_single_wgmma(int head_dim, const void* q, const void* k,
                          const void* v, void* o, void* lse, int B, int H,
                          int Hkv, int Sq, int Skv, int causal, float scale,
                          cudaStream_t st);
// the single-token decode route (attention_decode.cu)
int attn_decode_split(int dtype, int head_dim, const void* q, const void* kc,
                      const void* vc, void* o, void* ws, void* counters,
                      int B, int H, int Hkv, int Tlen, int kv_len,
                      int n_split, float scale, cudaStream_t st);

extern "C" {

int accl_attn_fwd(int dtype, int head_dim, const void* q, const void* k,
                  const void* v, void* o, void* lse, int B, int H, int Hkv,
                  int Sq, int Skv, int causal, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return attn_fwd_wgmma(head_dim, q, k, v, o, lse, B, H, Hkv, Sq, Skv,
                          causal, scale, st);
  if (dtype != 0) return cudaErrorInvalidValue;
  F32_DISPATCH(launch_fwd, q, k, v, o, lse, B, H, Hkv, Sq, Skv, causal,
               scale, st)
}

int accl_attn_fwd_single(int dtype, int head_dim, const void* q,
                         const void* k, const void* v, void* o, void* lse,
                         int B, int H, int Hkv, int Sq, int Skv, int causal,
                         float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return attn_fwd_single_wgmma(head_dim, q, k, v, o, lse, B, H, Hkv, Sq,
                                 Skv, causal, scale, st);
  if (dtype != 0) return cudaErrorInvalidValue;
  F32_DISPATCH(launch_single, q, k, v, o, lse, B, H, Hkv, Sq, Skv, causal,
               scale, st)
}

// ws, counters: the split route's f32 workspace and its zeroed counters
// (S_new == 1), n_split its splits
int accl_attn_decode(int dtype, int head_dim, const void* q, const void* kc,
                     const void* vc, void* o, void* ws, void* counters, int B,
                     int H, int Hkv, int Tlen, int s_new, int kv_len,
                     int n_split, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (s_new == 1)
    return attn_decode_split(dtype, head_dim, q, kc, vc, o, ws, counters, B,
                             H, Hkv, Tlen, kv_len, n_split, scale, st);
  if (dtype == 1)
    return attn_prefill_wgmma(head_dim, q, kc, vc, o, B, H, Hkv, Tlen, s_new,
                              kv_len, scale, st);
  if (dtype != 0) return cudaErrorInvalidValue;
  F32_DISPATCH(launch_decode, q, kc, vc, o, B, H, Hkv, Tlen, s_new, kv_len,
               scale, st)
}

}  // extern "C"
