// Attention forward kernels B8 and B12's prefill route for bf16 inputs on
// Hopper's tensor cores (CUDA C++, sm_90a): one online-softmax tile on
// wgmma (bf16 operands, f32 accumulators) with K and V brought into
// shared memory by TMA, and two launchers. The f32 inputs, B9, and B12's
// single-token decode (S_new == 1) keep the CUDA-core kernels of
// attention.cu, whose C entry points send bf16 B8 and bf16 chunks with
// S_new > 1 here.
//
// Replace accl_tpu/ops/attention.py:
//   B8  attn_fwd_wgmma_kernel via attn_fwd_wgmma <- _fwd_kernel
//       (pallas_call at :285): O and the per-row log-sum-exp (LSE), GQA through
//       _kv_head_row (:217), top-left causal (key j seen by query i iff
//       j <= i, _block_mask :116-127).
//   B12 attn_fwd_wgmma_kernel via attn_prefill_wgmma <- _decode_kernel
//       (:689) with S_new > 1: the cache read in its native (B, T, Hkv, D)
//       layout, query i of S_new at position kv_len - S_new + i seeing
//       keys up to its own (bottom-right); no LSE.
// One integer `off` gives both masks: key j is visible to row i iff
// j <= i + off (B8: 0; B12: kv_len - S_new).
//
// Bound on an H100: 4*D operations per visible score (S = Q K^T and
// O += P V) against 989 TFLOP/s of bf16 tensor cores; q, k, v are read
// once and O written once, two orders of magnitude fewer bytes at S in
// the hundreds, so both launchers are bound by operations.
//
// What the design does about it: one warpgroup (128 threads) per block
// owns 64 q rows of one q head; grid (B*H, q tiles), the last q tile,
// the heaviest under the causal mask, dispatched first. Q is read once,
// straight into registers as the bf16 A operand of S = Q K^T (a
// register-A wgmma m64n64k16), so S reads only K from shared memory:
// half the shared-memory traffic of a Q tile in shared memory, which
// holds an m64n64k16 product at the SM's 128 bytes a clock. 64-key tiles
// of K and V stream through a 2-stage TMA ring on their own mbarriers up
// to the tile's causal frontier (from the q tile's END, as
// attention.py:155-159); a K stage is refilled as soon as S has read it.
// Each thread keeps its two rows' running max and sum in registers (the
// sum as its own part, reduced over the row's 4 threads once at the
// end); exp is ex2 with log2(e) folded into the scale; the mask runs
// only on tiles on the causal diagonal or the ragged key edge. O is
// rescaled by alpha, then O += P V is a register-A wgmma with P packed
// to bf16 as the A operand and the V tile read MN-major, and it retires
// within the iteration: a P V left in flight across the loop's back edge
// makes ptxas serialize every wgmma of the kernel (its C7515 warning).
// About 66 KB of shared memory and 168 registers at D = 128, so three
// blocks share an SM and one block's softmax runs beside the others'
// products; a 3-stage ring, or S of the next tile started beside P V as
// FlashAttention-3 does (192 registers), leaves room for two and was
// slower on an H100 SXM at B=4, H=32, Hkv=8, S=2048, D=128.
//
// K and V maps: B8 uses the 3-D map (B*Hkv, Skv, D); B12 a 4-D map over
// the cache as it is, dims {D, Hkv, kv_len, B} with the cache's strides,
// so TMA zero-fills every row at or past kv_len (the reference's
// :592-598 guard: 0 * NaN never reaches P V) and no head's tile reads
// another's rows.
//
// Rounding: S is exact bf16 products summed in f32. P is f32 and is
// rounded to bf16 (round to nearest even) as the A operand of P V, so
// each term p * v moves by less than 2^-8 of its magnitude; the row sum
// l is taken from the f32 P before that rounding. The output is
// O / max(l, 1e-30) (a true division) rounded to bf16; the LSE is
// m + log(max(l, 1e-30)) in natural-log units, f32. A masked pair gets
// p = 0 through the mask, never through exp of a masked score.
#include <float.h>

#include "sm90_tile.cuh"

namespace {

constexpr float NEG = -FLT_MAX;  // jnp.finfo(jnp.float32).min
constexpr float LN2 = 0.6931471805599453f;

// shared memory: two stages of K and V (BKV rows each), four barriers
// (K of stages 0 and 1, V of stages 0 and 1)
template <int D>
struct FwdSmem {
  static constexpr int KV = BKV * Cols<D>::DP * 2;
  static constexpr int BARS = 4 * KV;
  static constexpr int BYTES = BARS + 4 * 8 + 1024;  // + alignment slack
};

// Is the pair (q row r, key) visible under the launch's mask?
__device__ __forceinline__ bool visible(int r, int key, int Skv, int causal,
                                        int off) {
  return key < Skv && (!causal || key <= r + off);
}

// One key tile of the online softmax for this thread's two rows: the raw
// scores sc (q . k) become p = 2^(s * scale_log2 - m) in place (p = 0
// where MASK hides the pair), m (log2 units) takes the tile's max, and
// the row's part of the sum is rescaled and added to. alpha is the
// factor the accumulated O of each row is rescaled by.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float* sc, float* m2, float* l,
                                             float* alpha, float scale_log2,
                                             int q0, int k0, int Skv,
                                             int causal, int off) {
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) {
    sc[i] = __fmul_rn(sc[i], scale_log2);
    if (!MASK ||
        visible(q0 + frag_row(i), k0 + frag_col(i), Skv, causal, off))
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m2[h], mx[h]);
    alpha[h] = ex2(__fsub_rn(m2[h], m_new));
    m2[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) {
    const int h = (i >> 1) & 1;
    const float p =
        !MASK || visible(q0 + frag_row(i), k0 + frag_col(i), Skv, causal,
                         off)
            ? ex2(__fsub_rn(sc[i], m2[h]))
            : 0.0f;
    sc[i] = p;
    sum[h] = __fadd_rn(sum[h], p);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    l[h] = __fadd_rn(__fmul_rn(l[h], alpha[h]), sum[h]);
}

// q, o (B*H, Sq, D) bf16. k/v maps: with `cache` 0 the 3-D map (B*Hkv,
// Skv, D), with `cache` 1 the 4-D map {D, Hkv, Skv, B}; box rows BKV.
// lse (B*H, Sq) f32 or null.
template <int D>
__global__ void __launch_bounds__(WG, 1)
    attn_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                          __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int H, int Hkv, int Sq,
                          int Skv, int causal, int off, int cache,
                          float scale) {
  using L = FwdSmem<D>;
  constexpr int DP = Cols<D>::DP, KS = Cols<D>::KS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  auto full_k = [&](int s) { return base + L::BARS + 8 * s; };
  auto full_v = [&](int s) { return base + L::BARS + 16 + 8 * s; };
  auto sK = [&](int s) { return base + s * 2 * L::KV; };
  auto sV = [&](int s) { return sK(s) + L::KV; };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  // the last q tile, the heaviest under the causal mask, first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = bh / H, hkv = (bh % H) / (H / Hkv);  // _kv_head_row
  const int nq = min(BQ, Sq - q0);
  // causal frontier from the q tile's end: keys past its last row unseen
  const int kv_end = causal ? min(Skv, q0 + nq + off) : Skv;
  const int n_it = (kv_end + BKV - 1) / BKV;

  // one thread: key tile k0 of K or V into `dst` on barrier `bar`
  auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar,
                  int k0) {
    mbar_expect_tx(bar, L::KV);
    if (cache)
      tma_tile4<D, BKV>(dst, map, bar, hkv, k0, b);
    else
      tma_tile<D, BKV>(dst, map, bar, k0, b * Hkv + hkv);
  };
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < 2 && s < n_it; ++s) {
      load(sK(s), &tk, full_k(s), s * BKV);
      load(sV(s), &tv, full_v(s), s * BKV);
    }
  }

  // Q's A fragments for the KS k16 steps: register r of step kk holds
  // columns 16kk + 8(r >> 1) + 2(tid & 3) + {0, 1} of row frag_row(2r)
  // (to_a's layout); zeros past Sq
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + frag_row(2 * r);
      const int col = 16 * kk + 8 * (r >> 1) + 2 * (tid & 3);
      qa[kk][r] = row < Sq
                      ? *reinterpret_cast<const uint32_t*>(
                            q + (static_cast<long long>(bh) * Sq + row) * D +
                            col)
                      : 0u;
    }
  float acc[DP / 2];                // O: q rows x DP columns
  float m2[2] = {NEG, NEG};         // running max, log2 units
  float l[2] = {0.0f, 0.0f};        // this thread's part of the row sum
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    const int s = it & 1, k0 = it * BKV;
    const uint32_t parity = (it >> 1) & 1;
    mbar_wait(full_k(s), parity);
    float sc[BKV / 2];  // S: q rows x keys
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.0f;
    fence_regs<BKV / 2>(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<BKV>::rs_k(sc, qa[kk], desc_k<BKV>(sK(s), kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs<BKV / 2>(sc);
    __syncthreads();  // every read of K(s) and of V(s ^ 1) is done
    if (tid == 0) {
      if (it + 2 < n_it) load(sK(s), &tk, full_k(s), k0 + 2 * BKV);
      if (it >= 1 && it + 1 < n_it)
        load(sV(s ^ 1), &tv, full_v(s ^ 1), k0 + BKV);
    }

    float alpha[2];
    if (k0 + BKV > Skv || (causal && k0 + BKV - 1 > q0 + off))
      softmax_tile<true>(sc, m2, l, alpha, scale_log2, q0, k0, Skv, causal,
                         off);
    else
      softmax_tile<false>(sc, m2, l, alpha, scale_log2, q0, k0, Skv, causal,
                          off);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i)
      acc[i] = __fmul_rn(acc[i], alpha[(i >> 1) & 1]);
    uint32_t pa[BKV / 16][4];  // P, bf16
    to_a<BKV>(sc, pa);
    mbar_wait(full_v(s), parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      Wgmma<DP>::rs(acc, pa[kk], desc_mn<BKV>(sV(s), kk));
    wg_commit();
    wg_wait<0>();
    fence_regs<DP / 2>(acc);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], 1));
    l[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], 2));
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int r = frag_row(i), c = frag_col(i);
    if (r >= nq || c >= D) continue;
    const float lr = l[(i >> 1) & 1];
    const long long e = (static_cast<long long>(bh) * Sq + q0 + r) * D + c;
    *reinterpret_cast<__nv_bfloat162*>(o + e) = __floats2bfloat162_rn(
        __fdiv_rn(acc[i], lr), __fdiv_rn(acc[i + 1], lr));
  }
  if (lse != nullptr && (tid & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row(2 * h);
      if (r < nq)
        lse[static_cast<long long>(bh) * Sq + q0 + r] =
            __fadd_rn(__fmul_rn(m2[h], LN2), logf(l[h]));
    }
  }
}

// the operands of one launch besides the maps
struct Args {
  const void* q;
  void* o;
  void* lse;
  int B, H, Hkv, Sq, Skv, causal, off, cache;
  float scale;
  cudaStream_t st;
};

template <int D>
cudaError_t launch(const CUtensorMap& tk, const CUtensorMap& tv,
                   const Args& a) {
  constexpr int smem = FwdSmem<D>::BYTES;
  auto kern = attn_fwd_wgmma_kernel<D>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  kern<<<grid, WG, smem, a.st>>>(static_cast<const __nv_bfloat16*>(a.q),
                                 tk, tv, static_cast<__nv_bfloat16*>(a.o),
                                 static_cast<float*>(a.lse), a.H, a.Hkv,
                                 a.Sq, a.Skv, a.causal, a.off, a.cache,
                                 a.scale);
  return cudaGetLastError();
}

cudaError_t launch_d(int head_dim, const CUtensorMap& tk,
                     const CUtensorMap& tv, const Args& a) {
  switch (head_dim) {
    case 16: return launch<16>(tk, tv, a);
    case 32: return launch<32>(tk, tv, a);
    case 64: return launch<64>(tk, tv, a);
    case 128: return launch<128>(tk, tv, a);
    default: return cudaErrorInvalidValue;
  }
}

// a contiguous bf16 cache (B, T, Hkv, D) as the 4-D map {D, Hkv, kv_len,
// B}: boxes of 64 columns x BKV rows of one head of one batch row; the T
// extent is kv_len, so every row at or past it reads as zeros
cudaError_t cache_map(CUtensorMap* map, const void* ptr, int B, int T,
                      int Hkv, int D, int kv_len) {
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Hkv),
      static_cast<cuuint64_t>(kv_len), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(Hkv) * D * 2,
      static_cast<cuuint64_t>(T) * Hkv * D * 2};
  const cuuint32_t box[4] = {64, 1, BKV, 1};
  return encode_bf16(map, ptr, 4, dims, strides, box);
}

}  // namespace

// Called by accl_attn_fwd (attention.cu) for bf16 operands: B8.
int attn_fwd_wgmma(int head_dim, const void* q, const void* k, const void* v,
                   void* o, void* lse, int B, int H, int Hkv, int Sq, int Skv,
                   int causal, float scale, cudaStream_t st) {
  CUtensorMap tk, tv;
  cudaError_t e = tile_map(&tk, k, B * Hkv, Skv, head_dim, BKV);
  if (e == cudaSuccess) e = tile_map(&tv, v, B * Hkv, Skv, head_dim, BKV);
  if (e != cudaSuccess) return e;
  return launch_d(head_dim, tk, tv,
                  Args{q, o, lse, B, H, Hkv, Sq, Skv, causal, 0, 0, scale,
                       st});
}

// Called by accl_attn_decode (attention.cu) for bf16 chunks of S_new > 1
// new tokens: B12's prefill route. q and o (B, H, S_new, D); the caches
// (B, T, Hkv, D), filled through kv_len.
int attn_prefill_wgmma(int head_dim, const void* q, const void* kc,
                       const void* vc, void* o, int B, int H, int Hkv, int T,
                       int s_new, int kv_len, float scale, cudaStream_t st) {
  CUtensorMap tk, tv;
  cudaError_t e = cache_map(&tk, kc, B, T, Hkv, head_dim, kv_len);
  if (e == cudaSuccess) e = cache_map(&tv, vc, B, T, Hkv, head_dim, kv_len);
  if (e != cudaSuccess) return e;
  return launch_d(head_dim, tk, tv,
                  Args{q, o, nullptr, B, H, Hkv, s_new, kv_len, 1,
                       kv_len - s_new, 1, scale, st});
}
