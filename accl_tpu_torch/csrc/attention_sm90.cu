// Attention forward kernels B8, B9 and B12's prefill route for 16-bit
// inputs (bf16 or f16, one template for both) on Hopper's tensor cores
// (CUDA C++, sm_90a): one online-softmax tile on wgmma (16-bit
// operands, f32 accumulators) with K and V brought into
// shared memory by TMA and two launchers (B8, B12 prefill), and B9's
// two-pass plain-softmax kernel on the same tiles. The f32 inputs keep the
// 3xTF32 kernels of attention.cu, and B12's single-token decode (S_new
// == 1) the split-KV kernel of attention_decode.cu; the C entry points of
// attention.cu send 16-bit B8, B9 and chunks with S_new > 1 here.
//
// Head dims: the kernels are instantiated on column tiers DP of 64, 128,
// 192 and 256 (sm90_tile.cuh Cols) and take the head dim D <= DP (a
// multiple of 8) at run time: the tensor maps have extent D, so TMA fills
// the columns past it with zeros, Q's registers past D are zeros, and only
// D output columns are stored. Up to DP = 128 Q sits in registers as the
// A operand of S = Q K^T; at DP = 192 and 256 it would take 48 or 64
// registers a thread beside O's 96 or 128, so Q is brought into shared
// memory by TMA once a block and S reads both operands from there. P V
// runs one m64n128k16 for each 128 columns of O and one m64n64k16 for 64
// left over (rs_cols). Past 256 (D a multiple of 128, the wrapper's
// padding) one online tile serves B8, B9 and the B12 chunks in two forms:
// to FWD16_CLUSTER_MAX_D (2048) the cluster form,
// attn_fwd_cluster_wgmma_kernel (clusters of ceil(D / 256) blocks, a
// 256-column slice of O a block, S formed once a tile and summed across
// the cluster in block order), but at 512 < D <= 768, where clusters of
// three blocks ran slower than the column groups on an H100 (and for B9
// up to 384), and past 2048 the column-group form, attn_fwd_cols_wgmma_kernel (which also takes a
// single-token decode past DECODE_SPLIT_MAX_D, at S_new = 1).
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
//   B9  attn_fwd_single_wgmma_kernel <- _fwd_kernel_single (:252): the
//       plain softmax over the whole key block (below).
// One integer `off` gives both masks: key j is visible to row i iff
// j <= i + off (B8, B9: 0; B12: kv_len - S_new).
//
// Bound on an H100: 4*D operations per visible score (S = Q K^T and
// O += P V) against 989 TFLOP/s of bf16 or f16 tensor cores; q, k, v are read
// once and O written once, two orders of magnitude fewer bytes at S in
// the hundreds, so both launchers are bound by operations.
//
// What the design does about it: one warpgroup (128 threads) per block
// owns 64 q rows of one q head; grid (B*H, q tiles), the last q tile,
// the heaviest under the causal mask, dispatched first. Q is read once,
// straight into registers as the 16-bit A operand of S = Q K^T (a
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
// to 16 bits as the A operand and the V tile read MN-major, and it retires
// within the iteration: a P V left in flight across the loop's back edge
// makes ptxas serialize every wgmma of the kernel (its C7515 warning).
// About 66 KB of shared memory and 168 registers at D = 128, so three
// blocks share an SM and one block's softmax runs beside the others'
// products (__launch_bounds__(WG, 3) up to DP = 128 holds it there: with
// the head dim a run-time value ptxas otherwise took 204 registers, two
// blocks an SM, and B8 ran 15 % slower on an H100); a 3-stage ring, or S of the next tile started beside P V as
// FlashAttention-3 does (192 registers), leaves room for two and was
// slower on an H100 SXM at B=4, H=32, Hkv=8, S=2048, D=128.
//
// K and V maps: B8 uses the 3-D map (B*Hkv, Skv, D); B12 a 4-D map over
// the cache as it is, dims {D, Hkv, kv_len, B} with the cache's strides,
// so TMA zero-fills every row at or past kv_len (the reference's
// :592-598 guard: 0 * NaN never reaches P V) and no head's tile reads
// another's rows.
//
// B9 (attn_fwd_single_wgmma_kernel) computes what _fwd_kernel_single
// computes: m over ALL visible keys of the row before any exponent, p =
// exp(s - m), l = max(sum p, 1e-30), O = P V / l, LSE = m + log l, the
// top-left causal mask, GQA through _kv_head_row. Same block shape and
// grid as B8 (one warpgroup per 64 q rows of one q head, Q in registers
// as the A operand), but two passes over the key tiles: pass 1 computes
// S = Q K^T tile by tile and keeps only the row max; pass 2 computes S
// again, p with the final m (no alpha rescale of O, which is what tells
// it from B8), l from the f32 p, and O += P V with P packed to 16 bits,
// retired within the iteration. Pass 2 walks the tiles backwards, so it
// starts from pass 1's last scores, still in registers, and the tile
// before them, still in the 2-stage TMA ring: n tiles cost 2n - 1
// products Q K^T and 2n - 2 K tile loads (the reloads from L2: a head's
// K at 512 keys is 128 KB), V n loads. The passes cost about 6*D
// operations per visible score instead of B8's 4*D; at the lengths that
// reach B9 (Skv <= 512 under the reference's block rule, 2048 with an
// explicit block_k) that is no limit: at B=4, H=32, Hkv=8, S=512, D=128
// the bound is 0.0126 ms by bytes (42 MB of q, k, v, O and LSE) against
// 0.0130 ms of operations at 6*D (0.0087 at 4*D), and at S=128 0.0031 ms
// by bytes against 0.0008, so the kernel is bound by bytes, by launch
// latency and by the chain of loads and products in each block.
//
// Rounding: S is exact 16-bit products summed in f32. P is f32 and is
// rounded to the input's type (round to nearest even) as the A operand
// of P V, so each term p * v moves by less than one unit u of its
// magnitude, u = 2^-8 for bf16 and 2^-11 for f16 (whose P in [0, 1]
// never leaves f16's range: below 2^-14 it keeps an absolute step of
// 2^-25); the row sum l is taken from the f32 P before that rounding.
// The output is O / max(l, 1e-30) (a true division) rounded to the
// input's type; the LSE is
// m + log(max(l, 1e-30)) in natural-log units, f32. A masked pair gets
// p = 0 through the mask, never through exp of a masked score.
#include <float.h>

#include <type_traits>

#include "sm90_tile.cuh"

namespace {

constexpr float NEG = -FLT_MAX;  // jnp.finfo(jnp.float32).min
constexpr float LN2 = 0.6931471805599453f;

// shared memory: two stages of K and V (BKV rows each), at DP > 128 the
// Q tile (BQ rows), then five barriers (K of stages 0 and 1, V of stages
// 0 and 1, Q)
template <int DP>
struct FwdSmem {
  static constexpr bool QS = DP > 128;  // Q in shared memory
  static constexpr int KV = BKV * DP * 2;
  static constexpr int Q = QS ? BQ * DP * 2 : 0;
  static constexpr int BARS = 4 * KV + Q;
  static constexpr int BYTES = BARS + 5 * 8 + 1024;  // + alignment slack
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

// B9's pass 1 on one key tile: the scaled scores (log2 units) of this
// thread's two rows into their running max (this thread's part; the row's
// four threads meet once after the pass)
template <bool MASK>
__device__ __forceinline__ void max_tile(const float* sc, float* m2,
                                         float scale_log2, int q0, int k0,
                                         int Skv, int causal) {
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i)
    if (!MASK || visible(q0 + frag_row(i), k0 + frag_col(i), Skv, causal, 0))
      m2[(i >> 1) & 1] = fmaxf(m2[(i >> 1) & 1], __fmul_rn(sc[i], scale_log2));
}

// B9's pass 2 on one key tile: p = 2^(s * scale_log2 - m) in place with the
// row's final max m (p = 0 where MASK hides the pair), added to the row's
// part of the sum
template <bool MASK>
__device__ __forceinline__ void exp_tile(float* sc, const float* m2, float* l,
                                         float scale_log2, int q0, int k0,
                                         int Skv, int causal) {
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) {
    const int h = (i >> 1) & 1;
    const float p =
        !MASK || visible(q0 + frag_row(i), k0 + frag_col(i), Skv, causal, 0)
            ? ex2(__fsub_rn(__fmul_rn(sc[i], scale_log2), m2[h]))
            : 0.0f;
    sc[i] = p;
    l[h] = __fadd_rn(l[h], p);
  }
}

// Q's A fragments for the k16 steps of the 64-row tile at q0 of row set
// bh (rows of D elements): register r of step kk holds columns 16kk +
// 8(r >> 1) + 2(tid & 3) + {0, 1} of row frag_row(2r) (to_a's layout);
// zeros past Sq and past D (D even: a pair is all in or all out)
template <typename T, int DP>
__device__ __forceinline__ void load_q(uint32_t (*qa)[4], const T* q, int bh,
                                       int Sq, int q0, int D) {
#pragma unroll
  for (int kk = 0; kk < Cols<DP>::KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + frag_row(2 * r);
      const int col = 16 * kk + 8 * (r >> 1) + 2 * (threadIdx.x & 3);
      qa[kk][r] = row < Sq && col < D
                      ? *reinterpret_cast<const uint32_t*>(
                            q + (static_cast<long long>(bh) * Sq + row) * D +
                            col)
                      : 0u;
    }
}

// S (64 rows x 64 keys) = Q K^T over the DP columns: Q from registers
// (qa) or, with QS, from the shared tile sq
template <typename T, int DP, bool QS>
__device__ __forceinline__ void scores(float* sc, uint32_t (*qa)[4],
                                       uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.0f;
  fence_regs<BKV / 2>(sc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < Cols<DP>::KS; ++kk) {
    if constexpr (QS)
      Wgmma<BKV>::ss<T>(sc, desc_k<BQ>(sq, kk), desc_k<BKV>(sk, kk), kk > 0);
    else
      Wgmma<BKV>::rs<T, 0>(sc, qa[kk], desc_k<BKV>(sk, kk), kk > 0);
  }
  wg_commit();
  wg_wait<0>();
  fence_regs<BKV / 2>(sc);
}

// O += P V over the tile's 64 keys, P packed to T, retired here
template <typename T, int DP>
__device__ __forceinline__ void pv(float* acc, const float* sc, uint32_t sv) {
  uint32_t pa[BKV / 16][4];
  to_a<T, BKV>(sc, pa);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    rs_cols<T, DP, BKV>(acc, pa[kk], sv, kk);
  wg_commit();
  wg_wait<0>();
  fence_regs<DP / 2>(acc);
}

// two f32 as T, rounded to nearest even, into o[0], o[1]
__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* o, float a, float b) {
  *reinterpret_cast<__half2*>(o) = __floats2half2_rn(a, b);
}

// O = acc / max(l, 1e-30) rounded to T for the tile's nq valid rows and
// its columns c0 .. c0 + DP - 1 below D (rows of D elements), and, if lse
// is given, LSE = m * ln 2 + log(max(l, 1e-30)); l is each thread's part
// of its rows' sums until the four threads of a row meet
template <typename T, int DP>
__device__ __forceinline__ void store_o_lse(const float* acc, const float* m2,
                                            float* l, T* o, float* lse,
                                            int bh, int Sq, int q0, int nq,
                                            int D, int c0 = 0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], 1));
    l[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], 2));
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int r = frag_row(i), c = c0 + frag_col(i);
    if (r >= nq || c >= D) continue;
    const float lr = l[(i >> 1) & 1];
    const long long e = (static_cast<long long>(bh) * Sq + q0 + r) * D + c;
    store2(o + e, __fdiv_rn(acc[i], lr), __fdiv_rn(acc[i + 1], lr));
  }
  if (lse != nullptr && (threadIdx.x & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row(2 * h);
      if (r < nq)
        lse[static_cast<long long>(bh) * Sq + q0 + r] =
            __fadd_rn(__fmul_rn(m2[h], LN2), logf(l[h]));
    }
  }
}

// The block's shared-memory layout (FwdSmem) as addresses
template <int DP>
struct FwdTiles {
  using L = FwdSmem<DP>;
  uint32_t base;
  __device__ __forceinline__ FwdTiles(const uint8_t* smem_raw) {
    const uint32_t raw = smem_u32(smem_raw);
    base = (raw + 1023) & ~1023u;
  }
  __device__ __forceinline__ uint32_t k(int s) const {
    return base + s * 2 * L::KV;
  }
  __device__ __forceinline__ uint32_t v(int s) const { return k(s) + L::KV; }
  __device__ __forceinline__ uint32_t q() const { return base + 4 * L::KV; }
  __device__ __forceinline__ uint32_t full_k(int s) const {
    return base + L::BARS + 8 * s;
  }
  __device__ __forceinline__ uint32_t full_v(int s) const {
    return base + L::BARS + 16 + 8 * s;
  }
  __device__ __forceinline__ uint32_t full_q() const {
    return base + L::BARS + 32;
  }
};

// q, o (B*H, Sq, D); tq its 3-D map (B*H, Sq, D), box rows BQ (read at DP
// > 128). k/v maps: with `cache` 0 the 3-D map (B*Hkv, Skv, D), with
// `cache` 1 the 4-D map {D, Hkv, Skv, B}; box rows BKV. lse (B*H, Sq)
// f32 or null.
template <typename T, int DP>
__global__ void __launch_bounds__(WG, DP <= 128 ? 3 : 1)
    attn_fwd_wgmma_kernel(const T* __restrict__ q,
                          __grid_constant__ const CUtensorMap tq,
                          __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv,
                          T* __restrict__ o, float* __restrict__ lse, int H,
                          int Hkv, int Sq, int Skv, int causal, int off,
                          int cache, int D, float scale) {
  using L = FwdSmem<DP>;
  constexpr int KS = Cols<DP>::KS;
  extern __shared__ uint8_t smem_raw[];
  const FwdTiles<DP> sm(smem_raw);

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
      tma_tile4<DP, BKV>(dst, map, bar, hkv, k0, b);
    else
      tma_tile<DP, BKV>(dst, map, bar, k0, b * Hkv + hkv);
  };
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(sm.full_k(s), 1);
      mbar_init(sm.full_v(s), 1);
    }
    mbar_init(sm.full_q(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    if constexpr (L::QS) {
      mbar_expect_tx(sm.full_q(), L::Q);
      tma_tile<DP, BQ>(sm.q(), &tq, sm.full_q(), q0, bh);
    }
    for (int s = 0; s < 2 && s < n_it; ++s) {
      load(sm.k(s), &tk, sm.full_k(s), s * BKV);
      load(sm.v(s), &tv, sm.full_v(s), s * BKV);
    }
  }

  uint32_t qa[L::QS ? 1 : KS][4];
  if constexpr (L::QS)
    mbar_wait(sm.full_q(), 0);
  else
    load_q<T, DP>(qa, q, bh, Sq, q0, D);
  float acc[DP / 2];                // O: q rows x DP columns
  float m2[2] = {NEG, NEG};         // running max, log2 units
  float l[2] = {0.0f, 0.0f};        // this thread's part of the row sum
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    const int s = it & 1, k0 = it * BKV;
    const uint32_t parity = (it >> 1) & 1;
    mbar_wait(sm.full_k(s), parity);
    float sc[BKV / 2];  // S: q rows x keys
    scores<T, DP, L::QS>(sc, qa, sm.q(), sm.k(s));
    __syncthreads();  // every read of K(s) and of V(s ^ 1) is done
    if (tid == 0) {
      if (it + 2 < n_it) load(sm.k(s), &tk, sm.full_k(s), k0 + 2 * BKV);
      if (it >= 1 && it + 1 < n_it)
        load(sm.v(s ^ 1), &tv, sm.full_v(s ^ 1), k0 + BKV);
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
    mbar_wait(sm.full_v(s), parity);
    pv<T, DP>(acc, sc, sm.v(s));
  }

  store_o_lse<T, DP>(acc, m2, l, o, lse, bh, Sq, q0, nq, D);
}

// B9: grid (B*H, q tiles), the last q tile first. q, o (B*H, Sq, D), tq
// as B8's; k/v the 3-D maps (B*Hkv, Skv, D), box rows BKV; lse (B*H, Sq)
// f32. Pass 1 reads key tiles 0 .. n-1, pass 2 n-1 .. 0: its first tile
// is pass 1's last, whose scores are still in registers, and its second
// is still in the ring, so pass 2 computes n - 1 products Q K^T and
// reloads n - 2 tiles of K. K tile j always lands in stage j & 1; V tile
// n-1-t of pass 2's step t in stage t & 1. Each K stage's barrier
// completes once per load into it, and each thread waits once per load,
// so a running parity per stage tells the phase to wait for.
template <typename T, int DP>
__global__ void __launch_bounds__(WG, 1)
    attn_fwd_single_wgmma_kernel(const T* __restrict__ q,
                                 __grid_constant__ const CUtensorMap tq,
                                 __grid_constant__ const CUtensorMap tk,
                                 __grid_constant__ const CUtensorMap tv,
                                 T* __restrict__ o, float* __restrict__ lse,
                                 int H, int Hkv, int Sq, int Skv, int causal,
                                 int D, float scale) {
  using L = FwdSmem<DP>;
  constexpr int KS = Cols<DP>::KS;
  extern __shared__ uint8_t smem_raw[];
  const FwdTiles<DP> sm(smem_raw);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);  // _kv_head_row
  const int nq = min(BQ, Sq - q0);
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;
  const int n = (kv_end + BKV - 1) / BKV;

  auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar,
                  int j) {
    mbar_expect_tx(bar, L::KV);
    tma_tile<DP, BKV>(dst, map, bar, j * BKV, kvrow);
  };
  auto load_k = [&](int j) { load(sm.k(j & 1), &tk, sm.full_k(j & 1), j); };
  auto load_v = [&](int t) {  // pass 2's step t: V tile n-1-t
    load(sm.v(t & 1), &tv, sm.full_v(t & 1), n - 1 - t);
  };
  // Q's loads fly while the barriers are set up and the first tiles asked
  uint32_t qa[L::QS ? 1 : KS][4];
  if constexpr (!L::QS) load_q<T, DP>(qa, q, bh, Sq, q0, D);
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tk))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tv))
                 : "memory");
    for (int s = 0; s < 2; ++s) {
      mbar_init(sm.full_k(s), 1);
      mbar_init(sm.full_v(s), 1);
    }
    mbar_init(sm.full_q(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    if constexpr (L::QS) {
      mbar_expect_tx(sm.full_q(), L::Q);
      tma_tile<DP, BQ>(sm.q(), &tq, sm.full_q(), q0, bh);
    }
    for (int s = 0; s < 2 && s < n; ++s) {
      load_k(s);
      load_v(s);
    }
  }
  if constexpr (L::QS) mbar_wait(sm.full_q(), 0);
  const float scale_log2 = scale * LOG2E;
  uint32_t kpar[2] = {0u, 0u};  // the phase each K stage completes next

  auto masked = [&](int j) {
    return j * BKV + BKV > Skv || (causal && j * BKV + BKV - 1 > q0);
  };
  // S = Q K^T of key tile j into sc, after waiting for its load if it is
  // a fresh one; then, if a load follows (`refill`), once every thread is
  // done with the stage it overwrites, that load
  float sc[BKV / 2];
  auto scores_j = [&](int j, bool fresh, bool refill, auto loads) {
    const int s = j & 1;
    if (fresh) {
      mbar_wait(sm.full_k(s), s ? kpar[1] : kpar[0]);
      if (s) kpar[1] ^= 1u; else kpar[0] ^= 1u;
    }
    scores<T, DP, L::QS>(sc, qa, sm.q(), sm.k(s));
    if (refill) {
      __syncthreads();  // every read of K(s) (and of the V stage freed) done
      if (tid == 0) loads();
    }
  };
  // pass 1: the row max over every visible key; stage j & 1 refilled
  // with tile j + 2, and after the last tile with n - 3, pass 2's first
  // reload
  float m2[2] = {NEG, NEG};  // log2 units
  for (int j = 0; j < n; ++j) {
    scores_j(j, true, j + 2 < n || (j == n - 1 && n >= 3), [&] {
      if (j + 2 < n) load_k(j + 2);
      if (j == n - 1 && n >= 3) load_k(n - 3);
    });
    if (masked(j))
      max_tile<true>(sc, m2, scale_log2, q0, j * BKV, Skv, causal);
    else
      max_tile<false>(sc, m2, scale_log2, q0, j * BKV, Skv, causal);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m2[h] = fmaxf(m2[h], __shfl_xor_sync(0xffffffffu, m2[h], 1));
    m2[h] = fmaxf(m2[h], __shfl_xor_sync(0xffffffffu, m2[h], 2));
  }

  // pass 2, tile j = n-1-t at step t: p with the final max, l, O += P V;
  // step 0 takes pass 1's last scores as they are
  float acc[DP / 2];
  float l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  for (int t = 0; t < n; ++t) {
    const int j = n - 1 - t;
    if (t > 0)  // tile j - 2 into j's stage; V of step t + 1 into the
                // stage step t - 1 used
      scores_j(j, t > 1, j >= 1, [&] {
        if (j >= 2) load_k(j - 2);
        load_v(t + 1);
      });
    if (masked(j))
      exp_tile<true>(sc, m2, l, scale_log2, q0, j * BKV, Skv, causal);
    else
      exp_tile<false>(sc, m2, l, scale_log2, q0, j * BKV, Skv, causal);
    mbar_wait(sm.full_v(t & 1), (t >> 1) & 1);
    pv<T, DP>(acc, sc, sm.v(t & 1));
  }
  store_o_lse<T, DP>(acc, m2, l, o, lse, bh, Sq, q0, nq, D);
}

// B8, B9 and B12's chunks (and single-token decode) at the head dims past
// 256 that fwd16_cluster leaves to it (512 < D <= 768, B9 to 384, and
// past 2048; the decode past DECODE_SPLIT_MAX_D): the column-group form (sm90_tile.cuh
// WCH, WGRP). D is a multiple of WCH (the wrapper pads it), so every chunk is whole. Grid (B*H, q
// tiles, column groups); block z keeps O's columns z*WGRP .. z*WGRP +
// WGRP - 1 (a 64 x 256 f32 accumulator, as B8 at DP = 256). For each key
// tile it forms S = Q K^T over the whole head dim, one WCH-column chunk a
// step (Q's and K's chunk in one ring slot, read from shared memory), then
// runs B8's online softmax and O += P V on its group of V's columns (the
// next slot). Every group issues the same chunks in the same order, so
// they reach the same m and l bit for bit; group 0 writes the LSE. B9
// takes this online tile too (at these head dims its two passes would
// form S twice more). Maps and masks as attn_fwd_wgmma_kernel's (`off`,
// `cache`).
template <typename T>
__global__ void __launch_bounds__(WG, 1)
    attn_fwd_cols_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                               __grid_constant__ const CUtensorMap tk,
                               __grid_constant__ const CUtensorMap tv,
                               T* __restrict__ o, float* __restrict__ lse,
                               int H, int Hkv, int Sq, int Skv, int causal,
                               int off, int cache, int D, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  auto slot = [&](int s) { return base + s * WSLOT; };
  auto bar = [&](int s) { return base + 2 * WSLOT + 8 * s; };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int c0 = blockIdx.z * WGRP;  // the block's first output column
  const int b = bh / H, hkv = (bh % H) / (H / Hkv);  // _kv_head_row
  const int nq = min(BQ, Sq - q0);
  const int kv_end = causal ? min(Skv, q0 + nq + off) : Skv;
  const int n_it = (kv_end + BKV - 1) / BKV;
  const int nch = wide_chunks(D), per = nch + 1;  // steps a key tile
  const int n_steps = n_it * per;
  constexpr uint32_t QB = BQ * WCH * 2;  // a Q chunk's bytes

  // one thread: step u's tiles into slot u & 1 (chunk c of Q and K, or
  // the group's V columns after the last chunk)
  auto issue = [&](int u) {
    const int s = u & 1, c = u % per, k0 = (u / per) * BKV;
    const uint32_t dst = slot(s);
    if (c < nch) {
      const int col = c * WCH;
      mbar_expect_tx(bar(s), QB + BKV * WCH * 2);
      tma_tile<WCH, BQ>(dst, &tq, bar(s), q0, bh, col);
      if (cache)
        tma_tile4<WCH, BKV>(dst + QB, &tk, bar(s), hkv, k0, b, col);
      else
        tma_tile<WCH, BKV>(dst + QB, &tk, bar(s), k0, b * Hkv + hkv, col);
    } else {
      mbar_expect_tx(bar(s), live_bytes<WGRP, BKV>(c0, D));
      if (cache)
        tma_tile4_live<WGRP, BKV>(dst, &tv, bar(s), hkv, k0, b, c0, D);
      else
        tma_tile_live<WGRP, BKV>(dst, &tv, bar(s), k0, b * Hkv + hkv, c0,
                                 D);
    }
  };
  if (tid == 0) {
    mbar_init(bar(0), 1);
    mbar_init(bar(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int u = 0; u < 2 && u < n_steps; ++u) issue(u);

  float acc[WGRP / 2];              // O: q rows x the group's columns
  float m2[2] = {NEG, NEG};         // running max, log2 units
  float l[2] = {0.0f, 0.0f};        // this thread's part of the row sum
#pragma unroll
  for (int i = 0; i < WGRP / 2; ++i) acc[i] = 0.0f;
  const float scale_log2 = scale * LOG2E;
  // step u landed; then, once every thread is done with its slot, step
  // u + 2 into it
  auto wait = [&](int u) { mbar_wait(bar(u & 1), (u >> 1) & 1); };
  auto release = [&](int u) {
    __syncthreads();
    if (tid == 0 && u + 2 < n_steps) issue(u + 2);
  };

  for (int it = 0; it < n_it; ++it) {
    const int k0 = it * BKV;
    float sc[BKV / 2];  // S: q rows x keys
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.0f;
    for (int c = 0; c < nch; ++c) {
      const int u = it * per + c;
      wait(u);
      const uint32_t sq = slot(u & 1), sk = sq + QB;
      fence_regs<BKV / 2>(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < Cols<WCH>::KS; ++kk)
        Wgmma<BKV>::ss<T>(sc, desc_k<BQ>(sq, kk), desc_k<BKV>(sk, kk), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs<BKV / 2>(sc);
      release(u);
    }
    float alpha[2];
    if (k0 + BKV > Skv || (causal && k0 + BKV - 1 > q0 + off))
      softmax_tile<true>(sc, m2, l, alpha, scale_log2, q0, k0, Skv, causal,
                         off);
    else
      softmax_tile<false>(sc, m2, l, alpha, scale_log2, q0, k0, Skv, causal,
                          off);
#pragma unroll
    for (int i = 0; i < WGRP / 2; ++i)
      acc[i] = __fmul_rn(acc[i], alpha[(i >> 1) & 1]);
    const int u = it * per + nch;
    wait(u);
    pv<T, WGRP>(acc, sc, slot(u & 1));
    release(u);
  }

  store_o_lse<T, WGRP>(acc, m2, l, o, blockIdx.z == 0 ? lse : nullptr, bh,
                       Sq, q0, nq, D, c0);
}

// B8, B9 and B12's chunks at 256 < D <= FWD16_CLUSTER_MAX_D (but where
// fwd16_cluster keeps the column groups): the cluster form. The
// column-group form above forms S over the whole head dim in every group,
// C (D + 256) products a tile for C groups where the work needs 2 D, and
// every group reloads all of Q's and K's chunks. Here a thread-block
// cluster of C = ceil(D / FSL) blocks (grid z, clusters (1, 1, C), C from
// 2 to 8; D a multiple of WCH, which the wrapper pads it to) owns one
// 64-row q tile of one (b, h), and block c keeps one slice, O's columns
// FSL*c .. FSL*c + FSL - 1 (a 64 x 256 f32 accumulator, as B8 at DP =
// 256). The last block may hold only 128 live columns: TMA loads only the
// live 64-column blocks (a box wholly past the map's extent loaded
// slowly), and Q_c's and K_c's others are zeros written once (zero_dead).
// Q_c loads once by TMA; K_c and V_c stream through two stages of 64 keys.
// For each key tile:
//   1. the slice's partial S_c = Q_c K_c^T (m64n64k16, FSL / 16 k-steps,
//      exact 16-bit products summed in f32);
//   2. the exchange, every position summed in block order 0 .. C - 1 so
//      that the bits do not depend on arrival. A thread's 32 accumulator
//      registers form FUNITS = 8 float4 units. At C = 2 each block stores
//      every unit into the other block's buffer for the tile (st.async,
//      counted on that block's receive mbarrier; two buffers, so a block
//      stores tile j + 2 only after the other has sent tile j + 1, which
//      it does after it has read tile j) and adds the two partials itself:
//      one round. At C > 2 unit u of every thread belongs to block u % C,
//      its owner: each block sends each unit it does not own to its
//      owner's slot for (unit, sender) (xch_slot), the owner's thread t
//      sums its units over the C blocks (its own partial from its
//      registers) and sends the f32 sum to every other block's result
//      slot, since every block needs whole rows for its softmax: two
//      rounds, one receive and one result buffer (a block sends tile j +
//      1's units only after it has every sum of tile j, which each owner
//      sends only after it has read tile j's units, and an owner sends
//      tile j + 1's sums only after every block's units of j + 1, which
//      each sends after it has read tile j's sums);
//   3. B8's online softmax (softmax_tile) on the summed S, so m, l and P
//      are the same bits in every block, O_c rescaled, then O_c += P V_c
//      (register-A wgmma over the slice, rs_cols), retired within the
//      iteration.
// The tiles overlap by one: tile j + 1's S_c is issued before tile j's
// softmax, and its units are sent before tile j's P V is issued, so the
// exchange of tile j + 1 runs beside tile j's P V. Thread 0 re-arms the
// mbarriers for tile j + 1 after its waits of tile j (arrive plus the
// bytes expected); bytes that land first leave the phase pending until it
// does. The cluster barrier before the first tile makes sure every
// block's mbarriers are initialized before a peer stores to them; the one
// after the last keeps every block resident until the cluster's stores
// have landed. Block 0 writes the LSE. Maps, masks and `off`/`cache` as
// attn_fwd_cols_wgmma_kernel's, so one kernel serves B8, B9 (its online
// tile) and the B12 chunks. A block moves 16 KB (C = 2) or about 2 (C -
// 1) / C of 16 KB a tile over the cluster's network against 4.2 MFLOP of
// S_c and P V_c. Code size moves this kernel's time: an owner's loops over
// the other blocks run as loops (unrolled, they ran slower on an H100),
// and its registers sit at 255 with no spills only when few values live
// across the loop (PERF.md).
constexpr int FSL = WGRP;                      // a block's columns of O
constexpr int FUNITS = BKV / 8;                // a thread's units of S
// The head dims that take the cluster form (ops/attention.py's
// takes_cluster16): past 256 up to FWD16_CLUSTER_MAX_D, but for the
// clusters of three blocks (FWD16_COLS_MIN_D < D <= FWD16_COLS_MAX_D) and
// B9 up to FWD16_SINGLE_MIN_D (a pair with a half-filled block), which ran
// slower than the column groups on an H100 (PERF.md), so those keep them
constexpr int FWD16_CLUSTER_MAX_D = 8 * FSL;
constexpr int FWD16_COLS_MIN_D = 2 * FSL, FWD16_COLS_MAX_D = 3 * FSL;
constexpr int FWD16_SINGLE_MIN_D = 3 * WCH;
__host__ __device__ constexpr bool fwd16_cluster(int d, bool single) {
  return d > (single ? FWD16_SINGLE_MIN_D : 256) &&
         d <= FWD16_CLUSTER_MAX_D &&
         (d <= FWD16_COLS_MIN_D || d > FWD16_COLS_MAX_D);
}
constexpr uint32_t FUB = WG * 16;              // a unit's bytes, every thread's

// shared memory of the cluster form: Q_c; K_c and V_c of stages 0 and 1;
// the exchange region (at C = 2 two tiles' units of the other block, else
// the owners' receive slots and then the sums received); the barriers (Q,
// K of both stages, V of both, receive (two), result)
struct FwdClSmem {
  static constexpr int Q = BQ * FSL * 2;
  static constexpr int KV = BKV * FSL * 2;
  static constexpr int X = Q + 4 * KV;
  static constexpr int NRCV = xch_slots(FUNITS, FWD16_CLUSTER_MAX_D / FSL);
  static constexpr int RES = X + (NRCV > 2 * FUNITS ? NRCV : 2 * FUNITS) * FUB;
  static constexpr int BARS = RES + FUNITS * FUB;
  static constexpr int BYTES = BARS + 8 * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "a block's shared memory");
};

// q, o (B*H, Sq, D) through the map tq; k/v maps as
// attn_fwd_cols_wgmma_kernel's; lse (B*H, Sq) f32 or null. Grid (B*H, q
// tiles, C), clusters (1, 1, C), C = ceil(D / FSL).
template <typename T>
__global__ void __launch_bounds__(WG, 1)
    attn_fwd_cluster_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                                  __grid_constant__ const CUtensorMap tk,
                                  __grid_constant__ const CUtensorMap tv,
                                  T* __restrict__ o, float* __restrict__ lse,
                                  int H, int Hkv, int Sq, int Skv, int causal,
                                  int off, int cache, int D, float scale) {
  using L = FwdClSmem;
  constexpr int KS = Cols<FSL>::KS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const float4* rcv = reinterpret_cast<const float4*>(gbase + L::X);
  const float4* res = reinterpret_cast<const float4*>(gbase + L::RES);
  const uint32_t sq = base, rcv_a = base + L::X, res_a = base + L::RES;
  auto sk = [&](int s) { return base + L::Q + s * 2 * L::KV; };
  auto sv = [&](int s) { return sk(s) + L::KV; };
  const uint32_t bar_q = base + L::BARS;
  auto full_k = [&](int s) { return bar_q + 8 + 8 * s; };
  auto full_v = [&](int s) { return bar_q + 24 + 8 * s; };
  auto bar_rcv = [&](int s) { return bar_q + 40 + 8 * s; };
  const uint32_t bar_res = bar_q + 56;

  const int tid = threadIdx.x;
  const int C = gridDim.z, rank = cluster_rank();
  const int bh = blockIdx.x, col0 = rank * FSL;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the heaviest first
  const int b = bh / H, hkv = (bh % H) / (H / Hkv);  // _kv_head_row
  const int n_it =
      ((causal ? min(Skv, min(q0 + BQ, Sq) + off) : Skv) + BKV - 1) / BKV;
  // two blocks: every unit to the other block (one round); else the owner
  // scheme (two rounds)
  const bool ag = C == 2;

  // one thread: key tile j of K_c or V_c into stage j & 1, the live column
  // blocks only (K's others hold the zeros zero_dead wrote; V's feed only
  // columns of O past D, never stored)
  auto load_k = [&](int j) {
    const uint32_t bar = full_k(j & 1);
    mbar_expect_tx(bar, live_bytes<FSL, BKV>(col0, D));
    if (cache)
      tma_tile4_live<FSL, BKV>(sk(j & 1), &tk, bar, hkv, j * BKV, b, col0,
                               D);
    else
      tma_tile_live<FSL, BKV>(sk(j & 1), &tk, bar, j * BKV, b * Hkv + hkv,
                              col0, D);
  };
  auto load_v = [&](int j) {
    const uint32_t bar = full_v(j & 1);
    mbar_expect_tx(bar, live_bytes<FSL, BKV>(col0, D));
    if (cache)
      tma_tile4_live<FSL, BKV>(sv(j & 1), &tv, bar, hkv, j * BKV, b, col0,
                               D);
    else
      tma_tile_live<FSL, BKV>(sv(j & 1), &tv, bar, j * BKV, b * Hkv + hkv,
                              col0, D);
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(bar_rcv(s), 1);
    }
    mbar_init(bar_res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q_c's and both K_c stages' column blocks past D: zeros, once
  zero_dead<FSL, BQ>(gbase, col0, D);
  zero_dead<FSL, BKV>(gbase + L::Q, col0, D);
  zero_dead<FSL, BKV>(gbase + L::Q + 2 * L::KV, col0, D);
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, live_bytes<FSL, BQ>(col0, D));
    tma_tile_live<FSL, BQ>(sq, &tq, bar_q, q0, bh, col0, D);
    for (int j = 0; j < 2 && j < n_it; ++j) {
      load_k(j);
      load_v(j);
    }
  }
  cluster_sync();  // every block's barriers are set: its peers may store

  // thread 0: the receive (and result) bars' phase of tile t
  auto arm = [&](int t) {
    if (tid != 0) return;
    if (ag) {
      mbar_expect_tx(bar_rcv(t & 1), FUNITS * FUB);
    } else {
      const int own = (FUNITS - rank + C - 1) / C;  // the units it owns
      mbar_expect_tx(bar_rcv(0), own * (C - 1) * FUB);
      mbar_expect_tx(bar_res, (FUNITS - own) * FUB);
    }
  };
  // S_c of key tile j into d, issued (not waited)
  auto issue_s = [&](float* d, int j) {
    mbar_wait(full_k(j & 1), (j >> 1) & 1);
    fence_regs<BKV / 2>(d);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<BKV>::ss<T>(d, desc_k<BQ>(sq, kk), desc_k<BKV>(sk(j & 1), kk),
                        kk > 0);
    wg_commit();
  };
  // tile t's units of d: at C = 2 every unit into the other block's
  // buffer t & 1, else each unit this block does not own to its owner's
  // slot for (unit, sender)
  auto send = [&](const float* d, int t) {
#pragma unroll
    for (int u = 0; u < FUNITS; ++u) {
      if (ag)
        st_async4(peer(rcv_a + ((t & 1) * FUNITS + u) * FUB + tid * 16,
                       rank ^ 1),
                  d[4 * u], d[4 * u + 1], d[4 * u + 2], d[4 * u + 3],
                  peer(bar_rcv(t & 1), rank ^ 1));
      else if (u % C != rank)
        st_async4(peer(rcv_a + xch_slot(u, rank, C) * FUB + tid * 16, u % C),
                  d[4 * u], d[4 * u + 1], d[4 * u + 2], d[4 * u + 3],
                  peer(bar_rcv(0), u % C));
    }
  };
  // tile t's sums into d, each position summed in block order: at C = 2
  // every unit here; else the owned units, sent on to every other block,
  // then the others' sums
  auto gather = [&](float* d, int t) {
    if (ag) {
      mbar_wait_cluster(bar_rcv(t & 1), (t >> 1) & 1);
#pragma unroll
      for (int u = 0; u < FUNITS; ++u) {
        const float4 mine = make_float4(d[4 * u], d[4 * u + 1], d[4 * u + 2],
                                        d[4 * u + 3]);
        // two partials: the same bits in either order
        const float4 x = add4(mine, rcv[((t & 1) * FUNITS + u) * WG + tid]);
        d[4 * u] = x.x;
        d[4 * u + 1] = x.y;
        d[4 * u + 2] = x.z;
        d[4 * u + 3] = x.w;
      }
      return;
    }
    mbar_wait_cluster(bar_rcv(0), t & 1);
#pragma unroll
    for (int u = 0; u < FUNITS; ++u) {
      if (u % C != rank) continue;
      const float4 mine =
          make_float4(d[4 * u], d[4 * u + 1], d[4 * u + 2], d[4 * u + 3]);
      const float4* slot = rcv + (u / C) * (C - 1) * WG + tid;
      float4 x = rank == 0 ? mine : slot[0];  // sender b's: slot[b' * WG]
#pragma unroll 1
      for (int bb = 1; bb < C; ++bb)
        x = add4(x, bb == rank ? mine : slot[(bb < rank ? bb : bb - 1) * WG]);
      d[4 * u] = x.x;
      d[4 * u + 1] = x.y;
      d[4 * u + 2] = x.z;
      d[4 * u + 3] = x.w;
#pragma unroll 1
      for (int bb = 0; bb < C; ++bb)
        if (bb != rank)
          st_async4(peer(res_a + u * FUB + tid * 16, bb), x.x, x.y, x.z, x.w,
                    peer(bar_res, bb));
    }
    mbar_wait_cluster(bar_res, t & 1);
#pragma unroll
    for (int u = 0; u < FUNITS; ++u) {
      if (u % C == rank) continue;
      const float4 w = res[u * WG + tid];
      d[4 * u] = w.x;
      d[4 * u + 1] = w.y;
      d[4 * u + 2] = w.z;
      d[4 * u + 3] = w.w;
    }
  };

  float acc[FSL / 2];               // O_c: q rows x the block's columns
  float m2[2] = {NEG, NEG};         // running max, log2 units
  float l[2] = {0.0f, 0.0f};        // this thread's part of the row sum
#pragma unroll
  for (int i = 0; i < FSL / 2; ++i) acc[i] = 0.0f;
  const float scale_log2 = scale * LOG2E;
  float sc[BKV / 2], nx[BKV / 2];   // S of this tile, S_c of the next

  mbar_wait(bar_q, 0);
  arm(0);
  issue_s(sc, 0);
  wg_wait<0>();
  fence_regs<BKV / 2>(sc);
  send(sc, 0);
  gather(sc, 0);
  __syncthreads();  // every read of K tile 0 is done
  if (tid == 0 && n_it > 2) load_k(2);

  // key tile it; with NEXT (every tile but the last) tile it + 1's S_c
  // and its exchange beside it (a compile-time flag: no wgmma is issued
  // or waited for under a run-time branch)
  auto tile = [&](int it, auto next_c) {
    constexpr bool NEXT = decltype(next_c)::value;
    const int s = it & 1, k0 = it * BKV;
    if constexpr (NEXT) {
      arm(it + 1);
      issue_s(nx, it + 1);
    }
    float alpha[2];
    if (k0 + BKV > Skv || (causal && k0 + BKV - 1 > q0 + off))
      softmax_tile<true>(sc, m2, l, alpha, scale_log2, q0, k0, Skv, causal,
                         off);
    else
      softmax_tile<false>(sc, m2, l, alpha, scale_log2, q0, k0, Skv, causal,
                          off);
#pragma unroll
    for (int i = 0; i < FSL / 2; ++i)
      acc[i] = __fmul_rn(acc[i], alpha[(i >> 1) & 1]);
    uint32_t pa[BKV / 16][4];
    to_a<T, BKV>(sc, pa);
    if constexpr (NEXT) {
      wg_wait<0>();
      fence_regs<BKV / 2>(nx);
      send(nx, it + 1);
    }
    mbar_wait(full_v(s), (it >> 1) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      rs_cols<T, FSL, BKV>(acc, pa[kk], sv(s), kk);
    wg_commit();
    if constexpr (NEXT) gather(nx, it + 1);
    wg_wait<0>();
    fence_regs<FSL / 2>(acc);
    if constexpr (NEXT) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) sc[i] = nx[i];
      __syncthreads();  // every read of K tile it + 1 and V tile it is done
      if (tid == 0) {
        if (it + 3 < n_it) load_k(it + 3);
        if (it + 2 < n_it) load_v(it + 2);
      }
    }
  };
  for (int it = 0; it + 1 < n_it; ++it) tile(it, std::true_type{});
  tile(n_it - 1, std::false_type{});
  cluster_sync();  // the cluster's last stores have landed

  store_o_lse<T, FSL>(acc, m2, l, o, rank == 0 ? lse : nullptr, bh, Sq, q0,
                      min(BQ, Sq - q0), D, col0);
}

// the operands of one launch besides the maps
struct Args {
  const void* q;
  void* o;
  void* lse;
  int B, H, Hkv, Sq, Skv, causal, off, cache, D;
  float scale;
  cudaStream_t st;
};

struct Maps {
  CUtensorMap q, k, v;
};

template <typename T, int DP>
cudaError_t launch(const Maps& m, const Args& a) {
  constexpr int smem = FwdSmem<DP>::BYTES;
  auto kern = attn_fwd_wgmma_kernel<T, DP>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  kern<<<grid, WG, smem, a.st>>>(static_cast<const T*>(a.q), m.q, m.k, m.v,
                                 static_cast<T*>(a.o),
                                 static_cast<float*>(a.lse), a.H, a.Hkv,
                                 a.Sq, a.Skv, a.causal, a.off, a.cache, a.D,
                                 a.scale);
  e = cudaGetLastError();
  if (e == cudaSuccess)
    set_attn_route(a.cache ? ROUTE_PREFILL_WGMMA : ROUTE_FWD_WGMMA,
                   Elt<T>::F16 ? 2 : 1, DP);
  return e;
}

template <typename T, int DP>
cudaError_t launch_single(const Maps& m, const Args& a) {
  constexpr int smem = FwdSmem<DP>::BYTES;
  auto kern = attn_fwd_single_wgmma_kernel<T, DP>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  kern<<<grid, WG, smem, a.st>>>(static_cast<const T*>(a.q), m.q, m.k, m.v,
                                 static_cast<T*>(a.o),
                                 static_cast<float*>(a.lse), a.H, a.Hkv,
                                 a.Sq, a.Skv, a.causal, a.D, a.scale);
  e = cudaGetLastError();
  if (e == cudaSuccess)
    set_attn_route(ROUTE_FWD_SINGLE_WGMMA, Elt<T>::F16 ? 2 : 1, DP);
  return e;
}

// the column-group form (D > 256) of route `kind`
template <typename T>
cudaError_t launch_cols(const Maps& m, const Args& a, int kind) {
  constexpr int smem = 2 * WSLOT + 2 * 8 + 1024;
  auto kern = attn_fwd_cols_wgmma_kernel<T>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ, (a.D + WGRP - 1) / WGRP);
  kern<<<grid, WG, smem, a.st>>>(m.q, m.k, m.v, static_cast<T*>(a.o),
                                 static_cast<float*>(a.lse), a.H, a.Hkv,
                                 a.Sq, a.Skv, a.causal, a.off, a.cache, a.D,
                                 a.scale);
  e = cudaGetLastError();
  if (e == cudaSuccess) set_attn_route(kind, Elt<T>::F16 ? 2 : 1, WGRP);
  return e;
}

// the cluster form (256 < D <= FWD16_CLUSTER_MAX_D) of route `kind`:
// clusters of ceil(D / FSL) blocks, refused (cudaErrorLaunchOutOfResources)
// where the card cannot hold one
template <typename T>
cudaError_t launch_cluster(const Maps& m, const Args& a, int kind) {
  const int C = (a.D + FSL - 1) / FSL;
  cudaError_t e = launch_cluster16(
      attn_fwd_cluster_wgmma_kernel<T>, a.B * a.H, (a.Sq + BQ - 1) / BQ, C,
      FwdClSmem::BYTES, a.st, m.q, m.k, m.v, static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.H, a.Hkv, a.Sq, a.Skv, a.causal, a.off,
      a.cache, a.D, a.scale);
  if (e == cudaSuccess) set_attn_route(kind, Elt<T>::F16 ? 2 : 1, FSL);
  return e;
}

// a contiguous 16-bit cache (B, T, Hkv, D) as the 4-D map {D, Hkv,
// kv_len, B}: boxes of 64 columns x BKV rows of one head of one batch
// row; the T extent is kv_len, so every row at or past it reads as zeros
template <typename T>
cudaError_t cache_map(CUtensorMap* map, const void* ptr, int B, int Tlen,
                      int Hkv, int D, int kv_len) {
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Hkv),
      static_cast<cuuint64_t>(kv_len), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(Hkv) * D * 2,
      static_cast<cuuint64_t>(Tlen) * Hkv * D * 2};
  const cuuint32_t box[4] = {64, 1, BKV, 1};
  return encode16<T>(map, ptr, 4, dims, strides, box);
}

// the maps of B8 and B9: q (B*H, Sq, D), k and v (B*Hkv, Skv, D)
template <typename T>
cudaError_t fwd_maps(Maps* m, const void* q, const void* k, const void* v,
                     const Args& a) {
  cudaError_t e = tile_map<T>(&m->q, q, a.B * a.H, a.Sq, a.D, BQ);
  if (e == cudaSuccess) e = tile_map<T>(&m->k, k, a.B * a.Hkv, a.Skv, a.D, BKV);
  if (e == cudaSuccess) e = tile_map<T>(&m->v, v, a.B * a.Hkv, a.Skv, a.D, BKV);
  return e;
}

template <typename T, int DP>
cudaError_t run_fwd(const void* k, const void* v, const Args& a) {
  Maps m;
  cudaError_t e = fwd_maps<T>(&m, a.q, k, v, a);
  return e == cudaSuccess ? launch<T, DP>(m, a) : e;
}

template <typename T, int DP>
cudaError_t run_single(const void* k, const void* v, const Args& a) {
  Maps m;
  cudaError_t e = fwd_maps<T>(&m, a.q, k, v, a);
  return e == cudaSuccess ? launch_single<T, DP>(m, a) : e;
}

// q (B, H, S_new, D) as (B*H, S_new, D); the caches through kv_len
template <typename T>
cudaError_t prefill_maps(Maps* m, const void* kc, const void* vc, int Tlen,
                         const Args& a) {
  cudaError_t e = tile_map<T>(&m->q, a.q, a.B * a.H, a.Sq, a.D, BQ);
  if (e == cudaSuccess)
    e = cache_map<T>(&m->k, kc, a.B, Tlen, a.Hkv, a.D, a.Skv);
  if (e == cudaSuccess)
    e = cache_map<T>(&m->v, vc, a.B, Tlen, a.Hkv, a.D, a.Skv);
  return e;
}

template <typename T, int DP>
cudaError_t run_prefill(const void* kc, const void* vc, int Tlen,
                        const Args& a) {
  Maps m;
  cudaError_t e = prefill_maps<T>(&m, kc, vc, Tlen, a);
  return e == cudaSuccess ? launch<T, DP>(m, a) : e;
}

// D > 256: B8 and B9 (route kind) on the column-group kernel
template <typename T>
cudaError_t run_fwd_cols(const void* k, const void* v, const Args& a,
                         int kind) {
  Maps m;
  cudaError_t e = fwd_maps<T>(&m, a.q, k, v, a);
  return e == cudaSuccess ? launch_cols<T>(m, a, kind) : e;
}

template <typename T>
cudaError_t run_prefill_cols(const void* kc, const void* vc, int Tlen,
                             const Args& a, int kind) {
  Maps m;
  cudaError_t e = prefill_maps<T>(&m, kc, vc, Tlen, a);
  return e == cudaSuccess ? launch_cols<T>(m, a, kind) : e;
}


// 256 < D <= FWD16_CLUSTER_MAX_D: B8 and B9 (route kind) on the cluster
// kernel
template <typename T>
cudaError_t run_fwd_cluster(const void* k, const void* v, const Args& a,
                            int kind) {
  Maps m;
  cudaError_t e = fwd_maps<T>(&m, a.q, k, v, a);
  return e == cudaSuccess ? launch_cluster<T>(m, a, kind) : e;
}

template <typename T>
cudaError_t run_prefill_cluster(const void* kc, const void* vc, int Tlen,
                                const Args& a, int kind) {
  Maps m;
  cudaError_t e = prefill_maps<T>(&m, kc, vc, Tlen, a);
  return e == cudaSuccess ? launch_cluster<T>(m, a, kind) : e;
}


}  // namespace

// Called by accl_attn_fwd (attention.cu) for 16-bit operands (dtype code
// 1 bf16, 2 f16): B8.
int attn_fwd_wgmma(int dtype, int head_dim, const void* q, const void* k,
                   const void* v, void* o, void* lse, int B, int H, int Hkv,
                   int Sq, int Skv, int causal, float scale,
                   cudaStream_t st) {
  const Args a{q, o, lse, B, H, Hkv, Sq, Skv, causal, 0, 0, head_dim, scale,
               st};
  if (head_dim > 256 && head_dim % WCH) return cudaErrorInvalidValue;
  if (fwd16_cluster(head_dim, false))
    SM90_COLS_DISPATCH(run_fwd_cluster, k, v, a, ROUTE_FWD_WGMMA_CLUSTER)
  if (head_dim > 256)
    SM90_COLS_DISPATCH(run_fwd_cols, k, v, a, ROUTE_FWD_COLS_WGMMA)
  SM90_DISPATCH(run_fwd, k, v, a)
}

// Called by accl_attn_decode (attention.cu) for 16-bit chunks of S_new > 1
// new tokens: B12's prefill route; at D > 256 also for S_new == 1 (the
// column-group kernel). q and o (B, H, S_new, D); the caches (B, T, Hkv,
// D), filled through kv_len.
int attn_prefill_wgmma(int dtype, int head_dim, const void* q,
                       const void* kc, const void* vc, void* o, int B, int H,
                       int Hkv, int Tlen, int s_new, int kv_len, float scale,
                       cudaStream_t st) {
  const Args a{q, o, nullptr, B, H, Hkv, s_new, kv_len, 1, kv_len - s_new,
               1, head_dim, scale, st};
  if (head_dim > 256 && head_dim % WCH) return cudaErrorInvalidValue;
  if (fwd16_cluster(head_dim, false) && s_new > 1)
    SM90_COLS_DISPATCH(run_prefill_cluster, kc, vc, Tlen, a,
                       ROUTE_PREFILL_WGMMA_CLUSTER)
  if (head_dim > 256)
    SM90_COLS_DISPATCH(run_prefill_cols, kc, vc, Tlen, a,
                       s_new == 1 ? ROUTE_DECODE_COLS_WGMMA
                                  : ROUTE_PREFILL_COLS_WGMMA)
  SM90_DISPATCH(run_prefill, kc, vc, Tlen, a)
}

// Called by accl_attn_fwd_single (attention.cu) for 16-bit operands: B9.
int attn_fwd_single_wgmma(int dtype, int head_dim, const void* q,
                          const void* k, const void* v, void* o, void* lse,
                          int B, int H, int Hkv, int Sq, int Skv, int causal,
                          float scale, cudaStream_t st) {
  const Args a{q, o, lse, B, H, Hkv, Sq, Skv, causal, 0, 0, head_dim, scale,
               st};
  if (head_dim > 256 && head_dim % WCH) return cudaErrorInvalidValue;
  if (fwd16_cluster(head_dim, true))
    SM90_COLS_DISPATCH(run_fwd_cluster, k, v, a,
                       ROUTE_FWD_SINGLE_WGMMA_CLUSTER)
  if (head_dim > 256)
    SM90_COLS_DISPATCH(run_fwd_cols, k, v, a, ROUTE_FWD_SINGLE_COLS_WGMMA)
  SM90_DISPATCH(run_single, k, v, a)
}

// the clusters of the 16-bit forward's cluster form (bf16; the f16 kernel
// has the same shape) at head_dim that the card holds at once (for
// reports): 0 where the forward does not take that form, minus the CUDA
// error code if the query fails
extern "C" int accl_attn_fwd16_active_clusters(int head_dim) {
  if (head_dim <= 256 || head_dim > FWD16_CLUSTER_MAX_D || head_dim % WCH)
    return 0;  // (also at the head dims that keep the column groups)
  int n = 0;
  const cudaError_t e = cluster16_active(
      attn_fwd_cluster_wgmma_kernel<__nv_bfloat16>,
      (head_dim + FSL - 1) / FSL, FwdClSmem::BYTES, &n);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// B8 on the cluster form at any 16-bit head dim past 256 up to
// FWD16_CLUSTER_MAX_D (a multiple of WCH), also where fwd16_cluster keeps
// the column groups: for measuring the two forms side by side
// (chip_compare.py); the entry points above dispatch
extern "C" int accl_attn_fwd16_cluster(int dtype, int head_dim, const void* q,
                                       const void* k, const void* v, void* o,
                                       void* lse, int B, int H, int Hkv,
                                       int Sq, int Skv, int causal,
                                       float scale, void* stream) {
  if (head_dim <= 256 || head_dim > FWD16_CLUSTER_MAX_D || head_dim % WCH)
    return cudaErrorInvalidValue;
  const Args a{q, o, lse, B, H, Hkv, Sq, Skv, causal, 0, 0, head_dim, scale,
               static_cast<cudaStream_t>(stream)};
  SM90_COLS_DISPATCH(run_fwd_cluster, k, v, a, ROUTE_FWD_WGMMA_CLUSTER)
}
