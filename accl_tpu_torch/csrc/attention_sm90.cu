// Attention forward kernels B8, B9 and B12's prefill route for bf16 inputs
// on Hopper's tensor cores (CUDA C++, sm_90a): one online-softmax tile on
// wgmma (bf16 operands, f32 accumulators) with K and V brought into
// shared memory by TMA and two launchers (B8, B12 prefill), and B9's
// two-pass plain-softmax kernel on the same tiles. The f32 inputs keep the
// CUDA-core kernels of attention.cu, and B12's single-token decode (S_new
// == 1) the split-KV kernel of attention_decode.cu; the C entry points of
// attention.cu send bf16 B8, bf16 B9 and bf16 chunks with S_new > 1 here.
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
// B9 (attn_fwd_single_wgmma_kernel) computes what _fwd_kernel_single
// computes: m over ALL visible keys of the row before any exponent, p =
// exp(s - m), l = max(sum p, 1e-30), O = P V / l, LSE = m + log l, the
// top-left causal mask, GQA through _kv_head_row. Same block shape and
// grid as B8 (one warpgroup per 64 q rows of one q head, Q in registers
// as the A operand), but two passes over the key tiles: pass 1 computes
// S = Q K^T tile by tile and keeps only the row max; pass 2 computes S
// again, p with the final m (no alpha rescale of O, which is what tells
// it from B8), l from the f32 p, and O += P V with P packed to bf16,
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

// Q's A fragments for the KS k16 steps of the 64-row tile at q0 of row
// set bh: register r of step kk holds columns 16kk + 8(r >> 1) + 2(tid &
// 3) + {0, 1} of row frag_row(2r) (to_a's layout); zeros past Sq
template <int D>
__device__ __forceinline__ void load_q(uint32_t (*qa)[4],
                                       const __nv_bfloat16* q, int bh, int Sq,
                                       int q0) {
#pragma unroll
  for (int kk = 0; kk < Cols<D>::KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + frag_row(2 * r);
      const int col = 16 * kk + 8 * (r >> 1) + 2 * (threadIdx.x & 3);
      qa[kk][r] = row < Sq
                      ? *reinterpret_cast<const uint32_t*>(
                            q + (static_cast<long long>(bh) * Sq + row) * D +
                            col)
                      : 0u;
    }
}

// O = acc / max(l, 1e-30) rounded to bf16 for the tile's nq valid rows,
// and, if lse is given, LSE = m * ln 2 + log(max(l, 1e-30)); l is each
// thread's part of its rows' sums until the four threads of a row meet
template <int D>
__device__ __forceinline__ void store_o_lse(const float* acc, const float* m2,
                                            float* l, __nv_bfloat16* o,
                                            float* lse, int bh, int Sq,
                                            int q0, int nq) {
  constexpr int DP = Cols<D>::DP;
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

  uint32_t qa[KS][4];
  load_q<D>(qa, q, bh, Sq, q0);
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

  store_o_lse<D>(acc, m2, l, o, lse, bh, Sq, q0, nq);
}

// B9: grid (B*H, q tiles), the last q tile first. q, o (B*H, Sq, D) bf16;
// k/v the 3-D maps (B*Hkv, Skv, D), box rows BKV; lse (B*H, Sq) f32. Pass
// 1 reads key tiles 0 .. n-1, pass 2 n-1 .. 0: its first tile is pass
// 1's last, whose scores are still in registers, and its second is still
// in the ring, so pass 2 computes n - 1 products Q K^T and reloads n - 2
// tiles of K. K tile j always lands in stage j & 1; V tile n-1-t of pass
// 2's step t in stage t & 1. Each K stage's barrier completes once per
// load into it, and each thread waits once per load, so a running parity
// per stage tells the phase to wait for.
template <int D>
__global__ void __launch_bounds__(WG, 1)
    attn_fwd_single_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                                 __grid_constant__ const CUtensorMap tk,
                                 __grid_constant__ const CUtensorMap tv,
                                 __nv_bfloat16* __restrict__ o,
                                 float* __restrict__ lse, int H, int Hkv,
                                 int Sq, int Skv, int causal, float scale) {
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
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);  // _kv_head_row
  const int nq = min(BQ, Sq - q0);
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;
  const int n = (kv_end + BKV - 1) / BKV;

  auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar,
                  int j) {
    mbar_expect_tx(bar, L::KV);
    tma_tile<D, BKV>(dst, map, bar, j * BKV, kvrow);
  };
  auto load_k = [&](int j) { load(sK(j & 1), &tk, full_k(j & 1), j); };
  auto load_v = [&](int t) {  // pass 2's step t: V tile n-1-t
    load(sV(t & 1), &tv, full_v(t & 1), n - 1 - t);
  };
  // Q's loads fly while the barriers are set up and the first tiles asked
  uint32_t qa[KS][4];
  load_q<D>(qa, q, bh, Sq, q0);
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tk))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tv))
                 : "memory");
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < 2 && s < n; ++s) {
      load_k(s);
      load_v(s);
    }
  }
  const float scale_log2 = scale * LOG2E;
  uint32_t kpar[2] = {0u, 0u};  // the phase each K stage completes next

  auto masked = [&](int j) {
    return j * BKV + BKV > Skv || (causal && j * BKV + BKV - 1 > q0);
  };
  // S = Q K^T of key tile j into sc, after waiting for its load if it is
  // a fresh one; then, if a load follows (`refill`), once every thread is
  // done with the stage it overwrites, that load
  float sc[BKV / 2];
  auto scores = [&](int j, bool fresh, bool refill, auto loads) {
    const int s = j & 1;
    if (fresh) {
      mbar_wait(full_k(s), s ? kpar[1] : kpar[0]);
      if (s) kpar[1] ^= 1u; else kpar[0] ^= 1u;
    }
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
    scores(j, true, j + 2 < n || (j == n - 1 && n >= 3), [&] {
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
      scores(j, t > 1, j >= 1, [&] {
        if (j >= 2) load_k(j - 2);
        load_v(t + 1);
      });
    if (masked(j))
      exp_tile<true>(sc, m2, l, scale_log2, q0, j * BKV, Skv, causal);
    else
      exp_tile<false>(sc, m2, l, scale_log2, q0, j * BKV, Skv, causal);
    uint32_t pa[BKV / 16][4];  // P, bf16
    to_a<BKV>(sc, pa);
    mbar_wait(full_v(t & 1), (t >> 1) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      Wgmma<DP>::rs(acc, pa[kk], desc_mn<BKV>(sV(t & 1), kk));
    wg_commit();
    wg_wait<0>();
    fence_regs<DP / 2>(acc);
  }
  store_o_lse<D>(acc, m2, l, o, lse, bh, Sq, q0, nq);
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

// head dim -> the instantiation of FN
#define SM90_DISPATCH(FN, ...)                 \
  switch (head_dim) {                          \
    case 16: return FN<16>(__VA_ARGS__);       \
    case 32: return FN<32>(__VA_ARGS__);       \
    case 64: return FN<64>(__VA_ARGS__);       \
    case 128: return FN<128>(__VA_ARGS__);     \
    default: return cudaErrorInvalidValue;     \
  }

cudaError_t launch_d(int head_dim, const CUtensorMap& tk,
                     const CUtensorMap& tv, const Args& a) {
  SM90_DISPATCH(launch, tk, tv, a)
}

template <int D>
cudaError_t launch_single(const CUtensorMap& tk, const CUtensorMap& tv,
                          const Args& a) {
  constexpr int smem = FwdSmem<D>::BYTES;
  auto kern = attn_fwd_single_wgmma_kernel<D>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  kern<<<grid, WG, smem, a.st>>>(static_cast<const __nv_bfloat16*>(a.q),
                                 tk, tv, static_cast<__nv_bfloat16*>(a.o),
                                 static_cast<float*>(a.lse), a.H, a.Hkv,
                                 a.Sq, a.Skv, a.causal, a.scale);
  return cudaGetLastError();
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

// Called by accl_attn_fwd_single (attention.cu) for bf16 operands: B9.
int attn_fwd_single_wgmma(int head_dim, const void* q, const void* k,
                          const void* v, void* o, void* lse, int B, int H,
                          int Hkv, int Sq, int Skv, int causal, float scale,
                          cudaStream_t st) {
  CUtensorMap tk, tv;
  cudaError_t e = tile_map(&tk, k, B * Hkv, Skv, head_dim, BKV);
  if (e == cudaSuccess) e = tile_map(&tv, v, B * Hkv, Skv, head_dim, BKV);
  if (e != cudaSuccess) return e;
  const Args a{q, o, lse, B, H, Hkv, Sq, Skv, causal, 0, 0, scale, st};
  SM90_DISPATCH(launch_single, tk, tv, a)
}
