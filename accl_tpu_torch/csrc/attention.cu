// Attention forward kernels B8, B9 and B12 (CUDA C++, sm_90a), the f32
// route: the FlashAttention-2 forward on the TF32 tensor cores with
// 3xTF32 products.
//
// Replace accl_tpu/ops/attention.py:
//   B8  attn_fwd_kernel        <- _fwd_kernel (pallas_call at :285): the
//       online-softmax forward that streams KV, with O and the per-row
//       log-sum-exp (LSE), the causal frontier skip and GQA routing.
//   B9  attn_fwd_single_kernel <- _fwd_kernel_single (:252): the same when
//       the whole padded KV is one reference block. Its plain softmax is
//       the online softmax here, over the block's key tiles.
//   B12 attn_decode_kernel     <- _decode_kernel (:689): chunked prefill
//       (S_new > 1) over the KV cache in its native (B, T, Hkv, D) layout,
//       bottom-right causal.
//
// Routes: the C entry points below send 16-bit (bf16 and f16) B8, B9 and
// B12 chunks of S_new > 1 new tokens to the tensor-core kernels of
// attention_sm90.cu (wgmma, TMA), and every single-token decode (S_new ==
// 1, any dtype) to attention_decode.cu (the split-KV kernels; f32 past head
// dim 2048 the band decode). f32 B8, f32 B9 and f32 B12 chunks run the
// kernels of this file, past head dim 4096 the band form of
// attention_band_fwd.cu.
//
// What bounds them on an H100: 4*D operations per visible score (S = Q K^T
// and P V) against 2*D*4 bytes per key row, so at S in the hundreds and
// above they are bound by operations. Every product runs three times on
// the 495 TFLOP/s TF32 tensor cores (bound 3 * ops / 495 TFLOP/s, 2.7x
// below the CUDA cores' ops / 67 TFLOP/s); at S = 128 the bytes bound.
//
// Numerics (tf32_mma.cuh): every f32 operand (Q, K, V and P) is split into
// hi = tf32(a) and lo = tf32(a - hi), and a product is lo*hi + hi*lo +
// hi*hi in f32 accumulators: about f32 accuracy, where one TF32 product
// would break the f32 limit the card holds these kernels to
// (tests/test_torch_attention_fwd_f32.py emulates both). The tensor core
// truncates as it accumulates, so every sum over the keys starts fresh:
// each key tile's S and each tile's P V go into fresh accumulators, and P
// V is added into the running O as O = O * alpha + PV with f32 roundings.
// expf/logf (no intrinsics, no fast math), a true division o = acc / l.
// Masked scores take part as finfo(f32).min in the row max and contribute
// p = 0 (attention.py:617). A fully masked row cannot occur on these
// paths (causal rows always see key 0; chunk rows see their own
// position), but it is handled as the reference handles it: l is floored
// at 1e-30, so o = 0 and the LSE is finite.
//
// Design: mma.sync m16n8k8 (tf32 x tf32 -> f32). One block per (head row
// set, q tile of BQ rows); two warps share each 16 query rows, so BQ / 8
// warps. A loop over BK-key tiles stands in for the TPU's sequential grid
// axis. Of a pair, warp h forms the scores of the tile's keys [BK/2 * h,
// BK/2 * (h + 1)) and keeps output columns [D/2 * h, D/2 * (h + 1)): the
// pair trades row maxima, row sums and its halves of P through shared
// memory (two named barriers a tile), and each warp keeps the running max
// m, normaliser l and its 16 x D/2 of the output in registers. A warp that
// kept all D columns would hold 64 accumulators of O and 32 words of P at
// D = 128, and ptxas spilled that kernel. The split costs about as many
// instructions as the products it feeds, so it is made once per block:
// Q is split into hi and lo planes in shared memory when the block
// starts, and each K and V tile as it lands, from two f32 staging buffers
// that cp.async fills two tiles ahead (tile t + 2 flies while tile t is
// computed; two block barriers a tile); the inner loops are ldmatrix and
// HMMA only. S = Q K^T sits in the accumulators as P does, and P serves
// as the A operand of P V from those registers: an accumulator holds
// columns 2t, 2t+1 where the A operand wants t, t+4, and the reduction
// index is free to permute, so the V tile is stored transposed with the
// keys of each group of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7.
//
// Shared memory (FwdSmem below), in 4-byte words: the hi and lo planes of
// Q (BQ x D), K (BK x D) and V^T (D x BK), two stages of staged K and V
// tiles (BK rows each), and the pairs' exchange; every row padded by 4
// words (16 bytes), so the 8 rows an ldmatrix reads hit 32 distinct banks.
// At D = 128 with BQ = 64, BK = 32: Q 2 x 33 KB, K 2 x 16.5 KB, V^T 2 x 18
// KB, staging 4 x 16.5 KB, exchange 17 KB: 218 KB of the 227 KB a block
// may use, one block an SM.
//
// Head dims: instantiated on power-of-two column tiers DP (16 .. 256),
// with the head dim D <= DP (a multiple of 8) at run time: cp.async and
// the Q load fill the columns past D with zeros, which add nothing to a
// score or an output column, and only D columns are stored. At DP = 256
// the planes alone take 2 x 33 KB (Q at 64 rows), 2 x 33 KB (K) and 2 x
// 36 KB (V^T): with the staging buffers (4 x 33 KB) that is twice a
// block's shared memory. So DP = 256 runs 32 query rows a block (4 warps,
// Q's planes 2 x 16.6 KB) and no staging: each K and V tile is read from
// global memory straight into the split (210.5 KB in all), so its loads
// are not overlapped with the previous tile's products. A warp's 64 O
// accumulators beside P's 32 words spilled there, so P V reads P's
// fragments from the pair's exchange buffer as it uses them
// (pv_update_smem) instead of holding them.
//
// Only keys below the tile's causal frontier (from the q tile's END, as
// attention.py:159) and below the fill length are read; cp.async fills the
// rest of a ragged tile with zeros. A warp whose 16 rows see no key of a
// tile skips its products (that leaves m, l and O as a tile of p = 0
// would). Rows are written by their one owner: two runs on the same
// inputs are bitwise equal.
#include <limits.h>

#include <type_traits>

#include "attention_cluster.cuh"
#include "tf32_mma.cuh"

static int g_attn_route = 0;
void set_attn_route(int kind, int dtype, int tier) {
  g_attn_route = kind << 16 | dtype << 12 | tier;
}

namespace {

// B8, B9 and the B12 prefill: 64 rows (8 warps) a block against 32-key
// tiles (B9 at 32 rows, twice the blocks, ran slower at S = 128 and 512
// on an H100: chip_compare.py --part fwd32); 32 rows at DP = 256
constexpr int FWD_BK = 32;
template <int DP>
__host__ __device__ constexpr int fwd_bq() {
  return DP > 128 ? 32 : 64;
}

// Query row r of a tile sits at absolute position pos_off + (row0 + r) %
// period: B8 and B9 pass period = INT_MAX (position = row), B12 the number
// of new tokens (row g * S_new + i of a KV head's group is token i).
struct QRows {
  int row0, nq, period, pos_off;
  __device__ __forceinline__ int pos(int r) const {
    return pos_off + (row0 + r) % period;
  }
};

// An operand plane of R rows of W words in shared memory, rows padded to
// a pitch of W + 4 words: the 8 rows an ldmatrix reads at one column sit
// 16 bytes apart modulo 128, on 32 distinct banks, and every fragment's
// address is its row's plus a constant.
template <int W>
struct Plane {
  static constexpr int P = W + 4;
  __device__ __forceinline__ static int at(int r, int c) { return r * P + c; }
};

template <int DP, int BQ, int BK>
struct FwdSmem {
  static constexpr bool STAGED = DP <= 128;  // cp.async staging buffers
  static constexpr int PAIRS = BQ / 16;  // warp pairs: 16 rows each
  static constexpr int NTH = 64 * PAIRS;
  static constexpr int SP = DP + 4;       // staging pitch, words
  static constexpr int Q = BQ * Plane<DP>::P;   // words of a Q plane
  static constexpr int K = BK * Plane<DP>::P;   // of a K plane (rows: keys)
  static constexpr int V = DP * Plane<BK>::P;   // of a V^T plane (rows: d)
  static constexpr int STAGE = BK * SP;  // one staged K or V tile
  static constexpr int STAGES = STAGED ? 4 : 0;  // K, V of two tiles
  // what a warp hands its partner each tile: 16 row maxima, 16 row sums
  // and, a lane, the hi and lo words of its half of P's A fragments
  static constexpr int XW = BK / 2;            // words a lane
  static constexpr int XHALF = 32 + 32 * XW;   // words a warp
  static constexpr int BYTES =
      (2 * Q + 2 * K + 2 * V + STAGES * STAGE + 2 * PAIRS * XHALF) * 4;
  static_assert(BQ % 16 == 0 && BK % 32 == 0 && BK <= 64 && DP % 16 == 0,
                "whole m16n8k8 tiles for each warp of a pair");
  static_assert(BYTES <= MAX_SMEM, "a block's shared memory");
};

// the four words of f split into hi (returned) and lo (split_tf32)
__device__ __forceinline__ uint4 split4(const float4& f, uint4& lo) {
  uint4 hi;
  split_tf32(f.x, hi.x, lo.x);
  split_tf32(f.y, hi.y, lo.y);
  split_tf32(f.z, hi.z, lo.z);
  split_tf32(f.w, hi.w, lo.w);
  return hi;
}

// BK key rows of D floats (row r at src + r * stride) into the staging
// tile (DP columns) by 16-byte cp.async; rows at or past n and columns at
// or past D are zeros, nothing past them is read
template <int DP, int BK, int NTH>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long stride, int n, int D) {
  constexpr int CPR = DP / 4, N = BK * CPR;
#pragma unroll
  for (int p = 0; p < (N + NTH - 1) / NTH; ++p) {
    const int i = threadIdx.x + p * NTH;
    if (N % NTH != 0 && i >= N) break;
    const int r = i / CPR, c = (i % CPR) * 4;
    const bool ok = r < n && c < D;
    cp_async16(dst + r * (DP + 4) + c, src + (ok ? r * stride + c : 0), ok);
  }
}

// 16 bytes of row r, column c of a K or V tile: from the staging tile
// (pitch DP + 4, every row and column there) or, at stride `pitch`, from
// global memory (zeros at rows >= n or columns >= D)
template <bool STAGED>
__device__ __forceinline__ float4 tile4(const float* src, long long pitch,
                                        int r, int c, int n, int D) {
  if (STAGED || (r < n && c < D))
    return *reinterpret_cast<const float4*>(src + r * pitch + c);
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
template <bool STAGED>
__device__ __forceinline__ float tile1(const float* src, long long pitch,
                                       int r, int c, int n, int D) {
  return STAGED || (r < n && c < D) ? src[r * pitch + c] : 0.0f;
}

// the K tile into its hi and lo planes, a 16-byte chunk a thread
template <int DP, int BK, int NTH, bool STAGED>
__device__ __forceinline__ void split_k(const float* src, long long pitch,
                                        int n, int D, float* kh, float* kl) {
  constexpr int CPR = DP / 4, N = BK * CPR;
#pragma unroll
  for (int p = 0; p < (N + NTH - 1) / NTH; ++p) {
    const int i = threadIdx.x + p * NTH;
    if (N % NTH != 0 && i >= N) break;
    const int r = i / CPR, c = (i % CPR) * 4;
    uint4 lo;
    const uint4 hi = split4(tile4<STAGED>(src, pitch, r, c, n, D), lo);
    const int at = Plane<DP>::at(r, c);
    *reinterpret_cast<uint4*>(kh + at) = hi;
    *reinterpret_cast<uint4*>(kl + at) = lo;
  }
}

// the V tile (as split_k reads it) into its transposed hi and lo planes. Within each
// group of 8 keys the even keys come first (key 8j + 2t at word 8j + t,
// 8j + 2t + 1 at 8j + t + 4), so plane words w..w + 3 of row d (w a
// multiple of 4) hold column d of keys k0, k0 + 2, k0 + 4, k0 + 6 (k0 =
// 8 * (w / 8) + (w / 4) % 2): a thread gathers the four and stores each
// plane's 16 bytes at once; columns run fastest across the threads
template <int DP, int BK, int NTH, bool STAGED>
__device__ __forceinline__ void split_v(const float* src, long long pitch,
                                        int n, int D, float* vh, float* vl) {
  constexpr int N = DP * BK / 4;
#pragma unroll
  for (int p = 0; p < (N + NTH - 1) / NTH; ++p) {
    const int i = threadIdx.x + p * NTH;
    if (N % NTH != 0 && i >= N) break;
    const int d = i % DP, w = (i / DP) * 4;
    const int r = (w & ~7) + ((w >> 2) & 1);
    uint4 lo;
    const uint4 hi = split4(
        make_float4(tile1<STAGED>(src, pitch, r, d, n, D),
                    tile1<STAGED>(src, pitch, r + 2, d, n, D),
                    tile1<STAGED>(src, pitch, r + 4, d, n, D),
                    tile1<STAGED>(src, pitch, r + 6, d, n, D)),
        lo);
    const int at = Plane<BK>::at(d, w);
    *reinterpret_cast<uint4*>(vh + at) = hi;
    *reinterpret_cast<uint4*>(vl + at) = lo;
  }
}

// ldmatrix .x4 of 32-bit words (as ldsm_x4) from a shared-space address
__device__ __forceinline__ void ldsm_x4_at(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// x, opaque to the compiler: the fragment addresses a key tile derives
// from it are formed where they are used, not hoisted out of the key loop
// into a register each (B8 at S = 2048 ran 4.3839-4.3845 ms with it,
// 4.3939-4.4293 without, in turns on an H100: chip_compare.py)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// x (16 x 8NJ) = Q K^T for the warp's 16 rows against 8NJ keys, fresh
// accumulators; x[j] holds keys 8j..8j+7. Operands by ldmatrix: A's tile
// m is rows 8*(m&1).., words 4*(m>>1).. of the warp's Q rows; a pair of
// B's n-tiles is keys 8*(m>>1).., words 4*(m&1)... qa, ka: the
// shared-space byte addresses of the lane's row and word in the hi planes
// (column 0, the warp's first key); each lo plane lies QLO, KLO bytes
// after its hi plane.
template <int DP, int NJ, int QLO, int KLO>
__device__ __forceinline__ void scores(uint32_t qa, uint32_t ka,
                                       float (&x)[NJ][4]) {
  constexpr int RB = (DP + 4) * 4;  // bytes a plane row
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.0f;
  // at DP = 256, 8 column steps at a time: a whole unrolled sweep keeps
  // too many fragments in flight beside the warp's 64 O accumulators
#pragma unroll(DP > 128 ? 8 : DP / 8)
  for (int c = 0; c < DP / 8; ++c) {
    FragA a;
    ldsm_x4_at(a.hi, qa + 32 * c);
    ldsm_x4_at(a.lo, qa + QLO + 32 * c);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t h[4], l[4];
      ldsm_x4_at(h, ka + 8 * j * RB + 32 * c);
      ldsm_x4_at(l, ka + KLO + 8 * j * RB + 32 * c);
      mma_3xtf32(x[j], a, FragB{{h[0], h[1]}, {l[0], l[1]}});
      mma_3xtf32(x[j + 1], a, FragB{{h[2], h[3]}, {l[2], l[3]}});
    }
  }
}

// o = o * alpha + P V for the warp's 16 rows and 8NC output columns: P
// (16 x BK) the A operand (key 8j + 2t as k = t, 8j + 2t + 1 as k = t +
// 4), V^T's rows the output columns (tile m: rows r.., words 4m..; va the
// lane's address in the hi plane at the warp's first column, the lo plane
// VLO bytes after). Each 8-column block of P V sums the tile's keys in a
// fresh accumulator; alpha0 scales rows g, alpha1 rows g + 8.
template <int NC, int BK, int VLO>
__device__ __forceinline__ void pv_update(const FragA (&pa)[BK / 8],
                                          uint32_t va, float alpha0,
                                          float alpha1, float (&o)[NC][4]) {
  constexpr int RB = (BK + 4) * 4;  // bytes a V^T plane row
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BK / 8; j += 2) {
      uint32_t h[4], l[4];
      ldsm_x4_at(h, va + 8 * c * RB + 32 * j);
      ldsm_x4_at(l, va + VLO + 8 * c * RB + 32 * j);
      mma_3xtf32(part, pa[j], FragB{{h[0], h[1]}, {l[0], l[1]}});
      mma_3xtf32(part, pa[j + 1], FragB{{h[2], h[3]}, {l[2], l[3]}});
    }
    o[c][0] = __fadd_rn(__fmul_rn(o[c][0], alpha0), part[0]);
    o[c][1] = __fadd_rn(__fmul_rn(o[c][1], alpha0), part[1]);
    o[c][2] = __fadd_rn(__fmul_rn(o[c][2], alpha1), part[2]);
    o[c][3] = __fadd_rn(__fmul_rn(o[c][3], alpha1), part[3]);
  }
}

// The same from P's fragments in shared memory, for DP > 128, where O's
// 64 accumulators a warp beside P's 32 words spilled: key group j of P
// (the A fragment of keys 8j..8j+7) is read from the pair's exchange
// buffer (xw, the warp's own half, for j in [NH*half, NH*(half+1)), else
// xp, the partner's; each 32 words of hi, then of lo, a lane) when it is
// used, CC output blocks at a time. Each block's products run in the
// same order as pv_update's, so the result is the same.
template <int NC, int BK, int VLO, int CC>
__device__ __forceinline__ void pv_update_smem(const float* xw,
                                               const float* xp, int half,
                                               uint32_t va, float alpha0,
                                               float alpha1,
                                               float (&o)[NC][4]) {
  constexpr int RB = (BK + 4) * 4;  // bytes a V^T plane row
  constexpr int NH = BK / 16;       // key groups of a half
  const int lane = threadIdx.x & 31;
  auto frag = [&](int j, FragA& a) {
    const float* buf = (j / NH == half ? xw : xp) + 32;
    const uint4* src = reinterpret_cast<const uint4*>(buf) +
                       2 * (j % NH) * 32 + lane;
    const uint4 hi = src[0], lo = src[32];
    a.hi[0] = hi.x, a.hi[1] = hi.y, a.hi[2] = hi.z, a.hi[3] = hi.w;
    a.lo[0] = lo.x, a.lo[1] = lo.y, a.lo[2] = lo.z, a.lo[3] = lo.w;
  };
#pragma unroll
  for (int c0 = 0; c0 < NC; c0 += CC) {
    float part[CC][4];
#pragma unroll
    for (int cc = 0; cc < CC; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[cc][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; j += 2) {
      FragA a0, a1;
      frag(j, a0);
      frag(j + 1, a1);
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        uint32_t h[4], l[4];
        ldsm_x4_at(h, va + 8 * (c0 + cc) * RB + 32 * j);
        ldsm_x4_at(l, va + VLO + 8 * (c0 + cc) * RB + 32 * j);
        mma_3xtf32(part[cc], a0, FragB{{h[0], h[1]}, {l[0], l[1]}});
        mma_3xtf32(part[cc], a1, FragB{{h[2], h[3]}, {l[2], l[3]}});
      }
    }
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      float (&oc)[4] = o[c0 + cc];
      oc[0] = __fadd_rn(__fmul_rn(oc[0], alpha0), part[cc][0]);
      oc[1] = __fadd_rn(__fmul_rn(oc[1], alpha0), part[cc][1]);
      oc[2] = __fadd_rn(__fmul_rn(oc[2], alpha1), part[cc][2]);
      oc[3] = __fadd_rn(__fmul_rn(oc[3], alpha1), part[cc][3]);
    }
  }
}

// the named barrier of the two warps that share 16 rows
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1) : "memory");
}

// The online-softmax tile shared by B8, B9 and B12: BQ query rows (the
// first nq valid, contiguous with pitch D) against keys [0, kv_end) of one
// KV head (key c at k + c * kstride), D <= DP columns. Writes O (pitch D)
// and, if lse is given, the LSE of each valid row. Two warps share 16 rows: warp `half`
// forms the scores of the tile's keys [BK/2 * half, BK/2 * (half + 1)),
// they trade row maxima, row sums and their halves of P through shared
// memory, and each adds P V into its half of the output columns.
template <int DP, int BQ, int BK>
__device__ __forceinline__ void flash_tile(const float* q, const float* k,
                                           const float* v, long long kstride,
                                           int kv_end, bool causal,
                                           QRows rows, float scale,
                                           float* o, float* lse, int D,
                                           float* smem) {
  using L = FwdSmem<DP, BQ, BK>;
  constexpr int NTH = L::NTH, NC = DP / 16, NJ = BK / 8, NH = NJ / 2;
  constexpr bool STAGED = L::STAGED;
  float* qh = smem;
  float* ql = qh + L::Q;
  float* kh = ql + L::Q;
  float* kl = kh + L::K;
  float* vh = kl + L::K;
  float* vl = vh + L::V;
  float* stage = vl + L::V;  // stage s: K at stage + 2s * STAGE, V after
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // partners are neighbours, so they sit on two of the SM's four
  // schedulers and a pair waiting on itself leaves each with other work
  const int pair = tid >> 6, half = (tid >> 5) & 1;
  const int qw = 16 * pair;  // the pair's first row in the tile
  float* mine = stage + L::STAGES * L::STAGE + (2 * pair + half) * L::XHALF;
  const float* theirs =
      stage + L::STAGES * L::STAGE + (2 * pair + 1 - half) * L::XHALF;
  const int n_it = (kv_end + BK - 1) / BK;
  // the lane's ldmatrix addresses in the hi planes: Q at the pair's rows,
  // K at the warp's half of a tile's keys, V^T at its half of the columns
  const int m = lane >> 3, r = lane & 7;
  const uint32_t qa = smem_addr(qh + Plane<DP>::at(qw + r + 8 * (m & 1),
                                                   4 * (m >> 1)));
  const uint32_t ka = smem_addr(kh + Plane<DP>::at(
      BK / 2 * half + r + 8 * (m >> 1), 4 * (m & 1)));
  const uint32_t va =
      smem_addr(vh + Plane<BK>::at(DP / 2 * half + r, 4 * m));

  // tile i's K and V into stage i % 2, one commit group a tile
  auto stage_tile = [&](int i) {
    if constexpr (STAGED) {
      if (i < n_it) {
        const long long off = static_cast<long long>(i) * BK * kstride;
        const int n = min(BK, kv_end - i * BK);
        float* dst = stage + 2 * (i & 1) * L::STAGE;
        stage_rows<DP, BK, NTH>(dst, k + off, kstride, n, D);
        stage_rows<DP, BK, NTH>(dst + L::STAGE, v + off, kstride, n, D);
      }
      cp_async_commit();
    }
  };
  stage_tile(0);
  stage_tile(1);
  // Q into its planes while the first tiles fly; rows past nq and columns
  // past D are zeros
  for (int i = tid; i < BQ * DP / 4; i += NTH) {
    const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
    const float4 f = r < rows.nq && c < D
                         ? *reinterpret_cast<const float4*>(q + r * D + c)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    uint4 lo;
    const uint4 hi = split4(f, lo);
    const int at = Plane<DP>::at(r, c);
    *reinterpret_cast<uint4*>(qh + at) = hi;
    *reinterpret_cast<uint4*>(ql + at) = lo;
  }
  // the positions of the thread's two rows, and the pair's first and last
  // positions among its valid rows (last -1 if it has none)
  const int pos0 = rows.pos(qw + g), pos1 = rows.pos(qw + g + 8);
  const bool valid = qw + (lane & 15) < rows.nq;
  const int mine_pos = rows.pos(qw + (lane & 15));
  int first = valid ? mine_pos : INT_MAX, last = valid ? mine_pos : -1;
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
    last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
  }

  float acc[NC][4];  // rows qw+g, qw+g+8; columns DP/2*half + 8c+2t, +1
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
  float mrow[2] = {NEG, NEG}, lrow[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_it; ++it) {
    const int kt = it * BK, k0 = kt + BK / 2 * half;  // the warp's keys
    if constexpr (STAGED) {
      cp_async_wait<1>();  // this tile landed; the next one may still fly
      __syncthreads();     // ... for every thread; the planes are free
      const float* cur = stage + 2 * (it & 1) * L::STAGE;
      split_k<DP, BK, NTH, true>(cur, DP + 4, BK, DP, kh, kl);
      split_v<DP, BK, NTH, true>(cur + L::STAGE, DP + 4, BK, DP, vh, vl);
    } else {
      __syncthreads();  // the planes are free
      const long long off = static_cast<long long>(kt) * kstride;
      const int n = min(BK, kv_end - kt);
      split_k<DP, BK, NTH, false>(k + off, kstride, n, D, kh, kl);
      split_v<DP, BK, NTH, false>(v + off, kstride, n, D, vh, vl);
    }
    __syncthreads();
    stage_tile(it + 2);
    // pair-uniform: do the pair's rows see a key of this tile?
    const bool live = last >= 0 && (!causal || kt <= last);
    FragA pa[NJ];
    float alpha[2] = {1.0f, 1.0f};
    if (live) {
      float x[NH][4];
      scores<DP, NH, 4 * L::Q, 4 * L::K>(opaque(qa), opaque(ka), x);
      float mx[2] = {NEG, NEG};
      uint32_t seen = ~0u;  // bit 4j + e: entry (j, e) visible
      // warp-uniform: every row sees every key of the warp's half
      if (k0 + BK / 2 <= kv_end && (!causal || k0 + BK / 2 - 1 <= first)) {
#pragma unroll
        for (int j = 0; j < NH; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[j][e] = __fmul_rn(x[j][e], scale);
            mx[e >> 1] = fmaxf(mx[e >> 1], x[j][e]);
          }
      } else {
        seen = 0;
#pragma unroll
        for (int j = 0; j < NH; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const bool ok = key < kv_end &&
                            (!causal || key <= (e < 2 ? pos0 : pos1));
            x[j][e] = ok ? __fmul_rn(x[j][e], scale) : NEG;
            seen |= static_cast<uint32_t>(ok) << (4 * j + e);
            mx[e >> 1] = fmaxf(mx[e >> 1], x[j][e]);
          }
      }
      // the row's 4 threads (one quad) hold the warp's scores of it; the
      // partner holds the rest
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
      if (t == 0) {
        mine[g] = mx[0];
        mine[g + 8] = mx[1];
      }
      pair_sync(pair);
      float mnew[2], sum[2] = {0.0f, 0.0f};
      mnew[0] = fmaxf(mrow[0], fmaxf(mx[0], theirs[g]));
      mnew[1] = fmaxf(mrow[1], fmaxf(mx[1], theirs[g + 8]));
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[j][e] = (seen >> (4 * j + e)) & 1u
                        ? expf(__fsub_rn(x[j][e], mnew[e >> 1]))
                        : 0.0f;
          sum[e >> 1] = __fadd_rn(sum[e >> 1], x[j][e]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 1));
        sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 2));
      }
      // the warp's half of P as A fragments, handed to the partner: the
      // partner's lanes hold the same rows and key positions
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        FragA& a = pa[NH * half + j];
        a.set(0, x[j][0]);
        a.set(1, x[j][2]);
        a.set(2, x[j][1]);
        a.set(3, x[j][3]);
        uint4* dst = reinterpret_cast<uint4*>(mine + 32) + 2 * j * 32 + lane;
        dst[0] = make_uint4(a.hi[0], a.hi[1], a.hi[2], a.hi[3]);
        dst[32] = make_uint4(a.lo[0], a.lo[1], a.lo[2], a.lo[3]);
      }
      if (t == 0) {
        mine[16 + g] = sum[0];
        mine[24 + g] = sum[1];
      }
      pair_sync(pair);
#pragma unroll
      for (int j = 0; j < (STAGED ? NH : 0); ++j) {  // else read at P V
        FragA& a = pa[NH * (1 - half) + j];
        const uint4* src =
            reinterpret_cast<const uint4*>(theirs + 32) + 2 * j * 32 + lane;
        const uint4 hi = src[0], lo = src[32];
        a.hi[0] = hi.x, a.hi[1] = hi.y, a.hi[2] = hi.z, a.hi[3] = hi.w;
        a.lo[0] = lo.x, a.lo[1] = lo.y, a.lo[2] = lo.z, a.lo[3] = lo.w;
      }
      // the tile's row sums: the two halves in the same order in both warps
      const float s0 = half == 0 ? __fadd_rn(sum[0], theirs[16 + g])
                                 : __fadd_rn(theirs[16 + g], sum[0]);
      const float s1 = half == 0 ? __fadd_rn(sum[1], theirs[24 + g])
                                 : __fadd_rn(theirs[24 + g], sum[1]);
      alpha[0] = expf(__fsub_rn(mrow[0], mnew[0]));
      alpha[1] = expf(__fsub_rn(mrow[1], mnew[1]));
      lrow[0] = __fadd_rn(__fmul_rn(lrow[0], alpha[0]), s0);
      lrow[1] = __fadd_rn(__fmul_rn(lrow[1], alpha[1]), s1);
      mrow[0] = mnew[0];
      mrow[1] = mnew[1];
    }
    if (live) {
      if constexpr (STAGED)
        pv_update<NC, BK, 4 * L::V>(pa, opaque(va), alpha[0], alpha[1],
                                    acc);
      else
        pv_update_smem<NC, BK, 4 * L::V, 2>(mine, theirs, half, opaque(va),
                                            alpha[0], alpha[1], acc);
    }
  }
  if constexpr (STAGED) cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qw + g + 8 * h;
    if (r >= rows.nq) continue;
    const float l = fmaxf(lrow[h], 1e-30f);
    const int c0 = DP / 2 * half;
    float* out = o + static_cast<long long>(r) * D + c0 + 2 * t;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c0 + 8 * c < D)
        *reinterpret_cast<float2*>(out + 8 * c) =
            make_float2(__fdiv_rn(acc[c][2 * h], l),
                        __fdiv_rn(acc[c][2 * h + 1], l));
    if (lse != nullptr && half == 0 && t == 0)
      lse[r] = __fadd_rn(mrow[h], logf(l));
  }
}

// B8 and B9: grid (B*H, q tiles), the last q tile (the heaviest under the
// causal mask) first. q (B*H, Sq, D); k/v (B*Hkv, Skv, D); the q head bh
// reads KV row (bh / H) * Hkv + (bh % H) / group (_kv_head_row).
template <int DP, int BQ, int BK>
__device__ __forceinline__ void fwd_block(const float* q, const float* k,
                                          const float* v, float* o,
                                          float* lse, int H, int Hkv, int Sq,
                                          int Skv, int causal, int D,
                                          float scale, float* smem) {
  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const long long kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int nq = min(BQ, Sq - row0);
  // causal frontier from the q tile's end: keys past its last row unseen
  const int kv_end = causal ? min(Skv, row0 + nq) : Skv;
  const long long qoff = (static_cast<long long>(bh) * Sq + row0) * D;
  flash_tile<DP, BQ, BK>(q + qoff, k + kvrow * Skv * D,
                         v + kvrow * Skv * D, D, kv_end, causal != 0,
                         QRows{row0, nq, INT_MAX, 0}, scale, o + qoff,
                         lse + static_cast<long long>(bh) * Sq + row0, D,
                         smem);
}

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(FwdSmem<DP, BQ, BK>::NTH, 1)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ lse, int H, int Hkv, int Sq, int Skv,
                int causal, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  fwd_block<DP, BQ, BK>(q, k, v, o, lse, H, Hkv, Sq, Skv, causal, D, scale,
                        smem);
}

// B9: B8's tile over the one key block, at B9's own tile height
template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(FwdSmem<DP, BQ, BK>::NTH, 1)
attn_fwd_single_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int H, int Hkv, int Sq,
                       int Skv, int causal, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  fwd_block<DP, BQ, BK>(q, k, v, o, lse, H, Hkv, Sq, Skv, causal, D, scale,
                        smem);
}

// B12: grid (row tiles, Hkv, B). q (B, Hkv, rows, D) with rows = group *
// S_new (the q heads of one KV head, token-minor); the cache (B, T, Hkv,
// D) as it is: key c of head h at ((b * T + c) * Hkv + h) * D.
template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(FwdSmem<DP, BQ, BK>::NTH, 1)
attn_decode_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                   const float* __restrict__ vc, float* __restrict__ o,
                   int Hkv, int Tlen, int nrows, int s_new, int kv_len,
                   int D, float scale) {
  extern __shared__ __align__(16) float smem[];
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
  flash_tile<DP, BQ, BK>(q + qoff, kc + koff, vc + koff,
                         static_cast<long long>(Hkv) * D, kv_end, true, rows,
                         scale, o + qoff, nullptr, D, smem);
}

// ---- head dims past 256 up to 4096: the cluster form ------------------------
//
// f32 B8, B9 and the B12 chunks (S_new > 1) at cluster_form(D), one launch a
// call, with S formed once for each (q tile, key tile) pair, not once a
// column group. The head dim is cut into 64-column slices and a cluster of
// C = cluster_size(D) blocks (attention_cluster.cuh: NS = 2 slices a block
// to D 1024, 4 to 2048, 8 to 4096; C <= 8) owns one tile of RK = 128 / NS
// query rows: block c holds slices NS*c .. NS*c + NS - 1 of the tile's Q,
// loaded once and resident, and of its O accumulator. Its 8 warps are RK /
// 16 groups of 16 rows by NS slices. For every 32-key tile:
//   1. each warp forms its slice's partial S (16 x 32, 3xTF32, a fresh
//      accumulator); the group's warps store theirs into shared memory and
//      meet at their named barrier, and the first min(NS, 4) of them sum
//      the four quarters of the group's positions over the live slices in
//      slice order and store each into its owner's receive buffer at the
//      block's slot (fwd_push); cluster barrier;
//   2. the owner of each position sums the C partials in block order with
//      f32 adds and stores the sum into every block's result buffer;
//      cluster barrier;
//   3. each warp reads its group's S from its own result buffer and runs
//      flash_tile's online softmax on it (scale, mask, row max, exp, row
//      sum, rescale): every warp of a group, in every block, holds the same
//      S, so m, l and P are bitwise the same everywhere; then O = O * alpha
//      + P V on its slice (rows_accumulate: the tile's keys in a fresh
//      accumulator).
// The tile's chain of products, barriers and exponents leaves an SM idle
// while one block waits, so at NS 2 two blocks share an SM (103 KB of
// shared memory and at most 128 registers a thread each), each hiding the
// other's waits. K's and V's slices stream through NSL cp.async slots
// of one operand tile each: four at NS 4 (two stages: the next tile's K
// and V load under this tile's products and exchange); two at NS 2 and 8
// (the next K loads from step 2 on, once every warp of the block has
// formed its S; the next V from the next tile's start, under its S).
// Whether a group's rows see a key of a tile depends on the rows alone,
// the same in every block of a cluster: such a group skips the tile, its
// positions are neither summed nor read, and every thread arrives at every
// barrier. A first cluster barrier makes sure every block runs before a
// peer stores to it; after a tile's second barrier no block touches a
// peer's shared memory, so a block may exit after its last tile. Columns
// past D load as zeros; a slice wholly past D forms no partial, and its
// warp only sums. Block 0's slice-0 warps write the LSE. Shared memory
// 103, 197 and 192 KB at NS 2, 4 and 8. No atomics: one writer for each
// element, so two runs on the same inputs are bitwise equal.
constexpr int CBK = 32;  // the cluster form's key tile

template <int NS>
struct FwdX {
  static constexpr int SLICES = NS;
  static constexpr int RK = 128 / NS;      // the query rows of a tile
  static constexpr int GROUPS = RK / 16;   // groups of 16 rows
  static constexpr int NQ = GROUPS * 4;    // quarters of S (128 floats)
  static constexpr int NSL = NS == 4 ? 4 : 2;  // slots of a K or V tile
  static constexpr int SUMW = NS < 4 ? 4 / NS : 1;  // quarters a summer
  static constexpr int BLOCKS = NS == 2 ? 2 : 1;   // blocks an SM
  static constexpr int RES = RK * SLP;     // floats of a slice of Q's rows
  static constexpr int XT = CBK * SLP;     // of a slice of a K or V tile
  static constexpr int RCV = most_slots(NQ, cluster_cmin(NS)) * 128;
  static constexpr int RSL = NQ * 128;     // the summed S
  static constexpr int SUM = GROUPS * NS * 4 * 128;  // the slices' partials
  static constexpr int BYTES =
      (NS * RES + NSL * NS * XT + RCV + RSL + SUM + GROUPS) * 4;
  static_assert(BLOCKS * (BYTES + 1024) <= MAX_SMEM + 1024,
                "the blocks' shared memory on one SM");
  static_assert(GROUPS * NS * 32 == NT, "a warp for each (group, slice)");
};

// step 1: the block's partial S over its nl live slices for rows group
// grp. The warp of slice h < nl stores x's four float4 units (x[u], one a
// lane) into the group's share of sum; the group meets at its named
// barrier; warp h < 4 / SUMW then adds units h*SUMW .. h*SUMW + SUMW - 1
// over the live slices in slice order and stores each sum (quarter qi =
// grp * 4 + u) into its owner's receive buffer rcv at slot `rank`.
template <int NS>
__device__ __forceinline__ void fwd_push(
    cooperative_groups::cluster_group& cluster, float* rcv, float* sum,
    int grp, int h, int nl, int rank, int C, const float (&x)[4][4]) {
  constexpr int U = FwdX<NS>::SUMW;
  const int l = threadIdx.x & 31;
  // unit u of slice s at float4 (s * 4 + u) * 32 + lane of the group's share
  float4* buf = reinterpret_cast<float4*>(sum) + grp * NS * 4 * 32 + l;
  if (h < nl) {
#pragma unroll
    for (int u = 0; u < 4; ++u) buf[(h * 4 + u) * 32] = f4(x[u]);
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(32 * NS) : "memory");
  if (h * U >= 4) return;
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int u = h * U + i, qi = grp * 4 + u;
    float4 acc = buf[u * 32];
    for (int s = 1; s < nl; ++s) acc = f4_add(acc, buf[(s * 4 + u) * 32]);
    float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(
                      rcv, qi % C)) +
                  ((qi / C) * C + rank) * 32 + l;
    *dst = acc;
  }
}

// The cluster form's tile: the RK query rows of `rows` (the first nq
// valid, contiguous with pitch D) against keys [0, kv_end) of one KV head
// (key c at k + c * kstride); this block's slices of O (pitch D) and, if
// lse is given, the LSE of each valid row. LEAN (the B12 chunk kernel):
// the key stride an int, the copies one slice a loop step and the S
// product's column steps two at a time; at the 128 registers of two
// blocks an SM, ptxas spilled that kernel without them and B8's with them
template <int NS, bool LEAN>
__device__ __forceinline__ void cluster_tile(
    cooperative_groups::cluster_group& cluster, const float* q,
    const float* k, const float* v, long long kstride_, int kv_end,
    bool causal, QRows rows, float scale, float* o, float* lse, int D,
    float* smem) {
  using X = FwdX<NS>;
  using Stride = typename std::conditional<LEAN, int, long long>::type;
  const Stride kstride = static_cast<Stride>(kstride_);
  float* sQ = smem;                       // slice hh at sQ + hh*RES
  float* sKV = sQ + NS * X::RES;          // slot s at sKV + s*NS*XT, its
                                          // slice hh at + hh*XT
  float* rS = sKV + X::NSL * NS * X::XT;  // the receive buffer
  float* xS = rS + X::RCV;                // the result buffer: summed S
  float* sSum = xS + X::RSL;              // the slices' partials
  int* sLast = reinterpret_cast<int*>(sSum + X::SUM);  // a group's last
                                                       // position
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = tid >> 5, grp = warp / NS, h = warp % NS, qw = 16 * grp;
  const int C = gridDim.z, rank = cluster.block_rank();
  const int col0 = NS * rank * SL, c0 = col0 + h * SL;  // the block's and
                                                        // the warp's columns
  const int nl = min(NS, (D - col0 + SL - 1) / SL);  // the live slices
  const int n_it = (kv_end + CBK - 1) / CBK;
  const int pos0 = rows.pos(qw + g), pos1 = rows.pos(qw + g + 8);

  // operand n (key tile n / 2's K if n is even, else its V) into slot n %
  // NSL, the block's NS slices of it
  auto load_op = [&](int n) {
    const int kt0 = (n >> 1) * CBK, cnt = min(CBK, kv_end - kt0);
    const float* src =
        (n & 1 ? v : k) + static_cast<long long>(kt0) * kstride;
    float* dst = sKV + (n % X::NSL) * NS * X::XT;
#pragma unroll(LEAN ? 1 : NS)
    for (int hh = 0; hh < NS; ++hh) {
      const int col = col0 + hh * SL;
      cp_rows<SL, CBK, SLP, NT>(dst + hh * X::XT, src + col, cnt, D - col,
                                kstride);
    }
  };
#pragma unroll
  for (int hh = 0; hh < NS; ++hh) {
    const int col = col0 + hh * SL;
    cp_rows<SL, X::RK, SLP, NT>(sQ + hh * X::RES, q + col, rows.nq, D - col,
                                D);
  }
  if (n_it > 0) {  // the first K (NSL 4: and V)
    load_op(0);
    if constexpr (X::NSL == 4) load_op(1);
  }
  cp_async_commit();
  if (h == 0) {  // the group's last position among its valid rows, or -1
    int last = qw + (lane & 15) < rows.nq ? rows.pos(qw + (lane & 15)) : -1;
#pragma unroll
    for (int off = 16; off; off >>= 1)
      last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
    if (lane == 0) sLast[grp] = last;
  }

  float acc[SL / 8][4];  // rows qw+g, qw+g+8; columns c0 + 8c+2t, +1
#pragma unroll
  for (int c = 0; c < SL / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
  float mrow[2] = {NEG, NEG}, lrow[2] = {0.0f, 0.0f};

  cluster.sync();  // every block of the cluster runs: its peers may store
  for (int it = 0; it < n_it; ++it) {
    const int kt = it * CBK;
    const bool more = it + 1 < n_it;
    cp_async_wait<0>();  // this tile's K (NSL 4: and V) landed
    __syncthreads();     // ... for every thread; the last tile's are read
    if constexpr (X::NSL == 4) {  // the next tile's K and V
      if (more) {
        load_op(2 * it + 2);
        load_op(2 * it + 3);
      }
    } else {  // this tile's V
      load_op(2 * it + 1);
    }
    cp_async_commit();
    const float* cK = sKV + (2 * it % X::NSL) * NS * X::XT + h * X::XT;
    const float* cV = sKV + ((2 * it + 1) % X::NSL) * NS * X::XT + h * X::XT;
    // cluster-uniform: do the rows of group gr see a key of this tile?
    auto live = [&](int gr) {
      const int last = sLast[gr];
      return last >= 0 && (!causal || kt <= last);
    };
    const bool mine = live(grp) && c0 < D;
    if (live(grp)) {  // step 1: the partial S over the warp's slice
      float x[4][4];
      if (mine) {
        rows16_x_rows32<SL, LEAN ? 2 : SL / 8>(sQ + h * X::RES + qw * SLP,
                                                cK, x);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[j][e] = 0.0f;
      }
      fwd_push<NS>(cluster, rS, sSum, grp, h, nl, rank, C, x);
    }
    cluster.sync();  // every partial of the tile is in place
    if constexpr (X::NSL == 2) {  // K's slot is free: the next K
      if (more) load_op(2 * it + 2);
      cp_async_commit();
    }
    // step 2 on this block's quarters, two elements a thread-step
    for (int u = tid;; u += NT) {
      const int m = u >> 6, qi = rank + C * m;  // the quarter, its position
      if (qi >= X::NQ) break;
      if (!live(qi >> 2)) continue;  // no warp reads it
      const int pl = (u >> 1) & 31, half = u & 1;
      const int roff = (m * C * 32 + pl) * 4 + 2 * half;
      const int off = (qi * 32 + pl) * 4 + 2 * half;
      xch_bcast(cluster, xS, off, C, xch_sum(rS, roff, C));
    }
    cluster.sync();  // every S of the tile is in place
    if constexpr (X::NSL == 2) {
      cp_async_wait<1>();  // this tile's V landed (the next K may fly)
      __syncthreads();
    }
    if (!mine) continue;
    // step 3: flash_tile's online softmax on the summed S, then P V
    float x[4][4];
    xch_read(xS, grp, x);
    float mx[2] = {NEG, NEG};
    uint32_t seen = 0;  // bit 4j + e: entry (j, e) visible
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + 8 * j + 2 * t + (e & 1);
        const bool ok =
            key < kv_end && (!causal || key <= (e < 2 ? pos0 : pos1));
        x[j][e] = ok ? __fmul_rn(x[j][e], scale) : NEG;
        seen |= static_cast<uint32_t>(ok) << (4 * j + e);
        mx[e >> 1] = fmaxf(mx[e >> 1], x[j][e]);
      }
    float sum[2] = {0.0f, 0.0f}, alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(mrow[r], mx[r]);  // the new running max
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[j][e] = (seen >> (4 * j + e)) & 1u
                      ? expf(__fsub_rn(x[j][e], mx[e >> 1]))
                      : 0.0f;
        sum[e >> 1] = __fadd_rn(sum[e >> 1], x[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 1));
      sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 2));
      alpha[r] = expf(__fsub_rn(mrow[r], mx[r]));
      lrow[r] = __fadd_rn(__fmul_rn(lrow[r], alpha[r]), sum[r]);
      mrow[r] = mx[r];
    }
#pragma unroll
    for (int c = 0; c < SL / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[c][e] = __fmul_rn(acc[c][e], alpha[e >> 1]);
    rows_accumulate<SL, SL>(x, cV, acc);  // O += P V
  }
  cp_async_wait<0>();
  if (c0 >= D) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    if (row >= rows.nq) continue;
    const float l = fmaxf(lrow[r], 1e-30f);
    float* out = o + static_cast<long long>(row) * D + c0 + 2 * t;
#pragma unroll
    for (int c = 0; c < SL / 8; ++c)
      if (c0 + 8 * c < D)
        *reinterpret_cast<float2*>(out + 8 * c) =
            make_float2(__fdiv_rn(acc[c][2 * r], l),
                        __fdiv_rn(acc[c][2 * r + 1], l));
    if (lse != nullptr && h == 0 && t == 0)
      lse[row] = __fadd_rn(mrow[r], logf(l));
  }
}

// B8 and B9 at cluster_form(D), NS = cluster_ns(D): grid (B*H, q tiles of
// RK, C), clusters (1, 1, C), the last q tile first; operands as
// attn_fwd_kernel's
template <int NS>
__global__ void __launch_bounds__(NT, FwdX<NS>::BLOCKS)
attn_fwd_cluster_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int H, int Hkv, int Sq,
                        int Skv, int causal, int D, float scale) {
  constexpr int RK = FwdX<NS>::RK;
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * RK;
  const long long kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int nq = min(RK, Sq - row0);
  const int kv_end = causal ? min(Skv, row0 + nq) : Skv;
  const long long qoff = (static_cast<long long>(bh) * Sq + row0) * D;
  cluster_tile<NS, false>(cluster, q + qoff, k + kvrow * Skv * D,
                   v + kvrow * Skv * D, D, kv_end, causal != 0,
                   QRows{row0, nq, INT_MAX, 0}, scale, o + qoff,
                   cluster.block_rank() == 0
                       ? lse + static_cast<long long>(bh) * Sq + row0
                       : nullptr,
                   D, smem);
}

// B12 chunks (S_new > 1) at cluster_form(D): grid (B*Hkv, row tiles of
// RK, C), clusters (1, 1, C), the last row tile first; operands as
// attn_decode_kernel's
template <int NS>
__global__ void __launch_bounds__(NT, FwdX<NS>::BLOCKS)
attn_decode_cluster_kernel(const float* __restrict__ q,
                           const float* __restrict__ kc,
                           const float* __restrict__ vc,
                           float* __restrict__ o, int Hkv, int Tlen,
                           int nrows, int s_new, int kv_len, int D,
                           float scale) {
  constexpr int RK = FwdX<NS>::RK;
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * RK;
  const int nq = min(RK, nrows - row0);
  // last position among this tile's rows: kv_len - 1 once it wraps a group
  const int i0 = row0 % s_new;
  const int kv_end = i0 + nq - 1 >= s_new ? kv_len
                                          : kv_len - s_new + i0 + nq;
  const long long qoff =
      ((static_cast<long long>(b) * Hkv + h) * nrows + row0) * D;
  const long long koff = (static_cast<long long>(b) * Tlen * Hkv + h) * D;
  cluster_tile<NS, true>(cluster, q + qoff, kc + koff, vc + koff,
                   static_cast<long long>(Hkv) * D, kv_end, true,
                   QRows{row0, nq, s_new, kv_len - s_new}, scale, o + qoff,
                   nullptr, D, smem);
}

template <int NS>
cudaError_t launch_fwd_cluster(int kind, const float* q, const float* k,
                               const float* v, float* o, float* lse, int B,
                               int H, int Hkv, int Sq, int Skv, int causal,
                               int D, float scale, cudaStream_t st) {
  return launch_cluster<FwdX<NS>>(attn_fwd_cluster_kernel<NS>, kind, Sq, B,
                                  H, D, st, q, k, v, o, lse, H, Hkv, Sq, Skv,
                                  causal, D, scale);
}

template <int NS>
cudaError_t launch_decode_cluster(const float* q, const float* kc,
                                  const float* vc, float* o, int B, int H,
                                  int Hkv, int Tlen, int s_new, int kv_len,
                                  int D, float scale, cudaStream_t st) {
  const int nrows = (H / Hkv) * s_new;
  return launch_cluster<FwdX<NS>>(attn_decode_cluster_kernel<NS>,
                                  ROUTE_PREFILL_COLS_TF32, nrows, B, Hkv, D,
                                  st, q, kc, vc, o, Hkv, Tlen, nrows, s_new,
                                  kv_len, D, scale);
}

// B8 or B9 (route `kind`) over grid (B*H, q tiles)
template <int DP, typename K>
cudaError_t launch_rows(K kern, int kind, const void* q, const void* k,
                        const void* v, void* o, void* lse, int B, int H,
                        int Hkv, int Sq, int Skv, int causal, int D,
                        float scale, cudaStream_t st) {
  constexpr int BQ = fwd_bq<DP>();
  using L = FwdSmem<DP, BQ, FWD_BK>;
  cudaError_t e = allow_smem(kern, L::BYTES);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, L::NTH, L::BYTES, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Hkv, Sq, Skv, causal, D, scale);
  e = cudaGetLastError();
  if (e == cudaSuccess) set_attn_route(kind, 0, DP);
  return e;
}

template <int DP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Hkv, int Sq, int Skv,
                       int causal, int D, float scale, cudaStream_t st) {
  return launch_rows<DP>(attn_fwd_kernel<DP, fwd_bq<DP>(), FWD_BK>,
                         ROUTE_FWD_TF32, q, k, v, o, lse, B, H, Hkv, Sq, Skv,
                         causal, D, scale, st);
}

template <int DP>
cudaError_t launch_single(const void* q, const void* k, const void* v,
                          void* o, void* lse, int B, int H, int Hkv, int Sq,
                          int Skv, int causal, int D, float scale,
                          cudaStream_t st) {
  return launch_rows<DP>(attn_fwd_single_kernel<DP, fwd_bq<DP>(), FWD_BK>,
                         ROUTE_FWD_SINGLE_TF32, q, k, v, o, lse, B, H, Hkv,
                         Sq, Skv, causal, D, scale, st);
}

template <int DP>
cudaError_t launch_decode(const void* q, const void* kc, const void* vc,
                          void* o, int B, int H, int Hkv, int Tlen, int s_new,
                          int kv_len, int D, float scale, cudaStream_t st) {
  constexpr int BQ = fwd_bq<DP>();
  using L = FwdSmem<DP, BQ, FWD_BK>;
  const int nrows = (H / Hkv) * s_new;
  auto kern = attn_decode_kernel<DP, BQ, FWD_BK>;
  cudaError_t e = allow_smem(kern, L::BYTES);
  if (e != cudaSuccess) return e;
  dim3 grid((nrows + BQ - 1) / BQ, Hkv, B);
  kern<<<grid, L::NTH, L::BYTES, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc),
      static_cast<const float*>(vc), static_cast<float*>(o), Hkv, Tlen, nrows,
      s_new, kv_len, D, scale);
  e = cudaGetLastError();
  if (e == cudaSuccess) set_attn_route(ROUTE_PREFILL_TF32, 0, DP);
  return e;
}

}  // namespace

// the 16-bit tensor-core route (attention_sm90.cu; dtype 1 bf16, 2 f16)
int attn_fwd_wgmma(int dtype, int head_dim, const void* q, const void* k,
                   const void* v, void* o, void* lse, int B, int H, int Hkv,
                   int Sq, int Skv, int causal, float scale, cudaStream_t st);
int attn_prefill_wgmma(int dtype, int head_dim, const void* q,
                       const void* kc, const void* vc, void* o, int B, int H,
                       int Hkv, int Tlen, int s_new, int kv_len, float scale,
                       cudaStream_t st);
int attn_fwd_single_wgmma(int dtype, int head_dim, const void* q,
                          const void* k, const void* v, void* o, void* lse,
                          int B, int H, int Hkv, int Sq, int Skv, int causal,
                          float scale, cudaStream_t st);
// the single-token decode route (attention_decode.cu)
int attn_decode_split(int dtype, int head_dim, const void* q, const void* kc,
                      const void* vc, void* o, void* ws, void* counters,
                      int B, int H, int Hkv, int Tlen, int kv_len,
                      int n_split, float scale, cudaStream_t st);

// the single-token decode past it, f32 (attention_decode.cu)
int attn_decode_band(int dtype, int head_dim, const void* q, const void* kc,
                     const void* vc, void* o, void* ws, void* counters,
                     int B, int H, int Hkv, int Tlen, int kv_len,
                     int n_split, float scale, cudaStream_t st);
// the f32 band form past CLUSTER_MAX_D (attention_band_fwd.cu)
int attn_fwd_band(int kind, const float* q, const float* k, const float* v,
                  float* o, float* lse, float* ws, int B, int H, int Hkv,
                  int Sq, int Skv, int causal, int D, float scale,
                  cudaStream_t st);
int attn_prefill_band(const float* q, const float* kc, const float* vc,
                      float* o, float* ws, int B, int H, int Hkv, int Tlen,
                      int s_new, int kv_len, int D, float scale,
                      cudaStream_t st);

static const float* F(const void* p) { return static_cast<const float*>(p); }
static float* W(void* p) { return static_cast<float*>(p); }

extern "C" {

int accl_attn_last_route() { return g_attn_route; }

// dtype 0 f32, 1 bf16, 2 f16; head_dim a multiple of 8 (f32 past 256: the
// cluster kernels, past 4096 the band form on the workspace ws of B * H *
// fwd_band_words(...) floats, used only there; 16-bit past 256 the
// cluster or column-group kernels of attention_sm90.cu)
int accl_attn_fwd(int dtype, int head_dim, const void* q, const void* k,
                  const void* v, void* o, void* lse, void* ws, int B, int H,
                  int Hkv, int Sq, int Skv, int causal, float scale,
                  void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (head_dim % 8 || head_dim < 8) return cudaErrorInvalidValue;
  if (dtype == 1 || dtype == 2)
    return attn_fwd_wgmma(dtype, head_dim, q, k, v, o, lse, B, H, Hkv, Sq,
                          Skv, causal, scale, st);
  if (dtype != 0) return cudaErrorInvalidValue;
  if (cluster_form(head_dim)) {
    CLUSTER_NS_DISPATCH(launch_fwd_cluster, head_dim, ROUTE_FWD_COLS_TF32,
                        F(q), F(k), F(v), static_cast<float*>(o),
                        static_cast<float*>(lse), B, H, Hkv, Sq, Skv, causal,
                        head_dim, scale, st)
  }
  if (head_dim > CLUSTER_MAX_D)
    return attn_fwd_band(ROUTE_FWD_TF32_BAND, F(q), F(k), F(v), W(o), W(lse),
                         W(ws), B, H, Hkv, Sq, Skv, causal, head_dim, scale,
                         st);
  F32_DISPATCH(launch_fwd, q, k, v, o, lse, B, H, Hkv, Sq, Skv, causal,
               head_dim, scale, st)
}

int accl_attn_fwd_single(int dtype, int head_dim, const void* q,
                         const void* k, const void* v, void* o, void* lse,
                         void* ws, int B, int H, int Hkv, int Sq, int Skv,
                         int causal, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (head_dim % 8 || head_dim < 8) return cudaErrorInvalidValue;
  if (dtype == 1 || dtype == 2)
    return attn_fwd_single_wgmma(dtype, head_dim, q, k, v, o, lse, B, H, Hkv,
                                 Sq, Skv, causal, scale, st);
  if (dtype != 0) return cudaErrorInvalidValue;
  if (cluster_form(head_dim)) {
    CLUSTER_NS_DISPATCH(launch_fwd_cluster, head_dim,
                        ROUTE_FWD_SINGLE_COLS_TF32, F(q), F(k), F(v),
                        static_cast<float*>(o), static_cast<float*>(lse), B,
                        H, Hkv, Sq, Skv, causal, head_dim, scale, st)
  }
  if (head_dim > CLUSTER_MAX_D)
    return attn_fwd_band(ROUTE_FWD_SINGLE_TF32_BAND, F(q), F(k), F(v), W(o),
                         W(lse), W(ws), B, H, Hkv, Sq, Skv, causal, head_dim,
                         scale, st);
  F32_DISPATCH(launch_single, q, k, v, o, lse, B, H, Hkv, Sq, Skv, causal,
               head_dim, scale, st)
}

// ws, counters: the split route's f32 workspace and its zeroed counters
// (S_new == 1 at head dims up to DECODE_SPLIT_MAX_D, every dtype), n_split
// its splits. Past it an S_new == 1 runs, 16-bit, its chunk's route (the
// tensor-core prefill form), f32 the band decode of attention_decode.cu
// on ws and counters with n_split splits; f32 chunks of S_new > 1 past 256
// run the cluster form to 4096, the band form past it on ws
int accl_attn_decode(int dtype, int head_dim, const void* q, const void* kc,
                     const void* vc, void* o, void* ws, void* counters, int B,
                     int H, int Hkv, int Tlen, int s_new, int kv_len,
                     int n_split, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (head_dim % 8 || head_dim < 8) return cudaErrorInvalidValue;
  if (s_new == 1 && head_dim <= DECODE_SPLIT_MAX_D)
    return attn_decode_split(dtype, head_dim, q, kc, vc, o, ws, counters, B,
                             H, Hkv, Tlen, kv_len, n_split, scale, st);
  if (dtype == 1 || dtype == 2)
    return attn_prefill_wgmma(dtype, head_dim, q, kc, vc, o, B, H, Hkv, Tlen,
                              s_new, kv_len, scale, st);
  if (dtype != 0) return cudaErrorInvalidValue;
  if (s_new == 1)
    return attn_decode_band(dtype, head_dim, q, kc, vc, o, ws, counters, B,
                            H, Hkv, Tlen, kv_len, n_split, scale, st);
  if (s_new > 1 && cluster_form(head_dim)) {
    CLUSTER_NS_DISPATCH(launch_decode_cluster, head_dim, F(q), F(kc), F(vc),
                        static_cast<float*>(o), B, H, Hkv, Tlen, s_new,
                        kv_len, head_dim, scale, st)
  }
  if (head_dim > CLUSTER_MAX_D)
    return attn_prefill_band(F(q), F(kc), F(vc), W(o), W(ws), B, H, Hkv, Tlen,
                             s_new, kv_len, head_dim, scale, st);
  F32_DISPATCH(launch_decode, q, kc, vc, o, B, H, Hkv, Tlen, s_new, kv_len,
               head_dim, scale, st)
}

// The f32 B8 on the band form at any head dim past 256 (measurements
// beside the dispatch's choice), as accl_attn_fwd with dtype 0
int accl_attn_fwd_band(int dtype, int head_dim, const void* q, const void* k,
                       const void* v, void* o, void* lse, void* ws, int B,
                       int H, int Hkv, int Sq, int Skv, int causal,
                       float scale, void* stream) {
  if (dtype != 0 || head_dim % 8 || head_dim <= 256)
    return cudaErrorInvalidValue;
  return attn_fwd_band(ROUTE_FWD_TF32_BAND, F(q), F(k), F(v), W(o), W(lse),
                       W(ws), B, H, Hkv, Sq, Skv, causal, head_dim, scale,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
