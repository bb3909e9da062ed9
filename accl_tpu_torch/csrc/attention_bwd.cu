// Attention backward kernels B10 and B11 (CUDA C++, sm_90a), the f32
// route: the FlashAttention-2 backward on the TF32 tensor cores with
// 3xTF32 products, which rebuilds the probabilities from the forward's
// per-row log-sum-exp (LSE) instead of storing them. The C entry points
// below send 16-bit operands (dtype codes 1 bf16 and 2 f16) to the wgmma
// kernels of attention_bwd_sm90.cu and f32 operands (code 0) to the
// kernels here: one kernel per route.
//
// Replace accl_tpu/ops/attention.py:
//   B10 attn_bwd_dkv_kernel <- _bwd_dkv_kernel (pallas_call at :461):
//       per-q-head f32 partials of dK and dV (the GQA group sum runs
//       outside, as the reference's :522-523).
//   B11 attn_bwd_dq_kernel  <- _bwd_dq_kernel (:492): dQ in q's dtype.
//
// For a score s = q.k of a visible (query i, key j) pair:
//   p = exp(scale*s - lse_i), dp = do_i . v_j, ds = p * (dp - delta_i),
//   dv_j += p * do_i, dk_j += scale * ds * q_i, dq_i += scale * ds * k_j,
// with delta_i = rowsum(do_i * o_i) computed by the caller from O in q's
// dtype (attention.py:433). An invisible pair (key past Skv, query past
// Sq, or key j > query i under the causal mask, top-left as the forward)
// takes p = 0 through the mask, never through exp of a masked score.
//
// What bounds them on an H100: 8*D (B10: S, dP, dV, dK) and 6*D (B11: S,
// dP, dQ) operations per visible score against 2*D*4 bytes per row, so
// at S in the thousands they are bound by operations. On the CUDA cores
// that is 67 TFLOP/s of f32 FMA; here every product runs three times on
// the 495 TFLOP/s TF32 tensor cores (bound 3 * ops / 495 TFLOP/s, 2.7x
// below the CUDA-core bound).
//
// Numerics (tf32_mma.cuh): each f32 operand splits into hi = tf32(a) and
// lo = tf32(a - hi) as it is loaded into registers, and a product is lo*hi
// + hi*lo + hi*hi in f32 accumulators, which keeps all five products
// (S, dP, dV, dK, dQ) near f32 accuracy: one TF32 product would move the
// gradients some 25x past the f32 limit the card holds them to, three stay
// some 20x inside it (tests/test_torch_attention_bwd.py emulates both).
// The tensor core truncates as it accumulates, so a sum over thousands of
// rows kept in one accumulator drifts toward zero by up to an ulp a
// product; dV, dK and dQ therefore sum each streamed tile's 32 rows in a
// fresh accumulator and add it to theirs with an f32 add.
//
// Design: mma.sync m16n8k8 (tf32 x tf32 -> f32), 8 warps a block, one
// block an SM (about 200 KB of shared memory at D = 128). wgmma takes
// tf32 operands only K-major from shared memory and would need hi and lo
// copies of every tile, past a block's shared memory at these tiles; one
// f32 copy of each tile with the split made in registers fits.
//   B10: one block per (b*h, 128-key tile), key tile 0 (the heaviest
//   under the causal mask) dispatched first. K and V stay resident; a
//   loop over 32-row q tiles from the tile that holds query k0 streams Q,
//   dO, LSE and delta through two cp.async stages, so the next tile loads
//   while this one computes. Each warp owns 16 keys: it forms S^T = K Q^T
//   and dP^T = V dO^T (16 keys x 32 rows), P^T and dS^T in those
//   registers, then dV += P^T dO and dK += dS^T Q (16 keys x D each, in
//   registers for the whole loop). Keys are the rows, as in
//   FlashAttention-2's backward, so P^T and dS^T already sit in the
//   accumulators of the rows that need them: an accumulator holds columns
//   2t and 2t+1 where the A operand wants t and t+4, and the reduction
//   index is free to permute, so the second product reads B's rows in
//   the same order (row 2t as k = t, 2t+1 as k = t+4) instead of moving
//   P through shared memory.
//   B11: one block per (b*h, 128-row q tile), the last q tile first. Q,
//   dO, and the rows' LSE and delta stay resident; a loop over 32-key
//   tiles up to the tile's causal frontier (from its END, attention.py:393)
//   streams K and V through two stages. Each warp owns 16 rows: S = Q K^T,
//   dP = dO V^T, then dQ += dS K (16 rows x D in registers).
// A warp whose 16 rows see no pair of the streamed tile (under the causal
// mask, or past Sq or Skv) skips its products. Rows are padded to a pitch
// of D + 4 floats: the ldmatrix reads of the first products (8 rows of 16
// bytes) and the 32-bit reads of the second (rows 2t, 2t+1, columns g)
// both hit 32 distinct banks. Rows past Sq and keys past Skv are never
// read (cp.async fills them with zeros).
//
// Head dims: instantiated on power-of-two column tiers DP (16 .. 256) with
// the head dim D <= DP (a multiple of 8) at run time: cp.async fills the
// columns past D with zeros and only D columns are stored. At DP = 256 a
// warp that kept 16 rows of dK and dV (or dQ) over all 256 columns would
// hold 256 (128) accumulators, and two 128-row resident tiles with two
// stages of streamed ones would take 400 KB. So at DP = 256 two warps
// share each 16 resident rows, each keeping 128 of the output columns
// (both form the same S and dP: 12 instead of 8 products of D a score in
// B10, 10 instead of 6 in B11), a block holds 64 resident rows, and the
// streamed tiles have one stage (200 KB in all; the next tile's loads
// wait for this one's products). Past 256 columns up to 4096 a cluster of
// blocks splits the head dim and exchanges S and dP through distributed
// shared memory ("the cluster form" below); past 4096 S and dP are formed
// once a tile over the whole head dim and kept in a workspace in device
// memory for the second products ("the band form").
//
// Arithmetic in f32: expf without intrinsics, the scale of dK and dQ
// applied once to the sums. No atomics: one writer for each output
// element, so two runs on the same inputs are bitwise equal.
#include "attention_band.cuh"
#include "attention_cluster.cuh"
#include "tf32_mma.cuh"

namespace {

// The shape of a block at column tier DP: WPR warps share 16 resident
// rows, each keeping CW of the output columns; RROWS resident rows;
// NSTAGE stages of streamed tiles. Shared memory: two resident tiles
// (B10 K, V; B11 Q, dO), NSTAGE stages of two streamed tiles (B10 Q, dO;
// B11 K, V), and 2 * RROWS floats of LSE and delta (B10: NSTAGE stages
// of SROWS each).
template <int DP>
struct BwdSmem {
  static constexpr int WPR = DP > 128 ? 2 : 1;
  static constexpr int CW = DP / WPR;           // output columns a warp
  static constexpr int RROWS = 16 * (NT / 32) / WPR;
  static constexpr int NSTAGE = DP > 128 ? 1 : 2;
  static constexpr int P = DP + 4;       // row pitch, floats
  static constexpr int RES = RROWS * P;  // floats of a resident tile
  static constexpr int STR = SROWS * P;  // floats of a streamed tile
  static constexpr int BYTES =
      (2 * RES + 2 * NSTAGE * STR + 2 * RROWS) * 4;
  static_assert(NSTAGE * 2 * SROWS <= 2 * RROWS, "B10's stats");
  static_assert(BYTES <= MAX_SMEM, "a block's shared memory");
};

// B10: grid (B*H, key tiles). q/dout (B*H, Sq, D); k/v (B*Hkv, Skv, D);
// lse/delta (B*H, Sq) f32; dk/dv (B*H, Skv, D) f32 per-q-head partials.
template <int DP>
__global__ void __launch_bounds__(NT, 1)
attn_bwd_dkv_kernel(const float* __restrict__ q,
                    const float* __restrict__ dout,
                    const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int H, int Hkv, int Sq, int Skv,
                    int causal, int D, float scale) {
  using L = BwdSmem<DP>;
  constexpr int P = L::P, CW = L::CW, NC = CW / 8, RROWS = L::RROWS;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + L::RES;
  float* sQ = sV + L::RES;         // stage s: Q at sQ + 2*s*STR, dO after
  float* sStat = sQ + 2 * L::NSTAGE * L::STR;  // stage s: LSE at sStat +
                                               // 2*s*SROWS, delta after
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = tid >> 5;
  const int kw = 16 * (warp / L::WPR);  // the warp's first key in the tile
  const int c0 = CW * (warp % L::WPR);  // ... and its first column
  const int bh = blockIdx.x, k0 = blockIdx.y * RROWS;
  const long long kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int nk = min(RROWS, Skv - k0);
  const float* lse_row = lse + static_cast<long long>(bh) * Sq;
  const float* delta_row = delta + static_cast<long long>(bh) * Sq;
  // under the causal mask queries before k0 see none of these keys
  const int q_first = causal ? (k0 / SROWS) * SROWS : 0;
  const int n_it = q_first < Sq ? (Sq - q_first + SROWS - 1) / SROWS : 0;

  auto load_q = [&](int s, int q0) {
    const int nq = min(SROWS, Sq - q0);
    const long long off = (static_cast<long long>(bh) * Sq + q0) * D;
    float* dst = sQ + 2 * s * L::STR;
    cp_rows<DP, SROWS, P, NT>(dst, q + off, nq, D, D);
    cp_rows<DP, SROWS, P, NT>(dst + L::STR, dout + off, nq, D, D);
    if (tid < 2 * SROWS) {
      const int r = tid % SROWS;
      const bool ok = r < nq;
      cp_async4(sStat + 2 * s * SROWS + tid,
                (tid < SROWS ? lse_row : delta_row) + q0 + (ok ? r : 0), ok);
    }
  };
  const long long koff = (kvrow * Skv + k0) * D;
  cp_rows<DP, RROWS, P, NT>(sK, k + koff, nk, D, D);
  cp_rows<DP, RROWS, P, NT>(sV, v + koff, nk, D, D);
  if (n_it > 0) load_q(0, q_first);
  cp_async_commit();

  float adk[NC][4], adv[NC][4];  // keys kw+g, kw+g+8; columns c0+8c+2t, +1
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[c][e] = adv[c][e] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    const int s = L::NSTAGE == 2 ? it & 1 : 0;
    const int q0 = q_first + it * SROWS;
    const int nq = min(SROWS, Sq - q0);
    if constexpr (L::NSTAGE == 2) {
      if (it + 1 < n_it) load_q(s ^ 1, q0 + SROWS);
      cp_async_commit();
      cp_async_wait<1>();  // this stage (and K, V) landed
    } else {
      if (it > 0) {
        load_q(0, q0);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    // warp-uniform: do the warp's keys see a row of this tile?
    if (kw < nk && (!causal || k0 + kw <= q0 + nq - 1)) {
      const float* cQ = sQ + 2 * s * L::STR;
      const float* cDO = cQ + L::STR;
      const float* cLse = sStat + 2 * s * SROWS;
      const float* cDelta = cLse + SROWS;
      float x[4][4], y[4][4];  // S^T, then P^T; dP^T, then dS^T
      rows16_x_rows32<DP>(sK + kw * P, cQ, x);
      rows16_x_rows32<DP>(sV + kw * P, cDO, y);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + g + 8 * (e >> 1), r = 8 * j + 2 * t + (e & 1);
          const bool ok =
              r < nq && key < nk && (!causal || k0 + key <= q0 + r);
          x[j][e] = ok ? expf(__fsub_rn(__fmul_rn(x[j][e], scale), cLse[r]))
                       : 0.0f;
          y[j][e] = __fmul_rn(x[j][e], __fsub_rn(y[j][e], cDelta[r]));
        }
      rows_accumulate<DP, CW>(x, cDO + c0, adv);  // dV += P^T dO
      rows_accumulate<DP, CW>(y, cQ + c0, adk);   // dK += dS^T Q (scaled
                                                  // at the end)
    }
    __syncthreads();  // every warp is done with stage s before it reloads
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw + g + 8 * h;
    if (key >= nk) continue;
    const long long o = (static_cast<long long>(bh) * Skv + k0 + key) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c0 + 8 * c + 2 * t;
      if (c0 + 8 * c >= D) continue;
      *reinterpret_cast<float2*>(dk + o + col) =
          make_float2(__fmul_rn(adk[c][2 * h], scale),
                      __fmul_rn(adk[c][2 * h + 1], scale));
      *reinterpret_cast<float2*>(dv + o + col) =
          make_float2(adv[c][2 * h], adv[c][2 * h + 1]);
    }
  }
}

// B11: grid (B*H, q tiles); the same operands; dq (B*H, Sq, D) f32.
template <int DP>
__global__ void __launch_bounds__(NT, 1)
attn_bwd_dq_kernel(const float* __restrict__ q,
                   const float* __restrict__ dout,
                   const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int H, int Hkv, int Sq, int Skv, int causal, int D,
                   float scale) {
  using L = BwdSmem<DP>;
  constexpr int P = L::P, CW = L::CW, NC = CW / 8, RROWS = L::RROWS;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sDO = sQ + L::RES;
  float* sK = sDO + L::RES;          // stage s: K at sK + 2*s*STR, V after
  float* sLse = sK + 2 * L::NSTAGE * L::STR;  // RROWS
  float* sDelta = sLse + RROWS;               // RROWS
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = tid >> 5;
  const int qw = 16 * (warp / L::WPR);  // the warp's first row in the tile
  const int c0 = CW * (warp % L::WPR);  // ... and its first column
  const int bh = blockIdx.x;
  // the last q tile, the heaviest under the causal mask, first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * RROWS;
  const long long kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int nq = min(RROWS, Sq - q0);
  // causal frontier from the q tile's end: keys past its last row unseen
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;
  const int n_it = (kv_end + SROWS - 1) / SROWS;
  const long long kvoff = kvrow * Skv * D;

  auto load_kv = [&](int s, int kt0) {
    const int n = min(SROWS, kv_end - kt0);
    float* dst = sK + 2 * s * L::STR;
    cp_rows<DP, SROWS, P, NT>(
        dst, k + kvoff + static_cast<long long>(kt0) * D, n, D, D);
    cp_rows<DP, SROWS, P, NT>(
        dst + L::STR, v + kvoff + static_cast<long long>(kt0) * D, n, D, D);
  };
  const long long qoff = (static_cast<long long>(bh) * Sq + q0) * D;
  const long long roff = static_cast<long long>(bh) * Sq + q0;
  cp_rows<DP, RROWS, P, NT>(sQ, q + qoff, nq, D, D);
  cp_rows<DP, RROWS, P, NT>(sDO, dout + qoff, nq, D, D);
  for (int i = tid; i < 2 * RROWS; i += NT) {
    const int r = i % RROWS;
    const bool ok = r < nq;
    cp_async4(sLse + i, (i < RROWS ? lse : delta) + roff + (ok ? r : 0), ok);
  }
  if (n_it > 0) load_kv(0, 0);
  cp_async_commit();

  float acc[NC][4];  // rows qw+g, qw+g+8; columns c0+8c+2t, +1
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    const int s = L::NSTAGE == 2 ? it & 1 : 0, kt0 = it * SROWS;
    const int nk = min(SROWS, kv_end - kt0);
    if constexpr (L::NSTAGE == 2) {
      if (it + 1 < n_it) load_kv(s ^ 1, kt0 + SROWS);
      cp_async_commit();
      cp_async_wait<1>();  // this stage (and Q, dO, the stats) landed
    } else {
      if (it > 0) {
        load_kv(0, kt0);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    // warp-uniform: do the warp's rows see a key of this tile?
    if (qw < nq && (!causal || kt0 <= q0 + qw + 15)) {
      const float* cK = sK + 2 * s * L::STR;
      const float* cV = cK + L::STR;
      float x[4][4], y[4][4];  // S, then P; dP, then dS
      rows16_x_rows32<DP>(sQ + qw * P, cK, x);
      rows16_x_rows32<DP>(sDO + qw * P, cV, y);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = qw + g + 8 * (e >> 1), key = 8 * j + 2 * t + (e & 1);
          const bool ok =
              r < nq && key < nk && (!causal || kt0 + key <= q0 + r);
          x[j][e] = ok ? expf(__fsub_rn(__fmul_rn(x[j][e], scale), sLse[r]))
                       : 0.0f;
          y[j][e] = __fmul_rn(x[j][e], __fsub_rn(y[j][e], sDelta[r]));
        }
      rows_accumulate<DP, CW>(y, cK + c0, acc);  // dQ += dS K (scaled at
                                                 // the end)
    }
    __syncthreads();  // every warp is done with stage s before it reloads
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qw + g + 8 * h;
    if (r >= nq) continue;
    float* o = dq + qoff + static_cast<long long>(r) * D + c0 + 2 * t;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c0 + 8 * c < D)
        *reinterpret_cast<float2*>(o + 8 * c) =
            make_float2(__fmul_rn(acc[c][2 * h], scale),
                        __fmul_rn(acc[c][2 * h + 1], scale));
  }
}

// ---- head dims past 256: the cluster form -----------------------------------
//
// B10 and B11 at 256 < D <= 4096 on the same 3xTF32 products, one launch a
// call, with S and dP formed once for each (resident tile, streamed tile)
// pair. The head dim is cut into Gs = ceil(D / 64) slices of 64 columns and
// a thread-block cluster of C = ceil(Gs / NS) blocks (grid z; C <= 8,
// portable) owns one (b*h, tile of RK = 128 / NS resident rows): block c
// holds the NS slices NS*c .. NS*c + NS - 1. The tier is the smallest NS
// of 2, 4 and 8 with C <= 8: NS 2 to D 1024 (64 resident rows), 4 to 2048
// (32), 8 to 4096 (16). A block keeps only its slices of the resident
// operands (B10 K and V, B11 Q and dO) in shared memory for the whole loop
// and streams only its slices of the others (B10 Q and dO, B11 K and V)
// through NSL cp.async slots of one operand tile each, every load issued
// as soon as its slot is free: four slots at NS 2 (two stages: the next
// tile's loads run under this tile's products); three at NS 4, where two
// stages do not fit (B10: the next Q under the whole tile, the next dO
// under dV's product; B11: the next V under the whole tile, the next K
// from step 2 on, V's slot being free after step 1); two at NS 8, whose
// slices fill shared memory (B10: the next Q under dV's product, the next
// dO under the next tile's S, formed before its dO is waited for; B11:
// the next V from step 2 on, the next K under the next tile's dP, formed
// first).
// Its 8 warps form RK / 16 groups of 16 resident rows, one warp of a group
// for each slice. The partials' positions (a float4 of a 16 x 8
// accumulator tile; a "quarter" of 32 of them for 16 resident rows by 8
// streamed ones) are dealt to the blocks, quarter i to block i % C. For
// every streamed tile of 32 rows (B11: keys):
//   1. each warp forms its slice's partial S and dP (16 x 32, 3xTF32, each
//      in a fresh accumulator); the NS warps of a group add theirs in slice
//      order through shared memory (xch_push), each warp summing a share of
//      the positions, and store the block's partial, quarter by quarter,
//      into the owners' receive buffers at the block's slot; cluster
//      barrier;
//   2. the owner of each position sums the C partials in block order with
//      f32 adds, forms P = exp(scale*S - LSE) and dS = P*(dP - delta) under
//      the mask, and stores them into every block's result buffer (B11: dS
//      only); cluster barrier;
//   3. each warp reads its group's P and dS from its own result buffer and
//      updates its slice: dV += P^T dO and dK += dS^T Q (B10), dQ += dS K
//      (B11), each tile's rows summed in a fresh accumulator.
// So every block holds bitwise the same P and dS, and S and dP are formed
// once, not once a column group (the column-group form's 3x to 11x excess
// of products). Every access to a peer's shared memory is a store, which
// does not wait for an answer as a load from a peer does; and a block
// exchanges (C-1)/C of 8 * 16 * RK floats of partials and as many of
// results a tile (B11: half). The receive buffer is read before the second
// barrier and written after it, the result buffer read before the next
// tile's first barrier and written after it, so one of each suffices; the
// slice sums of step 1 share the result buffer's memory, used only between
// a tile's block barrier and its first cluster barrier. Whether a group's
// rows see a pair of the tile depends only on the tile, the same in every
// block of a cluster: such a group skips its products, its positions are
// neither summed nor read, and every thread arrives at every barrier. A
// first barrier makes sure every block of the cluster runs before a peer
// stores to it; past a tile's second barrier no block touches a peer's
// shared memory, so a block may exit after its last tile. Columns past D
// load as zeros; a slice wholly past D takes no part in the products and
// its warp only sums its share of the live slices' partials. Shared memory
// about 174, 209 and 227 KB at NS 2, 4 and 8, one block an SM. No atomics:
// one writer for each element. The tiers, the exchange's sum, broadcast and
// read and the launch are attention_cluster.cuh's, shared with the
// forward's cluster form (attention.cu).
constexpr int XSTR = SROWS * SLP;     // floats of a slice's streamed tile

// The shape of a cluster block holding NS slices: RK resident rows, NQ
// quarters of positions (128 floats each), NSL slots of streamed operand
// tiles; the slice sums deal each warp UNITS of the eight float4 units a
// lane holds (S's four, then dP's), WR slices storing theirs a round.
// Shared memory: the resident tiles (B10 K, V; B11 Q, dO) and the slots
// of the streamed ones (B10 Q, dO; B11 V, K), NS slices each; the receive
// buffers of S and dP; the result buffers of P and dS, which the slice
// sums share; the stats (B10 two tiles' SROWS rows, B11 RK rows, LSE and
// delta each).
template <int NS>
struct Xch {
  static constexpr int SLICES = NS;
  static constexpr int RK = 128 / NS;
  static constexpr int NQ = RK / 16 * 4;
  static constexpr int NSL = NS == 2 ? 4 : NS == 4 ? 3 : 2;
  static constexpr int CMIN = cluster_cmin(NS);  // the tier's least C
  static constexpr int UNITS = 8 / NS;
  static constexpr int WR = NS < 8 ? NS : 4;
  static constexpr int RES = RK * SLP;  // floats of a slice's resident tile
  static constexpr int RCV = most_slots(NQ, CMIN) * 128;  // S's (dP's)
  static constexpr int RSL = NQ * 128;                    // P's (dS's)
  static constexpr int SUM = RK / 16 * WR * (8 - UNITS) * 128;
  static constexpr int SHARE = SUM > 2 * RSL ? SUM : 2 * RSL;
  static constexpr int STAT = 2 * (2 * SROWS > RK ? 2 * SROWS : RK);
  static constexpr int BYTES =
      (2 * NS * RES + NSL * NS * XSTR + 2 * RCV + SHARE + STAT) * 4;
  static_assert(BYTES <= MAX_SMEM, "a block's shared memory");
  static_assert(RK / 16 * NS * 32 == NT, "a warp for each (group, slice)");
  static_assert(NS % WR == 0, "whole rounds");
};
__device__ __forceinline__ void zero_tile(float (&x)[4][4],
                                          float (&y)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.0f;
}
// step 1: the block's partial over its nl live slices for rows group grp.
// The warp of slice h holds x (S) and y (dP) over its slice; a lane's
// eight float4 units (x's four, then y's) are dealt UNITS to a warp, slice
// h owning units h*UNITS .. h*UNITS + UNITS - 1. Each live warp stores the
// units it does not own into sum, the group's warps meet at their named
// barrier, and each warp adds its units over the live slices in slice
// order, its own slice's from its registers: at NS 2 the slice-0 warp sums
// S, the slice-1 warp dP. Past WR slices (NS 8) they store and add in
// rounds of WR. Each summed unit goes into its owner's receive buffer rcv
// (S's, then dP's at rcv + RCV) at slot `rank`. The slice H is a template
// parameter, so that the units' roles are known as the code is built;
// xch_push below picks the warp's.
template <int NS, int H>
__device__ __forceinline__ void xch_push_as(
    cooperative_groups::cluster_group& cluster, float* rcv, float* sum,
    int grp, int nl, int rank, int C, const float (&x)[4][4],
    const float (&y)[4][4]) {
  using X = Xch<NS>;
  constexpr int U = X::UNITS, NW = 8 - U, WR = X::WR;  // NW: units stored
  const int l = threadIdx.x & 31;
  // the group's WR slots of NW units; unit u of slice s at index u, or
  // u - U past the slice's own units
  float4* buf = reinterpret_cast<float4*>(sum) + grp * WR * NW * 32 + l;
  float4 acc[U];
#pragma unroll
  for (int r = 0; r < NS / WR; ++r) {
    if (H / WR == r && H < nl) {  // this round's writers
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (u / U != H)
          buf[((H % WR) * NW + (u < H * U ? u : u - U)) * 32] =
              u < 4 ? f4(x[u & 3]) : f4(y[u & 3]);
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(32 * NS)
                 : "memory");
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = H * U + k;
#pragma unroll
      for (int w = 0; w < WR; ++w) {
        const int s = r * WR + w;
        if (s >= nl) break;
        const float4 v =
            s == H ? (u < 4 ? f4(x[u & 3]) : f4(y[u & 3]))
                   : buf[(w * NW + (u < s * U ? u : u - U)) * 32];
        acc[k] = s == 0 ? v : f4_add(acc[k], v);
      }
    }
    if (r + 1 < NS / WR)  // every read of the round is done
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(32 * NS)
                   : "memory");
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int u = H * U + k, qi = grp * 4 + (u & 3);
    float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(
                      rcv + (u >> 2) * X::RCV, qi % C)) +
                  ((qi / C) * C + rank) * 32 + l;
    *dst = acc[k];
  }
}
// xch_push_as for the warp's slice h
template <int NS, int H = 0>
__device__ __forceinline__ void xch_push(
    cooperative_groups::cluster_group& cluster, float* rcv, float* sum,
    int grp, int h, int nl, int rank, int C, const float (&x)[4][4],
    const float (&y)[4][4]) {
  if constexpr (H < NS) {
    if (h == H)
      xch_push_as<NS, H>(cluster, rcv, sum, grp, nl, rank, C, x, y);
    else
      xch_push<NS, H + 1>(cluster, rcv, sum, grp, h, nl, rank, C, x, y);
  }
}

// B10 at cluster_form(D), NS = cluster_ns(D): grid (B*H, key tiles of RK,
// C), clusters (1, 1, C); operands as attn_bwd_dkv_kernel's
template <int NS>
__global__ void __launch_bounds__(NT, 1)
attn_bwd_dkv_cluster_kernel(const float* __restrict__ q,
                            const float* __restrict__ dout,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int H, int Hkv, int Sq, int Skv, int causal, int D,
                            float scale) {
  using X = Xch<NS>;
  constexpr int RK = X::RK;
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                // slice h at sK + h*RES
  float* sV = sK + NS * X::RES;
  float* sQ = sV + NS * X::RES;    // the streamed operands' slots
  float* rS = sQ + X::NSL * NS * XSTR;  // receive buffers: S, dP
  float* xP = rS + 2 * X::RCV;     // result buffers P, dS; the slice sums
  float* sStat = xP + X::SHARE;    // tile i's LSE at sStat +
                                   // 2*(i&1)*SROWS, delta after
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = tid >> 5, grp = warp / NS, h = warp % NS, kw = 16 * grp;
  const int C = gridDim.z, rank = cluster.block_rank();
  const int col0 = NS * rank * SL, c0 = col0 + h * SL;  // the block's and
                                                        // the warp's columns
  const int nl = min(NS, (D - col0 + SL - 1) / SL);  // the live slices
  const int bh = blockIdx.x, k0 = blockIdx.y * RK;
  const long long kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int nk = min(RK, Skv - k0);
  const float* lse_row = lse + static_cast<long long>(bh) * Sq;
  const float* delta_row = delta + static_cast<long long>(bh) * Sq;
  // under the causal mask queries before k0 see none of these keys
  const int q_first = causal ? (k0 / SROWS) * SROWS : 0;
  const int n_it = q_first < Sq ? (Sq - q_first + SROWS - 1) / SROWS : 0;

  // the streamed operand n (tile i = n / 2's Q if n is even, else its dO)
  // into slot n % NSL, the tile's stats with its Q
  auto load_op = [&](int n) {
    const int i = n >> 1, q0 = q_first + i * SROWS, nq = min(SROWS, Sq - q0);
    const float* src =
        (n & 1 ? dout : q) + (static_cast<long long>(bh) * Sq + q0) * D;
    float* dst = sQ + (n % X::NSL) * NS * XSTR;
#pragma unroll
    for (int hh = 0; hh < NS; ++hh) {
      const int col = col0 + hh * SL;
      cp_rows<SL, SROWS, SLP, NT>(dst + hh * XSTR, src + col, nq, D - col,
                                  D);
    }
    if (!(n & 1) && tid < 2 * SROWS) {
      const int r = tid % SROWS;
      const bool ok = r < nq;
      cp_async4(sStat + 2 * (i & 1) * SROWS + tid,
                (tid < SROWS ? lse_row : delta_row) + q0 + (ok ? r : 0), ok);
    }
  };
  const long long koff = (kvrow * Skv + k0) * D;
#pragma unroll
  for (int hh = 0; hh < NS; ++hh) {
    const int col = col0 + hh * SL;
    cp_rows<SL, RK, SLP, NT>(sK + hh * X::RES, k + koff + col, nk, D - col,
                             D);
    cp_rows<SL, RK, SLP, NT>(sV + hh * X::RES, v + koff + col, nk, D - col,
                             D);
  }
  // at NS 8 in two groups, K, V and Q before dO: S may start first
  if (n_it > 0) load_op(0);
  if constexpr (X::NSL == 2) cp_async_commit();
  if (n_it > 0) load_op(1);
  cp_async_commit();

  float adk[SL / 8][4], adv[SL / 8][4];  // keys kw+g, kw+g+8; columns
                                         // c0+8c+2t, +1
#pragma unroll
  for (int c = 0; c < SL / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[c][e] = adv[c][e] = 0.0f;

  cluster.sync();  // every block of the cluster runs: its peers may store
  for (int it = 0; it < n_it; ++it) {
    const int q0 = q_first + it * SROWS, nq = min(SROWS, Sq - q0);
    const bool more = it + 1 < n_it;
    // this tile's Q and dO (NSL 2: Q only, dO the newest group; and K,
    // V) landed
    cp_async_wait<X::NSL == 2 ? 1 : 0>();
    __syncthreads();  // ... for every thread; the last tile's are read
    if (X::NSL >= 3 && more) {  // into the last tile's slots: the next Q
      load_op(2 * it + 2);      // (NSL 4: and dO)
      if (X::NSL == 4) load_op(2 * it + 3);
      cp_async_commit();
    }
    const float* cQ = sQ + (2 * it % X::NSL) * NS * XSTR + h * XSTR;
    const float* cDO = sQ + ((2 * it + 1) % X::NSL) * NS * XSTR + h * XSTR;
    const float* cLse = sStat + 2 * (it & 1) * SROWS;
    const float* cDelta = cLse + SROWS;
    // cluster-uniform: do the keys of group gr see a row of this tile?
    auto live = [&](int gr) {
      return 16 * gr < nk && (!causal || k0 + 16 * gr <= q0 + nq - 1);
    };
    const bool mine = live(grp) && c0 < D;
    // step 1: partial S^T, dP^T over the warp's slice (zeros past D)
    if constexpr (X::NSL == 2) {  // S, then dP once dO has landed
      float x[4][4], y[4][4];
      if (mine) rows16_x_rows32<SL>(sK + h * X::RES + kw * SLP, cQ, x);
      cp_async_wait<0>();
      __syncthreads();
      if (mine) rows16_x_rows32<SL>(sV + h * X::RES + kw * SLP, cDO, y);
      if (live(grp)) {
        if (!mine) zero_tile(x, y);
        xch_push<NS>(cluster, rS, xP, grp, h, nl, rank, C, x, y);
      }
    } else if (live(grp)) {
      float x[4][4], y[4][4];
      if (mine) {
        rows16_x_rows32<SL>(sK + h * X::RES + kw * SLP, cQ, x);
        rows16_x_rows32<SL>(sV + h * X::RES + kw * SLP, cDO, y);
      } else {
        zero_tile(x, y);
      }
      xch_push<NS>(cluster, rS, xP, grp, h, nl, rank, C, x, y);
    }
    cluster.sync();  // every partial of the tile is in place
    // step 2 on this block's quarters, two elements a thread-step
    for (int u = tid;; u += NT) {
      const int m = u >> 6, qi = rank + C * m;  // the quarter, its position
      if (qi >= X::NQ) break;
      const int pg = qi >> 2, j = qi & 3, pl = (u >> 1) & 31, half = u & 1;
      if (!live(pg)) continue;  // no warp reads it
      const int roff = (m * C * 32 + pl) * 4 + 2 * half;
      const int off = (qi * 32 + pl) * 4 + 2 * half;
      const float2 sv = xch_sum(rS, roff, C);
      const float2 dpv = xch_sum(rS + X::RCV, roff, C);
      const int key = 16 * pg + (pl >> 2) + 8 * half, r0 = 8 * j + 2 * (pl & 3);
      const float sx[2] = {sv.x, sv.y}, dx[2] = {dpv.x, dpv.y};
      float pp[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + e;
        const bool ok =
            r < nq && key < nk && (!causal || k0 + key <= q0 + r);
        pp[e] = ok ? expf(__fsub_rn(__fmul_rn(sx[e], scale), cLse[r])) : 0.0f;
        ds[e] = __fmul_rn(pp[e], __fsub_rn(dx[e], cDelta[r]));
      }
      xch_bcast(cluster, xP, off, C, make_float2(pp[0], pp[1]));
      xch_bcast(cluster, xP + X::RSL, off, C, make_float2(ds[0], ds[1]));
    }
    cluster.sync();  // every P and dS of the tile is in place
    float x[4][4];     // step 3: dS^T, then P^T, 16 keys x 32 rows
    if (mine) {
      xch_read(xP + X::RSL, grp, x);
      rows_accumulate<SL, SL>(x, cQ, adk);  // dK += dS^T Q (scaled at the
                                            // end)
    }
    if (X::NSL <= 3 && more) {  // Q's slot is free: the next dO (NSL 3) or
      __syncthreads();          // Q (NSL 2)
      load_op(2 * it + (X::NSL == 3 ? 3 : 2));
      cp_async_commit();
    }
    if (mine) {
      xch_read(xP, grp, x);
      rows_accumulate<SL, SL>(x, cDO, adv);  // dV += P^T dO
    }
    if (X::NSL == 2 && more) {  // dO's slot is free: the next dO
      __syncthreads();
      load_op(2 * it + 3);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  if (c0 >= D) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = kw + g + 8 * hh;
    if (key >= nk) continue;
    const long long o = (static_cast<long long>(bh) * Skv + k0 + key) * D;
#pragma unroll
    for (int c = 0; c < SL / 8; ++c) {
      const int col = c0 + 8 * c + 2 * t;
      if (c0 + 8 * c >= D) continue;
      *reinterpret_cast<float2*>(dk + o + col) =
          make_float2(__fmul_rn(adk[c][2 * hh], scale),
                      __fmul_rn(adk[c][2 * hh + 1], scale));
      *reinterpret_cast<float2*>(dv + o + col) =
          make_float2(adv[c][2 * hh], adv[c][2 * hh + 1]);
    }
  }
}

// B11 at cluster_form(D), NS = cluster_ns(D): grid (B*H, q tiles of RK,
// C), clusters (1, 1, C); operands as attn_bwd_dq_kernel's
template <int NS>
__global__ void __launch_bounds__(NT, 1)
attn_bwd_dq_cluster_kernel(const float* __restrict__ q,
                           const float* __restrict__ dout,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int H, int Hkv, int Sq,
                           int Skv, int causal, int D, float scale) {
  using X = Xch<NS>;
  constexpr int RK = X::RK;
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                // slice h at sQ + h*RES
  float* sDO = sQ + NS * X::RES;
  float* sK = sDO + NS * X::RES;   // the streamed operands' slots
  float* rS = sK + X::NSL * NS * XSTR;  // receive buffers: S, dP
  float* xS = rS + 2 * X::RCV;     // result buffer dS; the slice sums
  float* sLse = xS + X::SHARE;     // RK, then delta's RK
  float* sDelta = sLse + RK;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = tid >> 5, grp = warp / NS, h = warp % NS, qw = 16 * grp;
  const int C = gridDim.z, rank = cluster.block_rank();
  const int col0 = NS * rank * SL, c0 = col0 + h * SL;  // the block's and
                                                        // the warp's columns
  const int nl = min(NS, (D - col0 + SL - 1) / SL);  // the live slices
  const int bh = blockIdx.x;
  // the last q tile, the heaviest under the causal mask, first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * RK;
  const long long kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int nq = min(RK, Sq - q0);
  // causal frontier from the q tile's end: keys past its last row unseen
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;
  const int n_it = (kv_end + SROWS - 1) / SROWS;
  const long long kvoff = kvrow * Skv * D;

  // the streamed operand n (key tile i = n / 2's V if n is even, else
  // its K) into slot n % NSL: V first, whose slot frees after step 1
  auto load_op = [&](int n) {
    const int kt0 = (n >> 1) * SROWS, cnt = min(SROWS, kv_end - kt0);
    const float* src =
        (n & 1 ? k : v) + kvoff + static_cast<long long>(kt0) * D;
    float* dst = sK + (n % X::NSL) * NS * XSTR;
#pragma unroll
    for (int hh = 0; hh < NS; ++hh) {
      const int col = col0 + hh * SL;
      cp_rows<SL, SROWS, SLP, NT>(dst + hh * XSTR, src + col, cnt, D - col,
                                  D);
    }
  };
  const long long qoff = (static_cast<long long>(bh) * Sq + q0) * D;
  const long long roff = static_cast<long long>(bh) * Sq + q0;
#pragma unroll
  for (int hh = 0; hh < NS; ++hh) {
    const int col = col0 + hh * SL;
    cp_rows<SL, RK, SLP, NT>(sQ + hh * X::RES, q + qoff + col, nq, D - col,
                             D);
    cp_rows<SL, RK, SLP, NT>(sDO + hh * X::RES, dout + qoff + col, nq,
                             D - col, D);
  }
  for (int i = tid; i < 2 * RK; i += NT) {
    const int r = i % RK;
    const bool ok = r < nq;
    cp_async4(sLse + i, (i < RK ? lse : delta) + roff + (ok ? r : 0), ok);
  }
  // at NS 8 in two groups, V before K: dP may start first
  if (n_it > 0) load_op(0);
  if constexpr (X::NSL == 2) cp_async_commit();
  if (n_it > 0) load_op(1);
  cp_async_commit();

  float acc[SL / 8][4];  // rows qw+g, qw+g+8; columns c0+8c+2t, +1
#pragma unroll
  for (int c = 0; c < SL / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;

  cluster.sync();  // every block of the cluster runs: its peers may store
  for (int it = 0; it < n_it; ++it) {
    const int kt0 = it * SROWS, nk = min(SROWS, kv_end - kt0);
    const bool more = it + 1 < n_it;
    // this tile's V (past NSL 2: and K; and Q, dO, the stats) landed: its
    // K is the newest group at NSL 2
    cp_async_wait<X::NSL == 2 ? 1 : 0>();
    __syncthreads();  // ... for every thread; the last tile's are read
    if (X::NSL >= 3 && more) {  // into the last tile's slots: the next V
      load_op(2 * it + 2);      // (NSL 4: and K)
      if (X::NSL == 4) load_op(2 * it + 3);
      cp_async_commit();
    }
    const float* cV = sK + (2 * it % X::NSL) * NS * XSTR + h * XSTR;
    const float* cK = sK + ((2 * it + 1) % X::NSL) * NS * XSTR + h * XSTR;
    // cluster-uniform: do the rows of group gr see a key of this tile?
    auto live = [&](int gr) {
      return 16 * gr < nq && (!causal || kt0 <= q0 + 16 * gr + 15);
    };
    const bool mine = live(grp) && c0 < D;
    // step 1: partial S, dP over the warp's slice (zeros past D)
    auto push = [&](float (&x)[4][4], float (&y)[4][4]) {
      if (!mine) zero_tile(x, y);
      xch_push<NS>(cluster, rS, xS, grp, h, nl, rank, C, x, y);
    };
    if constexpr (X::NSL == 2) {  // dP, then S once K has landed
      float x[4][4], y[4][4];
      if (mine) rows16_x_rows32<SL>(sDO + h * X::RES + qw * SLP, cV, y);
      cp_async_wait<0>();
      __syncthreads();
      if (mine) rows16_x_rows32<SL>(sQ + h * X::RES + qw * SLP, cK, x);
      if (live(grp)) push(x, y);
    } else if (live(grp)) {
      float x[4][4], y[4][4];
      if (mine) {
        rows16_x_rows32<SL>(sQ + h * X::RES + qw * SLP, cK, x);
        rows16_x_rows32<SL>(sDO + h * X::RES + qw * SLP, cV, y);
      }
      push(x, y);
    }
    cluster.sync();  // every partial of the tile is in place
    if (X::NSL <= 3 && more) {  // V's slot is free: the next K (NSL 3) or V
      load_op(2 * it + (X::NSL == 3 ? 3 : 2));  // (NSL 2)
      cp_async_commit();
    }
    // step 2 on this block's quarters, two elements a thread-step
    for (int u = tid;; u += NT) {
      const int m = u >> 6, qi = rank + C * m;  // the quarter, its position
      if (qi >= X::NQ) break;
      const int pg = qi >> 2, j = qi & 3, pl = (u >> 1) & 31, half = u & 1;
      if (!live(pg)) continue;  // no warp reads it
      const int rof = (m * C * 32 + pl) * 4 + 2 * half;
      const int off = (qi * 32 + pl) * 4 + 2 * half;
      const float2 sv = xch_sum(rS, rof, C);
      const float2 dpv = xch_sum(rS + X::RCV, rof, C);
      const int r = 16 * pg + (pl >> 2) + 8 * half, key0 = 8 * j + 2 * (pl & 3);
      const float sx[2] = {sv.x, sv.y}, dx[2] = {dpv.x, dpv.y};
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + e;
        const bool ok =
            r < nq && key < nk && (!causal || kt0 + key <= q0 + r);
        const float pp =
            ok ? expf(__fsub_rn(__fmul_rn(sx[e], scale), sLse[r])) : 0.0f;
        ds[e] = __fmul_rn(pp, __fsub_rn(dx[e], sDelta[r]));
      }
      xch_bcast(cluster, xS, off, C, make_float2(ds[0], ds[1]));
    }
    cluster.sync();  // every dS of the tile is in place
    if (mine) {  // step 3
      float y[4][4];  // dS: 16 rows x 32 keys
      xch_read(xS, grp, y);
      rows_accumulate<SL, SL>(y, cK, acc);  // dQ += dS K (scaled at the
                                            // end)
    }
    if (X::NSL == 2 && more) {  // K's slot is free: the next K
      __syncthreads();
      load_op(2 * it + 3);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  if (c0 >= D) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = qw + g + 8 * hh;
    if (r >= nq) continue;
    float* o = dq + qoff + static_cast<long long>(r) * D + c0 + 2 * t;
#pragma unroll
    for (int c = 0; c < SL / 8; ++c)
      if (c0 + 8 * c < D)
        *reinterpret_cast<float2*>(o + 8 * c) =
            make_float2(__fmul_rn(acc[c][2 * hh], scale),
                        __fmul_rn(acc[c][2 * hh + 1], scale));
  }
}

// B10 and B11 on the cluster form's instantiation for NS slices a block
template <int NS>
cudaError_t launch_dkv_cluster(const float* q, const float* dout,
                               const float* k, const float* v,
                               const float* lse, const float* delta,
                               float* dk, float* dv, int B, int H, int Hkv,
                               int Sq, int Skv, int causal, int D,
                               float scale, cudaStream_t st) {
  return launch_cluster<Xch<NS>>(attn_bwd_dkv_cluster_kernel<NS>,
                            ROUTE_BWD_DKV_COLS_TF32, Skv, B, H, D, st, q,
                            dout, k, v, lse, delta, dk, dv, H, Hkv, Sq, Skv,
                            causal, D, scale);
}
template <int NS>
cudaError_t launch_dq_cluster(const float* q, const float* dout,
                              const float* k, const float* v,
                              const float* lse, const float* delta,
                              float* dq, int B, int H, int Hkv, int Sq,
                              int Skv, int causal, int D, float scale,
                              cudaStream_t st) {
  return launch_cluster<Xch<NS>>(attn_bwd_dq_cluster_kernel<NS>,
                            ROUTE_BWD_DQ_COLS_TF32, Sq, B, H, D, st, q, dout,
                            k, v, lse, delta, dq, H, Hkv, Sq, Skv, causal, D,
                            scale);
}
template <int NS>
int active_of(int dkv, int D) {
  int n = 0;
  const cudaError_t e =
      dkv ? active_clusters<Xch<NS>>(attn_bwd_dkv_cluster_kernel<NS>, D, &n)
          : active_clusters<Xch<NS>>(attn_bwd_dq_cluster_kernel<NS>, D, &n);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// ---- head dims past 4096: the band form ------------------------------------
//
// B10 and B11 at D > 4096 (past the cluster form above) on the same
// 3xTF32 products, as five D-long matrix products: S and dP formed once a
// tile over the whole head dim, kept in a workspace in device memory, and
// read back by the second products. A band of R query rows at a time
// (band_rows: all of Sq where the workspace fits in q's own words, else
// the largest multiple of BT that does), each band two launches:
//   the score pass (attn_bwd_band_score_kernel): grid (the band's visible
//   tiles of BTQ queries x BT keys, B*H); tiles wholly above the causal
//   diagonal are not in the grid, and a warp whose 32 x 32 pairs are all
//   hidden skips its products. Each block forms S = Q K^T and dP = dO V^T
//   over the head dim in chunks of BCH columns (BSTAGE cp.async stages of
//   the four operands' chunks), each chunk's product in a fresh
//   accumulator added to the running sum in f32, then P = exp(scale*S -
//   LSE) and dS = P*(dP - delta) under the mask, and stores them: B10 P^T
//   and dS^T as [bh][key][row of the band], B11 dS as [bh][row][key];
//   positions past Sq, Skv or the mask are zeros;
//   the product pass: B10 (attn_bwd_band_dkv_kernel) dV = P^T dO and dK =
//   scale * dS^T Q over grid (BOUT-column tiles, BT-key tiles, B*H), four
//   warps a product, loops over the band's rows that see the key tile in
//   steps of SROWS; B11 (attn_bwd_band_dq_kernel) dQ = scale * dS K over
//   grid (BOUT-column tiles, BT-row tiles of the band, B*H), loops over the
//   keys the rows see in steps of SROWS. Each step's product is summed in
//   a fresh accumulator and added in f32.
// Every warp holds 32 rows of its products (two 16-row tiles on the same
// B fragments, split once for both): a 3xTF32 operand is split in
// registers, so the larger warp tile splits and reads each B element half
// as often. The score pass's tiles and the product pass's steps cover the
// same visible tiles (a key tile's first step lies in a tile that sees
// it), so nothing reads a tile that was not formed. With several bands
// B10 stores on the first and adds in f32 on each later one that sees the
// key tile, in band order; B11's bands own disjoint rows. So every run
// gives the same bits. The workspace comes from the caller (band_words
// floats a head); the kernels allocate nothing. The tile, chunk and step
// sizes and the products: attention_band.cuh.

// a score stage: Q and dO chunks (BTQ rows), K and V chunks (BT rows)
constexpr int BAND_SCORE_STAGE = 2 * (BTQ + BT) * BCP;
constexpr int BAND_SCORE_BYTES = (BSTAGE * BAND_SCORE_STAGE + 2 * BTQ) * 4;
// a product step: two BT x SROWS tiles of the workspace, two SROWS x BOUT
// operand tiles (B10); one and one (B11); two stages each
constexpr int BAND_DKV_STAGE = 2 * BT * BCP + 2 * SROWS * BOP;
constexpr int BAND_DQ_STAGE = BT * BCP + SROWS * BOP;
constexpr int BAND_DKV_BYTES = 2 * BAND_DKV_STAGE * 4;
constexpr int BAND_DQ_BYTES = 2 * BAND_DQ_STAGE * 4;
static_assert(BAND_SCORE_BYTES <= MAX_SMEM, "a block's shared memory");

// the workspace's floats a head for a band of R rows: B10 (dkv) two
// buffers of Skv rows at a pitch of round4(R); B11 one of R rows at a
// pitch of round4(Skv)
__host__ __device__ constexpr long long band_words(int dkv, int R, int Skv) {
  return dkv ? 2LL * Skv * round4(R) : static_cast<long long>(R) * round4(Skv);
}
// the rows a band: Sq where the workspace fits in q's own words (Sq * D a
// head), else the largest multiple of BT that fits, at least min(Sq, BT)
__host__ __device__ constexpr int band_rows(int dkv, int Sq, int Skv, int D) {
  const long long budget = static_cast<long long>(Sq) * D;
  if (band_words(dkv, Sq, Skv) <= budget) return Sq;
  const long long r = budget / (dkv ? 2LL * Skv : round4(Skv)) / BT * BT;
  const int lo = Sq < BT ? Sq : BT;
  return r < lo ? lo : r > Sq ? Sq : static_cast<int>(r);
}
// the key tiles that a query tile from row q0 (nq rows) sees
__host__ __device__ inline int band_keys(int q0, int nq, int Skv,
                                         int causal) {
  const int nkt = (Skv + BT - 1) / BT;
  const int seen = (q0 + nq - 1) / BT + 1;
  return causal && seen < nkt ? seen : nkt;
}
// the visible tiles of the band of nr rows from r0
static int band_tiles(int r0, int nr, int Skv, int causal) {
  int n = 0;
  for (int q0 = r0; q0 < r0 + nr; q0 += BTQ)
    n += band_keys(q0, r0 + nr - q0 < BTQ ? r0 + nr - q0 : BTQ, Skv, causal);
  return n;
}

// The score pass over the band of nr rows from r0: grid (visible tiles,
// B*H). DKV: B10's P^T into wp and dS^T into wd at bh*bhs + key*pitch +
// row; else B11's dS into wd at bh*bhs + row*pitch + key (rows of the
// band). Operands as attn_bwd_dkv_kernel's. Warp w holds rows 32*(w/2)
// and keys 32*(w%2) of the tile.
template <bool DKV>
__global__ void __launch_bounds__(NT, 1)
attn_bwd_band_score_kernel(const float* __restrict__ q,
                           const float* __restrict__ dout,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ wp, float* __restrict__ wd,
                           int H, int Hkv, int Sq, int Skv, int causal, int D,
                           float scale, int r0, int nr, int pitch,
                           long long bhs) {
  extern __shared__ __align__(16) float smem[];
  float* sStat = smem + BSTAGE * BAND_SCORE_STAGE;  // LSE, then delta
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = tid >> 5;
  const int qw = 32 * (warp >> 1), kw = 32 * (warp & 1);  // the warp's
                                                          // rows and keys
  const int bh = blockIdx.y;
  // the tile: query tiles in order, each its visible key tiles
  int q0 = r0, kt = blockIdx.x;
  for (;;) {
    const int n = band_keys(q0, min(BTQ, r0 + nr - q0), Skv, causal);
    if (kt < n) break;
    kt -= n;
    q0 += BTQ;
  }
  const int k0 = kt * BT;
  const int nq = min(BTQ, r0 + nr - q0), nk = min(BT, Skv - k0);
  // warp-uniform: do the warp's rows see one of its keys?
  const bool live =
      qw < nq && kw < nk && (!causal || k0 + kw <= q0 + qw + 31);
  const long long kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const long long qoff = (static_cast<long long>(bh) * Sq + q0) * D;
  const long long koff = (kvrow * Skv + k0) * D;
  const int nch = (D + BCH - 1) / BCH;

  // stage s: Q, dO (BTQ rows), then K, V (BT rows)
  auto load = [&](int c) {
    const int col = c * BCH;
    float* s = smem + (c % BSTAGE) * BAND_SCORE_STAGE;
    cp_rows<BCH, BTQ, BCP, NT>(s, q + qoff + col, nq, D - col, D);
    cp_rows<BCH, BTQ, BCP, NT>(s + BTQ * BCP, dout + qoff + col, nq,
                               D - col, D);
    cp_rows<BCH, BT, BCP, NT>(s + 2 * BTQ * BCP, k + koff + col, nk, D - col,
                              D);
    cp_rows<BCH, BT, BCP, NT>(s + (2 * BTQ + BT) * BCP, v + koff + col, nk,
                              D - col, D);
  };
  {
    const int r = tid % BTQ;
    const bool ok = r < nq;
    cp_async4(sStat + tid,
              (tid < BTQ ? lse : delta) + static_cast<long long>(bh) * Sq +
                  q0 + (ok ? r : 0),
              ok);
  }
  static_assert(2 * BTQ == NT, "a thread for each row's LSE and delta");
#pragma unroll
  for (int c = 0; c < BSTAGE - 1; ++c) {
    if (c < nch) load(c);
    cp_async_commit();
  }

  float x[2][4][4], y[2][4][4];  // S, then P; dP, then dS: rows
                                 // qw+16m+g, +8, keys kw+8j+2t, +1
#pragma unroll
  for (int mm = 0; mm < 2; ++mm) zero_tile(x[mm], y[mm]);
  for (int c = 0; c < nch; ++c) {
    __syncthreads();  // every warp is done with the stage chunk c+2 takes
    if (c + BSTAGE - 1 < nch) load(c + BSTAGE - 1);
    cp_async_commit();
    cp_async_wait<BSTAGE - 1>();  // chunk c (and the stats) landed
    __syncthreads();
    if (live) {
      const float* s = smem + (c % BSTAGE) * BAND_SCORE_STAGE;
      add_rows32_x_rows32<BCH>(s + qw * BCP, s + (2 * BTQ + kw) * BCP, x);
      add_rows32_x_rows32<BCH>(s + (BTQ + qw) * BCP,
                               s + (2 * BTQ + BT + kw) * BCP, y);
    }
  }
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = qw + 16 * mm + g + 8 * (e >> 1);
        const int key = kw + 8 * j + 2 * t + (e & 1);
        const bool ok =
            r < nq && key < nk && (!causal || k0 + key <= q0 + r);
        const float p =
            ok ? expf(__fsub_rn(__fmul_rn(x[mm][j][e], scale), sStat[r]))
               : 0.0f;
        const float ds = __fmul_rn(p, __fsub_rn(y[mm][j][e], sStat[BTQ + r]));
        // rows and keys past the ends as zeros up to the pitch, which the
        // product pass reads in 16-byte pieces
        const int row = q0 - r0 + r, kk = k0 + key;
        if (DKV) {
          if (kk < Skv && row < pitch) {
            const long long o =
                bh * bhs + static_cast<long long>(kk) * pitch + row;
            wp[o] = p;
            wd[o] = ds;
          }
        } else if (row < nr && kk < pitch) {
          wd[bh * bhs + static_cast<long long>(row) * pitch + kk] = ds;
        }
      }
}

// B10's product pass over the band of nr rows from r0: grid (BOUT-column
// tiles, BT-key tiles, B*H). Warps 0-3 dV = P^T dO, warps 4-7 dK = scale *
// dS^T Q, each 32 keys x 64 columns. add: a later band, added to dk and dv
// (and a key tile no row of the band sees is left as it is).
__global__ void __launch_bounds__(NT, 1)
attn_bwd_band_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ dout,
                         const float* __restrict__ wp,
                         const float* __restrict__ wd, float* __restrict__ dk,
                         float* __restrict__ dv, int Sq, int Skv, int causal,
                         int D, float scale, int r0, int nr, int pitch,
                         long long bhs, int add) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = tid >> 5, dkw = warp >> 2;  // dkw: the warp makes dK
  const int kw = 32 * ((warp >> 1) & 1), cw = (BOUT / 2) * (warp & 1);
  const int c0 = blockIdx.x * BOUT, k0 = blockIdx.y * BT, bh = blockIdx.z;
  const int nk = min(BT, Skv - k0), end = r0 + nr;
  // under the causal mask rows before k0 see none of these keys
  const int first = causal ? max(r0, k0) : r0;
  const int n_it = first < end ? (end - first + SROWS - 1) / SROWS : 0;
  if (add && n_it == 0) return;
  const float* wpk = wp + bh * bhs + static_cast<long long>(k0) * pitch;
  const float* wdk = wd + bh * bhs + static_cast<long long>(k0) * pitch;

  // stage s: P^T, dS^T (BT x SROWS), then dO, Q (SROWS x BOUT)
  auto load = [&](int it) {
    const int r = first + it * SROWS, n = min(SROWS, end - r);
    float* s = smem + (it & 1) * BAND_DKV_STAGE;
    const long long off = (static_cast<long long>(bh) * Sq + r) * D + c0;
    cp_rows<SROWS, BT, BCP, NT>(s, wpk + (r - r0), nk, end - r, pitch);
    cp_rows<SROWS, BT, BCP, NT>(s + BT * BCP, wdk + (r - r0), nk, end - r,
                                pitch);
    cp_rows<BOUT, SROWS, BOP, NT>(s + 2 * BT * BCP, dout + off, n, D - c0, D);
    cp_rows<BOUT, SROWS, BOP, NT>(s + 2 * BT * BCP + SROWS * BOP, q + off, n,
                                  D - c0, D);
  };
  if (n_it > 0) load(0);
  cp_async_commit();

  float acc[2][BOUT / 16][4];  // keys kw+16m+g, +8; columns c0+cw+8c+2t, +1
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int c = 0; c < BOUT / 16; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mm][c][e] = 0.0f;
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this step landed
    __syncthreads();
    const float* s = smem + (it & 1) * BAND_DKV_STAGE;
    band_accumulate<BOUT / 2>(s + (dkw * BT + kw) * BCP,
                              s + 2 * BT * BCP + dkw * SROWS * BOP + cw, acc);
    __syncthreads();  // every warp is done with the stage before it reloads
  }
  cp_async_wait<0>();
  float* out = dkw ? dk : dv;
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = kw + 16 * mm + g + 8 * h;
      if (key >= nk) continue;
      float* o = out + (static_cast<long long>(bh) * Skv + k0 + key) * D +
                 c0 + cw + 2 * t;
#pragma unroll
      for (int c = 0; c < BOUT / 16; ++c) {
        if (c0 + cw + 8 * c >= D) continue;
        const float a0 = acc[mm][c][2 * h], a1 = acc[mm][c][2 * h + 1];
        float2 val = dkw ? make_float2(__fmul_rn(a0, scale),
                                       __fmul_rn(a1, scale))
                         : make_float2(a0, a1);
        float2* p = reinterpret_cast<float2*>(o + 8 * c);
        if (add) {
          const float2 was = *p;
          val = make_float2(__fadd_rn(was.x, val.x), __fadd_rn(was.y, val.y));
        }
        *p = val;
      }
    }
}

// B11's product pass over the band of nr rows from r0: grid (BOUT-column
// tiles, BT-row tiles of the band, B*H). Each warp dQ = scale * dS K for
// 32 rows and a quarter of the tile's columns.
__global__ void __launch_bounds__(NT, 1)
attn_bwd_band_dq_kernel(const float* __restrict__ k,
                        const float* __restrict__ wd, float* __restrict__ dq,
                        int H, int Hkv, int Sq, int Skv, int causal, int D,
                        float scale, int r0, int nr, int pitch,
                        long long bhs) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = tid >> 5, qw = 32 * (warp >> 2);
  const int c0 = blockIdx.x * BOUT, cw = (BOUT / 4) * (warp & 3);
  const int q0 = r0 + blockIdx.y * BT, bh = blockIdx.z;
  const int nq = min(BT, r0 + nr - q0);
  const long long kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  // the keys the tile's rows see: to its last row under the causal mask
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;
  const int n_it = (kv_end + SROWS - 1) / SROWS;
  const float* wdq = wd + bh * bhs + static_cast<long long>(q0 - r0) * pitch;

  // stage s: dS (BT x SROWS), then K (SROWS x BOUT)
  auto load = [&](int it) {
    const int kt0 = it * SROWS, n = min(SROWS, kv_end - kt0);
    float* s = smem + (it & 1) * BAND_DQ_STAGE;
    cp_rows<SROWS, BT, BCP, NT>(s, wdq + kt0, nq, kv_end - kt0, pitch);
    cp_rows<BOUT, SROWS, BOP, NT>(
        s + BT * BCP, k + (kvrow * Skv + kt0) * D + c0, n, D - c0, D);
  };
  if (n_it > 0) load(0);
  cp_async_commit();

  float acc[2][BOUT / 32][4];  // rows qw+16m+g, +8; columns c0+cw+8c+2t, +1
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int c = 0; c < BOUT / 32; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mm][c][e] = 0.0f;
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this step landed
    __syncthreads();
    const float* s = smem + (it & 1) * BAND_DQ_STAGE;
    band_accumulate<BOUT / 4>(s + qw * BCP, s + BT * BCP + cw, acc);
    __syncthreads();  // every warp is done with the stage before it reloads
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = qw + 16 * mm + g + 8 * h;
      if (r >= nq) continue;
      float* o = dq + (static_cast<long long>(bh) * Sq + q0 + r) * D + c0 +
                 cw + 2 * t;
#pragma unroll
      for (int c = 0; c < BOUT / 32; ++c)
        if (c0 + cw + 8 * c < D)
          *reinterpret_cast<float2*>(o + 8 * c) =
              make_float2(__fmul_rn(acc[mm][c][2 * h], scale),
                          __fmul_rn(acc[mm][c][2 * h + 1], scale));
    }
}

// B10 (dkv) or B11 on the band form at any head dim past 256, the
// workspace ws of B*H*band_words(dkv, band_rows(...), Skv) floats from
// the caller; each band a score pass and a product pass, in band order
cudaError_t launch_band(int dkv, const float* q, const float* dout,
                        const float* k, const float* v, const float* lse,
                        const float* delta, float* o0, float* o1, float* ws,
                        int B, int H, int Hkv, int Sq, int Skv, int causal,
                        int D, float scale, cudaStream_t st) {
  if (ws == nullptr) return cudaErrorInvalidValue;
  auto score = dkv ? attn_bwd_band_score_kernel<true>
                   : attn_bwd_band_score_kernel<false>;
  cudaError_t e = allow_smem(score, BAND_SCORE_BYTES);
  if (e == cudaSuccess)
    e = dkv ? allow_smem(attn_bwd_band_dkv_kernel, BAND_DKV_BYTES)
            : allow_smem(attn_bwd_band_dq_kernel, BAND_DQ_BYTES);
  if (e != cudaSuccess) return e;
  const int R = band_rows(dkv, Sq, Skv, D);
  const int pitch = dkv ? round4(R) : round4(Skv);
  const long long bhs = band_words(dkv, R, Skv) / (dkv ? 2 : 1);
  float* wp = ws;  // B10: P^T, then dS^T; B11: dS
  float* wd = dkv ? ws + B * H * bhs : ws;
  const int nb = R > 0 ? (Sq + R - 1) / R : 0;
  const int ct = (D + BOUT - 1) / BOUT;
  for (int b = 0; b < (nb > 0 ? nb : 1); ++b) {
    const int r0 = b * R, nr = Sq - r0 < R ? Sq - r0 : R;
    const int tiles = nr > 0 ? band_tiles(r0, nr, Skv, causal) : 0;
    if (tiles > 0)
      score<<<dim3(tiles, B * H), NT, BAND_SCORE_BYTES, st>>>(
          q, dout, k, v, lse, delta, wp, wd, H, Hkv, Sq, Skv, causal, D,
          scale, r0, nr, pitch, bhs);
    if (dkv)
      attn_bwd_band_dkv_kernel<<<dim3(ct, (Skv + BT - 1) / BT, B * H), NT,
                                 BAND_DKV_BYTES, st>>>(
          q, dout, wp, wd, o0, o1, Sq, Skv, causal, D, scale, r0, nr, pitch,
          bhs, b > 0);
    else if (nr > 0)
      attn_bwd_band_dq_kernel<<<dim3(ct, (nr + BT - 1) / BT, B * H), NT,
                                BAND_DQ_BYTES, st>>>(
          k, wd, o0, H, Hkv, Sq, Skv, causal, D, scale, r0, nr, pitch, bhs);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  set_attn_route(dkv ? ROUTE_BWD_DKV_TF32_BAND : ROUTE_BWD_DQ_TF32_BAND, 0,
                 BOUT);
  return cudaSuccess;
}

template <int DP>
cudaError_t launch_bwd_dkv(const void* q, const void* dout, const void* k,
                           const void* v, const void* lse, const void* delta,
                           void* dk, void* dv, int B, int H, int Hkv, int Sq,
                           int Skv, int causal, int D, float scale,
                           cudaStream_t st) {
  using L = BwdSmem<DP>;
  auto kern = attn_bwd_dkv_kernel<DP>;
  cudaError_t e = allow_smem(kern, L::BYTES);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (Skv + L::RROWS - 1) / L::RROWS);
  kern<<<grid, NT, L::BYTES, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(dout),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv, Sq, Skv,
      causal, D, scale);
  e = cudaGetLastError();
  if (e == cudaSuccess) set_attn_route(ROUTE_BWD_DKV_TF32, 0, DP);
  return e;
}

template <int DP>
cudaError_t launch_bwd_dq(const void* q, const void* dout, const void* k,
                          const void* v, const void* lse, const void* delta,
                          void* dq, int B, int H, int Hkv, int Sq, int Skv,
                          int causal, int D, float scale, cudaStream_t st) {
  using L = BwdSmem<DP>;
  auto kern = attn_bwd_dq_kernel<DP>;
  cudaError_t e = allow_smem(kern, L::BYTES);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (Sq + L::RROWS - 1) / L::RROWS);
  kern<<<grid, NT, L::BYTES, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(dout),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, Hkv, Sq, Skv, causal, D, scale);
  e = cudaGetLastError();
  if (e == cudaSuccess) set_attn_route(ROUTE_BWD_DQ_TF32, 0, DP);
  return e;
}

}  // namespace

// the 16-bit route (attention_bwd_sm90.cu; dtype 1 bf16, 2 f16)
int attn_bwd_dkv_wgmma(int dtype, int head_dim, const void* q,
                       const void* dout, const void* k, const void* v,
                       const void* lse, const void* delta, void* dk, void* dv,
                       int B, int H, int Hkv, int Sq, int Skv, int causal,
                       float scale, cudaStream_t st);
int attn_bwd_dq_wgmma(int dtype, int head_dim, const void* q,
                      const void* dout, const void* k, const void* v,
                      const void* lse, const void* delta, void* dq, int B,
                      int H, int Hkv, int Sq, int Skv, int causal,
                      float scale, cudaStream_t st);

static const float* F(const void* p) { return static_cast<const float*>(p); }

extern "C" {

// dtype 0 f32, 1 bf16, 2 f16; head_dim a multiple of 8 (f32 past 256: the
// cluster kernels, past 4096 the band form on the workspace ws of
// B*H*band_words(...) floats; ws is used only there)
int accl_attn_bwd_dkv(int dtype, int head_dim, const void* q,
                      const void* dout, const void* k, const void* v,
                      const void* lse, const void* delta, void* dk, void* dv,
                      void* ws, int B, int H, int Hkv, int Sq, int Skv,
                      int causal, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (head_dim % 8 || head_dim < 8) return cudaErrorInvalidValue;
  if (dtype == 1 || dtype == 2)
    return attn_bwd_dkv_wgmma(dtype, head_dim, q, dout, k, v, lse, delta, dk,
                              dv, B, H, Hkv, Sq, Skv, causal, scale, st);
  if (dtype != 0) return cudaErrorInvalidValue;
  if (cluster_form(head_dim)) {
    CLUSTER_NS_DISPATCH(launch_dkv_cluster, head_dim, F(q), F(dout), F(k),
                        F(v), F(lse), F(delta), static_cast<float*>(dk),
                        static_cast<float*>(dv), B, H, Hkv, Sq, Skv, causal,
                        head_dim, scale, st)
  }
  if (head_dim > CLUSTER_MAX_D)
    return launch_band(1, F(q), F(dout), F(k), F(v), F(lse), F(delta),
                       static_cast<float*>(dk), static_cast<float*>(dv),
                       static_cast<float*>(ws), B, H, Hkv, Sq, Skv, causal,
                       head_dim, scale, st);
  F32_DISPATCH(launch_bwd_dkv, q, dout, k, v, lse, delta, dk, dv, B, H, Hkv,
               Sq, Skv, causal, head_dim, scale, st)
}

int accl_attn_bwd_dq(int dtype, int head_dim, const void* q,
                     const void* dout, const void* k, const void* v,
                     const void* lse, const void* delta, void* dq, void* ws,
                     int B, int H, int Hkv, int Sq, int Skv, int causal,
                     float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (head_dim % 8 || head_dim < 8) return cudaErrorInvalidValue;
  if (dtype == 1 || dtype == 2)
    return attn_bwd_dq_wgmma(dtype, head_dim, q, dout, k, v, lse, delta, dq,
                             B, H, Hkv, Sq, Skv, causal, scale, st);
  if (dtype != 0) return cudaErrorInvalidValue;
  if (cluster_form(head_dim)) {
    CLUSTER_NS_DISPATCH(launch_dq_cluster, head_dim, F(q), F(dout), F(k),
                        F(v), F(lse), F(delta), static_cast<float*>(dq), B,
                        H, Hkv, Sq, Skv, causal, head_dim, scale, st)
  }
  if (head_dim > CLUSTER_MAX_D)
    return launch_band(0, F(q), F(dout), F(k), F(v), F(lse), F(delta),
                       static_cast<float*>(dq), nullptr,
                       static_cast<float*>(ws), B, H, Hkv, Sq, Skv, causal,
                       head_dim, scale, st);
  F32_DISPATCH(launch_bwd_dq, q, dout, k, v, lse, delta, dq, B, H, Hkv, Sq,
               Skv, causal, head_dim, scale, st)
}

// The f32 B10 (accl_attn_bwd_dkv_band) and B11 on the band form at any
// head dim past 256 (measurements beside the dispatch's choice), as
// accl_attn_bwd_dkv and accl_attn_bwd_dq with dtype 0
int accl_attn_bwd_dkv_band(int dtype, int head_dim, const void* q,
                           const void* dout, const void* k, const void* v,
                           const void* lse, const void* delta, void* dk,
                           void* dv, void* ws, int B, int H, int Hkv, int Sq,
                           int Skv, int causal, float scale, void* stream) {
  if (dtype != 0 || head_dim % 8 || head_dim <= 256)
    return cudaErrorInvalidValue;
  return launch_band(1, F(q), F(dout), F(k), F(v), F(lse), F(delta),
                     static_cast<float*>(dk), static_cast<float*>(dv),
                     static_cast<float*>(ws), B, H, Hkv, Sq, Skv, causal,
                     head_dim, scale, static_cast<cudaStream_t>(stream));
}
int accl_attn_bwd_dq_band(int dtype, int head_dim, const void* q,
                          const void* dout, const void* k, const void* v,
                          const void* lse, const void* delta, void* dq,
                          void* ws, int B, int H, int Hkv, int Sq, int Skv,
                          int causal, float scale, void* stream) {
  if (dtype != 0 || head_dim % 8 || head_dim <= 256)
    return cudaErrorInvalidValue;
  return launch_band(0, F(q), F(dout), F(k), F(v), F(lse), F(delta),
                     static_cast<float*>(dq), nullptr,
                     static_cast<float*>(ws), B, H, Hkv, Sq, Skv, causal,
                     head_dim, scale, static_cast<cudaStream_t>(stream));
}

// the blocks of a cluster of the f32 cluster form at head_dim (for
// reports): 0 where B10 and B11 do not take that form
int accl_attn_bwd_cluster_size(int head_dim) {
  return cluster_form(head_dim) ? cluster_size(head_dim) : 0;
}

// the clusters of the f32 cluster form (B10 if dkv, else B11) at head_dim
// that the card holds at once (for reports): 0 where B10 and B11 do not
// take that form, minus the CUDA error code if the query fails
int accl_attn_bwd_active_clusters(int dkv, int head_dim) {
  if (!cluster_form(head_dim)) return 0;
  CLUSTER_NS_DISPATCH(active_of, head_dim, dkv, head_dim)
}

}  // extern "C"
