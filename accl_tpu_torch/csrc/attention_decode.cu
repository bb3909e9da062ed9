// Kernel B12's single-token decode (S_new == 1) as split-KV on the CUDA
// cores (CUDA C++, sm_90a), f32, bf16 and f16.
//
// Replaces accl_tpu/ops/attention.py _decode_kernel (pallas_call at :689)
// for one new token: q (B, H, 1, D); the cache (B, T, Hkv, D) in its
// native layout, keys 0 .. kv_len-1 and nothing at or past kv_len read;
// GQA by index (the group = H / Hkv q heads of one kv head share its K
// and V); O in q's dtype. accl_attn_decode (attention.cu) sends every
// S_new == 1 launch at head dims up to DECODE_SPLIT_MAX_D here, every
// dtype (past 256 the wide kernel below), and the f32 ones past it (the
// band decode at the end of this file); chunks of S_new > 1 keep their
// routes there.
//
// Bound on an H100: a step reads the filled prefix once, 2 * kv_len * D
// elements per (b, kv head), and does 4 * D operations per (q row, key):
// at D = 128 and a group of 4, 2048 f32 operations per 512 bytes of bf16
// K and V, 4 per byte against the card's 20 (67 TFLOP/s f32 over 3.35
// TB/s), so it is bound by bytes: at B = 4, Hkv = 8, kv_len 2047, 33.5 MB
// in 10 us. The tensor cores buy nothing here; the arithmetic stays f32
// on the CUDA cores.
//
// What the design does about it (flash-decoding):
// - Split the keys. The grid is (n_split, Hkv * group chunks, B): n_split
//   blocks per (b, kv head), each over keys [s*c, min((s+1)*c, kv_len))
//   with c = ceil(kv_len / n_split) rounded up to 64 keys. n_split comes
//   from the caller (ops/attention.py decode_splits: B, Hkv, T and the SM
//   count, never kv_len), so the launch geometry does not depend on
//   kv_len: each block derives its range from kv_len here, and a split
//   whose range is empty writes an empty partial (m = finfo.min, l = 0).
// - Inside a block (4 warps): the group's q rows (GR of them, 4 for
//   Llama-3-8B) sit in registers as f32, each lane holding CPL chunks of
//   16 bytes' worth of columns (one, or two for f32 at 256 columns). K and V rows stream through a 3-stage ring of 16-byte
//   cp.async copies (16 KB a stage, so 32 KB in flight per block and
//   four blocks, 16 warps, an SM: with the cache in L2, as it is when
//   the same step is timed again, the block's chain of shuffles and
//   exponents, not the bytes, sets the pace, and more warps hide it); a
//   row at or past the range end is
//   zero-filled by the copy, never read. Head dims: the kernel is
//   instantiated on power-of-two column tiers DP (16 .. 256) and takes
//   D <= DP (a multiple of 8) at run time: the copies and q's loads fill
//   the columns past D with zeros, which add nothing to a score, and only
//   D columns of a partial or of O are written. LPR = min(DP / (16 /
//   sizeof(T)), 32) lanes share one key (a key slot): their partial dot products meet through a
//   reduce-scatter of warp shuffles that leaves each lane the full scores
//   of GR / lanes of the rows (RowSplit), so each (key, row) exponent is
//   computed once and reaches the other lanes by a shuffle. Each key slot
//   runs its own online softmax (m, l, acc) over its keys, one max and
//   one rescale per stage; the slots' streams merge through shared
//   memory at the end of the block. No padding rows: a block computes
//   exactly its GR rows.
// - Combine, in the same kernel: each block writes its split's partial
//   (m, l, acc) to an f32 workspace that the wrapper allocates (acc (B,
//   Hkv, n_split, group, D), then m and l (B, Hkv, n_split, group)) and
//   takes a ticket from a counter per (b, kv head, row chunk); the last
//   block to arrive merges all n_split partials per q row, M = max m_s,
//   O = sum e^(m_s - M) acc_s / max(sum e^(m_s - M) l_s, 1e-30) (online,
//   eight splits' loads in flight at a time), and sets the counter back to
//   0 for the next launch (the wrapper keeps the counters, zeroed once,
//   per (device, stream)). Chosen over a second kernel: a second launch
//   waits for the first to drain and reads every partial back, where here
//   only the last block of each group does, while the others' loads still
//   stream; and one self-resetting launch is as easy for a CUDA graph to
//   hold. The rule that keeps it right: two launches that may run at once
//   never share counters. The wrapper keeps one set for each (device,
//   stream) (ops/attention.py _split_counters), and launches on one stream
//   run in order, each finding its counters back at zero.
//
// Arithmetic: f32 throughout, explicit fmaf (the library builds with
// --fmad=false), expf and a true division at the end; nothing is rounded
// to 16 bits before the output, so only the summation order differs from
// the plain version (flash_decode_ref). Invalid keys take part in the
// max as finfo(f32).min and contribute p = 0 through the mask.
#include <type_traits>

#include "attention_tile.cuh"

namespace {

constexpr int DNT = 128;         // threads per split block
constexpr int DWARPS = DNT / 32;
constexpr int STAGES = 3;        // depth of the K/V ring
constexpr int SPLIT_TILE = 64;   // a split's key range is a multiple of it
constexpr int BLOCKS_PER_SM = 4; // 48 KB of ring and <= 128 registers each
constexpr int MERGE_CHUNK = 8;   // splits whose partials load at once

template <typename T, int DP>
struct Geo {
  static constexpr int VEC = 16 / sizeof(T);   // elements per 16 bytes
  static constexpr int CH = DP / VEC;          // 16-byte chunks of a row
  static constexpr int LPR = CH < 32 ? CH : 32;  // lanes per key row
  static constexpr int CPL = CH / LPR;         // chunks a lane holds
  static constexpr int VL = CPL * VEC;         // columns a lane holds
  static constexpr int KPW = 32 / LPR;         // keys per warp step
  static constexpr int ROWB = DP * sizeof(T);  // bytes of one key row
  // keys per stage: 64, or fewer so that K and V of a stage fit 16 KB
  static constexpr int KT = 2 * 64 * ROWB <= 16384 ? 64 : 16384 / (2 * ROWB);
  static constexpr int STEPS = KT / (DWARPS * KPW);  // warp steps a stage
  static constexpr int STAGE = 2 * KT * ROWB;        // K rows, then V rows
  static constexpr int STREAMS = DWARPS * KPW;       // lane groups a block
  static_assert(STEPS >= 1 && STEPS * DWARPS * KPW == KT, "geometry");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; with bytes = 0 the destination is
// zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This split's keys [lo, hi) of kv_len (the rule of ops/attention.py
// decode_split_ranges)
__device__ __forceinline__ void split_range(int s, int n_split, int kv_len,
                                            int* lo, int* hi) {
  const int c = ((kv_len + n_split - 1) / n_split + SPLIT_TILE - 1) /
                SPLIT_TILE * SPLIT_TILE;
  *lo = min(s * c, kv_len);
  *hi = min(*lo + c, kv_len);
}

// The LPR lanes of one key split the GR rows' dot products between them
// (a reduce-scatter over shuffles): at each step that halves the rows a
// lane holds, the lane with the step's bit set keeps the upper half; the
// remaining steps add the NR rows left over the lanes that share them.
// After it a lane holds rows row0 .. row0 + NR - 1, bitwise equal in every
// lane that holds them (each step adds the same two values in either
// order), and lane src(g) of the key's lanes is the one of them whose
// remaining bits are 0.
template <int GR, int LPR>
struct RowSplit {
  static constexpr int NR = GR > LPR ? GR / LPR : 1;  // rows a lane holds

  static __device__ __forceinline__ void reduce(float* v, int cc) {
    int nr = GR;
#pragma unroll
    for (int off = LPR / 2; off; off >>= 1) {
      if (nr > NR) {
        const int half = nr / 2;
        const bool up = cc & off;
#pragma unroll
        for (int i = 0; i < half; ++i) {
          const float send = up ? v[i] : v[i + half];
          const float keep = up ? v[i + half] : v[i];
          v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, off));
        }
        nr = half;
      } else {
#pragma unroll
        for (int i = 0; i < NR; ++i)
          v[i] = __fadd_rn(v[i], __shfl_xor_sync(0xffffffffu, v[i], off));
      }
    }
  }
  static __device__ __forceinline__ int row0(int cc) {
    int r = 0, off = LPR / 2;
#pragma unroll
    for (int half = GR / 2; half >= NR && off; half >>= 1, off >>= 1)
      if (cc & off) r += half;
    return r;
  }
  static __device__ __forceinline__ int src(int g) {
    int lane = 0, off = LPR / 2;
#pragma unroll
    for (int half = GR / 2; half >= NR && off; half >>= 1, off >>= 1)
      if (g & half) lane |= off;
    return lane;
  }
};

// grid (n_split, Hkv * group / GR, B). q, o (B, H, 1, D); kc, vc (B, T,
// Hkv, D); partial row ((b * Hkv + h) * n_split + s) * group + g of
// part_m, part_l and (times D) part_acc; counters (B * Hkv * group / GR)
// zero between launches. Rows of D elements (D <= DP).
template <typename T, int DP, int GR>
__global__ void __launch_bounds__(DNT, BLOCKS_PER_SM)
attn_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                         const T* __restrict__ vc, T* __restrict__ o,
                         float* __restrict__ part_m,
                         float* __restrict__ part_l,
                         float* __restrict__ part_acc,
                         unsigned* __restrict__ counters, int H, int Hkv,
                         int Tlen, int kv_len, int D, float scale) {
  using G_ = Geo<T, DP>;
  using RS = RowSplit<GR, G_::LPR>;
  constexpr int VEC = G_::VEC, LPR = G_::LPR, KPW = G_::KPW, NR = RS::NR;
  constexpr int CPL = G_::CPL, VL = G_::VL;
  constexpr int KT = G_::KT, ROWB = G_::ROWB, STEPS = G_::STEPS;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_last;
  const int s = blockIdx.x, n_split = gridDim.x;
  const int group = H / Hkv, chunks = group / GR;
  const int h = blockIdx.y / chunks, g0 = (blockIdx.y % chunks) * GR;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kr = lane / LPR, cc = lane % LPR;  // key slot, 16-byte column
  const int row0 = RS::row0(cc);               // this lane's rows

  int lo, hi;
  split_range(s, n_split, kv_len, &lo, &hi);
  const int ntiles = (hi - lo + KT - 1) / KT;
  const long long kstride = static_cast<long long>(Hkv) * D;
  const long long head = (static_cast<long long>(b) * Tlen * Hkv + h) * D;
  const T* kb = kc + head;
  const T* vb = vc + head;
  const uint32_t sbase = smem_addr(smem);

  // stage t % STAGES <- K and V rows of tile t (zeros past hi); one commit
  // group per call, empty past the last tile, so that the wait counts hold
  auto issue = [&](int t) {
    if (t < ntiles) {
      const int key0 = lo + t * KT;
      const uint32_t dst = sbase + (t % STAGES) * G_::STAGE;
      for (int i = threadIdx.x; i < KT * G_::CH; i += DNT) {
        const int r = i / G_::CH, c = i % G_::CH;
        const bool ok = key0 + r < hi && c * VEC < D;
        const long long off =
            ok ? (key0 + r) * kstride + static_cast<long long>(c) * VEC : 0;
        cp_async16(dst + i * 16, kb + off, ok ? 16 : 0);
        cp_async16(dst + KT * ROWB + i * 16, vb + off, ok ? 16 : 0);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);

  // q and the accumulator: all GR rows, this lane's VL columns (chunks
  // cc, cc + LPR, ..., each VEC columns; zeros past D); the running max
  // and sum: this lane's NR rows
  float qf[GR][VL], acc[GR][VL], m[NR], l[NR];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    const T* qrow =
        q + (static_cast<long long>(b) * H + h * group + g0 + g) * D;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = (cc + j * LPR) * VEC;
      if (c < D) {
        unpack(*reinterpret_cast<const uint4*>(qrow + c), qf[g] + j * VEC,
               T());
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qf[g][j * VEC + e] = 0.0f;
      }
    }
#pragma unroll
    for (int e = 0; e < VL; ++e) acc[g][e] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    m[k] = NEG;
    l[k] = 0.0f;
  }
  const int src0 = kr * LPR;  // the first lane of this key slot

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile t landed; every thread is done with t - 1
    issue(t + STAGES - 1);
    const uint8_t* tk = smem + (t % STAGES) * G_::STAGE;
    const uint8_t* tv = tk + KT * ROWB;
    const int key0 = lo + t * KT;
    // the scores of this lane's rows for the key slot's keys of the tile
    float sc[STEPS][NR], tmax[NR];
#pragma unroll
    for (int k = 0; k < NR; ++k) tmax[k] = NEG;
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int r = warp * (KT / DWARPS) + j * KPW + kr;
      const bool ok = key0 + r < hi;
      float kf[VL], d[GR];
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        unpack(*reinterpret_cast<const uint4*>(tk + r * ROWB +
                                               (cc + j * LPR) * 16),
               kf + j * VEC, T());
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        d[g] = 0.0f;
#pragma unroll
        for (int e = 0; e < VL; ++e) d[g] = fmaf(qf[g][e], kf[e], d[g]);
      }
      RS::reduce(d, cc);
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        sc[j][k] = ok ? __fmul_rn(d[k], scale) : NEG;
        tmax[k] = fmaxf(tmax[k], sc[j][k]);
      }
    }
    // this lane's rows: one rescale per tile, alpha = e^(m_old - m_new),
    // then p = e^(s - m) for each key once (0 past hi)
    float alpha[NR];
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const float m_new = fmaxf(m[k], tmax[k]);
      alpha[k] = expf(__fsub_rn(m[k], m_new));
      m[k] = m_new;
      l[k] = __fmul_rn(l[k], alpha[k]);
    }
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const bool ok = key0 + warp * (KT / DWARPS) + j * KPW + kr < hi;
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        sc[j][k] = ok ? expf(__fsub_rn(sc[j][k], m[k])) : 0.0f;
        l[k] = __fadd_rn(l[k], sc[j][k]);
      }
    }
    // every row's alpha and p from the lane that holds it
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      const float a =
          __shfl_sync(0xffffffffu, alpha[g % NR], src0 + RS::src(g));
#pragma unroll
      for (int e = 0; e < VL; ++e) acc[g][e] = __fmul_rn(acc[g][e], a);
    }
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int r = warp * (KT / DWARPS) + j * KPW + kr;
      float vf[VL];
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        unpack(*reinterpret_cast<const uint4*>(tv + r * ROWB +
                                               (cc + j * LPR) * 16),
               vf + j * VEC, T());
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        const float p =
            __shfl_sync(0xffffffffu, sc[j][g % NR], src0 + RS::src(g));
#pragma unroll
        for (int e = 0; e < VL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it holds the streams now

  // merge the block's key-slot streams, one (row, column) per thread, into
  // this split's partial
  constexpr int NS = G_::STREAMS;
  float* sm_m = reinterpret_cast<float*>(smem);  // NS x GR
  float* sm_l = sm_m + NS * GR;                  // NS x GR
  float* sm_acc = sm_l + NS * GR;                // NS x GR x DP
  const int stream = warp * KPW + kr;
#pragma unroll
  for (int g = 0; g < GR; ++g)
#pragma unroll
    for (int j = 0; j < CPL; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sm_acc[(stream * GR + g) * DP + (cc + j * LPR) * VEC + e] =
            acc[g][j * VEC + e];
  if (cc == RS::src(row0)) {
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      sm_m[stream * GR + row0 + k] = m[k];
      sm_l[stream * GR + row0 + k] = l[k];
    }
  }
  __syncthreads();
  const long long prow0 =
      ((static_cast<long long>(b) * Hkv + h) * n_split) * group + g0;
  const long long prow = prow0 + static_cast<long long>(s) * group;
  for (int i = threadIdx.x; i < GR * D; i += DNT) {
    const int g = i / D, d = i % D;
    float M = NEG;
    for (int u = 0; u < NS; ++u) M = fmaxf(M, sm_m[u * GR + g]);
    float L = 0.0f, A = 0.0f;
    for (int u = 0; u < NS; ++u) {
      const float w = expf(__fsub_rn(sm_m[u * GR + g], M));
      L = fmaf(w, sm_l[u * GR + g], L);
      A = fmaf(w, sm_acc[(u * GR + g) * DP + d], A);
    }
    part_acc[(prow + g) * D + d] = A;
    if (d == 0) {
      part_m[prow + g] = M;
      part_l[prow + g] = L;
    }
  }

  // the last split of (b, kv head, row chunk) to arrive merges all
  // n_split partials into O, then resets the counter for the next launch.
  // The barrier makes the block's partial visible to thread 0, whose
  // fence then orders all of it before its ticket (one fence a block).
  __syncthreads();
  const int cidx = blockIdx.z * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(counters + cidx, 1u) == static_cast<unsigned>(
                                                   n_split - 1);
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  // four columns of one row a thread: the splits' (m, l, acc) MERGE_CHUNK
  // at a time in flight, merged online (max, rescale, add) chunk by chunk
  constexpr int MC = MERGE_CHUNK;
  for (int c = threadIdx.x; c < GR * D / 4; c += DNT) {
    const int g = c / (D / 4), d = (c % (D / 4)) * 4;
    const long long r0 = prow0 + g;  // split u's row: r0 + u * group
    float M = NEG, L = 0.0f, a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int u0 = 0; u0 < n_split; u0 += MC) {
      float mu[MC], lu[MC];
      float4 x[MC];
#pragma unroll
      for (int k = 0; k < MC; ++k) {
        // past the last split: its row again, weighted 0
        const long long r =
            r0 + static_cast<long long>(min(u0 + k, n_split - 1)) * group;
        mu[k] = u0 + k < n_split ? __ldcg(part_m + r) : NEG;
        lu[k] = __ldcg(part_l + r);
        x[k] = __ldcg(reinterpret_cast<const float4*>(part_acc + r * D + d));
      }
      float cm = M;
#pragma unroll
      for (int k = 0; k < MC; ++k) cm = fmaxf(cm, mu[k]);
      const float alpha = expf(__fsub_rn(M, cm));
      L = __fmul_rn(L, alpha);
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = __fmul_rn(a[e], alpha);
#pragma unroll
      for (int k = 0; k < MC; ++k) {
        const float w = u0 + k < n_split ? expf(__fsub_rn(mu[k], cm)) : 0.0f;
        L = fmaf(w, lu[k], L);
        a[0] = fmaf(w, x[k].x, a[0]);
        a[1] = fmaf(w, x[k].y, a[1]);
        a[2] = fmaf(w, x[k].z, a[2]);
        a[3] = fmaf(w, x[k].w, a[3]);
      }
      M = cm;
    }
    const float den = fmaxf(L, 1e-30f);
    T* out = o + (static_cast<long long>(b) * H + h * group + g0 + g) * D + d;
#pragma unroll
    for (int e = 0; e < 4; ++e) st(out + e, __fdiv_rn(a[e], den));
  }
  if (threadIdx.x == 0) counters[cidx] = 0u;
}

template <typename T, int DP, int GR>
cudaError_t launch_split(const void* q, const void* kc, const void* vc,
                         void* o, void* ws, void* counters, int B, int H,
                         int Hkv, int Tlen, int kv_len, int n_split,
                         int D, float scale, cudaStream_t st) {
  using G_ = Geo<T, DP>;
  constexpr int ring = STAGES * G_::STAGE;
  constexpr int merge = G_::STREAMS * GR * (DP + 2) * 4;
  constexpr int smem = ring > merge ? ring : merge;
  auto kern = attn_decode_split_kernel<T, DP, GR>;
  // always: with the kernel's static s_last a 48 KB ring passes the
  // default limit
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long rows = static_cast<long long>(B) * H * n_split;
  float* part_acc = static_cast<float*>(ws);  // first: 16-byte rows
  float* part_m = part_acc + rows * D;
  float* part_l = part_m + rows;
  dim3 grid(n_split, Hkv * (H / Hkv / GR), B);
  kern<<<grid, DNT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(o), part_m, part_l,
      part_acc, static_cast<unsigned*>(counters), H, Hkv, Tlen, kv_len, D,
      scale);
  e = cudaGetLastError();
  if (e == cudaSuccess)
    set_attn_route(ROUTE_DECODE_SPLIT,
                   sizeof(T) == 4 ? 0 : std::is_same<T, __half>::value ? 2 : 1,
                   DP);
  return e;
}

// the largest row count of the group that divides it: 4, 2 or 1
template <typename T, int DP>
cudaError_t launch_split_group(const void* q, const void* kc, const void* vc,
                               void* o, void* ws, void* counters, int B,
                               int H, int Hkv, int Tlen, int kv_len,
                               int n_split, int D, float scale,
                               cudaStream_t st) {
  const int group = H / Hkv;
  if (group % 4 == 0)
    return launch_split<T, DP, 4>(q, kc, vc, o, ws, counters, B, H, Hkv,
                                  Tlen, kv_len, n_split, D, scale, st);
  if (group % 2 == 0)
    return launch_split<T, DP, 2>(q, kc, vc, o, ws, counters, B, H, Hkv,
                                  Tlen, kv_len, n_split, D, scale, st);
  return launch_split<T, DP, 1>(q, kc, vc, o, ws, counters, B, H, Hkv, Tlen,
                                kv_len, n_split, D, scale, st);
}

// ---- head dims past 256: the wide split ------------------------------------
//
// Every dtype at 256 < D <= DECODE_SPLIT_MAX_D (2048), where a warp can no
// longer hold its rows' q and accumulator over the whole head dim (GR x D
// floats each: 32 KB at GR 8, D 1024). The grid and the partials are the
// split route's above: (n_split, Hkv * group / GR, B) blocks, each over
// one key range of its (b, kv head), its GR rows of the group, the whole
// head dim; the blocks merge as a tree (merge_tree). Inside a block the
// columns are dealt over the threads, VEC a thread, so that one 16-byte
// cp.async carries a thread's part of a K row and one its part of a V row
// (4 columns of f32, 8 of bf16 or f16): a key slot of DP / VEC threads at
// column tier DP (512, 1024, 2048), thread i of a slot keeping columns
// VEC*i .. VEC*i + VEC - 1 of each row's q and accumulator in registers as
// f32 (2 * GR * VEC floats), and KS slots, each a share of every tile's
// keys, so that more warps share the tile's chain (f32: two to DP 1024,
// one at 2048; 16-bit: 2048 / DP, eight warps a block at every tier). K
// and V rows stream through a 3-stage ring of KT keys a stage (64 KB: 8192
// / DP keys of f32, twice as many of 16 bits), each thread copying and
// reading only its own columns of its slot's keys, so that each key's K
// and V row is read once and the ring needs no barrier of its own. For
// each tile: each thread forms its columns' part of its slot's (key, row)
// dot products, a warp's 32 parts meet through RowSplit's reduce-scatter
// of shuffles, and each warp's sums go to shared memory; block barrier;
// the first GR * KT threads, one a (row, key), add the key's warps' sums
// in warp order, scale and mask, and run the rows' one online softmax (the
// KT threads of a row meet through shuffles and all hold its m and l),
// storing p and the rescale alpha; block barrier; each thread rescales its
// columns and adds p V for its slot's keys. At the end the slots'
// accumulators add in slot order into the split's partial. Arithmetic f32
// on the CUDA cores, as above (q and the cache widened exactly from 16
// bits, the scores, softmax and partials f32; O rounded once to T at the
// root of the merge): the step is bound by bytes.
constexpr int WIDE_STAGES = 3;
constexpr int MERGE_FAN = 8;  // the merge tree's children a node
template <typename T, int DP>
struct Wide {
  static constexpr int VEC = 16 / sizeof(T);  // a thread's columns
  static constexpr int CT = DP / VEC;         // a slot's threads
  static constexpr int KS =                   // key slots
      sizeof(T) == 4 ? (DP <= 1024 ? 2 : 1) : 2048 / DP;
  static constexpr int NTH = KS * CT;
  static constexpr int NW = CT / 32;          // a slot's warps
  static constexpr int ROWB = DP * sizeof(T);  // bytes of a K or V row
  static constexpr int KT = 32768 / ROWB;     // keys a stage: 64 KB of K, V
  static constexpr int KH = KT / KS;          // a slot's keys of a tile
  static constexpr int STAGE = 2 * KT * ROWB;  // bytes: K rows, then V rows
  static_assert(NW >= 1 && KH >= 1 && 32 % KT == 0 && NTH <= 512,
                "geometry");
};
template <typename T, int DP, int GR>
__host__ __device__ constexpr int wide_smem() {
  // the ring, the warps' sums (KT x GR x NW), p (KT x GR), alpha (GR) and
  // the merge's weights and sums ((MERGE_FAN + 2) x GR)
  using W = Wide<T, DP>;
  return WIDE_STAGES * W::STAGE +
         (W::KT * GR * W::NW + W::KT * GR + GR + (MERGE_FAN + 2) * GR) * 4;
}

// four f32 results as T at o (four columns, 16 bytes of f32, 8 of 16 bits)
__device__ __forceinline__ void store4(float* o, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(o) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(o) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}
__device__ __forceinline__ void store4(__half* o, float a, float b, float c,
                                       float d) {
  const __half2 lo = __floats2half2_rn(a, b);
  const __half2 hi = __floats2half2_rn(c, d);
  *reinterpret_cast<uint2*>(o) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// The wide kernel's merge. Its partials are GR x D floats a split (32
// times the narrow kernel's at D 512 and GR 8), too many for one block to
// read in turn, so the splits merge as a tree of fan-in MERGE_FAN: the
// last of a node's children to arrive (a ticket on the node's counter,
// which it sets back to 0 for the next launch) merges their partials, in
// child order, into its first child's slot, and goes up a level; the root
// writes O. A node of children (m_i, l_i, acc_i): M = max m_i, w_i =
// e^(m_i - M), l = sum w_i l_i, acc = sum w_i acc_i, the i in order
// (merge_node), so the bits do not depend on the order of arrival; O =
// acc / max(l, 1e-30). Split u's partial rows: prow0 + u * group + g.

// cnt partials (split slots (first + i) * span) of the GR rows into slot
// first * span, or into O (rounded once to T) if top; sw: (MERGE_FAN + 2)
// * GR floats of shared memory. A thread takes four columns of RW rows at
// a time, the RW * MERGE_FAN loads of them in flight at once.
template <typename T, int GR, int NTH>
__device__ __forceinline__ void merge_node(
    T* __restrict__ o, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, float* sw,
    long long prow0, int group, int first, int cnt, int span, bool top,
    int H, int h, int g0, int b, int D) {
  constexpr int F = MERGE_FAN, RW = GR < 2 ? GR : 2;
  float* sML = sw + F * GR;  // each row's M, then its l
  auto row = [&](int i, int g) {  // child i's partial row g
    return prow0 + static_cast<long long>(first + i) * span * group + g;
  };
  if (threadIdx.x < GR) {
    const int g = threadIdx.x;
    float mu[F], M = NEG;
#pragma unroll
    for (int i = 0; i < F; ++i) {
      mu[i] = i < cnt ? __ldcg(part_m + row(i, g)) : NEG;
      M = fmaxf(M, mu[i]);
    }
    float L = 0.0f;
#pragma unroll
    for (int i = 0; i < F; ++i) {
      if (i >= cnt) break;
      const float w = expf(__fsub_rn(mu[i], M));
      sw[i * GR + g] = w;
      L = fmaf(w, __ldcg(part_l + row(i, g)), L);
    }
    sML[g] = M;
    sML[GR + g] = L;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < GR / RW * (D / 4); c += NTH) {
    const int gr = c / (D / 4) * RW, d = (c % (D / 4)) * 4;
    float4 x[RW][F];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int i = 0; i < F; ++i)  // past the last child: the last again
        x[r][i] = __ldcg(reinterpret_cast<const float4*>(
            part_acc + row(min(i, cnt - 1), gr + r) * D + d));
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int g = gr + r;
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < F; ++i) {
        const float w = i < cnt ? sw[i * GR + g] : 0.0f;
        a[0] = fmaf(w, x[r][i].x, a[0]);
        a[1] = fmaf(w, x[r][i].y, a[1]);
        a[2] = fmaf(w, x[r][i].z, a[2]);
        a[3] = fmaf(w, x[r][i].w, a[3]);
      }
      if (top) {
        const float den = fmaxf(sML[GR + g], 1e-30f);
        store4(o + (static_cast<long long>(b) * H + h * group + g0 + g) * D +
                   d,
               __fdiv_rn(a[0], den), __fdiv_rn(a[1], den),
               __fdiv_rn(a[2], den), __fdiv_rn(a[3], den));
      } else {  // into the first child's slot: this thread read its items
        *reinterpret_cast<float4*>(part_acc + row(0, g) * D + d) =
            make_float4(a[0], a[1], a[2], a[3]);
      }
    }
  }
  if (!top && threadIdx.x < GR) {
    part_m[row(0, threadIdx.x)] = sML[threadIdx.x];
    part_l[row(0, threadIdx.x)] = sML[GR + threadIdx.x];
  }
}

// Split s's block after writing its partial: up the tree while it is the
// last child of its node to arrive. counters: n_split a (b, kv head, row
// chunk) at cidx, a node's at its level's base plus its index.
template <typename T, int GR, int NTH>
__device__ __forceinline__ void merge_tree(
    T* __restrict__ o, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc,
    unsigned* __restrict__ counters, int& s_last, float* sw, long long prow0,
    int group, int s, int n_split, int H, int h, int g0, int b, int D) {
  constexpr int F = MERGE_FAN;
  const long long cidx = blockIdx.z * gridDim.y + blockIdx.y;
  int nodes = n_split, j = s, span = 1, base = 0;
  for (;;) {
    const int parents = (nodes + F - 1) / F, parent = j / F;
    const int first = parent * F, cnt = min(F, nodes - first);
    const bool top = parents == 1;
    if (cnt > 1) {
      __syncthreads();  // the block's partial (or merge) is written
      if (threadIdx.x == 0) {
        unsigned* ctr = counters + cidx * n_split + base + parent;
        __threadfence();
        s_last = atomicAdd(ctr, 1u) == static_cast<unsigned>(cnt - 1);
        if (s_last) {
          *ctr = 0u;
          __threadfence();
        }
      }
      __syncthreads();
      if (!s_last) return;
    }
    if (cnt > 1 || top)  // (a lone child below the root passes up as it is)
      merge_node<T, GR, NTH>(o, part_m, part_l, part_acc, sw, prow0, group,
                             first, cnt, span, top, H, h, g0, b, D);
    if (top) return;
    base += parents;
    nodes = parents;
    j = parent;
    span *= F;
  }
}

// grid (n_split, Hkv * group / GR, B); operands and partials as
// attn_decode_split_kernel's, rows of D <= DP elements of T (a multiple
// of 8)
template <typename T, int DP, int GR>
__global__ void __launch_bounds__(Wide<T, DP>::NTH, 1)
attn_decode_split_wide_kernel(const T* __restrict__ q,
                              const T* __restrict__ kc,
                              const T* __restrict__ vc, T* __restrict__ o,
                              float* __restrict__ part_m,
                              float* __restrict__ part_l,
                              float* __restrict__ part_acc,
                              unsigned* __restrict__ counters, int H,
                              int Hkv, int Tlen, int kv_len, int D,
                              float scale) {
  using W = Wide<T, DP>;
  using RS = RowSplit<GR, 32>;
  constexpr int NW = W::NW, KT = W::KT, KH = W::KH, VEC = W::VEC;
  constexpr int ROWB = W::ROWB;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_last;
  // stage i: K rows, then V rows, at smem + i * STAGE
  float* red = reinterpret_cast<float*>(smem + WIDE_STAGES * W::STAGE);
  float* sp = red + KT * GR * NW;   // p: (key, row); red: (key, row, warp)
  float* salpha = sp + KT * GR;     // alpha: row
  float* smerge = salpha + GR;      // the merge's weights
  const int s = blockIdx.x, n_split = gridDim.x;
  const int group = H / Hkv, chunks = group / GR;
  const int h = blockIdx.y / chunks, g0 = (blockIdx.y % chunks) * GR;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int slot = tid / W::CT, wslot = (tid >> 5) % NW;  // key slot, warp
  const int c = VEC * (tid % W::CT);             // this thread's columns
  const int k0 = slot * KH;                      // its keys of a tile
  const int rrow = RS::row0(lane);               // the row a lane sums

  int lo, hi;
  split_range(s, n_split, kv_len, &lo, &hi);
  const int ntiles = (hi - lo + KT - 1) / KT;
  const long long kstride = static_cast<long long>(Hkv) * D;
  const long long head = (static_cast<long long>(b) * Tlen * Hkv + h) * D;
  const T* kb = kc + head;
  const T* vb = vc + head;
  const uint32_t sbase = smem_addr(smem);

  // stage t % STAGES <- this thread's columns of its slot's keys of tile
  // t's K and V rows (zeros past hi or D); one commit group a call, empty
  // past the last tile
  auto issue = [&](int t) {
    if (t < ntiles) {
      const int key0 = lo + t * KT + k0;
      const uint32_t dst = sbase + (t % WIDE_STAGES) * W::STAGE +
                           k0 * ROWB + c * static_cast<int>(sizeof(T));
#pragma unroll
      for (int r = 0; r < KH; ++r) {
        const bool ok = key0 + r < hi && c < D;
        const long long off = ok ? (key0 + r) * kstride + c : 0;
        cp_async16(dst + r * ROWB, kb + off, ok ? 16 : 0);
        cp_async16(dst + (KT + r) * ROWB, vb + off, ok ? 16 : 0);
      }
    }
    cp_commit();
  };
  issue(0);
  issue(1);

  float qf[GR][VEC], acc[GR][VEC];  // this thread's columns of each row
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    if (c < D) {
      unpack(*reinterpret_cast<const uint4*>(
                 q + (static_cast<long long>(b) * H + h * group + g0 + g) *
                         D + c),
             qf[g], T());
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qf[g][e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.0f;
  }
  // the softmax threads: (row srow, key skey) for tid < GR * KT, in the
  // first warps; the KT threads of a row are neighbours in one warp
  const bool soft = tid < GR * KT;
  const int srow = soft ? tid / KT : 0, skey = tid % KT;
  const bool soft_warp = (tid >> 5) < (GR * KT + 31) / 32;  // warp-uniform
  float m = NEG, l = 0.0f;  // row srow's, in each of its KT threads

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<1>();  // this thread's copies of tile t landed
    const uint8_t* tk = smem + (t % WIDE_STAGES) * W::STAGE +
                        c * static_cast<int>(sizeof(T));
    const uint8_t* tv = tk + KT * ROWB;
    const int key0 = lo + t * KT;
    // each warp's part of its slot's (key, row) dot products
#pragma unroll
    for (int r = k0; r < k0 + KH; ++r) {
      float kf[VEC], d[GR];
      unpack(*reinterpret_cast<const uint4*>(tk + r * ROWB), kf, T());
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        d[g] = __fmul_rn(qf[g][0], kf[0]);
#pragma unroll
        for (int e = 1; e < VEC; ++e) d[g] = fmaf(qf[g][e], kf[e], d[g]);
      }
      RS::reduce(d, lane);
      if (lane == RS::src(rrow)) red[(r * GR + rrow) * NW + wslot] = d[0];
    }
    __syncthreads();  // the warps' sums are in place; tile t - 1's p, alpha
                      // and ring stage are free
    issue(t + 2);
    if (soft_warp) {
      const int key = key0 + skey;
      const bool ok = soft && key < hi;
      float sc = NEG;
      if (soft) {
        const float* w = red + (skey * GR + srow) * NW;
        float dsum = w[0];
#pragma unroll
        for (int i = 1; i < NW; ++i) dsum = __fadd_rn(dsum, w[i]);
        sc = ok ? __fmul_rn(dsum, scale) : NEG;
      }
      float mx = sc;
#pragma unroll
      for (int off = KT / 2; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx);
      const float p = ok ? expf(__fsub_rn(sc, m_new)) : 0.0f;
      float psum = p;
#pragma unroll
      for (int off = KT / 2; off; off >>= 1)
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, off));
      const float alpha = expf(__fsub_rn(m, m_new));
      l = __fadd_rn(__fmul_rn(l, alpha), psum);
      m = m_new;
      if (soft) {
        sp[skey * GR + srow] = p;
        if (skey == 0) salpha[srow] = alpha;
      }
    }
    __syncthreads();  // p and alpha are in place
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      const float a = salpha[g];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] = __fmul_rn(acc[g][e], a);
    }
#pragma unroll
    for (int r = k0; r < k0 + KH; ++r) {
      float vf[VEC];
      unpack(*reinterpret_cast<const uint4*>(tv + r * ROWB), vf, T());
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        const float p = sp[r * GR + g];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
  cp_wait<0>();

  // this split's partial: slot 0's columns of acc plus the other slots'
  // in slot order (through the ring, free now), the softmax threads of key
  // 0 each row's m and l
  const long long prow0 =
      ((static_cast<long long>(b) * Hkv + h) * n_split) * group + g0;
  const long long prow = prow0 + static_cast<long long>(s) * group;
  float* xs = reinterpret_cast<float*>(smem);  // slot u's at (u - 1) GR DP
  if constexpr (W::KS > 1) {
    __syncthreads();  // every read of the ring is done
    if (slot > 0) {
#pragma unroll
      for (int g = 0; g < GR; ++g)
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(xs + ((slot - 1) * GR + g) * DP + c +
                                     e) =
              make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2],
                          acc[g][e + 3]);
    }
    __syncthreads();
  }
  if (slot == 0 && c < D) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        float4 a = make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2],
                               acc[g][e + 3]);
#pragma unroll
        for (int u = 1; u < W::KS; ++u) {
          const float4 x = *reinterpret_cast<const float4*>(
              xs + ((u - 1) * GR + g) * DP + c + e);
          a = make_float4(__fadd_rn(a.x, x.x), __fadd_rn(a.y, x.y),
                          __fadd_rn(a.z, x.z), __fadd_rn(a.w, x.w));
        }
        *reinterpret_cast<float4*>(part_acc + (prow + g) * D + c + e) = a;
      }
    }
  }
  if (soft && skey == 0) {
    part_m[prow + srow] = m;
    part_l[prow + srow] = l;
  }
  merge_tree<T, GR, W::NTH>(o, part_m, part_l, part_acc, counters, s_last,
                            smerge, prow0, group, s, n_split, H, h, g0, b,
                            D);
}

template <typename T, int DP, int GR>
cudaError_t launch_split_wide(const void* q, const void* kc, const void* vc,
                              void* o, void* ws, void* counters, int B, int H,
                              int Hkv, int Tlen, int kv_len, int n_split,
                              int D, float scale, cudaStream_t st) {
  constexpr int smem = wide_smem<T, DP, GR>();
  auto kern = attn_decode_split_wide_kernel<T, DP, GR>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long rows = static_cast<long long>(B) * H * n_split;
  float* part_acc = static_cast<float*>(ws);  // first: 16-byte rows
  float* part_m = part_acc + rows * D;
  float* part_l = part_m + rows;
  dim3 grid(n_split, Hkv * (H / Hkv / GR), B);
  kern<<<grid, Wide<T, DP>::NTH, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(o), part_m, part_l,
      part_acc, static_cast<unsigned*>(counters), H, Hkv, Tlen, kv_len, D,
      scale);
  e = cudaGetLastError();
  if (e == cudaSuccess)
    set_attn_route(ROUTE_DECODE_SPLIT,
                   sizeof(T) == 4 ? 0 : std::is_same<T, __half>::value ? 2 : 1,
                   DP);
  return e;
}

// the largest row count of the group that divides it: 8, 4, 2 or 1
template <typename T, int DP>
cudaError_t launch_wide_group(const void* q, const void* kc, const void* vc,
                              void* o, void* ws, void* counters, int B, int H,
                              int Hkv, int Tlen, int kv_len, int n_split,
                              int D, float scale, cudaStream_t st) {
  const int group = H / Hkv;
  if (group % 8 == 0)
    return launch_split_wide<T, DP, 8>(q, kc, vc, o, ws, counters, B, H, Hkv,
                                       Tlen, kv_len, n_split, D, scale, st);
  if (group % 4 == 0)
    return launch_split_wide<T, DP, 4>(q, kc, vc, o, ws, counters, B, H, Hkv,
                                       Tlen, kv_len, n_split, D, scale, st);
  if (group % 2 == 0)
    return launch_split_wide<T, DP, 2>(q, kc, vc, o, ws, counters, B, H, Hkv,
                                       Tlen, kv_len, n_split, D, scale, st);
  return launch_split_wide<T, DP, 1>(q, kc, vc, o, ws, counters, B, H, Hkv,
                                     Tlen, kv_len, n_split, D, scale, st);
}

// dtype code (0 f32, 1 bf16, 2 f16) -> the wide split at column tier DP
template <int DP>
cudaError_t launch_wide(int dtype, const void* q, const void* kc,
                        const void* vc, void* o, void* ws, void* counters,
                        int B, int H, int Hkv, int Tlen, int kv_len,
                        int n_split, int D, float scale, cudaStream_t st) {
  switch (dtype) {
    case 0:
      return launch_wide_group<float, DP>(q, kc, vc, o, ws, counters, B, H,
                                          Hkv, Tlen, kv_len, n_split, D,
                                          scale, st);
    case 1:
      return launch_wide_group<__nv_bfloat16, DP>(q, kc, vc, o, ws, counters,
                                                  B, H, Hkv, Tlen, kv_len,
                                                  n_split, D, scale, st);
    case 2:
      return launch_wide_group<__half, DP>(q, kc, vc, o, ws, counters, B, H,
                                           Hkv, Tlen, kv_len, n_split, D,
                                           scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- f32 head dims past DECODE_SPLIT_MAX_D: the band decode ---------------
//
// The single-token decode at f32 head dims past 2048, where the wide split
// above would need more than a block's 1024 threads for one row's 16-byte
// columns. A row's scores are kv_len floats (4 KB at 1023 keys) where K
// and V are kv_len * D each (16.8 MB at D 4104), so the step is two
// streaming passes over the cache with the scores kept in a workspace:
//   the score pass (attn_decode_band_score_kernel): grid (the cache's tiles
//   of BD_KEYS keys, Hkv * group / GR, B), blocks past kv_len returning at
//   once. A block holds its kv head's GR query rows and its tile's keys and
//   loops over the head dim in chunks of BD_CT * VEC columns (512 of f32)
//   through a double-buffered cp.async ring: a thread copies and forms 16
//   bytes of columns of the GR rows against its key group's BD_KEYS /
//   BD_KG keys, summing every chunk into the same f32 accumulators (fmaf,
//   in column order). At the end each warp's sums meet through RowSplit's
//   reduce-scatter, the key group's warps add theirs in warp order, and the
//   GR * BD_KEYS threads of the scores scale and mask them (finfo(f32).min
//   past kv_len) and store them with each row's tile maximum m_t and sum
//   l_t = sum exp(s - m_t);
//   the product pass (attn_decode_band_pv_kernel): grid (BD_SLICE-column
//   slices, n_split key splits, B * Hkv * group / GR), about two blocks an
//   SM. Each block merges its rows' tile stats (a warp a row: M = max m_t,
//   L = sum l_t exp(m_t - M), each lane its tiles in order, then a fixed
//   tree of shuffles: the same order in every block), forms P = exp(s -
//   LSE) for its split's keys in shared memory, and adds P V over them
//   for its slice in four key groups, summed in group order, into a partial
//   of the workspace. The last block of a (b, kv head's rows, slice) to
//   finish (a ticket on its counter, which it sets back to 0) adds the
//   n_split partials in split order into O.
// The grid and the splits depend on the cache's T, not on kv_len
// (ops/attention.py band_decode_splits), so the launch geometry stays the
// same from step to step. The step is bound by bytes: f32 FMAs on the CUDA
// cores, no tensor core. Keys at or past kv_len are never loaded. No float
// atomics: one writer for each element, the sums in fixed orders, so two
// runs on the same inputs are bitwise equal. Written for any T, routed
// for f32 only.
constexpr int BD_KEYS = 8;    // keys of a score tile
constexpr int BD_KG = 2;      // key groups of a score block
constexpr int BD_CT = 128;    // threads of a score key group
constexpr int BD_NT = BD_KG * BD_CT;
constexpr int BD_PKG = 4;     // key groups of a product block
constexpr int BD_PT = 64;     // threads of a product key group
constexpr int BD_PCH = 128;   // keys of P a product block holds at once
constexpr int BD_PNT = BD_PKG * BD_PT;
static_assert(BD_NT == 256 && BD_PNT == 256, "eight warps a block");

template <typename T>
__host__ __device__ constexpr int bd_slice() {  // a product slice's columns
  return BD_PT * (16 / static_cast<int>(sizeof(T)));
}
template <typename T, int GR>
__host__ __device__ constexpr int bd_score_smem() {  // two stages of q, K
  return 2 * (GR + BD_KEYS) * BD_CT * 16;
}
template <typename T, int GR>
__host__ __device__ constexpr int bd_pv_smem() {  // P, the groups' sums
  return (BD_PCH * GR + (BD_PKG - 1) * GR * bd_slice<T>() + GR) * 4;
}

// grid (cache tiles, Hkv * group / GR, B). q (B, H, 1, D); kc (B, T, Hkv,
// D); S (B*H, pitch) and stat (B*H, tiles) float2 of (m, l)
template <typename T, int GR>
__global__ void __launch_bounds__(BD_NT, 2)
attn_decode_band_score_kernel(const T* __restrict__ q,
                              const T* __restrict__ kc,
                              float* __restrict__ S,
                              float2* __restrict__ stat, int H, int Hkv,
                              int Tlen, int kv_len, int D, float scale,
                              int pitch, int tiles) {
  constexpr int VEC = 16 / sizeof(T), KPG = BD_KEYS / BD_KG;
  constexpr int NP = GR * KPG;  // a thread's (row, key) sums
  constexpr int CW = BD_CT * VEC;  // a chunk's columns
  constexpr int ROWB = BD_CT * 16;  // bytes of a chunk's row
  using RS = RowSplit<NP, 32>;
  static_assert(RS::NR == 1, "one (row, key) sum a lane");
  extern __shared__ __align__(16) uint8_t smem[];
  const int key0 = blockIdx.x * BD_KEYS;
  if (key0 >= kv_len) return;
  const int group = H / Hkv, chunks = group / GR;
  const int h = blockIdx.y / chunks, g0 = (blockIdx.y % chunks) * GR;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = tid / BD_CT, ct = tid % BD_CT;
  const long long qrow0 = static_cast<long long>(b) * H + h * group + g0;
  const long long kstride = static_cast<long long>(Hkv) * D;
  const T* kb = kc + (static_cast<long long>(b) * Tlen * Hkv + h) * D +
                key0 * kstride;
  const int nch = (D + CW - 1) / CW;
  const uint32_t sbase = smem_addr(smem);

  // stage c % 2 <- chunk c: the q rows g with g % BD_KG == kg and the key
  // group's keys, this thread's 16 bytes of each (zeros past D or kv_len)
  auto issue = [&](int c) {
    if (c < nch) {
      const int col = c * CW + ct * VEC;
      const bool in = col < D;
      const uint32_t dst = sbase + (c & 1) * (GR + BD_KEYS) * ROWB + ct * 16;
#pragma unroll
      for (int g = kg; g < GR; g += BD_KG)
        cp_async16(dst + g * ROWB, q + (in ? (qrow0 + g) * D + col : 0),
                   in ? 16 : 0);
#pragma unroll
      for (int i = 0; i < KPG; ++i) {
        const int j = kg * KPG + i;
        const bool ok = in && key0 + j < kv_len;
        cp_async16(dst + (GR + j) * ROWB, kb + (ok ? j * kstride + col : 0),
                   ok ? 16 : 0);
      }
    }
    cp_commit();
  };
  issue(0);
  float d[NP];  // rows g, keys kg * KPG + i at g * KPG + i
#pragma unroll
  for (int p = 0; p < NP; ++p) d[p] = 0.0f;
  for (int c = 0; c < nch; ++c) {
    issue(c + 1);
    cp_wait<1>();
    __syncthreads();  // chunk c landed for every thread
    const uint8_t* s = smem + (c & 1) * (GR + BD_KEYS) * ROWB + ct * 16;
    float kf[KPG][VEC];
#pragma unroll
    for (int i = 0; i < KPG; ++i)
      unpack(*reinterpret_cast<const uint4*>(s + (GR + kg * KPG + i) * ROWB),
             kf[i], T());
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      float qf[VEC];
      unpack(*reinterpret_cast<const uint4*>(s + g * ROWB), qf, T());
#pragma unroll
      for (int i = 0; i < KPG; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          d[g * KPG + i] = fmaf(qf[e], kf[i][e], d[g * KPG + i]);
    }
    __syncthreads();  // every thread is done with the stage chunk c+2 takes
  }
  cp_wait<0>();
  // the warp's sums of each (row, key), then the key group's warps in order
  float* red = reinterpret_cast<float*>(smem);  // [warp][NP]
  RS::reduce(d, lane);
  const int p0 = RS::row0(lane);
  if (lane == RS::src(p0)) red[warp * NP + p0] = d[0];
  __syncthreads();
  if (tid < GR * BD_KEYS) {  // (row g, key j): a row's keys in 8 lanes
    // the lanes of warp tid / 32 that take part (all but at GR 1 and 2)
    constexpr unsigned LANES =
        GR * BD_KEYS >= 32 ? 0xffffffffu : (1u << (GR * BD_KEYS)) - 1;
    const int g = tid / BD_KEYS, j = tid % BD_KEYS;
    const int grp = j / KPG, p = g * KPG + j % KPG;
    constexpr int WPG = BD_CT / 32;  // the key group's warps
    float sum = red[grp * WPG * NP + p];
#pragma unroll
    for (int w = 1; w < WPG; ++w)
      sum = __fadd_rn(sum, red[(grp * WPG + w) * NP + p]);
    const bool ok = key0 + j < kv_len;
    const float sc = ok ? __fmul_rn(sum, scale) : NEG;
    float m = sc;
#pragma unroll
    for (int off = BD_KEYS / 2; off; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(LANES, m, off, BD_KEYS));
    float l = ok ? expf(__fsub_rn(sc, m)) : 0.0f;
#pragma unroll
    for (int off = BD_KEYS / 2; off; off >>= 1)
      l = __fadd_rn(l, __shfl_xor_sync(LANES, l, off, BD_KEYS));
    S[(qrow0 + g) * pitch + key0 + j] = sc;
    if (j == 0) stat[(qrow0 + g) * tiles + blockIdx.x] = make_float2(m, l);
  }
}

// grid (slices, n_split, B * Hkv * group / GR). vc (B, T, Hkv, D); o (B,
// H, 1, D); part (B*H, n_split, D) f32; counters (B * Hkv * group / GR *
// slices) zero between launches
template <typename T, int GR>
__global__ void __launch_bounds__(BD_PNT, 2)
attn_decode_band_pv_kernel(const T* __restrict__ vc, T* __restrict__ o,
                           const float* __restrict__ S,
                           const float2* __restrict__ stat,
                           float* __restrict__ part,
                           unsigned* __restrict__ counters, int H, int Hkv,
                           int Tlen, int kv_len, int D, int pitch,
                           int tiles) {
  constexpr int VEC = 16 / sizeof(T), SW = bd_slice<T>();
  extern __shared__ __align__(16) float fsm[];
  __shared__ int s_last;
  float* sP = fsm;                    // [key][row] of a chunk of keys
  float* red = sP + BD_PCH * GR;      // groups 1.. of [row][slice column]
  float* sLse = red + (BD_PKG - 1) * GR * SW;
  const int slice = blockIdx.x, s = blockIdx.y, n_split = gridDim.y;
  const int group = H / Hkv, chunks = group / GR;
  const int b = blockIdx.z / (Hkv * chunks), rc = blockIdx.z % (Hkv * chunks);
  const int h = rc / chunks, g0 = (rc % chunks) * GR;
  const long long qrow0 = static_cast<long long>(b) * H + h * group + g0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = tid / BD_PT, col = slice * SW + (tid % BD_PT) * VEC;
  const bool in = col < D;
  // this split's keys: whole tiles of the cache's, clipped to kv_len
  const int per = (tiles + n_split - 1) / n_split * BD_KEYS;
  const int lo = min(s * per, kv_len), hi = min(lo + per, kv_len);
  const int live = (kv_len + BD_KEYS - 1) / BD_KEYS;  // tiles with keys

  // each row's LSE: its tiles' stats, every lane its own in order, then a
  // fixed tree of shuffles
  for (int g = warp; g < GR; g += BD_PNT / 32) {
    const float2* st = stat + (qrow0 + g) * tiles;
    float M = NEG;
    for (int i = lane; i < live; i += 32) M = fmaxf(M, st[i].x);
#pragma unroll
    for (int off = 16; off; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float L = 0.0f;
    for (int i = lane; i < live; i += 32) {
      const float2 x = st[i];
      L = __fadd_rn(L, __fmul_rn(x.y, expf(__fsub_rn(x.x, M))));
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      L = __fadd_rn(L, __shfl_xor_sync(0xffffffffu, L, off));
    if (lane == 0) sLse[g] = __fadd_rn(M, logf(fmaxf(L, 1e-30f)));
  }
  float acc[GR][VEC];
#pragma unroll
  for (int g = 0; g < GR; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.0f;
  const long long vstride = static_cast<long long>(Hkv) * D;
  const T* vb = vc + (static_cast<long long>(b) * Tlen * Hkv + h) * D + col;
  for (int k0 = lo; k0 < hi; k0 += BD_PCH) {
    const int n = min(BD_PCH, hi - k0);
    __syncthreads();  // the LSE is in place; the last chunk's P is read
    for (int i = tid; i < n * GR; i += BD_PNT) {
      const int j = i / GR, g = i % GR;
      sP[i] = expf(__fsub_rn(S[(qrow0 + g) * pitch + k0 + j], sLse[g]));
    }
    __syncthreads();
    if (in) {
#pragma unroll 4
      for (int j = kg; j < n; j += BD_PKG) {
        float vf[VEC];
        unpack(__ldg(reinterpret_cast<const uint4*>(
                   vb + static_cast<long long>(k0 + j) * vstride)),
               vf, T());
#pragma unroll
        for (int g = 0; g < GR; ++g) {
          const float p = sP[j * GR + g];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
  }
  // the key groups' sums in group order into this split's partial
  __syncthreads();
  const int c = (tid % BD_PT) * VEC;  // the thread's column of the slice
  if (kg > 0) {
#pragma unroll
    for (int g = 0; g < GR; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        red[((kg - 1) * GR + g) * SW + c + e] = acc[g][e];
  }
  __syncthreads();
  if (kg == 0 && in) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      float* dst = part + ((qrow0 + g) * n_split + s) * D + col;
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        float4 a = make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2],
                               acc[g][e + 3]);
#pragma unroll
        for (int u = 1; u < BD_PKG; ++u) {
          const float* x = red + ((u - 1) * GR + g) * SW + c + e;
          a = make_float4(__fadd_rn(a.x, x[0]), __fadd_rn(a.y, x[1]),
                          __fadd_rn(a.z, x[2]), __fadd_rn(a.w, x[3]));
        }
        *reinterpret_cast<float4*>(dst + e) = a;
      }
    }
  }
  // the last split of (b, rows, slice) to finish adds the partials in
  // split order into O and sets the counter back to 0
  __syncthreads();
  if (tid == 0) {
    unsigned* ctr = counters + static_cast<long long>(blockIdx.z) *
                                   gridDim.x + slice;
    __threadfence();
    s_last = atomicAdd(ctr, 1u) == static_cast<unsigned>(n_split - 1);
    if (s_last) {
      *ctr = 0u;
      __threadfence();
    }
  }
  __syncthreads();
  if (!s_last) return;
  for (int i = tid; i < GR * BD_PT; i += BD_PNT) {
    const int g = i / BD_PT, cc = slice * SW + (i % BD_PT) * VEC;
    if (cc >= D) continue;
    const float* src = part + (qrow0 + g) * n_split * D + cc;
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      float4 a = __ldcg(reinterpret_cast<const float4*>(src + e));
      for (int u = 1; u < n_split; ++u) {
        const float4 x = __ldcg(
            reinterpret_cast<const float4*>(src + static_cast<long long>(u) *
                                                      D + e));
        a = make_float4(__fadd_rn(a.x, x.x), __fadd_rn(a.y, x.y),
                        __fadd_rn(a.z, x.z), __fadd_rn(a.w, x.w));
      }
      store4(o + (qrow0 + g) * D + cc + e, a.x, a.y, a.z, a.w);
    }
  }
}

// the cache's score tiles and the scores' row pitch at T keys
__host__ __device__ constexpr int bd_tiles(int T) {
  return (T + BD_KEYS - 1) / BD_KEYS;
}

template <typename T, int GR>
cudaError_t launch_band_decode(const void* q, const void* kc, const void* vc,
                               void* o, void* ws, void* counters, int B,
                               int H, int Hkv, int Tlen, int kv_len,
                               int n_split, int D, float scale,
                               cudaStream_t st) {
  auto score = attn_decode_band_score_kernel<T, GR>;
  auto pv = attn_decode_band_pv_kernel<T, GR>;
  constexpr int ss = bd_score_smem<T, GR>(), ps = bd_pv_smem<T, GR>();
  cudaError_t e = cudaFuncSetAttribute(
      score, cudaFuncAttributeMaxDynamicSharedMemorySize, ss);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(pv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ps);
  if (e != cudaSuccess) return e;
  const int tiles = bd_tiles(Tlen), pitch = tiles * BD_KEYS;
  const long long rows = static_cast<long long>(B) * H;
  float* part = static_cast<float*>(ws);  // first: 16-byte rows
  float* S = part + rows * n_split * D;
  float2* stat = reinterpret_cast<float2*>(S + rows * pitch);
  const int chunks = H / Hkv / GR;
  score<<<dim3(tiles, Hkv * chunks, B), BD_NT, ss, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), S, stat, H, Hkv,
      Tlen, kv_len, D, scale, pitch, tiles);
  pv<<<dim3((D + bd_slice<T>() - 1) / bd_slice<T>(), n_split,
            B * Hkv * chunks),
       BD_PNT, ps, st>>>(static_cast<const T*>(vc), static_cast<T*>(o), S,
                          stat, part, static_cast<unsigned*>(counters), H,
                          Hkv, Tlen, kv_len, D, pitch, tiles);
  e = cudaGetLastError();
  if (e == cudaSuccess) set_attn_route(ROUTE_DECODE_BAND, 0, bd_slice<T>());
  return e;
}

// the largest row count of the group that divides it: 8, 4, 2 or 1
template <typename T>
cudaError_t launch_band_decode_group(const void* q, const void* kc,
                                     const void* vc, void* o, void* ws,
                                     void* counters, int B, int H, int Hkv,
                                     int Tlen, int kv_len, int n_split, int D,
                                     float scale, cudaStream_t st) {
  const int group = H / Hkv;
  if (group % 8 == 0)
    return launch_band_decode<T, 8>(q, kc, vc, o, ws, counters, B, H, Hkv,
                                    Tlen, kv_len, n_split, D, scale, st);
  if (group % 4 == 0)
    return launch_band_decode<T, 4>(q, kc, vc, o, ws, counters, B, H, Hkv,
                                    Tlen, kv_len, n_split, D, scale, st);
  if (group % 2 == 0)
    return launch_band_decode<T, 2>(q, kc, vc, o, ws, counters, B, H, Hkv,
                                    Tlen, kv_len, n_split, D, scale, st);
  return launch_band_decode<T, 1>(q, kc, vc, o, ws, counters, B, H, Hkv,
                                  Tlen, kv_len, n_split, D, scale, st);
}

}  // namespace

// Called by accl_attn_decode (attention.cu) for S_new == 1 up to
// DECODE_SPLIT_MAX_D, every dtype. ws: the f32 workspace of B * H *
// n_split * (D + 2) floats; counters: B * H unsigned ints (past 256: B * H
// * n_split, the merge tree's), zero (the kernel leaves them zero), used
// by no launch that may run at the same time as this one (the wrapper
// keeps a set for each stream).
int attn_decode_split(int dtype, int head_dim, const void* q, const void* kc,
                      const void* vc, void* o, void* ws, void* counters,
                      int B, int H, int Hkv, int Tlen, int kv_len,
                      int n_split, float scale, cudaStream_t st) {
  if (n_split < 1 || kv_len < 1 || kv_len > Tlen) return cudaErrorInvalidValue;
  if (head_dim > 256) {  // the wide split
    if (head_dim > DECODE_SPLIT_MAX_D) return cudaErrorInvalidValue;
    const auto wide = head_dim <= 512    ? &launch_wide<512>
                      : head_dim <= 1024 ? &launch_wide<1024>
                                         : &launch_wide<2048>;
    return wide(dtype, q, kc, vc, o, ws, counters, B, H, Hkv, Tlen, kv_len,
                n_split, head_dim, scale, st);
  }
  POW2_DISPATCH(launch_split_group, q, kc, vc, o, ws, counters, B, H, Hkv,
                Tlen, kv_len, n_split, head_dim, scale, st)
}

// Called by accl_attn_decode (attention.cu) for an f32 S_new == 1 past
// DECODE_SPLIT_MAX_D. ws: the f32 workspace of B * H * (n_split * D +
// pitch + 2 * tiles) floats (partials, scores, tile stats; tiles =
// ceil(T / BD_KEYS), pitch = tiles * BD_KEYS); counters: B * H *
// ceil(D / 256) unsigned ints, zero (the kernel leaves them zero), used by
// no launch that may run at the same time as this one.
int attn_decode_band(int dtype, int head_dim, const void* q, const void* kc,
                     const void* vc, void* o, void* ws, void* counters,
                     int B, int H, int Hkv, int Tlen, int kv_len,
                     int n_split, float scale, cudaStream_t st) {
  if (dtype != 0 || ws == nullptr || counters == nullptr || n_split < 1 ||
      kv_len < 1 || kv_len > Tlen)
    return cudaErrorInvalidValue;
  return launch_band_decode_group<float>(q, kc, vc, o, ws, counters, B, H,
                                         Hkv, Tlen, kv_len, n_split,
                                         head_dim, scale, st);
}
