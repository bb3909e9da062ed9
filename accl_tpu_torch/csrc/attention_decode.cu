// Kernel B12's single-token decode (S_new == 1) as split-KV on the CUDA
// cores (CUDA C++, sm_90a), f32 and bf16.
//
// Replaces accl_tpu/ops/attention.py _decode_kernel (pallas_call at :689)
// for one new token: q (B, H, 1, D); the cache (B, T, Hkv, D) in its
// native layout, keys 0 .. kv_len-1 and nothing at or past kv_len read;
// GQA by index (the group = H / Hkv q heads of one kv head share its K
// and V); O in q's dtype. accl_attn_decode (attention.cu) sends every
// S_new == 1 launch here; chunks of S_new > 1 keep their routes there.
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
//   Llama-3-8B) sit in registers as f32, each lane holding 16 bytes' worth
//   of columns. K and V rows stream through a 3-stage ring of 16-byte
//   cp.async copies (16 KB a stage, so 32 KB in flight per block and
//   four blocks, 16 warps, an SM: with the cache in L2, as it is when
//   the same step is timed again, the block's chain of shuffles and
//   exponents, not the bytes, sets the pace, and more warps hide it); a
//   row at or past the range end is
//   zero-filled by the copy, never read. D / (16 / sizeof(T)) lanes share
//   one key (a key slot): their partial dot products meet through a
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
//   per device). Chosen over a second kernel: a second launch waits for
//   the first to drain and reads every partial back, where here only the
//   last block of each group does, while the others' loads still stream;
//   and one self-resetting launch is as easy for a CUDA graph to hold.
//   The counters make concurrent launches on two streams unsafe; the port
//   launches on one.
//
// Arithmetic: f32 throughout, explicit fmaf (the library builds with
// --fmad=false), expf and a true division at the end; nothing is rounded
// to bf16 before the output, so only the summation order differs from
// the plain version (flash_decode_ref). Invalid keys take part in the
// max as finfo(f32).min and contribute p = 0 through the mask.
#include "attention_tile.cuh"

namespace {

constexpr int DNT = 128;         // threads per split block
constexpr int DWARPS = DNT / 32;
constexpr int STAGES = 3;        // depth of the K/V ring
constexpr int SPLIT_TILE = 64;   // a split's key range is a multiple of it
constexpr int BLOCKS_PER_SM = 4; // 48 KB of ring and <= 128 registers each
constexpr int MERGE_CHUNK = 8;   // splits whose partials load at once

template <typename T, int D>
struct Geo {
  static constexpr int VEC = 16 / sizeof(T);   // elements per 16 bytes
  static constexpr int LPR = D / VEC;          // lanes per key row
  static constexpr int KPW = 32 / LPR;         // keys per warp step
  static constexpr int ROWB = D * sizeof(T);   // bytes of one key row
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
// zero between launches.
template <typename T, int D, int GR>
__global__ void __launch_bounds__(DNT, BLOCKS_PER_SM)
attn_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                         const T* __restrict__ vc, T* __restrict__ o,
                         float* __restrict__ part_m,
                         float* __restrict__ part_l,
                         float* __restrict__ part_acc,
                         unsigned* __restrict__ counters, int H, int Hkv,
                         int Tlen, int kv_len, float scale) {
  using G_ = Geo<T, D>;
  using RS = RowSplit<GR, G_::LPR>;
  constexpr int VEC = G_::VEC, LPR = G_::LPR, KPW = G_::KPW, NR = RS::NR;
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
      for (int i = threadIdx.x; i < KT * LPR; i += DNT) {
        const int r = i / LPR, c = i % LPR;
        const bool ok = key0 + r < hi;
        const long long off =
            (ok ? (key0 + r) * kstride : 0) + static_cast<long long>(c) * VEC;
        cp_async16(dst + i * 16, kb + off, ok ? 16 : 0);
        cp_async16(dst + KT * ROWB + i * 16, vb + off, ok ? 16 : 0);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);

  // q and the accumulator: all GR rows, this lane's VEC columns; the
  // running max and sum: this lane's NR rows
  float qf[GR][VEC], acc[GR][VEC], m[NR], l[NR];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    const T* qrow =
        q + (static_cast<long long>(b) * H + h * group + g0 + g) * D + cc * VEC;
    unpack(*reinterpret_cast<const uint4*>(qrow), qf[g], T());
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.0f;
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
      float kf[VEC], d[GR];
      unpack(*reinterpret_cast<const uint4*>(tk + r * ROWB + cc * 16), kf,
             T());
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        d[g] = 0.0f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d[g] = fmaf(qf[g][e], kf[e], d[g]);
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
      for (int e = 0; e < VEC; ++e) acc[g][e] = __fmul_rn(acc[g][e], a);
    }
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int r = warp * (KT / DWARPS) + j * KPW + kr;
      float vf[VEC];
      unpack(*reinterpret_cast<const uint4*>(tv + r * ROWB + cc * 16), vf,
             T());
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        const float p =
            __shfl_sync(0xffffffffu, sc[j][g % NR], src0 + RS::src(g));
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
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
  float* sm_acc = sm_l + NS * GR;                // NS x GR x D
  const int stream = warp * KPW + kr;
#pragma unroll
  for (int g = 0; g < GR; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      sm_acc[(stream * GR + g) * D + cc * VEC + e] = acc[g][e];
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
      A = fmaf(w, sm_acc[(u * GR + g) * D + d], A);
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

template <typename T, int D, int GR>
cudaError_t launch_split(const void* q, const void* kc, const void* vc,
                         void* o, void* ws, void* counters, int B, int H,
                         int Hkv, int Tlen, int kv_len, int n_split,
                         float scale, cudaStream_t st) {
  using G_ = Geo<T, D>;
  constexpr int ring = STAGES * G_::STAGE;
  constexpr int merge = G_::STREAMS * GR * (D + 2) * 4;
  constexpr int smem = ring > merge ? ring : merge;
  auto kern = attn_decode_split_kernel<T, D, GR>;
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
      part_acc, static_cast<unsigned*>(counters), H, Hkv, Tlen, kv_len,
      scale);
  return cudaGetLastError();
}

// the largest row count of the group that divides it: 4, 2 or 1
template <typename T, int D>
cudaError_t launch_split_group(const void* q, const void* kc, const void* vc,
                               void* o, void* ws, void* counters, int B,
                               int H, int Hkv, int Tlen, int kv_len,
                               int n_split, float scale, cudaStream_t st) {
  const int group = H / Hkv;
  if (group % 4 == 0)
    return launch_split<T, D, 4>(q, kc, vc, o, ws, counters, B, H, Hkv, Tlen,
                                 kv_len, n_split, scale, st);
  if (group % 2 == 0)
    return launch_split<T, D, 2>(q, kc, vc, o, ws, counters, B, H, Hkv, Tlen,
                                 kv_len, n_split, scale, st);
  return launch_split<T, D, 1>(q, kc, vc, o, ws, counters, B, H, Hkv, Tlen,
                               kv_len, n_split, scale, st);
}

}  // namespace

// Called by accl_attn_decode (attention.cu) for S_new == 1. ws: the f32
// workspace of B * H * n_split * (D + 2) floats; counters: B * H unsigned
// ints, zero (the kernel leaves them zero).
int attn_decode_split(int dtype, int head_dim, const void* q, const void* kc,
                      const void* vc, void* o, void* ws, void* counters,
                      int B, int H, int Hkv, int Tlen, int kv_len,
                      int n_split, float scale, cudaStream_t st) {
  if (n_split < 1 || kv_len < 1 || kv_len > Tlen) return cudaErrorInvalidValue;
  ATTN_DISPATCH(launch_split_group, q, kc, vc, o, ws, counters, B, H, Hkv,
                Tlen, kv_len, n_split, scale, st)
}
