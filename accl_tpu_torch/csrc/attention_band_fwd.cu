// Attention forward kernels B8, B9 and the B12 chunks (S_new > 1) past
// head dim 4096, the f32 route (CUDA C++, sm_90a): the band form.
//
// Replace accl_tpu/ops/attention.py _fwd_kernel (pallas_call at :285),
// _fwd_kernel_single (:252) and _decode_kernel (:689) for chunks of S_new
// > 1 new tokens, at f32 head dims past CLUSTER_MAX_D (4096), where the
// cluster form of attention.cu ends (a portable cluster of 8 blocks of 8
// 64-column slices). attention.cu's entry points send those launches here.
//
// What bounds them on an H100: 4*D operations a visible score (S = Q K^T
// and P V), each product three times on the 495 TFLOP/s TF32 tensor cores
// (3xTF32, tf32_mma.cuh): bound 3 * ops / 495 TFLOP/s, about 0.42 ms at B
// 1, H 8, S 1024, D 4104, causal. There a head's score matrix (1024 x 1024
// floats, 4 MB) is far smaller than Q or K (16.8 MB), so the forward is
// two D-long products with S kept in device memory between them, where
// the column groups formed S once for every 64 output columns (65 times at
// D 4104). A band of R query rows at a time (fwd_band_rows), each band
// three launches:
//   the score pass (attn_fwd_band_score_kernel): grid (the band's visible
//   tiles of BTQ queries x BT keys, heads), two blocks an SM; tiles wholly
//   above the causal diagonal or past the last key are not in the grid,
//   and a warp whose 32 x 32 pairs are all hidden skips its products. Each
//   block forms S = Q K^T over the head dim in BCH-column chunks through
//   BSTAGE cp.async stages (each chunk's product in a fresh accumulator,
//   added to the running sum in f32), scales it, masks it as the plain
//   version does (finfo(f32).min) and stores it to the workspace as
//   [head][row of the band][key]; and each row's maximum m_t over the
//   tile's keys and sum l_t = sum exp(s - m_t) over its visible keys to the
//   tile stats, [head][row][key tile];
//   the normalisation (attn_fwd_band_norm_kernel): a warp a row merges the
//   row's tile stats, M = max m_t, L = sum l_t exp(m_t - M) (each lane its
//   tiles in key-tile order, then a fixed butterfly), into its LSE = M +
//   log max(L, 1e-30) (stored for B8 and B9), and turns the row's S into P
//   = exp(S - LSE) in place, 0 where the mask hides a key: each P once,
//   where exponentiating it in the product pass would repeat it for every
//   column tile (33 times at D 4104), which ran slower on an H100;
//   the product pass (attn_fwd_band_pv_kernel): grid (BOUT-column tiles,
//   BT-row tiles of the band, the heaviest under the causal mask first,
//   heads): O = P V over the keys its rows see, SROWS a step
//   (band_accumulate: each step in a fresh accumulator added in f32).
// Rows: B8 and B9 a q head's Sq rows against its kv head's keys (GQA by
// index); a chunk the GR q heads x S_new tokens of a kv head (row g *
// S_new + i at position kv_len - S_new + i) against the cache in place (a
// key stride of Hkv * D), bottom-right causal. A row with no visible key
// gives O = 0 and the LSE of l floored at 1e-30, as the plain version
// does. cp.async zero-fills rows past the ends and columns past D (D is a
// multiple of 8): a cache row at or past kv_len is never loaded, and the
// normalisation selects p = 0, never multiplies, where the mask hides a
// key, so no NaN past kv_len reaches O. The workspace comes from the caller
// (fwd_band_words floats a head: R * round4(keys) of S, then 2 * R * the
// key tiles of stats); the kernels allocate nothing. Every output element
// has one writer and the bands own disjoint rows: two runs on the same
// inputs are bitwise equal.
#include <limits.h>

#include <algorithm>

#include "attention_band.cuh"

namespace {

// the workspace's floats a head for a band of R rows over `keys` keys: S
// at a pitch of round4(keys), then each row's (m, l) of every key tile
__host__ __device__ constexpr long long fwd_band_words(int R, int keys) {
  return static_cast<long long>(R) *
         (round4(keys) + 2 * ((keys + BT - 1) / BT));
}
// the rows a band: all `rows` of a head where the workspace fits in q's
// own words (rows * D a head), else the largest multiple of BT that fits,
// at least min(rows, BT)
__host__ __device__ constexpr int fwd_band_rows(int rows, int keys, int D) {
  const long long budget = static_cast<long long>(rows) * D;
  if (fwd_band_words(rows, keys) <= budget) return rows;
  const long long r =
      budget / (round4(keys) + 2 * ((keys + BT - 1) / BT)) / BT * BT;
  const int lo = rows < BT ? rows : BT;
  return r < lo ? lo : r > rows ? rows : static_cast<int>(r);
}

// One launch's operands and band. Row r of a head sits at position
// pos_off + r % period (B8, B9: period INT_MAX, pos_off 0; a chunk:
// S_new, kv_len - S_new); cache_T 0: k, v (B*Hkv, keys, D) and q head
// `head` reads kv row (head / H) * Hkv + (head % H) / (H / Hkv); else the
// cache (B, cache_T, Hkv, D) and head = b * Hkv + h.
struct BandFwd {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;       // B8, B9: (heads, rows); a chunk: none
  float* S;         // heads x sws
  float2* stat;     // heads x tws: (m, l) of [row][key tile]
  int H, Hkv, rows, keys, D, causal, period, pos_off, cache_T;
  float scale;
  int r0, nr;       // the band's rows
  int pitch, nkt;   // S's row pitch; key tiles
  long long sws, tws;

  // the last position among rows [row, row + n), n >= 1
  __host__ __device__ int last_pos(int row, int n) const {
    const int i0 = row % period;
    return pos_off + (static_cast<long long>(i0) + n - 1 >= period
                          ? period - 1
                          : i0 + n - 1);
  }
  // the keys rows [row, row + n) see
  __host__ __device__ int kv_end(int row, int n) const {
    const int e = last_pos(row, n) + 1;
    return causal && e < keys ? e : keys;
  }
  __host__ __device__ int tiles_seen(int row, int n) const {
    return (kv_end(row, n) + BT - 1) / BT;
  }
  __device__ __forceinline__ int pos(int r) const {
    return pos_off + r % period;
  }
  __device__ __forceinline__ long long kstride() const {
    return cache_T ? static_cast<long long>(Hkv) * D : D;
  }
  // the offset of key 0 of the head's kv head in k and v
  __device__ __forceinline__ long long kv_base(int head) const {
    if (cache_T == 0)
      return ((head / H) * static_cast<long long>(Hkv) +
              (head % H) / (H / Hkv)) * keys * D;
    return (static_cast<long long>(head / Hkv) * cache_T * Hkv +
            head % Hkv) * D;
  }
};

// a score stage: Q's chunk (BTQ rows), K's (BT rows); then the tile's row
// maxima and sums, each from the two warps that share the rows
constexpr int FWD_SCORE_STAGE = (BTQ + BT) * BCP;
constexpr int FWD_SCORE_BYTES = (BSTAGE * FWD_SCORE_STAGE + 4 * BTQ) * 4;
// a product step: P's BT x SROWS tile and V's SROWS x BOUT; two stages
constexpr int FWD_PV_STAGE = BT * BCP + SROWS * BOP;
constexpr int FWD_PV_BYTES = 2 * FWD_PV_STAGE * 4;
static_assert(2 * FWD_SCORE_BYTES <= MAX_SMEM, "two score blocks an SM");

// The score pass over the band: grid (visible tiles, heads). Warp w holds
// rows 32*(w/2) and keys 32*(w%2) of the tile.
__global__ void __launch_bounds__(NT, 2)
attn_fwd_band_score_kernel(const BandFwd a) {
  extern __shared__ __align__(16) float smem[];
  float* sMax = smem + BSTAGE * FWD_SCORE_STAGE;  // [half][row]
  float* sSum = sMax + 2 * BTQ;                    // [half][row]
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = tid >> 5, half = warp & 1;
  const int qw = 32 * (warp >> 1), kw = 32 * half;  // the warp's rows, keys
  const int head = blockIdx.y;
  // the tile: query tiles in order, each its visible key tiles
  int q0 = a.r0, kt = blockIdx.x;
  for (;;) {
    const int n = a.tiles_seen(q0, min(BTQ, a.r0 + a.nr - q0));
    if (kt < n) break;
    kt -= n;
    q0 += BTQ;
  }
  const int k0 = kt * BT;
  const int nq = min(BTQ, a.r0 + a.nr - q0), nk = min(BT, a.keys - k0);
  // warp-uniform: do the warp's rows see one of its keys?
  const bool live =
      qw < nq && kw < nk &&
      (!a.causal || k0 + kw <= a.last_pos(q0 + qw, min(32, nq - qw)));
  const long long qoff = (static_cast<long long>(head) * a.rows + q0) * a.D;
  const long long kst = a.kstride();
  const float* kb = a.k + a.kv_base(head) + k0 * kst;
  const int nch = (a.D + BCH - 1) / BCH;

  // stage c % BSTAGE: Q's chunk c, then K's
  auto load = [&](int c) {
    const int col = c * BCH;
    float* s = smem + (c % BSTAGE) * FWD_SCORE_STAGE;
    cp_rows<BCH, BTQ, BCP, NT>(s, a.q + qoff + col, nq, a.D - col, a.D);
    cp_rows<BCH, BT, BCP, NT>(s + BTQ * BCP, kb + col, nk, a.D - col, kst);
  };
#pragma unroll
  for (int c = 0; c < BSTAGE - 1; ++c) {
    if (c < nch) load(c);
    cp_async_commit();
  }
  float x[2][4][4];  // S: rows qw+16m+g, +8; keys kw+8j+2t, +1
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[mm][j][e] = 0.0f;
  for (int c = 0; c < nch; ++c) {
    __syncthreads();  // every warp is done with the stage chunk c+2 takes
    if (c + BSTAGE - 1 < nch) load(c + BSTAGE - 1);
    cp_async_commit();
    cp_async_wait<BSTAGE - 1>();  // chunk c landed
    __syncthreads();
    if (live) {
      const float* s = smem + (c % BSTAGE) * FWD_SCORE_STAGE;
      add_rows32_x_rows32<BCH>(s + qw * BCP, s + (BTQ + kw) * BCP, x);
    }
  }
  // scale and mask; the row maxima of the warp's keys
  uint32_t seen = 0;  // bit 16m + 4j + e: entry (m, j, e) visible
  float mx[2][2];     // rows qw+16m+g+8h
#pragma unroll
  for (int mm = 0; mm < 2; ++mm) {
    mx[mm][0] = mx[mm][1] = NEG;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = qw + 16 * mm + g + 8 * (e >> 1);
        const int key = kw + 8 * j + 2 * t + (e & 1);
        const bool ok = r < nq && key < nk &&
                        (!a.causal || k0 + key <= a.pos(q0 + r));
        x[mm][j][e] = ok ? __fmul_rn(x[mm][j][e], a.scale) : NEG;
        seen |= static_cast<uint32_t>(ok) << (16 * mm + 4 * j + e);
        mx[mm][e >> 1] = fmaxf(mx[mm][e >> 1], x[mm][j][e]);
      }
  }
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = mx[mm][h];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (t == 0) sMax[half * BTQ + qw + 16 * mm + g + 8 * h] = m;
    }
  __syncthreads();
  // each row's sum of exp(s - m_t) over the warp's visible keys
#pragma unroll
  for (int mm = 0; mm < 2; ++mm) {
    float m[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = qw + 16 * mm + g + 8 * h;
      m[h] = fmaxf(sMax[r], sMax[BTQ + r]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((seen >> (16 * mm + 4 * j + e)) & 1u)
          sum[e >> 1] = __fadd_rn(
              sum[e >> 1], expf(__fsub_rn(x[mm][j][e], m[e >> 1])));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = sum[h];
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
      if (t == 0) sSum[half * BTQ + qw + 16 * mm + g + 8 * h] = s;
    }
  }
  __syncthreads();
  if (tid < nq)  // the tile's stats: the two halves in key order
    a.stat[head * a.tws + static_cast<long long>(q0 - a.r0 + tid) * a.nkt +
           kt] = make_float2(fmaxf(sMax[tid], sMax[BTQ + tid]),
                             __fadd_rn(sSum[tid], sSum[BTQ + tid]));
  // S, masked positions as finfo.min, every key of the tile to the pitch
  float* srow = a.S + head * a.sws +
                static_cast<long long>(q0 - a.r0) * a.pitch + k0;
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = qw + 16 * mm + g + 8 * h;
      if (r >= nq) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kw + 8 * j + 2 * t;
        if (k0 + key < a.pitch)
          *reinterpret_cast<float2*>(srow + static_cast<long long>(r) *
                                                a.pitch + key) =
              make_float2(x[mm][j][2 * h], x[mm][j][2 * h + 1]);
      }
    }
}

// The rows' BT-row product tile: the keys it sees are the keys its P holds
__device__ __forceinline__ int tile_kv_end(const BandFwd& a, int row) {
  const int q0 = a.r0 + (row - a.r0) / BT * BT;
  return a.kv_end(q0, min(BT, a.r0 + a.nr - q0));
}

// The normalisation over the band: grid (row groups of the band, heads),
// a warp a row. Each row's tile stats merge into its LSE (M = max m_t,
// then L = sum l_t exp(m_t - M), each lane its tiles in key-tile order and
// a fixed butterfly of the lanes; LSE = M + log max(L, 1e-30), stored for
// B8 and B9), then P = exp(S - LSE) where the row sees the key, else 0
// (selected, never multiplied), in place over the keys its product tile
// reads.
__global__ void __launch_bounds__(NT)
attn_fwd_band_norm_kernel(const BandFwd a) {
  const int lane = threadIdx.x & 31;
  const int row = a.r0 + blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (row >= a.r0 + a.nr) return;
  const int head = blockIdx.y;
  const int end = tile_kv_end(a, row), ntile = (end + BT - 1) / BT;
  const float2* st = a.stat + head * a.tws +
                     static_cast<long long>(row - a.r0) * a.nkt;
  float M = NEG;
  for (int i = lane; i < ntile; i += 32) M = fmaxf(M, st[i].x);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  float L = 0.0f;
  for (int i = lane; i < ntile; i += 32) {
    const float2 s = st[i];
    L = __fadd_rn(L, __fmul_rn(s.y, expf(__fsub_rn(s.x, M))));
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    L = __fadd_rn(L, __shfl_xor_sync(0xffffffffu, L, off));
  const float lse = __fadd_rn(M, logf(fmaxf(L, 1e-30f)));
  if (lane == 0 && a.lse != nullptr)
    a.lse[static_cast<long long>(head) * a.rows + row] = lse;
  float* s = a.S + head * a.sws + static_cast<long long>(row - a.r0) * a.pitch;
  const int last = a.causal ? a.pos(row) : INT_MAX;
  const int n = min(round4(end), a.pitch);  // what the product pass reads
  for (int key = lane; key < n; key += 32)
    s[key] = key < a.keys && key <= last ? expf(__fsub_rn(s[key], lse))
                                         : 0.0f;
}

// The product pass over the band: grid (BOUT-column tiles, BT-row tiles
// of the band, the last first, heads). Each warp O = P V for 32 rows and a
// quarter of the tile's columns over the keys the tile's rows see.
__global__ void __launch_bounds__(NT, 1)
attn_fwd_band_pv_kernel(const BandFwd a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = tid >> 5, qw = 32 * (warp >> 2);
  const int c0 = blockIdx.x * BOUT, cw = (BOUT / 4) * (warp & 3);
  const int q0 = a.r0 + (gridDim.y - 1 - blockIdx.y) * BT, head = blockIdx.z;
  const int nq = min(BT, a.r0 + a.nr - q0);
  const int kv_end = a.kv_end(q0, nq);
  const int n_it = (kv_end + SROWS - 1) / SROWS;
  const float* pw = a.S + head * a.sws +
                    static_cast<long long>(q0 - a.r0) * a.pitch;
  const long long kst = a.kstride();
  const float* vb = a.v + a.kv_base(head) + c0;

  // stage s: P (BT x SROWS), then V (SROWS x BOUT)
  auto load = [&](int it) {
    const int kt0 = it * SROWS, n = min(SROWS, kv_end - kt0);
    float* s = smem + (it & 1) * FWD_PV_STAGE;
    cp_rows<SROWS, BT, BCP, NT>(s, pw + kt0, nq, kv_end - kt0, a.pitch);
    cp_rows<BOUT, SROWS, BOP, NT>(s + BT * BCP, vb + kt0 * kst, n, a.D - c0,
                                  kst);
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
    const float* s = smem + (it & 1) * FWD_PV_STAGE;
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
      float* out = a.o + (static_cast<long long>(head) * a.rows + q0 + r) *
                             a.D + c0 + cw + 2 * t;
#pragma unroll
      for (int c = 0; c < BOUT / 32; ++c)
        if (c0 + cw + 8 * c < a.D)
          *reinterpret_cast<float2*>(out + 8 * c) =
              make_float2(acc[mm][c][2 * h], acc[mm][c][2 * h + 1]);
    }
}

// The band form over `heads` heads of a.rows rows each, the workspace ws
// of heads * fwd_band_words(fwd_band_rows(...), keys) floats; each band a
// score pass and a product pass, in band order; reports `route`
cudaError_t launch_fwd_band(int route, BandFwd a, int heads, float* ws,
                           cudaStream_t st) {
  if (ws == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(attn_fwd_band_score_kernel, FWD_SCORE_BYTES);
  if (e == cudaSuccess) e = allow_smem(attn_fwd_band_pv_kernel, FWD_PV_BYTES);
  if (e != cudaSuccess) return e;
  const int R = fwd_band_rows(a.rows, a.keys, a.D);
  a.pitch = round4(a.keys);
  a.nkt = (a.keys + BT - 1) / BT;
  a.sws = static_cast<long long>(R) * a.pitch;
  a.tws = static_cast<long long>(R) * a.nkt;
  a.S = ws;
  a.stat = reinterpret_cast<float2*>(ws + heads * a.sws);
  const int ct = (a.D + BOUT - 1) / BOUT;
  for (a.r0 = 0; a.r0 < a.rows; a.r0 += R) {
    a.nr = std::min(R, a.rows - a.r0);
    int tiles = 0;
    for (int q0 = a.r0; q0 < a.r0 + a.nr; q0 += BTQ)
      tiles += a.tiles_seen(q0, std::min(BTQ, a.r0 + a.nr - q0));
    if (tiles > 0)
      attn_fwd_band_score_kernel<<<dim3(tiles, heads), NT, FWD_SCORE_BYTES,
                                   st>>>(a);
    attn_fwd_band_norm_kernel<<<dim3((a.nr + NT / 32 - 1) / (NT / 32),
                                     heads), NT, 0, st>>>(a);
    attn_fwd_band_pv_kernel<<<dim3(ct, (a.nr + BT - 1) / BT, heads), NT,
                              FWD_PV_BYTES, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  set_attn_route(route, 0, BOUT);
  return cudaSuccess;
}

}  // namespace

// B8 or B9 (route `kind`) on the band form at any f32 head dim (a multiple
// of 8); operands as attention.cu's attn_fwd_kernel, ws the workspace
int attn_fwd_band(int kind, const float* q, const float* k, const float* v,
                  float* o, float* lse, float* ws, int B, int H, int Hkv,
                  int Sq, int Skv, int causal, int D, float scale,
                  cudaStream_t st) {
  if (B < 1 || Sq < 1 || Skv < 1) return cudaErrorInvalidValue;
  BandFwd a = {};
  a.q = q, a.k = k, a.v = v, a.o = o, a.lse = lse;
  a.H = H, a.Hkv = Hkv, a.rows = Sq, a.keys = Skv, a.D = D;
  a.causal = causal, a.period = INT_MAX, a.pos_off = 0, a.cache_T = 0;
  a.scale = scale;
  return launch_fwd_band(kind, a, B * H, ws, st);
}

// A B12 chunk of s_new > 1 new tokens on the band form; operands as
// attention.cu's attn_decode_kernel, ws the workspace
int attn_prefill_band(const float* q, const float* kc, const float* vc,
                      float* o, float* ws, int B, int H, int Hkv, int Tlen,
                      int s_new, int kv_len, int D, float scale,
                      cudaStream_t st) {
  if (B < 1 || s_new < 1 || kv_len < s_new || kv_len > Tlen)
    return cudaErrorInvalidValue;
  BandFwd a = {};
  a.q = q, a.k = kc, a.v = vc, a.o = o, a.lse = nullptr;
  a.H = H, a.Hkv = Hkv, a.rows = (H / Hkv) * s_new, a.keys = kv_len;
  a.D = D, a.causal = 1, a.period = s_new, a.pos_off = kv_len - s_new;
  a.cache_T = Tlen, a.scale = scale;
  return launch_fwd_band(ROUTE_PREFILL_TF32_BAND, a, B * Hkv, ws, st);
}
