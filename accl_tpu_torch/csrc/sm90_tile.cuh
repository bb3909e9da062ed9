// Hopper tile helpers shared by the tensor-core attention kernels
// (attention_sm90.cu: B8, B9 and B12's prefill route; attention_bwd_sm90.cu:
// B10, B11): warpgroup MMA (wgmma) wrappers for 16-bit operands (bf16 or
// f16, f32 accumulators) and descriptors for 128-byte-swizzled tiles,
// mbarriers, TMA tile loads on 3-D and 4-D tensor maps, the register
// fragments of a wgmma accumulator, and the thread-block clusters of the
// 16-bit cluster forms (remote stores, their slots, the launch).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the driver entry
                   // point is looked up at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_route.cuh"

namespace {

constexpr int WG = 128;   // threads per block: one warpgroup
constexpr int BKV = 64;   // keys per tile
constexpr int BQ = 64;    // q rows per tile
constexpr int ROW = 128;  // bytes of one row of a 64-column 16-bit block
constexpr float LOG2E = 1.4426950408889634f;

// A tile of R rows in shared memory: NB blocks of R x 64 16-bit columns,
// each R * 128 bytes, written by TMA with the 128-byte swizzle. DP, the
// columns held, is a tier (64, 128, 192 or 256); the head dim D <= DP is
// a run-time value: the tensor maps have extent D, so TMA fills the
// columns past D with zeros, and zero columns add nothing to a product.
template <int DP_>
struct Cols {
  static_assert(DP_ % 64 == 0 && DP_ <= 256, "a column tier");
  static constexpr int DP = DP_;      // columns held
  static constexpr int NB = DP / 64;  // 64-column blocks
  static constexpr int KS = DP / 16;  // k16 steps over the head dim
};

// the tier that holds head dim d (a multiple of 8, at most 256)
__host__ __device__ constexpr int col_tier(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : d <= 192 ? 192 : 256;
}

// The 16-bit element types: bf16 (8 significant bits) and f16 (11).
template <typename T>
struct Elt;
template <>
struct Elt<__nv_bfloat16> {
  static constexpr bool F16 = false;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // two f32 as one bf16x2 register, each rounded to nearest even (the
  // lower column in the low half, as wgmma's register fragments hold them)
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <>
struct Elt<__half> {
  static constexpr bool F16 = true;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// the accumulator registers of a 64 x 64 and a 64 x 128 product
#define WG_ACC32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9" \
  ", %10, %11, %12, %13, %14, %15, %16, %17, %18, %19" \
  ", %20, %21, %22, %23, %24, %25, %26, %27, %28, %29" \
  ", %30, %31}"
#define WG_ACC64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9" \
  ", %10, %11, %12, %13, %14, %15, %16, %17, %18, %19" \
  ", %20, %21, %22, %23, %24, %25, %26, %27, %28, %29" \
  ", %30, %31, %32, %33, %34, %35, %36, %37, %38, %39" \
  ", %40, %41, %42, %43, %44, %45, %46, %47, %48, %49" \
  ", %50, %51, %52, %53, %54, %55, %56, %57, %58, %59" \
  ", %60, %61, %62, %63}"
#define WG_OUT32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_OUT64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// One wgmma instruction: m64nNk16, f32 accumulators, operands of type TY
// ("bf16" or "f16"), predicate P (0: overwrite, 1: accumulate). SS: both
// operands from shared memory, K-major; RS: A from registers, B from
// shared memory with transpose bit TB (1: MN-major, row k of B is a row
// of the tile).
#define WG_SS(N, TY, ACC, A, B, P)                                      \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                        \
  "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " " ACC   \
  ", " A ", " B ", p, 1, 1, 0, 0;\n}\n"
#define WG_RS(N, TY, ACC, A, B, P, TB)                                  \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                        \
  "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " " ACC   \
  ", " A ", " B ", p, 1, 1, " TB ";\n}\n"

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // D(64x64) (+)= A(64x16, K-major in shared memory) * B(16x64, K-major)
  template <typename T>
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int acc) {
    if constexpr (Elt<T>::F16)
      asm volatile(WG_SS("64", "f16", WG_ACC32, "%32", "%33", "%34")
                   : WG_OUT32(d)
                   : "l"(da), "l"(db), "r"(acc));
    else
      asm volatile(WG_SS("64", "bf16", WG_ACC32, "%32", "%33", "%34")
                   : WG_OUT32(d)
                   : "l"(da), "l"(db), "r"(acc));
  }
  // D(64x64) (+)= A(64x16, registers) * B(16x64 in shared memory),
  // MN-major when TB is 1, K-major when it is 0
  template <typename T, int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int acc) {
    if constexpr (Elt<T>::F16)
      asm volatile(WG_RS("64", "f16", WG_ACC32, "{%32, %33, %34, %35}",
                         "%36", "%37", "%38")
                   : WG_OUT32(d)
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                     "r"(acc), "n"(TB));
    else
      asm volatile(WG_RS("64", "bf16", WG_ACC32, "{%32, %33, %34, %35}",
                         "%36", "%37", "%38")
                   : WG_OUT32(d)
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                     "r"(acc), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  // D(64x128) += A(64x16, registers) * B(16x128, MN-major in shared
  // memory)
  template <typename T>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db) {
    if constexpr (Elt<T>::F16)
      asm volatile(WG_RS("128", "f16", WG_ACC64, "{%64, %65, %66, %67}",
                         "%68", "%69", "1")
                   : WG_OUT64(d)
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                     "r"(1));
    else
      asm volatile(WG_RS("128", "bf16", WG_ACC64, "{%64, %65, %66, %67}",
                         "%68", "%69", "1")
                   : WG_OUT64(d)
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                     "r"(1));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a 128-byte-swizzled tile at shared address `addr`:
// SBO 1024 bytes (from one 8-row atom to the next), LBO `lbo` bytes (from
// one 64-column block to the next; read by MN-major operands only).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// K-major operand: k16 step `kk` over the head dim of an R-row tile
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * R * ROW + (kk & 3) * 32, 16);
}

// MN-major operand: rows 16*kk .. 16*kk + 15 of an R-row tile as B (16 x DP)
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * ROW, R * ROW);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of wgmma registers across the
// asynchronous issue and wait
template <int R>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// waits for the completion of the barrier's phase of parity `parity`; a
// transfer that never lands traps (a launch error) instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins > (1ll << 26)) __trap();
  }
}

// one box {64 columns, rows, 1} of a 3-D map {D, S, rows} into `dst`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

// one box {64 columns, 1, rows, 1} of a 4-D map {D, heads, S, batch}
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int col, int head,
                                          int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// all NB column blocks of an R-row tile (rows row .. row + R - 1 of head
// `head`, columns col0 .. col0 + DP - 1) on barrier `bar`
template <int DP, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int head,
                                         int col0 = 0) {
#pragma unroll
  for (int b = 0; b < Cols<DP>::NB; ++b)
    tma_load(dst + b * R * ROW, map, bar, col0 + b * 64, row, head);
}

// the same from a 4-D map: rows row .. row + R - 1 of head `head` of
// batch `batch`; the shared tile is laid out as tma_tile's
template <int DP, int R>
__device__ __forceinline__ void tma_tile4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int head, int row,
                                          int batch, int col0 = 0) {
#pragma unroll
  for (int b = 0; b < Cols<DP>::NB; ++b)
    tma_load4(dst + b * R * ROW, map, bar, col0 + b * 64, head, row, batch);
}

// The column-group form of head dims past 256 (both sm90 sources): a
// block keeps one group of WGRP output columns (grid z), and forms the
// products over the head dim (S = Q K^T, the backward's dP) in chunks of
// WCH columns (D a multiple of WCH), each group the same chunks in the
// same order, so every group reaches the same scores bit for bit. Tiles stream through a ring
// of two slots of WSLOT bytes on their own barriers, one load a step.
constexpr int WCH = 128;   // a chunk of the head dim: two 64-column blocks
constexpr int WGRP = 256;  // the columns of O or dQ a block keeps
constexpr int WSLOT = 4 * BKV * WCH * 2;  // a ring slot: 64 KB

// the chunks of head dim d
__host__ __device__ constexpr int wide_chunks(int d) {
  return (d + WCH - 1) / WCH;
}

// the bytes of an R-row tile's 64-column blocks from column col0 that
// hold a column below d (tma_tile_live loads those; blocks wholly past d
// are not loaded: they feed only columns of a result past d, which are
// never stored)
template <int DP, int R>
__device__ __forceinline__ uint32_t live_bytes(int col0, int d) {
  const int n = (d - col0 + 63) / 64;
  return (n < 0 ? 0 : n > Cols<DP>::NB ? Cols<DP>::NB : n) * R * ROW;
}

// the live column blocks of an R-row tile (tma_tile's layout) from a
// 3-D map
template <int DP, int R>
__device__ __forceinline__ void tma_tile_live(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row, int head,
                                              int col0, int d) {
  for (int b = 0; b < Cols<DP>::NB && col0 + b * 64 < d; ++b)
    tma_load(dst + b * R * ROW, map, bar, col0 + b * 64, row, head);
}

// the same from a 4-D map {D, heads, S, batch}
template <int DP, int R>
__device__ __forceinline__ void tma_tile4_live(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int head,
                                               int row, int batch, int col0,
                                               int d) {
  for (int b = 0; b < Cols<DP>::NB && col0 + b * 64 < d; ++b)
    tma_load4(dst + b * R * ROW, map, bar, col0 + b * 64, head, row, batch);
}

// zeros into the 64-column blocks of an R-row tile (tma_tile's layout) at
// `tile` from column col0 that hold no column below d: every thread of
// the block. The cluster forms load only the live blocks (tma_tile_live;
// a box wholly past the map's extent loads slowly) and zero the others
// once, so that they add nothing to a product over the head dim; the
// caller fences (fence_async_smem) and syncs before wgmma reads them.
template <int DP, int R>
__device__ __forceinline__ void zero_dead(uint8_t* tile, int col0, int d) {
  const int n = (d - col0 + 63) / 64;
  const int live = n < 0 ? 0 : n > Cols<DP>::NB ? Cols<DP>::NB : n;
  float4* p = reinterpret_cast<float4*>(tile + live * R * ROW);
  const int words = (Cols<DP>::NB - live) * R * ROW / 16;
  for (int i = threadIdx.x; i < words; i += blockDim.x)
    p[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragments of a product over the N columns of a 64 x N f32
// accumulator, rounded to T: k16 step kk takes accumulator registers
// 8kk .. 8kk + 7.
template <typename T, int N>
__device__ __forceinline__ void to_a(const float* acc, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = Elt<T>::pack(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// acc (64 x N) += A (64 x 16, registers) * B, B rows 16kk .. 16kk + 15
// of the R-row tile at `tile` over its first N columns, MN-major: one
// m64n128k16 for each 128 columns, one m64n64k16 for 64 left over
template <typename T, int N, int R>
__device__ __forceinline__ void rs_cols(float* acc, const uint32_t* a,
                                        uint32_t tile, int kk) {
#pragma unroll
  for (int c = 0; c + 128 <= N; c += 128)
    Wgmma<128>::rs<T>(acc + c / 2, a,
                      desc_mn<R>(tile + c / 64 * R * ROW, kk));
  if constexpr (N % 128 != 0)
    Wgmma<64>::rs<T, 1>(acc + (N - 64) / 2, a,
                        desc_mn<R>(tile + (N - 64) / 64 * R * ROW, kk), 1);
}

// Accumulator register i of a 64 x N wgmma result sits at row
// frag_row(i) and column frag_col(i) of the tile for this thread.
__device__ __forceinline__ int frag_row(int i) {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2) + (i & 2) * 4;
}
__device__ __forceinline__ int frag_col(int i) {
  return (i >> 2) * 8 + (threadIdx.x & 3) * 2 + (i & 1);
}

// ---- thread-block clusters (the 16-bit cluster forms) -------------------
//
// A block reaches its peers' shared memory by stores only (st.async, each
// counted on the receiving block's mbarrier), never by a remote load.

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the shared::cluster address of this block's shared address `a` in the
// block of rank r
__device__ __forceinline__ uint32_t peer(uint32_t a, int r) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(a), "r"(r));
  return d;
}
// 16 and 8 bytes into a peer's shared memory, counted on its mbarrier
__device__ __forceinline__ void st_async4(uint32_t a, float x, float y,
                                          float z, float w, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(a),
      "f"(x), "f"(y), "f"(z), "f"(w), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async2(uint32_t a, uint32_t x, uint32_t y,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(a),
      "r"(x), "r"(y), "r"(bar)
      : "memory");
}
// this thread's shared-memory writes made visible to the async proxy
// (TMA, wgmma) that reads them after a barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// mbar_wait, acquiring at cluster scope what the peers' st.async wrote
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done = 0;
  for (long long spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins > (1ll << 26)) __trap();
  }
}

// a + b, element by element, rounded to nearest
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
// the receive slot, at its owner u % C, of unit u from sender s != u % C:
// the owner's units one after another, each with a slot for each other
// block in block order
__host__ __device__ constexpr int xch_slot(int u, int s, int C) {
  return (u / C) * (C - 1) + (s < u % C ? s : s - 1);
}
// the receive slots an owner needs for `units` units dealt over clusters
// of 2 to cmax blocks (unit u to block u % C): its units from each other
// block, the most of ceil(units / C) (C - 1)
__host__ __device__ constexpr int xch_slots(int units, int cmax) {
  int m = 0;
  for (int c = 2; c <= cmax; ++c)
    m = (units + c - 1) / c * (c - 1) > m ? (units + c - 1) / c * (c - 1) : m;
  return m;
}

// ---- host -----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a map of 16-bit elements T of `rank` dims (innermost first; strides in
// bytes of dims 1..) with boxes of 64 columns, 128-byte swizzle, zeros
// past every extent
template <typename T>
cudaError_t encode16(CUtensorMap* map, const void* ptr, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, Elt<T>::MAP, rank, const_cast<void*>(ptr),
                         dims, strides, box, step,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a contiguous 16-bit (heads, S, D) tensor as the 3-D map {D, S, heads}:
// boxes of 64 columns x `rows` rows of one head, zeros past D and past S
// (D a multiple of 8: TMA takes row strides of a multiple of 16 bytes)
template <typename T>
cudaError_t tile_map(CUtensorMap* map, const void* ptr, int heads, int S,
                     int D, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return encode16<T>(map, ptr, 3, dims, strides, box);
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The launch configuration of a 16-bit cluster kernel: grid (x, y, C),
// clusters (1, 1, C), one warpgroup a block, `smem` bytes of shared
// memory; attr holds the cluster dimension
inline cudaLaunchConfig_t cluster16_config(int x, int y, int C, int smem,
                                           cudaStream_t st,
                                           cudaLaunchAttribute (&attr)[1]) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(x, y, C);
  cfg.blockDim = dim3(WG);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the clusters of C blocks of `kern` (`smem` bytes a block) that the card
// holds at once into *n
template <typename K>
cudaError_t cluster16_active(K kern, int C, int smem, int* n) {
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster16_config(1, 1, C, smem, nullptr,
                                                  attr);
  return cudaOccupancyMaxActiveClusters(n, kern, &cfg);
}

// `kern` over grid (x, y, C) in clusters of C <= 8 blocks. The card must
// hold one such cluster at one block an SM (asked once for each kernel,
// device and C), or the launch is refused with
// cudaErrorLaunchOutOfResources; there is no fallback.
template <typename... P, typename... A>
cudaError_t launch_cluster16(void (*kern)(P...), int x, int y, int C,
                             int smem, cudaStream_t st, A... args) {
  constexpr int NDEV = 16;
  static int fits[NDEV][9];  // by C: 0 unknown, 1 fits, -1 not
  if (C < 2 || C > 8) return cudaErrorInvalidValue;
  int dev = 0, unknown = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  int& ok = dev < NDEV ? fits[dev][C] : unknown;
  if (ok == 0) {
    int n = 0;
    e = cluster16_active(kern, C, smem, &n);
    if (e != cudaSuccess) return e;
    ok = n > 0 ? 1 : -1;
  }
  if (ok < 0) return cudaErrorLaunchOutOfResources;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster16_config(x, y, C, smem, st, attr);
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

}  // namespace

// dtype code (1 bf16, 2 f16) x the head dim's column tier -> FN<T, DP>
#define SM90_DISPATCH(FN, ...)                                   \
  switch (dtype * 1000 + col_tier(head_dim)) {                   \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);        \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);       \
    case 1192: return FN<__nv_bfloat16, 192>(__VA_ARGS__);       \
    case 1256: return FN<__nv_bfloat16, 256>(__VA_ARGS__);       \
    case 2064: return FN<__half, 64>(__VA_ARGS__);               \
    case 2128: return FN<__half, 128>(__VA_ARGS__);              \
    case 2192: return FN<__half, 192>(__VA_ARGS__);              \
    case 2256: return FN<__half, 256>(__VA_ARGS__);              \
    default: return cudaErrorInvalidValue;                       \
  }

// dtype code (1 bf16, 2 f16) -> FN<T>: the column-group kernels (D > 256)
#define SM90_COLS_DISPATCH(FN, ...)                             \
  switch (dtype) {                                              \
    case 1: return FN<__nv_bfloat16>(__VA_ARGS__);              \
    case 2: return FN<__half>(__VA_ARGS__);                     \
    default: return cudaErrorInvalidValue;                      \
  }
