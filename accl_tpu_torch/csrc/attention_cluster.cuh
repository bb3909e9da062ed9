// The cluster form's machinery, shared by the f32 attention kernels of
// head dims past 256 (attention.cu: B8, B9 and the B12 chunks;
// attention_bwd.cu: B10 and B11): the slices and tiers, the exchange of
// partial sums through distributed shared memory, and the launch.
//
// A thread-block cluster of C = cluster_size(D) blocks (grid z, at most 8:
// the portable size) owns one tile of resident rows; the head dim is cut
// into slices of SL columns and block c holds the NS = cluster_ns(D)
// slices NS*c .. NS*c + NS - 1. A product over the head dim (S = Q K^T,
// and the backward's dP) is formed once a tile: each block sums its
// slices' partials and stores them into the owners' receive buffers (a
// store, never a remote load), the owner of each position sums the C
// partials in block order (xch_sum) and stores the sum, or what it makes
// of it, into every block's result buffer (xch_bcast), and each warp
// reads its rows from its own block's result buffer (xch_read). The
// positions of a 16 x 32 accumulator tile are dealt as four "quarters"
// (one float4 a lane each, 128 floats), quarter i to block i % C.
#pragma once

#include <cooperative_groups.h>

#include "attention_tile.cuh"

namespace {

constexpr int SL = 64, SLP = SL + 4;  // a slice's columns; its row pitch
// the head dims of the cluster form: at most 8 slices a block, at most 8
// blocks a cluster (the portable size)
constexpr int CLUSTER_MAX_D = 8 * 8 * SL;
// the slices a block holds at head dim D: the fewest of 2, 4, 8 that keep
// the cluster at 8 blocks
__host__ __device__ constexpr int cluster_ns(int D) {
  return D <= 8 * 2 * SL ? 2 : D <= 8 * 4 * SL ? 4 : 8;
}
__host__ __device__ constexpr int cluster_size(int D) {
  return ((D + SL - 1) / SL + cluster_ns(D) - 1) / cluster_ns(D);
}
__host__ __device__ constexpr bool cluster_form(int D) {
  return D > 256 && D <= CLUSTER_MAX_D;
}
// the least cluster size of the tier of NS slices a block
__host__ __device__ constexpr int cluster_cmin(int NS) {
  return NS == 2 ? 3 : 5;
}
// the receive slots of NQ quarters over C blocks: each owner holds C for
// each of its quarters
__host__ __device__ constexpr int cluster_slots(int NQ, int C) {
  return (NQ + C - 1) / C * C;
}
__host__ __device__ constexpr int most_slots(int NQ, int cmin) {
  int m = 0;
  for (int c = cmin; c <= 8; ++c)
    m = cluster_slots(NQ, c) > m ? cluster_slots(NQ, c) : m;
  return m;
}
static_assert(cluster_ns(CLUSTER_MAX_D) == 8 &&
                  cluster_size(CLUSTER_MAX_D) == 8 &&
                  cluster_size(257) == cluster_cmin(2) &&
                  cluster_size(8 * 2 * SL + 8) == cluster_cmin(4) &&
                  cluster_size(8 * 4 * SL + 8) == cluster_cmin(8),
              "the tiers' cluster sizes");

__device__ __forceinline__ float4 f4(const float (&z)[4]) {
  return make_float4(z[0], z[1], z[2], z[3]);
}
__device__ __forceinline__ float4 f4_add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// the sum, in block order, of the C partials at float offset off (two
// elements) of the receive buffer rcv (a slot is 128 floats)
__device__ __forceinline__ float2 xch_sum(const float* rcv, int off, int C) {
  float2 s = *reinterpret_cast<const float2*>(rcv + off);
  for (int b = 1; b < C; ++b) {
    const float2 a = *reinterpret_cast<const float2*>(rcv + off + b * 128);
    s = make_float2(__fadd_rn(s.x, a.x), __fadd_rn(s.y, a.y));
  }
  return s;
}

// v (two elements at float offset off) into the result buffer res of
// every block of the cluster
__device__ __forceinline__ void xch_bcast(
    cooperative_groups::cluster_group& cluster, float* res, int off, int C,
    float2 v) {
#pragma unroll
  for (int b = 0; b < 8; ++b)
    if (b < C)
      *reinterpret_cast<float2*>(cluster.map_shared_rank(res, b) + off) = v;
}

// rows group grp's 16 x 32 tile (the quarters grp*4 .. grp*4 + 3) from
// the result buffer res, as the accumulator x of a 16 x 32 product
__device__ __forceinline__ void xch_read(const float* res, int grp,
                                         float (&x)[4][4]) {
  const float4* p =
      reinterpret_cast<const float4*>(res) + grp * 128 + (threadIdx.x & 31);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 a = p[32 * j];
    x[j][0] = a.x;
    x[j][1] = a.y;
    x[j][2] = a.z;
    x[j][3] = a.w;
  }
}

// The launch of a cluster kernel of shape X (X::SLICES slices a block,
// X::RK resident rows, X::BYTES of shared memory) at head dim D over grid
// (x, y, cluster_size(D)) on stream st; attr holds its cluster dimension
template <typename X>
cudaLaunchConfig_t cluster_config(int D, int x, int y, cudaStream_t st,
                                  cudaLaunchAttribute (&attr)[1]) {
  const int C = cluster_size(D);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(x, y, C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = X::BYTES;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the clusters of `kern` (shape X) at head dim D that the card holds at
// once, one block an SM (cudaOccupancyMaxActiveClusters) into *n
template <typename X, typename K>
cudaError_t active_clusters(K kern, int D, int* n) {
  cudaError_t e = allow_smem(kern, X::BYTES);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config<X>(D, 1, 1, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(n, kern, &cfg);
}

// `kern` (shape X) at cluster_form(D): clusters of cluster_size(D) blocks
// over grid (B*H, tiles of X::RK rows of `rows`, C). The card must be able
// to hold one such cluster at one block an SM (asked once for each
// kernel, device and C), or the launch is refused with
// cudaErrorLaunchOutOfResources. Reports `route` with the tier of a
// block's columns, 64 * X::SLICES.
template <typename X, typename... P, typename... A>
cudaError_t launch_cluster(void (*kern)(P...), int route, int rows, int B,
                           int H, int D, cudaStream_t st, A... args) {
  constexpr int NDEV = 16;
  static int fits[NDEV][9];  // by C: 0 unknown, 1 fits, -1 not
  int dev = 0, unknown = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = allow_smem(kern, X::BYTES);
  if (e != cudaSuccess) return e;
  int& ok = dev < NDEV ? fits[dev][cluster_size(D)] : unknown;
  if (ok == 0) {
    int n = 0;
    e = active_clusters<X>(kern, D, &n);
    if (e != cudaSuccess) return e;
    ok = n > 0 ? 1 : -1;
  }
  if (ok < 0) return cudaErrorLaunchOutOfResources;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config<X>(
      D, B * H, (rows + X::RK - 1) / X::RK, st, attr);
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e == cudaSuccess) set_attn_route(route, 0, X::SLICES * SL);
  return e;
}

// FN<NS> for head dim D's cluster tier
#define CLUSTER_NS_DISPATCH(FN, D, ...)   \
  switch (cluster_ns(D)) {                \
    case 2: return FN<2>(__VA_ARGS__);    \
    case 4: return FN<4>(__VA_ARGS__);    \
    default: return FN<8>(__VA_ARGS__);   \
  }

}  // namespace
