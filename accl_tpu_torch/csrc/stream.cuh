// Streams: the launch geometry and memory accesses of B1 (combine.cu)
// and B2 (wire_lanes.cu `cast_kernel`).
//
// Both kernels move every byte once and do next to no arithmetic, so the
// H100's memory rate bounds them. A row of n elements is ceil(n / TILE)
// tiles, the last one ragged; a tile is one step of every thread of a
// block. The grid is (tiles of a row, nrows) (`stream_grid`): block
// (g, r) takes tile g of row r. That is tens of thousands of short
// blocks that the hardware hands to whichever SM has room, so no SM
// idles while another still has work. On the H100 it measured faster
// than a persistent grid of one wave (SMs x resident blocks, fixed
// shares a block), whose blocks finish unevenly, and than the capped
// grid-stride grid it replaces (PERF.md §6). No index is divided at
// run time: the tile sizes are powers of two.
//
// A thread-step is one access of up to 16 bytes on each side (`Pack`),
// by neighbouring threads at neighbouring addresses. A row takes the
// vector steps when its pointers are aligned to them; a ragged tile, or
// a row that is not aligned, takes scalar accesses where steps do not
// fit, still one element a thread at neighbouring addresses.
#pragma once

#include "common.cuh"

#define STREAM_THREADS 256

// E elements of S, read or written as one access (several 16-byte ones
// when wider than 16 bytes)
template <typename S, int E>
struct alignas(sizeof(S) * E < 16 ? sizeof(S) * E : 16) Pack {
  S v[E];
};

template <typename P>
__device__ __forceinline__ bool aligned_for(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & (alignof(P) - 1)) == 0;
}

// One block a tile of E-element steps: the grid over nrows rows of n
// elements (n > 0).
template <int E>
static inline dim3 stream_grid(long long n, int nrows) {
  constexpr long long TILE = STREAM_THREADS * E;
  return dim3(static_cast<unsigned>((n + TILE - 1) / TILE), nrows);
}

// Tile blockIdx.x of a row of n elements: steps of E elements (step(s)
// covers elements [s * E, (s + 1) * E)) as far as they go where `vec`,
// then one(i) per element. A whole tile of a vector row is one step a
// thread, with no loop around it: the tile's own instructions are most
// of what a thread issues.
template <int E, class Step, class One>
__device__ __forceinline__ void stream_tile(bool vec, long long n, Step step,
                                            One one) {
  constexpr long long TILE = STREAM_THREADS * E;
  const long long e0 = blockIdx.x * TILE;
  const long long e1 = e0 + TILE < n ? e0 + TILE : n;
  if (vec && e1 - e0 == TILE) {
    step(e0 / E + threadIdx.x);
    return;
  }
  const long long ve = vec ? e0 + (e1 - e0) / E * E : e0;
  for (long long s = e0 / E + threadIdx.x; s < ve / E; s += STREAM_THREADS)
    step(s);
  for (long long i = ve + threadIdx.x; i < e1; i += STREAM_THREADS) one(i);
}
