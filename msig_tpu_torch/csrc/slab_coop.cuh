// The frame of the port's one-launch epilogues over an int32 map x [B, S, C]
// (S rows of a sample, C channels): the chunked relu epilogue
// (adain_relu_requant_chunked.cu) and the whole-slab epilogues
// (int8_epilogue.cu). Each is one persistent cooperative launch of kThreads
// CTAs, as many as the card holds at once, whose phases meet at grid
// barriers. Each sample's rows are cut into items; an item's statistics go to
// a slot of their own in a workspace the wrapper allocates with torch.empty,
// so nothing needs a fill and nothing adds with atomics. A pass over an
// item's rows takes kTileC channels at a time: warp w walks rows r0 + w,
// r0 + w + kWarps, ..., lane l loads channels 4l .. 4l + 3 of a row in one
// 16-byte load, several rows in flight a thread; the warps' partials then
// meet in shared memory in warp order.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace msig {
namespace coop {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileC = 128;  // channels a pass over an item's rows: 32 lanes of 4
constexpr int kMaxDevices = 64;

// The grid of a cooperative launch of `kernel` (kThreads a CTA, dyn_smem bytes
// of dynamic shared memory, its attribute set here past 48 KB) on the current
// device: as many CTAs as fit at once. The query is made once per device into
// the caller's `cache`. Returns a CUDA error code (0 = success).
inline int cooperative_grid(const void* kernel, int (&cache)[kMaxDevices], int* grid,
                            int dyn_smem = 0) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (dyn_smem > 48 * 1024)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, dyn_smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cache[dev] = per_sm * sms;
  }
  *grid = cache[dev];
  return 0;
}

// Item `item` of a launch: share item % parts of sample item / parts. The
// sample's S rows are taken in blocks of `unit` rows (the last one ragged) and
// the blocks cut into `parts` contiguous shares; the item's rows are [r0, r1).
__device__ __forceinline__ void item_rows(int item, int parts, int S, int unit, int& b, int& r0,
                                          int& r1) {
  b = item / parts;
  const long long k = item % parts, blocks = ((long long)S + unit - 1) / unit;
  r0 = (int)min((long long)S, unit * (k * blocks / parts));
  r1 = (int)min((long long)S, unit * ((k + 1) * blocks / parts));
}

// Every CTA of the launch waits here for all the others. Data written before
// it by another CTA is read after it past L1 (__ldcg).
__device__ __forceinline__ void grid_barrier() { cooperative_groups::this_grid().sync(); }

// Warp `warp`'s rows of [r0, r1): r0 + warp, r0 + warp + kWarps, ... in that
// order, or (kReverse) the same rows from the last. load(r) is issued for
// kUnroll rows before use(v, r) runs on each of them, in the walk's order.
template <bool kReverse, int kUnroll, class Load, class Use>
__device__ __forceinline__ void walk_rows(int r0, int r1, int warp, Load load, Use use) {
  using V = decltype(load(r0));
  constexpr int kStep = kWarps * kUnroll;
  if constexpr (!kReverse) {
    for (int r = r0 + warp; r < r1; r += kStep) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = r + u * kWarps < r1 ? load(r + u * kWarps) : V{};
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u * kWarps < r1) use(v[u], r + u * kWarps);
    }
  } else {
    for (int r = r1 - 1 - warp; r >= r0; r -= kStep) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = r - u * kWarps >= r0 ? load(r - u * kWarps) : V{};
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r - u * kWarps >= r0) use(v[u], r - u * kWarps);
    }
  }
}

// The folds' operations: sums of integer counts, true extremes.
template <class T> struct Plus {
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Min {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct Max {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

// The warps' partials of entry c met in warp order:
// op(... op(op(acc, part[0][c]), part[1][c]) ..., part[kWarps - 1][c]).
template <class T, int N, class Op>
__device__ __forceinline__ T fold_warps(const T (&part)[kWarps][N], int c, T acc, Op op) {
#pragma unroll
  for (int k = 0; k < kWarps; ++k) acc = op(acc, part[k][c]);
  return acc;
}

}  // namespace coop
}  // namespace msig
