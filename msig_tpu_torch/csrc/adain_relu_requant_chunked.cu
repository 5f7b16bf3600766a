// Instance norm + AdaIN + ReLU + per-sample requant of an int32 map, the
// epilogue of the unfused trunk's relu sites: x [B, S, C] int32 -> int8
// [B, S, C], with the true per-channel extremes and the unfolded requant of
// conv_int8.cuh (true_relu_hi, relu_requant_unfolded).
//
// Replaces the TPU kernel msig_tpu/ops/int8_epilogue_chunked.py::
// adain_relu_requant_chunked, which walks a sequential (B, 2, S/512) grid:
// phase 0 carries fp32 sums, min and max across chunks in VMEM, phase 1
// requantizes. Blocks of a Hopper grid run in no order, so here the phases
// are parts of one persistent cooperative launch (as fused_trunk_blocks.cu),
// one grid of as many CTAs as the card holds at once, joined by grid
// barriers:
//   1. each CTA streams a contiguous share of one sample's rows (an item: the
//      sample's S rows cut into `parts` shares) with 16-byte loads, kUnroll
//      in flight a thread, and folds the exact statistics in registers and
//      shared memory: the integer sum, the square split at bit 32 into two
//      64-bit words, the true min and max. It writes them to its item's own
//      slot of the partials: no atomics, so nothing needs a fill first;
//   2. (after a barrier) each (sample, 32 channels) is reduced by one CTA,
//      a warp per share of the items, the warps' sums met in warp order; the
//      CTA builds the channels' affine as in_affine does and each channel's
//      part of the amax (true_relu_hi) and writes them;
//   3. (after a second barrier) each CTA takes its sample's amax from the
//      parts and the scale, then requantizes its own share, last-read rows
//      first, so that the rows it read last still lie in the 50 MB L2.
// The frame (the grid, the items, the barrier, the row walk and the warps'
// fold) is slab_coop.cuh's, shared with the whole-slab epilogues
// (int8_epilogue.cu).
// The reduction is a phase of its own so that each CTA reads its sample's
// C x 12 bytes of affine, not all of its sample's partials: those grow with
// the grid (parts x C x 32 bytes a sample), and each of a sample's `parts`
// CTAs would read them all.
//
// The input is any int32, not a conv output of known depth. So each square
// (< 2^62 for |x| <= 2^31) is split at bit 32 element by element and the
// halves are summed in two 64-bit words: exact for every int32 and for up to
// 2^32 rows, with no range check. Integer sums: the result does not depend on
// the grid or the order of the CTAs.
//
// Bound on an H100 at the main path's shape [8, 4096, 256]: 33.6 MB read and
// 8.4 MB written, 12.5 us at 3.35 TB/s; bytes bound it. This design reads the
// int32 map twice (statistics, then requant); the second read mostly hits the
// L2 at this size. Two CTAs of 256 threads an SM: the grid barriers cost more
// the more CTAs meet at them (tools/optin_rows_torch.py times the grid at
// one, two, three and four CTAs an SM, the unroll, the requant's order and the
// second barrier replaced by a second launch).
#include <climits>

#include "conv_int8.cuh"
#include "slab_coop.cuh"

namespace msig {
namespace chunked {

using namespace coop;

constexpr int kUnroll = 4;    // 16-byte loads in flight a thread
constexpr int kSmem = 32768;  // phase 1's fold of the warps, then phase 3's affine
constexpr int kMaxC = kSmem / 8;

struct Args {
  const int32_t* x;     // [B, S, C]
  const float* gamma;   // [B, C]
  const float* beta;    // [B, C]
  long long* ws;        // the workspace (Work)
  int8_t* out;          // [B, S, C]
  int B, S, C, parts;   // parts: items a sample
  float eps;
};

// The workspace, for items = B * parts: the partials' sums, low and high
// words of the squares [items * C] (int64), their mins and maxes [items * C]
// (int32 each), then the affine a, d and the amax parts [3][B * C] (float):
// 4 * items * C + ceil(3 * B * C / 2) int64 words.
struct Work {
  long long* sum;
  unsigned long long *lo, *hi;
  int *mn, *mx;
  float* aff;
  __device__ explicit Work(const Args& p) {
    const size_t n = (size_t)p.B * p.parts * p.C;
    sum = p.ws;
    lo = reinterpret_cast<unsigned long long*>(p.ws + n);
    hi = reinterpret_cast<unsigned long long*>(p.ws + 2 * n);
    mn = reinterpret_cast<int*>(p.ws + 3 * n);
    mx = mn + n;
    aff = reinterpret_cast<float*>(p.ws + 4 * n);
  }
};

// A thread's statistics of its four channels.
struct Stats4 {
  long long s[4];
  unsigned long long lo[4], hi[4];
  int mn[4], mx[4];
  __device__ void clear() {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = 0, lo[j] = 0, hi[j] = 0, mn[j] = INT_MAX, mx[j] = INT_MIN;
  }
  __device__ void add(const int4& v) {
    const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned long long sq = (unsigned long long)((long long)e[j] * e[j]);
      s[j] += e[j];
      lo[j] += sq & 0xffffffffull;
      hi[j] += sq >> 32;
      mn[j] = min(mn[j], e[j]);
      mx[j] = max(mx[j], e[j]);
    }
  }
};

// Phases 1-2 meet the warps' partials here, [kWarps][kTileC] each.
struct Fold {
  long long s[kWarps][kTileC];
  unsigned long long lo[kWarps][kTileC], hi[kWarps][kTileC];
  int mn[kWarps][kTileC], mx[kWarps][kTileC];
};
static_assert(sizeof(Fold) <= kSmem, "the fold fits the shared block");

__global__ void __launch_bounds__(kThreads, 2) chunked_epilogue_kernel(Args p) {
  __shared__ __align__(16) unsigned char smem[kSmem];
  __shared__ float red[32];
  Fold& f = *reinterpret_cast<Fold*>(smem);
  const Work w(p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int items = p.B * p.parts, C = p.C, C4 = C / 4;
  const size_t BC = (size_t)p.B * C;

  // 1. Each item's statistics, one tile of 128 channels after the other: warp
  // k takes rows r0 + k, r0 + k + 8, ..., lane l channels 4l .. 4l + 3.
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int b, r0, r1;
    item_rows(item, p.parts, p.S, 1, b, r0, r1);
    for (int ct = 0; ct < C / kTileC; ++ct) {
      const int4* xc = reinterpret_cast<const int4*>(p.x + (size_t)b * p.S * C) + ct * 32 + lane;
      Stats4 a;
      a.clear();
      walk_rows<false, kUnroll>(
          r0, r1, warp, [&](int r) { return __ldg(xc + (size_t)r * C4); },
          [&](const int4& v, int) { a.add(v); });
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * lane + j;
        f.s[warp][c] = a.s[j], f.lo[warp][c] = a.lo[j], f.hi[warp][c] = a.hi[j];
        f.mn[warp][c] = a.mn[j], f.mx[warp][c] = a.mx[j];
      }
      __syncthreads();
      if (threadIdx.x < kTileC) {  // channel c of the tile, the warps in order
        const int c = threadIdx.x;
        const size_t i = (size_t)item * C + ct * kTileC + c;
        w.sum[i] = fold_warps(f.s, c, 0LL, Plus<long long>());
        w.lo[i] = fold_warps(f.lo, c, 0ull, Plus<unsigned long long>());
        w.hi[i] = fold_warps(f.hi, c, 0ull, Plus<unsigned long long>());
        w.mn[i] = fold_warps(f.mn, c, INT_MAX, Min());
        w.mx[i] = fold_warps(f.mx, c, INT_MIN, Max());
      }
      __syncthreads();
    }
  }
  grid_barrier();

  // 2. (sample, 32 channels) unit by unit: warp k sums items k, k + 8, ... of
  // the sample (read past L1: written in this launch), lane l channel l; the
  // warps meet in order and thread l builds channel l's affine and amax part.
  const int groups = C / 32;
  for (int unit = blockIdx.x; unit < p.B * groups; unit += gridDim.x) {
    const int b = unit / groups, c = (unit % groups) * 32 + lane;
    long long s = 0;
    unsigned long long lo = 0, hi = 0;
    int mn = INT_MAX, mx = INT_MIN;
    for (int k = warp; k < p.parts; k += kWarps) {
      const size_t i = ((size_t)b * p.parts + k) * C + c;
      s += __ldcg(w.sum + i), lo += __ldcg(w.lo + i), hi += __ldcg(w.hi + i);
      mn = min(mn, __ldcg(w.mn + i)), mx = max(mx, __ldcg(w.mx + i));
    }
    f.s[warp][lane] = s, f.lo[warp][lane] = lo, f.hi[warp][lane] = hi;
    f.mn[warp][lane] = mn, f.mx[warp][lane] = mx;
    __syncthreads();
    if (threadIdx.x < 32) {
      const size_t i = (size_t)b * C + c;
      float a, d;
      affine_of(fold_warps(f.s, lane, 0LL, Plus<long long>()),
                fold_warps(f.lo, lane, 0ull, Plus<unsigned long long>()),
                fold_warps(f.hi, lane, 0ull, Plus<unsigned long long>()), p.gamma[i], p.beta[i],
                (float)p.S, p.eps, a, d);
      w.aff[i] = a, w.aff[BC + i] = d;
      w.aff[2 * BC + i] = true_relu_hi(a, d, (float)fold_warps(f.mn, lane, INT_MAX, Min()),
                                       (float)fold_warps(f.mx, lane, INT_MIN, Max()));
    }
    __syncthreads();
  }
  grid_barrier();

  // 3. The CTA's items in reverse order, each item's tiles and rows from the
  // last read; the sample's affine and scale loaded where the sample changes.
  float* a_s = reinterpret_cast<float*>(smem);
  float* d_s = a_s + C;
  if ((int)blockIdx.x >= items) return;
  int held = -1;
  float sc = 1.f;
  const int last = blockIdx.x + (items - 1 - blockIdx.x) / gridDim.x * gridDim.x;
  for (int item = last; item >= (int)blockIdx.x; item -= gridDim.x) {
    int b, r0, r1;
    item_rows(item, p.parts, p.S, 1, b, r0, r1);
    if (b != held) {
      __syncthreads();  // the last item's rows have read a_s, d_s
      float local = 0.f;  // max(hi, 0)
      for (int c = threadIdx.x; c < C; c += kThreads) {
        const size_t i = (size_t)b * C + c;
        a_s[c] = __ldcg(w.aff + i), d_s[c] = __ldcg(w.aff + BC + i);
        local = fmaxf(local, __ldcg(w.aff + 2 * BC + i));
      }
      sc = relu_scale(block_max(local, red));  // block_max syncs: a_s, d_s are in place
      held = b;
    }
    const int4* xb = reinterpret_cast<const int4*>(p.x + (size_t)b * p.S * C);
    char4* ob = reinterpret_cast<char4*>(p.out + (size_t)b * p.S * C);
    for (int ct = C / kTileC - 1; ct >= 0; --ct) {
      const int g = ct * 32 + lane;  // the thread's group of four channels
      const float4 a = reinterpret_cast<const float4*>(a_s)[g];
      const float4 d = reinterpret_cast<const float4*>(d_s)[g];
      walk_rows<true, kUnroll>(
          r0, r1, warp, [&](int r) { return __ldg(xb + (size_t)r * C4 + g); },
          [&](const int4& v, int r) {
            ob[(size_t)r * C4 + g] = make_char4(relu_requant_unfolded((float)v.x, a.x, d.x, sc),
                                                relu_requant_unfolded((float)v.y, a.y, d.y, sc),
                                                relu_requant_unfolded((float)v.z, a.z, d.z, sc),
                                                relu_requant_unfolded((float)v.w, a.w, d.w, sc));
          });
    }
  }
}

// The cooperative grid on the current device: as many CTAs as fit at once.
static int cooperative_grid(int* grid) {
  static int cached[kMaxDevices] = {0};
  return coop::cooperative_grid((const void*)chunked_epilogue_kernel, cached, grid);
}

}  // namespace chunked
}  // namespace msig

// The grid that msig_adain_relu_requant_chunked launches on the current
// device (*grid); the caller cuts each sample into parts = max(1, grid / B)
// items. Returns a CUDA error code (0 = success).
extern "C" int msig_adain_relu_requant_chunked_grid(int* grid) {
  return msig::chunked::cooperative_grid(grid);
}

// Returns the CUDA error of the launch (0 = success). One cooperative launch
// on `stream`; does not synchronise. x: [B, S, C] int32; gamma, beta: [B, C]
// float32; ws: int64 [4*B*parts*C + ceil(3*B*C / 2)], needs no fill; out:
// [B, S, C] int8. Needs C % 128 == 0, C <= 4096 and parts >= 1.
extern "C" int msig_adain_relu_requant_chunked(const void* x, const void* gamma, const void* beta,
                                               void* ws, void* out, int B, int S, int C,
                                               int parts, float eps, void* stream) {
  using namespace msig::chunked;
  if (C % kTileC != 0 || C > kMaxC || parts < 1 || B < 1) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int err = cooperative_grid(&grid);
  if (err != 0) return err;
  Args p{static_cast<const int32_t*>(x), static_cast<const float*>(gamma),
         static_cast<const float*>(beta), static_cast<long long*>(ws), static_cast<int8_t*>(out),
         B, S, C, parts, eps};
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)chunked_epilogue_kernel, dim3(grid),
                                                    dim3(kThreads), args, 0,
                                                    reinterpret_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
