// Whole-slab epilogues of an int32 conv output x [B, S, C] (S rows of a
// sample, C channels), with the TPU's two-pass fp32 instance norm:
//   norm_mod(x) = (fp32(x) - m) * k + beta,  k = rcp(sqrt(v + eps)) * gamma,
//   m = mean of fp32(x), v = mean of fp32((fp32(x) - m)^2), over the S rows;
//   msig_adain_relu_requant:     y = max(norm_mod(x), 0), amax = max y, q = int8(y);
//   msig_adain_residual_requant: h = norm_mod(x) + residual, amax = max |h|,
//                                h out in the residual's dtype and q = int8(h) from fp32 h;
//   q = clip(round(v * s), +-127), s = 127/amax (1 where amax is 0).
//
// Replaces msig_tpu/ops/int8_epilogue.py::adain_relu_requant (:93, its
// _relu_kernel) and ::adain_residual_requant (:106, _residual_kernel), which
// hold a sample's whole [S, C] slab in VMEM (S*C*4 <= 8 MB) and reduce it there
// in fp32. An SM holds 227 KB, so here each call is one persistent cooperative
// launch on the frame of slab_coop.cuh (as adain_relu_requant_chunked.cu): two
// CTAs of 256 threads an SM, as many as the card holds at once, phases joined
// by grid barriers. An item is one 128-row chunk of a sample (the last one
// ragged), so every partial below belongs to a chunk and none depends on the
// grid; each goes to the chunk's own slot of a workspace the wrapper takes from
// torch.empty: no fill, no atomics, and two calls give the same bits.
//   1. Each CTA streams its chunks' rows once (16-byte loads, four in flight a
//      thread): per channel the sum of fp32(x), exact in int64 (every fp32(x)
//      is an integer below 2^31 in magnitude), and for the relu form the true
//      min and max of x. It keeps the first rows of each chunk's tiles in
//      96 KB of dynamic shared memory (96 of 128 rows a tile at one chunk a
//      CTA): the later passes read those from there, the rest from the L2.
//   2. (barrier) One CTA per (sample, 32 channels) adds the chunks' sums and
//      writes m, the exact sum rounded once, over S; for the relu form also the
//      sample's extremes. A phase of its own because the sums grow with S
//      (C x 8 bytes a chunk): each of a sample's CTAs would read all of them.
//   3. (barrier) Each CTA reads its chunks again, their tiles last-read first,
//      and sums the fp32 squares of fsub(fp32(x), m) in fp64 in the order of
//      the plain version (ops/int8_epilogue.py::deviation_sq_sum): warp w of a
//      chunk adds rows w, w + 8, ..., w + 120 in that order, the eight warps
//      meet as a pairwise tree. One partial per (chunk, channel).
//   4. (barrier) One CTA per (sample, 32 channels) adds the chunks' partials as
//      a pairwise tree of adjacent chunks (zero-padded to a power of two, in
//      blocks of 64 in shared memory) and writes k. The relu form also writes
//      each 32 channels' part of the amax: norm_mod's rounded operations are
//      each monotone in x (non-increasing where k < 0), so the largest
//      max(norm_mod(x), 0) of a channel is that of its min or its max, exactly.
//   5. Relu form: (barrier) each CTA takes its sample's amax from the parts and
//      requantizes its chunks. Residual form: (barrier) each CTA computes fp32
//      h over its chunks, writes the chunk's max|h| and keeps h in place of
//      the cached rows of x; (barrier) then it writes h in the residual's dtype
//      and the int8 from fp32 h, last-read first, h from the cache or again
//      from x and the residual. The residual, h and the int8 pass with the
//      streaming cache hints, so that they do not push x out of the L2.
// x is read from the card's memory once, then from shared memory or the L2
// (twice; three times in the residual form), the residual once or twice.
// Bytes a pass at [8, 4096, 256], of which a quarter of x (the rows not kept)
// comes again from the L2 or the card's memory: sums 33.6 MB of x in;
// squares 8.4 MB; relu requant 8.4 MB in, 8.4 MB of int8 out; residual form's
// max|h| 16.8 MB of bf16 residual + 8.4 MB, its requant 4.2 MB of residual +
// 8.4 MB in, 16.8 MB of h and 8.4 MB of int8 out.
//
// Bound on an H100 at [8, 4096, 256] (the trunk's map at a 256² input): relu,
// 33.6 MB read + 8.4 MB written = 41.9 MB, 12.5 us at 3.35 TB/s; residual with
// a bf16 residual, + 16.8 MB read + 16.8 MB written = 75.5 MB, 22.5 us. Bytes
// bound both. The launch and its grid barriers (four; five) alone take about
// 8 us (tools/slab_rows_torch.py, "barriers alone"); the SMs hold 227 KB of
// shared memory each against x's 254 KB a SM at this shape.
#include <cuda_bf16.h>

#include <climits>
#include <type_traits>

#include "conv_int8.cuh"
#include "slab_coop.cuh"

// Internal linkage throughout: a process may load several builds of this
// source (tools/slab_rows_torch.py), and a template's static (the grid's
// cache) would otherwise be one object shared by all of them.
namespace msig {
namespace slab {
namespace {

using namespace coop;

constexpr int kRows = 128;    // rows of a chunk: an item
constexpr int kUnroll = 4;    // rows in flight a thread: 16-byte loads of x
constexpr int kUnrollRes = 8;  // in the residual form's last two passes: x (or h) and the residual
constexpr int kSmem = 16384;  // the warps' folds (phases 1-3), then phase 4's tree
constexpr int kTree = kSmem / (32 * 8);  // chunks of 32 channels in phase 4's tree
// Dynamic shared memory a CTA: the first rows of its chunks' tiles, kept
// across the barriers (two CTAs an SM fill the SM's 227 KB with the static block).
constexpr int kCacheBytes = 96 * 1024;

// The residual's element type: four loaded as they are (Raw), unpacked to
// fp32 when used, four stored (round to nearest), with the streaming cache
// hints: read or written once, they leave x in the L2.
template <class R> struct ResOf;
template <> struct ResOf<float> {
  using Raw = float4;
  __device__ static Raw load(const float* p) { return __ldcs(reinterpret_cast<const float4*>(p)); }
  __device__ static void unpack(const Raw& v, float (&f)[4]) {
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  __device__ static void store4(float* p, const float (&f)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));
  }
};
template <> struct ResOf<__nv_bfloat16> {
  using Raw = uint2;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint2*>(p));
  }
  __device__ static void unpack(const Raw& u, float (&f)[4]) {
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    f[0] = __low2float(lo), f[1] = __high2float(lo), f[2] = __low2float(hi),
    f[3] = __high2float(hi);
  }
  __device__ static void store4(__nv_bfloat16* p, const float (&f)[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned int*>(&lo);
    u.y = *reinterpret_cast<const unsigned int*>(&hi);
    __stcs(reinterpret_cast<uint2*>(p), u);
  }
};

// R = void: the relu form; else the residual's element type.
template <class R> struct Args {
  const int32_t* x;     // [B, S, C]
  const float* gamma;   // [B, C]
  const float* beta;    // [B, C]
  const R* res;         // [B, S, C] (residual form)
  R* h;                 // [B, S, C] (residual form)
  long long* ws;        // the workspace (Work)
  int8_t* out;          // [B, S, C]
  int B, S, C;
  float eps;
};

// The workspace, for N = B * chunks * C: per (chunk, channel) the sums [N]
// (int64) and the squares' partials [N] (fp64), the mins and maxes [N] (int32
// each); per (sample, channel) m, k [B*C] (float) and the extremes [B*C]
// (int32 each); the amax parts per (sample, 32 channels) [B*C/32] and the
// max|h| per chunk [B*chunks] (float): 3N + ceil((4BC + BC/32 + B*chunks) / 2)
// int64 words (ops/int8_epilogue.py::workspace_words).
struct Work {
  long long* sum;
  double* sq;
  int *mn, *mx;
  float *m, *k;
  int *cmn, *cmx;
  float *hi, *amax;
  template <class R> __device__ explicit Work(const Args<R>& p, int chunks) {
    const size_t n = (size_t)p.B * chunks * p.C, bc = (size_t)p.B * p.C;
    sum = p.ws;
    sq = reinterpret_cast<double*>(p.ws + n);
    mn = reinterpret_cast<int*>(p.ws + 2 * n);
    mx = mn + n;
    m = reinterpret_cast<float*>(p.ws + 3 * n);
    k = m + bc;
    cmn = reinterpret_cast<int*>(k + bc);
    cmx = cmn + bc;
    hi = reinterpret_cast<float*>(cmx + bc);
    amax = hi + bc / 32;
  }
};

// The warps' partials of phases 1-2, [kWarps][kTileC] each; phase 3's are
// fp64 (SqFold) in the same shared block, and phase 4's tree is there too.
struct SumFold {
  long long s[kWarps][kTileC];
  int mn[kWarps][kTileC], mx[kWarps][kTileC];
};
using SqFold = double[kWarps][kTileC];
static_assert(sizeof(SumFold) <= kSmem && sizeof(SqFold) <= kSmem, "the folds fit the block");
static_assert(kTree * 32 * sizeof(double) == kSmem && (kTree & (kTree - 1)) == 0,
              "phase 4's tree fills the shared block, a power of two of chunks");

__device__ __forceinline__ float norm_mod(int v, float m, float k, float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(__int2float_rn(v), m), k), beta);
}

// The eight warps' fp64 partials of entry c as a pairwise tree:
// ((q0 + q1) + (q2 + q3)) + ((q4 + q5) + (q6 + q7)).
__device__ __forceinline__ double warp_tree(const SqFold& q, int c) {
  static_assert(kWarps == 8, "the tree is written for eight warps");
  return __dadd_rn(__dadd_rn(__dadd_rn(q[0][c], q[1][c]), __dadd_rn(q[2][c], q[3][c])),
                   __dadd_rn(__dadd_rn(q[4][c], q[5][c]), __dadd_rn(q[6][c], q[7][c])));
}

// Channel coefficients of a lane's four channels at entry i = b*C + c (c % 4 == 0).
struct Coef4 {
  float m[4], k[4], beta[4];
  __device__ Coef4(const Work& w, const float* beta_g, size_t i) {
    const float4 mv = __ldcg(reinterpret_cast<const float4*>(w.m + i));
    const float4 kv = __ldcg(reinterpret_cast<const float4*>(w.k + i));
    m[0] = mv.x, m[1] = mv.y, m[2] = mv.z, m[3] = mv.w;
    k[0] = kv.x, k[1] = kv.y, k[2] = kv.z, k[3] = kv.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) beta[j] = __ldg(beta_g + i + j);
  }
};

template <class R> struct XRow {  // a lane's four channels of one row: x (or h) and the residual
  int4 x;
  typename ResOf<R>::Raw r;
};

__device__ __forceinline__ signed char requant(float v, float s) {
  return (signed char)min(max(__float2int_rn(__fmul_rn(v, s)), -127), 127);
}

template <class R>
__global__ void __launch_bounds__(kThreads, 2) slab_epilogue_kernel(Args<R> p) {
  constexpr bool kRelu = std::is_void<R>::value;
  __shared__ __align__(16) unsigned char smem[kSmem];
  __shared__ float red[32];
  extern __shared__ int4 cache[];  // kCacheBytes: rows kept across the barriers
  SumFold& f = *reinterpret_cast<SumFold*>(smem);
  SqFold& fq = *reinterpret_cast<SqFold*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = p.C, C4 = C / 4, chunks = (p.S + kRows - 1) / kRows, items = p.B * chunks;
  const int groups = C / 32, tiles = C / kTileC;
  const Work w(p, chunks);
  const float n = (float)p.S;
  // The CTA's items k = 0, 1, ... (item blockIdx.x + k * gridDim.x) keep the
  // first `nr` rows of each tile in the cache, 32 int4 a row: x from phase 1
  // on, then h in the residual form's phase 5.
  const int mine = (int)blockIdx.x < items ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int nr = mine ? min(kRows, kCacheBytes / 512 / (mine * tiles)) : 0;
  auto cached = [&](int item, int ct) {
    return cache + (size_t)(((item - (int)blockIdx.x) / (int)gridDim.x) * tiles + ct) * nr * 32 +
           lane;
  };

  // 1. Each chunk's sums (and extremes), one tile of 128 channels after the
  // other: warp k takes rows r0 + k, r0 + k + 8, ..., lane l channels 4l .. 4l + 3.
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int b, r0, r1;
    item_rows(item, chunks, p.S, kRows, b, r0, r1);
    for (int ct = 0; ct < tiles; ++ct) {
      const int4* xc = reinterpret_cast<const int4*>(p.x + (size_t)b * p.S * C) + ct * 32 + lane;
      int4* cr = cached(item, ct);
      long long s[4] = {0, 0, 0, 0};
      int mn[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
      int mx[4] = {INT_MIN, INT_MIN, INT_MIN, INT_MIN};
      walk_rows<false, kUnroll>(
          r0, r1, warp, [&](int r) { return __ldg(xc + (size_t)r * C4); },
          [&](const int4& v, int r) {
            if (r - r0 < nr) cr[(r - r0) * 32] = v;
            const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[j] += (long long)__int2float_rn(e[j]);
              if constexpr (std::is_void<R>::value)
                mn[j] = min(mn[j], e[j]), mx[j] = max(mx[j], e[j]);
            }
          });
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f.s[warp][4 * lane + j] = s[j];
        if constexpr (kRelu) f.mn[warp][4 * lane + j] = mn[j], f.mx[warp][4 * lane + j] = mx[j];
      }
      __syncthreads();
      if (threadIdx.x < kTileC) {  // channel c of the tile, the warps in order
        const int c = threadIdx.x;
        const size_t i = (size_t)item * C + ct * kTileC + c;
        w.sum[i] = fold_warps(f.s, c, 0LL, Plus<long long>());
        if constexpr (kRelu) {
          w.mn[i] = fold_warps(f.mn, c, INT_MAX, Min());
          w.mx[i] = fold_warps(f.mx, c, INT_MIN, Max());
        }
      }
      __syncthreads();
    }
  }
  grid_barrier();

  // 2. m per (sample, 32 channels): warp k adds chunks k, k + 8, ... of the
  // sample (read past L1: written in this launch), lane l channel l.
  for (int unit = blockIdx.x; unit < p.B * groups; unit += gridDim.x) {
    const int b = unit / groups, c = (unit % groups) * 32 + lane;
    long long s = 0;
    int mn = INT_MAX, mx = INT_MIN;
    for (int k = warp; k < chunks; k += kWarps) {
      const size_t i = ((size_t)b * chunks + k) * C + c;
      s += __ldcg(w.sum + i);
      if constexpr (kRelu) mn = min(mn, __ldcg(w.mn + i)), mx = max(mx, __ldcg(w.mx + i));
    }
    f.s[warp][lane] = s;
    if constexpr (kRelu) f.mn[warp][lane] = mn, f.mx[warp][lane] = mx;
    __syncthreads();
    if (threadIdx.x < 32) {
      const size_t i = (size_t)b * C + c;
      w.m[i] = __fdiv_rn(__ll2float_rn(fold_warps(f.s, lane, 0LL, Plus<long long>())), n);
      if constexpr (kRelu) {
        w.cmn[i] = fold_warps(f.mn, lane, INT_MAX, Min());
        w.cmx[i] = fold_warps(f.mx, lane, INT_MIN, Max());
      }
    }
    __syncthreads();
  }
  grid_barrier();

  // 3. Each chunk's fp64 sum of the squared deviations, the CTA's chunks and
  // their tiles from the last read in phase 1, each warp's rows in order.
  if (mine) {
    const int last = blockIdx.x + (mine - 1) * gridDim.x;
    for (int item = last; item >= (int)blockIdx.x; item -= gridDim.x) {
      int b, r0, r1;
      item_rows(item, chunks, p.S, kRows, b, r0, r1);
      for (int ct = tiles - 1; ct >= 0; --ct) {
        const int4* xc = reinterpret_cast<const int4*>(p.x + (size_t)b * p.S * C) + ct * 32 + lane;
        const int4* cr = cached(item, ct);
        const float4 mv =
            __ldcg(reinterpret_cast<const float4*>(w.m + (size_t)b * C) + ct * 32 + lane);
        const float m[4] = {mv.x, mv.y, mv.z, mv.w};
        double q[4] = {0.0, 0.0, 0.0, 0.0};
        walk_rows<false, kUnroll>(
            r0, r1, warp,
            [&](int r) { return r - r0 < nr ? cr[(r - r0) * 32] : __ldg(xc + (size_t)r * C4); },
            [&](const int4& v, int) {
              const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float d = __fsub_rn(__int2float_rn(e[j]), m[j]);
                q[j] = __dadd_rn(q[j], (double)__fmul_rn(d, d));
              }
            });
#pragma unroll
        for (int j = 0; j < 4; ++j) fq[warp][4 * lane + j] = q[j];
        __syncthreads();
        if (threadIdx.x < kTileC)
          w.sq[(size_t)item * C + ct * kTileC + threadIdx.x] = warp_tree(fq, threadIdx.x);
        __syncthreads();
      }
    }
  }
  grid_barrier();

  // 4. k per (sample, 32 channels): the chunks' partials as a tree of adjacent
  // pairs, kTree chunks at a time in shared memory; past kTree chunks each
  // block's sum goes back to the slot of chunk `block` (read before), and the
  // blocks' sums are added the same way.
  double (&t)[kTree][32] = *reinterpret_cast<double(*)[kTree][32]>(smem);
  for (int unit = blockIdx.x; unit < p.B * groups; unit += gridDim.x) {
    const int b = unit / groups, c0 = (unit % groups) * 32;
    const size_t i = (size_t)b * C + c0 + lane;
    float gamma = 0.f, beta = 0.f, m = 0.f;
    int cmn = 0, cmx = 0;
    if (threadIdx.x < 32) {  // loaded ahead of the tree
      gamma = p.gamma[i];
      if constexpr (kRelu)
        beta = p.beta[i], m = __ldcg(w.m + i), cmn = __ldcg(w.cmn + i), cmx = __ldcg(w.cmx + i);
    }
    double* sq = w.sq + (size_t)b * chunks * C + c0;
    for (int len = chunks;;) {
      const int blocks = (len + kTree - 1) / kTree;
      for (int blk = 0; blk < blocks; ++blk) {
        const int cnt = min(kTree, len - blk * kTree);
        int width = 1;
        while (width < cnt) width <<= 1;
        for (int e = threadIdx.x; e < width * 32; e += kThreads) {
          const int j = e >> 5;
          t[j][e & 31] = j < cnt ? __ldcg(sq + (size_t)(blk * kTree + j) * C + (e & 31)) : 0.0;
        }
        __syncthreads();
        for (int s = 1; s < width; s <<= 1) {
          for (int e = threadIdx.x; e < width / (2 * s) * 32; e += kThreads) {
            const int j = (e >> 5) * 2 * s;
            t[j][e & 31] = __dadd_rn(t[j][e & 31], t[j + s][e & 31]);
          }
          __syncthreads();
        }
        if (blocks > 1) {
          if (threadIdx.x < 32) sq[(size_t)blk * C + threadIdx.x] = t[0][threadIdx.x];
          __syncthreads();
        }
      }
      if (blocks == 1) break;
      len = blocks;
    }
    if (threadIdx.x < 32) {
      const float v = __fdiv_rn(__double2float_rn(t[0][lane]), n);
      const float k = __fmul_rn(__frcp_rn(__fsqrt_rn(__fadd_rn(v, p.eps))), gamma);
      w.k[i] = k;
      if constexpr (kRelu) {
        float hi = fmaxf(norm_mod(cmn, m, k, beta), norm_mod(cmx, m, k, beta));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
        if (lane == 0) w.hi[(size_t)b * groups + c0 / 32] = hi;
      }
    }
    __syncthreads();
  }
  grid_barrier();

  if constexpr (kRelu) {
    // 5. The CTA's chunks from the first, as phase 3 left them last; the
    // sample's scale from its amax parts where the sample changes.
    int held = -1;
    float sc = 1.f;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      int b, r0, r1;
      item_rows(item, chunks, p.S, kRows, b, r0, r1);
      if (b != held) {
        float local = 0.f;  // max(hi, 0)
        for (int g = threadIdx.x; g < groups; g += kThreads)
          local = fmaxf(local, __ldcg(w.hi + (size_t)b * groups + g));
        sc = relu_scale(block_max(local, red));
        held = b;
      }
      const int4* xb = reinterpret_cast<const int4*>(p.x + (size_t)b * p.S * C);
      char4* ob = reinterpret_cast<char4*>(p.out + (size_t)b * p.S * C);
      for (int ct = 0; ct < tiles; ++ct) {
        const int g = ct * 32 + lane;  // the thread's group of four channels
        const int4* cr = cached(item, ct);
        const Coef4 cf(w, p.beta, (size_t)b * C + 4 * g);
        walk_rows<false, kUnroll>(
            r0, r1, warp,
            [&](int r) { return r - r0 < nr ? cr[(r - r0) * 32] : __ldg(xb + (size_t)r * C4 + g); },
            [&](const int4& v, int r) {
              const int e[4] = {v.x, v.y, v.z, v.w};
              signed char q[4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                q[j] = requant(fmaxf(norm_mod(e[j], cf.m[j], cf.k[j], cf.beta[j]), 0.f), sc);
              __stcs(ob + (size_t)r * C4 + g, make_char4(q[0], q[1], q[2], q[3]));
            });
      }
    }
  } else {
    // 5. max|h| of each chunk, the CTA's chunks from the first; the cached
    // rows keep h in place of x.
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      int b, r0, r1;
      item_rows(item, chunks, p.S, kRows, b, r0, r1);
      const int4* xb = reinterpret_cast<const int4*>(p.x + (size_t)b * p.S * C);
      const R* rb = p.res + (size_t)b * p.S * C;
      float local = 0.f;
      for (int ct = 0; ct < tiles; ++ct) {
        const int g = ct * 32 + lane;
        int4* cr = cached(item, ct);
        const Coef4 cf(w, p.beta, (size_t)b * C + 4 * g);
        walk_rows<false, kUnrollRes>(
            r0, r1, warp,
            [&](int r) {
              XRow<R> v;
              v.x = r - r0 < nr ? cr[(r - r0) * 32] : __ldg(xb + (size_t)r * C4 + g);
              v.r = ResOf<R>::load(rb + (size_t)r * C + 4 * g);
              return v;
            },
            [&](const XRow<R>& v, int r) {
              const int e[4] = {v.x.x, v.x.y, v.x.z, v.x.w};
              float h[4], rf[4];
              ResOf<R>::unpack(v.r, rf);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                h[j] = __fadd_rn(norm_mod(e[j], cf.m[j], cf.k[j], cf.beta[j]), rf[j]);
                local = fmaxf(local, fabsf(h[j]));
              }
              if (r - r0 < nr)
                cr[(r - r0) * 32] = make_int4(__float_as_int(h[0]), __float_as_int(h[1]),
                                              __float_as_int(h[2]), __float_as_int(h[3]));
            });
      }
      const float a = block_max(local, red);
      if (threadIdx.x == 0) w.amax[item] = a;
    }
    grid_barrier();

    // 6. h and its int8, the CTA's chunks, tiles and rows from the last read:
    // h from the cache, or again from x and the residual.
    if (mine) {
      int held = -1;
      float sc = 1.f;
      const int last = blockIdx.x + (mine - 1) * gridDim.x;
      for (int item = last; item >= (int)blockIdx.x; item -= gridDim.x) {
        int b, r0, r1;
        item_rows(item, chunks, p.S, kRows, b, r0, r1);
        if (b != held) {
          float local = 0.f;
          for (int j = threadIdx.x; j < chunks; j += kThreads)
            local = fmaxf(local, __ldcg(w.amax + (size_t)b * chunks + j));
          sc = relu_scale(block_max(local, red));
          held = b;
        }
        const int4* xb = reinterpret_cast<const int4*>(p.x + (size_t)b * p.S * C);
        const R* rb = p.res + (size_t)b * p.S * C;
        R* hb = p.h + (size_t)b * p.S * C;
        char4* ob = reinterpret_cast<char4*>(p.out + (size_t)b * p.S * C);
        for (int ct = tiles - 1; ct >= 0; --ct) {
          const int g = ct * 32 + lane;
          const int4* cr = cached(item, ct);
          const Coef4 cf(w, p.beta, (size_t)b * C + 4 * g);
          walk_rows<true, kUnrollRes>(
              r0, r1, warp,
              [&](int r) {
                XRow<R> v{};
                if (r - r0 < nr) {
                  v.x = cr[(r - r0) * 32];
                } else {
                  v.x = __ldg(xb + (size_t)r * C4 + g);
                  v.r = ResOf<R>::load(rb + (size_t)r * C + 4 * g);
                }
                return v;
              },
              [&](const XRow<R>& v, int r) {
                const int e[4] = {v.x.x, v.x.y, v.x.z, v.x.w};
                float h[4], rf[4];
                ResOf<R>::unpack(v.r, rf);
                signed char q[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  h[j] = r - r0 < nr
                             ? __int_as_float(e[j])
                             : __fadd_rn(norm_mod(e[j], cf.m[j], cf.k[j], cf.beta[j]), rf[j]);
                  q[j] = requant(h[j], sc);
                }
                ResOf<R>::store4(hb + (size_t)r * C + 4 * g, h);
                __stcs(ob + (size_t)r * C4 + g, make_char4(q[0], q[1], q[2], q[3]));
              });
        }
      }
    }
  }
}

// The grid of each form's launch on the current device.
template <class R> int grid_of(int* grid) {
  static int cached[kMaxDevices] = {0};
  return coop::cooperative_grid((const void*)slab_epilogue_kernel<R>, cached, grid, kCacheBytes);
}

template <class R> int launch(const Args<R>& p, void* stream) {
  if (p.C % kTileC != 0 || p.B < 1 || p.S < 1) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int err = grid_of<R>(&grid);
  if (err != 0) return err;
  void* args[] = {const_cast<Args<R>*>(&p)};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)slab_epilogue_kernel<R>,
                                                    dim3(grid), dim3(kThreads), args,
                                                    kCacheBytes,
                                                    reinterpret_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace
}  // namespace slab
}  // namespace msig

// The grid that an entry launches on the current device (*grid): form 0 the
// relu form, 1 the residual form with a bfloat16 residual, 2 with a float32
// one. Returns a CUDA error code (0 = success).
extern "C" int msig_int8_epilogue_grid(int form, int* grid) {
  using namespace msig::slab;
  if (form == 0) return grid_of<void>(grid);
  return form == 1 ? grid_of<__nv_bfloat16>(grid) : grid_of<float>(grid);
}

// Both entries return the CUDA error of their one cooperative launch on
// `stream` (0 = success) and do not synchronise. x: [B, S, C] int32; gamma,
// beta: [B, C] float32; ws: int64, workspace_words(B, S, C) of
// ops/int8_epilogue.py, needs no fill; out: [B, S, C] int8. Needs C % 128 == 0.
extern "C" int msig_adain_relu_requant(const void* x, const void* gamma, const void* beta,
                                       void* ws, void* out, int B, int S, int C, float eps,
                                       void* stream) {
  using namespace msig::slab;
  const Args<void> p{static_cast<const int32_t*>(x), static_cast<const float*>(gamma),
                     static_cast<const float*>(beta), nullptr, nullptr,
                     static_cast<long long*>(ws), static_cast<int8_t*>(out), B, S, C, eps};
  return launch(p, stream);
}

// residual and h_out: [B, S, C], bfloat16 (res_bf16 != 0) or float32.
extern "C" int msig_adain_residual_requant(const void* x, const void* gamma, const void* beta,
                                           const void* residual, void* ws, void* h_out, void* out,
                                           int B, int S, int C, float eps, int res_bf16,
                                           void* stream) {
  using namespace msig::slab;
  if (res_bf16) {
    using R = __nv_bfloat16;
    const Args<R> p{static_cast<const int32_t*>(x), static_cast<const float*>(gamma),
                    static_cast<const float*>(beta), static_cast<const R*>(residual),
                    static_cast<R*>(h_out), static_cast<long long*>(ws),
                    static_cast<int8_t*>(out), B, S, C, eps};
    return launch(p, stream);
  }
  const Args<float> p{static_cast<const int32_t*>(x), static_cast<const float*>(gamma),
                      static_cast<const float*>(beta), static_cast<const float*>(residual),
                      static_cast<float*>(h_out), static_cast<long long*>(ws),
                      static_cast<int8_t*>(out), B, S, C, eps};
  return launch(p, stream);
}
