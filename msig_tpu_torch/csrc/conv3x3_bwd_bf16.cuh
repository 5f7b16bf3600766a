// Backward of a 3x3 stride-1 zero-padded ("SAME") convolution with bf16
// operands and fp32 accumulation on dense NHWC maps (sm_90a): dx and dW of
// y = conv3x3([relu](x), W), W in HWIO; x, dy and W in bf16, dx written in
// bf16, dW in fp32.
//
// Replaces the bf16 configuration of the core shared by the TPU kernels
// msig_tpu/ops/conv3x3_vjp.py::conv3x3_bwd and conv3x3_adain_bwd, the one the
// JAX package's bf16 train step runs (models/layers.py casts x and the kernel
// to the compute type; :143 and :298 cast the transposed taps; the MXU
// products take bf16 operands and accumulate in fp32, :93-94 and :108-110).
//
// The two implicit GEMMs of conv3x3_bwd.cuh (the fp32 core), on its grid:
//   dx: M = B*H*W pixels, N = C, K = 9*Co, A = dy gathered at the shifted
//       pixel (zero outside the map), B = the transposed taps wt [9*Co, C];
//   dW: M = 9*C (tap, input channel), N = Co, K = pixels, A = xin gathered at
//       the shifted pixel, B = dy.
// Each product is one mma.sync.m16n8k16 bf16 with fp32 accumulators: a
// product of two bf16 values is exact in fp32, so there is no split and no
// second pass (the fp32 core needs three TF32 passes).
//
// Bound on an H100 at [8, 64, 64, 256]: 77.3 GFLOP at the 989 TFLOP/s of
// dense bf16 is 0.078 ms; the bytes (x, dy read, dx written in bf16, W and
// dW) about 50 MB, 0.015 ms. mma.sync reaches a part of that rate only (wgmma
// is the route to all of it: later work).
//
// Layout: CTA tiles of 128 x 128 on 4 warps of 64 x 64 (m16n8k16 tiles 4 x 8),
// 2 CTAs per SM. K moves 64 at a time, one row of a stage 128 bytes, through
// a ring of kStages stages filled by 16-byte cp.async.cg copies that zero-fill
// taps outside the map and pixels past the ragged edge of B*H*W; a dx K block
// never straddles two taps (Co % 64 == 0). Fragments come by ldmatrix: dx's A
// (dy rows [m][k], k contiguous) plain, the operands that NHWC stores with k
// strided (dW's A, x rows [k = pixel][m = channel], and both B tiles [k][n])
// transposed. Rows are padded by 16 bytes (pitches of 144 and 272 bytes), so
// the 8 rows of an 8x8 matrix fall in 8 distinct 16-byte bank groups. dW's
// ReLU of x (sign bit set -> 0) applies at its fragment load, dx's relu'(x)
// (x > 0 on bf16 x) in its epilogue.
//
// kMaxK (conv3x3_bwd.cuh) is kept: no tile accumulates more than 2304 of K.
// The tensor cores add with truncation, so the error of an fp32 sum grows
// with its length; in bf16 it is far under a bf16 step at that length, but
// the shared geometry keeps the grid, the scratch (ops/conv3x3_vjp.py::
// scratch_floats) and the in-order reduction of dW's partials of the fp32
// core: dW's K in chunks of kMaxK pixels, each chunk's partial in fp32 to
// scratch, the chunks added in order, and dx's K in dx_splits(g) parts where
// 9*Co > kMaxK (none at Co = 256), added in order into bf16. No float
// atomics: the same bits on every call.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "conv3x3_bwd.cuh"

namespace msig_bf16 {

using bf16 = __nv_bfloat16;
using msig_f32::dw_chunks;
using msig_f32::dw_tiles;
using msig_f32::dx_splits;
using msig_f32::dx_tiles;
using msig_f32::kMaxK;
using msig_f32::Map;
using msig_f32::npix;

constexpr int kBM = 128, kBN = 128;  // a CTA's output tile: the fp32 core's grid
constexpr int kBK = 64;              // K per ring stage: 128 bytes of a bf16 row
constexpr int kWarpsM = 2, kWarpsN = 2;
constexpr int kWM = kBM / kWarpsM, kWN = kBN / kWarpsN;  // a warp's output tile, 64 x 64
constexpr int kMI = kWM / 16, kNI = kWN / 8;              // its mma tiles of 16 x 8
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMinCtas = 2;          // CTAs per SM: up to 255 registers a thread
constexpr int kStages = 3;
constexpr int kLdMK = kBK + 8;       // [m][k] tile pitch in bf16 (dx's A): 144 bytes
constexpr int kLdKN = kBN + 8;       // [k][m] or [k][n] tile pitch (dW's A, both B): 272 bytes
constexpr int kAElems = kBM * kLdMK;   // >= kBK * kLdKN, dW's A
constexpr int kBElems = kBK * kLdKN;
constexpr int kStageElems = kAElems + kBElems;
constexpr int kSmemBytes = kStages * kStageElems * 2;  // 107,520: two CTAs fit an SM
// Loader geometry: an [m][k] tile row is 8 copies of 16 bytes, a [k][*] row 16.
constexpr int kRowsMK = kThreads / 8, kItMK = kBM / kRowsMK;
constexpr int kRowsKN = kThreads / 16, kItKN = kBK / kRowsKN;
static_assert(kBM == msig_f32::kBM && kBN == msig_f32::kBN, "the fp32 core's grid and scratch");
static_assert(kMaxK % kBK == 0, "a dW chunk is whole stages");
static_assert(kBK * kLdKN <= kAElems, "dW's A tile fits the A slot");
static_assert((kLdMK * 2) % 16 == 0 && (kLdKN * 2) % 16 == 0, "16-byte rows for cp.async");

// -------------------------------------------------------------- primitives

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Four 8x8 matrices of b16 from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Plain: register i of lane l holds row l / 4,
// columns 2 (l % 4) and + 1 of matrix i; .trans: of its transpose.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// relu of two packed bf16: a half whose sign bit is set becomes +0.
__device__ __forceinline__ uint32_t relu2(uint32_t v) {
  return v & ~(((v >> 15) & 0x00010001u) * 0xffffu);
}

// acc += A * B over one ring stage (K = 64, four k16 steps). B is [k][n]
// (pitch kLdKN); kMK: A is [m][k] (pitch kLdMK, dx's dy rows), else [k][m]
// (pitch kLdKN, dW's x rows); kRelu: A is relu(A).
//
// m16n8k16 fragments, g = lane / 4, t = lane % 4: A a0 = (m g, k 2t..2t+1),
// a1 = (m g + 8, ..), a2 = (m g, k 2t + 8..), a3 = (m g + 8, k 2t + 8..);
// B b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g). One ldmatrix.x4 gives
// A's four (its matrices in that order), or the b0, b1 of two n8 tiles.
template <bool kMK, bool kRelu>
__device__ __forceinline__ void mma_stage(const bf16* As, const bf16* Bs,
                                          float (&acc)[kMI][kNI][4], int wm, int wn, int lane) {
  const int r8 = lane & 7, q1 = (lane >> 3) & 1, q2 = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t b[kNI][2];
#pragma unroll
    for (int nj = 0; nj < kNI; nj += 2) {
      // matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
      uint32_t r[4];
      ldsm_x4_t(r, Bs + (kk + r8 + 8 * q1) * kLdKN + wn * kWN + nj * 8 + 8 * q2);
      b[nj][0] = r[0];
      b[nj][1] = r[1];
      b[nj + 1][0] = r[2];
      b[nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const int m0 = wm * kWM + mi * 16;
      uint32_t a[4];
      if constexpr (kMK) {
        // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
        ldsm_x4(a, As + (m0 + (lane & 15)) * kLdMK + kk + 8 * q2);
      } else {
        // the same four, stored as [k][m]: rows k, 8 m each, transposed
        ldsm_x4_t(a, As + (kk + r8 + 8 * q2) * kLdKN + m0 + 8 * q1);
        if constexpr (kRelu) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = relu2(a[i]);
        }
      }
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) mma_bf16(acc[mi][ni], a, b[ni]);
    }
  }
}

// The ring: stage s of the K loop's blocks kb = 0 .. nk-1. load(stage, kb)
// starts block kb's copies into stage `stage`, in increasing kb.
template <bool kMK, bool kRelu, class Load>
__device__ __forceinline__ void gemm_ring(bf16* smem, int nk, Load&& load,
                                          float (&acc)[kMI][kNI][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    msig_f32::cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    msig_f32::cp_async_wait<kStages - 2>();  // block kb has landed, for this thread's copies
    __syncthreads();                         // ... and everyone's; stage (kb - 1) % kStages is free
    const int next = kb + kStages - 1;
    if (next < nk) load(next % kStages, next);
    msig_f32::cp_async_commit();
    const bf16* st = smem + (kb % kStages) * kStageElems;
    mma_stage<kMK, kRelu>(st, st + kAElems, acc, wm, wn, lane);
  }
  msig_f32::cp_async_wait<0>();
}

// ---------------------------------------------------------------------- dx
// Tile (split s, m, n): pixels m*128 .., channels n*128 .., the s-th part of
// K; dy [B*H*W, Co], wt [9*Co, C], x and dx [B*H*W, C] in bf16. With one part
// the tile writes dx (bf16, rounded to nearest even); else its fp32 partial
// goes to dx_part [splits, B*H*W, C].
template <bool kRelu>
__device__ __forceinline__ void dx_tile(const bf16* __restrict__ dy, const bf16* __restrict__ wt,
                                        const bf16* __restrict__ x, bf16* __restrict__ dx,
                                        float* __restrict__ dx_part, const Map& g, int tile,
                                        bf16* smem) {
  const int tid = threadIdx.x, np = npix(g), hw = g.H * g.W;
  const int n_mn = (np + kBM - 1) / kBM * (g.C / kBN), split = tile / n_mn, mn = tile % n_mn;
  const int m0 = mn / (g.C / kBN) * kBM, n0 = mn % (g.C / kBN) * kBN;
  const int splits = dx_splits(g), nkb = 9 * g.Co / kBK, per = (nkb + splits - 1) / splits;
  const int kb0 = split * per, nk = min(nkb, kb0 + per) - kb0;
  // A: rows a_row + kRowsMK i, 16 bytes at column a_col; a pixel past the
  // edge gets h = -4, so that every tap of it is outside the map (zero-filled).
  const int a_row = tid >> 3, a_col = (tid & 7) * 8;
  int ah[kItMK], aw[kItMK];
#pragma unroll
  for (int i = 0; i < kItMK; ++i) {
    const int pix = m0 + a_row + kRowsMK * i, r = pix % hw;
    ah[i] = pix < np ? r / g.W : -4;
    aw[i] = r % g.W;
  }
  // B: rows b_row + kRowsKN i, 16 bytes at column b_col.
  const int b_row = tid >> 4, b_col = (tid & 15) * 8;
  const int blocks_per_tap = g.Co / kBK;

  auto load = [&](int stage, int kb_in_split) {
    bf16* As = smem + stage * kStageElems;
    bf16* Bs = As + kAElems;
    const int kb = kb0 + kb_in_split;
    const int tap = kb / blocks_per_tap, co0 = (kb - tap * blocks_per_tap) * kBK;
    const int sh = 1 - tap / 3, sw = 1 - tap % 3;  // source pixel = (h + sh, w + sw)
    const int shift = sh * g.W + sw;
#pragma unroll
    for (int i = 0; i < kItMK; ++i) {
      const int h = ah[i] + sh, w = aw[i] + sw;
      const bool ok = h >= 0 && h < g.H && w >= 0 && w < g.W;
      const int src = m0 + a_row + kRowsMK * i + shift;
      cp_async16(As + (a_row + kRowsMK * i) * kLdMK + a_col,
                 ok ? dy + (size_t)src * g.Co + co0 + a_col : dy, ok);
    }
#pragma unroll
    for (int i = 0; i < kItKN; ++i) {
      const int k = b_row + kRowsKN * i;
      cp_async16(Bs + k * kLdKN + b_col, wt + (size_t)(kb * kBK + k) * g.C + n0 + b_col, true);
    }
  };

  float acc[kMI][kNI][4];
  gemm_ring<true, false>(smem, nk, load, acc);

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * kWM + mi * 16 + gq + 8 * half;
      if (row >= np) continue;  // the ragged edge
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const size_t off = (size_t)row * g.C + n0 + wn * kWN + ni * 8 + 2 * tq;
        float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if (splits > 1) {
          *reinterpret_cast<float2*>(dx_part + (size_t)split * np * g.C + off) =
              make_float2(v0, v1);
          continue;
        }
        if constexpr (kRelu) {  // relu'(x): dx is exactly 0 where x <= 0
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + off);
          v0 = __low2float(xv) > 0.f ? v0 : 0.f;
          v1 = __high2float(xv) > 0.f ? v1 : 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(dx + off) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------- dW
// Tile (chunk z, m, n): rows m*128 .. of [9*C] (one tap: C % 128 == 0),
// columns n*128 .. of Co, K = the chunk's pixels. x [B*H*W, C], dy
// [B*H*W, Co] in bf16; part [chunks, 9*C, Co] receives the chunk's fp32 product.
template <bool kRelu>
__device__ __forceinline__ void dw_tile(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                                        float* __restrict__ part, const Map& g, int tile,
                                        bf16* smem) {
  const int tid = threadIdx.x, np = npix(g), hw = g.H * g.W;
  const int n_m = 9 * g.C / kBM, n_n = g.Co / kBN;
  const int z = tile / (n_m * n_n), mn = tile % (n_m * n_n);
  const int m0 = mn / n_n * kBM, n0 = mn % n_n * kBN;
  const int tap = m0 / g.C, ci0 = m0 % g.C;
  const int di = tap / 3 - 1, dj = tap % 3 - 1;  // source pixel = (h + di, w + dj)
  const int shift = di * g.W + dj;
  const int p_begin = z * kMaxK, p_end = min(np, p_begin + kMaxK);
  // Both operands: pixel rows k_row + kRowsKN i of the block, 16 bytes at
  // column col; (h, w) of each row's pixel, advanced by 64 pixels a block.
  const int k_row = tid >> 4, col = (tid & 15) * 8;
  int ph[kItKN], pw[kItKN];
#pragma unroll
  for (int i = 0; i < kItKN; ++i) {
    const int r = (p_begin + k_row + kRowsKN * i) % hw;
    ph[i] = r / g.W;
    pw[i] = r % g.W;
  }

  auto load = [&](int stage, int kb) {
    bf16* As = smem + stage * kStageElems;
    bf16* Bs = As + kAElems;
#pragma unroll
    for (int i = 0; i < kItKN; ++i) {
      const int k = k_row + kRowsKN * i, p = p_begin + kb * kBK + k;
      const bool in = p < p_end;  // the chunk's (and the map's) ragged edge
      const int h = ph[i] + di, w = pw[i] + dj;
      const bool ok = in && h >= 0 && h < g.H && w >= 0 && w < g.W;
      cp_async16(As + k * kLdKN + col, ok ? x + (size_t)(p + shift) * g.C + ci0 + col : x, ok);
      cp_async16(Bs + k * kLdKN + col, in ? dy + (size_t)p * g.Co + n0 + col : dy, in);
      pw[i] += kBK;
      while (pw[i] >= g.W) {
        pw[i] -= g.W;
        ++ph[i];
      }
      while (ph[i] >= g.H) ph[i] -= g.H;
    }
  };

  float acc[kMI][kNI][4];
  gemm_ring<false, kRelu>(smem, (p_end - p_begin + kBK - 1) / kBK, load, acc);

  float* out = part + (size_t)z * 9 * g.C * g.Co;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t row = (size_t)(m0 + wm * kWM + mi * 16 + gq + 8 * half) * g.Co;
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
        *reinterpret_cast<float2*>(out + row + n0 + wn * kWN + ni * 8 + 2 * tq) =
            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
    }
}

// One launch for both products: blocks [0, dx_tiles) take dx, the rest dW.
// part: dW's partials [chunks, 9*C, Co], then dx's [splits, B*H*W, C] (fp32).
template <bool kRelu>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    conv3x3_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                       const bf16* __restrict__ wt, bf16* __restrict__ dx,
                       float* __restrict__ part, Map g, int n_dx) {
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* smem = reinterpret_cast<bf16*>(smem_bf16);
  if ((int)blockIdx.x < n_dx)
    dx_tile<kRelu>(dy, wt, x, dx, part + (size_t)dw_chunks(g) * 9 * g.C * g.Co, g, blockIdx.x,
                   smem);
  else
    dw_tile<kRelu>(x, dy, part, g, blockIdx.x - n_dx, smem);
}

// dx = the sum of n fp32 partials of n4 x 4 values each, added in order
// (deterministic), rounded to bf16; with kRelu, 0 where x <= 0.
template <bool kRelu>
__global__ void reduce_kernel(const float4* __restrict__ part, const uint2* __restrict__ x,
                              uint2* __restrict__ out, size_t n4, int n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int c = 1; c < n; ++c) {
      const float4 v = part[(size_t)c * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if constexpr (kRelu) {
      const uint2 xv = x[i];
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&xv.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&xv.y);
      s.x = __low2float(lo) > 0.f ? s.x : 0.f;
      s.y = __high2float(lo) > 0.f ? s.y : 0.f;
      s.z = __low2float(hi) > 0.f ? s.z : 0.f;
      s.w = __high2float(hi) > 0.f ? s.w : 0.f;
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y), hi = __floats2bfloat162_rn(s.z, s.w);
    out[i] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                        *reinterpret_cast<const uint32_t*>(&hi));
  }
}

template <bool kRelu>
inline cudaError_t reduce_dx(const float* part, const bf16* x, bf16* out, size_t n, int parts,
                             cudaStream_t st) {
  const size_t n4 = n / 4;
  const int blocks = (int)std::min<size_t>((n4 + 255) / 256, 4096);
  reduce_kernel<kRelu><<<blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(part),
                                               reinterpret_cast<const uint2*>(x),
                                               reinterpret_cast<uint2*>(out), n4, parts);
  return cudaGetLastError();
}

// Lets the kernel take kSmemBytes of dynamic shared memory (above the 48 KB
// default) and asks for the largest shared-memory carveout, so kMinCtas fit.
template <bool kRelu>
inline cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_bwd_kernel<kRelu>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(conv3x3_bwd_kernel<kRelu>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// CTAs of conv3x3_bwd_kernel<kRelu> resident per SM (0 on an error).
template <bool kRelu>
inline int ctas_per_sm() {
  int n = 0;
  if (set_smem<kRelu>() != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv3x3_bwd_kernel<kRelu>, kThreads,
                                                    kSmemBytes) != cudaSuccess)
    return 0;
  return n;
}

template <bool kRelu>
inline cudaError_t launch_core(const bf16* x, const bf16* dy, const bf16* wt, bf16* dx,
                               float* part, const Map& g, cudaStream_t st) {
  cudaError_t err = set_smem<kRelu>();
  if (err != cudaSuccess) return err;
  const int n_dx = dx_tiles(g);
  conv3x3_bwd_kernel<kRelu><<<n_dx + dw_tiles(g), kThreads, kSmemBytes, st>>>(x, dy, wt, dx, part,
                                                                             g, n_dx);
  return cudaGetLastError();
}

// dx (bf16) and dW (fp32) of one conv on bf16 x, dy and taps wt; part: scratch
// of msig_f32::part_floats(g) floats. Needs C and Co multiples of 128; any
// B*H*W. Returns cudaGetLastError() after the launches.
inline cudaError_t conv3x3_bwd_launch(const bf16* x, const bf16* dy, const bf16* wt, bf16* dx,
                                      float* dw, float* part, const Map& g, bool relu,
                                      cudaStream_t st) {
  cudaError_t err = relu ? launch_core<true>(x, dy, wt, dx, part, g, st)
                         : launch_core<false>(x, dy, wt, dx, part, g, st);
  if (err != cudaSuccess) return err;
  const size_t n_dw = (size_t)9 * g.C * g.Co;
  err = msig_f32::reduce<false>(part, nullptr, dw, n_dw, dw_chunks(g), st);
  if (err != cudaSuccess || dx_splits(g) == 1) return err;
  const float* dx_part = part + dw_chunks(g) * n_dw;
  const size_t n_dx = (size_t)npix(g) * g.C;
  return relu ? reduce_dx<true>(dx_part, x, dx, n_dx, dx_splits(g), st)
              : reduce_dx<false>(dx_part, x, dx, n_dx, dx_splits(g), st);
}

}  // namespace msig_bf16
