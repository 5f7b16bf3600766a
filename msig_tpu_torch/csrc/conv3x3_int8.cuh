// Shared pieces of the two resblock trunk kernels (sm_90a).
//
// Both sites start with the same pass: an int8 3x3 "same" convolution over a
// dense NHWC map, accumulated exactly in int32 with mma.sync m16n8k32, whose
// output goes to an int32 scratch in device memory while exact per-(sample,
// channel) statistics are reduced across CTAs with int64 atomics.
//
// Why two passes: the TPU kernels (msig_tpu/ops/fused_conv_int8_v2.py) run one
// whole sample per program and keep its 64x64x256 int32 accumulator (4 MB) in
// VMEM, because the per-sample requant scale needs every conv output of the
// sample before any int8 is written. One SM holds 227 KB of shared memory, so
// here the accumulator round-trips through device memory (8 B per element:
// 4 written, 4 read back) and the epilogue runs as a second kernel.
//
// Statistics block (int64, zero-initialised by the caller), for B samples and
// C channels:
//   [0*B*C + b*C + c]  sum of y          (exact)
//   [1*B*C + b*C + c]  sum of y*y        (exact: the wrapper checks the bound)
//   [2*B*C + b*C + c]  min(0, min y)     (the zero-masked min of the TPU kernel)
//   [3*B*C + b*C + c]  max(0, max y)     (the zero-masked max)
//   [4*B*C + b]        max |hn| of the residual site, as the bits of a float
// Integer sums make the statistics independent of the order of the CTAs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace msig {

constexpr int kBM = 128;          // output pixels per CTA, consecutive in one sample
constexpr int kBN = 128;          // output channels per CTA
constexpr int kBK = 64;           // input channels staged per (tap, chunk)
constexpr int kLds = kBK + 16;    // smem row pitch in bytes (20 words: fragment loads hit 32 banks)
constexpr int kConvThreads = 256; // 8 warps: 4 along M (32 rows each) x 2 along N (64 cols each)
constexpr int kEpiThreads = 256;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Pass A. grid = (B * HW / kBM, C / kBN), block = kConvThreads.
// x: [B, H, W, C] int8; w: [9C, C] int8, row (ky*3 + kx)*C + ci, column co
// (msig_tpu/ops/fused_conv_int8.py::pack_weights); y: [B, H*W, C] int32.
__global__ void __launch_bounds__(kConvThreads)
conv3x3_i8_stats_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        int32_t* __restrict__ y, long long* __restrict__ stats,
                        int B, int H, int W, int C) {
  __shared__ __align__(16) int8_t As[kBM * kLds];  // [pixel][k]
  __shared__ __align__(16) int8_t Bs[kBN * kLds];  // [co][k]: the "col" operand of mma

  const int HW = H * W;
  const int tiles = HW / kBM;
  const int b = blockIdx.x / tiles;
  const int m0 = (blockIdx.x % tiles) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const int8_t* xb = x + (size_t)b * HW * C;
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += kBK) {
      // Input tile: kBM pixels x kBK channels, 16 B per load; the zero halo of
      // the "same" padding comes from the bounds check.
      for (int i = tid; i < kBM * kBK / 16; i += kConvThreads) {
        const int p = i / (kBK / 16), j = i % (kBK / 16);
        const int m = m0 + p;
        const int yy = m / W + dy, xx = m % W + dx;
        int4 v = make_int4(0, 0, 0, 0);
        if (yy >= 0 && yy < H && xx >= 0 && xx < W)
          v = *reinterpret_cast<const int4*>(xb + (size_t)(yy * W + xx) * C + c0 + j * 16);
        *reinterpret_cast<int4*>(As + p * kLds + j * 16) = v;
      }
      // Weight tile, transposed on the way in: Bs[co][k] = w[tap*C + c0 + k][n0 + co].
      for (int i = tid; i < kBK * kBN / 16; i += kConvThreads) {
        const int k = i % kBK, j = i / kBK;
        const int4 v = *reinterpret_cast<const int4*>(w + (size_t)(tap * C + c0 + k) * C + n0 + j * 16);
        const int8_t* vb = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int e = 0; e < 16; ++e) Bs[(j * 16 + e) * kLds + k] = vb[e];
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 32) {
        uint32_t af[2][4], bf[8][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + g;
          af[mi][0] = *reinterpret_cast<const uint32_t*>(As + r * kLds + ks + t4 * 4);
          af[mi][1] = *reinterpret_cast<const uint32_t*>(As + (r + 8) * kLds + ks + t4 * 4);
          af[mi][2] = *reinterpret_cast<const uint32_t*>(As + r * kLds + ks + 16 + t4 * 4);
          af[mi][3] = *reinterpret_cast<const uint32_t*>(As + (r + 8) * kLds + ks + 16 + t4 * 4);
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int n = wn * 64 + ni * 8 + g;
          bf[ni][0] = *reinterpret_cast<const uint32_t*>(Bs + n * kLds + ks + t4 * 4);
          bf[ni][1] = *reinterpret_cast<const uint32_t*>(Bs + n * kLds + ks + 16 + t4 * 4);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
      }
      __syncthreads();
    }
  }

  // acc[mi][ni][r] holds row wm*32 + mi*16 + g (+8 for r >= 2) and column
  // wn*64 + ni*8 + t4*2 + (r & 1) of the CTA tile.
  int32_t* yb = y + ((size_t)b * HW + m0) * C + n0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int row = wm * 32 + mi * 16 + g;
      const int col = wn * 64 + ni * 8 + t4 * 2;
      *reinterpret_cast<int2*>(yb + (size_t)row * C + col) = make_int2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<int2*>(yb + (size_t)(row + 8) * C + col) = make_int2(acc[mi][ni][2], acc[mi][ni][3]);
    }

  const size_t BC = (size_t)B * C;
  long long* st = stats + (size_t)b * C + n0;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      long long s = 0, q = 0;
      int mn = 0, mx = 0;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int v = acc[mi][ni][h * 2 + e];
          s += v;
          q += (long long)v * v;
          mn = min(mn, v);
          mx = max(mx, v);
        }
      // Reduce over the 8 row groups of the warp (lane bits 2..4).
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
        mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      if (g == 0) {
        const int col = wn * 64 + ni * 8 + t4 * 2 + e;
        atomicAdd(reinterpret_cast<unsigned long long*>(st + col), (unsigned long long)s);
        atomicAdd(reinterpret_cast<unsigned long long*>(st + BC + col), (unsigned long long)q);
        atomicMin(st + 2 * BC + col, (long long)mn);
        atomicMax(st + 3 * BC + col, (long long)mx);
      }
    }
}

// Per-channel IN + AdaIN affine of sample b, in the order of the TPU kernel
// (fused_conv_int8_v2.py:121-126): mean = sum/n, var = max(sumsq/n - mean^2, 0),
// a = gamma * rsqrt(var + eps), d = beta - mean * a. Explicit _rn intrinsics
// keep nvcc from contracting into FMAs, so the plain PyTorch version can
// repeat the arithmetic.
__device__ __forceinline__ void channel_affine(const long long* __restrict__ stats,
                                               const float* __restrict__ gamma,
                                               const float* __restrict__ beta, int b, int B,
                                               int C, int HW, float eps, float* a_s, float* d_s) {
  const float n = (float)HW;
  const size_t BC = (size_t)B * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const size_t i = (size_t)b * C + c;
    const float mean = __fdiv_rn((float)stats[i], n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn((float)stats[BC + i], n), __fmul_rn(mean, mean)), 0.f);
    const float a = __fmul_rn(gamma[i], __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps))));
    a_s[c] = a;
    d_s[c] = __fsub_rn(beta[i], __fmul_rn(mean, a));
  }
}

// Max of non-negative per-thread values over the block.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

// Epilogue CTAs per sample: each walks a contiguous share of the sample's
// HW*C/4 groups of 4 channels.
inline int epilogue_blocks(int HW, int C) {
  const long long groups = (long long)HW * C / 4;
  long long n = (groups + 16LL * kEpiThreads - 1) / (16LL * kEpiThreads);
  return (int)(n < 1 ? 1 : (n > 1024 ? 1024 : n));
}

}  // namespace msig
