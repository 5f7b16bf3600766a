// Instance norm + modulation over dense NHWC maps [B, S, C] (S = H*W), fp32
// statistics, forward and backward (sm_90a). Element type T: float or bf16.
//
// One CTA per (sample, 32-channel group): 32 lanes on 32 consecutive channels
// (128 contiguous bytes of a pixel row in fp32), 16 rows of threads striding
// over the S pixels. A CTA reads its [S, 32] slab once per pass; the passes
// after the first find it in L2 (the whole map of the main path, 32 MB, fits
// the 50 MB L2). Per-thread partial sums are added across the 16 rows in
// shared memory in a fixed order, so results do not depend on scheduling.
//
// Forward (the TPU kernel's _fwd_kernel): m = mean(x); v = mean((x - m)^2)
// (two passes, biased); r = rsqrt(v + eps); y = (x - m) * (r * g) + b.
// Backward (its _bwd_kernel, and the IN part of conv3x3_adain_bwd's
// _bwd_adain_kernel): xhat = (x - m) * r; db = sum(dy); dg = sum(dy * xhat);
// dx = (g * r) * (dy - db / S - xhat * (dg / S)).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace msig_in {

constexpr int kLanes = 32;  // channels per CTA
constexpr int kRows = 16;   // pixel rows of threads per CTA

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sum of v over the kRows rows of threads of one channel, in row order.
// red: shared [kRows][kLanes]; every thread gets the channel's sum.
__device__ __forceinline__ float rows_sum(float v, float (*red)[kLanes]) {
  red[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) s += red[r][threadIdx.x];
  __syncthreads();
  return s;
}

// grid (C / 32, B), block (32, 16). gamma, beta [B, C] fp32; mean, rstd [B, C].
template <typename T>
__global__ void __launch_bounds__(kLanes * kRows) adain_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    T* __restrict__ y, float* __restrict__ mean, float* __restrict__ rstd, int S, int C, float eps) {
  __shared__ float red[kRows][kLanes];
  const int b = blockIdx.y, c = blockIdx.x * kLanes + threadIdx.x;
  const size_t base = (size_t)b * S * C + c;
  float s = 0.f;
  for (int p = threadIdx.y; p < S; p += kRows) s += to_f(x[base + (size_t)p * C]);
  const float m = rows_sum(s, red) / (float)S;
  float q = 0.f;
  for (int p = threadIdx.y; p < S; p += kRows) {
    const float d = to_f(x[base + (size_t)p * C]) - m;
    q = fmaf(d, d, q);
  }
  const float v = rows_sum(q, red) / (float)S;
  const float r = 1.f / sqrtf(v + eps);
  const float rg = r * gamma[b * C + c], be = beta[b * C + c];
  for (int p = threadIdx.y; p < S; p += kRows) {
    const size_t i = base + (size_t)p * C;
    y[i] = from_f<T>((to_f(x[i]) - m) * rg + be);
  }
  if (threadIdx.y == 0) {
    mean[b * C + c] = m;
    rstd[b * C + c] = r;
  }
}

// grid (C / 32, B), block (32, 16). dgamma = sum(dy * xhat), dbeta = sum(dy).
template <typename T>
__global__ void __launch_bounds__(kLanes * kRows) in_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ gamma, T* __restrict__ dx,
    float* __restrict__ dgamma, float* __restrict__ dbeta, int S, int C) {
  __shared__ float red[kRows][kLanes];
  const int b = blockIdx.y, c = blockIdx.x * kLanes + threadIdx.x;
  const size_t base = (size_t)b * S * C + c;
  const float m = mean[b * C + c], r = rstd[b * C + c];
  float sb = 0.f, sg = 0.f;
  for (int p = threadIdx.y; p < S; p += kRows) {
    const size_t i = base + (size_t)p * C;
    const float g = to_f(dy[i]);
    sb += g;
    sg = fmaf(g, (to_f(x[i]) - m) * r, sg);
  }
  const float db = rows_sum(sb, red), dg = rows_sum(sg, red);
  const float gr = gamma[b * C + c] * r, mb = db / (float)S, mg = dg / (float)S;
  for (int p = threadIdx.y; p < S; p += kRows) {
    const size_t i = base + (size_t)p * C;
    const float xhat = (to_f(x[i]) - m) * r;
    dx[i] = from_f<T>(gr * (to_f(dy[i]) - mb - xhat * mg));
  }
  if (threadIdx.y == 0) {
    dgamma[b * C + c] = dg;
    dbeta[b * C + c] = db;
  }
}

inline dim3 grid_of(int B, int C) { return dim3(C / kLanes, B); }
inline dim3 block_of() { return dim3(kLanes, kRows); }

}  // namespace msig_in
