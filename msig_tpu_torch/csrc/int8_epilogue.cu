// Whole-slab epilogues of an int32 conv output x [B, S, C] (S rows of a
// sample, C channels), with the TPU's two-pass fp32 instance norm:
//   norm_mod(x) = (fp32(x) - m) * (rsqrt(v + eps) * gamma) + beta,
//   m = mean of fp32(x), v = mean of fp32((fp32(x) - m)^2), over the S rows;
//   msig_adain_relu_requant:     y = max(norm_mod(x), 0), amax = max y, q = int8(y);
//   msig_adain_residual_requant: h = norm_mod(x) + residual, amax = max |h|,
//                                h out in the residual's dtype and q = int8(h) from fp32 h;
//   q = clip(round(v * s), +-127), s = 127/amax (1 where amax is 0).
//
// Replaces msig_tpu/ops/int8_epilogue.py::adain_relu_requant (_relu_kernel)
// and adain_residual_requant (_residual_kernel), which hold a sample's whole
// [S, C] slab in VMEM (S*C*4 <= 8 MB) and reduce it there in fp32. An SM holds
// 227 KB, so here the statistics are reduced across CTAs and the slab is read
// again for each pass, five launches:
//   1. cast_sum_kernel: the sum of fp32(x) per (sample, channel), exact in
//      int64 (every fp32(x) is an integer below 2^31), with atomics;
//   2. dev_sq_kernel: per kEpRows-row chunk, the sum of the fp32 squares of
//      fp32(x) - m in fp64, one partial per (chunk, sample, channel);
//   3. coef_kernel: m (the exact sum rounded once, over n) and
//      k = rsqrt(v + eps) * gamma, v from the partials added in chunk order;
//   4. epi_amax_kernel: amax per sample (an integer atomicMax on the bits of a
//      non-negative float);
//   5. epi_requant_kernel: q, and h for the residual form.
// No float atomics: two calls give the same bits. The TPU sums in fp32 in its
// own order; m and v here are those sums done exactly (m) or in fp64 (v) and
// rounded once, so they may differ from the TPU's in the last bits (the
// int8 bar of one step absorbs that). The int32 -> fp32 cast is inexact above
// 2^24 and conv outputs reach about 7.5e7, so the statistics are taken of the
// cast, as the TPU takes them, not of the integers.
//
// Bound on an H100 at [8, 4096, 256] (the trunk's map at a 256² input):
// relu, 33.6 MB read + 8.4 MB written = 41.9 MB, 12.5 us at 3.35 TB/s;
// residual with a bf16 residual, + 16.8 MB read + 16.8 MB written = 75.5 MB,
// 22.5 us. Bytes bound both. This design reads x four times (passes 1, 2, 4,
// 5) and the residual twice; at this size the 50 MB L2 holds x.
#include <cuda_bf16.h>

#include <type_traits>

#include "conv_int8.cuh"

namespace msig {

constexpr int kEpRows = 128;  // rows of one sample per statistics CTA
constexpr int kEpCols = 128;  // channels per statistics CTA, four per thread
constexpr int kEpLanes = 8;   // row lanes: 256 threads = 32 channel quads x 8 lanes

// The residual's element type: load four, store four (round to nearest).
template <class R> struct ResOf;
template <> struct ResOf<float> {
  __device__ static void load4(const float* p, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  __device__ static void store4(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct ResOf<__nv_bfloat16> {
  __device__ static void load4(const __nv_bfloat16* p, float (&f)[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
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
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// Statistics CTAs: grid = (ceil(S / kEpRows), C / kEpCols, B), block 256.
// Warp `lane` takes rows r0 + lane, r0 + lane + kEpLanes, ...; its thread
// `quad` takes channels quad*4 .. +3 of the CTA's 128 (one 512-byte row per
// warp and load). The lanes meet in shared memory in a fixed order.
__global__ void __launch_bounds__(256)
cast_sum_kernel(const int32_t* __restrict__ x, long long* __restrict__ sums, int S, int C) {
  __shared__ long long sh[kEpLanes][kEpCols];
  const int b = blockIdx.z, quad = threadIdx.x % 32, lane = threadIdx.x / 32;
  const int c = blockIdx.y * kEpCols + quad * 4;
  const int r0 = blockIdx.x * kEpRows, r1 = min(r0 + kEpRows, S);
  long long s[4] = {0, 0, 0, 0};
  const int32_t* xb = x + (size_t)b * S * C + c;
  for (int r = r0 + lane; r < r1; r += kEpLanes) {
    const int4 v = *reinterpret_cast<const int4*>(xb + (size_t)r * C);
    s[0] += (long long)__int2float_rn(v.x);
    s[1] += (long long)__int2float_rn(v.y);
    s[2] += (long long)__int2float_rn(v.z);
    s[3] += (long long)__int2float_rn(v.w);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) sh[lane][quad * 4 + k] = s[k];
  __syncthreads();
  if (threadIdx.x < kEpCols) {
    long long t = 0;
    for (int l = 0; l < kEpLanes; ++l) t += sh[l][threadIdx.x];
    atomicAdd(reinterpret_cast<unsigned long long*>(
                  &sums[(size_t)b * C + blockIdx.y * kEpCols + threadIdx.x]),
              (unsigned long long)t);
  }
}

__device__ __forceinline__ float mean_of(const long long* sums, size_t i, float n) {
  return __fdiv_rn(__ll2float_rn(sums[i]), n);
}

// Same grid as cast_sum_kernel; partials: [gridDim.x, B*C] fp64.
__global__ void __launch_bounds__(256)
dev_sq_kernel(const int32_t* __restrict__ x, const long long* __restrict__ sums,
              double* __restrict__ partials, int B, int S, int C) {
  __shared__ double sh[kEpLanes][kEpCols];
  const int b = blockIdx.z, quad = threadIdx.x % 32, lane = threadIdx.x / 32;
  const int c = blockIdx.y * kEpCols + quad * 4;
  const int r0 = blockIdx.x * kEpRows, r1 = min(r0 + kEpRows, S);
  const float n = (float)S;
  float m[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) m[k] = mean_of(sums, (size_t)b * C + c + k, n);
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  const int32_t* xb = x + (size_t)b * S * C + c;
  for (int r = r0 + lane; r < r1; r += kEpLanes) {
    const int4 v = *reinterpret_cast<const int4*>(xb + (size_t)r * C);
    const int vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xc = __fsub_rn(__int2float_rn(vals[k]), m[k]);
      acc[k] += (double)__fmul_rn(xc, xc);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) sh[lane][quad * 4 + k] = acc[k];
  __syncthreads();
  if (threadIdx.x < kEpCols) {
    double t = 0.0;
    for (int l = 0; l < kEpLanes; ++l) t += sh[l][threadIdx.x];
    partials[(size_t)blockIdx.x * B * C + (size_t)b * C + blockIdx.y * kEpCols + threadIdx.x] = t;
  }
}

// One thread per (sample, channel): coef[0:BC] = m, coef[BC:2BC] = k.
__global__ void __launch_bounds__(256)
coef_kernel(const long long* __restrict__ sums, const double* __restrict__ partials,
            const float* __restrict__ gamma, float* __restrict__ coef, int BC, int S, int chunks,
            float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BC) return;
  const float n = (float)S;
  double t = 0.0;
  for (int j = 0; j < chunks; ++j) t += partials[(size_t)j * BC + i];
  const float v = __fdiv_rn(__double2float_rn(t), n);
  coef[i] = mean_of(sums, i, n);
  coef[BC + i] = __fmul_rn(__frcp_rn(__fsqrt_rn(__fadd_rn(v, eps))), gamma[i]);
}

__device__ __forceinline__ float norm_mod(int v, float m, float k, float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(__int2float_rn(v), m), k), beta);
}

// The value each element requantizes: y = max(norm_mod, 0), or with a
// residual h = norm_mod + fp32(residual). R = void: the relu form.
template <class R>
__device__ __forceinline__ void epi_values(const int4 v, const float* m_s, const float* k_s,
                                           const float* b_s, int c, const R* res, float (&out)[4]) {
  const int vals[4] = {v.x, v.y, v.z, v.w};
  float r[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (!std::is_void<R>::value) ResOf<R>::load4(res, r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float y = norm_mod(vals[k], m_s[c + k], k_s[c + k], b_s[c + k]);
    if constexpr (std::is_void<R>::value)
      out[k] = fmaxf(y, 0.f);
    else
      out[k] = __fadd_rn(y, r[k]);
  }
}

// Sample b's coefficients into shared memory: m[C], k[C], beta[C].
__device__ __forceinline__ void load_coef(const float* __restrict__ coef,
                                          const float* __restrict__ beta, int b, int B, int C,
                                          float* sh) {
  const size_t BC = (size_t)B * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    sh[c] = coef[(size_t)b * C + c];
    sh[C + c] = coef[BC + (size_t)b * C + c];
    sh[2 * C + c] = beta[(size_t)b * C + c];
  }
  __syncthreads();
}

// grid = (epilogue_blocks(S, C), B), block kEpiThreads, dynamic smem 3*C floats.
template <class R>
__global__ void __launch_bounds__(kEpiThreads)
epi_amax_kernel(const int32_t* __restrict__ x, const float* __restrict__ coef,
                const float* __restrict__ beta, const R* __restrict__ res,
                unsigned int* __restrict__ amax, int B, int S, int C) {
  extern __shared__ float sh[];
  __shared__ float red[32];
  const int b = blockIdx.y;
  load_coef(coef, beta, b, B, C, sh);
  const size_t base = (size_t)b * S * C, n4 = (size_t)S * C / 4;
  const int4* x4 = reinterpret_cast<const int4*>(x + base);
  float local = 0.f;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float vals[4];
    const R* r = nullptr;
    if constexpr (!std::is_void<R>::value) r = res + base + i * 4;
    epi_values<R>(x4[i], sh, sh + C, sh + 2 * C, (int)((i * 4) % C), r, vals);
#pragma unroll
    for (int k = 0; k < 4; ++k) local = fmaxf(local, fabsf(vals[k]));
  }
  const float m = block_max(local, red);
  if (threadIdx.x == 0) atomicMax(&amax[b], __float_as_uint(m));
}

template <class R>
__global__ void __launch_bounds__(kEpiThreads)
epi_requant_kernel(const int32_t* __restrict__ x, const float* __restrict__ coef,
                   const float* __restrict__ beta, const R* __restrict__ res,
                   const unsigned int* __restrict__ amax, R* __restrict__ h_out,
                   int8_t* __restrict__ out, int B, int S, int C) {
  extern __shared__ float sh[];
  const int b = blockIdx.y;
  load_coef(coef, beta, b, B, C, sh);
  const float a = __uint_as_float(amax[b]);
  const float s = a > 0.f ? __fdiv_rn(127.f, a) : 1.f;
  const size_t base = (size_t)b * S * C, n4 = (size_t)S * C / 4;
  const int4* x4 = reinterpret_cast<const int4*>(x + base);
  char4* o4 = reinterpret_cast<char4*>(out + base);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float vals[4];
    const R* r = nullptr;
    if constexpr (!std::is_void<R>::value) r = res + base + i * 4;
    epi_values<R>(x4[i], sh, sh + C, sh + 2 * C, (int)((i * 4) % C), r, vals);
    if constexpr (!std::is_void<R>::value) ResOf<R>::store4(h_out + base + i * 4, vals);
    signed char q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      q[k] = (signed char)min(max(__float2int_rn(__fmul_rn(vals[k], s)), -127), 127);
    o4[i] = make_char4(q[0], q[1], q[2], q[3]);
  }
}

template <class R>
int epilogue_launch(const int32_t* x, const float* gamma, const float* beta, const R* res,
                    long long* sums, double* partials, float* coef, unsigned int* amax, R* h_out,
                    int8_t* out, int B, int S, int C, float eps, cudaStream_t st) {
  const int chunks = (S + kEpRows - 1) / kEpRows;
  dim3 grid_s(chunks, C / kEpCols, B);
  cast_sum_kernel<<<grid_s, 256, 0, st>>>(x, sums, S, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dev_sq_kernel<<<grid_s, 256, 0, st>>>(x, sums, partials, B, S, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int BC = B * C;
  coef_kernel<<<(BC + 255) / 256, 256, 0, st>>>(sums, partials, gamma, coef, BC, S, chunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_e(epilogue_blocks(S, C), B);
  const size_t smem = 3 * C * sizeof(float);
  epi_amax_kernel<R><<<grid_e, kEpiThreads, smem, st>>>(x, coef, beta, res, amax, B, S, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  epi_requant_kernel<R><<<grid_e, kEpiThreads, smem, st>>>(x, coef, beta, res, amax, h_out, out,
                                                           B, S, C);
  return (int)cudaGetLastError();
}

}  // namespace msig

// Both entries return cudaGetLastError() after the launches (0 = success),
// launch on `stream` and do not synchronise. x: [B, S, C] int32; gamma, beta:
// [B, C] float32; sums: int64 [B*C], zeroed; partials: float64
// [ceil(S/128), B*C]; coef: float32 [2*B*C]; amax: uint32 [B], zeroed; out:
// [B, S, C] int8. Needs C % 128 == 0.
extern "C" int msig_adain_relu_requant(const void* x, const void* gamma, const void* beta,
                                       void* sums, void* partials, void* coef, void* amax,
                                       void* out, int B, int S, int C, float eps, void* stream) {
  using namespace msig;
  return epilogue_launch<void>(
      static_cast<const int32_t*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), nullptr, static_cast<long long*>(sums),
      static_cast<double*>(partials), static_cast<float*>(coef),
      static_cast<unsigned int*>(amax), nullptr, static_cast<int8_t*>(out), B, S, C, eps,
      reinterpret_cast<cudaStream_t>(stream));
}

// residual and h_out: [B, S, C], bfloat16 (res_bf16 != 0) or float32.
extern "C" int msig_adain_residual_requant(const void* x, const void* gamma, const void* beta,
                                           const void* residual, void* sums, void* partials,
                                           void* coef, void* amax, void* h_out, void* out, int B,
                                           int S, int C, float eps, int res_bf16, void* stream) {
  using namespace msig;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* xp = static_cast<const int32_t*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  long long* sp = static_cast<long long*>(sums);
  double* pp = static_cast<double*>(partials);
  float* cp = static_cast<float*>(coef);
  unsigned int* ap = static_cast<unsigned int*>(amax);
  int8_t* op = static_cast<int8_t*>(out);
  if (res_bf16)
    return epilogue_launch<__nv_bfloat16>(xp, gp, bp, static_cast<const __nv_bfloat16*>(residual),
                                          sp, pp, cp, ap, static_cast<__nv_bfloat16*>(h_out), op,
                                          B, S, C, eps, st);
  return epilogue_launch<float>(xp, gp, bp, static_cast<const float*>(residual), sp, pp, cp, ap,
                                static_cast<float*>(h_out), op, B, S, C, eps, st);
}
