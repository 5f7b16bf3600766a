// Resblock conv2 site: int8 3x3 conv -> IN -> AdaIN (gamma, beta) -> + the
// int8 residual times its per-sample scale -> requant with the true max|hn|,
// on dense NHWC [B, H, W, C]. Returns int8 and the new scale amax/127.
//
// Replaces the TPU kernel msig_tpu/ops/fused_conv_int8_v2.py::
// conv3x3_adain_residual_requant (_kernel_res), which keeps the int32
// accumulator and the fp32 hn of one sample in VMEM.
//
// Bound on an H100 at [8, 64, 64, 256]: 38.7 G int8 operations (19.5 us at
// 1,979 TOP/s) against 25.8 MB that must move (7.7 us at 3.35 TB/s), so
// operations bound it. This design adds the int32 round trip and computes hn
// twice (once for max|hn|, once to store) instead of keeping it; a later pass
// can fuse them.
//
// Launches: a memset of the statistics block, the conv + statistics on wgmma
// (conv_i8_wgmma.cuh, K-major weights), max|hn| per sample (float
// atomicMax on the bit pattern of a non-negative float), requant. The v1
// conv2 site (msig_tpu/ops/fused_conv_int8.py::conv3x3_adain_residual_requant)
// computes the same function and runs this entry too.
#include "conv_i8_wgmma.cuh"
#include "conv_int8.cuh"

namespace msig {

// hn: residual_hn of conv_int8.cuh.
__global__ void __launch_bounds__(kEpiThreads)
residual_amax_kernel(const int32_t* __restrict__ y, const int8_t* __restrict__ h,
                     const float* __restrict__ h_scale, long long* __restrict__ stats,
                     const float* __restrict__ gamma, const float* __restrict__ beta, int B,
                     int HW, int C, float eps) {
  extern __shared__ float sh[];
  __shared__ float red[32];
  float* a_s = sh;
  float* d_s = sh + C;
  const int b = blockIdx.y;
  channel_affine(stats, gamma, beta, b, B, C, HW, eps, a_s, d_s);
  __syncthreads();
  const float hs = h_scale[b];
  const size_t n4 = (size_t)HW * C / 4;
  const int4* y4 = reinterpret_cast<const int4*>(y + (size_t)b * HW * C);
  const char4* h4 = reinterpret_cast<const char4*>(h + (size_t)b * HW * C);
  float local = 0.f;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const int4 v = y4[i];
    const char4 r = h4[i];
    const int c = (int)((i * 4) % C);
    local = fmaxf(local, fabsf(residual_hn(v.x, r.x, a_s[c], d_s[c], hs)));
    local = fmaxf(local, fabsf(residual_hn(v.y, r.y, a_s[c + 1], d_s[c + 1], hs)));
    local = fmaxf(local, fabsf(residual_hn(v.z, r.z, a_s[c + 2], d_s[c + 2], hs)));
    local = fmaxf(local, fabsf(residual_hn(v.w, r.w, a_s[c + 3], d_s[c + 3], hs)));
  }
  const float m = block_max(local, red);
  if (threadIdx.x == 0) store_amax(stats, B, C, b, m);
}

__global__ void __launch_bounds__(kEpiThreads)
residual_requant_kernel(const int32_t* __restrict__ y, const int8_t* __restrict__ h,
                        const float* __restrict__ h_scale, const long long* __restrict__ stats,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        int8_t* __restrict__ out, float* __restrict__ out_scale, int B, int HW,
                        int C, float eps) {
  extern __shared__ float sh[];
  float* a_s = sh;
  float* d_s = sh + C;
  const int b = blockIdx.y;
  channel_affine(stats, gamma, beta, b, B, C, HW, eps, a_s, d_s);
  __syncthreads();
  const float amax = load_amax(stats, B, C, b);
  const float s = amax > 0.f ? __fdiv_rn(127.f, amax) : 1.f;
  if (blockIdx.x == 0 && threadIdx.x == 0) out_scale[b] = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
  const float hs = h_scale[b];
  const size_t n4 = (size_t)HW * C / 4;
  const int4* y4 = reinterpret_cast<const int4*>(y + (size_t)b * HW * C);
  const char4* h4 = reinterpret_cast<const char4*>(h + (size_t)b * HW * C);
  char4* o4 = reinterpret_cast<char4*>(out + (size_t)b * HW * C);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const int4 v = y4[i];
    const char4 r = h4[i];
    const int c = (int)((i * 4) % C);
    const int vals[4] = {v.x, v.y, v.z, v.w};
    const signed char res[4] = {r.x, r.y, r.z, r.w};
    signed char q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float t = __fmul_rn(residual_hn(vals[k], res[k], a_s[c + k], d_s[c + k], hs), s);
      q[k] = (signed char)__float2int_rn(fminf(fmaxf(t, -127.f), 127.f));
    }
    o4[i] = make_char4(q[0], q[1], q[2], q[3]);
  }
}

}  // namespace msig

// Returns a CUDA error code (0 = success) after the launches. Launches on
// `stream` and does not synchronise. wk: [C, 9*C] int8, K-major (the
// transpose of the [9*C, C] packing); h_scale: [B] float32; out_scale: [B]
// float32; y_scratch: [B, H*W, C] int32; stats: int64 [5*B*C + B], zeroed here.
extern "C" int msig_conv3x3_adain_residual_requant(const void* y1, const void* h,
                                                   const void* h_scale, const void* wk,
                                                   const void* gamma, const void* beta,
                                                   void* y_scratch, void* stats, void* out,
                                                   void* out_scale, int B, int H, int W, int C,
                                                   float eps, void* stream) {
  using namespace msig;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const int err_a = wgmma::conv3x3_i8_stats(y1, wk, y_scratch, stats, B, H, W, C, st);
  if (err_a != 0) return err_a;
  dim3 grid_b(epilogue_blocks(HW, C), B);
  const size_t smem = 2 * C * sizeof(float);
  residual_amax_kernel<<<grid_b, kEpiThreads, smem, st>>>(
      static_cast<const int32_t*>(y_scratch), static_cast<const int8_t*>(h),
      static_cast<const float*>(h_scale), static_cast<long long*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), B, HW, C, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  residual_requant_kernel<<<grid_b, kEpiThreads, smem, st>>>(
      static_cast<const int32_t*>(y_scratch), static_cast<const int8_t*>(h),
      static_cast<const float*>(h_scale), static_cast<const long long*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<int8_t*>(out), static_cast<float*>(out_scale), B, HW, C, eps);
  return (int)cudaGetLastError();
}
