// Resblock conv2 site with a bf16 residual carry: int8 3x3 conv -> IN -> AdaIN
// (gamma, beta) -> + the bf16 residual, on dense NHWC [B, H, W, C]. Returns
// the new residual as bf16 and its int8 copy, which feeds the next conv1 (or
// the decoder); no scale is returned, the next block adds the bf16 carry.
//
// Replaces the TPU kernel msig_tpu/ops/fused_conv_int8_v2.py::
// conv3x3_adain_residual_hifi (_kernel_res_hifi), which keeps one sample's
// int32 accumulator in VMEM and writes the bf16 carry once.
//
// Two values must come from the right source (either mistake still gives a
// plausible image): max|hn| is taken from the fp32 hn = y*a + d + float(hb),
// before it is rounded to bf16; the int8 copy is quantized from the rounded
// bf16 carry, round(clip(float(carry) * s)), not from hn.
//
// Bound on an H100 at [8, 64, 64, 256]: 38.7 G int8 operations (19.5 us at
// 1,979 TOP/s) against 51 MB that must move (1 + 2 bytes per element in,
// 1 + 2 out; 15 us at 3.35 TB/s), so operations bound it. The conv runs on
// wgmma at rows 1-2's pace (conv_i8_wgmma.cuh: K-major weights, a cp.async
// ring, statistics from the registers). This design adds the int32 round trip
// (34 MB written, then read) and reads the carry it has just written once more
// (17 MB): max|hn| must be complete before any int8 copy is written.
//
// Launches: a memset of the statistics block and the conv + statistics on
// wgmma (wgmma::conv3x3_i8_stats, K-major weights), the carry and max|hn|
// per sample, the int8 copy.
#include <cuda_bf16.h>

#include "conv_i8_wgmma.cuh"
#include "conv_int8.cuh"

namespace msig {

__global__ void __launch_bounds__(kEpiThreads)
hifi_carry_kernel(const int32_t* __restrict__ y, const __nv_bfloat16* __restrict__ hb,
                  long long* __restrict__ stats, const float* __restrict__ gamma,
                  const float* __restrict__ beta, __nv_bfloat16* __restrict__ out_hb, int B,
                  int HW, int C, float eps) {
  extern __shared__ float sh[];
  __shared__ float red[32];
  float* a_s = sh;
  float* d_s = sh + C;
  const int b = blockIdx.y;
  channel_affine(stats, gamma, beta, b, B, C, HW, eps, a_s, d_s);
  __syncthreads();
  const size_t n4 = (size_t)HW * C / 4;
  const int4* y4 = reinterpret_cast<const int4*>(y + (size_t)b * HW * C);
  const uint2* h4 = reinterpret_cast<const uint2*>(hb + (size_t)b * HW * C);
  uint2* o4 = reinterpret_cast<uint2*>(out_hb + (size_t)b * HW * C);
  float local = 0.f;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const int4 v = y4[i];
    const uint2 r = h4[i];
    const int c = (int)((i * 4) % C);
    const int vals[4] = {v.x, v.y, v.z, v.w};
    const __nv_bfloat16* res = reinterpret_cast<const __nv_bfloat16*>(&r);
    uint2 o;
    __nv_bfloat16* carry = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // hn = y*a + d + h, in the order of fused_conv_int8_v2.py:229-231.
      const float hn = __fadd_rn(__fadd_rn(__fmul_rn((float)vals[k], a_s[c + k]), d_s[c + k]),
                                 __bfloat162float(res[k]));
      local = fmaxf(local, fabsf(hn));
      carry[k] = __float2bfloat16_rn(hn);
    }
    o4[i] = o;
  }
  const float m = block_max(local, red);
  if (threadIdx.x == 0) store_amax(stats, B, C, b, m);
}

__global__ void __launch_bounds__(kEpiThreads)
hifi_requant_kernel(const __nv_bfloat16* __restrict__ carry, const long long* __restrict__ stats,
                    int8_t* __restrict__ out, int B, int HW, int C) {
  const int b = blockIdx.y;
  const float amax = load_amax(stats, B, C, b);
  const float s = amax > 0.f ? __fdiv_rn(127.f, amax) : 1.f;
  const size_t n4 = (size_t)HW * C / 4;
  const uint2* h4 = reinterpret_cast<const uint2*>(carry + (size_t)b * HW * C);
  char4* o4 = reinterpret_cast<char4*>(out + (size_t)b * HW * C);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const uint2 r = h4[i];
    const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&r);
    signed char q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float t = __fmul_rn(__bfloat162float(hv[k]), s);
      q[k] = (signed char)__float2int_rn(fminf(fmaxf(t, -127.f), 127.f));
    }
    o4[i] = make_char4(q[0], q[1], q[2], q[3]);
  }
}

}  // namespace msig

// Returns a CUDA error code (0 = success) after the launches. Launches on
// `stream` and does not synchronise. wk: [C, 9*C] int8, K-major (the transpose
// of the [9*C, C] packing); hb, out_hb: [B, H, W, C] bf16, distinct buffers;
// y_scratch: [B, H*W, C] int32; stats: int64 [5*B*C + B], zeroed here.
extern "C" int msig_conv3x3_adain_residual_hifi(const void* y1, const void* hb, const void* wk,
                                                const void* gamma, const void* beta,
                                                void* y_scratch, void* stats, void* out,
                                                void* out_hb, int B, int H, int W, int C,
                                                float eps, void* stream) {
  using namespace msig;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const int err_a = wgmma::conv3x3_i8_stats(y1, wk, y_scratch, stats, B, H, W, C, st);
  if (err_a != 0) return err_a;
  dim3 grid_b(epilogue_blocks(HW, C), B);
  hifi_carry_kernel<<<grid_b, kEpiThreads, 2 * C * sizeof(float), st>>>(
      static_cast<const int32_t*>(y_scratch), static_cast<const __nv_bfloat16*>(hb),
      static_cast<long long*>(stats), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(out_hb), B, HW, C, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hifi_requant_kernel<<<grid_b, kEpiThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(out_hb), static_cast<const long long*>(stats),
      static_cast<int8_t*>(out), B, HW, C);
  return (int)cudaGetLastError();
}
