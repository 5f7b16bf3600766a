// Resblock conv2 site with a two-plane int8 residual carry: int8 3x3 conv ->
// IN -> AdaIN (gamma, beta) -> + the residual (h1 + h2/254) * scale -> requant
// into two int8 planes under one per-sample scale, on dense NHWC
// [B, H, W, C]. q1 = round(hn * s) feeds the next conv1 (or the decoder) like
// the stock carry; q2 = round((hn * s - q1) * 254) holds what q1 rounded away,
// so the next block adds about 15 bits of the residual at 2 bytes per element.
//
// Replaces the TPU kernel msig_tpu/ops/fused_conv_int8_v2.py::
// conv3x3_adain_residual_hifi2 (_kernel_res_hifi2), which keeps the int32
// accumulator and the fp32 hn of one sample in VMEM.
//
// Bound on an H100 at [8, 64, 64, 256]: 38.7 G int8 operations (19.5 us at
// 1,979 TOP/s) against 42 MB that must move (3 bytes per element in, 2 out;
// 13 us at 3.35 TB/s), so operations bound it. This design adds the int32
// round trip and computes hn twice (once for max|hn|, once to store).
//
// Three launches: conv + statistics (conv_int8.cuh), max|hn| per sample, the
// two planes and the new scale.
#include "conv_int8.cuh"

namespace msig {

// hn = y*a + d + h1*hs + h2*hs2, the additions in the order of
// fused_conv_int8_v2.py:291. Both kernels below evaluate it with the same
// rounded operations, so the requant sees exactly the values whose max it took.
__device__ __forceinline__ float hifi2_hn(int v, signed char h1, signed char h2, float a, float d,
                                          float hs, float hs2) {
  const float base = __fadd_rn(__fmul_rn((float)v, a), d);
  return __fadd_rn(__fadd_rn(base, __fmul_rn((float)h1, hs)), __fmul_rn((float)h2, hs2));
}

// hs2 = hs * fp32(1/254) (:284): the constant is the double quotient rounded to fp32.
__device__ __forceinline__ float hifi2_hs2(float hs) {
  return __fmul_rn(hs, (float)(1.0 / 254.0));
}

__global__ void __launch_bounds__(kEpiThreads)
hifi2_amax_kernel(const int32_t* __restrict__ y, const int8_t* __restrict__ h1,
                  const int8_t* __restrict__ h2, const float* __restrict__ h_scale,
                  long long* __restrict__ stats, const float* __restrict__ gamma,
                  const float* __restrict__ beta, int B, int HW, int C, float eps) {
  extern __shared__ float sh[];
  __shared__ float red[32];
  float* a_s = sh;
  float* d_s = sh + C;
  const int b = blockIdx.y;
  channel_affine(stats, gamma, beta, b, B, C, HW, eps, a_s, d_s);
  __syncthreads();
  const float hs = h_scale[b], hs2 = hifi2_hs2(hs);
  const size_t n4 = (size_t)HW * C / 4;
  const int4* y4 = reinterpret_cast<const int4*>(y + (size_t)b * HW * C);
  const char4* p1 = reinterpret_cast<const char4*>(h1 + (size_t)b * HW * C);
  const char4* p2 = reinterpret_cast<const char4*>(h2 + (size_t)b * HW * C);
  float local = 0.f;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const int4 v = y4[i];
    const char4 r1 = p1[i], r2 = p2[i];
    const int c = (int)((i * 4) % C);
    local = fmaxf(local, fabsf(hifi2_hn(v.x, r1.x, r2.x, a_s[c], d_s[c], hs, hs2)));
    local = fmaxf(local, fabsf(hifi2_hn(v.y, r1.y, r2.y, a_s[c + 1], d_s[c + 1], hs, hs2)));
    local = fmaxf(local, fabsf(hifi2_hn(v.z, r1.z, r2.z, a_s[c + 2], d_s[c + 2], hs, hs2)));
    local = fmaxf(local, fabsf(hifi2_hn(v.w, r1.w, r2.w, a_s[c + 3], d_s[c + 3], hs, hs2)));
  }
  const float m = block_max(local, red);
  if (threadIdx.x == 0) store_amax(stats, B, C, b, m);
}

__global__ void __launch_bounds__(kEpiThreads)
hifi2_requant_kernel(const int32_t* __restrict__ y, const int8_t* __restrict__ h1,
                     const int8_t* __restrict__ h2, const float* __restrict__ h_scale,
                     const long long* __restrict__ stats, const float* __restrict__ gamma,
                     const float* __restrict__ beta, int8_t* __restrict__ out1,
                     int8_t* __restrict__ out2, float* __restrict__ out_scale, int B, int HW,
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
  const float hs = h_scale[b], hs2 = hifi2_hs2(hs);
  const size_t n4 = (size_t)HW * C / 4;
  const int4* y4 = reinterpret_cast<const int4*>(y + (size_t)b * HW * C);
  const char4* p1 = reinterpret_cast<const char4*>(h1 + (size_t)b * HW * C);
  const char4* p2 = reinterpret_cast<const char4*>(h2 + (size_t)b * HW * C);
  char4* o1 = reinterpret_cast<char4*>(out1 + (size_t)b * HW * C);
  char4* o2 = reinterpret_cast<char4*>(out2 + (size_t)b * HW * C);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const int4 v = y4[i];
    const char4 r1 = p1[i], r2 = p2[i];
    const int c = (int)((i * 4) % C);
    const int vals[4] = {v.x, v.y, v.z, v.w};
    const signed char res1[4] = {r1.x, r1.y, r1.z, r1.w};
    const signed char res2[4] = {r2.x, r2.y, r2.z, r2.w};
    signed char q1[4], q2[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float t =
          __fmul_rn(hifi2_hn(vals[k], res1[k], res2[k], a_s[c + k], d_s[c + k], hs, hs2), s);
      const float q1f = rintf(fminf(fmaxf(t, -127.f), 127.f));
      const float e = __fmul_rn(__fsub_rn(t, q1f), 254.f);
      q1[k] = (signed char)(int)q1f;
      q2[k] = (signed char)__float2int_rn(fminf(fmaxf(e, -127.f), 127.f));
    }
    o1[i] = make_char4(q1[0], q1[1], q1[2], q1[3]);
    o2[i] = make_char4(q2[0], q2[1], q2[2], q2[3]);
  }
}

}  // namespace msig

// Returns cudaGetLastError() after the launches (0 = success). Launches on
// `stream` and does not synchronise. h1, h2, out1, out2: [B, H, W, C] int8;
// h_scale, out_scale: [B] float32; y_scratch: [B, H*W, C] int32; stats:
// int64 [5*B*C + B], zeroed.
extern "C" int msig_conv3x3_adain_residual_hifi2(const void* y1, const void* h1, const void* h2,
                                                 const void* h_scale, const void* w,
                                                 const void* gamma, const void* beta,
                                                 void* y_scratch, void* stats, void* out1,
                                                 void* out2, void* out_scale, int B, int H, int W,
                                                 int C, float eps, void* stream) {
  using namespace msig;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const int32_t* yp = static_cast<const int32_t*>(y_scratch);
  const int8_t* p1 = static_cast<const int8_t*>(h1);
  const int8_t* p2 = static_cast<const int8_t*>(h2);
  const float* hsp = static_cast<const float*>(h_scale);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  dim3 grid_a(B * (HW / kBM), C / 128);
  conv_i8_stats_kernel<Conv3x3Geom, 128><<<grid_a, kConvThreads, 0, st>>>(
      static_cast<const int8_t*>(y1), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(y_scratch), static_cast<long long*>(stats), B, H, W, C, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_b(epilogue_blocks(HW, C), B);
  const size_t smem = 2 * C * sizeof(float);
  hifi2_amax_kernel<<<grid_b, kEpiThreads, smem, st>>>(
      yp, p1, p2, hsp, static_cast<long long*>(stats), gp, bp, B, HW, C, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hifi2_requant_kernel<<<grid_b, kEpiThreads, smem, st>>>(
      yp, p1, p2, hsp, static_cast<const long long*>(stats), gp, bp, static_cast<int8_t*>(out1),
      static_cast<int8_t*>(out2), static_cast<float*>(out_scale), B, HW, C, eps);
  return (int)cudaGetLastError();
}
