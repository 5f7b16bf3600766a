// Resblock conv1 site: int8 3x3 conv -> IN -> AdaIN (gamma, beta) -> ReLU ->
// per-sample requant to int8, on dense NHWC [B, H, W, C].
//
// Replaces the TPU kernel msig_tpu/ops/fused_conv_int8_v2.py::
// conv3x3_adain_relu_requant (_kernel_relu), which runs one sample per program
// with its int32 accumulator in VMEM.
//
// Bound on an H100 at the main path's shape [8, 64, 64, 256]: the conv is
// 2 * 8 * 4096 * 256 * 2304 = 38.7 G int8 operations (19.5 us at 1,979 TOP/s),
// against 17.4 MB that must move (5.2 us at 3.35 TB/s), so operations bound
// it. This design adds the int32 round trip through device memory (64 MB at
// B = 8) and uses mma.sync rather than wgmma; both are left for a later pass.
//
// Two launches: conv + statistics (conv3x3_int8.cuh), then the epilogue, in
// which every CTA first rebuilds its sample's per-channel affine and the
// requant scale from the statistics (256 channels: cheaper than a third launch).
#include "conv3x3_int8.cuh"

namespace msig {

// amax from the affine image of the zero-masked min and max, as the TPU kernel
// does (fused_conv_int8_v2.py:127-131); it may exceed the true max, never
// clip. Then y -> round(min(max(y*a2 + d2, 0), 127)) with a2 = a*s, d2 = d*s.
__global__ void __launch_bounds__(kEpiThreads)
relu_requant_kernel(const int32_t* __restrict__ y, const long long* __restrict__ stats,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    int8_t* __restrict__ out, int B, int HW, int C, float eps) {
  extern __shared__ float sh[];  // a[C], d[C]
  __shared__ float red[32];
  float* a_s = sh;
  float* d_s = sh + C;
  const int b = blockIdx.y;
  channel_affine(stats, gamma, beta, b, B, C, HW, eps, a_s, d_s);
  __syncthreads();

  const size_t BC = (size_t)B * C;
  float local = 0.f;  // max(hi, 0)
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float cmin = (float)stats[2 * BC + (size_t)b * C + c];
    const float cmax = (float)stats[3 * BC + (size_t)b * C + c];
    const float hi = __fadd_rn(fmaxf(__fmul_rn(a_s[c], cmax), __fmul_rn(a_s[c], cmin)), d_s[c]);
    local = fmaxf(local, hi);
  }
  const float amax = block_max(local, red);
  const float s = amax > 0.f ? __fdiv_rn(127.f, amax) : 1.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    a_s[c] = __fmul_rn(a_s[c], s);
    d_s[c] = __fmul_rn(d_s[c], s);
  }
  __syncthreads();

  const size_t n4 = (size_t)HW * C / 4;
  const int4* y4 = reinterpret_cast<const int4*>(y + (size_t)b * HW * C);
  char4* o4 = reinterpret_cast<char4*>(out + (size_t)b * HW * C);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const int4 v = y4[i];
    const int c = (int)((i * 4) % C);
    const int vals[4] = {v.x, v.y, v.z, v.w};
    signed char q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float t = __fadd_rn(__fmul_rn((float)vals[k], a_s[c + k]), d_s[c + k]);
      t = fminf(fmaxf(t, 0.f), 127.f);
      q[k] = (signed char)__float2int_rn(t);
    }
    o4[i] = make_char4(q[0], q[1], q[2], q[3]);
  }
}

}  // namespace msig

// Returns cudaGetLastError() after the launches (0 = success). Launches on
// `stream` and does not synchronise. y_scratch: [B, H*W, C] int32;
// stats: int64 [4*B*C + B], zero-initialised.
extern "C" int msig_conv3x3_adain_relu_requant(const void* x, const void* w, const void* gamma,
                                               const void* beta, void* y_scratch, void* stats,
                                               void* out, int B, int H, int W, int C, float eps,
                                               void* stream) {
  using namespace msig;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int HW = H * W;
  dim3 grid_a(B * (HW / kBM), C / kBN);
  conv3x3_i8_stats_kernel<<<grid_a, kConvThreads, 0, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(y_scratch), static_cast<long long*>(stats), B, H, W, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_b(epilogue_blocks(HW, C), B);
  relu_requant_kernel<<<grid_b, kEpiThreads, 2 * C * sizeof(float), st>>>(
      static_cast<const int32_t*>(y_scratch), static_cast<const long long*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<int8_t*>(out), B, HW, C, eps);
  return (int)cudaGetLastError();
}
