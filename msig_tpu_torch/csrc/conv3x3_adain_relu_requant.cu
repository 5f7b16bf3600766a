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
// Two launches: conv + statistics, then the relu epilogue (both in
// conv_int8.cuh), in which every CTA first rebuilds its sample's per-channel
// affine and the requant scale from the statistics (256 channels: cheaper
// than a third launch).
#include "conv_int8.cuh"

// Returns cudaGetLastError() after the launches (0 = success). Launches on
// `stream` and does not synchronise. y_scratch: [B, H*W, C] int32;
// stats: int64 [5*B*C + B], zero-initialised.
extern "C" int msig_conv3x3_adain_relu_requant(const void* x, const void* w, const void* gamma,
                                               const void* beta, void* y_scratch, void* stats,
                                               void* out, int B, int H, int W, int C, float eps,
                                               void* stream) {
  using namespace msig;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int HW = H * W;
  dim3 grid_a(B * (HW / kBM), C / 128);
  conv_i8_stats_kernel<Conv3x3Geom, 128><<<grid_a, kConvThreads, 0, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(y_scratch), static_cast<long long*>(stats), B, H, W, C, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_b(epilogue_blocks(HW, C), B);
  relu_requant_kernel<int32_t><<<grid_b, kEpiThreads, 2 * C * sizeof(float), st>>>(
      static_cast<const int32_t*>(y_scratch), static_cast<const long long*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<int8_t*>(out), nullptr, B, HW, C, eps);
  return (int)cudaGetLastError();
}
