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
// it. The int32 accumulator still round-trips through device memory (32 MB
// written and read back at B = 8): a sample's is 4 MB, past an SM's 227 KB.
//
// Launches: a memset of the statistics block, the conv + statistics on
// wgmma (conv_i8_wgmma.cuh, K-major weights), then the relu epilogue
// (conv_int8.cuh), in which every CTA first rebuilds its sample's per-channel
// affine and the requant scale from the statistics (256 channels: cheaper
// than a third kernel).
//
// A second entry, msig_conv3x3_adain_relu_requant_v1, replaces the v1 TPU
// kernel of the same function, msig_tpu/ops/fused_conv_int8.py::
// conv3x3_adain_relu_requant (_kernel, the guard-row slab and a [1024, 9C]
// im2col operand in VMEM). Its requant differs: the true per-channel extremes
// (:125-126, :138-139) and the unfolded max(y*a + d, 0) * s (:154-157),
// where v2 zero-masks the extremes and folds s into a and d. v1's packing is
// v2's, so it reads the same K-major copy. Three launches, the same bound: the
// statistics block set to the true-extremes mode's neutral values (a fill
// kernel, not a memset: the extremes' blocks start at the int32 ends, as a
// CTA's shared block does), the pass A above in conv_i8_wgmma.cuh's kTrue
// mode (its own kernel, conv3x3_i8_wgmma_true_kernel), then
// true_relu_requant_kernel. Not the ConvT's two passes: at N = 256 the
// one-pass conv and its epilogue run faster than two convs would.
#include "conv_i8_wgmma.cuh"
#include "conv_int8.cuh"

// Returns a CUDA error code (0 = success) after the launches. Launches on
// `stream` and does not synchronise. wk: [C, 9*C] int8, K-major (the
// transpose of the [9*C, C] packing); y_scratch: [B, H*W, C] int32; stats:
// int64 [5*B*C + B], zeroed here.
extern "C" int msig_conv3x3_adain_relu_requant(const void* x, const void* wk, const void* gamma,
                                               const void* beta, void* y_scratch, void* stats,
                                               void* out, int B, int H, int W, int C, float eps,
                                               void* stream) {
  using namespace msig;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const int err = wgmma::conv3x3_i8_stats(x, wk, y_scratch, stats, B, H, W, C, st);
  if (err != 0) return err;
  dim3 grid_b(epilogue_blocks(HW, C), B);
  relu_requant_kernel<int32_t><<<grid_b, kEpiThreads, 2 * C * sizeof(float), st>>>(
      static_cast<const int32_t*>(y_scratch), static_cast<const long long*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<int8_t*>(out), nullptr, B, HW, C, eps);
  return (int)cudaGetLastError();
}

// The wgmma pass A's configuration, for reports: out[0..7] = tile pixels,
// bytes of K a stage, stages, threads, producer and consumer registers after
// setmaxnreg, and the dynamic shared memory of a CTA at BN = 256 and 128.
// Returns 0.
extern "C" int msig_conv3x3_i8_wgmma_config(int* out) {
  using namespace msig::wgmma;
  const int v[] = {kBM, kBK, Layout<256>::kStages, kThreads, kProducerRegs, kConsumerRegs,
                   Layout<256>::kBytes, Layout<128>::kBytes};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// The v1 site (see above). wk: [C, 9*C] int8 K-major, as above; stats: int64
// [5*B*C + B], set here to the true-extremes mode's neutral values.
extern "C" int msig_conv3x3_adain_relu_requant_v1(const void* x, const void* wk,
                                                  const void* gamma, const void* beta,
                                                  void* y_scratch, void* stats, void* out, int B,
                                                  int H, int W, int C, float eps, void* stream) {
  using namespace msig;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const int err = wgmma::conv3x3_i8_stats<true>(x, wk, y_scratch, stats, B, H, W, C, st);
  if (err != 0) return err;
  dim3 grid_b(epilogue_blocks(HW, C), B);
  true_relu_requant_kernel<<<grid_b, kEpiThreads, 2 * C * sizeof(float), st>>>(
      static_cast<const int32_t*>(y_scratch), static_cast<const long long*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<int8_t*>(out), nullptr, B, HW, C, eps);
  return (int)cudaGetLastError();
}
