// Decoder upsampling site: int8 ConvTranspose 4x4 / stride 2 / pad 1 -> IN ->
// ReLU -> per-sample requant to int8, dense NHWC [B, H, W, Cin] ->
// [B, 2H, 2W, Cout], plus the inverse scale amax/127 per sample.
//
// Replaces two TPU kernels that compute this one function in different slab
// layouts: msig_tpu/ops/fused_conv_int8_v2.py::convt4x4s2_in_relu_requant_ps
// (_kernel_up_ps, up0 256 -> 128 on the 64-grid, s2d-4 output) and
// msig_tpu/ops/fused_dec_int8.py::up1_s2d16 (_kernel_up1_s2d16, up1 128 -> 64
// read straight from up0's s2d slab, s2d-16 output with reflect guards for the
// final conv). Dense NHWC needs neither layout: the final conv reflects by
// index instead (final7_tanh_u8.cu).
//
// The ConvT runs as four output phases, each a dense GEMM with M = input
// pixels, N = Cout and K = 4*Cin over the 2x2 taps of the phase
// (ConvT4x4s2Geom in conv_int8.cuh), so no MAC multiplies an inserted zero.
// Bound on an H100 at the main path's shapes, B = 8: up0 [8, 64, 64, 256] ->
// [8, 128, 128, 128] and up1 [8, 128, 128, 128] -> [8, 256, 256, 64] are each
// 2 * outputs * 4 * Cin = 34.4 G int8 operations (17.4 us at 1,979 TOP/s),
// against 25 MB (up0) or 50 MB (up1) that must move (7.5 or 15 us at
// 3.35 TB/s), so operations bound both. This design adds the int32 round trip
// (67 or 134 MB at B = 8) and uses mma.sync, not wgmma.
//
// Two launches, both from conv_int8.cuh: conv + exact int64 statistics over
// all four phases, then the relu epilogue with gamma = 1, beta = 0, which
// also writes the inverse scale.
#include "conv_int8.cuh"

// Returns cudaGetLastError() after the launches (0 = success). Launches on
// `stream` and does not synchronise. w: [16*Cin, Cout] int8 from
// pack_convt_weights_ps; y_scratch: [B, 4*H*W, Cout] int32; stats: int64
// [4*B*Cout + B], zero-initialised; out: [B, 2H, 2W, Cout] int8;
// out_scale: [B] float32. Needs Cin % 64 == 0, Cout % 64 == 0,
// H*W % 128 == 0.
extern "C" int msig_convt4x4s2_in_relu_requant(const void* x, const void* w, void* y_scratch,
                                               void* stats, void* out, void* out_scale, int B,
                                               int H, int W, int Cin, int Cout, float eps,
                                               void* stream) {
  using namespace msig;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  int32_t* yp = static_cast<int32_t*>(y_scratch);
  long long* sp = static_cast<long long*>(stats);
  if (Cout % 128 == 0) {
    dim3 grid_a(B * ConvT4x4s2Geom::kPhases * (HW / kBM), Cout / 128);
    conv_i8_stats_kernel<ConvT4x4s2Geom, 128><<<grid_a, kConvThreads, 0, st>>>(
        xp, wp, yp, sp, B, H, W, Cin, Cout);
  } else {
    dim3 grid_a(B * ConvT4x4s2Geom::kPhases * (HW / kBM), Cout / 64);
    conv_i8_stats_kernel<ConvT4x4s2Geom, 64><<<grid_a, kConvThreads, 0, st>>>(
        xp, wp, yp, sp, B, H, W, Cin, Cout);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int HWo = 4 * HW;
  dim3 grid_b(epilogue_blocks(HWo, Cout), B);
  relu_requant_kernel<<<grid_b, kEpiThreads, 2 * Cout * sizeof(float), st>>>(
      yp, sp, nullptr, nullptr, static_cast<int8_t*>(out), static_cast<float*>(out_scale), B,
      HWo, Cout, eps);
  return (int)cudaGetLastError();
}
