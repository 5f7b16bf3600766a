// Encoder downsampling site: int8 conv 4x4 / stride 2 / zero pad 1 -> IN ->
// ReLU -> per-sample requant to int8, dense NHWC [B, H, W, Cin] ->
// [B, H/2, W/2, Cout], plus the inverse scale amax/127 per sample.
//
// Replaces two TPU kernels: msig_tpu/ops/fused_enc_int8.py::enc1_in_relu_requant
// (_kernel_enc1, 64 -> 128, four output phases x nine grid taps on enc0's
// b-major slab) and ::enc2_in_relu_requant (_kernel_enc2, 128 -> 256, sixteen
// dense taps, which also returns the inverse scale the trunk's residual carry
// starts from). The phase packing, and the 2.25x K inflation it costs enc1,
// belong to the slab: on dense NHWC both are one GEMM with M = output pixels,
// N = Cout and K = 16*Cin (Conv4x4s2Geom in conv_int8.cuh), which is also the
// function of ::enc1_in_relu_requant_im2col.
//
// Bound on an H100 at the main path's shapes, B = 8: enc1 [8, 256, 256, 64] ->
// [8, 128, 128, 128] and enc2 [8, 128, 128, 128] -> [8, 64, 64, 256] are each
// 2 * outputs * 16 * Cin = 34.4 G int8 operations (17.4 us at 1,979 TOP/s)
// against 50 MB (enc1) or 26 MB (enc2) that must move (15 or 7.7 us at
// 3.35 TB/s), so operations bound both. This design adds the int32 round trip
// (67 or 34 MB written and read back at B = 8) and uses mma.sync, not wgmma;
// each input pixel is staged by four of the sixteen taps.
//
// Two launches, both from conv_int8.cuh: conv + exact int64 statistics, then
// the relu epilogue with gamma = 1, beta = 0, which also writes the inverse
// scale.
#include "conv_int8.cuh"

// Returns cudaGetLastError() after the launches (0 = success). Launches on
// `stream` and does not synchronise. w: [16*Cin, Cout] int8, row
// (4u + v)*Cin + ci; y_scratch: [B, H/2 * W/2, Cout] int32; stats: int64
// [5*B*Cout + B], zero-initialised; out: [B, H/2, W/2, Cout] int8;
// out_scale: [B] float32. Needs H and W even, Cin % 64 == 0,
// Cout % 64 == 0, (H/2)*(W/2) % 128 == 0.
extern "C" int msig_conv4x4s2_in_relu_requant(const void* x, const void* w, void* y_scratch,
                                              void* stats, void* out, void* out_scale, int B,
                                              int H, int W, int Cin, int Cout, float eps,
                                              void* stream) {
  using namespace msig;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int HWo = (H / 2) * (W / 2);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  int32_t* yp = static_cast<int32_t*>(y_scratch);
  long long* sp = static_cast<long long*>(stats);
  if (Cout % 128 == 0) {
    dim3 grid_a(B * (HWo / kBM), Cout / 128);
    conv_i8_stats_kernel<Conv4x4s2Geom, 128><<<grid_a, kConvThreads, 0, st>>>(
        xp, wp, yp, sp, B, H, W, Cin, Cout);
  } else {
    dim3 grid_a(B * (HWo / kBM), Cout / 64);
    conv_i8_stats_kernel<Conv4x4s2Geom, 64><<<grid_a, kConvThreads, 0, st>>>(
        xp, wp, yp, sp, B, H, W, Cin, Cout);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_b(epilogue_blocks(HWo, Cout), B);
  relu_requant_kernel<int32_t><<<grid_b, kEpiThreads, 2 * Cout * sizeof(float), st>>>(
      yp, sp, nullptr, nullptr, static_cast<int8_t*>(out), static_cast<float*>(out_scale), B,
      HWo, Cout, eps);
  return (int)cudaGetLastError();
}
