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
// Two launches, both from conv_int8.cuh: conv + exact statistics over all
// four phases, then the relu epilogue with gamma = 1, beta = 0, which also
// writes the inverse scale.
//
// At the 512-pixel map, up1 [B, 256, 256, 128] -> [B, 512, 512, 64], the TPU
// runs this site as the staged pair msig_tpu/ops/fused_dec_int8.py::
// up1_s2d16_hbm (_kernel_up1_conv_hbm, _kernel_up1_rq_hbm), because there the
// accumulator no longer fits VMEM; here it goes through device memory at
// every size, so the staged site is these two launches at that shape. What
// the staged pair adds is kept: with stage_fp16 the accumulator crosses as
// fp16 x 2^-12 (StageOf<__half>), 268 MB instead of 537 MB each way at B = 8,
// the statistics still from the exact int32 values.
//
// A second entry, msig_convt4x4s2_kcat, takes the 9-tap K-concat weight
// operand [9*Cin, 4*Cout] (msig_tpu/ops/fused_conv_int8.py::
// pack_convt_weights) that two more TPU kernels read, and replaces both:
//  - msig_tpu/ops/fused_conv_int8_v2.py::convt4x4s2_in_relu_requant
//    (_kernel_up), this site's function with the same zero-masked
//    statistics and folded requant (true_extremes = 0);
//  - msig_tpu/ops/fused_conv_int8.py::convt4x4s2_in_relu_requant (v1,
//    _kernel_up), the true per-channel extremes (:225-226) and the unfolded
//    requant (:256-263) (true_extremes = 1).
// The TPU kernels multiply all nine row blocks against all four phases'
// columns, 20 of 36 blocks zero. Here ConvT4x4s2KcatGeom reads each phase's
// four nonzero blocks where they lie, so the MACs, the bound and the int32
// sums are those of the phase-split entry, and the operand is not repacked.
// The four phases' lanes are folded into per-channel statistics by
// construction (every phase adds to its channel's entries), as the TPU folds
// them (fused_conv_int8.py:243-249); with a > 0 the max over the phase lanes of
// a*max y + d is a*(max over phases of max y) + d, so the folded true extremes
// give the TPU's amax.
#include "conv_int8.cuh"

namespace msig {

template <class Stage>
int convt4x4s2_launch(const int8_t* x, const int8_t* w, Stage* y, long long* stats, int8_t* out,
                      float* out_scale, int B, int H, int W, int Cin, int Cout, float eps,
                      cudaStream_t st) {
  const int HW = H * W;
  if (Cout % 128 == 0) {
    dim3 grid_a(B * ConvT4x4s2Geom::kPhases * (HW / kBM), Cout / 128);
    conv_i8_stats_kernel<ConvT4x4s2Geom, 128, Stage><<<grid_a, kConvThreads, 0, st>>>(
        x, w, y, stats, B, H, W, Cin, Cout);
  } else {
    dim3 grid_a(B * ConvT4x4s2Geom::kPhases * (HW / kBM), Cout / 64);
    conv_i8_stats_kernel<ConvT4x4s2Geom, 64, Stage><<<grid_a, kConvThreads, 0, st>>>(
        x, w, y, stats, B, H, W, Cin, Cout);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int HWo = 4 * HW;
  dim3 grid_b(epilogue_blocks(HWo, Cout), B);
  relu_requant_kernel<Stage><<<grid_b, kEpiThreads, 2 * Cout * sizeof(float), st>>>(
      y, stats, nullptr, nullptr, out, out_scale, B, HWo, Cout, eps);
  return (int)cudaGetLastError();
}

template <int BN, bool kTrueExtremes>
int convt4x4s2_kcat_launch(const int8_t* x, const int8_t* w, int32_t* y, long long* stats,
                           int8_t* out, float* out_scale, int B, int H, int W, int Cin, int Cout,
                           float eps, cudaStream_t st) {
  const int HW = H * W;
  dim3 grid_a(B * ConvT4x4s2KcatGeom::kPhases * (HW / kBM), Cout / BN);
  conv_i8_stats_kernel<ConvT4x4s2KcatGeom, BN, int32_t, kTrueExtremes>
      <<<grid_a, kConvThreads, 0, st>>>(x, w, y, stats, B, H, W, Cin, Cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int HWo = 4 * HW;
  dim3 grid_b(epilogue_blocks(HWo, Cout), B);
  const size_t smem = 2 * Cout * sizeof(float);
  if constexpr (kTrueExtremes)
    true_relu_requant_kernel<<<grid_b, kEpiThreads, smem, st>>>(y, stats, nullptr, nullptr, out,
                                                                out_scale, B, HWo, Cout, eps);
  else
    relu_requant_kernel<int32_t><<<grid_b, kEpiThreads, smem, st>>>(
        y, stats, nullptr, nullptr, out, out_scale, B, HWo, Cout, eps);
  return (int)cudaGetLastError();
}

}  // namespace msig

// Returns cudaGetLastError() after the launches (0 = success). Launches on
// `stream` and does not synchronise. w: [16*Cin, Cout] int8 from
// pack_convt_weights_ps; y_scratch: [B, 4*H*W, Cout], int32 or (stage_fp16
// != 0) fp16; stats: int64 [5*B*Cout + B], zero-initialised; out:
// [B, 2H, 2W, Cout] int8; out_scale: [B] float32. Needs Cin % 64 == 0,
// Cout % 64 == 0, H*W % 128 == 0.
extern "C" int msig_convt4x4s2_in_relu_requant(const void* x, const void* w, void* y_scratch,
                                               void* stats, void* out, void* out_scale, int B,
                                               int H, int W, int Cin, int Cout, float eps,
                                               int stage_fp16, void* stream) {
  using namespace msig;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  long long* sp = static_cast<long long*>(stats);
  int8_t* op = static_cast<int8_t*>(out);
  float* osp = static_cast<float*>(out_scale);
  if (stage_fp16)
    return convt4x4s2_launch(xp, wp, static_cast<__half*>(y_scratch), sp, op, osp, B, H, W, Cin,
                             Cout, eps, st);
  return convt4x4s2_launch(xp, wp, static_cast<int32_t*>(y_scratch), sp, op, osp, B, H, W, Cin,
                           Cout, eps, st);
}

// The K-concat entry (see above). w: [9*Cin, 4*Cout] int8, phase q's block of
// tap (dy, dx) at rows ((dy+1)*3 + dx+1)*Cin, columns q*Cout; y_scratch:
// [B, 4*H*W, Cout] int32; stats: int64 [5*B*Cout + B], zeroed, or with
// true_extremes != 0 in the true-extremes mode (block 2 at INT64_MAX, block 3
// at INT64_MIN); out: [B, 2H, 2W, Cout] int8; out_scale: [B] float32. Needs
// Cin % 64 == 0, Cout % 64 == 0, H*W % 128 == 0.
extern "C" int msig_convt4x4s2_kcat(const void* x, const void* w, void* y_scratch, void* stats,
                                    void* out, void* out_scale, int B, int H, int W, int Cin,
                                    int Cout, float eps, int true_extremes, void* stream) {
  using namespace msig;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  int32_t* yp = static_cast<int32_t*>(y_scratch);
  long long* sp = static_cast<long long*>(stats);
  int8_t* op = static_cast<int8_t*>(out);
  float* osp = static_cast<float*>(out_scale);
  if (Cout % 128 == 0)
    return true_extremes
               ? convt4x4s2_kcat_launch<128, true>(xp, wp, yp, sp, op, osp, B, H, W, Cin, Cout,
                                                   eps, st)
               : convt4x4s2_kcat_launch<128, false>(xp, wp, yp, sp, op, osp, B, H, W, Cin, Cout,
                                                    eps, st);
  return true_extremes
             ? convt4x4s2_kcat_launch<64, true>(xp, wp, yp, sp, op, osp, B, H, W, Cin, Cout, eps,
                                                st)
             : convt4x4s2_kcat_launch<64, false>(xp, wp, yp, sp, op, osp, B, H, W, Cin, Cout, eps,
                                                 st);
}
