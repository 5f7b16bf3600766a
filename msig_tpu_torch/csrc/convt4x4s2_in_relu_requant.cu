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
// 3.35 TB/s), so operations bound both.
//
// The requant scale of a sample needs all its conv outputs, and the epilogue
// needs nothing of an output but to map it: so the conv runs twice on the
// wgmma main loop of conv_i8_wgmma.cuh, with K-major weights [4, Cout, 4*Cin]
// (fused_conv_int8_v2.py::pack_convt_weights_ps_kmajor), and the int32
// accumulator (67 MB at up0, 134 MB at up1, B = 8, each way) never reaches
// device memory. Three launches: a memset of the statistics block; pass S,
// the conv and the exact statistics over all four phases, storing nothing
// else; pass Q, the conv again, each CTA first rebuilding its sample's affine,
// amax and scale from the finished block (gamma = 1, beta = 0), then mapping
// its accumulator registers to int8 as relu_requant_kernel does (the shared
// helpers of conv_int8.cuh), writing the int8 map and the inverse scale. Twice
// the conv caps the design at half of the one-pass ops bound.
//
// At the 512-pixel map, up1 [B, 256, 256, 128] -> [B, 512, 512, 64], the TPU
// runs this site as the staged pair msig_tpu/ops/fused_dec_int8.py::
// up1_s2d16_hbm (_kernel_up1_conv_hbm, _kernel_up1_rq_hbm), because there the
// accumulator no longer fits VMEM; here it is the same two passes at that
// shape. The staging type is kept, applied in registers: with stage_fp16 pass
// Q reads each value as fp16(v * 2^-12) (StageOf<__half>::through) and folds
// 2^12 into the multiplier, the statistics still from the exact int32 values,
// so both stagings keep their bits without 268 or 537 MB crossing each way.
//
// A second entry, msig_convt4x4s2_kcat, serves two more TPU kernels, which
// read the 9-tap K-concat operand [9*Cin, 4*Cout] of msig_tpu/ops/
// fused_conv_int8.py::pack_convt_weights:
//  - msig_tpu/ops/fused_conv_int8_v2.py::convt4x4s2_in_relu_requant
//    (_kernel_up), this site's function with the same zero-masked
//    statistics and folded requant (true_extremes = 0): the two passes above;
//  - msig_tpu/ops/fused_conv_int8.py::convt4x4s2_in_relu_requant (v1,
//    _kernel_up), the true per-channel extremes (:224-239, the TPU starts
//    them at +-inf) and the unfolded requant max(y*a + d, 0) * s (:256-263)
//    (true_extremes = 1): the same two passes in conv_i8_wgmma.cuh's kTrue
//    mode. Its statistics block starts at the mode's neutral values (the
//    int32 ends in the extremes' blocks, stat_neutral), set on the stream by
//    a fill kernel in place of the memset: a CTA's shared block starts at the
//    same values, so its flush, which skips an entry left at its start, stays
//    right. Storing the extremes biased so that zero were neutral would have
//    kept the memset, at the price of a second encoding of the block, which
//    the single-kernel trunk (fused_trunk_blocks.cu) and
//    true_relu_requant_kernel read as it is. Pass Q then rebuilds each
//    channel's a, d unfolded and the sample's s = 127/amax, amax over the
//    true extremes (true_relu_hi's operations), and maps each register by
//    relu_requant_unfolded, with the _rn operations of
//    true_relu_requant_kernel in its order, so both equal their plain
//    versions to the bit.
// The TPU kernels multiply all nine row blocks against all four phases'
// columns, 20 of 36 blocks zero. Here both read the K-major copy
// [4, Cout, 4*Cin] of the operand's 16 nonzero blocks
// (fused_conv_int8_v2.py::pack_convt_kcat_kmajor, equal to
// pack_convt_weights_ps_kmajor of the phase-major packing), so the MACs, the
// bound and the int32 sums are those of the phase-split entry. The four
// phases' lanes are folded into per-channel statistics by construction
// (every phase adds to its channel's entries), as the TPU folds them
// (fused_conv_int8.py:243-249); with a > 0 the max over the phase lanes of
// a*max y + d is a*(max over phases of max y) + d, so the folded true extremes
// give the TPU's amax.
#include "conv_i8_wgmma.cuh"
#include "conv_int8.cuh"

// Returns a CUDA error code (0 = success) after the launches. Launches on
// `stream` and does not synchronise. wk: [4, Cout, 4*Cin] int8 from
// pack_convt_weights_ps_kmajor (phase q's [Cout, 4*Cin] block is the
// transpose of its block of pack_convt_weights_ps); stats: int64
// [5*B*Cout + B], zeroed here; out: [B, 2H, 2W, Cout] int8; out_scale: [B]
// float32; stage_fp16 != 0 reads the accumulator as fp16 x 2^-12. Needs
// Cin % 64 == 0, Cout % 64 == 0, H*W % 128 == 0.
extern "C" int msig_convt4x4s2_in_relu_requant(const void* x, const void* wk, void* stats,
                                               void* out, void* out_scale, int B, int H, int W,
                                               int Cin, int Cout, float eps, int stage_fp16,
                                               void* stream) {
  return msig::wgmma::convt4x4s2_i8(x, wk, stats, out, out_scale, B, H, W, Cin, Cout, eps,
                                    stage_fp16 != 0, reinterpret_cast<cudaStream_t>(stream));
}

// The two passes' configuration, for reports: out[0] = tile pixels, then for
// pass S and pass Q at BN = 128 and at BN = 64 (in that order) the bytes of K
// a stage, the stages of the ring and the dynamic shared memory of a CTA.
// Returns 0.
extern "C" int msig_convt_i8_wgmma_config(int* out) {
  using namespace msig::wgmma;
  using G = msig::ConvT4x4s2Geom;
  using S128 = LayoutOf<G, 128, Epi::kStats>;
  using Q128 = LayoutOf<G, 128, Epi::kRequant>;
  using S64 = LayoutOf<G, 64, Epi::kStats>;
  using Q64 = LayoutOf<G, 64, Epi::kRequant>;
  const int v[] = {kBM,
                   S128::kKBytes, S128::kStages, S128::kBytes, Q128::kKBytes, Q128::kStages,
                   Q128::kBytes, S64::kKBytes, S64::kStages, S64::kBytes, Q64::kKBytes,
                   Q64::kStages, Q64::kBytes};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return 0;
}

// The K-concat entry (see above). wk: [4, Cout, 4*Cin] int8, the K-major
// copy of the [9*Cin, 4*Cout] operand (pack_convt_kcat_kmajor); stats: int64
// [5*B*Cout + B], set here to the neutral values of the mode (zeroed, or with
// true_extremes != 0 the extremes' blocks at the int32 ends); out:
// [B, 2H, 2W, Cout] int8; out_scale: [B] float32. Needs Cin % 64 == 0,
// Cout % 64 == 0, H*W % 128 == 0.
extern "C" int msig_convt4x4s2_kcat(const void* x, const void* wk, void* stats, void* out,
                                    void* out_scale, int B, int H, int W, int Cin, int Cout,
                                    float eps, int true_extremes, void* stream) {
  using namespace msig::wgmma;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return true_extremes
             ? convt4x4s2_i8<true>(x, wk, stats, out, out_scale, B, H, W, Cin, Cout, eps, false,
                                   st)
             : convt4x4s2_i8(x, wk, stats, out, out_scale, B, H, W, Cin, Cout, eps, false, st);
}
