// Encoder downsampling site: int8 conv 4x4 / stride 2 / zero pad 1 -> IN ->
// ReLU -> per-sample requant to int8, dense NHWC [B, H, W, Cin] ->
// [B, H/2, W/2, Cout], plus the inverse scale amax/127 per sample.
//
// Replaces two TPU kernels: msig_tpu/ops/fused_enc_int8.py::enc1_in_relu_requant
// (_kernel_enc1, 64 -> 128, four output phases x nine grid taps on enc0's
// b-major slab) and ::enc2_in_relu_requant (_kernel_enc2, 128 -> 256, sixteen
// dense taps, which also returns the inverse scale the trunk's residual carry
// starts from). Both share the epilogue _epilogue_in_relu_requant: plain IN
// (gamma 1, beta 0), the relu sites' amax from the affine image of the
// zero-masked min and max. The phase packing, and the 2.25x K inflation it
// costs enc1, belong to the slab: on dense NHWC both are one GEMM with M =
// output pixels, N = Cout and K = 16*Cin (Conv4x4s2Geom in conv_int8.cuh),
// which is also the function of ::enc1_in_relu_requant_im2col.
//
// Bound on an H100 at the main path's shapes, B = 8: enc1 [8, 256, 256, 64] ->
// [8, 128, 128, 128] and enc2 [8, 128, 128, 128] -> [8, 64, 64, 256] are each
// 2 * outputs * 16 * Cin = 34.4 G int8 operations (17.4 us at 1,979 TOP/s)
// against 50 MB (enc1) or 26 MB (enc2) that must move (15 or 7.7 us at
// 3.35 TB/s), so operations bound both.
//
// The requant scale of a sample needs all its conv outputs, and the epilogue
// needs nothing of an output but to map it: so, as the decoder's ConvT site
// (convt4x4s2_in_relu_requant.cu), the conv runs twice on the wgmma main loop
// of conv_i8_wgmma.cuh, with K-major weights [Cout, 16*Cin]
// (fused_enc_int8.py::pack_conv4x4_kmajor, made once at quantization), and
// the int32 accumulator (67 MB at enc1, 34 MB at enc2, B = 8, each way) never
// reaches device memory. Three launches: a memset of the statistics block;
// pass S (conv4x4s2_i8_wgmma_stats_kernel), the conv and the exact statistics,
// storing nothing else; pass Q (conv4x4s2_i8_wgmma_requant_kernel), the conv
// again, each CTA first rebuilding its sample's affine, amax and scale from
// the finished block (gamma = 1, beta = 0), then mapping its accumulator
// registers to int8 as relu_requant_kernel does (the shared helpers of
// conv_int8.cuh), writing the int8 map and the inverse scale. The grid is
// the output map; each row's input pixel is (2*oy + dy, 2*ox + dx) with dy,
// dx in -1 .. 2, and only row and column -1 (at oy, ox = 0) and 2 (at the last
// output row or column) can fall outside the map. At Cin = 64 (enc1) a
// 128-byte K block holds two taps, at Cin = 128 (enc2) one. The channel tile
// is the whole Cout at both sites: BN = 256 at enc2 (the trunk's setting),
// 128 at enc1, one 128-byte K block a stage. Each CTA takes a contiguous
// run of tiles, so the statistics leave and the requant is rebuilt once per
// sample it meets. Twice the conv caps the design at half of the one-pass
// ops bound.
//
// A second entry, msig_enc1_phases_in_relu_requant, replaces
// ::enc1_in_relu_requant_im2col (_kernel_enc1_im2col), which gathers the 16
// 64-lane slices of each output phase into a [chunk, 1024] VMEM scratch and
// runs one dense K = 1024 product per phase against its own weight block
// (pack_enc1_im2col: [4 * 1024, 128], block q = 2*qy + qx holding w[u, v] in
// u*4 + v order). It is the same two passes on the same main loop over the
// geometry Enc1PhaseGeom (conv_int8.cuh): the grid is a quarter of the output
// map, (H/4) x (W/4), and a tile of phase q reads input rows 4gy - 1 ..
// 4gy + 4 and its own K-major block q of [4, Cout, 1024]
// (fused_enc_int8.py::pack_enc1_im2col_kmajor, made once at quantization),
// so the four blocks may differ; with four equal blocks the output equals
// enc1_in_relu_requant's bit for bit. A CTA's run of tiles takes a pixel
// block's four phases in turn, which read the same input rows. Two K blocks a
// stage (as the ConvT's phases) and a channel tile of 128: pass Q's ring at
// BN = 256 would hold one stage. Three launches, as enc1's: the memset, pass S
// (enc1_phase_i8_wgmma_stats_kernel), pass Q
// (enc1_phase_i8_wgmma_requant_kernel). Bound at [8, 256, 256, 64] ->
// [8, 128, 128, 128]: enc1's, 17.4 us of operations (34.8 us for the two
// passes).
#include "conv_i8_wgmma.cuh"

// Returns a CUDA error code (0 = success) after the launches. Launches on
// `stream` and does not synchronise. wk: [Cout, 16*Cin] int8 from
// pack_conv4x4_kmajor (the transpose of pack_conv4x4's [16*Cin, Cout], column
// (4u + v)*Cin + ci); stats: int64 [5*B*Cout + B], zeroed here; out:
// [B, H/2, W/2, Cout] int8; out_scale: [B] float32. Needs H and W even,
// Cin % 64 == 0, Cout % 64 == 0, (H/2)*(W/2) % 128 == 0.
extern "C" int msig_conv4x4s2_in_relu_requant(const void* x, const void* wk, void* stats,
                                              void* out, void* out_scale, int B, int H, int W,
                                              int Cin, int Cout, float eps, void* stream) {
  return msig::wgmma::conv4x4s2_i8(x, wk, stats, out, out_scale, B, H, W, Cin, Cout, eps,
                                   reinterpret_cast<cudaStream_t>(stream));
}

// The two passes' configuration, for reports: out[0] = tile pixels, then for
// pass S and pass Q at BN = 256, 128 and 64 (in that order) the bytes of K a
// stage, the stages of the ring and the dynamic shared memory of a CTA.
// Returns 0.
extern "C" int msig_conv4x4s2_i8_wgmma_config(int* out) {
  using namespace msig::wgmma;
  using G = msig::Conv4x4s2Geom;
  int n = 0;
  out[n++] = kBM;
  const int v[] = {LayoutOf<G, 256, Epi::kStats>::kKBytes, LayoutOf<G, 256, Epi::kStats>::kStages,
                   LayoutOf<G, 256, Epi::kStats>::kBytes, LayoutOf<G, 256, Epi::kRequant>::kKBytes,
                   LayoutOf<G, 256, Epi::kRequant>::kStages,
                   LayoutOf<G, 256, Epi::kRequant>::kBytes,
                   LayoutOf<G, 128, Epi::kStats>::kKBytes, LayoutOf<G, 128, Epi::kStats>::kStages,
                   LayoutOf<G, 128, Epi::kStats>::kBytes, LayoutOf<G, 128, Epi::kRequant>::kKBytes,
                   LayoutOf<G, 128, Epi::kRequant>::kStages,
                   LayoutOf<G, 128, Epi::kRequant>::kBytes,
                   LayoutOf<G, 64, Epi::kStats>::kKBytes, LayoutOf<G, 64, Epi::kStats>::kStages,
                   LayoutOf<G, 64, Epi::kStats>::kBytes, LayoutOf<G, 64, Epi::kRequant>::kKBytes,
                   LayoutOf<G, 64, Epi::kRequant>::kStages, LayoutOf<G, 64, Epi::kRequant>::kBytes};
  for (int x : v) out[n++] = x;
  return 0;
}

// enc1 as the dense K = 1024 product per output phase, a weight block each.
// Returns a CUDA error code (0 = success) after the launches. Launches on
// `stream` and does not synchronise. x: [B, H, W, Cin] int8; wk: [4, Cout,
// 16*Cin] int8 from pack_enc1_im2col_kmajor (block q the transpose of rows
// q*16*Cin .. of pack_enc1_im2col's [4 * 16*Cin, Cout]); stats: int64
// [5*B*Cout + B], zeroed here; out: [B, H/2, W/2, Cout] int8; out_scale: [B]
// float32. Needs H and W multiples of 4, Cin % 64 == 0, Cout % 128 == 0,
// (H/4)*(W/4) % 128 == 0.
extern "C" int msig_enc1_phases_in_relu_requant(const void* x, const void* wk, void* stats,
                                                void* out, void* out_scale, int B, int H, int W,
                                                int Cin, int Cout, float eps, void* stream) {
  return msig::wgmma::enc1_phases_i8(x, wk, stats, out, out_scale, B, H, W, Cin, Cout, eps,
                                     reinterpret_cast<cudaStream_t>(stream));
}
