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
// A second entry, msig_enc1_im2col_in_relu_requant, replaces
// ::enc1_in_relu_requant_im2col (_kernel_enc1_im2col), which gathers the 16
// 64-lane slices of each output phase into a [chunk, 1024] VMEM scratch and
// runs one dense K = 1024 product per phase against its own weight block
// (pack_enc1_im2col: [4 * 1024, 128], block q = 2*ay + ax holding w[u, v] in
// u*4 + v order). Here a CTA takes 128 output pixels of one phase q (the
// pixels (2I + qy, 2J + qx)), gathers their [128 x 1024] im2col tile of the
// input into dynamic shared memory once (133 KB, above the 48 KB default:
// cudaFuncSetAttribute), then runs the K = 1024 product from it against
// phase q's block, staged 64 rows of K at a time. Its epilogue is enc1's:
// with four equal blocks the output equals enc1_in_relu_requant's bit for
// bit. Bound at [8, 256, 256, 64] -> [8, 128, 128, 128]: enc1's, 17.4 us of
// operations; one CTA per SM (the tile's shared memory) and no overlap of the
// gather with the product are this design's costs.
#include "conv_i8_wgmma.cuh"
#include "conv_int8.cuh"

namespace msig {

// Output phase q = 2*qy + qx of a 4x4 / stride 2 / pad 1 conv as a grid of
// (H/4) x (W/4) pixels: grid pixel (gy, gx) is output pixel (2gy + qy,
// 2gx + qx), and tap t = 4u + v reads input (4gy + 2qy + u - 1,
// 4gx + 2qx + v - 1) against weight block q*16 + t.
struct Enc1PhaseGeom {
  static constexpr int kPhases = 4;
  static constexpr int kTaps = 16;
  static constexpr int kStride = 4;
  __device__ static void tap(int q, int t, int& dy, int& dx, int& blk) {
    dy = 2 * (q >> 1) + (t >> 2) - 1;
    dx = 2 * (q & 1) + (t & 3) - 1;
    blk = q * kTaps + t;
  }
  __device__ static int out_pixel(int q, int gy, int gx, int GW) {
    return (2 * gy + (q >> 1)) * (2 * GW) + 2 * gx + (q & 1);
  }
};

constexpr int kI2cCin = 64;                               // enc1's input channels
constexpr int kI2cK = Enc1PhaseGeom::kTaps * kI2cCin;     // 1024
constexpr int kI2cLda = kI2cK + 16;                       // row pitch: 4 words mod 32 banks
constexpr size_t kI2cSmem = (size_t)kBM * kI2cLda;        // 133,120 bytes

// grid = (B * 4 * (GHW / kBM), Cout / 128) with GHW = (H/4) * (W/4), block =
// kConvThreads, dynamic smem kI2cSmem. x: [B, H, W, 64] int8; w: [4 * 1024,
// Cout]; y: [B, (H/2) * (W/2), Cout] int32 in output-pixel order.
__global__ void __launch_bounds__(kConvThreads)
enc1_im2col_stats_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                         int32_t* __restrict__ y, long long* __restrict__ stats, int B, int H,
                         int W, int Cout) {
  constexpr int BN = 128, NI = BN / 16;
  extern __shared__ __align__(16) int8_t As[];       // [pixel][k], pitch kI2cLda
  __shared__ __align__(16) int8_t Bs[BN * kLds];      // [co][k] of one 64-row K chunk
  const int GW = W / 4, GHW = (H / 4) * GW, tiles = GHW / kBM;
  const int m0 = (blockIdx.x % tiles) * kBM;
  const int q = (blockIdx.x / tiles) % 4;
  const int b = blockIdx.x / (tiles * 4);
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;

  // The im2col tile: row p, bytes t*64 .. t*64+63 = input pixel of tap t, 16 B per load.
  const int8_t* xb = x + (size_t)b * H * W * kI2cCin;
  for (int i = tid; i < kBM * kI2cK / 16; i += kConvThreads) {
    const int p = i / (kI2cK / 16), j = i % (kI2cK / 16);
    const int t = j / (kI2cCin / 16), cj = j % (kI2cCin / 16);
    int dy, dx, blk;
    Enc1PhaseGeom::tap(q, t, dy, dx, blk);
    const int m = m0 + p;
    const int yy = (m / GW) * 4 + dy, xx = (m % GW) * 4 + dx;
    int4 v = make_int4(0, 0, 0, 0);
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = *reinterpret_cast<const int4*>(xb + (size_t)(yy * W + xx) * kI2cCin + cj * 16);
    *reinterpret_cast<int4*>(As + p * kI2cLda + j * 16) = v;
  }

  int acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const int8_t* wq = w + (size_t)q * kI2cK * Cout;
  for (int k0 = 0; k0 < kI2cK; k0 += kBK) {
    // Bs[co][k] = w[q*1024 + k0 + k][n0 + co]; the first pass also waits for the gather.
    for (int i = tid; i < kBK * BN / 16; i += kConvThreads) {
      const int k = i % kBK, j = i / kBK;
      const int4 v = *reinterpret_cast<const int4*>(wq + (size_t)(k0 + k) * Cout + n0 + j * 16);
      const int8_t* vb = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int e = 0; e < 16; ++e) Bs[(j * 16 + e) * kLds + k] = vb[e];
    }
    __syncthreads();
    mma_chunk<BN, kBK, kI2cLda, kLds>(As + k0, Bs, acc, wm, wn, g, t4);
    __syncthreads();
  }
  store_tile<Enc1PhaseGeom, BN, int32_t, false>(acc, y, stats, B, b, q, m0, n0, GW, GHW, Cout);
}

}  // namespace msig

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

// enc1 as the dense K = 1024 product per output phase. Returns
// cudaGetLastError() after the launches (0 = success); launches on `stream`
// and does not synchronise. x: [B, H, W, 64] int8; w: [4 * 1024, Cout] int8,
// block q = 2*qy + qx, row t*64 + ci of a block for tap t = 4u + v;
// y_scratch: [B, H/2 * W/2, Cout] int32; stats: int64 [5*B*Cout + B],
// zero-initialised; out: [B, H/2, W/2, Cout] int8; out_scale: [B] float32.
// Needs H and W multiples of 4, Cout % 128 == 0, (H/4)*(W/4) % 128 == 0.
extern "C" int msig_enc1_im2col_in_relu_requant(const void* x, const void* w, void* y_scratch,
                                                void* stats, void* out, void* out_scale, int B,
                                                int H, int W, int Cout, float eps, void* stream) {
  using namespace msig;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(enc1_im2col_stats_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kI2cSmem);
  if (err != cudaSuccess) return (int)err;
  const int GHW = (H / 4) * (W / 4), HWo = (H / 2) * (W / 2);
  int32_t* yp = static_cast<int32_t*>(y_scratch);
  long long* sp = static_cast<long long*>(stats);
  dim3 grid_a(B * 4 * (GHW / kBM), Cout / 128);
  enc1_im2col_stats_kernel<<<grid_a, kConvThreads, kI2cSmem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), yp, sp, B, H, W, Cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_b(epilogue_blocks(HWo, Cout), B);
  relu_requant_kernel<int32_t><<<grid_b, kEpiThreads, 2 * Cout * sizeof(float), st>>>(
      yp, sp, nullptr, nullptr, static_cast<int8_t*>(out), static_cast<float*>(out_scale), B,
      HWo, Cout, eps);
  return (int)cudaGetLastError();
}
