// First encoder site: uint8 image recentred to int8 (x - 128) ->
// ReflectionPad2d(3) -> exact int8 7x7 conv 3 -> 64 -> IN -> ReLU -> per-sample
// requant to int8, dense NHWC [B, H, W, 3] uint8 -> [B, H, W, 64] int8.
//
// Replaces the TPU kernel msig_tpu/ops/fused_enc_int8.py::enc0_in_relu_requant
// (_kernel_enc0), which runs nine K = 48 taps on a space-to-depth-4 slab of
// the reflect-padded image (prep_s2d4_input) and writes 16 pixel phases x 64
// channels per row. Dense NHWC needs neither: the image is read as it is
// stored, recentred with x ^ 0x80 on the way into shared memory, and the halo
// is reflected by index.
//
// Bound on an H100 at the main path's shape [8, 256, 256, 3]: 2 * 33.6 M
// outputs * 147 = 9.9 G int8 operations (5.0 us at 1,979 TOP/s) against
// 35.1 MB that must move (1.6 in, 33.6 out; 10.5 us at 3.35 TB/s), so bytes
// bound it. This design adds the int32 round trip of the two-pass scheme
// (134 MB written and read back at B = 8).
//
// Pass A, here: a CTA takes a tile of 8 x 16 output pixels of one sample,
// stages its reflected 14 x 22 x 3 halo (924 bytes) and the [160, 64] weights
// in shared memory, and unrolls the halo into a [128 pixels, 160] im2col
// operand there: k = (u*7 + v)*3 + ci, so the 21 values of one kernel row are
// 21 consecutive halo bytes, and k = 147 .. 159 are zeros against zero weight
// rows. Five mma.sync m16n8k32 steps per warp then give the 128 x 64 tile,
// which goes to the int32 scratch while the statistics are reduced as at the
// other sites (conv_int8.cuh). Pass B is relu_requant_kernel with gamma = 1,
// beta = 0 and C = 64.
#include "conv_int8.cuh"

namespace msig {

constexpr int kE0Cout = 64;
constexpr int kE0Taps = 7, kE0Pad = 3, kE0Cin = 3;
constexpr int kE0K = kE0Taps * kE0Taps * kE0Cin;   // 147
constexpr int kE0Kpad = 160;                       // 5 mma steps of 32
constexpr int kE0Lds = kE0Kpad + 16;               // pitch 44 words: fragment loads hit 32 banks
constexpr int kE0TH = 8, kE0TW = 16;               // kBM = 128 output pixels per CTA
constexpr int kE0HaloH = kE0TH + 2 * kE0Pad;       // 14
constexpr int kE0HaloRow = (kE0TW + 2 * kE0Pad) * kE0Cin;  // 66 bytes per halo row
constexpr int kE0KRow = kE0Taps * kE0Cin;          // 21 k per kernel row
static_assert(kE0TH * kE0TW == kBM, "one CTA tile is kBM GEMM rows");

// grid = (W / 16, H / 8, B), block = kConvThreads. img: [B, H, W, 3] uint8;
// w: [160, 64] int8, row (u*7 + v)*3 + ci, rows 147 .. 159 zero; y:
// [B, H*W, 64] int32; stats as in conv_int8.cuh.
__global__ void __launch_bounds__(kConvThreads)
enc0_conv_stats_kernel(const uint8_t* __restrict__ img, const int8_t* __restrict__ w,
                       int32_t* __restrict__ y, long long* __restrict__ stats, int B, int H,
                       int W) {
  constexpr int NI = kE0Cout / 16;
  __shared__ __align__(16) int8_t As[kBM * kE0Lds];      // [pixel][k]
  __shared__ __align__(16) int8_t Bs[kE0Cout * kE0Lds];  // [co][k]
  __shared__ int8_t halo[kE0HaloH * kE0HaloRow];         // [row][col][ci], recentred

  const int b = blockIdx.z, oy0 = blockIdx.y * kE0TH, ox0 = blockIdx.x * kE0TW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;

  const uint8_t* ib = img + (size_t)b * H * W * kE0Cin;
  for (int i = tid; i < kE0HaloH * kE0HaloRow; i += kConvThreads) {
    const int hy = i / kE0HaloRow, r = i % kE0HaloRow;
    const int iy = reflect_index(oy0 - kE0Pad + hy, H);
    const int ix = reflect_index(ox0 - kE0Pad + r / kE0Cin, W);
    // x - 128 is x ^ 0x80 read as int8.
    halo[i] = (int8_t)(ib[((size_t)iy * W + ix) * kE0Cin + r % kE0Cin] ^ 0x80);
  }
  // Weights, transposed on the way in: Bs[co][k] = w[k][co].
  for (int i = tid; i < kE0Kpad * kE0Cout / 16; i += kConvThreads) {
    const int k = i % kE0Kpad, j = i / kE0Kpad;
    const int4 v = *reinterpret_cast<const int4*>(w + (size_t)k * kE0Cout + j * 16);
    const int8_t* vb = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int e = 0; e < 16; ++e) Bs[(j * 16 + e) * kE0Lds + k] = vb[e];
  }
  __syncthreads();
  // im2col, one 4-byte word of a pixel's K row per step.
  for (int i = tid; i < kBM * (kE0Kpad / 4); i += kConvThreads) {
    const int p = i / (kE0Kpad / 4), j = i % (kE0Kpad / 4);
    const int8_t* src = halo + (p / kE0TW) * kE0HaloRow + (p % kE0TW) * kE0Cin;
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * j + e;
      if (k < kE0K)
        word |= (uint32_t)(uint8_t)src[(k / kE0KRow) * kE0HaloRow + k % kE0KRow] << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(As + p * kE0Lds + 4 * j) = word;
  }
  __syncthreads();

  int acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
  mma_chunk<kE0Cout, kE0Kpad, kE0Lds>(As, Bs, acc, wm, wn, g, t4);

  // Tile row p is output pixel (oy0 + p / 16, ox0 + p % 16).
  int32_t* yb = y + (size_t)b * H * W * kE0Cout;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = wm * 32 + mi * 16 + g + h * 8;
      const size_t row = (size_t)(oy0 + p / kE0TW) * W + ox0 + p % kE0TW;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = wn * (kE0Cout / 2) + ni * 8 + t4 * 2;
        *reinterpret_cast<int2*>(yb + row * kE0Cout + col) =
            make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
  reduce_tile_stats<kE0Cout>(acc, stats + (size_t)b * kE0Cout, (size_t)B * kE0Cout, wn, g, t4);
}

}  // namespace msig

// Returns cudaGetLastError() after the launches (0 = success). Launches on
// `stream` and does not synchronise. y_scratch: [B, H*W, 64] int32; stats:
// int64 [4*B*64 + B], zero-initialised; out: [B, H, W, 64] int8. Needs
// H % 8 == 0 and W % 16 == 0 (the wrapper checks; the reflection's
// H, W >= 4 follows).
extern "C" int msig_enc0_in_relu_requant(const void* img, const void* w, void* y_scratch,
                                         void* stats, void* out, int B, int H, int W, float eps,
                                         void* stream) {
  using namespace msig;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int32_t* yp = static_cast<int32_t*>(y_scratch);
  long long* sp = static_cast<long long*>(stats);
  dim3 grid_a(W / kE0TW, H / kE0TH, B);
  enc0_conv_stats_kernel<<<grid_a, kConvThreads, 0, st>>>(
      static_cast<const uint8_t*>(img), static_cast<const int8_t*>(w), yp, sp, B, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_b(epilogue_blocks(H * W, kE0Cout), B);
  relu_requant_kernel<<<grid_b, kEpiThreads, 2 * kE0Cout * sizeof(float), st>>>(
      yp, sp, nullptr, nullptr, static_cast<int8_t*>(out), nullptr, B, H * W, kE0Cout, eps);
  return (int)cudaGetLastError();
}
