// Decoder tail: ReflectionPad2d(3) -> exact int8 7x7 conv 64 -> 3 -> dequant
// (weight scale x the activation's inverse scale) -> + bias -> tanh -> uint8
// serving image, dense NHWC [B, H, W, 64] int8 -> [B, H, W, 3] uint8.
//
// Replaces the TPU kernel msig_tpu/ops/fused_dec_int8.py::final7_tanh_u8
// (_kernel_final7), which runs nine tap matmuls on up1's s2d-16 slab whose
// guard cells up1 filled with reflected values. Here the halo is read by
// index (reflect_index in conv_int8.cuh): i < 0 -> -i, i >= H -> 2H - 2 - i.
//
// Bound on an H100 at the main path's shape [8, 256, 256, 64]: 2 * 1.57 M
// outputs * 3,136 = 9.9 G int8 operations (5.0 us at 1,979 TOP/s) against
// 35.2 MB that must move (10.5 us at 3.35 TB/s), so bytes bound it. With
// N = 3 output channels the work fits an mma tile badly (a 16x8x32 tile
// would be 5/8 padding), so this first design is a direct conv with __dp4a
// over groups of 4 input channels: a CTA stages a reflected halo tile of
// 22 x 38 pixels in shared memory (pitch 17 words per pixel, so the 32 lanes
// of a warp, on 32 neighbouring pixels, hit 32 banks) and the 49 x 16 x 3
// weight words, and each thread computes 4 pixels of one column, reusing
// every loaded input word across 7 kernel rows. dp4a runs at the integer
// rate, well below the tensor cores; a later pass can move the 3,136-deep
// reduction onto mma with the channels padded to 8.
//
// The epilogue repeats the TPU kernel's fp32 order (:593, :605-606): the
// product wscale * inv_s first, then y * it + bias with y converted by
// rounding to nearest (|y| reaches 127^2 * 3,136 ~ 5.1e7, above 2^24, as
// astype(float32) does), tanhf, and rintf, which rounds half to even like
// torch.round and jnp.round.
#include "conv_int8.cuh"

namespace msig {

constexpr int kCin = 64, kCout = 3, kK = 7, kPad = 3;
constexpr int kWords = kCin / 4;                // int32 words of 4 channels per pixel
constexpr int kPitch = kWords + 1;              // shared-memory words per pixel
constexpr int kTW = 32, kTH = 16, kRows = 4;    // tile: 32 columns (one per lane) x 16 rows
constexpr int kThreads = 32 * kTH / kRows;      // 4 warps, each 4 rows of the tile
constexpr int kHaloW = kTW + 2 * kPad, kHaloH = kTH + 2 * kPad;
constexpr int kXWords = kHaloH * kHaloW * kPitch;
constexpr int kWWords = kK * kK * kWords * kCout;
constexpr size_t kSmemBytes = (size_t)(kXWords + kWWords) * sizeof(int);

// grid = (W / kTW, H / kTH, B), block = kThreads, dynamic smem kSmemBytes.
// x: [B, H, W, 64] int8; w: [3, 64, 7, 7] int8 (OIHW); wscale, bias: [3]
// float32; inv_s: [B] float32; out: [B, H, W, 3] uint8.
__global__ void __launch_bounds__(kThreads)
final7_tanh_u8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ wscale, const float* __restrict__ bias,
                      const float* __restrict__ inv_s, uint8_t* __restrict__ out, int H, int W) {
  extern __shared__ int smem[];
  int* xs = smem;             // [kHaloH * kHaloW][kPitch]
  int* ws = smem + kXWords;   // [ky*7 + kx][c4][co]: channels 4*c4 .. 4*c4+3, little-endian
  const int b = blockIdx.z, oy0 = blockIdx.y * kTH, ox0 = blockIdx.x * kTW;

  for (int i = threadIdx.x; i < kWWords; i += kThreads) {
    const int co = i % kCout, c4 = (i / kCout) % kWords, tap = i / (kCout * kWords);
    uint32_t v = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v |= (uint32_t)(uint8_t)w[(co * kCin + 4 * c4 + e) * kK * kK + tap] << (8 * e);
    ws[i] = (int)v;
  }
  const int8_t* xb = x + (size_t)b * H * W * kCin;
  for (int i = threadIdx.x; i < kHaloH * kHaloW * 4; i += kThreads) {
    const int quarter = i & 3, p = i >> 2;
    const int iy = reflect_index(oy0 - kPad + p / kHaloW, H);
    const int ix = reflect_index(ox0 - kPad + p % kHaloW, W);
    const int4 v = *reinterpret_cast<const int4*>(xb + ((size_t)iy * W + ix) * kCin + quarter * 16);
    int* d = xs + p * kPitch + quarter * 4;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * kRows;
  int acc[kRows][kCout];
#pragma unroll
  for (int p = 0; p < kRows; ++p)
#pragma unroll
    for (int co = 0; co < kCout; ++co) acc[p][co] = 0;

  for (int kx = 0; kx < kK; ++kx) {
#pragma unroll 2
    for (int c4 = 0; c4 < kWords; ++c4) {
      // The thread's input column at kernel column kx: halo rows r0 .. r0+kRows+5.
      int col[kRows + kK - 1];
#pragma unroll
      for (int j = 0; j < kRows + kK - 1; ++j)
        col[j] = xs[((r0 + j) * kHaloW + lane + kx) * kPitch + c4];
#pragma unroll
      for (int ky = 0; ky < kK; ++ky) {
        const int* wk = ws + ((ky * kK + kx) * kWords + c4) * kCout;
        const int w0 = wk[0], w1 = wk[1], w2 = wk[2];
#pragma unroll
        for (int p = 0; p < kRows; ++p) {
          acc[p][0] = __dp4a(col[p + ky], w0, acc[p][0]);
          acc[p][1] = __dp4a(col[p + ky], w1, acc[p][1]);
          acc[p][2] = __dp4a(col[p + ky], w2, acc[p][2]);
        }
      }
    }
  }

  const float is = inv_s[b];
  float sv[kCout], bv[kCout];
#pragma unroll
  for (int co = 0; co < kCout; ++co) {
    sv[co] = __fmul_rn(wscale[co], is);
    bv[co] = bias[co];
  }
  const int ox = ox0 + lane;
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    uint8_t* o = out + (((size_t)b * H + oy0 + r0 + p) * W + ox) * kCout;
#pragma unroll
    for (int co = 0; co < kCout; ++co) {
      const float t = tanhf(__fadd_rn(__fmul_rn(__int2float_rn(acc[p][co]), sv[co]), bv[co]));
      const float u = rintf(__fmul_rn(__fadd_rn(t, 1.f), 127.5f));
      o[co] = (uint8_t)fminf(fmaxf(u, 0.f), 255.f);
    }
  }
}

}  // namespace msig

// Returns the first CUDA error of the launch (0 = success). Launches on
// `stream` and does not synchronise. Needs H % 16 == 0, W % 32 == 0 (the
// wrapper checks; H, W >= 4 follows, as the reflection needs).
extern "C" int msig_final7_tanh_u8(const void* x, const void* w, const void* wscale,
                                   const void* bias, const void* inv_s, void* out, int B, int H,
                                   int W, void* stream) {
  using namespace msig;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(final7_tanh_u8_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid(W / kTW, H / kTH, B);
  final7_tanh_u8_kernel<<<grid, kThreads, kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(wscale), static_cast<const float*>(bias),
      static_cast<const float*>(inv_s), static_cast<uint8_t*>(out), H, W);
  return (int)cudaGetLastError();
}
