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
// 35.2 MB that must move (10.5 us at 3.35 TB/s), so bytes bound it. A direct
// conv on __dp4a needs 1.23 G integer instructions for those operations,
// which the SMs' integer issue rate cannot retire near that bound; only the
// tensor cores can. Their obstacle is Cout = 3: the narrowest mma tile has 8
// columns, so a tile of (pixels x Cout) products is 5/8 padding.
//
// Design: mma.sync.m16n8k32 s8 with kx folded into N. A GEMM row is one of 16
// input pixels of a halo row; N is 24 columns (co, kx) = co * 7 + kx, 21 used
// (three n8 tiles); K is (ky, channel), 7 x 64. The products are partial maps
// P[row][input column][co * 7 + kx], exact in int32, and an output adds its
// seven: y[row][x][co] = sum over kx of P[row][x + kx][co * 7 + kx] (halo
// columns). That is 16.9 G operations of tensor work at 256², against 26.3 G
// for Cout padded to 8 at each tap. A CTA takes an output tile of 32 columns
// x 16 rows: it copies the tile's reflected halo (22 x 38 pixels, 80 bytes a
// pixel so that ldmatrix's eight 16-byte rows fall on distinct banks) with
// 16-byte cp.async, and the weights (packed at quantization by
// fd.pack_final7_weights, [ky][half][n8 tile][8 columns][32 channels])
// rearranged so that each lane reads its B fragment with one 8-byte load.
// Each of 12 warps owns 16 input columns (halo columns 0, 16 or 22) x 4
// output rows: for each (ky, channel half) three B fragments, then for each
// row one ldmatrix.x4 and three products. The partials then take the halo's
// place in shared memory (25 words a pixel: the epilogue's reads, 25 words
// apart, hit 32 banks) and the CTA's threads form its 1,536 outputs. 77.6 KB
// of shared memory and 384 threads: two CTAs an SM, so that one CTA's copies
// and sums run under the other's products. PERF.md names the designs this
// one was chosen over, with their times: Cout padded to 8 at each tap, a
// persistent CTA that double-buffers the halo (one an SM), and a sweep that
// loads each A fragment once for several ky.
//
// The epilogue repeats the TPU kernel's fp32 order (:593, :605-606): the
// product wscale * inv_s first, then y * it + bias with y converted by
// rounding to nearest (|y| reaches 127^2 * 3,136 ~ 5.1e7, above 2^24, as
// astype(float32) does), tanhf, and rintf, which rounds half to even like
// torch.round and jnp.round. The int32 sums are exact in any order, so the
// output equals the plain version's to the bit.
#include "conv_int8.cuh"

namespace msig {
namespace final7 {

constexpr int kCin = 64, kCout = 3, kK = 7, kPad = 3;
constexpr int kTW = 32, kTH = 16;                             // output tile: 32 columns x 16 rows
constexpr int kHaloW = kTW + 2 * kPad, kHaloH = kTH + 2 * kPad;  // 38 x 22
constexpr int kPitch = kCin + 16;                             // bytes a staged pixel: 80
constexpr int kXBytes = kHaloH * kHaloW * kPitch;             // 66,880
constexpr int kNTiles = 3, kCols = kCout * kK;                // n8 tiles; columns used, 21
constexpr int kColTiles = 3;                                  // 16-column A tiles over 38
constexpr int kWarpRows = 4;                                  // output rows a warp
constexpr int kWarps = kColTiles * (kTH / kWarpRows);         // 12
constexpr int kThreads = 32 * kWarps;
constexpr int kWBlocks = kK * 2 * kNTiles;                    // (ky, half, n8 tile)
constexpr int kWBytes = kWBlocks * 8 * 32;                    // 10,752: fd.pack_final7_weights
constexpr int kPPitch = 25;                                   // int32 words a partial pixel
constexpr int kSmemBytes = kXBytes + kWBytes;                 // 77,632: two CTAs an SM
static_assert(kTH * kHaloW * kPPitch * 4 <= kXBytes, "the partials fit the halo's space");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// d += a * b on the tensor cores (a pure register operation: not volatile, so
// the compiler may interleave it with the fragment loads).
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint8_t to_u8(int acc, float sv, float bv) {
  const float t = tanhf(__fadd_rn(__fmul_rn(__int2float_rn(acc), sv), bv));
  const float u = rintf(__fmul_rn(__fadd_rn(t, 1.f), 127.5f));
  return (uint8_t)fminf(fmaxf(u, 0.f), 255.f);
}

// Output tile t of a [B, H, W] map walked row-major: (b, ty, tx).
struct Tile {
  int b, oy0, ox0;
  __device__ Tile(int t, int H, int W) {
    const int tw = W / kTW, th = H / kTH;
    ox0 = (t % tw) * kTW;
    oy0 = (t / tw % th) * kTH;
    b = t / (tw * th);
  }
};

// Issues the 16-byte copies of a tile's reflected halo into xs (pixel p =
// halo row * 38 + halo column at byte p * 80), as one group.
__device__ __forceinline__ void copy_halo(uint32_t xs, const int8_t* __restrict__ x,
                                          const Tile& tl, int H, int W) {
  const int8_t* xb = x + (size_t)tl.b * H * W * kCin;
  for (int i = threadIdx.x; i < kHaloH * kHaloW * 4; i += kThreads) {
    const int quarter = i & 3, p = i >> 2;
    const int iy = reflect_index(tl.oy0 - kPad + p / kHaloW, H);
    const int ix = reflect_index(tl.ox0 - kPad + p % kHaloW, W);
    cp_async16(xs + p * kPitch + quarter * 16, xb + ((size_t)iy * W + ix) * kCin + quarter * 16);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// grid = B * (H / 16) * (W / 32), block = kThreads, dynamic smem kSmemBytes.
// x: [B, H, W, 64] int8; wpk: [7 ky][2 half][3 n8 tiles][8 columns][32 ch]
// int8, column n = co * 7 + kx (n >= 21 zero); wscale, bias: [3] float32;
// inv_s: [B] float32; out: [B, H, W, 3] uint8.
__global__ void __launch_bounds__(kThreads, 2)
final7_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wpk,
                  const float* __restrict__ wscale, const float* __restrict__ bias,
                  const float* __restrict__ inv_s, uint8_t* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* part = reinterpret_cast<int*>(smem);  // after the products: [kTH][kHaloW][kPPitch]
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem + kXBytes);
  const uint32_t xs = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x;
  const Tile tl(blockIdx.x, H, W);

  copy_halo(xs, x, tl, H, W);
  // The weights in lane order: block blk holds, at words 2*lane and
  // 2*lane+1, the B fragment of lane (g, t) = (lane / 4, lane % 4): channels
  // 4t..4t+3 and 16+4t..16+4t+3 of column g. 16-byte chunk i of the packed
  // copy is (blk, column n, half-chunk q) = (i / 16, (i / 2) % 8, i % 2); its
  // word t goes to lane (n, t)'s word q.
  for (int i = tid; i < kWBlocks * 16; i += kThreads) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(wpk) + i);
    uint32_t* d = ws + (i >> 4) * 64 + ((i >> 1) & 7) * 8 + (i & 1);
    d[0] = (uint32_t)v.x;
    d[2] = (uint32_t)v.y;
    d[4] = (uint32_t)v.z;
    d[6] = (uint32_t)v.w;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int ctile = warp % kColTiles, r0 = (warp / kColTiles) * kWarpRows;
  const int ct = ctile == kColTiles - 1 ? kHaloW - 16 : ctile * 16;  // 0, 16, 22
  // ldmatrix.x4: lanes 0-15 give pixels 0-15 at channel bytes 0-15 of the
  // half, lanes 16-31 the same pixels at bytes 16-31; fragment registers
  // (rows g | g+8) x (k 4t | 16+4t), as mma's A.
  const uint32_t a_base = xs + (r0 * kHaloW + ct + (lane & 15)) * kPitch + 16 * (lane >> 4);
  const uint32_t* wl = ws + 2 * lane;
  int acc[kWarpRows][kNTiles][4];
#pragma unroll
  for (int p = 0; p < kWarpRows; ++p)
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[p][n][r] = 0;
#pragma unroll 1
  for (int ky = 0; ky < kK; ++ky) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t bf[kNTiles][2];
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        const uint2 v = *reinterpret_cast<const uint2*>(wl + ((ky * 2 + half) * kNTiles + n) * 64);
        bf[n][0] = v.x;
        bf[n][1] = v.y;
      }
#pragma unroll
      for (int p = 0; p < kWarpRows; ++p) {
        uint32_t a[4];
        ldmatrix_x4(a, a_base + (p + ky) * kHaloW * kPitch + 32 * half);
#pragma unroll
        for (int n = 0; n < kNTiles; ++n) mma(acc[p][n], a, bf[n]);
      }
    }
  }
  __syncthreads();  // every warp is done with the halo: the partials take its place

  // Partials of rows g and g+8 (halo columns ct+g, ct+g+8), columns 2t and
  // 2t+1 of each n8 tile; the last A tile only for halo columns 32-37,
  // which the others do not cover.
#pragma unroll
  for (int p = 0; p < kWarpRows; ++p)
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = g + 8 * (r >> 1), col = n * 8 + 2 * t + (r & 1);
        if (col < kCols && (ctile < kColTiles - 1 || ct + i >= 32))
          part[((r0 + p) * kHaloW + ct + i) * kPPitch + col] = acc[p][n][r];
      }
  __syncthreads();

  const float is = inv_s[tl.b];
  uint8_t* ob = out + (((size_t)tl.b * H + tl.oy0) * W + tl.ox0) * kCout;
  for (int idx = tid; idx < kTH * kTW * kCout; idx += kThreads) {
    const int co = idx % kCout, X = idx / kCout % kTW, row = idx / (kCout * kTW);
    const int* pp = part + (row * kHaloW + X) * kPPitch + co * kK;
    int s = 0;
#pragma unroll
    for (int kx = 0; kx < kK; ++kx) s += pp[kx * kPPitch + kx];
    ob[(size_t)row * W * kCout + X * kCout + co] = to_u8(s, __fmul_rn(wscale[co], is), bias[co]);
  }
}

}  // namespace final7
}  // namespace msig

// Returns the first CUDA error of the launch (0 = success). Launches on
// `stream` and does not synchronise. Needs H % 16 == 0, W % 32 == 0 (the
// wrapper checks; H, W >= 4 follows, as the reflection needs). wpk: the
// packed weights of fd.pack_final7_weights.
extern "C" int msig_final7_tanh_u8(const void* x, const void* wpk, const void* wscale,
                                   const void* bias, const void* inv_s, void* out, int B, int H,
                                   int W, void* stream) {
  using namespace msig::final7;
  // a kernel attribute holds for one device: set it once on each
  constexpr int kMaxDevices = 64;
  static bool smem_set[kMaxDevices] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(final7_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  final7_mma_kernel<<<B * (H / kTH) * (W / kTW), kThreads, kSmemBytes,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wpk),
      static_cast<const float*>(wscale), static_cast<const float*>(bias),
      static_cast<const float*>(inv_s), static_cast<uint8_t*>(out), H, W);
  return (int)cudaGetLastError();
}
