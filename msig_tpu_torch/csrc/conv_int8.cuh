// Shared pieces of the int8 conv sites that end in an instance norm (sm_90a):
// the resblock 3x3 sites, the decoder's 4x4/s2 ConvT sites and the encoder's
// 4x4/s2 conv sites (and, for all but its own staging, the encoder's 7x7 site).
//
// Every such site starts with the same pass: an int8 convolution over a dense
// NHWC map, written as an implicit GEMM and accumulated exactly in int32 with
// mma.sync m16n8k32, whose output goes to an int32 scratch in device memory
// while exact per-(sample, channel) statistics are reduced across CTAs with
// int64 atomics. A site's geometry (which input pixel and which weight block
// each tap reads, and where an output row lands) is a small struct; the tile
// loop is shared.
//
// Why two passes: the TPU kernels (msig_tpu/ops/fused_conv_int8_v2.py,
// fused_dec_int8.py) run one whole sample per program and keep its int32
// accumulator (4 to 16 MB) in VMEM, because the per-sample requant scale
// needs every conv output of the sample before any int8 is written. One SM
// holds 227 KB of shared memory, so here the accumulator round-trips through
// device memory (8 B per element: 4 written, 4 read back) and the epilogue
// runs as a second kernel.
//
// Statistics block (int64, zero-initialised by the caller), for B samples and
// C output channels:
//   [0*B*C + b*C + c]  sum of y          (exact)
//   [1*B*C + b*C + c]  sum of y*y, low words: each warp's partial sum & (2^32 - 1)
//   [2*B*C + b*C + c]  min(0, min y)     (the zero-masked min of the TPU kernel)
//   [3*B*C + b*C + c]  max(0, max y)     (the zero-masked max)
//   [4*B*C + b*C + c]  sum of y*y, high words: each warp's partial sum >> 32
//   [5*B*C + b]        max |hn| of the residual sites, as the bits of a float
// The sum of squares is hi * 2^32 + lo, exact while max|y| < 2^29 and the sum
// stays below 2^94 (the wrappers check): a [B, 256, 256, 256] trunk map can
// reach 2^66, past one int64. Integer sums make the statistics independent
// of the order of the CTAs.
//
// In the true-extremes mode (kTrueExtremes, the single-kernel trunk
// msig_tpu/ops/fused_trunk_v3.py:99-118 and the chunked epilogue
// int8_epilogue_chunked.py:64-69) blocks 2 and 3 hold the true min y and
// max y instead; the caller initialises them to INT64_MAX and INT64_MIN.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace msig {

constexpr int kBM = 128;          // GEMM rows (pixels of the site's grid) per CTA, consecutive in one sample
constexpr int kBK = 64;           // input channels staged per (tap, chunk)
constexpr int kLds = kBK + 16;    // smem row pitch in bytes (20 words: fragment loads hit 32 banks)
constexpr int kConvThreads = 256; // 8 warps: 4 along M (32 rows each) x 2 along N (BN/2 cols each)
constexpr int kEpiThreads = 256;
constexpr int kStatBlocks = 5;    // per-(sample, channel) blocks of the statistics block

// The scratch that carries pass A's accumulator to the epilogue is int32, or
// __half holding y * 2^-12 (msig_tpu/ops/fused_dec_int8.py: STAGE_SCALE):
// half the round trip, |y| * 2^-12 < 65504 for every site here, and the
// statistics are taken from the exact int32 values before the narrowing. The
// epilogue folds 2^12 into its multiplier.
constexpr float kStageScale = 1.f / 4096.f;

template <class Stage> struct StageOf;
template <> struct StageOf<int32_t> {
  static constexpr float kUnscale = 1.f;
  __device__ static void store2(int32_t* p, int v0, int v1) {
    *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
  }
  __device__ static void load4(const int32_t* p, float (&f)[4]) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    f[0] = (float)v.x, f[1] = (float)v.y, f[2] = (float)v.z, f[3] = (float)v.w;
  }
};
template <> struct StageOf<__half> {
  static constexpr float kUnscale = 4096.f;
  __device__ static void store2(__half* p, int v0, int v1) {
    *reinterpret_cast<__half2*>(p) =
        __halves2half2(__float2half_rn(__fmul_rn((float)v0, kStageScale)),
                       __float2half_rn(__fmul_rn((float)v1, kStageScale)));
  }
  __device__ static void load4(const __half* p, float (&f)[4]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const __half2 lo = *reinterpret_cast<const __half2*>(&v.x);
    const __half2 hi = *reinterpret_cast<const __half2*>(&v.y);
    f[0] = __low2float(lo), f[1] = __high2float(lo), f[2] = __low2float(hi), f[3] = __high2float(hi);
  }
};

// A geometry says how the GEMM of pass A maps onto a conv. GEMM rows are the
// pixels (gy, gx) of a grid of H/kStride x W/kStride; tap t of phase q reads
// input pixel (gy*kStride + dy, gx*kStride + dx), zero outside the map, against
// weight block blk, and the row lands at output pixel out_pixel(q, gy, gx, GW),
// GW the grid's width.

// 3x3 "same" conv: one phase, 9 taps, weight block t = ky*3 + kx.
struct Conv3x3Geom {
  static constexpr int kPhases = 1;
  static constexpr int kTaps = 9;
  static constexpr int kStride = 1;
  __device__ static void tap(int, int t, int& dy, int& dx, int& blk) {
    dy = t / 3 - 1;
    dx = t % 3 - 1;
    blk = t;
  }
  __device__ static int out_pixel(int, int gy, int gx, int GW) { return gy * GW + gx; }
};

// 4x4 / stride 2 / pad 1 conv: the grid is the output map; tap t = 4u + v
// reads input (2*oy + u - 1, 2*ox + v - 1), weight block t.
struct Conv4x4s2Geom {
  static constexpr int kPhases = 1;
  static constexpr int kTaps = 16;
  static constexpr int kStride = 2;
  __device__ static void tap(int, int t, int& dy, int& dx, int& blk) {
    dy = (t >> 2) - 1;
    dx = (t & 3) - 1;
    blk = t;
  }
  __device__ static int out_pixel(int, int gy, int gx, int GW) { return gy * GW + gx; }
};

// ConvT 4x4 / stride 2 / pad 1 as four output phases q = (qy, qx), each a
// dense 2x2-tap conv on the input grid (msig_tpu/ops/fused_conv_int8_v2.py::
// pack_convt_weights_ps): out(2I+qy, 2J+qx) = sum over dy in D(qy), dx in
// D(qx) of x(I+dy, J+dx) * w[2dy+2-qy, 2dx+2-qx], D(0) = {-1, 0},
// D(1) = {0, 1}; weight block q*4 + t with t = 2*(dy index) + (dx index).
struct ConvT4x4s2Geom {
  static constexpr int kPhases = 4;
  static constexpr int kTaps = 4;
  static constexpr int kStride = 1;
  __device__ static void tap(int q, int t, int& dy, int& dx, int& blk) {
    dy = (t >> 1) - ((q >> 1) == 0);
    dx = (t & 1) - ((q & 1) == 0);
    blk = q * 4 + t;
  }
  __device__ static int out_pixel(int q, int gy, int gx, int GW) {
    return (2 * gy + (q >> 1)) * (2 * GW) + 2 * gx + (q & 1);
  }
};

// A load that bypasses L1 (ld.global.cg) where kCg: data written earlier in
// the same launch (the single-kernel trunk) must not be read through L1 or the
// read-only path, which are not coherent with other SMs' writes.
template <bool kCg, class T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kCg) return __ldcg(p);
  else return *p;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ReflectionPad2d source index: -i -> i, n-1+i -> n-1-i (pad < n).
__device__ __forceinline__ int reflect_index(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// acc += As * Bs^T over one staged K chunk of KC bytes. As: [kBM pixels][k]
// with a row pitch of LDS bytes, Bs: [BN channels][k] with a pitch of LDB.
// Warp (wm, wn) owns rows wm*32 .. +31 and columns wn*BN/2 .. +BN/2-1;
// g = lane / 4, t4 = lane % 4.
template <int BN, int KC, int LDS, int LDB = LDS>
__device__ __forceinline__ void mma_chunk(const int8_t* As, const int8_t* Bs,
                                          int (&acc)[2][BN / 16][4], int wm, int wn, int g,
                                          int t4) {
  constexpr int NI = BN / 16;
#pragma unroll
  for (int ks = 0; ks < KC; ks += 32) {
    uint32_t af[2][4], bf[NI][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + g;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(As + r * LDS + ks + t4 * 4);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(As + (r + 8) * LDS + ks + t4 * 4);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(As + r * LDS + ks + 16 + t4 * 4);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(As + (r + 8) * LDS + ks + 16 + t4 * 4);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int n = wn * (BN / 2) + ni * 8 + g;
      bf[ni][0] = *reinterpret_cast<const uint32_t*>(Bs + n * LDB + ks + t4 * 4);
      bf[ni][1] = *reinterpret_cast<const uint32_t*>(Bs + n * LDB + ks + 16 + t4 * 4);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
  }
}

// Adds a CTA tile's share to the statistics block. acc[mi][ni][r] holds tile
// row wm*32 + mi*16 + g (+8 for r >= 2) and column wn*BN/2 + ni*8 + t4*2 +
// (r & 1); st points at the tile's first channel of sample b, BC = B * C.
// The warps first meet in shared memory (the four warps along M share their
// columns), so the tile costs kStatBlocks global atomics per column. Every
// thread of the CTA must call it.
template <int BN, bool kTrueExtremes = false>
__device__ __forceinline__ void reduce_tile_stats(const int (&acc)[2][BN / 16][4], long long* st,
                                                  size_t BC, int wn, int g, int t4) {
  // Zero is the neutral value of the sums, and of min and max where they are
  // zero-masked; the true extremes start from the ends of the range.
  constexpr int kMin0 = kTrueExtremes ? 0x7fffffff : 0;
  constexpr int kMax0 = kTrueExtremes ? (-0x7fffffff - 1) : 0;
  __shared__ long long cta[kStatBlocks][BN];
  for (int i = threadIdx.x; i < kStatBlocks * BN; i += blockDim.x)
    (&cta[0][0])[i] = i / BN == 2 ? kMin0 : (i / BN == 3 ? kMax0 : 0);
  __syncthreads();
#pragma unroll
  for (int ni = 0; ni < BN / 16; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      long long s = 0;
      unsigned long long sq = 0;  // 32 rows of v*v < 2^58 each
      int mn = kMin0, mx = kMax0;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int v = acc[mi][ni][h * 2 + e];
          s += v;
          sq += (unsigned long long)((long long)v * v);
          mn = min(mn, v);
          mx = max(mx, v);
        }
      // Reduce over the 8 row groups of the warp (lane bits 2..4).
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        sq += __shfl_xor_sync(0xffffffffu, sq, off);
        mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      if (g == 0) {
        // The warp's sum of squares is split here: four of them could pass 2^64.
        const int col = wn * (BN / 2) + ni * 8 + t4 * 2 + e;
        atomicAdd(reinterpret_cast<unsigned long long*>(&cta[0][col]), (unsigned long long)s);
        atomicAdd(reinterpret_cast<unsigned long long*>(&cta[1][col]), sq & 0xffffffffull);
        atomicMin(&cta[2][col], (long long)mn);
        atomicMax(&cta[3][col], (long long)mx);
        atomicAdd(reinterpret_cast<unsigned long long*>(&cta[4][col]), sq >> 32);
      }
    }
  __syncthreads();
  for (int i = threadIdx.x; i < kStatBlocks * BN; i += blockDim.x) {
    const int k = i / BN, col = i % BN;
    long long* dst = st + k * BC + col;
    const long long v = cta[k][col];
    if (k == 2)
      atomicMin(dst, v);
    else if (k == 3)
      atomicMax(dst, v);
    else
      atomicAdd(reinterpret_cast<unsigned long long*>(dst), (unsigned long long)v);
  }
}

// Writes a CTA tile's accumulator to the scratch (GEMM row m of phase q lands
// at its output pixel) and adds the tile's share to the statistics block.
// acc[mi][ni][r] holds GEMM row wm*32 + mi*16 + g (+8 for r >= 2) and column
// wn*BN/2 + ni*8 + t4*2 + (r & 1) of the tile. Every thread must call it.
template <class Geom, int BN, class Stage, bool kTrueExtremes>
__device__ __forceinline__ void store_tile(const int (&acc)[2][BN / 16][4], Stage* __restrict__ y,
                                           long long* __restrict__ stats, int B, int b, int q,
                                           int m0, int n0, int GW, int GHW, int Cout) {
  constexpr int NI = BN / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  Stage* yb = y + (size_t)b * Geom::kPhases * GHW * Cout + n0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + mi * 16 + g + h * 8;
      const size_t row = Geom::out_pixel(q, m / GW, m % GW, GW);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = wn * (BN / 2) + ni * 8 + t4 * 2;
        StageOf<Stage>::store2(yb + row * Cout + col, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
  reduce_tile_stats<BN, kTrueExtremes>(acc, stats + (size_t)b * Cout + n0, (size_t)B * Cout, wn,
                                       g, t4);
}

// Pass A on one CTA tile. With GHW = (H / kStride) * (W / kStride) grid pixels
// per sample, tile (tm, tn) with tm < B * Geom::kPhases * (GHW / kBM) and
// tn < Cout / BN covers kBM GEMM rows of one phase of one sample and BN output
// channels; block = kConvThreads. x: [B, H, W, Cin] int8; w: [(number of
// blocks)*Cin, Cout] int8, row blk*Cin + ci, column co; y: [B, kPhases*GHW,
// Cout], rows in output-pixel order, int32 or __half (see StageOf). Needs
// Cin % kBK == 0, Cout % BN == 0, GHW % kBM == 0, H and W multiples of
// kStride (the wrappers check). kCg reads x past L1 (see ld).
template <class Geom, int BN, class Stage = int32_t, bool kTrueExtremes = false,
          bool kCg = false>
__device__ __forceinline__ void conv_tile(const int8_t* __restrict__ x,
                                          const int8_t* __restrict__ w, Stage* __restrict__ y,
                                          long long* __restrict__ stats, int B, int H, int W,
                                          int Cin, int Cout, int tm, int tn) {
  constexpr int NI = BN / 16;  // n-tiles of 8 per warp
  __shared__ __align__(16) int8_t As[kBM * kLds];  // [pixel][k]
  __shared__ __align__(16) int8_t Bs[BN * kLds];   // [co][k]: the "col" operand of mma

  const int GW = W / Geom::kStride;
  const int GHW = (H / Geom::kStride) * GW;
  const int tiles = GHW / kBM;
  const int m0 = (tm % tiles) * kBM;
  const int q = (tm / tiles) % Geom::kPhases;
  const int b = tm / (tiles * Geom::kPhases);
  const int n0 = tn * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;

  int acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const int8_t* xb = x + (size_t)b * H * W * Cin;
  for (int t = 0; t < Geom::kTaps; ++t) {
    int dy, dx, blk;
    Geom::tap(q, t, dy, dx, blk);
    for (int c0 = 0; c0 < Cin; c0 += kBK) {
      // Input tile: kBM pixels x kBK channels, 16 B per load; the zero halo
      // comes from the bounds check.
      for (int i = tid; i < kBM * kBK / 16; i += kConvThreads) {
        const int p = i / (kBK / 16), j = i % (kBK / 16);
        const int m = m0 + p;
        const int yy = (m / GW) * Geom::kStride + dy, xx = (m % GW) * Geom::kStride + dx;
        int4 v = make_int4(0, 0, 0, 0);
        if (yy >= 0 && yy < H && xx >= 0 && xx < W)
          v = ld<kCg>(reinterpret_cast<const int4*>(xb + (size_t)(yy * W + xx) * Cin + c0 + j * 16));
        *reinterpret_cast<int4*>(As + p * kLds + j * 16) = v;
      }
      // Weight tile, transposed on the way in: Bs[co][k] = w[blk*Cin + c0 + k][n0 + co].
      for (int i = tid; i < kBK * BN / 16; i += kConvThreads) {
        const int k = i % kBK, j = i / kBK;
        const int4 v = *reinterpret_cast<const int4*>(
            w + (size_t)(blk * Cin + c0 + k) * Cout + n0 + j * 16);
        const int8_t* vb = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int e = 0; e < 16; ++e) Bs[(j * 16 + e) * kLds + k] = vb[e];
      }
      __syncthreads();
      mma_chunk<BN, kBK, kLds>(As, Bs, acc, wm, wn, g, t4);
      __syncthreads();
    }
  }
  store_tile<Geom, BN, Stage, kTrueExtremes>(acc, y, stats, B, b, q, m0, n0, GW, GHW, Cout);
}

// Pass A as a kernel: grid = (B * Geom::kPhases * (GHW / kBM), Cout / BN),
// block = kConvThreads, one tile per CTA (see conv_tile).
template <class Geom, int BN, class Stage = int32_t>
__global__ void __launch_bounds__(kConvThreads)
conv_i8_stats_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     Stage* __restrict__ y, long long* __restrict__ stats,
                     int B, int H, int W, int Cin, int Cout) {
  conv_tile<Geom, BN, Stage>(x, w, y, stats, B, H, W, Cin, Cout, blockIdx.x, blockIdx.y);
}

// The exact sum of squares hi * 2^32 + lo of a statistics block's two words,
// rounded once to fp32 (a route through float64 would round twice). Below
// 2^62 the integer converts directly; above, it is first cut to its top 62
// bits with the bits cut off ORed into the last one, which lies far below
// fp32's rounding position, so the one rounding sees what the full integer
// would show it; the power of two restores the magnitude exactly.
__device__ __forceinline__ float sumsq_to_float(unsigned long long lo_sum,
                                                unsigned long long hi_sum) {
  const unsigned long long hi = hi_sum + (lo_sum >> 32), lo = lo_sum & 0xffffffffull;
  const int s = max(0, 34 - __clzll((long long)hi));  // bit length of hi, less 30
  const unsigned long long m =
      (hi << (32 - s)) | (lo >> s) | (unsigned long long)((lo & ((1ull << s) - 1)) != 0);
  return __fmul_rn(__ull2float_rn(m), (float)(1ull << s));
}

// Where the residual sites keep max |hn| of sample b.
__device__ __forceinline__ long long* amax_slot(long long* stats, int B, int C, int b) {
  return stats + (size_t)kStatBlocks * B * C + b;
}
__device__ __forceinline__ float load_amax(const long long* stats, int B, int C, int b) {
  return __uint_as_float((unsigned int)stats[(size_t)kStatBlocks * B * C + b]);
}
// v >= 0: the bit patterns of non-negative floats are ordered as integers.
__device__ __forceinline__ void store_amax(long long* stats, int B, int C, int b, float v) {
  atomicMax(reinterpret_cast<unsigned long long*>(amax_slot(stats, B, C, b)),
            (unsigned long long)__float_as_uint(v));
}

// Per-channel IN (+ AdaIN) affine of sample b, in the order of the TPU kernel
// (fused_conv_int8_v2.py:121-126): mean = sum/n, var = max(sumsq/n - mean^2, 0),
// a = gamma * rsqrt(var + eps), d = beta - mean * a. A null gamma / beta is
// the plain IN of the ConvT sites (:627-631): 1 * r and 0 - m * a give the
// bits of r and -m * a. Explicit _rn intrinsics keep nvcc from contracting
// into FMAs, so the plain PyTorch version can repeat the arithmetic.
// kCg reads the statistics past L1 (see ld).
template <bool kCg = false>
__device__ __forceinline__ void channel_affine(const long long* __restrict__ stats,
                                               const float* __restrict__ gamma,
                                               const float* __restrict__ beta, int b, int B,
                                               int C, int HW, float eps, float* a_s, float* d_s) {
  const float n = (float)HW;
  const size_t BC = (size_t)B * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const size_t i = (size_t)b * C + c;
    const float mean = __fdiv_rn((float)ld<kCg>(&stats[i]), n);
    const float sumsq = sumsq_to_float((unsigned long long)ld<kCg>(&stats[BC + i]),
                                       (unsigned long long)ld<kCg>(&stats[4 * BC + i]));
    const float var = fmaxf(__fsub_rn(__fdiv_rn(sumsq, n), __fmul_rn(mean, mean)), 0.f);
    const float a = __fmul_rn(gamma ? gamma[i] : 1.f, __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps))));
    a_s[c] = a;
    d_s[c] = __fsub_rn(beta ? beta[i] : 0.f, __fmul_rn(mean, a));
  }
}

// Max of non-negative per-thread values over the block.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

// The true-extremes relu epilogue (fused_trunk_v3.py:112-124,
// int8_epilogue_chunked.py:79-95). amax is the largest of the channels'
// max(a*max y, a*min y) + d and 0, over the true extremes (exact: the affine
// is monotone in y per channel); then q = clip(round(max(y*a + d, 0) * s), +-127)
// with s = 127/amax, unfolded as the TPU kernels compute it. Every thread of
// the block calls true_relu_amax; a_s, d_s hold sample b's affine.
template <bool kCg = false>
__device__ __forceinline__ float true_relu_amax(const long long* __restrict__ stats,
                                                const float* a_s, const float* d_s, int b, int B,
                                                int C, float* red) {
  const size_t BC = (size_t)B * C;
  float local = 0.f;  // max(hi, 0)
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float cmin = (float)ld<kCg>(&stats[2 * BC + (size_t)b * C + c]);
    const float cmax = (float)ld<kCg>(&stats[3 * BC + (size_t)b * C + c]);
    local = fmaxf(local, __fadd_rn(fmaxf(__fmul_rn(a_s[c], cmax), __fmul_rn(a_s[c], cmin)), d_s[c]));
  }
  return block_max(local, red);
}

__device__ __forceinline__ signed char relu_requant_unfolded(float v, float a, float d, float s) {
  const float t = __fmul_rn(fmaxf(__fadd_rn(__fmul_rn(v, a), d), 0.f), s);
  return (signed char)min(max(__float2int_rn(t), -127), 127);
}

// hn = y*a + d + h*hs of the residual sites, in the order of
// fused_conv_int8_v2.py:175-176 and fused_trunk_v3.py:153-154, :162-163. The amax pass
// and the requant pass evaluate it with the same rounded operations, so the
// requant sees exactly the values whose max it took.
__device__ __forceinline__ float residual_hn(int v, signed char h, float a, float d, float hs) {
  const float hf = __fmul_rn((float)h, hs);
  return __fadd_rn(__fadd_rn(__fmul_rn((float)v, a), d), hf);
}

// Epilogue CTAs per sample: each walks a contiguous share of the sample's
// HW*C/4 groups of 4 channels.
inline int epilogue_blocks(int HW, int C) {
  const long long groups = (long long)HW * C / 4;
  long long n = (groups + 16LL * kEpiThreads - 1) / (16LL * kEpiThreads);
  return (int)(n < 1 ? 1 : (n > 1024 ? 1024 : n));
}

// Pass B of the relu sites (resblock conv1, the ConvT sites, the encoder
// sites): IN (+ AdaIN)
// -> ReLU -> per-sample requant. amax is the affine image of the zero-masked
// min and max, as the TPU kernels take it (fused_conv_int8_v2.py:127-131,
// :634-637); it may exceed the true max, never clip. Then
// y -> round(min(max(y*a2 + d2, 0), 127)) with a2 = a*s, d2 = d*s, s = 127/amax.
// out_scale (null at the resblock site) gets amax/127, or 1 when amax is 0.
// A __half scratch holds y * 2^-12: a2 takes the factor 2^12, after the
// product a*s, as the TPU's staged sites fold it (fused_dec_int8.py:425-428).
// grid = (epilogue_blocks(HW, C), B), dynamic smem 2*C floats; HW is the
// number of output pixels per sample.
template <class Stage>
__global__ void __launch_bounds__(kEpiThreads)
relu_requant_kernel(const Stage* __restrict__ y, const long long* __restrict__ stats,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    int8_t* __restrict__ out, float* __restrict__ out_scale, int B, int HW,
                    int C, float eps) {
  extern __shared__ float sh[];  // a[C], d[C]
  __shared__ float red[32];
  float* a_s = sh;
  float* d_s = sh + C;
  const int b = blockIdx.y;
  channel_affine(stats, gamma, beta, b, B, C, HW, eps, a_s, d_s);
  __syncthreads();

  const size_t BC = (size_t)B * C;
  float local = 0.f;  // max(hi, 0)
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float cmin = (float)stats[2 * BC + (size_t)b * C + c];
    const float cmax = (float)stats[3 * BC + (size_t)b * C + c];
    const float hi = __fadd_rn(fmaxf(__fmul_rn(a_s[c], cmax), __fmul_rn(a_s[c], cmin)), d_s[c]);
    local = fmaxf(local, hi);
  }
  const float amax = block_max(local, red);
  const float s = amax > 0.f ? __fdiv_rn(127.f, amax) : 1.f;
  if (out_scale != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    out_scale[b] = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    a_s[c] = __fmul_rn(__fmul_rn(a_s[c], s), StageOf<Stage>::kUnscale);
    d_s[c] = __fmul_rn(d_s[c], s);
  }
  __syncthreads();

  const size_t n4 = (size_t)HW * C / 4;
  const Stage* yb = y + (size_t)b * HW * C;
  char4* o4 = reinterpret_cast<char4*>(out + (size_t)b * HW * C);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float vals[4];
    StageOf<Stage>::load4(yb + i * 4, vals);
    const int c = (int)((i * 4) % C);
    signed char qv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float t = __fadd_rn(__fmul_rn(vals[k], a_s[c + k]), d_s[c + k]);
      t = fminf(fmaxf(t, 0.f), 127.f);
      qv[k] = (signed char)__float2int_rn(t);
    }
    o4[i] = make_char4(qv[0], qv[1], qv[2], qv[3]);
  }
}

}  // namespace msig
