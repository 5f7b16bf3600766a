// Shared pieces of the int8 conv sites that end in an instance norm (sm_90a):
// the resblock 3x3 sites, the decoder's 4x4/s2 ConvT sites and the encoder's
// 4x4/s2 conv sites (and, for all but its own staging, the encoder's 7x7 site).
//
// Every such site starts with an int8 convolution over a dense NHWC map,
// written as an implicit GEMM accumulated exactly in int32, whose exact
// per-(sample, channel) statistics are reduced across CTAs with int64
// atomics. A site's geometry (which input pixel each tap reads, and where an
// output row lands) is a small struct here; the conv itself runs on wgmma
// (conv_i8_wgmma.cuh). The 3x3 sites write the int32 accumulator to a
// scratch in device memory and map it in an epilogue kernel below; the
// two-pass sites (ConvT, 4x4/s2) run the conv twice and map the registers
// with the same helpers, without the scratch.
//
// Why not one pass: the TPU kernels (msig_tpu/ops/fused_conv_int8_v2.py,
// fused_dec_int8.py) run one whole sample per program and keep its int32
// accumulator (4 to 16 MB) in VMEM, because the per-sample requant scale
// needs every conv output of the sample before any int8 is written. One SM
// holds 227 KB of shared memory.
//
// Statistics block (int64, set to its neutral values by the launchers), for
// B samples and C output channels:
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
// In the true-extremes mode (conv_i8_wgmma.cuh's kTrue: the v1 relu and
// ConvT sites, fused_conv_int8.py:125-126, :225-226, and the single-kernel
// trunk, msig_tpu/ops/fused_trunk_v3.py:99-118) blocks 2 and 3 hold the true
// min y and max y instead, from neutral values at or past the int32 ends.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace msig {

constexpr int kBM = 128;          // pixels of the site's grid a tile, consecutive in one sample
constexpr int kEpiThreads = 256;
constexpr int kStatBlocks = 5;    // per-(sample, channel) blocks of the statistics block

// How the epilogue reads the accumulator: as int32, or as the __half holding
// y * 2^-12 that the TPU's staged sites pass on (msig_tpu/ops/fused_dec_int8.py:
// STAGE_SCALE; |y| * 2^-12 < 65504 for every site here), the statistics taken
// from the exact int32 values before the narrowing. The epilogue folds 2^12
// into its multiplier.
constexpr float kStageScale = 1.f / 4096.f;

template <class Stage> struct StageOf;
template <> struct StageOf<int32_t> {
  static constexpr float kUnscale = 1.f;
  __device__ static void load4(const int32_t* p, float (&f)[4]) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    f[0] = (float)v.x, f[1] = (float)v.y, f[2] = (float)v.z, f[3] = (float)v.w;
  }
  // v as the epilogue reads it back from the scratch, without the scratch.
  __device__ static float through(int v) { return (float)v; }
};
template <> struct StageOf<__half> {
  static constexpr float kUnscale = 4096.f;
  __device__ static void load4(const __half* p, float (&f)[4]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const __half2 lo = *reinterpret_cast<const __half2*>(&v.x);
    const __half2 hi = *reinterpret_cast<const __half2*>(&v.y);
    f[0] = __low2float(lo), f[1] = __high2float(lo), f[2] = __low2float(hi), f[3] = __high2float(hi);
  }
  __device__ static float through(int v) {
    return __half2float(__float2half_rn(__fmul_rn((float)v, kStageScale)));
  }
};

// A geometry says how the conv's GEMM maps onto a conv. GEMM rows are the
// pixels (gy, gx) of a grid of H/kStride x W/kStride; tap t of phase q reads
// input pixel (gy*kStride + dy, gx*kStride + dx), zero outside the map, and
// the row lands at output pixel out_pixel(q, gy, gx, GW), GW the grid's
// width. The K-major weights hold phase q's [Cout, kTaps*Cin] block, column
// t*Cin + ci (conv_i8_wgmma.cuh).

// 3x3 "same" conv: one phase, 9 taps, weight block t = ky*3 + kx.
struct Conv3x3Geom {
  static constexpr int kPhases = 1;
  static constexpr int kTaps = 9;
  static constexpr int kStride = 1;
  __device__ static void tap(int, int t, int& dy, int& dx) {
    dy = t / 3 - 1;
    dx = t % 3 - 1;
  }
  __device__ static int out_pixel(int, int gy, int gx, int GW) { return gy * GW + gx; }
};

// 4x4 / stride 2 / pad 1 conv: the grid is the output map; tap t = 4u + v
// reads input (2*oy + u - 1, 2*ox + v - 1).
struct Conv4x4s2Geom {
  static constexpr int kPhases = 1;
  static constexpr int kTaps = 16;
  static constexpr int kStride = 2;
  __device__ static void tap(int, int t, int& dy, int& dx) {
    dy = (t >> 2) - 1;
    dx = (t & 3) - 1;
  }
  __device__ static int out_pixel(int, int gy, int gx, int GW) { return gy * GW + gx; }
};

// The same conv as four output phases q = 2*qy + qx, each its own dense
// K = 16*Cin product against its own weight block (msig_tpu/ops/
// fused_enc_int8.py::enc1_in_relu_requant_im2col, pack_enc1_im2col): the grid
// is (H/4) x (W/4); grid pixel (gy, gx) of phase q is output pixel (2gy + qy,
// 2gx + qx), and tap t = 4u + v reads input (4gy + 2qy + u - 1,
// 4gx + 2qx + v - 1), dy and dx in -1 .. 4, against phase q's weight block.
struct Enc1PhaseGeom {
  static constexpr int kPhases = 4;
  static constexpr int kTaps = 16;
  static constexpr int kStride = 4;
  __device__ static void tap(int q, int t, int& dy, int& dx) {
    dy = 2 * (q >> 1) + (t >> 2) - 1;
    dx = 2 * (q & 1) + (t & 3) - 1;
  }
  __device__ static int out_pixel(int q, int gy, int gx, int GW) {
    return (2 * gy + (q >> 1)) * (2 * GW) + 2 * gx + (q & 1);
  }
};

// ConvT 4x4 / stride 2 / pad 1 as four output phases q = (qy, qx), each a
// dense 2x2-tap conv on the input grid (msig_tpu/ops/fused_conv_int8_v2.py::
// pack_convt_weights_ps): out(2I+qy, 2J+qx) = sum over dy in D(qy), dx in
// D(qx) of x(I+dy, J+dx) * w[2dy+2-qy, 2dx+2-qx], D(0) = {-1, 0},
// D(1) = {0, 1}; tap t = 2*(dy index) + (dx index).
struct ConvT4x4s2Geom {
  static constexpr int kPhases = 4;
  static constexpr int kTaps = 4;
  static constexpr int kStride = 1;
  __device__ static void tap(int q, int t, int& dy, int& dx) {
    dy = (t >> 1) - ((q >> 1) == 0);
    dx = (t & 1) - ((q & 1) == 0);
  }
  __device__ static int out_pixel(int q, int gy, int gx, int GW) {
    return (2 * gy + (q >> 1)) * (2 * GW) + 2 * gx + (q & 1);
  }
};

// ReflectionPad2d source index: -i -> i, n-1+i -> n-1-i (pad < n).
__device__ __forceinline__ int reflect_index(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
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

// IN (+ AdaIN) affine of entry i = b*C + c of the statistics block (BC =
// B*C, n outputs per (sample, channel)), in the order of the TPU kernel
// (fused_conv_int8_v2.py:121-126): mean = sum/n, var = max(sumsq/n - mean^2, 0),
// a = gamma * rsqrt(var + eps), d = beta - mean * a. A null gamma / beta is
// the plain IN of the ConvT sites (:627-631): 1 * r and 0 - m * a give the
// bits of r and -m * a. Explicit _rn intrinsics keep nvcc from contracting
// into FMAs, so the plain PyTorch version can repeat the arithmetic.
// affine_of: the same from the entry's sum and sum-of-squares words, loaded
// by the caller.
__device__ __forceinline__ void affine_of(long long sum, unsigned long long sq_lo,
                                          unsigned long long sq_hi, float gamma, float beta,
                                          float n, float eps, float& a, float& d) {
  const float mean = __fdiv_rn((float)sum, n);
  const float sumsq = sumsq_to_float(sq_lo, sq_hi);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(sumsq, n), __fmul_rn(mean, mean)), 0.f);
  a = __fmul_rn(gamma, __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps))));
  d = __fsub_rn(beta, __fmul_rn(mean, a));
}
__device__ __forceinline__ void in_affine(const long long* __restrict__ stats,
                                          const float* __restrict__ gamma,
                                          const float* __restrict__ beta, size_t i, size_t BC,
                                          float n, float eps, float& a, float& d) {
  affine_of(stats[i], (unsigned long long)stats[BC + i], (unsigned long long)stats[4 * BC + i],
            gamma ? gamma[i] : 1.f, beta ? beta[i] : 0.f, n, eps, a, d);
}

// The per-channel affine of sample b (in_affine) into a_s[C], d_s[C], by the
// threads of the block; HW is the number of outputs per (sample, channel).
__device__ __forceinline__ void channel_affine(const long long* __restrict__ stats,
                                               const float* __restrict__ gamma,
                                               const float* __restrict__ beta, int b, int B,
                                               int C, int HW, float eps, float* a_s, float* d_s) {
  const size_t BC = (size_t)B * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    in_affine(stats, gamma, beta, (size_t)b * C + c, BC, (float)HW, eps, a_s[c], d_s[c]);
}

// The relu sites' requant, shared by relu_requant_kernel and the ConvT site's
// pass Q (conv_i8_wgmma.cuh), so that both give the same bits by construction.
// relu_hi: channel i's part of the amax, the affine image of its zero-masked
// min and max (fused_conv_int8_v2.py:127-131, :634-637); amax is the largest of
// them and 0 over the sample's channels (max is exact, so in any order).
__device__ __forceinline__ float relu_hi(const long long* __restrict__ stats, size_t BC, size_t i,
                                         float a, float d) {
  const float cmin = (float)stats[2 * BC + i];
  const float cmax = (float)stats[3 * BC + i];
  return __fadd_rn(fmaxf(__fmul_rn(a, cmax), __fmul_rn(a, cmin)), d);
}
// The requant scale s = 127/amax and the inverse scale amax/127 (1 for amax 0).
__device__ __forceinline__ float relu_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(127.f, amax) : 1.f;
}
__device__ __forceinline__ float relu_inv_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
}
// a2 = a*s*unscale, d2 = d*s: the affine with the scale folded in; unscale
// (StageOf::kUnscale) undoes the fp16 staging's 2^-12 after the product a*s,
// as the TPU's staged sites fold it (fused_dec_int8.py:425-428).
__device__ __forceinline__ void fold_relu(float a, float d, float s, float unscale, float& a2,
                                          float& d2) {
  a2 = __fmul_rn(__fmul_rn(a, s), unscale);
  d2 = __fmul_rn(d, s);
}
// One value: round(min(max(v*a2 + d2, 0), 127)).
__device__ __forceinline__ signed char relu_requant_folded(float v, float a2, float d2) {
  const float t = fminf(fmaxf(__fadd_rn(__fmul_rn(v, a2), d2), 0.f), 127.f);
  return (signed char)__float2int_rn(t);
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

// The true-extremes relu epilogue (int8_epilogue_chunked.py:79-95, as
// fused_trunk_v3.py:112-124, the v1 sites' fused_conv_int8.py:141-157,
// :247-264), also the kTrue pass Q of conv_i8_wgmma.cuh. amax is the largest of the channels'
// max(a*max y, a*min y) + d and 0, over the true extremes (exact: the affine
// is monotone in y per channel); then q = clip(round(max(y*a + d, 0) * s), +-127)
// with s = 127/amax, unfolded as the TPU kernels compute it. true_relu_hi is
// one channel's part; every thread of the block calls true_relu_amax; a_s,
// d_s hold sample b's affine.
__device__ __forceinline__ float true_relu_hi(float a, float d, float cmin, float cmax) {
  return __fadd_rn(fmaxf(__fmul_rn(a, cmax), __fmul_rn(a, cmin)), d);
}
__device__ __forceinline__ float true_relu_amax(const long long* __restrict__ stats,
                                                const float* a_s, const float* d_s, int b, int B,
                                                int C, float* red) {
  const size_t BC = (size_t)B * C;
  float local = 0.f;  // max(hi, 0)
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float cmin = (float)stats[2 * BC + (size_t)b * C + c];
    const float cmax = (float)stats[3 * BC + (size_t)b * C + c];
    local = fmaxf(local, true_relu_hi(a_s[c], d_s[c], cmin, cmax));
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

// The epilogue of the relu site (resblock conv1, after its pass A; the
// two-pass sites map their registers with its helpers): IN (+ AdaIN) -> ReLU
// -> per-sample requant. amax is the affine image of the zero-masked
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
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    local = fmaxf(local, relu_hi(stats, BC, (size_t)b * C + c, a_s[c], d_s[c]));
  const float amax = block_max(local, red);
  const float s = relu_scale(amax);
  if (out_scale != nullptr && blockIdx.x == 0 && threadIdx.x == 0) out_scale[b] = relu_inv_scale(amax);
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    fold_relu(a_s[c], d_s[c], s, StageOf<Stage>::kUnscale, a_s[c], d_s[c]);
  __syncthreads();

  const size_t n4 = (size_t)HW * C / 4;
  const Stage* yb = y + (size_t)b * HW * C;
  char4* o4 = reinterpret_cast<char4*>(out + (size_t)b * HW * C);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float vals[4];
    StageOf<Stage>::load4(yb + i * 4, vals);
    const int c = (int)((i * 4) % C);
    o4[i] = make_char4(relu_requant_folded(vals[0], a_s[c], d_s[c]),
                       relu_requant_folded(vals[1], a_s[c + 1], d_s[c + 1]),
                       relu_requant_folded(vals[2], a_s[c + 2], d_s[c + 2]),
                       relu_requant_folded(vals[3], a_s[c + 3], d_s[c + 3]));
  }
}

// The epilogue of the true-extremes relu site (the v1 conv1 site
// msig_tpu/ops/fused_conv_int8.py::_kernel :141-157, after the kTrue pass A):
// the affine (gamma, beta null for the plain IN of a ConvT site), amax by
// true_relu_amax, q by relu_requant_unfolded. out_scale, where not null, gets amax/127, or 1 when
// amax is 0. y: [B, HW, C] int32, HW the output pixels per sample; the
// statistics block in the true-extremes mode. grid = (epilogue_blocks(HW, C),
// B), dynamic smem 2*C floats.
__global__ void __launch_bounds__(kEpiThreads)
true_relu_requant_kernel(const int32_t* __restrict__ y, const long long* __restrict__ stats,
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
  const float amax = true_relu_amax(stats, a_s, d_s, b, B, C, red);
  const float s = amax > 0.f ? __fdiv_rn(127.f, amax) : 1.f;
  if (out_scale != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    out_scale[b] = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
  const size_t n4 = (size_t)HW * C / 4;
  const int4* y4 = reinterpret_cast<const int4*>(y + (size_t)b * HW * C);
  char4* o4 = reinterpret_cast<char4*>(out + (size_t)b * HW * C);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const int4 v = y4[i];
    const int c = (int)((i * 4) % C);
    o4[i] = make_char4(relu_requant_unfolded((float)v.x, a_s[c], d_s[c], s),
                       relu_requant_unfolded((float)v.y, a_s[c + 1], d_s[c + 1], s),
                       relu_requant_unfolded((float)v.z, a_s[c + 2], d_s[c + 2], s),
                       relu_requant_unfolded((float)v.w, a_s[c + 3], d_s[c + 3], s));
  }
}

}  // namespace msig
