// Backward of a 3x3 stride-1 zero-padded ("SAME") convolution in fp32 on dense
// NHWC maps (sm_90a): dx and dW of y = conv3x3([relu](x), W), W in HWIO.
//
//   y[p]  = sum_t xin[p + off_t] @ W_t           W_t = W[di, dj] in [C, Co]
//   dx[q] = sum_t dy[q - off_t] @ W_t^T          (times [x > 0] for a relu input)
//   dW_t  = sum_p xin[p + off_t]^T dy[p]         off_t = (di - 1, dj - 1)
//
// Shared by the two TPU kernels msig_tpu/ops/conv3x3_vjp.py::conv3x3_bwd
// (_bwd_kernel) and conv3x3_adain_bwd (_bwd_adain_kernel), whose common core
// (_conv_bwd_core) runs both products over one image's padded slabs held in
// VMEM, one image per grid step, with dW accumulated across the grid.
//
// Here the two products are two tiled fp32 GEMMs on the CUDA cores (FMA; TF32
// or bf16 tensor-core products would miss the fp32 parity bars):
//   dx: M = B*H*W pixels, N = C, K = 9*Co, A = dy gathered at the shifted
//       pixel (zero outside the map), B = the transposed taps wt [9*Co, C];
//   dW: M = 9*C (tap, input channel), N = Co, K = B*H*W pixels, A = xin
//       gathered at the shifted pixel, B = dy. K runs over the batch and the
//       image, so it is split into chunks of kDwChunk pixels: each CTA writes
//       its partial [9*C, Co] product, and a second small kernel adds the
//       partials in chunk order. No atomics: two runs give the same dW bits.
// Each CTA computes a 128 x 128 tile, 8 x 8 outputs per thread, with K staged
// through shared memory 8 at a time, double-buffered through registers.
//
// Bound on an H100 at the main path's shape (x, dy [8, 64, 64, 256], W
// [3, 3, 256, 256]): dx and dW are 2 x 2 * 32768 * 256 * 2304 = 77.3 GFLOP,
// 1.15 ms at the 67 TFLOP/s of fp32 FMA, against 101 MB that must move
// (0.03 ms), so operations bound it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace msig_f32 {

constexpr int kTile = 128;       // M and N of a CTA's output tile
constexpr int kBK = 8;           // K staged per step
constexpr int kThreads = 256;    // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLdA = kTile + 4;  // A's smem row pitch: conflict-free transposed stores
constexpr int kDwChunk = 2048;   // pixels of K per dW partial

struct Map {
  int B, H, W, C, Co;
};

// The 8 x 8 outer-product update over one staged K step.
__device__ __forceinline__ void tile_fma(const float (*As)[kLdA], const float (*Bs)[kTile],
                                         float acc[8][8], int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Row (M) index of the i-th of a thread's 8 rows, and likewise for columns.
__device__ __forceinline__ int tile_row(int ty, int i) { return (i < 4 ? 0 : 64) + ty * 4 + (i & 3); }

// ---------------------------------------------------------------------- dx
// grid (B*H*W / 128, C / 128). dy [B*H*W, Co], wt [9*Co, C], x and dx [B*H*W, C].
template <bool kRelu>
__global__ void __launch_bounds__(kThreads) conv3x3_dx_kernel(const float* __restrict__ dy,
                                                              const float* __restrict__ wt,
                                                              const float* __restrict__ x,
                                                              float* __restrict__ dx, Map g) {
  __shared__ __align__(16) float As[2][kBK][kLdA];
  __shared__ __align__(16) float Bs[2][kBK][kTile];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;

  // A loader: this thread's pixel and its 4 consecutive k of each step.
  const int am = tid >> 1, ak = (tid & 1) * 4;
  const int pix = m0 + am, hw = g.H * g.W;
  const int pb = pix / hw, ph = (pix % hw) / g.W, pw = pix % g.W;
  // B loader: row k of the step, 4 consecutive n.
  const int bk = tid >> 5, bn = (tid & 31) * 4;

  const int ksteps = 9 * g.Co / kBK;
  auto load_a = [&](int ks) -> float4 {
    const int k = ks * kBK, t = k / g.Co, co = k % g.Co + ak;
    const int sh = ph - (t / 3) + 1, sw = pw - (t % 3) + 1;
    if (sh < 0 || sh >= g.H || sw < 0 || sw >= g.W) return make_float4(0.f, 0.f, 0.f, 0.f);
    return *reinterpret_cast<const float4*>(dy + ((size_t)(pb * g.H + sh) * g.W + sw) * g.Co + co);
  };
  auto load_b = [&](int ks) -> float4 {
    return *reinterpret_cast<const float4*>(wt + (size_t)(ks * kBK + bk) * g.C + n0 + bn);
  };
  auto store = [&](int buf, float4 a, float4 b) {
    As[buf][ak + 0][am] = a.x;
    As[buf][ak + 1][am] = a.y;
    As[buf][ak + 2][am] = a.z;
    As[buf][ak + 3][am] = a.w;
    *reinterpret_cast<float4*>(&Bs[buf][bk][bn]) = b;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  store(0, load_a(0), load_b(0));
  __syncthreads();
  for (int ks = 0; ks < ksteps; ++ks) {
    const int cur = ks & 1;
    float4 na, nb;
    const bool more = ks + 1 < ksteps;
    if (more) {
      na = load_a(ks + 1);
      nb = load_b(ks + 1);
    }
    tile_fma(As[cur], Bs[cur], acc, ty, tx);
    if (more) store(cur ^ 1, na, nb);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t row = (size_t)(m0 + tile_row(ty, i)) * g.C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      if (kRelu) {  // relu'(x): dx is exactly 0 where x <= 0
        const float4 xv = *reinterpret_cast<const float4*>(x + row + n);
        v.x = xv.x > 0.f ? v.x : 0.f;
        v.y = xv.y > 0.f ? v.y : 0.f;
        v.z = xv.z > 0.f ? v.z : 0.f;
        v.w = xv.w > 0.f ? v.w : 0.f;
      }
      *reinterpret_cast<float4*>(dx + row + n) = v;
    }
  }
}

// ---------------------------------------------------------------------- dW
// grid (9*C / 128, Co / 128, ceil(B*H*W / kDwChunk)). x [B*H*W, C], dy
// [B*H*W, Co]; part [chunks, 9*C, Co] receives each chunk's product.
template <bool kRelu>
__global__ void __launch_bounds__(kThreads) conv3x3_dw_kernel(const float* __restrict__ x,
                                                              const float* __restrict__ dy,
                                                              float* __restrict__ part, Map g) {
  __shared__ __align__(16) float As[2][kBK][kLdA];
  __shared__ __align__(16) float Bs[2][kBK][kTile];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int t = m0 / g.C, ci0 = m0 % g.C;  // a tile of M lies within one tap
  const int di = t / 3 - 1, dj = t % 3 - 1;
  const int npix = g.B * g.H * g.W, hw = g.H * g.W;
  const int p_begin = blockIdx.z * kDwChunk;
  const int p_end = min(npix, p_begin + kDwChunk);

  // Both loaders: pixel row k of the step, 4 consecutive columns.
  const int lk = tid >> 5, lc = (tid & 31) * 4;
  auto load_a = [&](int p) -> float4 {
    const int b = p / hw, h = (p % hw) / g.W + di, w = p % g.W + dj;
    if (h < 0 || h >= g.H || w < 0 || w >= g.W) return make_float4(0.f, 0.f, 0.f, 0.f);
    float4 v = *reinterpret_cast<const float4*>(x + ((size_t)(b * g.H + h) * g.W + w) * g.C + ci0 + lc);
    if (kRelu) {
      v.x = fmaxf(v.x, 0.f);
      v.y = fmaxf(v.y, 0.f);
      v.z = fmaxf(v.z, 0.f);
      v.w = fmaxf(v.w, 0.f);
    }
    return v;
  };
  auto load_b = [&](int p) -> float4 {
    return *reinterpret_cast<const float4*>(dy + (size_t)p * g.Co + n0 + lc);
  };
  auto store = [&](int buf, float4 a, float4 b) {
    *reinterpret_cast<float4*>(&As[buf][lk][lc]) = a;
    *reinterpret_cast<float4*>(&Bs[buf][lk][lc]) = b;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int ksteps = (p_end - p_begin) / kBK;  // B*H*W is a multiple of 128
  store(0, load_a(p_begin + lk), load_b(p_begin + lk));
  __syncthreads();
  for (int ks = 0; ks < ksteps; ++ks) {
    const int cur = ks & 1;
    float4 na, nb;
    const bool more = ks + 1 < ksteps;
    if (more) {
      const int p = p_begin + (ks + 1) * kBK + lk;
      na = load_a(p);
      nb = load_b(p);
    }
    tile_fma(As[cur], Bs[cur], acc, ty, tx);
    if (more) store(cur ^ 1, na, nb);
    __syncthreads();
  }

  float* out = part + (size_t)blockIdx.z * 9 * g.C * g.Co;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t row = (size_t)(m0 + tile_row(ty, i)) * g.Co;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      *reinterpret_cast<float4*>(out + row + n) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

// dW = sum of the chunks' partials, added in chunk order (deterministic).
// n4: the number of float4 of one [9*C, Co] product.
__global__ void dw_reduce_kernel(const float4* __restrict__ part, float4* __restrict__ dw, int n4,
                                 int chunks) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int c = 1; c < chunks; ++c) {
      const float4 v = part[(size_t)c * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    dw[i] = s;
  }
}

inline int dw_chunks(const Map& g) { return (g.B * g.H * g.W + kDwChunk - 1) / kDwChunk; }

// dx and dW of one conv; part: scratch of dw_chunks(g) * 9*C*Co floats.
// Returns cudaGetLastError() after the launches.
inline cudaError_t conv3x3_bwd_launch(const float* x, const float* dy, const float* wt, float* dx,
                                      float* dw, float* part, const Map& g, bool relu,
                                      cudaStream_t st) {
  const dim3 grid_dx(g.B * g.H * g.W / kTile, g.C / kTile);
  if (relu)
    conv3x3_dx_kernel<true><<<grid_dx, kThreads, 0, st>>>(dy, wt, x, dx, g);
  else
    conv3x3_dx_kernel<false><<<grid_dx, kThreads, 0, st>>>(dy, wt, x, dx, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunks = dw_chunks(g);
  const dim3 grid_dw(9 * g.C / kTile, g.Co / kTile, chunks);
  if (relu)
    conv3x3_dw_kernel<true><<<grid_dw, kThreads, 0, st>>>(x, dy, part, g);
  else
    conv3x3_dw_kernel<false><<<grid_dw, kThreads, 0, st>>>(x, dy, part, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n4 = 9 * g.C * g.Co / 4;
  dw_reduce_kernel<<<(n4 + 255) / 256, 256, 0, st>>>(reinterpret_cast<const float4*>(part),
                                                     reinterpret_cast<float4*>(dw), n4, chunks);
  return cudaGetLastError();
}

}  // namespace msig_f32
