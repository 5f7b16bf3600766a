// Backward of a 3x3 stride-1 zero-padded ("SAME") convolution in fp32 on dense
// NHWC maps (sm_90a): dx and dW of y = conv3x3([relu](x), W), W in HWIO.
//
//   y[p]  = sum_t xin[p + off_t] @ W_t           W_t = W[di, dj] in [C, Co]
//   dx[q] = sum_t dy[q - off_t] @ W_t^T          (times [x > 0] for a relu input)
//   dW_t  = sum_p xin[p + off_t]^T dy[p]         off_t = (di - 1, dj - 1)
//
// Replaces the core shared by the TPU kernels msig_tpu/ops/conv3x3_vjp.py::
// conv3x3_bwd (_bwd_kernel) and conv3x3_adain_bwd (_bwd_adain_kernel): their
// _conv_bwd_core runs both products over one image's padded slabs held in
// VMEM, one image per grid step, with dW accumulated across the grid.
//
// Here the two products are two implicit GEMMs in one launch:
//   dx: M = B*H*W pixels, N = C, K = 9*Co, A = dy gathered at the shifted
//       pixel (zero outside the map), B = the transposed taps wt [9*Co, C];
//   dW: M = 9*C (tap, input channel), N = Co, K = pixels, A = xin gathered at
//       the shifted pixel, B = dy.
// No tile accumulates more than kMaxK of K (see the error below): dW's K is
// split into chunks of kMaxK pixels, and dx's into dx_splits(g) parts where
// 9*Co > kMaxK (none at Co = 256). Each such CTA writes its partial product
// to scratch, and a second kernel adds the partials in order. No float
// atomics: the same bits on every call.
//
// Bound on an H100 at the main path's shape (x, dy [8, 64, 64, 256], W
// [3, 3, 256, 256]): the two products are 2 x 2 * 32768 * 256 * 2304 = 77.3
// GFLOP against 101 MB that must move (0.03 ms). On the CUDA cores (fp32 FMA,
// 67 TFLOP/s) that is 1.15 ms, and the CUDA cores are where the first version
// ran. One TF32 tensor-core pass misses the port's fp32 bars (rtol 1e-4) by
// about 20x, so the products run as 3xTF32: each operand v splits into big =
// tf32_rna(v) and small = tf32_rna(v - big), and the tile sums small*big +
// big*small + big*big in fp32 (small*small, at most 2^-22 of a product, is
// dropped). Three passes at the 495 TFLOP/s of dense TF32 bound it at 0.47 ms.
// The tensor cores add with truncation, so the error grows with the length of
// an accumulation: at K = 2304 it reaches about 3/4 of the bars (rtol 1e-4,
// atol 1e-5 x max), at 576 under 1/4; hence kMaxK.
//
// Route: both products on mma.sync.m16n8k8 TF32 (wgmma reads B from shared
// memory, so it needs B split there, and dW's K, the pixels, K-major; NHWC
// puts the channels there). Each CTA computes a 128 x 128 tile with 4 warps
// of 64 x 64, 2 CTAs per SM (up to 255 registers a thread). Operands stream
// through a ring of kStages stages in dynamic shared memory, filled by
// 16-byte cp.async.cg copies that zero-fill taps outside the map and pixels
// past the ragged edge of B*H*W; K moves 32 at a time (one barrier per 32 of
// K), and a dx K block never straddles two taps (Co % 32 == 0), so the tap and
// the shift are worked out once per block. The split, and dW's ReLU of x,
// happen at the fragment load (cp.async bypasses registers). Pitches keep the
// fragment loads free of bank conflicts: [m][k] tiles 36 floats, [k][m|n]
// tiles 136. dx tiles come first in the grid and dW's chunk by chunk after
// them; at Co = 256 a full dW chunk has dx's K (2304), so the CTAs are of one
// size and the short last chunk fills the last wave.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace msig_f32 {

constexpr int kBM = 128, kBN = 128;  // a CTA's output tile
constexpr int kBK = 32;              // K per ring stage
constexpr int kWarpsM = 2, kWarpsN = 2;
constexpr int kWM = kBM / kWarpsM, kWN = kBN / kWarpsN;  // a warp's output tile, 64 x 64
constexpr int kMI = kWM / 16, kNI = kWN / 8;              // its mma tiles of 16 x 8
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMinCtas = 2;          // CTAs per SM: up to 255 registers a thread
constexpr int kStages = 3;
constexpr int kLdMK = kBK + 4;       // [m][k] tile pitch (dx's A)
constexpr int kLdKN = kBN + 8;       // [k][m] or [k][n] tile pitch (dW's A, both B)
constexpr int kAFloats = kBM * kLdMK;  // >= kBK * kLdKN, dW's A
constexpr int kBFloats = kBK * kLdKN;
constexpr int kStageFloats = kAFloats + kBFloats;
constexpr int kSmemBytes = kStages * kStageFloats * 4;  // 107,520: two CTAs fit an SM
constexpr int kMaxK = 2304;          // the most K a tile accumulates: dx's K at Co = 256
// Loader geometry: an [m][k] tile row is 8 copies of 16 bytes, a [k][*] row 32.
constexpr int kRowsMK = kThreads / 8, kItMK = kBM / kRowsMK;
constexpr int kRowsKN = kThreads / 32, kItKN = kBK / kRowsKN;
static_assert(kBK * kLdKN <= kAFloats, "dW's A tile fits the A slot");

struct Map {
  int B, H, W, C, Co;
};

__host__ __device__ inline int npix(const Map& g) { return g.B * g.H * g.W; }
__host__ __device__ inline int dx_splits(const Map& g) { return (9 * g.Co + kMaxK - 1) / kMaxK; }
inline int dx_tiles(const Map& g) { return (npix(g) + kBM - 1) / kBM * (g.C / kBN) * dx_splits(g); }
__host__ __device__ inline int dw_chunks(const Map& g) { return (npix(g) + kMaxK - 1) / kMaxK; }
inline int dw_tiles(const Map& g) { return 9 * g.C / kBM * (g.Co / kBN) * dw_chunks(g); }
// Scratch floats: dW's partials, then dx's where it is split.
inline size_t part_floats(const Map& g) {
  const int s = dx_splits(g);
  return (size_t)dw_chunks(g) * 9 * g.C * g.Co + (s > 1 ? (size_t)s * npix(g) * g.C : 0);
}

// -------------------------------------------------------------- primitives

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// TF32 of v rounded to nearest, ties away from zero: cvt.rna.tf32.f32, which
// ptxas expands into compares and selects on sm_90, as two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
// v = big + small to within fp32's last bits, each a TF32 value.
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The four values (rc0 + g, k0 + t), (rc0 + 8 + g, k0 + t), (rc0 + g, k0 + 4 + t),
// (rc0 + 8 + g, k0 + 4 + t) of a tile, g = lane / 4, t = lane % 4: an A
// fragment of m16n8k8 (rows m), or the B fragments of two n8 tiles (rows n:
// b[0] = {v0, v2}, b[1] = {v1, v3}). kKRows: the tile is [row][k] (pitch
// kLdMK), else [k][row] (pitch kLdKN).
template <bool kKRows>
__device__ __forceinline__ void frag(const float* S, int rc0, int k0, int lane, float (&v)[4]) {
  if constexpr (kKRows) {
    const float* p = S + (rc0 + (lane >> 2)) * kLdMK + k0 + (lane & 3);
    v[0] = p[0];
    v[1] = p[8 * kLdMK];
    v[2] = p[4];
    v[3] = p[8 * kLdMK + 4];
  } else {
    const float* p = S + (k0 + (lane & 3)) * kLdKN + rc0 + (lane >> 2);
    v[0] = p[0];
    v[1] = p[8];
    v[2] = p[4 * kLdKN];
    v[3] = p[4 * kLdKN + 8];
  }
}

// acc += A * B over one ring stage (K = 32) in 3xTF32: small*big, big*small,
// big*big into the fp32 accumulator. B is [k][n]; kMK: A is [m][k] (dx's dy
// rows), else [k][m] (dW's x rows); kRelu: A is relu(A).
template <bool kMK, bool kRelu>
__device__ __forceinline__ void mma_stage(const float* As, const float* Bs,
                                          float (&acc)[kMI][kNI][4], int wm, int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    uint32_t bh[kNI][2], bl[kNI][2];
#pragma unroll
    for (int nj = 0; nj < kNI; nj += 2) {
      float v[4];
      frag<false>(Bs, wn * kWN + nj * 8, kk, lane, v);
      split(v[0], bh[nj][0], bl[nj][0]);
      split(v[2], bh[nj][1], bl[nj][1]);
      split(v[1], bh[nj + 1][0], bl[nj + 1][0]);
      split(v[3], bh[nj + 1][1], bl[nj + 1][1]);
    }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      float v[4];
      frag<kMK>(As, wm * kWM + mi * 16, kk, lane, v);
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(kRelu ? fmaxf(v[i], 0.f) : v[i], ah[i], al[i]);
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        mma_tf32(acc[mi][ni], al, bh[ni]);
        mma_tf32(acc[mi][ni], ah, bl[ni]);
        mma_tf32(acc[mi][ni], ah, bh[ni]);
      }
    }
  }
}

// The ring: stage s of the K loop's blocks kb = 0 .. nk-1. load(stage, kb)
// starts block kb's copies into stage `stage`, in increasing kb.
template <bool kMK, bool kRelu, class Load>
__device__ __forceinline__ void gemm_ring(float* smem, int nk, Load&& load,
                                          float (&acc)[kMI][kNI][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait<kStages - 2>();  // block kb has landed, for this thread's copies
    __syncthreads();               // ... and everyone's; stage (kb - 1) % kStages is free
    const int next = kb + kStages - 1;
    if (next < nk) load(next % kStages, next);
    cp_async_commit();
    const float* st = smem + (kb % kStages) * kStageFloats;
    mma_stage<kMK, kRelu>(st, st + kAFloats, acc, wm, wn, lane);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------- dx
// Tile (split s, m, n): pixels m*128 .., channels n*128 .., the s-th part of
// K; dy [B*H*W, Co], wt [9*Co, C], x and dx [B*H*W, C]. With one part the
// tile writes dx; else its partial goes to dx_part [splits, B*H*W, C].
template <bool kRelu>
__device__ __forceinline__ void dx_tile(const float* __restrict__ dy, const float* __restrict__ wt,
                                        const float* __restrict__ x, float* __restrict__ dx,
                                        float* __restrict__ dx_part, const Map& g, int tile,
                                        float* smem) {
  const int tid = threadIdx.x, np = npix(g), hw = g.H * g.W;
  const int n_mn = (np + kBM - 1) / kBM * (g.C / kBN), split = tile / n_mn, mn = tile % n_mn;
  const int m0 = mn / (g.C / kBN) * kBM, n0 = mn % (g.C / kBN) * kBN;
  const int splits = dx_splits(g), nkb = 9 * g.Co / kBK, per = (nkb + splits - 1) / splits;
  const int kb0 = split * per, nk = min(nkb, kb0 + per) - kb0;
  // A: rows a_row + kRowsMK i, 16 bytes at column a_col; a pixel past the
  // edge gets h = -4, so that every tap of it is outside the map (zero-filled).
  const int a_row = tid >> 3, a_col = (tid & 7) * 4;
  int ah[kItMK], aw[kItMK];
#pragma unroll
  for (int i = 0; i < kItMK; ++i) {
    const int pix = m0 + a_row + kRowsMK * i, r = pix % hw;
    ah[i] = pix < np ? r / g.W : -4;
    aw[i] = r % g.W;
  }
  // B: rows b_row + kRowsKN i, 16 bytes at column b_col.
  const int b_row = tid >> 5, b_col = (tid & 31) * 4;
  const int blocks_per_tap = g.Co / kBK;

  auto load = [&](int stage, int kb_in_split) {
    float* As = smem + stage * kStageFloats;
    float* Bs = As + kAFloats;
    const int kb = kb0 + kb_in_split;
    const int tap = kb / blocks_per_tap, co0 = (kb - tap * blocks_per_tap) * kBK;
    const int sh = 1 - tap / 3, sw = 1 - tap % 3;  // source pixel = (h + sh, w + sw)
    const int shift = sh * g.W + sw;
#pragma unroll
    for (int i = 0; i < kItMK; ++i) {
      const int h = ah[i] + sh, w = aw[i] + sw;
      const bool ok = h >= 0 && h < g.H && w >= 0 && w < g.W;
      const int src = m0 + a_row + kRowsMK * i + shift;
      cp_async16(As + (a_row + kRowsMK * i) * kLdMK + a_col,
                 ok ? dy + (size_t)src * g.Co + co0 + a_col : dy, ok);
    }
#pragma unroll
    for (int i = 0; i < kItKN; ++i) {
      const int k = b_row + kRowsKN * i;
      cp_async16(Bs + k * kLdKN + b_col, wt + (size_t)(kb * kBK + k) * g.C + n0 + b_col, true);
    }
  };

  float acc[kMI][kNI][4];
  gemm_ring<true, false>(smem, nk, load, acc);

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * kWM + mi * 16 + gq + 8 * half;
      if (row >= np) continue;  // the ragged edge
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const size_t off = (size_t)row * g.C + n0 + wn * kWN + ni * 8 + 2 * tq;
        float2 v = make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
        if (splits > 1) {
          *reinterpret_cast<float2*>(dx_part + (size_t)split * np * g.C + off) = v;
          continue;
        }
        if constexpr (kRelu) {  // relu'(x): dx is exactly 0 where x <= 0
          const float2 xv = *reinterpret_cast<const float2*>(x + off);
          v.x = xv.x > 0.f ? v.x : 0.f;
          v.y = xv.y > 0.f ? v.y : 0.f;
        }
        *reinterpret_cast<float2*>(dx + off) = v;
      }
    }
  }
}

// ---------------------------------------------------------------------- dW
// Tile (chunk z, m, n): rows m*128 .. of [9*C] (one tap: C % 128 == 0),
// columns n*128 .. of Co, K = the chunk's pixels. x [B*H*W, C], dy
// [B*H*W, Co]; part [chunks, 9*C, Co] receives the chunk's product.
template <bool kRelu>
__device__ __forceinline__ void dw_tile(const float* __restrict__ x, const float* __restrict__ dy,
                                        float* __restrict__ part, const Map& g, int tile,
                                        float* smem) {
  const int tid = threadIdx.x, np = npix(g), hw = g.H * g.W;
  const int n_m = 9 * g.C / kBM, n_n = g.Co / kBN;
  const int z = tile / (n_m * n_n), mn = tile % (n_m * n_n);
  const int m0 = mn / n_n * kBM, n0 = mn % n_n * kBN;
  const int tap = m0 / g.C, ci0 = m0 % g.C;
  const int di = tap / 3 - 1, dj = tap % 3 - 1;  // source pixel = (h + di, w + dj)
  const int shift = di * g.W + dj;
  const int p_begin = z * kMaxK, p_end = min(np, p_begin + kMaxK);
  // Both operands: pixel rows k_row + kRowsKN i of the block, 16 bytes at
  // column col; (h, w) of each row's pixel, advanced by 32 pixels a block.
  const int k_row = tid >> 5, col = (tid & 31) * 4;
  int ph[kItKN], pw[kItKN];
#pragma unroll
  for (int i = 0; i < kItKN; ++i) {
    const int r = (p_begin + k_row + kRowsKN * i) % hw;
    ph[i] = r / g.W;
    pw[i] = r % g.W;
  }

  auto load = [&](int stage, int kb) {
    float* As = smem + stage * kStageFloats;
    float* Bs = As + kAFloats;
#pragma unroll
    for (int i = 0; i < kItKN; ++i) {
      const int k = k_row + kRowsKN * i, p = p_begin + kb * kBK + k;
      const bool in = p < p_end;  // the chunk's (and the map's) ragged edge
      const int h = ph[i] + di, w = pw[i] + dj;
      const bool ok = in && h >= 0 && h < g.H && w >= 0 && w < g.W;
      cp_async16(As + k * kLdKN + col, ok ? x + (size_t)(p + shift) * g.C + ci0 + col : x, ok);
      cp_async16(Bs + k * kLdKN + col, in ? dy + (size_t)p * g.Co + n0 + col : dy, in);
      pw[i] += kBK;
      while (pw[i] >= g.W) {
        pw[i] -= g.W;
        ++ph[i];
      }
      while (ph[i] >= g.H) ph[i] -= g.H;
    }
  };

  float acc[kMI][kNI][4];
  gemm_ring<false, kRelu>(smem, (p_end - p_begin + kBK - 1) / kBK, load, acc);

  float* out = part + (size_t)z * 9 * g.C * g.Co;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t row = (size_t)(m0 + wm * kWM + mi * 16 + gq + 8 * half) * g.Co;
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
        *reinterpret_cast<float2*>(out + row + n0 + wn * kWN + ni * 8 + 2 * tq) =
            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
    }
}

// One launch for both products: blocks [0, dx_tiles) take dx, the rest dW.
// part: dW's partials [chunks, 9*C, Co], then dx's [splits, B*H*W, C].
template <bool kRelu>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    conv3x3_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                       const float* __restrict__ wt, float* __restrict__ dx,
                       float* __restrict__ part, Map g, int n_dx) {
  extern __shared__ __align__(16) float smem[];
  if ((int)blockIdx.x < n_dx)
    dx_tile<kRelu>(dy, wt, x, dx, part + (size_t)dw_chunks(g) * 9 * g.C * g.Co, g,
                   blockIdx.x, smem);
  else
    dw_tile<kRelu>(x, dy, part, g, blockIdx.x - n_dx, smem);
}

// out = the sum of n partials of n4 float4 each, added in order
// (deterministic); with kRelu, 0 where x <= 0 (dx's relu mask).
template <bool kRelu>
__global__ void reduce_kernel(const float4* __restrict__ part, const float4* __restrict__ x,
                              float4* __restrict__ out, size_t n4, int n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int c = 1; c < n; ++c) {
      const float4 v = part[(size_t)c * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if constexpr (kRelu) {
      const float4 xv = x[i];
      s.x = xv.x > 0.f ? s.x : 0.f;
      s.y = xv.y > 0.f ? s.y : 0.f;
      s.z = xv.z > 0.f ? s.z : 0.f;
      s.w = xv.w > 0.f ? s.w : 0.f;
    }
    out[i] = s;
  }
}

template <bool kRelu>
inline cudaError_t reduce(const float* part, const float* x, float* out, size_t n, int parts,
                          cudaStream_t st) {
  const size_t n4 = n / 4;
  const int blocks = (int)std::min<size_t>((n4 + 255) / 256, 4096);
  reduce_kernel<kRelu><<<blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(part),
                                               reinterpret_cast<const float4*>(x),
                                               reinterpret_cast<float4*>(out), n4, parts);
  return cudaGetLastError();
}

// Lets the kernel take kSmemBytes of dynamic shared memory (above the 48 KB
// default) and asks for the largest shared-memory carveout, so kMinCtas fit.
template <bool kRelu>
inline cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_bwd_kernel<kRelu>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(conv3x3_bwd_kernel<kRelu>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// CTAs of conv3x3_bwd_kernel<kRelu> resident per SM (0 on an error).
template <bool kRelu>
inline int ctas_per_sm() {
  int n = 0;
  if (set_smem<kRelu>() != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv3x3_bwd_kernel<kRelu>, kThreads,
                                                    kSmemBytes) != cudaSuccess)
    return 0;
  return n;
}

template <bool kRelu>
inline cudaError_t launch_core(const float* x, const float* dy, const float* wt, float* dx,
                               float* part, const Map& g, cudaStream_t st) {
  cudaError_t err = set_smem<kRelu>();
  if (err != cudaSuccess) return err;
  const int n_dx = dx_tiles(g);
  conv3x3_bwd_kernel<kRelu><<<n_dx + dw_tiles(g), kThreads, kSmemBytes, st>>>(x, dy, wt, dx, part,
                                                                             g, n_dx);
  return cudaGetLastError();
}

// dx and dW of one conv; part: scratch of part_floats(g) floats. Needs C and
// Co multiples of 128; any B*H*W. Returns cudaGetLastError() after the launches.
inline cudaError_t conv3x3_bwd_launch(const float* x, const float* dy, const float* wt, float* dx,
                                      float* dw, float* part, const Map& g, bool relu,
                                      cudaStream_t st) {
  cudaError_t err = relu ? launch_core<true>(x, dy, wt, dx, part, g, st)
                         : launch_core<false>(x, dy, wt, dx, part, g, st);
  if (err != cudaSuccess) return err;
  const size_t n_dw = (size_t)9 * g.C * g.Co;
  err = reduce<false>(part, nullptr, dw, n_dw, dw_chunks(g), st);
  if (err != cudaSuccess || dx_splits(g) == 1) return err;
  const float* dx_part = part + dw_chunks(g) * n_dw;
  const size_t n_dx = (size_t)npix(g) * g.C;
  return relu ? reduce<true>(dx_part, x, dx, n_dx, dx_splits(g), st)
              : reduce<false>(dx_part, x, dx, n_dx, dx_splits(g), st);
}

}  // namespace msig_f32
