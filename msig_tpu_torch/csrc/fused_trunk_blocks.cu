// The whole residual trunk in one launch: N AdaIN resblocks (conv1 -> IN ->
// AdaIN -> ReLU -> requant; conv2 -> IN -> AdaIN -> + residual -> requant),
// int8 NHWC [B, H, W, C] in and out, with the residual's per-sample scale.
//
// Replaces the TPU kernel msig_tpu/ops/fused_trunk_v3.py::fused_trunk_blocks,
// which runs one sample per program and keeps its residual slabs, conv1's
// output and both int32 accumulators in VMEM for all 2N sites. Its numbers
// differ from the per-site chain in two places, and this kernel follows the
// TPU kernel: conv1's requant scale comes from the true per-channel extremes
// (not the zero-masked ones), and the requant is unfolded,
// round(max(y*a + d, 0) * s) (conv_int8.cuh: true_relu_amax,
// relu_requant_unfolded). Its statistics are exact integers, as at every site
// of the port, where the TPU kernel sums fp32 over 16-row chunks.
//
// One SM cannot hold a sample (4 MB of int32 per conv at the 64-grid), so the
// trunk is one persistent cooperative launch on all SMs that walks the 2N
// sites with grid-wide barriers between five phases per block:
//   1. conv1 pass A: conv_tile over a grid-stride tile index, true extremes;
//   2. conv1 epilogue: int32 -> int8 y1 (per sample: affine, amax, requant);
//   3. conv2 pass A on y1;
//   4. conv2 max|hn| per sample (float atomicMax on the bits);
//   5. conv2 requant into the other residual map; hs <- amax/127.
// The int32 accumulator (32 MB at B = 8) and the int8 maps stay in device
// memory, mostly in the 50 MB L2; data written earlier in the launch is read
// with ld.global.cg, past the non-coherent L1.
//
// Bound on an H100 at [8, 64, 64, 256], N = 8: 16 convs of 38.7 G int8
// operations, 0.31 ms at 1,979 TOP/s; operations bound it. This design keeps
// mma.sync and the int32 round trip of the per-site kernels and only removes
// the 32-48 launches and the host gaps between them.
#include <cooperative_groups.h>

#include "conv_int8.cuh"

namespace cg = cooperative_groups;

namespace msig {

struct TrunkArgs {
  const int8_t* x;        // [B, H, W, C] block 0's input
  const float* h_scale;   // [B] its scale
  const int8_t* w;        // [2N * 9C, C] site-major packed weights
  const float* gammas;    // [2N, B, C]
  const float* betas;     // [2N, B, C]
  int32_t* y;             // [B, H*W, C] accumulator scratch
  long long* stats;       // 2N statistics blocks of kStatLen(B, C)
  int8_t* y1;             // [B, H, W, C] conv1's output
  int8_t* h_a;            // [B, H, W, C] residual ping-pong map
  int8_t* out;            // [B, H, W, C] the last block's output
  float* out_scale;       // [B]
  int B, H, W, C, n_blocks;
  float eps;
};

__host__ __device__ inline size_t stat_len(int B, int C) {
  return (size_t)kStatBlocks * B * C + B;
}

__global__ void __launch_bounds__(kConvThreads) fused_trunk_kernel(TrunkArgs p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sh[];  // a[C], d[C]
  __shared__ float red[32];
  float* a_s = sh;
  float* d_s = sh + p.C;
  const int B = p.B, C = p.C, HW = p.H * p.W;
  const size_t BC = (size_t)B * C, SL = stat_len(B, C);
  const int m_tiles = B * (HW / kBM), tiles = m_tiles * (C / 128);
  const size_t n4 = (size_t)HW * C / 4;
  const size_t t0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const int8_t* src = p.x;

  for (int blk = 0; blk < p.n_blocks; ++blk) {
    // The last block writes out; before it, blocks alternate with h_a, so no
    // block reads the map it writes.
    int8_t* dst = ((p.n_blocks - 1 - blk) % 2 == 0) ? p.out : p.h_a;
    long long* st1 = p.stats + (size_t)(2 * blk) * SL;
    long long* st2 = st1 + SL;
    const int8_t* w1 = p.w + (size_t)(2 * blk) * 9 * C * C;
    const int8_t* w2 = w1 + (size_t)9 * C * C;
    const float* g1 = p.gammas + (size_t)(2 * blk) * BC;
    const float* b1 = p.betas + (size_t)(2 * blk) * BC;
    const float* g2 = g1 + BC;
    const float* b2 = b1 + BC;

    // 1. conv1 pass A.
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      conv_tile<Conv3x3Geom, 128, int32_t, true, true>(src, w1, p.y, st1, B, p.H, p.W, C, C,
                                                       t % m_tiles, t / m_tiles);
    grid.sync();

    // 2. conv1 epilogue, sample by sample.
    for (int b = 0; b < B; ++b) {
      channel_affine<true>(st1, g1, b1, b, B, C, HW, p.eps, a_s, d_s);
      __syncthreads();
      const float amax = true_relu_amax<true>(st1, a_s, d_s, b, B, C, red);
      const float s = amax > 0.f ? __fdiv_rn(127.f, amax) : 1.f;
      const int4* y4 = reinterpret_cast<const int4*>(p.y + (size_t)b * HW * C);
      char4* o4 = reinterpret_cast<char4*>(p.y1 + (size_t)b * HW * C);
      for (size_t i = t0; i < n4; i += stride) {
        const int4 v = __ldcg(y4 + i);
        const int c = (int)((i * 4) % C);
        o4[i] = make_char4(relu_requant_unfolded((float)v.x, a_s[c], d_s[c], s),
                           relu_requant_unfolded((float)v.y, a_s[c + 1], d_s[c + 1], s),
                           relu_requant_unfolded((float)v.z, a_s[c + 2], d_s[c + 2], s),
                           relu_requant_unfolded((float)v.w, a_s[c + 3], d_s[c + 3], s));
      }
      __syncthreads();  // a_s, d_s are rewritten for the next sample
    }
    grid.sync();

    // 3. conv2 pass A on y1.
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      conv_tile<Conv3x3Geom, 128, int32_t, true, true>(p.y1, w2, p.y, st2, B, p.H, p.W, C, C,
                                                       t % m_tiles, t / m_tiles);
    grid.sync();

    // 4. max |hn| per sample. The residual's scale: the input's for block 0,
    // else amax/127 of the block before (1 where that amax was 0).
    const long long* st_prev = blk == 0 ? nullptr : st1 - SL;
    for (int b = 0; b < B; ++b) {
      channel_affine<true>(st2, g2, b2, b, B, C, HW, p.eps, a_s, d_s);
      __syncthreads();
      float hs = p.h_scale[b];
      if (st_prev != nullptr) {
        const float am = __uint_as_float((unsigned int)__ldcg(&st_prev[kStatBlocks * BC + b]));
        hs = am > 0.f ? __fdiv_rn(am, 127.f) : 1.f;
      }
      const int4* y4 = reinterpret_cast<const int4*>(p.y + (size_t)b * HW * C);
      const char4* h4 = reinterpret_cast<const char4*>(src + (size_t)b * HW * C);
      float local = 0.f;
      for (size_t i = t0; i < n4; i += stride) {
        const int4 v = __ldcg(y4 + i);
        const char4 r = __ldcg(h4 + i);
        const int c = (int)((i * 4) % C);
        local = fmaxf(local, fabsf(residual_hn(v.x, r.x, a_s[c], d_s[c], hs)));
        local = fmaxf(local, fabsf(residual_hn(v.y, r.y, a_s[c + 1], d_s[c + 1], hs)));
        local = fmaxf(local, fabsf(residual_hn(v.z, r.z, a_s[c + 2], d_s[c + 2], hs)));
        local = fmaxf(local, fabsf(residual_hn(v.w, r.w, a_s[c + 3], d_s[c + 3], hs)));
      }
      const float m = block_max(local, red);
      if (threadIdx.x == 0) store_amax(st2, B, C, b, m);
    }
    grid.sync();

    // 5. conv2 requant into dst.
    for (int b = 0; b < B; ++b) {
      channel_affine<true>(st2, g2, b2, b, B, C, HW, p.eps, a_s, d_s);
      __syncthreads();
      float hs = p.h_scale[b];
      if (st_prev != nullptr) {
        const float am = __uint_as_float((unsigned int)__ldcg(&st_prev[kStatBlocks * BC + b]));
        hs = am > 0.f ? __fdiv_rn(am, 127.f) : 1.f;
      }
      const float amax = __uint_as_float((unsigned int)__ldcg(&st2[kStatBlocks * BC + b]));
      const float s = amax > 0.f ? __fdiv_rn(127.f, amax) : 1.f;
      if (blk == p.n_blocks - 1 && blockIdx.x == 0 && threadIdx.x == 0)
        p.out_scale[b] = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
      const int4* y4 = reinterpret_cast<const int4*>(p.y + (size_t)b * HW * C);
      const char4* h4 = reinterpret_cast<const char4*>(src + (size_t)b * HW * C);
      char4* o4 = reinterpret_cast<char4*>(dst + (size_t)b * HW * C);
      for (size_t i = t0; i < n4; i += stride) {
        const int4 v = __ldcg(y4 + i);
        const char4 r = __ldcg(h4 + i);
        const int c = (int)((i * 4) % C);
        const int vals[4] = {v.x, v.y, v.z, v.w};
        const signed char res[4] = {r.x, r.y, r.z, r.w};
        signed char q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float t = __fmul_rn(residual_hn(vals[k], res[k], a_s[c + k], d_s[c + k], hs), s);
          q[k] = (signed char)__float2int_rn(fminf(fmaxf(t, -127.f), 127.f));
        }
        o4[i] = make_char4(q[0], q[1], q[2], q[3]);
      }
      __syncthreads();
    }
    grid.sync();
    src = dst;
  }
}

}  // namespace msig

// Returns the CUDA error of the launch (0 = success); a grid that cannot be
// co-resident fails with cudaErrorCooperativeLaunchTooLarge. Launches on
// `stream` and does not synchronise. Sizes as in TrunkArgs; stats: int64
// [2N * (5*B*C + B)], in each site's block blocks 0, 1, 4 and the amax slots
// zeroed, block 2 set to INT64_MAX and block 3 to INT64_MIN. Needs
// C % 128 == 0 and H*W % 128 == 0. *grid_out gets the number of CTAs.
extern "C" int msig_fused_trunk_blocks(const void* x, const void* h_scale, const void* w,
                                       const void* gammas, const void* betas, void* y_scratch,
                                       void* stats, void* y1, void* h_a, void* out,
                                       void* out_scale, int B, int H, int W, int C, int n_blocks,
                                       float eps, void* stream, int* grid_out) {
  using namespace msig;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = 2 * C * sizeof(float);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_trunk_kernel, kConvThreads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  TrunkArgs p{static_cast<const int8_t*>(x), static_cast<const float*>(h_scale),
              static_cast<const int8_t*>(w), static_cast<const float*>(gammas),
              static_cast<const float*>(betas), static_cast<int32_t*>(y_scratch),
              static_cast<long long*>(stats), static_cast<int8_t*>(y1),
              static_cast<int8_t*>(h_a), static_cast<int8_t*>(out),
              static_cast<float*>(out_scale), B, H, W, C, n_blocks, eps};
  void* args[] = {&p};
  const dim3 grid(per_sm * sms);
  *grid_out = (int)grid.x;
  err = cudaLaunchCooperativeKernel((const void*)fused_trunk_kernel, grid, dim3(kConvThreads), args,
                                    smem, reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
