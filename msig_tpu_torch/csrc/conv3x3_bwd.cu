// dx and dW of a 3x3 stride-1 SAME conv in fp32 on dense NHWC, optionally
// with the ReLU of its input folded in (dx masked by x > 0, dW on relu(x)).
//
// Replaces the TPU kernel msig_tpu/ops/conv3x3_vjp.py::conv3x3_bwd
// (_bwd_kernel -> _conv_bwd_core), the fused backward of conv3x3_same and
// relu_conv3x3 at MSIG_CONV_VJP=1, in its two configurations:
//  - fp32 (msig_conv3x3_bwd): bound on an H100 at [8, 64, 64, 256] 77.3 GFLOP,
//    0.47 ms as three TF32 tensor-core passes (1.15 ms at the fp32 FMA rate of
//    the CUDA cores, which the first version used). Design (conv3x3_bwd.cuh):
//    both products as 3xTF32 implicit GEMMs on mma.sync in one launch,
//    operands through a 3-stage cp.async ring, then the in-order reduction of
//    the partials;
//  - bf16 operands, fp32 accumulation (msig_conv3x3_bwd_bf16, the JAX
//    package's bf16 train step): the same 77.3 GFLOP at dense bf16, 0.078 ms.
//    Design (conv3x3_bwd_bf16.cuh): wgmma on operands in shared memory fed
//    by a producer warpgroup, a persistent grid over dx and dW tiles, dW's
//    K in at most 8 chunks added in order.
#include "conv3x3_bwd.cuh"
#include "conv3x3_bwd_bf16.cuh"

// x, dy: [B, H, W, C] and [B, H, W, Co] fp32; wt: the taps transposed, [9, Co, C];
// dx: [B, H, W, C]; dw: [9, C, Co] (HWIO); part: scratch of
// ceil(B*H*W / 2304) * 9*C*Co floats, plus ceil(9*Co / 2304) * B*H*W*C where
// 9*Co > 2304. Needs C and Co multiples of 128; any B*H*W.
// Returns cudaGetLastError() (0 = success); launches on `stream`, does not synchronise.
extern "C" int msig_conv3x3_bwd(const void* x, const void* dy, const void* wt, void* dx, void* dw,
                                void* part, int B, int H, int W, int C, int Co, int relu,
                                void* stream) {
  const msig_f32::Map g{B, H, W, C, Co};
  return (int)msig_f32::conv3x3_bwd_launch(
      static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<const float*>(wt),
      static_cast<float*>(dx), static_cast<float*>(dw), static_cast<float*>(part), g, relu != 0,
      reinterpret_cast<cudaStream_t>(stream));
}

// As msig_conv3x3_bwd with x and dy in bf16, the taps w in bf16 as they are
// (HWIO, [9, C, Co], dense), and dx written in bf16; dw and part fp32, part
// of msig_bf16::part_floats floats (ops/conv3x3_vjp.py::scratch_floats).
extern "C" int msig_conv3x3_bwd_bf16(const void* x, const void* dy, const void* w, void* dx,
                                     void* dw, void* part, int B, int H, int W, int C, int Co,
                                     int relu, void* stream) {
  using msig_bf16::bf16;
  const msig_f32::Map g{B, H, W, C, Co};
  return (int)msig_bf16::conv3x3_bwd_launch(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<const bf16*>(w),
      static_cast<bf16*>(dx), static_cast<float*>(dw), static_cast<float*>(part), g, relu != 0,
      reinterpret_cast<cudaStream_t>(stream));
}

// The core's configuration, into out[0 .. 8]: tile M, N, K per stage, ring
// stages, threads, the most K a tile accumulates (dW's chunk of pixels),
// dynamic shared memory (bytes), and the CTAs resident per SM without and with
// the relu input (occupancy API).
// Returns 0, or the CUDA error of the queries.
extern "C" int msig_conv3x3_bwd_config(int* out) {
  using namespace msig_f32;
  const int v[9] = {kBM, kBN, kBK, kStages, kThreads, kMaxK, kSmemBytes, ctas_per_sm<false>(),
                    ctas_per_sm<true>()};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return (int)cudaGetLastError();
}

// The bf16 core's configuration, into out[0 .. 13]: of its kernel at the
// trunk's tile and loads (BN = 256: C and Co multiples of 256; TMA) tile M,
// N, K per stage, ring stages, threads, dynamic shared memory (bytes), the
// CTAs resident per SM (occupancy API), the producer's and the consumers'
// registers after setmaxnreg, the kernel's registers as compiled; the most
// chunks of dW's K and the most pixels a chunk (the limit that can add
// chunks); the ring stages at BN = 128, and the fewest registers
// any of its four kernels (BN 256 or 128, TMA or cp.async) was compiled to.
// Returns 0, or the CUDA error of the queries.
extern "C" int msig_conv3x3_bwd_bf16_config(int* out) {
  using namespace msig_bf16;
  const int regs[4] = {kernel_regs<256, true>(), kernel_regs<256, false>(),
                       kernel_regs<128, true>(), kernel_regs<128, false>()};
  const int least = std::min(std::min(regs[0], regs[1]), std::min(regs[2], regs[3]));
  const int v[14] = {kBM, 256, kBK, Layout<256>::kStages, kThreads, Layout<256>::kSmemBytes,
                     ctas_per_sm<256, true>(), kProducerRegs, kConsumerRegs, regs[0],
                     kMaxChunks, kMaxChunkPixels, Layout<128>::kStages, least};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return (int)cudaGetLastError();
}
