// dx and dW of a 3x3 stride-1 SAME conv in fp32 on dense NHWC, optionally
// with the ReLU of its input folded in (dx masked by x > 0, dW on relu(x)).
//
// Replaces the TPU kernel msig_tpu/ops/conv3x3_vjp.py::conv3x3_bwd
// (_bwd_kernel -> _conv_bwd_core), the fused backward of conv3x3_same and
// relu_conv3x3 at MSIG_CONV_VJP=1. Design and bound: conv3x3_bwd.cuh.
#include "conv3x3_bwd.cuh"

// x, dy: [B, H, W, C] and [B, H, W, Co] fp32; wt: the taps transposed, [9, Co, C];
// dx: [B, H, W, C]; dw: [9, C, Co] (HWIO); part: scratch of
// ceil(B*H*W / 2048) * 9*C*Co floats. Needs B*H*W, C and Co multiples of 128.
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
