// Backward of the resblock unit z = gamma * IN(conv3x3([relu](x), W)) + beta
// in fp32 on dense NHWC: dx, dW, dgamma and dbeta from the saved conv output
// y, its IN statistics (mu, r) and the cotangent g of z.
//
// Replaces the TPU kernel msig_tpu/ops/conv3x3_vjp.py::conv3x3_adain_bwd
// (_bwd_adain_kernel, MSIG_CONV_VJP=2), which holds one image in VMEM: it
// reduces sg = sum(g) and sgy = sum(g * yhat), yhat = (y - mu) * r, over the
// image, forms dy = gamma * r * (g - sg/N - yhat * sgy/N) into its padded
// slab, and runs the conv backward core on it; dgamma = sgy, dbeta = sg.
//
// Here the per-(sample, channel) sums need the whole image before any dy
// exists, which on the card is a reduction across CTAs. So the IN backward
// runs first as in_norm.cuh's in_bwd_kernel (a thread-block cluster per
// sample and 32 channels, the same launch as adain_pallas's backward, whose
// bits it gives), which writes dy to a device scratch; then the conv
// backward core of conv3x3_bwd.cuh runs on that dy: dx and dW as 3xTF32
// implicit GEMMs on mma.sync, operands through a 3-stage cp.async ring, dW's
// partials added in chunk order. Bound on an H100 at [8, 64, 64, 256]: the conv's 77.3 GFLOP as
// three TF32 passes, 0.47 ms (1.15 ms at the fp32 FMA rate), plus the IN's
// ~8 flops an element; the function's bytes (x, y, g read, dx written) are
// 134 MB, 0.04 ms. The dy scratch costs 33.6 MB written and read back:
// forming dy in the core's loaders would remove it (chip_smoke.py times the
// IN part alone).
//
// The bf16 configuration (msig_conv3x3_adain_bwd_bf16, the JAX package's bf16
// train step): x, y, g and the taps in bf16. The IN backward runs as
// in_bwd_kernel<bf16> and writes dy to a bf16 scratch, the rounding point of
// the TPU kernel's slab (dyp_ref is in x's type); then the bf16 core of
// conv3x3_bwd_bf16.cuh runs on it (wgmma, a producer warpgroup, a persistent
// grid over dx and dW tiles), bound by the conv's 77.3 GFLOP at dense bf16,
// 0.078 ms. dW, dgamma and dbeta stay fp32.
#include "conv3x3_bwd.cuh"
#include "conv3x3_bwd_bf16.cuh"
#include "in_norm.cuh"

// x [B, H, W, C], y and g [B, H, W, Co] fp32; mu, r, gamma [B, Co] fp32; wt
// [9, Co, C]; outputs dx [B, H, W, C], dw [9, C, Co], dgamma and dbeta
// [B, Co]; dy_scratch [B, H, W, Co]; part as for msig_conv3x3_bwd; R: the
// IN backward's cluster size (ops/adain_pallas.py::plan at S = H*W).
// Returns cudaGetLastError() (0 = success); launches on `stream`, does not synchronise.
extern "C" int msig_conv3x3_adain_bwd(const void* x, const void* y, const void* g, const void* mu,
                                      const void* r, const void* gamma, const void* wt, void* dx,
                                      void* dw, void* dgamma, void* dbeta, void* dy_scratch,
                                      void* part, int B, int H, int W, int C, int Co, int relu,
                                      int R, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int err = msig_in::in_bwd_launch<float>(y, g, mu, r, gamma, dy_scratch, dgamma, dbeta, B,
                                                H * W, Co, R, st);
  if (err != 0) return err;
  const msig_f32::Map geom{B, H, W, C, Co};
  return (int)msig_f32::conv3x3_bwd_launch(
      static_cast<const float*>(x), static_cast<const float*>(dy_scratch),
      static_cast<const float*>(wt), static_cast<float*>(dx), static_cast<float*>(dw),
      static_cast<float*>(part), geom, relu != 0, st);
}

// As msig_conv3x3_adain_bwd with x, y, g and dy_scratch in bf16, the taps w
// in bf16 as they are (HWIO, [9, C, Co], dense), and dx written in bf16; mu,
// r, gamma, dw, dgamma, dbeta and part fp32, part of msig_bf16::part_floats
// floats.
extern "C" int msig_conv3x3_adain_bwd_bf16(const void* x, const void* y, const void* g,
                                           const void* mu, const void* r, const void* gamma,
                                           const void* w, void* dx, void* dw, void* dgamma,
                                           void* dbeta, void* dy_scratch, void* part, int B, int H,
                                           int W, int C, int Co, int relu, int R, void* stream) {
  using msig_bf16::bf16;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int err = msig_in::in_bwd_launch<bf16>(y, g, mu, r, gamma, dy_scratch, dgamma, dbeta, B,
                                               H * W, Co, R, st);
  if (err != 0) return err;
  const msig_f32::Map geom{B, H, W, C, Co};
  return (int)msig_bf16::conv3x3_bwd_launch(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy_scratch),
      static_cast<const bf16*>(w), static_cast<bf16*>(dx), static_cast<float*>(dw),
      static_cast<float*>(part), geom, relu != 0, st);
}
