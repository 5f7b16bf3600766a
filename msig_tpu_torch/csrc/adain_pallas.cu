// Fused instance norm + AdaIN modulation, forward and backward, on dense NHWC
// [B, H*W, C] in fp32 or bf16 with fp32 statistics.
//
// Replaces the TPU kernels of msig_tpu/ops/adain_pallas.py: _call_fwd
// (_fwd_kernel: y = gamma * IN(x) + beta, saving mean and rstd) and _call_bwd
// (_bwd_kernel: dx, dgamma, dbeta from the saved statistics). The TPU grid is
// (B, C / 128) with a whole [S, 128] slab in VMEM per step.
//
// Bound on an H100 at the main path's shape [8, 64, 64, 256] fp32: bytes.
// The forward must read x and write y (67 MB, 0.020 ms at 3.35 TB/s), the
// backward read x and dy and write dx (101 MB, 0.030 ms); both do O(1)
// operations per byte. So the design spreads each slab over every SM: a
// thread-block cluster of R CTAs per (sample, 32 channels) splits its
// pixels, each CTA reduces its share and re-reads it from L2 in the later
// passes, while the cluster's statistics meet through distributed shared
// memory (in_norm.cuh; R from ops/adain_pallas.py::plan: at [8, 4096, 256]
// clusters of 8, 512 CTAs).
#include "in_norm.cuh"

// bf16: 0 for fp32 x and y, 1 for bf16. gamma, beta [B, C] fp32; mean, rstd
// [B, C] fp32 outputs. R: the cluster's CTAs. Returns the launch's CUDA
// error (0 = success); launches on `stream` and does not synchronise.
extern "C" int msig_adain_pallas_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                     void* mean, void* rstd, int B, int S, int C, float eps,
                                     int bf16, int R, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return bf16 ? msig_in::adain_fwd_launch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, B, S, C,
                                                         eps, R, st)
              : msig_in::adain_fwd_launch<float>(x, gamma, beta, y, mean, rstd, B, S, C, eps, R,
                                                 st);
}

// x and dy (and dx) in the same type; dgamma, dbeta [B, C] fp32 outputs.
extern "C" int msig_adain_pallas_bwd(const void* x, const void* dy, const void* mean,
                                     const void* rstd, const void* gamma, void* dx, void* dgamma,
                                     void* dbeta, int B, int S, int C, int bf16, int R,
                                     void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return bf16 ? msig_in::in_bwd_launch<__nv_bfloat16>(x, dy, mean, rstd, gamma, dx, dgamma, dbeta,
                                                      B, S, C, R, st)
              : msig_in::in_bwd_launch<float>(x, dy, mean, rstd, gamma, dx, dgamma, dbeta, B, S,
                                              C, R, st);
}

// cudaOccupancyMaxActiveClusters of the forward (bwd = 0) or backward's
// launch at cluster size R, into *clusters; nothing is launched. Returns the
// CUDA error of the query.
extern "C" int msig_adain_pallas_clusters(int bwd, int bf16, int S, int C, int R, int* clusters) {
  *clusters = 0;
  if (bwd)
    return bf16 ? msig_in::in_bwd_launch<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nullptr,
                                                        nullptr, nullptr, nullptr, 1, S, C, R,
                                                        nullptr, clusters)
                : msig_in::in_bwd_launch<float>(nullptr, nullptr, nullptr, nullptr, nullptr,
                                                nullptr, nullptr, nullptr, 1, S, C, R, nullptr,
                                                clusters);
  return bf16 ? msig_in::adain_fwd_launch<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr,
                                                         nullptr, nullptr, 1, S, C, 0.f, R,
                                                         nullptr, clusters)
              : msig_in::adain_fwd_launch<float>(nullptr, nullptr, nullptr, nullptr, nullptr,
                                                 nullptr, 1, S, C, 0.f, R, nullptr, clusters);
}
