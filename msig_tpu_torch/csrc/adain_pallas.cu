// Fused instance norm + AdaIN modulation, forward and backward, on dense NHWC
// [B, H*W, C] in fp32 or bf16 with fp32 statistics.
//
// Replaces the TPU kernels of msig_tpu/ops/adain_pallas.py: _call_fwd
// (_fwd_kernel: y = gamma * IN(x) + beta, saving mean and rstd) and _call_bwd
// (_bwd_kernel: dx, dgamma, dbeta from the saved statistics). The TPU grid is
// (B, C / 128) with a whole [S, 128] slab in VMEM per step; here a CTA takes
// (sample, 32 channels) and re-reads its slab from L2 for each pass
// (in_norm.cuh).
//
// Bound on an H100 at the main path's shape [8, 64, 64, 256] fp32: bytes.
// The forward must read x and write y (67 MB, 0.020 ms at 3.35 TB/s), the
// backward read x and dy and write dx (101 MB, 0.030 ms); both do O(1)
// operations per byte. This design runs 64 CTAs at B = 8 (32 at B = 4), fewer
// than the 132 SMs, and reads the slab two or three times; splitting the
// pixels over more CTAs with a cross-CTA reduction is left for a later pass.
#include "in_norm.cuh"

namespace {

template <typename T>
int fwd(const void* x, const void* gamma, const void* beta, void* y, void* mean, void* rstd,
        int B, int S, int C, float eps, cudaStream_t st) {
  msig_in::adain_fwd_kernel<T><<<msig_in::grid_of(B, C), msig_in::block_of(), 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<T*>(y), static_cast<float*>(mean), static_cast<float*>(rstd), S, C, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* dy, const void* mean, const void* rstd, const void* gamma,
        void* dx, void* dgamma, void* dbeta, int B, int S, int C, cudaStream_t st) {
  msig_in::in_bwd_kernel<T><<<msig_in::grid_of(B, C), msig_in::block_of(), 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(gamma), static_cast<T*>(dx),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), S, C);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16: 0 for fp32 x and y, 1 for bf16. gamma, beta [B, C] fp32; mean, rstd
// [B, C] fp32 outputs. Returns cudaGetLastError() (0 = success); launches on
// `stream` and does not synchronise.
extern "C" int msig_adain_pallas_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                     void* mean, void* rstd, int B, int S, int C, float eps,
                                     int bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return bf16 ? fwd<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, B, S, C, eps, st)
              : fwd<float>(x, gamma, beta, y, mean, rstd, B, S, C, eps, st);
}

// x and dy (and dx) in the same type; dgamma, dbeta [B, C] fp32 outputs.
extern "C" int msig_adain_pallas_bwd(const void* x, const void* dy, const void* mean,
                                     const void* rstd, const void* gamma, void* dx, void* dgamma,
                                     void* dbeta, int B, int S, int C, int bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return bf16 ? bwd<__nv_bfloat16>(x, dy, mean, rstd, gamma, dx, dgamma, dbeta, B, S, C, st)
              : bwd<float>(x, dy, mean, rstd, gamma, dx, dgamma, dbeta, B, S, C, st);
}
