// Instance norm + modulation over dense NHWC maps [B, S, C] (S = H*W), fp32
// statistics, forward and backward (sm_90a), each (sample, 32-channel group)
// on one thread-block cluster. Element type T: float or bf16.
//
// The TPU kernel (msig_tpu/ops/adain_pallas.py) keeps one [S, 128] slab in
// VMEM while it reduces and then normalises it. One CTA per slab leaves most
// of the 132 SMs idle (64 CTAs at B = 8). Here R CTAs of a cluster (at most
// 8, the portable size) split the S pixels: each reduces its share of the
// slab, the R partial sums meet through distributed shared memory, and each
// pass after the first reads the share again, from L2 (a share of [512, 32]
// fp32 is 64 KB; the slab of a cluster 512 KB). Holding the share in shared
// memory instead, or clusters of 16, measured no faster on an H100
// (PERF.md, row 22's variants): the kernels move 1.7-1.8 TB/s however they
// are cut. ops/adain_pallas.py::plan chooses R from the shape; the
// launchers take it.
//
// Summation order, fixed: each thread adds its pixel rows in order; a CTA's
// kSlots rows of threads are added in slot order; the R CTAs' partials in
// rank order 0..R-1 by every CTA of the cluster, so all CTAs hold the same
// bits and a second call gives the same bits as the first.
//
// Forward (the TPU kernel's _fwd_kernel): m = mean(x); v = mean((x - m)^2)
// (two passes, biased); r = 1 / sqrt(v + eps); y = (x - m) * (r * g) + b.
// Backward (its _bwd_kernel, and the IN part of conv3x3_adain_bwd's
// _bwd_adain_kernel): xhat = (x - m) * r; db = sum(dy); dg = sum(dy * xhat);
// dx = (g * r) * (dy - db / S - xhat * (dg / S)).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace msig_in {
// Internal linkage throughout: adain_pallas.cu and conv3x3_adain_bwd.cu each
// build a library with these kernels, loaded into one process, and each
// library launches its own copies.
namespace {

namespace cg = cooperative_groups;

constexpr int kLanes = 32;                  // channels a cluster
constexpr int kQuads = kLanes / 4;          // threads across a pixel row, 4 channels each
constexpr int kThreads = 512;
constexpr int kSlots = kThreads / kQuads;   // pixel rows in flight a CTA: 64
constexpr int kMaxCluster = 8;              // the portable cluster size
// a CTA's shared memory: red, part, tot below
constexpr int kStaticSmem = (2 * kSlots * kLanes + 2 * kLanes + 2 * kLanes) * 4;

// Four channels of one pixel row, as stored (16 bytes of fp32, 8 of bf16).
template <typename T> struct Quad;
template <> struct Quad<float> {
  using Raw = float4;
  __device__ static void to_f(const Raw& v, float (&f)[4]) {
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  __device__ static Raw from_f(const float (&f)[4]) { return make_float4(f[0], f[1], f[2], f[3]); }
};
template <> struct Quad<__nv_bfloat16> {
  using Raw = uint2;
  __device__ static void to_f(const Raw& v, float (&f)[4]) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    f[0] = __low2float(a), f[1] = __high2float(a), f[2] = __low2float(b), f[3] = __high2float(b);
  }
  __device__ static Raw from_f(const float (&f)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    return make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                      *reinterpret_cast<const uint32_t*>(&b));
  }
};

// Shared memory of a CTA.
struct Scratch {
  float red[2][kSlots][kLanes];  // the threads' partials, by slot
  float part[2][kLanes];         // the CTA's partials, read by the cluster
  float tot[2][kLanes];          // the cluster's sums
};
static_assert(sizeof(Scratch) == kStaticSmem, "kStaticSmem counts the scratch");

// Sums v[j][k] (channel 4q + k of the group, q = threadIdx.x % kQuads) over
// the cluster's threads for j < NV: the kSlots rows of threads in slot order,
// then the CTAs' partials in rank order. Sum j lands in sc.tot[J0 + j]. A
// CTA's partials stay in sc.part[J0 + j], which the other CTAs read until
// they pass their next cluster barrier: a later call takes another J0.
// Every thread of the cluster calls it.
template <int J0, int NV>
__device__ __forceinline__ void cluster_sum(const float (&v)[NV][4], Scratch& sc,
                                            cg::cluster_group& cluster) {
  const int q = threadIdx.x % kQuads, slot = threadIdx.x / kQuads;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    *reinterpret_cast<float4*>(&sc.red[j][slot][4 * q]) =
        make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
  __syncthreads();
  if (threadIdx.x < kLanes) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float s = 0.f;
      for (int k = 0; k < kSlots; ++k) s += sc.red[j][k][threadIdx.x];
      sc.part[J0 + j][threadIdx.x] = s;
    }
  }
  cluster.sync();
  if (threadIdx.x < kLanes) {
    const int R = (int)cluster.num_blocks();
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float s = 0.f;
      for (int r = 0; r < R; ++r)
        s += cluster.map_shared_rank(&sc.part[J0 + j][0], r)[threadIdx.x];
      sc.tot[J0 + j][threadIdx.x] = s;
    }
  }
  __syncthreads();
}

// The second half of a cluster barrier: arrive once a CTA's last remote read
// is done, wait before it exits, so that no CTA leaves while another may
// still read its shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// grid (R, C / 32, B), cluster (R, 1, 1), block kThreads; CTA `rank` takes
// pixels rank * rows .. rank * rows + rows - 1. gamma, beta [B, C] fp32;
// mean, rstd [B, C] fp32 outputs.
template <typename T>
__global__ void __launch_bounds__(kThreads) adain_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    T* __restrict__ y, float* __restrict__ mean, float* __restrict__ rstd, int S, int C, int rows,
    float eps) {
  using Q = Quad<T>;
  __shared__ Scratch sc;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), b = blockIdx.z, cg0 = blockIdx.y * kLanes;
  const int q = threadIdx.x % kQuads, slot = threadIdx.x / kQuads;
  const int p0 = rank * rows, p1 = min(S, p0 + rows);
  const size_t off = (size_t)b * S * C + cg0, stride = C / 4;  // stride: quads a pixel row
  const typename Q::Raw* xg = reinterpret_cast<const typename Q::Raw*>(x + off) + q;
  typename Q::Raw* yg = reinterpret_cast<typename Q::Raw*>(y + off) + q;

  float v[1][4] = {{0.f, 0.f, 0.f, 0.f}}, f[4];
#pragma unroll 4
  for (int p = p0 + slot; p < p1; p += kSlots) {
    Q::to_f(xg[p * stride], f);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[0][k] += f[k];
  }
  cluster_sum<0, 1>(v, sc, cluster);
  float m[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) m[k] = sc.tot[0][4 * q + k] / (float)S, v[0][k] = 0.f;

#pragma unroll 4
  for (int p = p0 + slot; p < p1; p += kSlots) {
    Q::to_f(xg[p * stride], f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float d = f[k] - m[k];
      v[0][k] = fmaf(d, d, v[0][k]);
    }
  }
  cluster_sum<1, 1>(v, sc, cluster);
  cluster_arrive();
  float rg[4], be[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = b * C + cg0 + 4 * q + k;
    const float r = 1.f / sqrtf(sc.tot[1][4 * q + k] / (float)S + eps);
    rg[k] = r * gamma[c];
    be[k] = beta[c];
    if (rank == 0 && slot == 0) mean[c] = m[k], rstd[c] = r;
  }
#pragma unroll 4
  for (int p = p0 + slot; p < p1; p += kSlots) {
    Q::to_f(xg[p * stride], f);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = (f[k] - m[k]) * rg[k] + be[k];
    yg[p * stride] = Q::from_f(f);
  }
  cluster_wait();
}

// As adain_fwd_kernel. dgamma = sum(dy * xhat), dbeta = sum(dy) [B, C] fp32
// outputs.
template <typename T>
__global__ void __launch_bounds__(kThreads) in_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ gamma, T* __restrict__ dx,
    float* __restrict__ dgamma, float* __restrict__ dbeta, int S, int C, int rows) {
  using Q = Quad<T>;
  __shared__ Scratch sc;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), b = blockIdx.z, cg0 = blockIdx.y * kLanes;
  const int q = threadIdx.x % kQuads, slot = threadIdx.x / kQuads;
  const int p0 = rank * rows, p1 = min(S, p0 + rows);
  const size_t off = (size_t)b * S * C + cg0, stride = C / 4;
  const typename Q::Raw* xg = reinterpret_cast<const typename Q::Raw*>(x + off) + q;
  const typename Q::Raw* gg = reinterpret_cast<const typename Q::Raw*>(dy + off) + q;
  typename Q::Raw* dxg = reinterpret_cast<typename Q::Raw*>(dx + off) + q;
  float m[4], r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[k] = mean[b * C + cg0 + 4 * q + k];
    r[k] = rstd[b * C + cg0 + 4 * q + k];
  }

  float v[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}}, fx[4], fg[4];
#pragma unroll 4
  for (int p = p0 + slot; p < p1; p += kSlots) {
    Q::to_f(xg[p * stride], fx);
    Q::to_f(gg[p * stride], fg);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[0][k] += fg[k];
      v[1][k] = fmaf(fg[k], (fx[k] - m[k]) * r[k], v[1][k]);
    }
  }
  cluster_sum<0, 2>(v, sc, cluster);
  cluster_arrive();
  float gr[4], mb[4], mg[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = b * C + cg0 + 4 * q + k;
    const float db = sc.tot[0][4 * q + k], dg = sc.tot[1][4 * q + k];
    gr[k] = gamma[c] * r[k];
    mb[k] = db / (float)S;
    mg[k] = dg / (float)S;
    if (rank == 0 && slot == 0) dgamma[c] = dg, dbeta[c] = db;
  }
#pragma unroll 4
  for (int p = p0 + slot; p < p1; p += kSlots) {
    Q::to_f(xg[p * stride], fx);
    Q::to_f(gg[p * stride], fg);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xhat = (fx[k] - m[k]) * r[k];
      fx[k] = gr[k] * (fg[k] - mb[k] - xhat * mg[k]);
    }
    dxg[p * stride] = Q::from_f(fx);
  }
  cluster_wait();
}

// A cluster kernel's launch: R CTAs a cluster along x. With `clusters`
// given, nothing is launched: *clusters is cudaOccupancyMaxActiveClusters of
// the configuration (ops/adain_pallas.py raises before a launch where it is
// 0).
template <typename... KArgs, typename... Args>
int cluster_run(void (*kernel)(KArgs...), int R, dim3 grid, cudaStream_t st, int* clusters,
                Args... args) {
  if (R < 1 || R > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr) return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

inline int rows_of(int S, int R) { return (S + R - 1) / R; }

// The forward on cluster size R; with `clusters` given, the occupancy query
// alone.
template <typename T>
int adain_fwd_launch(const void* x, const void* gamma, const void* beta, void* y, void* mean,
                     void* rstd, int B, int S, int C, float eps, int R, cudaStream_t st,
                     int* clusters = nullptr) {
  return cluster_run(adain_fwd_kernel<T>, R, dim3(R, C / kLanes, B), st, clusters,
                     static_cast<const T*>(x), static_cast<const float*>(gamma),
                     static_cast<const float*>(beta), static_cast<T*>(y),
                     static_cast<float*>(mean), static_cast<float*>(rstd), S, C, rows_of(S, R),
                     eps);
}

// The backward (x and dy, dx in T), as adain_fwd_launch.
template <typename T>
int in_bwd_launch(const void* x, const void* dy, const void* mean, const void* rstd,
                  const void* gamma, void* dx, void* dgamma, void* dbeta, int B, int S, int C,
                  int R, cudaStream_t st, int* clusters = nullptr) {
  return cluster_run(in_bwd_kernel<T>, R, dim3(R, C / kLanes, B), st, clusters,
                     static_cast<const T*>(x), static_cast<const T*>(dy),
                     static_cast<const float*>(mean), static_cast<const float*>(rstd),
                     static_cast<const float*>(gamma), static_cast<T*>(dx),
                     static_cast<float*>(dgamma), static_cast<float*>(dbeta), S, C,
                     rows_of(S, R));
}

}  // namespace
}  // namespace msig_in
