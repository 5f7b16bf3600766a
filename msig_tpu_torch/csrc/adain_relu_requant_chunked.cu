// Instance norm + AdaIN + ReLU + per-sample requant of an int32 map, the
// epilogue of the unfused trunk's relu sites: x [B, S, C] int32 -> int8
// [B, S, C], with the true per-channel extremes and the unfolded requant of
// conv_int8.cuh (true_relu_amax, relu_requant_unfolded).
//
// Replaces the TPU kernel msig_tpu/ops/int8_epilogue_chunked.py::
// adain_relu_requant_chunked, which walks a sequential (B, 2, S/512) grid:
// phase 0 carries fp32 sums, min and max across chunks in VMEM, phase 1
// requantizes. Blocks of a Hopper grid run in no order, so here the two
// phases are two launches: exact integer statistics reduced across CTAs with
// int64 atomics (order-free, as at every site of the port), then the
// elementwise pass (true_relu_requant_kernel of conv_int8.cuh), in which each
// CTA rebuilds its sample's affine and scale.
//
// The input is any int32, not a conv output of known depth. So each square
// (< 2^62 for |x| <= 2^31) is split at bit 32 element by element and the
// halves are summed in two 64-bit words: exact for every int32 and for up to
// 2^32 rows, with no range check.
//
// Bound on an H100 at the main path's shape [8, 4096, 256]: 33.6 MB read and
// 8.4 MB written, 12.5 us at 3.35 TB/s; bytes bound it. This design reads the
// int32 map twice (statistics, then requant); the second read mostly hits the
// 50 MB L2 at this size.
#include <climits>

#include "conv_int8.cuh"

namespace msig {

constexpr int kChunkRows = 128;  // rows of one sample per statistics CTA
constexpr int kChunkCols = 128;  // channels per statistics CTA: one per thread, two row lanes

// grid = (ceil(S / kChunkRows), C / kChunkCols, B), block = 256. Thread t
// takes channel t % 128 and every other row from t / 128; the two lanes meet
// in shared memory, then one thread per channel adds to the statistics block.
__global__ void __launch_bounds__(256)
chunk_stats_kernel(const int32_t* __restrict__ x, long long* __restrict__ stats, int B, int S,
                   int C) {
  __shared__ long long sh_s[kChunkCols], sh_mn[kChunkCols], sh_mx[kChunkCols];
  __shared__ unsigned long long sh_lo[kChunkCols], sh_hi[kChunkCols];
  const int b = blockIdx.z;
  const int col = threadIdx.x % kChunkCols, lane = threadIdx.x / kChunkCols;
  const int c = blockIdx.y * kChunkCols + col;
  const int r0 = blockIdx.x * kChunkRows, r1 = min(r0 + kChunkRows, S);
  long long s = 0;
  unsigned long long lo = 0, hi = 0;
  int mn = INT_MAX, mx = INT_MIN;
  const int32_t* xb = x + (size_t)b * S * C + c;
  for (int r = r0 + lane; r < r1; r += 2) {
    const int v = xb[(size_t)r * C];
    const unsigned long long sq = (unsigned long long)((long long)v * v);
    s += v;
    lo += sq & 0xffffffffull;
    hi += sq >> 32;
    mn = min(mn, v);
    mx = max(mx, v);
  }
  if (lane == 1) {
    sh_s[col] = s, sh_lo[col] = lo, sh_hi[col] = hi, sh_mn[col] = mn, sh_mx[col] = mx;
  }
  __syncthreads();
  if (lane == 0) {
    const size_t BC = (size_t)B * C, i = (size_t)b * C + c;
    atomicAdd(reinterpret_cast<unsigned long long*>(&stats[i]),
              (unsigned long long)(s + sh_s[col]));
    atomicAdd(reinterpret_cast<unsigned long long*>(&stats[BC + i]), lo + sh_lo[col]);
    atomicMin(&stats[2 * BC + i], min((long long)mn, sh_mn[col]));
    atomicMax(&stats[3 * BC + i], max((long long)mx, sh_mx[col]));
    atomicAdd(reinterpret_cast<unsigned long long*>(&stats[4 * BC + i]), hi + sh_hi[col]);
  }
}

}  // namespace msig

// Returns cudaGetLastError() after the launches (0 = success). Launches on
// `stream` and does not synchronise. x: [B, S, C] int32; gamma, beta: [B, C]
// float32; stats: int64 [5*B*C + B], blocks 0, 1 and 4 zeroed, block 2 set
// to INT64_MAX and block 3 to INT64_MIN; out: [B, S, C] int8. Needs
// C % 128 == 0.
extern "C" int msig_adain_relu_requant_chunked(const void* x, const void* gamma, const void* beta,
                                               void* stats, void* out, int B, int S, int C,
                                               float eps, void* stream) {
  using namespace msig;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid_a((S + kChunkRows - 1) / kChunkRows, C / kChunkCols, B);
  chunk_stats_kernel<<<grid_a, 256, 0, st>>>(static_cast<const int32_t*>(x),
                                             static_cast<long long*>(stats), B, S, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_b(epilogue_blocks(S, C), B);
  true_relu_requant_kernel<<<grid_b, kEpiThreads, 2 * C * sizeof(float), st>>>(
      static_cast<const int32_t*>(x), static_cast<const long long*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<int8_t*>(out), nullptr, B, S, C, eps);
  return (int)cudaGetLastError();
}
