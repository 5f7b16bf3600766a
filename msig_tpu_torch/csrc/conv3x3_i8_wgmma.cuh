// Pass A of the resblock trunk's int8 3x3 sites on Hopper (sm_90a): the exact
// int32 3x3 "same" conv of dense NHWC int8 x [B, H, W, C] against K-major
// weights, its int32 output written to a scratch in device memory, and the
// exact int64 statistics block of conv_int8.cuh (sum, two-word sum of squares,
// zero-masked min and max per (sample, channel)), to the bit the sums of
// conv_int8.cuh's pass A.
//
// Replaces, for the sites msig_conv3x3_adain_relu_requant and
// msig_conv3x3_adain_residual_requant, conv_int8.cuh's mma.sync pass A; the
// TPU kernels msig_tpu/ops/fused_conv_int8_v2.py::_kernel_relu and _kernel_res
// compute the same sums (their zero-masked extremes :68-87).
//
// Bound on an H100 at the main path's [8, 64, 64, 256]: 2 * 32768 * 256 * 2304
// = 38.7 G int8 operations (19.5 us at 1,979 TOP/s) against 17.4 MB that must
// move. What held the mma.sync pass A at about a tenth of that: no overlap of
// loads and math (one stage, two block barriers per 64 channels of a tap), the
// weights transposed byte by byte in every CTA on every call, each input window
// staged once per 128 output channels, and mma.sync itself. Here:
//
// - The weights come K-major, [C_out, 9*C_in] (fused_conv_int8_v2.py::
//   pack_weights_kmajor, made once at quantization): wgmma takes 8-bit A and B
//   only K-major, and a 16-byte copy of a weight row then lands as it is.
// - GEMM: M = B*H*W pixels, N = C_out, K = 9*C_in, one tap and 128 channels
//   (kBK bytes) a stage. A CTA tile is kBM = 128 pixels (never across a sample:
//   H*W % 128 == 0) by BN channels, BN = 256 where C % 256 == 0 (the whole
//   width at C = 256: each input window is staged once per tile and the tile's
//   statistics close in one CTA), else 128. Two consumer warpgroups of 64 rows
//   each run wgmma.mma_async m64nBNk32 s32.s8.s8, both operands read from
//   shared memory in the 128-byte swizzle (8-row atoms of 128-byte rows, 16-byte
//   chunk c of row r at chunk c ^ (r % 8)); the accumulator is BN/2 registers a
//   thread (setmaxnreg gives the consumers kConsumerRegs, the producer
//   kProducerRegs).
// - A ring of kStages stages (48 KB each at BN = 256), filled by a producer
//   warpgroup with 16-byte cp.async.cg copies that write zeros (source size 0)
//   for taps outside the map, for any W: a TMA box tiles a 128-pixel run only
//   where W divides 128 or 128 divides W, and the trunk of a 384^2 input has
//   W = 96. mbarriers hand the stages over: a stage is full when all 128
//   producer threads' copies have landed (cp.async.mbarrier.arrive.noinc) and
//   empty when the 8 consumer warps' wgmma on it have completed (wait_group 1
//   releases the stage before the one just issued). cp.async writes through
//   the generic proxy and wgmma reads through the async proxy, so each
//   consumer fences the proxies (fence.proxy.async) after its full-wait.
// - Persistent CTAs, one per SM (gridDim.x = min(tiles, SMs)), walk the tiles
//   in order tile = blockIdx.x + i * gridDim.x (channel tiles fastest), so the
//   producer loads the next tile's stages while the consumers store and reduce
//   the last one. At [8, 64, 64, 256]: 256 tiles on 132 SMs.
// - The statistics come from the registers. A consumer thread holds rows
//   16*warp + lane/4 (+8) and columns 8j + 2*(lane%4) + {0, 1} of its
//   warpgroup's 64 rows. Per column it folds its two rows, then the 8 lanes of
//   one lane%4 halve their columns three times (shuffles at xor 16, 8, 4: 7
//   shuffles per 8 columns where a full reduction takes 24), so that lane
//   (g = lane/4, lane%4) ends with the warp's 16-row sums of column 32c +
//   8*(g/2) + 2*(lane%4) + g%2 of chunk c; those meet the other warps' in a
//   shared [5][BN] int64 block by shared atomics, and the block goes to the
//   statistics block by global int64 atomics. Every sum is an integer: the
//   result does not depend on the order of the warps or the CTAs. The sum of
//   squares is split per warp (16 squares < 2^62) into its low and high 32-bit
//   words, as conv_int8.cuh splits it per warp of 32 rows; the epilogues read
//   hi * 2^32 + lo, the same integer.
// - The accumulator leaves by 8-byte stores straight from the fragment: four
//   lanes write 32 contiguous bytes of one row, a full sector.
//
// Tried and measured (tools/trunk_wgmma_variants_torch.py, which builds
// these variants; H100 80GB HBM3 at 700 W), pass A alone at [8, 64, 64, 256]
// (CUDA events over 20 launches back to back, median of 5; at [8, 128, 128,
// 256] in brackets): this design 0.0628 ms (0.2255); one CTA per tile, 256
// CTAs, 0.0643 (0.2339); 3 stages 0.0632 (0.2284). Cut down to find the
// limit: without B's loads 0.0550, without A's 0.0517, without either
// 0.0482; without the statistics 0.0520, without them and the stores 0.0243
// (80% of the int8 peak). So the main loop is fast and the tile's epilogue
// is not: the stores take 28 us, the statistics 11 (the 32 MB of int32 leave
// as all SMs end a tile together, at about 1.2 TB/s). Two ways to take the
// stores off the consumers were slower in trial builds (not committed): the
// producer warpgroup split into 2 loader warps and 2 storer warps draining a
// staging buffer (two warps cannot keep the ring full), and the consumers
// handing staged rows to the TMA engine (cp.async.bulk), which without the
// statistics ran no faster than these stores: the write costs the same
// whoever issues it. Keeping the accumulator on chip is the lever.
//
// Needs C % 128 == 0 and H*W % 128 == 0 (the wrappers check), the weights
// [C, 9*C] K-major, the statistics block zeroed, and a kernel register count
// that lets setmaxnreg rebalance (checked before the launch: a shortfall
// would block the consumers' setmaxnreg.inc).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_int8.cuh"

namespace msig {
namespace wgmma3x3 {

constexpr int kBM = 128;           // pixels a tile: two consumer warpgroups of 64 rows
constexpr int kBK = 128;           // bytes of K a stage: 128 channels of one tap, one swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 384;      // warpgroup 0 produces, 1 and 2 consume
constexpr int kProducerRegs = 56;  // 128 * 56 + 256 * 224 = 384 * 168, the kernel's budget
constexpr int kConsumerRegs = 224;
constexpr int kConsumerWarps = 8;

template <int BN>
struct Layout {
  static constexpr int kA = kBM * kBK;  // 16 KB
  static constexpr int kB = BN * kBK;   // 32 KB at BN = 256
  static constexpr int kStage = kA + kB;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kStats = kStatBlocks * BN * 8;
  static constexpr int kBars = 2 * kStages * 8;
  static constexpr int kBytes = kRing + kStats + kBars + 1024;  // + the slack to align to 1024
};
static_assert(Layout<256>::kBytes <= 232448, "the ring, the statistics and the barriers fit an SM");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Spins until the phase of the given parity has completed. A deadlock would
// otherwise hang the card: after 2^24 failed polls (far past any real wait,
// which takes microseconds) it traps, and the launch fails.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++polls == (1u << 24)) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// Arrives on bar once every cp.async this thread has issued so far has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// 16 bytes from src, or 16 zero bytes where src_bytes is 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte swizzle:
// start address >> 4, leading byte offset 1 (unused by this layout), stride
// byte offset 1024 (from one 8-row atom to the next), layout type 1 (128B).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers across the asynchronous
// wgmma (it cannot see that they are in flight).
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 256] += A[64 x 32] * B[256 x 32]^T, int8 in, int32 out; A and B K-major in
// shared memory (descriptors da, db).
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 32] * B[128 x 32]^T, int8 in, int32 out; A and B K-major in
// shared memory (descriptors da, db).
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256) wgmma_m64n256k32(d, da, db);
  else wgmma_m64n128k32(d, da, db);
}

struct Add {
  template <class T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Min {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct Max {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

// The 8 lanes of one lane % 4 each hold 8 column values v[k]; after three
// halvings (xor 16, 8, 4) lane g = lane / 4 returns column k = g combined over
// the 8 lanes.
template <class T, class Op>
__device__ __forceinline__ T fold8(T (&v)[8], int lane, Op op) {
  const bool b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T send = b4 ? v[k] : v[k + 4], keep = b4 ? v[k + 4] : v[k];
    v[k] = op(keep, __shfl_xor_sync(0xffffffffu, send, 16));
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const T send = b3 ? v[k] : v[k + 2], keep = b3 ? v[k + 2] : v[k];
    v[k] = op(keep, __shfl_xor_sync(0xffffffffu, send, 8));
  }
  const T send = b2 ? v[0] : v[1], keep = b2 ? v[1] : v[0];
  return op(keep, __shfl_xor_sync(0xffffffffu, send, 4));
}

// Adds a warp's 16 rows of the tile to the CTA's shared statistics block cta
// [kStatBlocks][BN] (zero-masked extremes). acc[4j + e] holds column 8j +
// 2*(lane%4) + e of row lane/4, acc[4j + 2 + e] the same column 8 rows down.
template <int BN>
__device__ __forceinline__ void warp_stats(const int (&acc)[BN / 2], long long* cta, int lane) {
  const int q = lane & 3, g = lane >> 2;
#pragma unroll
  for (int c = 0; c < BN / 32; ++c) {  // chunk c: the thread's column pairs j = 4c .. 4c + 3
    long long s[8];
    unsigned long long sq[8];
    int mn[8], mx[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = 4 * c + (k >> 1), e = k & 1;
      const int v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
      s[k] = (long long)v0 + v1;
      sq[k] = (unsigned long long)((long long)v0 * v0) + (unsigned long long)((long long)v1 * v1);
      mn[k] = min(0, min(v0, v1));
      mx[k] = max(0, max(v0, v1));
    }
    const long long s16 = fold8(s, lane, Add());
    const unsigned long long sq16 = fold8(sq, lane, Add());  // 16 squares < 2^62
    const int mn16 = fold8(mn, lane, Min()), mx16 = fold8(mx, lane, Max());
    const int col = 32 * c + 8 * (g >> 1) + 2 * q + (g & 1);
    atomicAdd(reinterpret_cast<unsigned long long*>(&cta[0 * BN + col]), (unsigned long long)s16);
    atomicAdd(reinterpret_cast<unsigned long long*>(&cta[1 * BN + col]), sq16 & 0xffffffffull);
    atomicMin(&cta[2 * BN + col], (long long)mn16);
    atomicMax(&cta[3 * BN + col], (long long)mx16);
    atomicAdd(reinterpret_cast<unsigned long long*>(&cta[4 * BN + col]), sq16 >> 32);
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerWarps * 32) : "memory");
}

// x: [B, H, W, C] int8; wk: [C, 9*C] int8, row co, column (ky*3 + kx)*C + ci;
// y: [B, H*W, C] int32; stats: the zeroed statistics block (conv_int8.cuh).
// grid = min(tiles, SMs), block = kThreads, dynamic smem Layout<BN>::kBytes.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_i8_wgmma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wk,
                        int32_t* __restrict__ y, long long* __restrict__ stats, int B, int H,
                        int W, int C) {
  using L = Layout<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes
  long long* cta = reinterpret_cast<long long*>(smem_raw + (base - raw) + L::kRing);
  const uint32_t full = base + L::kRing + L::kStats, empty = full + 8 * kStages;

  const int HW = H * W, tiles_per_sample = HW / kBM, tiles_n = C / BN;
  const int tiles = B * tiles_per_sample * tiles_n;
  const int chunks = C / kBK, ksteps = 9 * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 128);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < kStatBlocks * BN; i += kThreads) cta[i] = 0;
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: thread t copies 16-byte chunk t % 8 of rows t / 8 + 16 i.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int jc = threadIdx.x & 7, r0 = threadIdx.x >> 3;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int tn = tile % tiles_n, tm = tile / tiles_n;
      const int b = tm / tiles_per_sample, m0 = (tm % tiles_per_sample) * kBM;
      uint32_t yx[kBM / 16];  // (y << 16) | x of the pixel of each of this thread's rows
#pragma unroll
      for (int i = 0; i < kBM / 16; ++i) {
        const int m = m0 + r0 + 16 * i;
        yx[i] = ((uint32_t)(m / W) << 16) | (uint32_t)(m % W);
      }
      const int8_t* xb = x + (size_t)b * HW * C + jc * 16;
      const int8_t* wb = wk + (size_t)(tn * BN + r0) * 9 * C + jc * 16;
      for (int ks = 0; ks < ksteps; ++ks) {
        const int tap = ks / chunks, c0 = (ks - tap * chunks) * kBK;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t sa = base + stage * L::kStage, sb = sa + L::kA;
#pragma unroll
        for (int i = 0; i < kBM / 16; ++i) {
          const int p = r0 + 16 * i;
          const int yy = (int)(yx[i] >> 16) + dy, xx = (int)(yx[i] & 0xffffu) + dx;
          const bool in = (unsigned)yy < (unsigned)H && (unsigned)xx < (unsigned)W;
          const int8_t* src = in ? xb + ((size_t)yy * W + xx) * C + c0 : xb;
          cp_async16(sa + p * kBK + ((jc ^ (p & 7)) << 4), src, in ? 16u : 0u);
        }
#pragma unroll
        for (int i = 0; i < BN / 16; ++i) {
          const int n = r0 + 16 * i;
          cp_async16(sb + n * kBK + ((jc ^ (n & 7)) << 4),
                     wb + (size_t)16 * i * 9 * C + tap * C + c0, 16u);
        }
        cp_async_arrive(full + 8 * stage);
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = (threadIdx.x >> 7) - 1;  // consumer warpgroup: tile rows 64*cw ..
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int ct = threadIdx.x - 128;
    const size_t BC = (size_t)B * C;
    int stage = 0;
    uint32_t phase = 0;
    int acc[BN / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int tn = tile % tiles_n, tm = tile / tiles_n;
      const int b = tm / tiles_per_sample, m0 = (tm % tiles_per_sample) * kBM, n0 = tn * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev = 0;
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(full + 8 * stage, phase);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t sa = base + stage * L::kStage + cw * 64 * kBK, sb =
            base + stage * L::kStage + L::kA;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          wgmma_tile<BN>(acc, sw128_desc(sa + 32 * kk), sw128_desc(sb + 32 * kk));
        wgmma_commit();
        fence_regs(acc);
        if (ks > 0) {
          wgmma_wait<1>();  // the previous stage's products are done: release it
          fence_regs(acc);
          if (lane == 0) mbar_arrive(empty + 8 * prev);
          __syncwarp();
        }
        prev = stage;
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * prev);
      __syncwarp();

      // The tile's int32 rows, straight from the fragment.
      const int row = 64 * cw + 16 * warp + (lane >> 2);
      int32_t* y0 = y + ((size_t)b * HW + m0 + row) * C + n0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<int2*>(y0 + 8 * j) = make_int2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<int2*>(y0 + (size_t)8 * C + 8 * j) = make_int2(acc[4 * j + 2],
                                                                         acc[4 * j + 3]);
      }
      warp_stats<BN>(acc, cta, lane);
      consumer_sync();
      for (int i = ct; i < kStatBlocks * BN; i += kConsumerWarps * 32) {
        const int k = i / BN, col = i % BN;
        const long long v = cta[i];
        cta[i] = 0;
        if (v == 0) continue;  // every block starts at 0, the identity of its operation
        long long* dst = stats + k * BC + (size_t)b * C + n0 + col;
        if (k == 2) atomicMin(dst, v);
        else if (k == 3) atomicMax(dst, v);
        else atomicAdd(reinterpret_cast<unsigned long long*>(dst), (unsigned long long)v);
      }
      consumer_sync();
    }
  }
}

// Host side. Returns a cudaError_t as int (0 = success); launches on `st`.
// Internal linkage (static): each kernel library sets up its own kernel, and
// the per-device state below must not be merged across the libraries loaded
// in one process, as a template's static locals otherwise are (one symbol
// for all of them).
template <int BN>
static int launch(const int8_t* x, const int8_t* wk, int32_t* y, long long* stats, int B, int H,
                  int W, int C, cudaStream_t st) {
  using L = Layout<BN>;
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices] = {0};  // 0: this device is not set up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, conv3x3_i8_wgmma_kernel<BN>);
    if (err != cudaSuccess) return (int)err;
    // setmaxnreg moves registers within the CTA's allocation: the producer's
    // release must cover the consumers' request, or they would wait forever.
    if (attr.numRegs * kThreads < 128 * kProducerRegs + 256 * kConsumerRegs)
      return (int)cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(conv3x3_i8_wgmma_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev] = n;
  }
  const int tiles = B * (H * W / kBM) * (C / BN);
  conv3x3_i8_wgmma_kernel<BN><<<tiles < sms[dev] ? tiles : sms[dev], kThreads, L::kBytes, st>>>(
      x, wk, y, stats, B, H, W, C);
  return (int)cudaGetLastError();
}

// Zeroes the statistics block [kStatBlocks*B*C + B] on `st`, then runs pass A
// (BN = 256 where C % 256 == 0, else 128).
static int conv3x3_i8_stats(const void* x, const void* wk, void* y, void* stats, int B, int H,
                            int W, int C, cudaStream_t st) {
  cudaError_t err =
      cudaMemsetAsync(stats, 0, ((size_t)kStatBlocks * B * C + B) * sizeof(long long), st);
  if (err != cudaSuccess) return (int)err;
  const auto* xi = static_cast<const int8_t*>(x);
  const auto* wi = static_cast<const int8_t*>(wk);
  auto* yi = static_cast<int32_t*>(y);
  auto* si = static_cast<long long*>(stats);
  return C % 256 == 0 ? launch<256>(xi, wi, yi, si, B, H, W, C, st)
                      : launch<128>(xi, wi, yi, si, B, H, W, C, st);
}

}  // namespace wgmma3x3
}  // namespace msig
