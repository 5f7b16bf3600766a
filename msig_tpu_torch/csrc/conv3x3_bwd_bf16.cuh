// Backward of a 3x3 stride-1 zero-padded ("SAME") convolution with bf16
// operands and fp32 accumulation on dense NHWC maps (sm_90a): dx and dW of
// y = conv3x3([relu](x), W), W in HWIO; x, dy and W in bf16, dx written in
// bf16, dW in fp32.
//
// Replaces the bf16 configuration of the core shared by the TPU kernels
// msig_tpu/ops/conv3x3_vjp.py::conv3x3_bwd and conv3x3_adain_bwd, the one the
// JAX package's bf16 train step runs (models/layers.py casts x and the kernel
// to the compute type; :143 and :298 cast the transposed taps; the MXU
// products take bf16 operands and accumulate in fp32, :93-94 and :108-110).
//
// The two products are implicit GEMMs (a product of two bf16 values is exact
// in fp32, so one pass, where the fp32 core of conv3x3_bwd.cuh needs three):
//   dx: M = B*H*W pixels, N = C, K = 9*Co: A = dy gathered at the shifted
//       pixel (zero outside the map), K-major ([pixel][co]); B[k = co][n = c]
//       = W[tap][c][co], K-major in HWIO as it is (no transposed copy);
//   dW: M = 9*C (tap, input channel), N = Co, K = pixels: A[m = ci][k = p] =
//       x at the shifted pixel, B[k = p][n = co] = dy, both MN-major as NHWC
//       stores them.
//
// Bound on an H100 at [8, 64, 64, 256]: 77.3 GFLOP at the 989 TFLOP/s of
// dense bf16 is 0.078 ms; the bytes (x, dy read, dx written in bf16, W and
// dW) about 50 MB, 0.015 ms: the products bound it. The design, for Hopper:
//
// - wgmma.mma_async m64nBNk16 bf16 -> fp32, both operands in shared memory in
//   the 128-byte swizzle (16-byte chunk c of 128-byte row r at chunk c ^
//   (r % 8), 1024-byte atoms), read by descriptor: dx's operands K-major
//   (rows of 64 K values; the descriptor steps 32 bytes a k16), dW's MN-major
//   (the instruction's transpose bits: rows of 64 M or N values, 64 K rows a
//   stage; 8-row groups 1024 bytes apart, 64-wide blocks 8192 bytes apart;
//   the descriptor steps 2048 bytes a k16).
// - A CTA tile of 128 x BN, BN = 256 where C and Co are multiples of 256 (the
//   trunk: each operand row staged once per tile, a quarter fewer bytes a
//   product than at 128), else 128: two consumer warpgroups of 64 rows each
//   (BN / 2 fp32 accumulators a thread, setmaxnreg moving registers from the
//   producer to them), and a producer that fills a ring of as many stages of
//   K = 64 as fit (4 of 48 KB at BN = 256, 7 of 32 KB at 128).
// - The producer: by TMA where a 128-pixel tile is whole rows of one image
//   or a part of one row (the trunk's 64- and 128-wide maps), one thread
//   issuing boxes of 4-D tensor maps over [B, H, W, C] whose origin the tap
//   shifts, signed, so that the box's zeros outside the map are the SAME
//   padding; the stage completes on its full barrier by the boxes' bytes
//   (expect_tx). Elsewhere (a 96-wide map, W = 24, whose tiles straddle
//   rows; any B*H*W) the producer warpgroup's 16-byte cp.async copies that
//   zero-fill the taps outside the map and the pixels past the ragged edge,
//   each thread's arrival when its copies have landed. Both write the same
//   bytes (tests/test_torch_port_conv_bwd_bf16_wgmma.py holds them).
// - The ReLU of x for dW's A: an operand read by descriptor cannot be masked
//   on its way to the tensor cores, so a pass in shared memory zeroes the
//   negative values of each dW stage's A tile and fences the proxies before
//   the products: by TMA the producer warpgroup's three idle warps (the
//   boxes land on a barrier of their own, the warps hand the stage over), by
//   copies, where every producer thread copies, each consumer warpgroup over
//   its own 8 KB half. dx's relu'(x) (x > 0) is applied in its epilogue, the
//   row's x loaded all at once.
// - A persistent grid, one CTA per SM (grid = min(items, SMs)): dx tiles
//   (128 pixels x BN channels, all of K) and dW tiles (128 rows of one tap x
//   BN output channels, one chunk of the pixels) are items, dealt one at a
//   time from a counter in device memory (an integer atomic; which CTA takes
//   an item changes nothing of its bits), the longer kind first, so the
//   shorter items fill the tail. The producer loads the next item while the
//   consumers write the last one out.
// - dW's K in dw_plan(g) chunks of whole 64-pixel stages: one chunk per half
//   a dx item's K of pixels (9*Co / 2), at most kMaxChunks (at the trunk's
//   width 18 dW tiles x 7 = 126 items, fewer than the card's 132 SMs: each
//   SM takes at most one, the shorter dx items deal around them; in a model
//   of the dealing 96% of the SMs' time busy at [4|8, 64, 64, 256] where one
//   chunk per 2048 pixels, at most 8, kept 70-81%), unless a chunk would
//   pass kMaxChunkPixels (the tensor cores' fp32 sums lose bits with their
//   length: at 8192 pixels a chunk 0.52% of dW's elements rounded to bf16
//   differed from the plain version's at [8, 128, 128, 256] on the card,
//   past the 0.5% bar; 0.29-0.33% at the 4736 of [8, 64, 64, 256]), from
//   the shape alone (never from the SM count), so every call gives the same
//   bits. One chunk: the item writes dW; more: each chunk's fp32 partial goes
//   to scratch and one launch of the fp32 core's reduce_kernel adds them in
//   chunk order. No float atomics.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_bwd.cuh"

namespace msig_bf16 {

using bf16 = __nv_bfloat16;
using msig_f32::Map;
using msig_f32::npix;

constexpr int kBM = 128;             // a tile's rows: two consumer warpgroups of 64
constexpr int kBK = 64;              // K a stage: one 128-byte swizzle row of bf16
constexpr int kThreads = 384;        // warpgroup 0 produces, 1 and 2 consume
constexpr int kProducerRegs = 56;    // 128 * 56 + 256 * 224 = 384 * 168, the kernel's budget
constexpr int kConsumerRegs = 224;
constexpr int kConsumerWarps = 8;
constexpr int kATile = kBM * kBK * 2;             // A of a stage: 16 KB
constexpr int kSmemLimit = 232448;                // the shared memory a CTA may have
constexpr int kMaxStages = 7;
constexpr int kMaxChunks = 7;                     // dW's K: a chunk per 9*Co / 2 pixels, at most 7, ...
constexpr int kMaxChunkPixels = 4864;             // ... unless a chunk would pass this
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 168 * kThreads, "setmaxnreg budget");

// A tile of BN columns (256 where C and Co are multiples of 256, else 128):
// the stage (A, then B of BN rows or columns), the ring of as many stages as
// fit (4 at BN = 256, 7 at 128), then the barriers, the stages' items and the
// two ticket slots.
template <int BN>
struct Layout {
  static constexpr int kBTile = BN * kBK * 2;
  static constexpr int kStageBytes = kATile + kBTile;
  static constexpr int kFixedBytes = kMaxStages * (3 * 8 + 4) + 2 * 4;
  static constexpr int kFit = (kSmemLimit - 1024 - kFixedBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmemBytes = kStages * kStageBytes + kFixedBytes + 1024;  // + align
  static_assert(kStages >= 3, "a ring of three stages at least");
};

// The chunks of dW's K and the items of one call, from the shape alone.
struct Plan {
  int bn;         // the tile's columns: 256 where C % 256 == 0 and Co % 256 == 0, else 128
  bool tma;       // the loads by TMA: a 128-pixel tile is whole rows of one image, or a
                  // part of one row (H*W % 128 == 0, and W divides 128 or 128 divides W)
  int np;         // pixels, B*H*W
  int chunks;     // dW's K chunks
  int chunk_px;   // pixels a chunk (a multiple of kBK; the last may be short)
  int n_dx;       // dx items: pixel tiles x channel tiles
  int dw_tiles;   // dW items a chunk: (9*C / kBM) x (Co / bn)
  int n_dw;       // dw_tiles * chunks
  int dx_nk;      // stages of a dx item, 9*Co / kBK
  bool dw_first;  // dW's items are the longer: dealt first
};

__host__ __device__ inline Plan dw_plan(const Map& g) {
  Plan p;
  p.bn = g.C % 256 == 0 && g.Co % 256 == 0 ? 256 : 128;
  p.tma = g.H * g.W % kBM == 0 && (g.W % kBM == 0 || kBM % g.W == 0);
  p.np = npix(g);
  int chunks = p.np / (9 * g.Co / 2);
  chunks = chunks < 1 ? 1 : (chunks > kMaxChunks ? kMaxChunks : chunks);
  const int least = (p.np + kMaxChunkPixels - 1) / kMaxChunkPixels;
  chunks = chunks < least ? least : chunks;
  const int per = (p.np + chunks - 1) / chunks;
  p.chunk_px = (per + kBK - 1) / kBK * kBK;
  p.chunks = (p.np + p.chunk_px - 1) / p.chunk_px;
  p.n_dx = (p.np + kBM - 1) / kBM * (g.C / p.bn);
  p.dw_tiles = 9 * g.C / kBM * (g.Co / p.bn);
  p.n_dw = p.dw_tiles * p.chunks;
  p.dx_nk = 9 * g.Co / kBK;
  p.dw_first = p.chunk_px / kBK >= p.dx_nk;
  return p;
}

// Scratch floats: dW's partials where there is more than one chunk, then the
// item counter (one int).
inline size_t part_floats(const Map& g) {
  const Plan p = dw_plan(g);
  return (p.chunks > 1 ? (size_t)p.chunks * 9 * g.C * g.Co : 0) + 1;
}

// One item: a dx tile (rows m0.. of the pixels, columns n0.. of C) or a dW
// tile (rows m0.. of [9*C], one tap; columns n0.. of Co; pixels p0 .. p1 - 1).
struct Item {
  bool dw;
  int m0, n0, p0, p1, z, nk;
};

__device__ __forceinline__ Item item_at(int item, const Map& g, const Plan& p) {
  Item it;
  const bool first = item < (p.dw_first ? p.n_dw : p.n_dx);
  it.dw = first == p.dw_first;
  const int j = first ? item : item - (p.dw_first ? p.n_dw : p.n_dx);
  if (it.dw) {
    // chunk-major: the CTAs on neighbouring items read the same pixels
    it.z = j / p.dw_tiles;
    const int r = j - it.z * p.dw_tiles, tn = g.Co / p.bn;
    it.m0 = r / tn * kBM;
    it.n0 = r % tn * p.bn;
    it.p0 = it.z * p.chunk_px;
    it.p1 = min(p.np, it.p0 + p.chunk_px);
    it.nk = (it.p1 - it.p0 + kBK - 1) / kBK;
  } else {
    const int tn = g.C / p.bn;  // the channel tiles of one pixel tile follow each other
    it.m0 = j / tn * kBM;
    it.n0 = j % tn * p.bn;
    it.p0 = it.p1 = it.z = 0;
    it.nk = p.dx_nk;
  }
  return it;
}

// -------------------------------------------------------------- primitives

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Spins until the phase of the given parity has completed; after 2^24 failed
// polls (far past any real wait) it traps, so a deadlock fails the launch
// instead of hanging the card.
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

// 16 bytes from src, or 16 zero bytes where src_bytes is 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Arrives on bar once every cp.async this thread has issued so far has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Arrives on bar and adds `bytes` to the transaction count its phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A TMA box of a 4-D tensor map at coordinates (c0 innermost .. c3), signed:
// what lies outside the tensor arrives as zeros. Completes on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                           int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                           int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor in the 128-byte swizzle (layout type 1):
// start address >> 4, leading byte offset lbo, stride byte offset sbo (both
// >> 4). K-major: sbo = 1024 from one 8-row atom to the next, lbo unused (1).
// MN-major: sbo = 1024 from one group of 8 K rows to the next, lbo = from one
// 64-wide block of M or N to the next.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
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

// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma (it cannot see that they are in flight).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], bf16 in, fp32 out, both operands
// in shared memory (descriptors da, db); kT: both MN-major (transposed),
// else both K-major.
template <int kT>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kT));
}

// D[64 x 256] += A[64 x 16] * B[16 x 256], bf16 in, fp32 out, both operands
// in shared memory (descriptors da, db); kT: both MN-major (transposed),
// else both K-major.
template <int kT>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(kT));
}

template <int BN, int kT>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256) wgmma_m64n256k16<kT>(d, da, db);
  else wgmma_m64n128k16<kT>(d, da, db);
}

// relu of two packed bf16: a half whose sign bit is set becomes +0.
__device__ __forceinline__ uint32_t relu2(uint32_t v) {
  return v & ~(((v >> 15) & 0x00010001u) * 0xffffu);
}

// ------------------------------------------------------------------ kernel
// Shared memory from the first 1024-byte boundary (Layout<BN>): the ring
// (stage s: A at s * kStageBytes, B kATile after it), the full, empty and
// loaded barriers (loaded: TMA's boxes have landed, for the relu pass), the
// item of each stage (written by the producer with the stage, read by the
// consumers at an item's first stage; -1 ends the call), two ticket slots.
template <int BN>
struct Smem {
  using L = Layout<BN>;
  uint32_t ring, full, empty, loaded;
  volatile int* items;
  volatile int* tickets;
  __device__ __forceinline__ explicit Smem(uint8_t* raw) {
    const uint32_t r = smem_addr(raw);
    ring = (r + 1023u) & ~1023u;
    uint8_t* base = raw + (ring - r);
    full = ring + L::kStages * L::kStageBytes;
    empty = full + 8 * L::kStages;
    loaded = empty + 8 * L::kStages;
    items = reinterpret_cast<volatile int*>(base + L::kStages * L::kStageBytes + 24 * L::kStages);
    tickets = items + L::kStages;
  }
};

struct Args {
  const bf16* x;   // [B*H*W, C]
  const bf16* dy;  // [B*H*W, Co]
  const bf16* w;   // [9, C, Co] (HWIO)
  bf16* dx;        // [B*H*W, C]
  float* dw;       // [9*C, Co]
  float* part;     // dW's partials [chunks, 9*C, Co] where chunks > 1
  int* counter;    // the item counter, zero at the launch
  Map g;
  int relu;
};

// The TMA descriptors (Plan::tma): dy [B, H, W, Co] in boxes of 64 channels x
// a 128-pixel tile (dx's A) and x 64 pixels (dW's B); x [B, H, W, C] in boxes
// of 64 channels x 64 pixels (dW's A); the taps [9*C, Co] in boxes of 64 co x
// BN rows (dx's B). All in the 128-byte swizzle, zeros outside the tensor.
struct Maps {
  CUtensorMap dy_a, dy_b, x_a, w_b;
};

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// (b, h, w) of pixel p.
__device__ __forceinline__ void pixel_at(const Map& g, int p, int& b, int& h, int& w) {
  const int hw = g.H * g.W;
  b = p / hw;
  const int r = p - b * hw;
  h = r / g.W;
  w = r - h * g.W;
}

template <int BN, bool kTma>
struct Producer {
  using L = Layout<BN>;
  const Args& a;
  const Maps& maps;
  const Smem<BN>& sm;
  int t, stage = 0;
  uint32_t phase = 0;
  uint32_t dx_dst, dw_dst;  // cp.async: the thread's first chunk in a tile (dx: + 2048 i, dW: + 1024 i)

  __device__ __forceinline__ Producer(const Args& a_, const Maps& m_, const Smem<BN>& sm_)
      : a(a_), maps(m_), sm(sm_) {
    t = threadIdx.x;
    const int jc = t & 7, r0 = t >> 3, j16 = t & 15, k0 = t >> 4;
    dx_dst = r0 * 128 + ((jc ^ (r0 & 7)) << 4);
    dw_dst = (j16 >> 3) * 8192 + k0 * 128 + (((j16 & 7) ^ (k0 & 7)) << 4);
  }

  // The next stage, once the consumers have released it; the stage's item
  // for them. Returns its A tile's shared address (B follows).
  __device__ __forceinline__ uint32_t open(int item) {
    mbar_wait(sm.empty + 8 * stage, phase ^ 1);
    if (t == 0) sm.items[stage] = item;
    return sm.ring + stage * L::kStageBytes;
  }

  // The barrier the stage's loads complete on: by TMA under the relu input,
  // loaded (the relu warps hand the stage over); else full.
  __device__ __forceinline__ uint32_t data_bar() const {
    return (kTma && a.relu ? sm.loaded : sm.full) + 8 * stage;
  }

  // Hands the stage over: by TMA, thread 0's expect_tx arrival (`bytes` on
  // their way); by cp.async, each thread's arrival once its copies have
  // landed, and thread 0's for the item it wrote.
  __device__ __forceinline__ void close(uint32_t bytes) {
    const uint32_t bar = data_bar();
    if constexpr (kTma) {
      if (bytes) mbar_expect_tx(bar, bytes);
      else mbar_arrive(bar);
    } else {
      cp_async_arrive(bar);
      if (t == 0) mbar_arrive(bar);
    }
    if (++stage == L::kStages) stage = 0, phase ^= 1;
  }

  // A dx item: its 9*Co / 64 stages, tap-major.
  __device__ __forceinline__ void dx_item(int item, const Item& it, const Plan& P) {
    const Map& g = a.g;
    const int blocks = g.Co / kBK;
    if constexpr (kTma) {
      int b, h0, w0;
      pixel_at(g, it.m0, b, h0, w0);
      for (int kb = 0; kb < it.nk; ++kb) {
        const uint32_t sa = open(item), sb = sa + kATile, bar = data_bar();
        const int tp = kb / blocks, co0 = (kb - tp * blocks) * kBK;
        // the tile's pixels shifted by the tap: (h + 1 - tp / 3, w + 1 - tp % 3)
        tma_load_4d(sa, &maps.dy_a, bar, co0, w0 + 1 - tp % 3, h0 + 1 - tp / 3, b);
        tma_load_2d(sb, &maps.w_b, bar, co0, tp * g.C + it.n0);
        close(kATile + L::kBTile);
      }
      return;
    }
    const int jc = t & 7, r0 = t >> 3, hw = g.H * g.W;
    // per row: its pixel p << 5 | which neighbours lie in the map (bit 0: the
    // row above, 1: below, 2: the column left, 3: right; 4: p < B*H*W)
    int pix[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = it.m0 + r0 + 16 * i, r = p % hw, h = r / g.W, w = r - h * g.W;
      pix[i] = p << 5 | (h > 0) | (h < g.H - 1) << 1 | (w > 0) << 2 | (w < g.W - 1) << 3 |
               (p < P.np) << 4;
    }
    const bf16* wb = a.w + (size_t)(it.n0 + r0) * g.Co + 8 * jc;
    for (int kb = 0; kb < it.nk; ++kb) {
      const uint32_t sa = open(item), sb = sa + kATile;
      const int tp = kb / blocks, co0 = (kb - tp * blocks) * kBK;
      const int sh = 1 - tp / 3, sw = 1 - tp % 3;  // source pixel (h + sh, w + sw)
      const int need = (sh < 0 ? 1 : sh > 0 ? 2 : 0) | (sw < 0 ? 4 : sw > 0 ? 8 : 0) | 16;
      const int shift = sh * g.W + sw;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool ok = (pix[i] & need) == need;
        const bf16* src = ok ? a.dy + (size_t)((pix[i] >> 5) + shift) * g.Co + co0 + 8 * jc : a.dy;
        cp_async16(sa + dx_dst + 2048 * i, src, ok ? 16u : 0u);
      }
      // B: rows n = c of the tile, 64 co of tap tp each
      const bf16* wk = wb + (size_t)tp * g.C * g.Co + co0;
#pragma unroll
      for (int i = 0; i < BN / 16; ++i)
        cp_async16(sb + dx_dst + 2048 * i, wk + (size_t)16 * i * g.Co, 16u);
      close(0);
    }
  }

  // A dW item: its chunk's pixels, 64 a stage.
  __device__ __forceinline__ void dw_item(int item, const Item& it) {
    const Map& g = a.g;
    const int tap = it.m0 / g.C, ci0 = it.m0 - tap * g.C, di = tap / 3 - 1, dj = tap % 3 - 1;
    if constexpr (kTma) {
      for (int kb = 0; kb < it.nk; ++kb) {
        const uint32_t sa = open(item), sb = sa + kATile, bar = data_bar();
        int b, h, w;
        pixel_at(g, it.p0 + kb * kBK, b, h, w);
        // A: x at the 64 pixels shifted by the tap, two 64-wide blocks of ci;
        // B: dy at the pixels, BN / 64 blocks of co; each block 64 K rows
#pragma unroll
        for (int blk = 0; blk < 2; ++blk)
          tma_load_4d(sa + 8192 * blk, &maps.x_a, bar, ci0 + 64 * blk, w + dj, h + di, b);
#pragma unroll
        for (int blk = 0; blk < BN / 64; ++blk)
          tma_load_4d(sb + 8192 * blk, &maps.dy_b, bar, it.n0 + 64 * blk, w, h, b);
        close(kATile + L::kBTile);
      }
      return;
    }
    const int j16 = t & 15, k0 = t >> 4, hw = g.H * g.W;
    const long long xs = (long long)(di * g.W + dj) * g.C + ci0 + 8 * j16;  // + p * C: row p's source
    const bf16* ds = a.dy + it.n0 + 8 * j16;
    int ph[8], pw[8];  // (h, w) of each row's pixel at this stage
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (it.p0 + k0 + 8 * i) % hw;
      ph[i] = r / g.W;
      pw[i] = r - ph[i] * g.W;
    }
    for (int kb = 0; kb < it.nk; ++kb) {
      const uint32_t sa = open(item), sb = sa + kATile;
      const int pk = it.p0 + kb * kBK + k0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = pk + 8 * i, h = ph[i] + di, w = pw[i] + dj;
        const bool in = p < it.p1;
        const bool ok = in && h >= 0 && h < g.H && w >= 0 && w < g.W;
        cp_async16(sa + dw_dst + 1024 * i, ok ? a.x + (xs + (long long)p * g.C) : a.x,
                   ok ? 16u : 0u);
        // B: BN co of pixel p, 128 at a time (two 64-wide blocks, 16 KB apart)
#pragma unroll
        for (int hb = 0; hb < BN / 128; ++hb)
          cp_async16(sb + dw_dst + 16384 * hb + 1024 * i,
                     in ? ds + (size_t)p * g.Co + 128 * hb : a.dy, in ? 16u : 0u);
        pw[i] += kBK;  // the pixel 64 on, for the next stage
        while (pw[i] >= g.W) pw[i] -= g.W, ++ph[i];
        while (ph[i] >= g.H) ph[i] -= g.H;
      }
      close(0);
    }
  }
};

// The producer: items come one at a time from the counter. By TMA (Plan::tma)
// thread 0 alone takes the tickets and issues a stage's boxes (2 for a dx
// stage, 2 + BN / 64 for a dW one), the rest of the warpgroup idle. By
// cp.async the warpgroup (threads 0-127): thread 0 takes a ticket, the
// warpgroup meets, and every thread reads it (two slots: thread 0 writes the
// other one next, after the next meeting); thread t copies, for a dx item,
// 16-byte chunk t % 8 of rows t / 8 + 16 i of both tiles (A: 128 pixels x 64
// co of one tap, i < 8; B: BN channels c x the same 64 co, i < BN / 16); for
// a dW item, chunk j = t % 16 of K rows t / 16 + 8 i (i < 8) of A (64 pixels x
// 128 ci) and chunks j + 16 hb (hb < BN / 128) of B (64 pixels x BN co): chunk
// j lies in the 64-wide block j / 8, at chunk j % 8 of its row, as a TMA box
// puts it. Ticket n_items and past: one last stage with item -1 ends the
// consumers.
// The relu warps (TMA under the relu input: producer warps 1-3, 96 threads):
// stage by stage as the boxes land, they zero the negative values of a dW
// item's A tile (16 KB, chunk ht + 96 i of 16 bytes a thread), fence the
// proxies and arrive on the stage's full barrier (96 arrivals); a dx stage
// they hand over as it is; item -1 ends them.
template <int BN>
__device__ __forceinline__ void relu_warps(const Args& a, const Plan& P, const Smem<BN>& sm) {
  using L = Layout<BN>;
  const int ht = threadIdx.x - 32;
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(sm.loaded + 8 * stage, phase);
    const int item = sm.items[stage];
    if (item >= 0 && item_at(item, a.g, P).dw) {
      const uint32_t base = sm.ring + stage * L::kStageBytes;
      for (int q = ht; q < kATile / 16; q += 96) {
        uint32_t v0, v1, v2, v3;
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
                     : "r"(base + 16 * q)
                     : "memory");
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(base + 16 * q),
                     "r"(relu2(v0)), "r"(relu2(v1)), "r"(relu2(v2)), "r"(relu2(v3))
                     : "memory");
      }
      fence_proxy_async();
    }
    mbar_arrive(sm.full + 8 * stage);
    if (item < 0) break;
    if (++stage == L::kStages) stage = 0, phase ^= 1;
  }
}

template <int BN, bool kTma>
__device__ __forceinline__ void produce(const Args& a, const Maps& maps, const Plan& P,
                                        const Smem<BN>& sm) {
  if constexpr (kTma) {
    if (threadIdx.x >= 32 && a.relu) relu_warps<BN>(a, P, sm);
    if (threadIdx.x != 0) return;
  }
  Producer<BN, kTma> pr(a, maps, sm);
  const int n_items = P.n_dx + P.n_dw;
  for (int slot = 0;; slot ^= 1) {
    int item;
    if constexpr (kTma) {
      item = atomicAdd(a.counter, 1);
    } else {
      if (pr.t == 0) sm.tickets[slot] = atomicAdd(a.counter, 1);
      producer_sync();
      item = sm.tickets[slot];
    }
    if (item >= n_items) {
      pr.open(-1);
      pr.close(0);
      break;
    }
    const Item it = item_at(item, a.g, P);
    if (it.dw) pr.dw_item(item, it);
    else pr.dx_item(item, it, P);
  }
  if constexpr (!kTma) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The consumer warpgroups (threads 128-383): warpgroup cw = 0, 1 takes rows
// 64 cw .. 64 cw + 63 of each tile. Thread (warp w of the warpgroup, lane l)
// holds rows 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) + {0, 1}, j < BN / 8.
// The ReLU of x for dW's A where the copies load it (by TMA the relu warps
// pass over it): each warpgroup zeroes the negative values of its own 8 KB
// half of the stage's A tile (a 64-wide block of ci; 4 chunks of 16 bytes a
// thread), fences the proxies and meets on a named barrier before its
// products read it.
template <int BN, bool kTma>
__device__ __forceinline__ void consume(const Args& a, const Plan& P, const Smem<BN>& sm) {
  using L = Layout<BN>;
  const Map& g = a.g;
  const int cw = (threadIdx.x >> 7) - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int ct = threadIdx.x & 127;
  int stage = 0;
  uint32_t phase = 0;
  float acc[BN / 2];
  for (;;) {
    mbar_wait(sm.full + 8 * stage, phase);
    const int item = sm.items[stage];
    if (item < 0) break;
    const Item it = item_at(item, g, P);
    const bool relu_a = !kTma && it.dw && a.relu;  // by TMA the relu warps have run
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int kb = 0; kb < it.nk; ++kb) {
      if (kb > 0) mbar_wait(sm.full + 8 * stage, phase);
      // the copies wrote through the generic proxy, wgmma reads through the
      // async one (TMA's boxes arrive through it; the relu warps fence their own)
      if constexpr (!kTma) fence_proxy_async();
      const uint32_t sa = sm.ring + stage * L::kStageBytes, sb = sa + kATile;
      if (relu_a) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t q = sa + cw * 8192 + 16 * (ct + 128 * i);
          uint32_t v0, v1, v2, v3;
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
                       : "r"(q)
                       : "memory");
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(q), "r"(relu2(v0)),
                       "r"(relu2(v1)), "r"(relu2(v2)), "r"(relu2(v3))
                       : "memory");
        }
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
      }
      fence_regs(acc);
      wgmma_fence();
      if (it.dw) {  // MN-major: 8 K rows 1024 bytes apart, a k16 is 2048 bytes on
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_tile<BN, 1>(acc, sw128_desc(sa + cw * 8192 + 2048 * kk, 8192, 1024),
                            sw128_desc(sb + 2048 * kk, 8192, 1024));
      } else {      // K-major: a k16 is 32 bytes on within the 128-byte rows
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_tile<BN, 0>(acc, sw128_desc(sa + cw * 8192 + 32 * kk, 16, 1024),
                            sw128_desc(sb + 32 * kk, 16, 1024));
      }
      wgmma_commit();
      fence_regs(acc);
      if (kb > 0) {
        wgmma_wait<1>();  // the previous stage's products are done: release it
        fence_regs(acc);
        if (lane == 0) mbar_arrive(sm.empty + 8 * prev);
        __syncwarp();
      }
      prev = stage;
      if (++stage == L::kStages) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(sm.empty + 8 * prev);
    __syncwarp();

    const int row0 = it.m0 + 64 * cw + 16 * warp + (lane >> 2), col0 = it.n0 + 2 * (lane & 3);
    if (it.dw) {
      float* out = P.chunks == 1 ? a.dw : a.part + (size_t)it.z * 9 * g.C * g.Co;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* o = out + (size_t)(row0 + 8 * h) * g.Co + col0;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    } else {
      // Rounded to bf16, then each pair of 8-column groups (j, j + 1) of a row
      // regrouped across the row's 4 lanes, so that lane q writes columns
      // 8 j + 4 q .. + 3 (8 bytes; the 4 lanes a 32-byte sector): lane q holds
      // columns 2 q, 2 q + 1 of both groups, lanes 2 (q % 2) and + 1 hold q's.
      // Under the relu input the row's x comes first, all its loads in flight
      // at once (a load between two stores would wait out its latency alone).
      const int q = lane & 3, src = (lane & ~3) | ((2 * q) & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = row0 + 8 * h;
        const size_t off = (size_t)p * g.C + it.n0 + 4 * q;
        uint2 xr[BN / 16];
        if (a.relu && p < P.np) {
#pragma unroll
          for (int j = 0; j < BN / 8; j += 2)
            xr[j / 2] = __ldg(reinterpret_cast<const uint2*>(a.x + off + 8 * j));
        }
#pragma unroll
        for (int j = 0; j < BN / 8; j += 2) {
          const __nv_bfloat162 wa = __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          const __nv_bfloat162 wb =
              __floats2bfloat162_rn(acc[4 * j + 4 + 2 * h], acc[4 * j + 4 + 2 * h + 1]);
          const uint32_t ua = *reinterpret_cast<const uint32_t*>(&wa);
          const uint32_t ub = *reinterpret_cast<const uint32_t*>(&wb);
          const uint32_t a0 = __shfl_sync(0xffffffffu, ua, src);
          const uint32_t a1 = __shfl_sync(0xffffffffu, ua, src + 1);
          const uint32_t b0 = __shfl_sync(0xffffffffu, ub, src);
          const uint32_t b1 = __shfl_sync(0xffffffffu, ub, src + 1);
          uint2 v = q < 2 ? make_uint2(a0, a1) : make_uint2(b0, b1);
          if (p >= P.np) continue;  // the ragged edge (after the quad's shuffles)
          if (a.relu) {  // relu'(x): dx is exactly 0 where x <= 0
            const uint2 xv = xr[j / 2];
            const __nv_bfloat162 x0 = *reinterpret_cast<const __nv_bfloat162*>(&xv.x);
            const __nv_bfloat162 x1 = *reinterpret_cast<const __nv_bfloat162*>(&xv.y);
            v.x &= (__low2float(x0) > 0.f ? 0x0000ffffu : 0u) | (__high2float(x0) > 0.f ? 0xffff0000u : 0u);
            v.y &= (__low2float(x1) > 0.f ? 0x0000ffffu : 0u) | (__high2float(x1) > 0.f ? 0xffff0000u : 0u);
          }
          *reinterpret_cast<uint2*>(a.dx + off + 8 * j) = v;
        }
      }
    }
  }
}

template <int BN, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_bwd_bf16_kernel(const Args a, const __grid_constant__ Maps maps) {
  extern __shared__ uint8_t smem_raw[];
  const Smem<BN> sm(smem_raw);
  const Plan P = dw_plan(a.g);
  if (threadIdx.x == 0) {
    for (int s = 0; s < Layout<BN>::kStages; ++s) {
      mbar_init(sm.full + 8 * s, kTma ? (a.relu ? 96 : 1) : 129);
      mbar_init(sm.empty + 8 * s, kConsumerWarps);
      mbar_init(sm.loaded + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    produce<BN, kTma>(a, maps, P, sm);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<BN, kTma>(a, P, sm);
  }
}

// -------------------------------------------------------------------- host
// Internal linkage: each kernel library keeps its own per-device state.

// The kernel's attributes, checked once a device: setmaxnreg moves registers
// within the CTA's allocation, so the producer's release must cover the
// consumers' request (else they would wait forever); dynamic shared memory
// above 48 KB. sms: the SM count; regs: the kernel's registers as compiled.
template <int BN, bool kTma>
static cudaError_t setup(int& sms, int& regs) {
  constexpr int kMaxDevices = 64;
  static int sm_count[kMaxDevices] = {0}, num_regs[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, conv3x3_bwd_bf16_kernel<BN, kTma>);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * kThreads < 128 * kProducerRegs + 256 * kConsumerRegs)
      return cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(conv3x3_bwd_bf16_kernel<BN, kTma>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<BN>::kSmemBytes);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    num_regs[dev] = attr.numRegs;
    sm_count[dev] = n;
  }
  sms = sm_count[dev];
  regs = num_regs[dev];
  return cudaSuccess;
}

// CTAs of the kernel resident per SM (0 on an error).
template <int BN, bool kTma>
static int ctas_per_sm() {
  int sms = 0, regs = 0, n = 0;
  if (setup<BN, kTma>(sms, regs) != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv3x3_bwd_bf16_kernel<BN, kTma>,
                                                    kThreads, Layout<BN>::kSmemBytes) != cudaSuccess)
    return 0;
  return n;
}

// Registers a thread of the kernel as compiled (0 on an error).
template <int BN, bool kTma>
static int kernel_regs() {
  int sms = 0, regs = 0;
  return setup<BN, kTma>(sms, regs) == cudaSuccess ? regs : 0;
}

// libcuda's cuTensorMapEncodeTiled, through the runtime's entry-point query
// (no link to libcuda), looked up once a call (no process-wide state); null
// where the installed libcuda lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                       &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
    return nullptr;
#else
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
          cudaSuccess || q != cudaDriverEntryPointSuccess)
    return nullptr;
#endif
  return reinterpret_cast<EncodeTiled>(p);
}

// A bf16 tensor map of `rank` dimensions (dims[0] innermost, contiguous) in
// boxes of box[0..rank-1], the 128-byte swizzle, zeros outside.
static bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rank,
                   const cuuint64_t* dims, const cuuint32_t* box) {
  cuuint64_t strides[3];
  cuuint64_t stride = dims[0] * 2;
  for (int i = 1; i < rank; ++i) {
    strides[i - 1] = stride;
    stride *= dims[i];
  }
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The four maps of Maps for a call (Plan::tma); false if one cannot be made.
static bool make_maps(Maps& m, const Args& a, int bn) {
  const Map& g = a.g;
  const cuuint32_t tw = g.W < kBM ? g.W : kBM, rw = g.W < kBK ? g.W : kBK;  // box widths
  const cuuint64_t dy_dims[4] = {(cuuint64_t)g.Co, (cuuint64_t)g.W, (cuuint64_t)g.H,
                                 (cuuint64_t)g.B};
  const cuuint64_t x_dims[4] = {(cuuint64_t)g.C, (cuuint64_t)g.W, (cuuint64_t)g.H,
                                (cuuint64_t)g.B};
  const cuuint64_t w_dims[2] = {(cuuint64_t)g.Co, (cuuint64_t)9 * g.C};
  const cuuint32_t tile_box[4] = {kBK, tw, kBM / tw, 1};  // 64 channels x a 128-pixel tile
  const cuuint32_t run_box[4] = {kBK, rw, kBK / rw, 1};   // 64 channels x 64 pixels
  const cuuint32_t w_box[2] = {kBK, (cuuint32_t)bn};
  const EncodeTiled fn = encode_tiled();
  return fn != nullptr && encode(fn, &m.dy_a, a.dy, 4, dy_dims, tile_box) &&
         encode(fn, &m.dy_b, a.dy, 4, dy_dims, run_box) &&
         encode(fn, &m.x_a, a.x, 4, x_dims, run_box) && encode(fn, &m.w_b, a.w, 2, w_dims, w_box);
}

template <int BN, bool kTma>
static cudaError_t launch_kernel(const Args& a, const Maps& maps, int items, cudaStream_t st) {
  int sms = 0, regs = 0;
  const cudaError_t err = setup<BN, kTma>(sms, regs);
  if (err != cudaSuccess) return err;
  conv3x3_bwd_bf16_kernel<BN, kTma>
      <<<items < sms ? items : sms, kThreads, Layout<BN>::kSmemBytes, st>>>(a, maps);
  return cudaGetLastError();
}

// dx (bf16) and dW (fp32) of one conv on bf16 x, dy and taps w (HWIO, [9, C,
// Co]); part: scratch of part_floats(g) floats. Needs C and Co multiples of
// 128 and B*H*W*max(C, Co) < 2^31; any B*H*W. The item counter is zeroed on
// `st`, then the kernel (dw_plan's tile width and loads), then (more than one
// chunk) the in-order reduction of dW's partials. Returns cudaGetLastError()
// after the launches (cudaErrorNotSupported where the TMA descriptors cannot
// be made).
static cudaError_t conv3x3_bwd_launch(const bf16* x, const bf16* dy, const bf16* w, bf16* dx,
                                      float* dw, float* part, const Map& g, bool relu,
                                      cudaStream_t st) {
  if (g.C % 128 || g.Co % 128) return cudaErrorInvalidValue;
  if ((long long)npix(g) * (g.C > g.Co ? g.C : g.Co) >= (1ll << 31)) return cudaErrorInvalidValue;
  const Plan P = dw_plan(g);
  const size_t n_dw = (size_t)9 * g.C * g.Co;
  int* counter = reinterpret_cast<int*>(part + (P.chunks > 1 ? P.chunks * n_dw : 0));
  const Args a{x, dy, w, dx, dw, part, counter, g, relu ? 1 : 0};
  Maps maps{};
  if (P.tma && !make_maps(maps, a, P.bn)) return cudaErrorNotSupported;
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  const int items = P.n_dx + P.n_dw;
  if (P.tma)
    err = P.bn == 256 ? launch_kernel<256, true>(a, maps, items, st)
                      : launch_kernel<128, true>(a, maps, items, st);
  else
    err = P.bn == 256 ? launch_kernel<256, false>(a, maps, items, st)
                      : launch_kernel<128, false>(a, maps, items, st);
  if (err != cudaSuccess || P.chunks == 1) return err;
  return msig_f32::reduce<false>(part, nullptr, dw, n_dw, P.chunks, st);
}

}  // namespace msig_bf16
