// The int8 conv main loop of the trunk's 3x3 sites, the decoder's ConvT site
// and the encoder's 4x4/s2 sites on Hopper (sm_90a): an implicit GEMM on wgmma
// over a geometry, exact in int32, fed by a cp.async ring; the tile then
// leaves in one of three ways (Epi): its int32 rows and the statistics, the
// statistics alone, or int8. (This header was conv3x3_i8_wgmma.cuh, the 3x3
// alone; it is that kernel generalised over conv_int8.cuh's geometries, and
// renamed.)
//
// Statistics: the exact int64 block of conv_int8.cuh (sum, two-word sum of
// squares, zero-masked min and max per (sample, channel); the true min and
// max in the kTrue mode of the v1 sites and the single-kernel trunk).
//
// Users and the TPU kernels they replace:
// - Conv3x3Geom, Epi::kInt32: pass A of msig_conv3x3_adain_relu_requant and
//   msig_conv3x3_adain_residual_requant (msig_tpu/ops/fused_conv_int8_v2.py::
//   _kernel_relu and _kernel_res, their zero-masked extremes :68-87), and of
//   msig_conv3x3_adain_residual_hifi and msig_conv3x3_adain_residual_hifi2
//   (::_kernel_res_hifi and _kernel_res_hifi2, the hi-fi residual carries);
// - Conv3x3Geom, Epi::kInt32 with the true extremes: pass A of
//   msig_conv3x3_adain_relu_requant_v1 (msig_tpu/ops/fused_conv_int8.py::
//   conv3x3_adain_relu_requant, v1's true extremes :125-126), see
//   conv3x3_adain_relu_requant.cu;
// - ConvT4x4s2Geom, Epi::kStats then Epi::kRequant: the whole of
//   msig_convt4x4s2_in_relu_requant (fused_conv_int8_v2.py::
//   convt4x4s2_in_relu_requant_ps, msig_tpu/ops/fused_dec_int8.py::up1_s2d16
//   and up1_s2d16_hbm) and of msig_convt4x4s2_kcat on the K-major copy of
//   the 9-tap operand (fused_conv_int8_v2.py::convt4x4s2_in_relu_requant,
//   the same function; with the true extremes and the unfolded requant,
//   fused_conv_int8.py::convt4x4s2_in_relu_requant, v1), see
//   convt4x4s2_in_relu_requant.cu;
// - Conv4x4s2Geom, Epi::kStats then Epi::kRequant: the whole of
//   msig_conv4x4s2_in_relu_requant (msig_tpu/ops/fused_enc_int8.py::
//   enc1_in_relu_requant and enc2_in_relu_requant), see
//   conv4x4s2_in_relu_requant.cu;
// - Enc1PhaseGeom, Epi::kStats then Epi::kRequant: the whole of
//   msig_enc1_phases_in_relu_requant (::enc1_in_relu_requant_im2col, a weight
//   block per output phase), the same source;
// - Conv3x3Geom, Epi::kInt32 with the true extremes, produce and consume
//   called by a persistent kernel: the 16 convs of msig_fused_trunk_blocks
//   (msig_tpu/ops/fused_trunk_v3.py::fused_trunk_blocks), see
//   fused_trunk_blocks.cu.
// enc0_in_relu_requant.cu runs a transposed product of its own on the wgmma
// helpers below (m64n256k32, the swizzle descriptor, the fences).
//
// Bound on an H100 at the trunk's [8, 64, 64, 256]: 2 * 32768 * 256 * 2304
// = 38.7 G int8 operations (19.5 us at 1,979 TOP/s) against 17.4 MB that must
// move. What held conv_int8.cuh's mma.sync pass A at about a tenth of that: no
// overlap of loads and math (one stage, two block barriers per 64 channels of
// a tap), the weights transposed byte by byte in every CTA on every call, each
// input window staged once per 128 output channels, and mma.sync itself. Here:
//
// - The weights come K-major, [phases, Cout, K] with K = taps * Cin and column
//   t*Cin + ci (fused_conv_int8_v2.py::pack_weights_kmajor for the 3x3,
//   [Cout, 9*C]; ::pack_convt_weights_ps_kmajor for the ConvT, [4, Cout,
//   4*Cin]; fused_enc_int8.py::pack_conv4x4_kmajor for the 4x4/s2 conv,
//   [Cout, 16*Cin], and ::pack_enc1_im2col_kmajor for its four-phase form,
//   [4, Cout, 16*Cin]; all made once at quantization): wgmma takes 8-bit A and B only
//   K-major, and a 16-byte copy of a weight row then lands as it is.
// - GEMM per phase q: M = the pixels of the grid (the input map at stride 1,
//   the output map of the 4x4/s2 conv, whose row (gy, gx) reads input pixels
//   (2gy + dy, 2gx + dx), dy, dx in -1 .. 2, and a quarter of it in the
//   four-phase form, whose row of phase q reads (4gy + dy, 4gx + dx), dy, dx
//   in -1 .. 4), N = Cout, K = taps * Cin, in K blocks of 128 bytes (kBK, one
//   swizzle row): one a stage for the 3x3, whose tile is 9 taps deep, and for
//   the 4x4/s2 conv; two for the phased geometries (the ConvT, whose tile is
//   4*Cin bytes of K, and the four-phase 4x4/s2 conv) (kSubBlocks).
//   The 16-byte chunk jc of K block kb holds K index 128*kb + 16*jc: one tap
//   and 128 channels of it where Cin % 128 == 0, two taps of 64 channels
//   each at Cin = 64. A CTA tile is kBM = 128 pixels of one phase of one sample
//   (H*W % 128 == 0) by BN channels: BN = 256 where Cout % 256 == 0 and the
//   geometry has one phase (the trunk at C = 256: each input window staged
//   once per tile), else 128 where Cout % 128 == 0, else 64. Two consumer
//   warpgroups of 64 rows each run wgmma.mma_async m64nBNk32 s32.s8.s8, both
//   operands read from shared memory in the 128-byte swizzle (8-row atoms of
//   128-byte rows, 16-byte chunk c of row r at chunk c ^ (r % 8)); the
//   accumulator is BN/2 registers a thread (setmaxnreg gives the consumers
//   kConsumerRegs, the producer kProducerRegs).
// - A ring of as many stages as fit, up to kMaxStages (Layout::kStages: 4 of
//   48 KB for the 3x3 at BN = 256, 3 of 64 KB and 4 of 48 KB for the ConvT at
//   BN = 128 and 64), filled by a producer warpgroup with 16-byte cp.async.cg
//   copies that write zeros (source size 0)
//   for taps outside the map (the 3x3's border, the ConvT's rows and columns
//   -1 and H or W), for any W: a TMA box tiles a 128-pixel run only where W
//   divides 128 or 128 divides W, and the trunk of a 384^2 input has W = 96.
//   Each producer thread keeps, per row of a tile, its input pixel's offset
//   and which of the rows and columns its taps reach lie in the map, so that
//   a copy costs a shift, a mask and an add: with stride S a tap's row offset
//   dy is in -1 .. S; rows S*gy .. S*gy + S - 1 always lie in the map, row
//   S*gy - 1 where gy > 0 and row S*gy + S where gy < GH - 1 (bits 0, 1, 2 for
//   the three cases; columns likewise, bits 3, 4, 5).
//   mbarriers hand the stages over: a stage is full when all 128 producer
//   threads' copies have landed (cp.async.mbarrier.arrive.noinc) and empty
//   when the 8 consumer warps' wgmma on it have completed (wait_group 1
//   releases the stage before the one just issued). cp.async writes through
//   the generic proxy and wgmma reads through the async proxy, so each
//   consumer fences the proxies (fence.proxy.async) after its full-wait.
// - Persistent CTAs, one per SM (gridDim.x = min(tiles, SMs)); channel tiles
//   vary fastest, then phases, then pixel blocks, then samples. The int32
//   pass of a one-phase geometry (rows 1-4) walks tile = blockIdx.x + i *
//   gridDim.x, so the SMs work on neighbouring tiles; the two-pass sites
//   (Epi::kStats, Epi::kRequant) and every phased geometry give each CTA a
//   contiguous run of tiles, so a CTA meets at most a few samples (the
//   statistics leave and the requant scale is rebuilt once per sample and
//   channel tile, where a strided walk would change sample at nearly every
//   tile) and the four phases of a pixel block, which read the same input
//   rows, follow each other. Either way the producer loads the next tile's
//   stages while the consumers finish the last one.
// - The statistics come from the registers. A consumer thread holds rows
//   16*warp + lane/4 (+8) and columns 8j + 2*(lane%4) + {0, 1} of its
//   warpgroup's 64 rows. Per column it folds its two rows, then the 8 lanes of
//   one lane%4 halve their columns three times (shuffles at xor 16, 8, 4: 7
//   shuffles per 8 columns where a full reduction takes 24), so that lane
//   (g = lane/4, lane%4) ends with the warp's 16-row sums of column 32c +
//   8*(g/2) + 2*(lane%4) + g%2 of chunk c; those meet the other warps' in a
//   shared [5][BN] int64 block by shared atomics, which goes to the statistics
//   block by global int64 atomics when the next tile is of another (sample,
//   channel tile). Every sum is an integer: the result does not depend on the
//   order of the warps or the CTAs. The sum of squares is split per warp (16
//   squares < 2^62) into its low and high 32-bit words, as conv_int8.cuh
//   splits it per warp of 32 rows; the epilogues read hi * 2^32 + lo, the
//   same integer. At BN = 64 (the ConvT's up1, a tile of 4096 outputs) each
//   thread first gathers its columns' partials in registers over up to 16
//   tiles (RegStats) and the fold runs once for all of them.
// - Epi::kInt32: the accumulator leaves by 8-byte stores straight from the
//   fragment (four lanes write 32 contiguous bytes of one row, a full sector)
//   at the geometry's output pixel.
// - Epi::kRequant (after Epi::kStats has finished the statistics block): the
//   consumers rebuild the sample's requant from the block (channel_affine,
//   the amax and the scale of conv_int8.cuh's relu epilogue, by its helpers),
//   map their accumulator registers through the staging type and
//   relu_requant_folded (kTrue: the unfolded affine and scale of
//   true_relu_requant_kernel, relu_requant_unfolded), stage the int8 tile
//   per warp in shared memory and write it as 16-byte rows at the geometry's
//   output pixels. The int32 accumulator never reaches device memory; the
//   conv runs twice.
//
// Tried and measured on the 3x3 (tools/trunk_wgmma_variants_torch.py, which
// builds variants of this header; H100 80GB HBM3 at 700 W), pass A alone at
// [8, 64, 64, 256] (CUDA events over 20 launches back to back, median of 5; at
// [8, 128, 128, 256] in brackets), as first built: 0.0628 ms (0.2255); one CTA
// per tile, 256 CTAs, 0.0643 (0.2339); 3 stages 0.0632 (0.2284). Cut down to
// find the limit: without B's loads 0.0550, without A's 0.0517, without
// either 0.0482; without the statistics 0.0520, without them and the stores
// 0.0243 (80% of the int8 peak). So the main loop is fast and the tile's
// epilogue is not: the stores take 28 us, the statistics 11 (the 32 MB of
// int32 leave as all SMs end a tile together, at about 1.2 TB/s). Two ways to
// take the stores off the consumers were slower in trial builds (not
// committed): the producer warpgroup split into 2 loader warps and 2 storer
// warps draining a staging buffer (two warps cannot keep the ring full), and
// the consumers handing staged rows to the TMA engine (cp.async.bulk), which
// without the statistics ran no faster than these stores: the write costs the
// same whoever issues it. Keeping the accumulator on chip is the lever, which
// the ConvT's two passes pull (tools/convt_wgmma_variants_torch.py times them
// against the int32 round trip on this main loop).
//
// Needs Cin % 64 == 0 (% 128 for the 3x3), Cout % 64 == 0 (% 128 for the
// four-phase conv), a grid of (H/S) * (W/S) pixels, a multiple of 128 (the
// wrappers check), the statistics block at its neutral values (zeroed; in the
// kTrue mode the extremes at the ends of the int32 range: the launchers below
// set it on the stream), and a kernel register count that lets setmaxnreg
// rebalance (checked before the launch: a shortfall would block the
// consumers' setmaxnreg.inc).
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv_int8.cuh"

namespace msig {
namespace wgmma {

constexpr int kBM = 128;           // pixels a tile per m64 block of each consumer warpgroup
constexpr int kBK = 128;           // bytes of K a stage: one swizzle row
constexpr int kMaxStages = 8;      // the ring takes what shared memory leaves, up to this
constexpr int kSmem = 232448;      // the shared memory a CTA may have
constexpr int kThreads = 384;      // warpgroup 0 produces, 1 and 2 consume
constexpr int kProducerRegs = 56;  // 128 * 56 + 256 * 224 = 384 * 168, the kernel's budget
constexpr int kConsumerRegs = 224;
constexpr int kConsumerWarps = 8;
constexpr int kConsumerThreads = kConsumerWarps * 32;

// What the consumers do with a finished tile (see the header comment).
enum class Epi { kInt32, kStats, kRequant };

// K blocks of kBK bytes a stage: one for the 3x3, whose tile is 9 taps deep,
// and for the 4x4/s2 conv (two were no faster at enc1 on the card, and at
// BN = 256 would leave a ring of two stages); two for the ConvT, whose tile is
// 4*Cin bytes of K, so that a stage's products are twice as long against its
// hand-over (6% at up1 on the card).
template <class Geom>
constexpr int kSubBlocks = Geom::kPhases > 1 ? 2 : 1;

// MB: m64 blocks a consumer warpgroup runs, so a tile is kBM * MB pixels; KS:
// K sub-blocks a stage. A stage is KS sub-blocks of A, then KS of B.
template <int BN, Epi E = Epi::kInt32, int MB = 1, int KS = 1>
struct Layout {
  static constexpr int kA1 = kBM * MB * kBK;  // one sub-block of A: 16 KB at MB = 1
  static constexpr int kB1 = BN * kBK;        // of B: 32 KB at BN = 256
  static constexpr int kA = KS * kA1;
  static constexpr int kKBytes = KS * kBK;  // bytes of K a stage
  static constexpr int kStage = kA + KS * kB1;
  // kRequant: the int8 tile, staged per warp (16 rows each, one m64 block
  // after the other), rows padded by 16 bytes so that the 8 rows of one store
  // instruction meet 8 bank groups
  static constexpr int kOutPitch = BN + 16;
  static constexpr int kOut = E == Epi::kRequant ? kConsumerWarps * 16 * kOutPitch : 0;
  static constexpr int kStats = E == Epi::kRequant ? 0 : kStatBlocks * BN * 8;
  // kRequant: the folded affine a2, d2 of the tile's channels and 8 warp maxima
  static constexpr int kAff = E == Epi::kRequant ? 2 * BN * 4 + kConsumerWarps * 4 : 0;
  static constexpr int kFixed = kOut + kStats + kAff + 2 * kMaxStages * 8 + 1024;  // + align
  // as many stages as fit, up to kMaxStages (see the header comment)
  static constexpr int kStages =
      (kSmem - kFixed) / kStage < kMaxStages ? (kSmem - kFixed) / kStage : kMaxStages;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kBars = 2 * kStages * 8;
  static constexpr int kBytes = kRing + kOut + kStats + kAff + kBars + 1024;  // + align to 1024
  static_assert(kStages >= 2 && kBytes <= kSmem, "a ring of two stages at least fits an SM");
};
static_assert(Layout<256>::kStages == 4, "rows 1-2 keep their ring of 4 stages");

// The layout of a geometry's kernels.
template <class Geom, int BN, Epi E, int MB = 1>
using LayoutOf = Layout<BN, E, MB, kSubBlocks<Geom>>;

// The kernels' arguments. y: Epi::kInt32 int32 [B, phases*H*W, Cout];
// Epi::kRequant int8 [B, phases*H*W, Cout]; rows at the geometry's output
// pixels. out_scale: Epi::kRequant, [B] float32 (amax/127 per sample), or null.
struct Args {
  const int8_t* x;     // [B, H, W, Cin]
  const int8_t* wk;    // [phases, Cout, taps * Cin], K-major
  void* y;
  long long* stats;    // the statistics block (conv_int8.cuh), [5*B*Cout + B]
  float* out_scale;
  int B, H, W, Cin, Cout;
  float eps;
};

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
// The same for every N: the instruction's N says how many rows of B it reads.
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

// D[64 x 64] += A[64 x 32] * B[64 x 32]^T, int8 in, int32 out; A and B K-major in
// shared memory (descriptors da, db).
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256) wgmma_m64n256k32(d, da, db);
  else if constexpr (BN == 128) wgmma_m64n128k32(d, da, db);
  else wgmma_m64n64k32(d, da, db);
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

// The neutral value of statistics block k: 0 for the sums and the
// zero-masked extremes; the ends of the int32 range for the true extremes
// (kTrue: the v1 sites, the single-kernel trunk), past every value of an
// accumulator (|y| < 2^29, the wrappers check). A CTA's shared block starts
// there, and so does the global block of a kTrue site (fill_stats): a CTA
// then skips what it left at the start, in either block.
template <bool kTrue>
__device__ __forceinline__ long long stat_neutral(int k) {
  if constexpr (kTrue) return k == 2 ? 0x7fffffffll : (k == 3 ? -0x80000000ll : 0ll);
  else return 0;
}

// Adds a warp's 16 rows of the tile to the CTA's shared statistics block cta
// [kStatBlocks][BN] (zero-masked extremes, or the true ones where kTrue).
// acc[4j + e] holds column 8j + 2*(lane%4) + e of row lane/4, acc[4j + 2 + e]
// the same column 8 rows down.
template <int BN, bool kTrue = false>
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
      mn[k] = kTrue ? min(v0, v1) : min(0, min(v0, v1));
      mx[k] = kTrue ? max(v0, v1) : max(0, max(v0, v1));
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

// The statistics of a thread's columns over several tiles, in registers (pass
// S at BN = 64, where a tile is 4096 outputs and warp_stats per tile would
// cost more than the tile's products): per column k = 2j + e (column 8j +
// 2*(lane%4) + e, as in warp_stats) the sum, the sum of squares as the sums of
// their low and high 32-bit words, and the min and max (zero-masked: they
// start at 0; true where kTrue: at the ends of the int32 range). fold() then
// does warp_stats' reduction once for all the tiles added. The words stay
// exact: a square is below 2^58, so a high word below 2^26, and at most
// kTiles tiles of MB m64 blocks (two rows each) add 2 * 16 = 32 of them.
template <int BN, int MB, bool kTrue = false>
struct RegStats {
  static constexpr int kCols = BN / 4;
  static constexpr int kTiles = 16 / MB;
  long long s[kCols];
  unsigned long long lo[kCols];
  unsigned hi[kCols];
  int mn[kCols], mx[kCols];
  int tiles;

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      s[k] = 0, lo[k] = 0, hi[k] = 0, mn[k] = (int)stat_neutral<kTrue>(2),
      mx[k] = (int)stat_neutral<kTrue>(3);
    tiles = 0;
  }
  __device__ __forceinline__ void add(const int (&acc)[BN / 2]) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 2 * j + e, v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
        const unsigned long long sq =
            (unsigned long long)((long long)v0 * v0) + (unsigned long long)((long long)v1 * v1);
        s[k] += (long long)(v0 + v1);  // |v| < 2^29
        lo[k] += sq & 0xffffffffull;
        hi[k] += (unsigned)(sq >> 32);
        mn[k] = min(mn[k], min(v0, v1));
        mx[k] = max(mx[k], max(v0, v1));
      }
  }
  // Adds the warp's partials to the CTA's shared block and clears them.
  __device__ __forceinline__ void fold(long long* cta, int lane) {
    const int q = lane & 3, g = lane >> 2;
#pragma unroll
    for (int c = 0; c < BN / 32; ++c) {  // chunk c: the thread's columns k = 8c .. 8c + 7
      long long vs[8];
      unsigned long long vlo[8], vhi[8];
      int vmn[8], vmx[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        vs[k] = s[8 * c + k], vlo[k] = lo[8 * c + k], vhi[k] = hi[8 * c + k],
        vmn[k] = mn[8 * c + k], vmx[k] = mx[8 * c + k];
      const long long s8 = fold8(vs, lane, Add());
      const unsigned long long lo8 = fold8(vlo, lane, Add()), hi8 = fold8(vhi, lane, Add());
      const int mn8 = fold8(vmn, lane, Min()), mx8 = fold8(vmx, lane, Max());
      const int col = 32 * c + 8 * (g >> 1) + 2 * q + (g & 1);
      atomicAdd(reinterpret_cast<unsigned long long*>(&cta[0 * BN + col]), (unsigned long long)s8);
      atomicAdd(reinterpret_cast<unsigned long long*>(&cta[1 * BN + col]), lo8);
      atomicMin(&cta[2 * BN + col], (long long)mn8);
      atomicMax(&cta[3 * BN + col], (long long)mx8);
      atomicAdd(reinterpret_cast<unsigned long long*>(&cta[4 * BN + col]), hi8);
    }
    clear();
  }
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// Sample b's requant from the finished statistics block, by the consumer
// threads (ct < kConsumerThreads), as relu_requant_kernel computes it with
// gamma = 1, beta = 0: the amax over all Cout channels (the affine image of
// each channel's extremes: relu_hi of the zero-masked ones, or where kTrue
// true_relu_hi of the true ones), and the folded a2, d2 of the tile's channels
// n0 .. n0 + BN - 1 into shared memory; where kTrue, as
// true_relu_requant_kernel computes it, their affine a, d unfolded (the
// caller maps with relu_scale(amax)). n_out: output pixels per sample.
// Returns amax. The caller syncs the consumers before (the previous tile's map
// reads a2, d2) and this syncs after.
template <int BN, class Stage, bool kTrue = false>
__device__ __forceinline__ float load_requant(const long long* __restrict__ stats, int b, int B,
                                              int Cout, float n_out, float eps, int n0,
                                              float* a2_s, float* d2_s, float* red, int ct) {
  const size_t BC = (size_t)B * Cout;
  float local = 0.f;  // max(hi, 0)
  for (int c = ct; c < Cout; c += kConsumerThreads) {
    const size_t i = (size_t)b * Cout + c;
    float a, d;
    in_affine(stats, nullptr, nullptr, i, BC, n_out, eps, a, d);
    if constexpr (kTrue)
      local = fmaxf(local, true_relu_hi(a, d, (float)stats[2 * BC + i], (float)stats[3 * BC + i]));
    else
      local = fmaxf(local, relu_hi(stats, BC, i, a, d));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, off));
  if ((ct & 31) == 0) red[ct >> 5] = local;
  consumer_sync();
  float amax = red[0];
#pragma unroll
  for (int w = 1; w < kConsumerWarps; ++w) amax = fmaxf(amax, red[w]);
  for (int c = ct; c < BN; c += kConsumerThreads) {
    float a, d;
    in_affine(stats, nullptr, nullptr, (size_t)b * Cout + n0 + c, BC, n_out, eps, a, d);
    if constexpr (kTrue) a2_s[c] = a, d2_s[c] = d;
    else fold_relu(a, d, relu_scale(amax), StageOf<Stage>::kUnscale, a2_s[c], d2_s[c]);
  }
  consumer_sync();
  return amax;
}

// One tile: BM pixels (m0 ..) of phase q of sample b, channels n0 .. n0 + BN - 1.
struct Tile {
  int b, q, m0, n0, key;  // key: (sample, channel tile), what a statistics block or a requant serves
};
__device__ __forceinline__ Tile tile_at(int tile, int tiles_n, int phases, int mblocks, int BM,
                                        int BN) {
  const int tn = tile % tiles_n, r = tile / tiles_n;
  const int q = r % phases, r2 = r / phases;
  const int b = r2 / mblocks;
  return Tile{b, q, (r2 % mblocks) * BM, tn * BN, b * tiles_n + tn};
}

// The kernel body's pieces; see the header comment. grid = min(tiles, SMs),
// block = kThreads, dynamic smem Layout<BN, E, MB>::kBytes. Stage: how
// Epi::kRequant reads the accumulator (StageOf of conv_int8.cuh). MB: m64
// blocks a consumer warpgroup runs (a tile of kBM * MB pixels; the 3x3 runs
// 1). conv_body runs one call in a kernel of its own; the single-kernel trunk
// (fused_trunk_blocks.cu) keeps each warpgroup in its role for the whole
// launch and calls produce and consume once per conv, the ring's barriers
// initialised once and its position (RingPos) carried from call to call.

// Where a kernel's blocks lie in its dynamic shared memory: the Layout from
// the first 1024-byte boundary (the swizzle repeats every 1024 bytes).
template <class Geom, int BN, Epi E, int MB>
struct Body {
  using L = LayoutOf<Geom, BN, E, MB>;
  static_assert((L::kRing + L::kOut + L::kStats + L::kAff) % 8 == 0, "8-byte aligned blocks");
  uint32_t base, full, empty;  // shared addresses: the ring, its full and empty barriers
  uint8_t* out_s;
  long long* cta;
  float *a2_s, *d2_s, *red;

  __device__ __forceinline__ explicit Body(uint8_t* smem_raw) {
    const uint32_t raw = smem_addr(smem_raw);
    base = (raw + 1023u) & ~1023u;
    uint8_t* smem = smem_raw + (base - raw);
    out_s = smem + L::kRing;
    cta = reinterpret_cast<long long*>(smem + L::kRing + L::kOut);
    a2_s = reinterpret_cast<float*>(smem + L::kRing + L::kOut + L::kStats);
    d2_s = a2_s + BN;
    red = d2_s + BN;
    full = base + L::kRing + L::kOut + L::kStats + L::kAff;
    empty = full + 8 * L::kStages;
  }

  // Thread 0 initialises the ring's barriers, all threads set the CTA's
  // statistics block to its neutral values; then the CTA meets.
  template <bool kTrue>
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < L::kStages; ++s) {
        mbar_init(full + 8 * s, 128);
        mbar_init(empty + 8 * s, kConsumerWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if constexpr (E != Epi::kRequant)
      for (int i = threadIdx.x; i < kStatBlocks * BN; i += kThreads)
        cta[i] = stat_neutral<kTrue>(i / BN);
    __syncthreads();
  }
};

// The tiles of one call, and the CTA's share of them.
template <class Geom, int BN, Epi E, int MB>
struct Walk {
  int GH, GW, GHW, mblocks, tiles_n, K, ksteps, first, end, step;

  __device__ __forceinline__ explicit Walk(const Args& p) {
    constexpr int S = Geom::kStride, BM = kBM * MB, KS = kSubBlocks<Geom>;
    // the grid: GH x GW pixels a sample (the input map at stride 1)
    GH = p.H / S, GW = p.W / S, GHW = GH * GW, mblocks = GHW / BM, tiles_n = p.Cout / BN;
    const int tiles = p.B * Geom::kPhases * mblocks * tiles_n;
    K = Geom::kTaps * p.Cin, ksteps = K / (KS * kBK);
    if constexpr (Geom::kPhases > 1 || E != Epi::kInt32) {  // a contiguous run of tiles per CTA
      first = (int)((long long)blockIdx.x * tiles / gridDim.x);
      end = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
      step = 1;
    } else {
      first = blockIdx.x;
      end = tiles;
      step = gridDim.x;
    }
  }
};

// The ring's next stage and its phase parity; each role keeps its own.
struct RingPos {
  int stage;
  uint32_t phase;
};

// The producer warpgroup's part of a call (threads 0-127): thread t copies
// 16-byte chunk t % 8 (K index 128 ks + 16 (t % 8) of stage ks) of rows t / 8
// + 16 i. Returns with its copies in flight.
template <class Geom, int BN, Epi E, int MB>
__device__ __forceinline__ void produce(const Args& p, const Body<Geom, BN, E, MB>& sm,
                                        RingPos& pos) {
  constexpr int S = Geom::kStride, BM = kBM * MB, KS = kSubBlocks<Geom>;
  using L = LayoutOf<Geom, BN, E, MB>;
  const Walk<Geom, BN, E, MB> w(p);
  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int GH = w.GH, GW = w.GW, mblocks = w.mblocks, tiles_n = w.tiles_n, K = w.K;
  const int ksteps = w.ksteps;
  const uint32_t base = sm.base, empty = sm.empty, full = sm.full;
  const int jc = threadIdx.x & 7, r0 = threadIdx.x >> 3;
  int stage = pos.stage;
  uint32_t phase = pos.phase;
  for (int tile = w.first; tile < w.end; tile += w.step) {
    const Tile t = tile_at(tile, tiles_n, Geom::kPhases, mblocks, BM, BN);
    // Per row: its input pixel's offset in its sample, (S*gy*W + S*gx) * Cin
    // (Cin % 64 == 0, so its low 6 bits are free), ORed with which of the
    // rows S*gy - 1, S*gy .. S*gy + S - 1, S*gy + S (bits 0-2) and the same
    // columns (bits 3-5) lie in the map.
    int pix[BM / 16];
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const int m = t.m0 + r0 + 16 * i, gy = m / GW, gx = m - gy * GW;
      pix[i] = S * (gy * W + gx) * Cin | (gy > 0) | 2 | (gy < GH - 1) << 2 | (gx > 0) << 3 |
               16 | (gx < GW - 1) << 5;
    }
    const int8_t* xb = p.x + (size_t)t.b * H * W * Cin;
    const int8_t* wb = p.wk + ((size_t)t.q * Cout + t.n0 + r0) * K + jc * 16;
    int tap = jc * 16 / Cin, c0 = jc * 16 - tap * Cin;  // this chunk's tap and channel
    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(empty + 8 * stage, phase ^ 1);
#pragma unroll
      for (int sub = 0; sub < KS; ++sub) {
        int dy, dx;
        Geom::tap(t.q, tap, dy, dx);
        const int delta = (dy * W + dx) * Cin + c0;  // from a row's pixel to its source
        // the in-map bits of the tap's row and column (see pix)
        const int rb = dy < 0 ? 0 : (dy < S ? 1 : 2), cb = dx < 0 ? 3 : (dx < S ? 4 : 5);
        const uint32_t sa = base + stage * L::kStage + sub * L::kA1,
                       sb = base + stage * L::kStage + L::kA + sub * L::kB1;
#pragma unroll
        for (int i = 0; i < BM / 16; ++i) {
          const int row = r0 + 16 * i;
          const bool in = (pix[i] >> rb) & (pix[i] >> cb) & 1;
          const int8_t* src = in ? xb + ((pix[i] & ~63) + delta) : p.x;
          cp_async16(sa + row * kBK + ((jc ^ (row & 7)) << 4), src, in ? 16u : 0u);
        }
        const int8_t* wk = wb + (ks * KS + sub) * kBK;
#pragma unroll
        for (int i = 0; i < BN / 16; ++i) {
          const int n = r0 + 16 * i;
          cp_async16(sb + n * kBK + ((jc ^ (n & 7)) << 4), wk + (size_t)16 * i * K, 16u);
        }
        for (c0 += kBK; c0 >= Cin; c0 -= Cin) ++tap;
      }
      cp_async_arrive(full + 8 * stage);
      if (++stage == L::kStages) stage = 0, phase ^= 1;
    }
  }
  pos = RingPos{stage, phase};
}

// The consumer warpgroups' part of a call (threads 128-383): the products,
// and the tile's way out (Epi). kTrue: the true extremes in the statistics,
// and Epi::kRequant's map unfolded (relu_requant_unfolded).
template <class Geom, int BN, Epi E, class Stage, int MB, bool kTrue>
__device__ __forceinline__ void consume(const Args& p, const Body<Geom, BN, E, MB>& sm,
                                        RingPos& pos) {
  constexpr int BM = kBM * MB, KS = kSubBlocks<Geom>;
  using L = LayoutOf<Geom, BN, E, MB>;
  const Walk<Geom, BN, E, MB> w(p);
  const int B = p.B, Cout = p.Cout;
  const int GW = w.GW, GHW = w.GHW, mblocks = w.mblocks, tiles_n = w.tiles_n, ksteps = w.ksteps;
  const uint32_t base = sm.base, full = sm.full, empty = sm.empty;
  uint8_t* out_s = sm.out_s;
  long long* cta = sm.cta;
  float *a2_s = sm.a2_s, *d2_s = sm.d2_s, *red = sm.red;
  const int cw = (threadIdx.x >> 7) - 1;  // consumer warpgroup: tile rows 64*MB*cw ..
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int ct = threadIdx.x - 128;
  const size_t BC = (size_t)B * Cout;
  int stage = pos.stage;
  uint32_t phase = pos.phase;
  int held = -1;     // Epi::kRequant: the key whose requant a2_s, d2_s hold
  // Epi::kStats at BN = 64: the statistics gather in registers over tiles
  constexpr bool kRegStats = E == Epi::kStats && BN == 64;
  static_assert(!(kTrue && E == Epi::kRequant && !std::is_same_v<Stage, int32_t>),
                "the true-extremes requant reads the accumulator as int32");
  RegStats<kRegStats ? BN : 32, MB, kTrue> reg;
  if constexpr (kRegStats) reg.clear();
  float amax = 0.f, s = 1.f;  // and its amax, and (kTrue) its scale
  int acc[MB][BN / 2];  // m64 block mb: tile rows 64*(MB*cw + mb) ..
  for (int tile = w.first; tile < w.end; tile += w.step) {
    const Tile t = tile_at(tile, tiles_n, Geom::kPhases, mblocks, BM, BN);
    if constexpr (E == Epi::kRequant) {
      if (t.key != held) {
        consumer_sync();  // the last tile's map has read a2_s, d2_s
        amax = load_requant<BN, Stage, kTrue>(p.stats, t.b, B, Cout,
                                              (float)(Geom::kPhases * GHW), p.eps, t.n0, a2_s,
                                              d2_s, red, ct);
        if constexpr (kTrue) s = relu_scale(amax);
        held = t.key;
      }
    }
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mb][i] = 0;
    int prev = 0;
    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(full + 8 * stage, phase);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t sa = base + stage * L::kStage + cw * MB * 64 * kBK, sb =
          base + stage * L::kStage + L::kA;
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) fence_regs(acc[mb]);
      wgmma_fence();
#pragma unroll
      for (int sub = 0; sub < KS; ++sub)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int kk = 0; kk < kBK / 32; ++kk)
            wgmma_tile<BN>(acc[mb], sw128_desc(sa + sub * L::kA1 + mb * 64 * kBK + 32 * kk),
                           sw128_desc(sb + sub * L::kB1 + 32 * kk));
      wgmma_commit();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) fence_regs(acc[mb]);
      if (ks > 0) {
        wgmma_wait<1>();  // the previous stage's products are done: release it
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) fence_regs(acc[mb]);
        if (lane == 0) mbar_arrive(empty + 8 * prev);
        __syncwarp();
      }
      prev = stage;
      if (++stage == L::kStages) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) fence_regs(acc[mb]);
    if (lane == 0) mbar_arrive(empty + 8 * prev);
    __syncwarp();

    const size_t ob = (size_t)t.b * Geom::kPhases * GHW;  // the sample's first output row
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int r16 = 64 * (MB * cw + mb) + 16 * warp;  // the warp's first row
      if constexpr (E == Epi::kInt32) {
        // The tile's int32 rows, straight from the fragment.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = t.m0 + r16 + (lane >> 2) + 8 * h;
          int32_t* yr = static_cast<int32_t*>(p.y) +
                        (ob + Geom::out_pixel(t.q, m / GW, m % GW, GW)) * Cout + t.n0 +
                        2 * (lane & 3);
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            *reinterpret_cast<int2*>(yr + 8 * j) = make_int2(acc[mb][4 * j + 2 * h],
                                                             acc[mb][4 * j + 2 * h + 1]);
        }
      }
      if constexpr (E == Epi::kRequant) {
        // Each value as the epilogue reads it, mapped to int8 into the warp's
        // 16 staged rows, which leave as 16-byte chunks at their output pixels.
        const int qd = lane & 3;
        uint8_t* stg = out_s + (4 * cw + warp) * 16 * L::kOutPitch;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 a2 = *reinterpret_cast<const float2*>(a2_s + 8 * j + 2 * qd);
          const float2 d2 = *reinterpret_cast<const float2*>(d2_s + 8 * j + 2 * qd);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float f0 = StageOf<Stage>::through(acc[mb][4 * j + 2 * h]);
            const float f1 = StageOf<Stage>::through(acc[mb][4 * j + 2 * h + 1]);
            signed char v0, v1;
            if constexpr (kTrue)
              v0 = relu_requant_unfolded(f0, a2.x, d2.x, s),
              v1 = relu_requant_unfolded(f1, a2.y, d2.y, s);
            else
              v0 = relu_requant_folded(f0, a2.x, d2.x), v1 = relu_requant_folded(f1, a2.y, d2.y);
            *reinterpret_cast<char2*>(stg + ((lane >> 2) + 8 * h) * L::kOutPitch + 8 * j +
                                      2 * qd) = make_char2(v0, v1);
          }
        }
        __syncwarp();
        constexpr int kChunks = BN / 16;
        int8_t* yb = static_cast<int8_t*>(p.y) + t.n0;
#pragma unroll
        for (int i = lane; i < 16 * kChunks; i += 32) {
          const int rr = i / kChunks, ch = i % kChunks;
          const int m = t.m0 + r16 + rr;
          *reinterpret_cast<int4*>(yb + (ob + Geom::out_pixel(t.q, m / GW, m % GW, GW)) * Cout +
                                   16 * ch) =
              *reinterpret_cast<const int4*>(stg + rr * L::kOutPitch + 16 * ch);
        }
        __syncwarp();  // the chunks are read before the next rows land
      }
      if constexpr (kRegStats) reg.add(acc[mb]);
      else if constexpr (E != Epi::kRequant) warp_stats<BN, kTrue>(acc[mb], cta, lane);
    }
    if constexpr (E == Epi::kRequant) {
      // One tile per sample writes its inverse scale (all compute the same bits).
      if (p.out_scale != nullptr && ct == 0 && t.q == 0 && t.m0 == 0 && t.n0 == 0)
        p.out_scale[t.b] = relu_inv_scale(amax);
    } else {
      // The CTA's block leaves when the next tile is of another (sample,
      // channel tile), or this is the CTA's last; register partials fold
      // into it then, or when they hold RegStats::kTiles tiles.
      const int next = tile + w.step;
      const bool leaves =
          next >= w.end || tile_at(next, tiles_n, Geom::kPhases, mblocks, BM, BN).key != t.key;
      if constexpr (kRegStats)
        if (leaves || ++reg.tiles == reg.kTiles) reg.fold(cta, lane);
      if (leaves) {
        consumer_sync();
        for (int i = ct; i < kStatBlocks * BN; i += kConsumerThreads) {
          const int k = i / BN, col = i % BN;
          const long long v = cta[i], neutral = stat_neutral<kTrue>(k);
          cta[i] = neutral;
          if (v == neutral) continue;  // every block starts at the identity of its operation
          long long* dst = p.stats + k * BC + (size_t)t.b * Cout + t.n0 + col;
          if (k == 2) atomicMin(dst, v);
          else if (k == 3) atomicMax(dst, v);
          else atomicAdd(reinterpret_cast<unsigned long long*>(dst), (unsigned long long)v);
        }
        consumer_sync();
      }
    }
  }
  pos = RingPos{stage, phase};
}

template <class Geom, int BN, Epi E, class Stage, int MB, bool kTrue = false>
__device__ __forceinline__ void conv_body(Args p, uint8_t* smem_raw) {
  const Body<Geom, BN, E, MB> sm(smem_raw);
  sm.template init<kTrue>();
  RingPos pos{0, 0};
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    produce(p, sm, pos);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<Geom, BN, E, Stage, MB, kTrue>(p, sm, pos);
  }
}

// The kernels, one name each, so that a profile tells them apart.
// Rows 1-4's pass A: the 3x3, int32 rows and statistics.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_i8_wgmma_kernel(Args p) {
  extern __shared__ uint8_t smem_raw[];
  conv_body<Conv3x3Geom, BN, Epi::kInt32, int32_t, 1>(p, smem_raw);
}
// The ConvT site's pass S: the statistics alone.
template <int BN, int MB>
__global__ void __launch_bounds__(kThreads, 1) convt_i8_wgmma_stats_kernel(Args p) {
  extern __shared__ uint8_t smem_raw[];
  conv_body<ConvT4x4s2Geom, BN, Epi::kStats, int32_t, MB>(p, smem_raw);
}
// The ConvT site's pass Q: the conv again, mapped to int8 through Stage.
template <int BN, int MB, class Stage>
__global__ void __launch_bounds__(kThreads, 1) convt_i8_wgmma_requant_kernel(Args p) {
  extern __shared__ uint8_t smem_raw[];
  conv_body<ConvT4x4s2Geom, BN, Epi::kRequant, Stage, MB>(p, smem_raw);
}
// The encoder's 4x4/s2 site's pass S and pass Q.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1) conv4x4s2_i8_wgmma_stats_kernel(Args p) {
  extern __shared__ uint8_t smem_raw[];
  conv_body<Conv4x4s2Geom, BN, Epi::kStats, int32_t, 1>(p, smem_raw);
}
template <int BN>
__global__ void __launch_bounds__(kThreads, 1) conv4x4s2_i8_wgmma_requant_kernel(Args p) {
  extern __shared__ uint8_t smem_raw[];
  conv_body<Conv4x4s2Geom, BN, Epi::kRequant, int32_t, 1>(p, smem_raw);
}
// Its four-phase form's pass S and pass Q (a weight block per phase).
template <int BN>
__global__ void __launch_bounds__(kThreads, 1) enc1_phase_i8_wgmma_stats_kernel(Args p) {
  extern __shared__ uint8_t smem_raw[];
  conv_body<Enc1PhaseGeom, BN, Epi::kStats, int32_t, 1>(p, smem_raw);
}
template <int BN>
__global__ void __launch_bounds__(kThreads, 1) enc1_phase_i8_wgmma_requant_kernel(Args p) {
  extern __shared__ uint8_t smem_raw[];
  conv_body<Enc1PhaseGeom, BN, Epi::kRequant, int32_t, 1>(p, smem_raw);
}
// The v1 sites (the true extremes; the requant unfolded): row 19's pass A,
// rows 1-4's in the kTrue mode; row 21's pass S and pass Q, the ConvT site's.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_i8_wgmma_true_kernel(Args p) {
  extern __shared__ uint8_t smem_raw[];
  conv_body<Conv3x3Geom, BN, Epi::kInt32, int32_t, 1, true>(p, smem_raw);
}
template <int BN>
__global__ void __launch_bounds__(kThreads, 1) convt_i8_wgmma_true_stats_kernel(Args p) {
  extern __shared__ uint8_t smem_raw[];
  conv_body<ConvT4x4s2Geom, BN, Epi::kStats, int32_t, 1, true>(p, smem_raw);
}
template <int BN>
__global__ void __launch_bounds__(kThreads, 1) convt_i8_wgmma_true_requant_kernel(Args p) {
  extern __shared__ uint8_t smem_raw[];
  conv_body<ConvT4x4s2Geom, BN, Epi::kRequant, int32_t, 1, true>(p, smem_raw);
}
// The ConvT on this main loop with the int32 round trip (int32 rows and the
// statistics, then relu_requant_kernel): tools/convt_wgmma_variants_torch.py
// times it; no site runs it.
template <int BN, int MB>
__global__ void __launch_bounds__(kThreads, 1) convt_i8_wgmma_int32_kernel(Args p) {
  extern __shared__ uint8_t smem_raw[];
  conv_body<ConvT4x4s2Geom, BN, Epi::kInt32, int32_t, MB>(p, smem_raw);
}

// Host side. Returns a cudaError_t as int (0 = success); launches on `st`.
// Internal linkage (static): each kernel library sets up its own kernels, and
// the per-device state below must not be merged across the libraries loaded
// in one process, as a template's static locals otherwise are (one symbol
// for all of them). One instantiation per kernel, so one state each.
template <class Geom, int BN, Epi E, class Stage = int32_t, int MB = 1, bool kTrue = false>
static int launch(const Args& p, cudaStream_t st, int grid = 0) {
  using L = LayoutOf<Geom, BN, E, MB>;
  void (*kernel)(Args);
  if constexpr (kTrue) {
    static_assert(MB == 1 && std::is_same_v<Stage, int32_t>, "the v1 sites run on int32");
    if constexpr (std::is_same_v<Geom, Conv3x3Geom>) {
      static_assert(E == Epi::kInt32, "row 19 runs pass A and an epilogue kernel");
      kernel = conv3x3_i8_wgmma_true_kernel<BN>;
    } else {
      static_assert(std::is_same_v<Geom, ConvT4x4s2Geom> && E != Epi::kInt32,
                    "row 21 runs the ConvT site's two passes");
      if constexpr (E == Epi::kStats) kernel = convt_i8_wgmma_true_stats_kernel<BN>;
      else kernel = convt_i8_wgmma_true_requant_kernel<BN>;
    }
  } else if constexpr (std::is_same_v<Geom, Conv3x3Geom>) {
    kernel = conv3x3_i8_wgmma_kernel<BN>;
  } else if constexpr (std::is_same_v<Geom, Conv4x4s2Geom>) {
    static_assert(E != Epi::kInt32 && MB == 1 && std::is_same_v<Stage, int32_t>,
                  "the 4x4/s2 site runs its two passes on int32");
    if constexpr (E == Epi::kStats) kernel = conv4x4s2_i8_wgmma_stats_kernel<BN>;
    else kernel = conv4x4s2_i8_wgmma_requant_kernel<BN>;
  } else if constexpr (std::is_same_v<Geom, Enc1PhaseGeom>) {
    static_assert(E != Epi::kInt32 && MB == 1 && std::is_same_v<Stage, int32_t>,
                  "the four-phase 4x4/s2 site runs its two passes on int32");
    if constexpr (E == Epi::kStats) kernel = enc1_phase_i8_wgmma_stats_kernel<BN>;
    else kernel = enc1_phase_i8_wgmma_requant_kernel<BN>;
  } else if constexpr (E == Epi::kStats) kernel = convt_i8_wgmma_stats_kernel<BN, MB>;
  else if constexpr (E == Epi::kRequant) kernel = convt_i8_wgmma_requant_kernel<BN, MB, Stage>;
  else kernel = convt_i8_wgmma_int32_kernel<BN, MB>;
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices] = {0};  // 0: this device is not set up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    // setmaxnreg moves registers within the CTA's allocation: the producer's
    // release must cover the consumers' request, or they would wait forever.
    if (attr.numRegs * kThreads < 128 * kProducerRegs + 256 * kConsumerRegs)
      return (int)cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev] = n;
  }
  // the producer's offsets within a sample are ints
  if ((long long)p.H * p.W * p.Cin >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int grid_px = (p.H / Geom::kStride) * (p.W / Geom::kStride);
  const int tiles = p.B * Geom::kPhases * (grid_px / (kBM * MB)) * (p.Cout / BN);
  if (grid <= 0) grid = sms[dev];  // a grid given (the variants tool) replaces one CTA per SM
  kernel<<<tiles < grid ? tiles : grid, kThreads, L::kBytes, st>>>(p);
  return (int)cudaGetLastError();
}

static int zero_stats(void* stats, int B, int C, cudaStream_t st) {
  return (int)cudaMemsetAsync(stats, 0, ((size_t)kStatBlocks * B * C + B) * sizeof(long long), st);
}

// Sets each entry of a statistics block [kStatBlocks*B*C + B] to the neutral
// value of its block (stat_neutral; the amax slots to 0). The true-extremes
// mode's: one kernel where its three values would take four memsets (no byte
// pattern gives the int32 ends).
template <bool kTrue>
__global__ void __launch_bounds__(256) stats_fill_kernel(long long* stats, size_t BC, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t k = i / BC;
    stats[i] = k < (size_t)kStatBlocks ? stat_neutral<kTrue>((int)k) : 0ll;
  }
}

// The statistics block at its neutral values on `st`: zeroed, or where kTrue
// filled by stats_fill_kernel.
template <bool kTrue>
static int fill_stats(void* stats, int B, int C, cudaStream_t st) {
  if constexpr (!kTrue) {
    return zero_stats(stats, B, C, st);
  } else {
    const size_t BC = (size_t)B * C, n = kStatBlocks * BC + B;
    const size_t blocks = (n + 255) / 256;
    stats_fill_kernel<true><<<blocks < 1024 ? (unsigned)blocks : 1024u, 256, 0, st>>>(
        static_cast<long long*>(stats), BC, n);
    return (int)cudaGetLastError();
  }
}

// Zeroes the statistics block [kStatBlocks*B*C + B] on `st` (kTrue: sets it to
// the true-extremes mode's neutral values), then runs rows 1-4's pass A (row
// 19's where kTrue; BN = 256 where C % 256 == 0, else 128). x: [B, H, W, C]
// int8; wk: [C, 9*C] int8 K-major; y: [B, H*W, C] int32.
template <bool kTrue = false>
static int conv3x3_i8_stats(const void* x, const void* wk, void* y, void* stats, int B, int H,
                            int W, int C, cudaStream_t st) {
  const int err = fill_stats<kTrue>(stats, B, C, st);
  if (err != 0) return err;
  const Args p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wk), y,
               static_cast<long long*>(stats), nullptr, B, H, W, C, C, 0.f};
  return C % 256 == 0 ? launch<Conv3x3Geom, 256, Epi::kInt32, int32_t, 1, kTrue>(p, st)
                      : launch<Conv3x3Geom, 128, Epi::kInt32, int32_t, 1, kTrue>(p, st);
}

// Pass S, then pass Q (the statistics block zeroed before).
template <class Geom, int BN, int MB = 1>
static int two_passes(const Args& p, bool stage_fp16, cudaStream_t st) {
  const int err = launch<Geom, BN, Epi::kStats, int32_t, MB>(p, st);
  if (err != 0) return err;
  if constexpr (std::is_same_v<Geom, Conv4x4s2Geom> || std::is_same_v<Geom, Enc1PhaseGeom>)
    return launch<Geom, BN, Epi::kRequant>(p, st);
  else
    return stage_fp16 ? launch<Geom, BN, Epi::kRequant, __half, MB>(p, st)
                      : launch<Geom, BN, Epi::kRequant, int32_t, MB>(p, st);
}


// Row 21's pass S, then pass Q, in the kTrue mode (the statistics block at
// the mode's neutral values before).
template <int BN>
static int true_two_passes(const Args& p, cudaStream_t st) {
  const int err = launch<ConvT4x4s2Geom, BN, Epi::kStats, int32_t, 1, true>(p, st);
  return err != 0 ? err : launch<ConvT4x4s2Geom, BN, Epi::kRequant, int32_t, 1, true>(p, st);
}

// The whole ConvT site: zeroes the statistics block on `st`, then pass S and
// pass Q (BN = 128 where Cout % 128 == 0, else 64). x: [B, H, W, Cin] int8;
// wk: [4, Cout, 4*Cin] int8 (phase, channel, K = t*Cin + ci); out:
// [B, 2H, 2W, Cout] int8; out_scale: [B] float32; stage_fp16 reads the
// accumulator as fp16 x 2^-12 (StageOf<__half>), else as int32. kTrue: row
// 21, the true extremes (the block filled, not zeroed) and the unfolded
// requant, on int32.
template <bool kTrue = false>
static int convt4x4s2_i8(const void* x, const void* wk, void* stats, void* out, void* out_scale,
                         int B, int H, int W, int Cin, int Cout, float eps, bool stage_fp16,
                         cudaStream_t st) {
  if (kTrue && stage_fp16) return (int)cudaErrorInvalidValue;
  const int err = fill_stats<kTrue>(stats, B, Cout, st);
  if (err != 0) return err;
  const Args p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wk), out,
               static_cast<long long*>(stats), static_cast<float*>(out_scale), B, H, W, Cin,
               Cout, eps};
  if constexpr (kTrue)
    return Cout % 128 == 0 ? true_two_passes<128>(p, st) : true_two_passes<64>(p, st);
  else
    return Cout % 128 == 0 ? two_passes<ConvT4x4s2Geom, 128>(p, stage_fp16, st)
                           : two_passes<ConvT4x4s2Geom, 64>(p, stage_fp16, st);
}

// The whole 4x4/s2 site: zeroes the statistics block on `st`, then pass S and
// pass Q (BN = 256 where Cout % 256 == 0, else 128 where Cout % 128 == 0, else
// 64). x: [B, H, W, Cin] int8; wk: [Cout, 16*Cin] int8 (K = (4u + v)*Cin +
// ci); out: [B, H/2, W/2, Cout] int8; out_scale: [B] float32.
static int conv4x4s2_i8(const void* x, const void* wk, void* stats, void* out, void* out_scale,
                        int B, int H, int W, int Cin, int Cout, float eps, cudaStream_t st) {
  const int err = zero_stats(stats, B, Cout, st);
  if (err != 0) return err;
  const Args p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wk), out,
               static_cast<long long*>(stats), static_cast<float*>(out_scale), B, H, W, Cin,
               Cout, eps};
  if (Cout % 256 == 0) return two_passes<Conv4x4s2Geom, 256>(p, false, st);
  return Cout % 128 == 0 ? two_passes<Conv4x4s2Geom, 128>(p, false, st)
                         : two_passes<Conv4x4s2Geom, 64>(p, false, st);
}

// The four-phase form: zeroes the statistics block on `st`, then pass S and
// pass Q at BN = 128, each on a ring of three 64 KB stages (a channel tile of
// 256 would leave pass Q's ring one stage at two K blocks a stage; one K
// block a stage, six stages of 32 KB, ran no faster on the card:
// tools/enc_variants_torch.py). x: [B, H, W, Cin] int8; wk: [4, Cout,
// 16*Cin] int8 (phase, channel, K = (4u + v)*Cin + ci); out: [B, H/2, W/2,
// Cout] int8; out_scale: [B] float32.
static_assert(LayoutOf<Enc1PhaseGeom, 128, Epi::kStats>::kStages >= 3 &&
                  LayoutOf<Enc1PhaseGeom, 128, Epi::kRequant>::kStages >= 3,
              "the four-phase passes keep rings of three stages at least");
static int enc1_phases_i8(const void* x, const void* wk, void* stats, void* out, void* out_scale,
                          int B, int H, int W, int Cin, int Cout, float eps, cudaStream_t st) {
  const int err = zero_stats(stats, B, Cout, st);
  if (err != 0) return err;
  const Args p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wk), out,
               static_cast<long long*>(stats), static_cast<float*>(out_scale), B, H, W, Cin,
               Cout, eps};
  return two_passes<Enc1PhaseGeom, 128>(p, false, st);
}

}  // namespace wgmma
}  // namespace msig
