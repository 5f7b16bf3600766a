// The whole residual trunk in one launch: N AdaIN resblocks (conv1 -> IN ->
// AdaIN -> ReLU -> requant; conv2 -> IN -> AdaIN -> + residual -> requant),
// int8 NHWC [B, H, W, C] in and out, with the residual's per-sample scale.
//
// Replaces the TPU kernel msig_tpu/ops/fused_trunk_v3.py::fused_trunk_blocks,
// which runs one sample per program and keeps its residual slabs, conv1's
// output and both int32 accumulators in VMEM for all 2N sites. Its numbers
// differ from the per-site chain in two places, and this kernel follows the
// TPU kernel: conv1's requant scale comes from the true per-channel extremes
// (not the zero-masked ones), and the requant is unfolded,
// round(max(y*a + d, 0) * s) (conv_int8.cuh: true_relu_amax,
// relu_requant_unfolded). Its statistics are exact integers, as at every site
// of the port, where the TPU kernel sums fp32 over 16-row chunks.
//
// Bound on an H100 at [8, 64, 64, 256], N = 8: 16 convs of 38.7 G int8
// operations, 0.31 ms at 1,979 TOP/s; operations bound it.
//
// One SM cannot hold a sample (4 MB of int32 per conv at the 64-grid), so the
// trunk is one persistent cooperative launch, one CTA per SM, that walks the
// 2N sites with grid-wide barriers between five phases per block:
//   1. conv1, pass A: int32 rows and the statistics with the true extremes;
//   2. conv1's epilogue: int32 -> int8 y1;
//   3. conv2, pass A on y1;
//   4. conv2's max|hn| per sample (float atomicMax on the bits);
//   5. conv2's requant into the other residual map; hs <- amax/127.
// The convs are the main loop of rows 1-4 (conv_i8_wgmma.cuh: K-major
// weights, a cp.async ring, wgmma m64nBNk32, BN = 256 where C % 256 == 0),
// and the CTA's warpgroups keep their roles for the whole launch: warpgroup 0
// (setmaxnreg 64) only loads the convs' operands and meets the grid barriers;
// warpgroups 1-2 (216) run the products and every elementwise phase. The ring's
// barriers are initialised once and each role carries its ring position from
// conv to conv. (Rebalancing the registers around each elementwise phase, 56
// and 224 during a conv and 168 after it on all 384 threads, hung on the
// card; values live across the producer's setmaxnreg.dec are the likely
// cause, and fixed roles keep none.) The elementwise phases run over all B
// samples at once: the consumers stage the site's [B, C] affines (and per
// sample the scales) in the idle ring, then stream the CTA's contiguous share
// of the B*H*W*C/4 groups of four channels through the ring by cp.async
// (stream_groups). The int32 accumulator (32 MB at B = 8) and the int8 maps
// stay in device memory, mostly in the 50 MB L2; data written earlier in the
// launch is read past the non-coherent L1 (cp.async.cg, ld.global.cg).
#include <cooperative_groups.h>

#include "conv_i8_wgmma.cuh"

namespace cg = cooperative_groups;

namespace msig {
namespace trunk {

// The channel tile of the convs where C % kTileN == 0, else 128
// (tools/trunk_v3_variants_torch.py builds it the other way and times it).
constexpr int kTileN = 256;

using wgmma::kThreads;
using Pass = wgmma::Epi;
// setmaxnreg's split of the CTA's 384 x 168 registers (rows 1-4's 56 / 224
// ran 2-3% slower here: tools/trunk_v3_variants_torch.py).
constexpr int kProducerRegs = 64;
constexpr int kConsumerRegs = 216;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= kThreads * 168,
              "setmaxnreg moves registers within the CTA's allocation");
// The elementwise phases' threads: the consumer warpgroups, which meet at
// wgmma::consumer_sync.
constexpr int kEwThreads = wgmma::kConsumerThreads;
__device__ __forceinline__ int ew_thread() { return threadIdx.x - 128; }
// (Sample, channel) entries of the statistics a thread loads at once when it
// stages a site's affines, so that one's latency covers the others'.
constexpr int kInFlight = 4;
// The elementwise phases stream the CTA's share of the groups of four
// channels (16 bytes of int32 rows, 4 of residual each) through kEwStages
// buffers of kEwChunk groups in the idle ring, by cp.async: kEwStages - 1
// chunks in flight a CTA, which hold no registers.
constexpr int kEwChunk = 2048;
constexpr int kEwStages = 3;
constexpr int kEwBytes = kEwStages * kEwChunk * 20;

struct TrunkArgs {
  const int8_t* x;        // [B, H, W, C] block 0's input
  const float* h_scale;   // [B] its scale
  const int8_t* wk;       // [2N * C, 9C] site-major K-major weights
  const float* gammas;    // [2N, B, C]
  const float* betas;     // [2N, B, C]
  int32_t* y;             // [B, H*W, C] accumulator scratch
  long long* stats;       // 2N statistics blocks of stat_len(B, C)
  int8_t* y1;             // [B, H, W, C] conv1's output
  int8_t* h_a;            // [B, H, W, C] residual ping-pong map
  int8_t* out;            // [B, H, W, C] the last block's output
  float* out_scale;       // [B]
  int B, H, W, C, n_blocks;
  float eps;
};

__host__ __device__ inline size_t stat_len(int B, int C) {
  return (size_t)kStatBlocks * B * C + B;
}

// Block blk writes out if it is the last; before it, blocks alternate with
// h_a, so no block reads the map it writes.
__device__ __forceinline__ int8_t* block_output(const TrunkArgs& p, int blk) {
  return (p.n_blocks - 1 - blk) % 2 == 0 ? p.out : p.h_a;
}
__device__ __forceinline__ const int8_t* block_input(const TrunkArgs& p, int blk) {
  return blk == 0 ? p.x : block_output(p, blk - 1);
}
__device__ __forceinline__ long long* site_stats(const TrunkArgs& p, int site) {
  return p.stats + (size_t)site * stat_len(p.B, p.C);
}

// The elementwise phases' shared memory, in the ring (idle between convs): a
// site's affine a, d [B*C], per sample the requant scale s, the residual's
// scale hs and the max |hn| bits, then the stream's buffers (16-byte aligned).
struct Shared {
  float *a, *d, *s, *hs;
  unsigned* mx;
  uint8_t* buf;
};
__host__ __device__ inline size_t shared_bytes(int B, int C) {
  return (((size_t)2 * B * C + 3 * B) * sizeof(float) + 15) / 16 * 16;
}
__device__ __forceinline__ Shared shared_at(uint8_t* smem, int B, int C) {
  float* f = reinterpret_cast<float*>(smem);
  const size_t BC = (size_t)B * C;
  return Shared{f, f + BC, f + 2 * BC, f + 2 * BC + B,
                reinterpret_cast<unsigned*>(f + 2 * BC + 2 * B), smem + shared_bytes(B, C)};
}

// The site's [B, C] affines (in_affine's operations, statistics read past L1,
// kInFlight entries a thread at once) into sh.a, sh.d; with relu, also s =
// 127/amax per sample into sh.s, amax over the true extremes
// (true_relu_amax: max is exact, so in any order). A warp's 32 entries lie in
// one sample (C % 128 == 0). By the consumers, who meet after.
__device__ __forceinline__ void stage_affines(const TrunkArgs& p, const long long* st,
                                              const float* g, const float* be, bool relu,
                                              Shared sh) {
  const int B = p.B, C = p.C, t0 = ew_thread();
  const int BC = B * C;
  if (relu) {
    for (int b = t0; b < B; b += kEwThreads) sh.mx[b] = 0u;
    wgmma::consumer_sync();
  }
  for (int i0 = t0; i0 < BC; i0 += kInFlight * kEwThreads) {
    long long sum[kInFlight], lo[kInFlight], hi[kInFlight];
    int mn[kInFlight], mx[kInFlight];  // the true extremes of int32 outputs
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int i = i0 + k * kEwThreads;
      if (i < BC) {
        sum[k] = __ldcg(&st[i]), lo[k] = __ldcg(&st[BC + i]), hi[k] = __ldcg(&st[4 * BC + i]);
        if (relu) mn[k] = (int)__ldcg(&st[2 * BC + i]), mx[k] = (int)__ldcg(&st[3 * BC + i]);
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int i = i0 + k * kEwThreads;
      if (i >= BC) break;  // for the whole warp
      float a, d;
      affine_of(sum[k], (unsigned long long)lo[k], (unsigned long long)hi[k], g[i], be[i],
                (float)(p.H * p.W), p.eps, a, d);
      sh.a[i] = a;
      sh.d[i] = d;
      if (relu) {
        const float cmin = (float)mn[k], cmax = (float)mx[k];
        float h = fmaxf(__fadd_rn(fmaxf(__fmul_rn(a, cmax), __fmul_rn(a, cmin)), d), 0.f);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) h = fmaxf(h, __shfl_xor_sync(0xffffffffu, h, off));
        if ((t0 & 31) == 0) atomicMax(&sh.mx[i / C], __float_as_uint(h));  // h >= 0
      }
    }
  }
  wgmma::consumer_sync();
  if (relu) {
    for (int b = t0; b < B; b += kEwThreads) sh.s[b] = relu_scale(__uint_as_float(sh.mx[b]));
    wgmma::consumer_sync();
  }
}

// The CTA's contiguous share [lo, hi) of the B*H*W*C/4 groups of four
// channels, in runs of four groups (16 bytes of int8).
__device__ __forceinline__ void my_groups(const TrunkArgs& p, int& lo, int& hi) {
  const long long n4 = (long long)p.B * p.H * p.W * p.C / 16;
  lo = 4 * (int)(n4 * blockIdx.x / gridDim.x);
  hi = 4 * (int)(n4 * (blockIdx.x + 1) / gridDim.x);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Runs f(i, b, a, d, v, r) for every group i of the CTA's share: b its sample,
// a and d the affine of its four channels (sh.a, sh.d), v its int32 rows and
// r its residual (from res, where kResidual), streamed through sh.buf: chunk
// c lands in buffer c % kEwStages while the consumers work on chunk c - 1 or
// earlier. A thread's groups lie 4 * kEwThreads elements apart, so it walks
// their sample and channel by increments (its channel stays put where C
// divides 1024) and reloads a, d only when they change. By the consumers; the
// buffers are free again on return.
template <bool kResidual, class F>
__device__ __forceinline__ void stream_groups(const TrunkArgs& p, const int8_t* res, Shared sh,
                                              F&& f) {
  int lo, hi;
  my_groups(p, lo, hi);
  const int t0 = ew_thread(), chunks = (hi - lo + kEwChunk - 1) / kEwChunk;
  const int C = p.C, SC = p.H * p.W * C, dc = 4 * kEwThreads % C;
  int held = -1;  // the entry b*C + c whose affine a, d hold
  float4 a, d;
  const int4* y4 = reinterpret_cast<const int4*>(p.y);
  const int4* r16 = reinterpret_cast<const int4*>(res);  // four groups' residual a piece
  auto ys = [&](int c) {
    return reinterpret_cast<int4*>(sh.buf + (c % kEwStages) * kEwChunk * 20);
  };
  auto rs = [&](int c) { return reinterpret_cast<char4*>(ys(c) + kEwChunk); };
  auto issue = [&](int c) {
    if (c < chunks) {
      const int g0 = lo + c * kEwChunk, n = min(kEwChunk, hi - g0);
      for (int j = t0; j < n; j += kEwThreads)
        wgmma::cp_async16(wgmma::smem_addr(ys(c) + j), y4 + g0 + j, 16u);
      if constexpr (kResidual)
        for (int j = t0; j < n / 4; j += kEwThreads)
          wgmma::cp_async16(wgmma::smem_addr(rs(c) + 4 * j), r16 + g0 / 4 + j, 16u);
    }
    cp_async_commit();  // an empty group past the last chunk keeps the count
  };
#pragma unroll
  for (int c = 0; c < kEwStages - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kEwStages - 2>();  // this thread's copies of chunk c have landed,
    wgmma::consumer_sync();          // and everyone's; chunk c - 1 is done with
    issue(c + kEwStages - 1);        // into chunk c - 1's buffer
    const int g0 = lo + c * kEwChunk, n = min(kEwChunk, hi - g0);
    const int4* yc = ys(c);
    const char4* rc = rs(c);
    const int e = 4 * (g0 + t0);
    int b = e / SC, ch = e % C, left = SC - e % SC;  // elements left in sample b
    for (int j = t0; j < n; j += kEwThreads) {
      const int ai = b * C + ch;
      if (ai != held) {
        a = *reinterpret_cast<const float4*>(sh.a + ai);
        d = *reinterpret_cast<const float4*>(sh.d + ai);
        held = ai;
      }
      if constexpr (kResidual) f(g0 + j, b, a, d, yc[j], rc[j]);
      else f(g0 + j, b, a, d, yc[j], make_char4(0, 0, 0, 0));
      if ((ch += dc) >= C) ch -= C;
      if ((left -= 4 * kEwThreads) <= 0) ++b, left += SC;  // 4 * kEwThreads < SC
    }
  }
  cp_async_wait<0>();
  wgmma::consumer_sync();
}

// The residual's scale of sample b in block blk: the input's for block 0, else
// amax/127 of the block before (1 where that amax was 0).
__device__ __forceinline__ float residual_scale(const TrunkArgs& p, int blk, int b) {
  if (blk == 0) return p.h_scale[b];
  const long long* st_prev = site_stats(p, 2 * blk - 1);
  return relu_inv_scale(
      __uint_as_float((unsigned)__ldcg(&st_prev[(size_t)kStatBlocks * p.B * p.C + b])));
}

// Phases 1 and 3, conv1 of the block's input and conv2 of y1 (site 2*blk and
// 2*blk + 1): int32 rows into p.y, statistics into the site's block; the
// producer's loads or the consumers' products.
template <int BN, bool kProducer>
__device__ __forceinline__ void conv_pass(const TrunkArgs& p, int site, const int8_t* src,
                                          const wgmma::Body<Conv3x3Geom, BN, Pass::kInt32, 1>& sm,
                                          wgmma::RingPos& pos) {
  const wgmma::Args a{src, p.wk + (size_t)site * p.C * 9 * p.C, p.y, site_stats(p, site),
                      nullptr, p.B, p.H, p.W, p.C, p.C, p.eps};
  if constexpr (kProducer) wgmma::produce(a, sm, pos);
  else wgmma::consume<Conv3x3Geom, BN, Pass::kInt32, int32_t, 1, true>(a, sm, pos);
}
template <int BN, bool kProducer>
__device__ __forceinline__ void conv1_pass(const TrunkArgs& p, int blk,
                                           const wgmma::Body<Conv3x3Geom, BN, Pass::kInt32, 1>& sm,
                                           wgmma::RingPos& pos) {
  conv_pass<BN, kProducer>(p, 2 * blk, block_input(p, blk), sm, pos);
}
template <int BN, bool kProducer>
__device__ __forceinline__ void conv2_pass(const TrunkArgs& p, int blk,
                                           const wgmma::Body<Conv3x3Geom, BN, Pass::kInt32, 1>& sm,
                                           wgmma::RingPos& pos) {
  conv_pass<BN, kProducer>(p, 2 * blk + 1, p.y1, sm, pos);
}

// Phase 2: y1 = requant(relu(y*a + d)), unfolded, with the true-extremes scale.
__device__ __forceinline__ void relu_phase(const TrunkArgs& p, int blk, uint8_t* smem) {
  const Shared sh = shared_at(smem, p.B, p.C);
  const size_t BC = (size_t)p.B * p.C;
  stage_affines(p, site_stats(p, 2 * blk), p.gammas + 2 * blk * BC, p.betas + 2 * blk * BC, true,
                sh);
  char4* o4 = reinterpret_cast<char4*>(p.y1);
  stream_groups<false>(p, nullptr, sh, [&](int i, int b, float4 a, float4 d, int4 v, char4) {
    const float s = sh.s[b];
    o4[i] = make_char4(relu_requant_unfolded((float)v.x, a.x, d.x, s),
                       relu_requant_unfolded((float)v.y, a.y, d.y, s),
                       relu_requant_unfolded((float)v.z, a.z, d.z, s),
                       relu_requant_unfolded((float)v.w, a.w, d.w, s));
  });
}

// The four hn = y*a + d + h*hs of a group (residual_hn's operations), v and r
// its int32 rows and residual.
__device__ __forceinline__ float4 hn4(int4 v, char4 r, float4 a, float4 d, float hs) {
  return make_float4(residual_hn(v.x, r.x, a.x, d.x, hs), residual_hn(v.y, r.y, a.y, d.y, hs),
                     residual_hn(v.z, r.z, a.z, d.z, hs), residual_hn(v.w, r.w, a.w, d.w, hs));
}

// Phase 4: max |hn| per sample into conv2's amax slots.
__device__ __forceinline__ void amax_phase(const TrunkArgs& p, int blk, uint8_t* smem) {
  const Shared sh = shared_at(smem, p.B, p.C);
  const size_t BC = (size_t)p.B * p.C;
  const int site = 2 * blk + 1;
  long long* st = site_stats(p, site);
  const int8_t* src = block_input(p, blk);
  for (int b = ew_thread(); b < p.B; b += kEwThreads) {
    sh.hs[b] = residual_scale(p, blk, b);
    sh.mx[b] = 0u;
  }
  // its barrier also publishes hs and mx
  stage_affines(p, st, p.gammas + site * BC, p.betas + site * BC, false, sh);
  int cur = -1;
  float local = 0.f;
  stream_groups<true>(p, src, sh, [&](int, int b, float4 a, float4 d, int4 v, char4 r) {
    const float4 h = hn4(v, r, a, d, sh.hs[b]);
    if (b != cur) {
      if (cur >= 0) atomicMax(&sh.mx[cur], __float_as_uint(local));
      cur = b, local = 0.f;
    }
    local = fmaxf(fmaxf(local, fmaxf(fabsf(h.x), fabsf(h.y))), fmaxf(fabsf(h.z), fabsf(h.w)));
  });
  if (cur >= 0) atomicMax(&sh.mx[cur], __float_as_uint(local));
  wgmma::consumer_sync();
  for (int b = ew_thread(); b < p.B; b += kEwThreads)
    if (sh.mx[b] != 0u) store_amax(st, p.B, p.C, b, __uint_as_float(sh.mx[b]));
}

// Phase 5: the block's output = clip(round(hn * 127/amax)); the last block
// writes out_scale.
__device__ __forceinline__ void requant_phase(const TrunkArgs& p, int blk, uint8_t* smem) {
  const Shared sh = shared_at(smem, p.B, p.C);
  const size_t BC = (size_t)p.B * p.C;
  const int site = 2 * blk + 1;
  const long long* st = site_stats(p, site);
  const int8_t* src = block_input(p, blk);
  for (int b = ew_thread(); b < p.B; b += kEwThreads) {
    const float amax = __uint_as_float((unsigned)__ldcg(&st[(size_t)kStatBlocks * BC + b]));
    sh.hs[b] = residual_scale(p, blk, b);
    sh.s[b] = relu_scale(amax);
    if (blk == p.n_blocks - 1 && blockIdx.x == 0) p.out_scale[b] = relu_inv_scale(amax);
  }
  stage_affines(p, st, p.gammas + site * BC, p.betas + site * BC, false, sh);
  char4* o4 = reinterpret_cast<char4*>(block_output(p, blk));
  stream_groups<true>(p, src, sh, [&](int i, int b, float4 a, float4 d, int4 v, char4 r) {
    const float4 h = hn4(v, r, a, d, sh.hs[b]);
    const float s = sh.s[b];
    const float hv[4] = {h.x, h.y, h.z, h.w};
    signed char q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = (signed char)__float2int_rn(fminf(fmaxf(__fmul_rn(hv[j], s), -127.f), 127.f));
    o4[i] = make_char4(q[0], q[1], q[2], q[3]);
  });
}

__device__ __forceinline__ void grid_barrier() { cg::this_grid().sync(); }

// Every thread meets the same grid barriers: per block one after each conv and
// after conv1's epilogue and max|hn|, and one after the requant but the last.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1) fused_trunk_kernel(TrunkArgs p) {
  extern __shared__ uint8_t smem_raw[];
  using Body = wgmma::Body<Conv3x3Geom, BN, Pass::kInt32, 1>;
  {
    const Body sm(smem_raw);
    sm.template init<true>();  // the ring's barriers and the statistics block, once
  }
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const Body sm(smem_raw);
    wgmma::RingPos pos{0, 0};
    for (int blk = 0; blk < p.n_blocks; ++blk) {
      conv1_pass<BN, true>(p, blk, sm, pos);
      grid_barrier();
      grid_barrier();  // conv1's epilogue
      conv2_pass<BN, true>(p, blk, sm, pos);
      grid_barrier();
      grid_barrier();  // max|hn|
      if (blk + 1 < p.n_blocks) grid_barrier();  // the requant
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const Body sm(smem_raw);
    wgmma::RingPos pos{0, 0};
    for (int blk = 0; blk < p.n_blocks; ++blk) {
      conv1_pass<BN, false>(p, blk, sm, pos);
      grid_barrier();
      relu_phase(p, blk, smem_raw);
      grid_barrier();
      conv2_pass<BN, false>(p, blk, sm, pos);
      grid_barrier();
      amax_phase(p, blk, smem_raw);
      grid_barrier();
      requant_phase(p, blk, smem_raw);
      if (blk + 1 < p.n_blocks) grid_barrier();
    }
  }
}

template <int BN>
int launch(const TrunkArgs& p, cudaStream_t stream, int* grid_out) {
  using L = wgmma::LayoutOf<Conv3x3Geom, BN, Pass::kInt32>;
  void (*kernel)(TrunkArgs) = fused_trunk_kernel<BN>;
  // the elementwise phases' block and buffers lie in the ring; group indices
  // and the producer's offsets are ints
  if (shared_bytes(p.B, p.C) + kEwBytes > (size_t)L::kRing ||
      (long long)p.B * p.H * p.W * p.C >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  // setmaxnreg moves registers within the CTA's allocation: the producer's
  // release must cover the consumers' request, or they would wait forever.
  if (attr.numRegs * kThreads < 128 * kProducerRegs + 256 * kConsumerRegs)
    return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  TrunkArgs q = p;
  void* args[] = {&q};
  const dim3 grid(per_sm * sms);
  *grid_out = (int)grid.x;
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, dim3(kThreads), args, L::kBytes,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace trunk
}  // namespace msig

// Returns the CUDA error of the launch (0 = success); a grid that cannot be
// co-resident fails with cudaErrorCooperativeLaunchTooLarge. Launches on
// `stream` and does not synchronise. Sizes as in TrunkArgs; wk: the 2N
// K-major [C, 9C] blocks stacked site-major; stats: int64 [2N * (5*B*C + B)],
// in each site's block blocks 0, 1, 4 and the amax slots zeroed, block 2 set
// to INT64_MAX and block 3 to INT64_MIN. Needs C % 128 == 0, H*W % 128 == 0,
// B*H*W*C < 2^31 and (2*B*C + 3*B) * 4 bytes (rounded up to 16) within the
// 73,728 bytes that the stream's buffers leave of the ring.
// *grid_out gets the number of CTAs.
extern "C" int msig_fused_trunk_blocks(const void* x, const void* h_scale, const void* wk,
                                       const void* gammas, const void* betas, void* y_scratch,
                                       void* stats, void* y1, void* h_a, void* out,
                                       void* out_scale, int B, int H, int W, int C, int n_blocks,
                                       float eps, void* stream, int* grid_out) {
  using namespace msig::trunk;
  const TrunkArgs p{static_cast<const int8_t*>(x), static_cast<const float*>(h_scale),
                    static_cast<const int8_t*>(wk), static_cast<const float*>(gammas),
                    static_cast<const float*>(betas), static_cast<int32_t*>(y_scratch),
                    static_cast<long long*>(stats), static_cast<int8_t*>(y1),
                    static_cast<int8_t*>(h_a), static_cast<int8_t*>(out),
                    static_cast<float*>(out_scale), B, H, W, C, n_blocks, eps};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return C % kTileN == 0 ? launch<kTileN>(p, st, grid_out) : launch<128>(p, st, grid_out);
}
