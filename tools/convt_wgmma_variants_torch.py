#!/usr/bin/env python3
"""Where the time of the decoder ConvT site's two wgmma passes goes: variants, timed alone.

    python3 tools/convt_wgmma_variants_torch.py [--reps 5] [--calls 20]

Builds ``msig_tpu_torch/csrc/conv_i8_wgmma.cuh`` as it is and in variants made
by editing its text (each variant one nvcc, all at once, into
``build/msig_kernels/convt_variants/``), and times the site's kernels launched
back to back ``--calls`` times between two CUDA events, median of ``--reps``,
at the main path's up0 [8, 64, 64, 256] -> 128 and up1 [8, 128, 128, 128] -> 64
and at a 512² input's up1 [8, 256, 256, 128] -> 64 (seeded int8 inputs and
K-major weights). What it times, each as a row:

* ``as built``: the site as the entry runs it (memset, pass S, pass Q);
* ``int32 round trip``: the same main loop storing its int32 rows and the
  statistics (``convt_i8_wgmma_int32_kernel``), then conv_int8.cuh's
  ``relu_requant_kernel`` reading them back: the design this one replaces,
  on the new main loop;
* ``pass S alone`` and ``pass Q alone`` (pass Q on the statistics of a pass S
  run before the timing);
* the variants, each as pass S + pass Q: ``pass S without statistics``
  (the consumers skip warp_stats, or the register partials at BN = 64: the
  sums are then wrong, the time says what they cost), ``pass Q without its stores`` (the int8 rows are staged
  but not written), ``no A loads`` (the producer skips the input copies);
* ``256-pixel tile`` against the 128-pixel tile as built, at up1 (Cout 64):
  each consumer warpgroup runs two m64 blocks in place of one (the header's
  ``MB = 2``), so a weight stage serves twice the pixels;
* ``no loads`` (neither operand copied), ``no products`` (no wgmma issued)
  and ``one K sub-block a stage`` (128 bytes of K a stage in place of 256);
* ``channel tile 64`` (at up0, Cout 128, two channel tiles of 64: the same
  products as m64n64k32 in place of m64n128k32), alone and without loads, to
  tell the products' rate at N = 64 from that at N = 128.

Prints each time with its int8 rate (the conv's operations once per pass) and
share of the card's 1,979 TOP/s, the card's name and power limit, and ptxas's
registers and spills per variant. Needs a card and nvcc; exits 1 without a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_INT8_OPS = 1979e12
SHAPES = ((8, 64, 256, 128), (8, 128, 128, 64), (8, 256, 128, 64))  # (batch, side, Cin, Cout)

_NO_STATS = [("warp_stats<BN>(acc[mb], cta, lane);", "(void)0;"),
             ("if constexpr (kRegStats) reg.add(acc[mb]);", "if constexpr (kRegStats) (void)0;"),
             ("reg.fold(cta, lane);", "(void)0;")]
_NO_STORES = ("*reinterpret_cast<int4*>(yb + (ob", "if (0) *reinterpret_cast<int4*>(yb + (ob")
_NO_A = ("cp_async16(sa + row * kBK", "if (0) cp_async16(sa + row * kBK")
_NO_B = ("cp_async16(sb + n * kBK", "if (0) cp_async16(sb + n * kBK")
# at Cout = 128 (up0) two channel tiles of 64: the same products as m64n64k32
_TILE_64 = ("return Cout % 128 == 0 ? two_passes<ConvT4x4s2Geom, 128>(p, stage_fp16, st)",
            "return Cout % 128 == 0 ? two_passes<ConvT4x4s2Geom, 64>(p, stage_fp16, st)")
_NO_MMA = ("wgmma_tile<BN>(acc[mb], sw128_desc", "if (0) wgmma_tile<BN>(acc[mb], sw128_desc")
# name -> edits (old text, new text) of the header; each old text occurs once
VARIANTS = {
    "as built": [],
    "pass S without statistics": _NO_STATS,
    "pass Q without its stores": [_NO_STORES],
    "no A loads": [_NO_A],
    "no loads": [_NO_A, _NO_B],
    "no products": [_NO_MMA],
    "one K sub-block a stage": [("constexpr int kSubBlocks = Geom::kPhases > 1 ? 2 : 1;",
                                 "constexpr int kSubBlocks = 1;")],
    "channel tile 64": [_TILE_64],
    "channel tile 64, no loads": [_TILE_64, _NO_A, _NO_B],
}

# The site's kernels, one entry for every way the variants run them.
ENTRY = r'''
#include "conv_i8_wgmma.cuh"
using namespace msig;
using namespace msig::wgmma;
// what: 0 the site (memset, pass S, pass Q), 1 pass S, 2 pass Q, 3 the int32
// round trip (y: the int32 scratch; out8: the int8 output), 4 the site with
// MB = 2 (a 256-pixel tile)
template <int BN>
static int run(int what, Args p, void* y, cudaStream_t st) {
  int err = 0;
  switch (what) {
    case 0: return convt4x4s2_i8(p.x, p.wk, p.stats, p.y, p.out_scale, p.B, p.H, p.W, p.Cin,
                                 p.Cout, p.eps, false, st);
    case 1: return launch<ConvT4x4s2Geom, BN, Epi::kStats>(p, st);
    case 2: return launch<ConvT4x4s2Geom, BN, Epi::kRequant, int32_t>(p, st);
    case 4:  // at BN = 64 (at 128 four m64 blocks a warpgroup would not fit its registers)
      if constexpr (BN == 64) {
        err = zero_stats(p.stats, p.B, p.Cout, st);
        return err != 0 ? err : two_passes<ConvT4x4s2Geom, BN, 2>(p, false, st);
      } else {
        return (int)cudaErrorInvalidValue;
      }
    default: {
      void* out8 = p.y;
      p.y = y;
      err = zero_stats(p.stats, p.B, p.Cout, st);
      if (err == 0) err = launch<ConvT4x4s2Geom, BN, Epi::kInt32>(p, st);
      if (err != 0) return err;
      const int HWo = 4 * p.H * p.W;
      dim3 grid(epilogue_blocks(HWo, p.Cout), p.B);
      relu_requant_kernel<int32_t><<<grid, kEpiThreads, 2 * p.Cout * sizeof(float), st>>>(
          static_cast<const int32_t*>(y), p.stats, nullptr, nullptr, static_cast<int8_t*>(out8),
          p.out_scale, p.B, HWo, p.Cout, p.eps);
      return (int)cudaGetLastError();
    }
  }
}
extern "C" int variant_run(int what, const void* x, const void* wk, void* y, void* out8,
                           void* stats, void* out_scale, int B, int H, int W, int Cin, int Cout,
                           void* stream) {
  const Args p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wk), out8,
               static_cast<long long*>(stats), static_cast<float*>(out_scale), B, H, W, Cin,
               Cout, 1e-5f};
  cudaStream_t st = (cudaStream_t)stream;
  return Cout % 128 == 0 ? run<128>(what, p, y, st) : run<64>(what, p, y, st);
}
'''
WHAT = {"site": 0, "pass S": 1, "pass Q": 2, "int32 round trip": 3, "256-pixel tile": 4}


def build_variants(_build) -> dict:
    """{name: ctypes library} of every variant, compiled in parallel."""
    header = open(os.path.join(_build.CSRC, "conv_i8_wgmma.cuh")).read()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = header
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} occurs {text.count(old)} times")
            text = text.replace(old, new)
        d = _build.BUILD_DIR / "convt_variants" / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "conv_i8_wgmma.cuh").write_text(text)
        (d / "entry.cu").write_text(ENTRY)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(d), "-I", str(_build.CSRC), "-o",
               str(d / "variant.so"), str(d / "entry.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        regs = sorted({line.split(":", 1)[-1].strip() for line in log.splitlines()
                       if "registers" in line or "spill" in line})
        print(f"[build] {name}: " + " | ".join(regs), flush=True)
        lib = ctypes.CDLL(str(d / "variant.so"))
        lib.variant_run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--calls", type=int, default=20)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the variants run on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from msig_tpu_torch.ops import _build
    from msig_tpu_torch.ops import fused_conv_int8_v2 as fc

    libs = build_variants(_build)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for b, side, cin, cout in SHAPES:
        rng = np.random.default_rng(side + cin)
        x = torch.from_numpy(rng.integers(0, 128, (b, side, side, cin), dtype=np.int8)).cuda()
        w = fc.pack_convt_weights_ps(torch.from_numpy(
            rng.integers(-127, 128, (4, 4, cin, cout), dtype=np.int8)), cin, cout)
        wk = fc.pack_convt_weights_ps_kmajor(w).cuda()
        y = torch.empty((b, 4 * side * side, cout), dtype=torch.int32, device="cuda")
        out = torch.empty((b, 2 * side, 2 * side, cout), dtype=torch.int8, device="cuda")
        stats = torch.zeros(5 * b * cout + b, dtype=torch.int64, device="cuda")
        scale = torch.empty(b, dtype=torch.float32, device="cuda")
        ops = 2 * b * 4 * side * side * cout * 4 * cin  # one pass
        want = fc.convt4x4s2_in_relu_requant_ps_plain(x, w.cuda())[0]
        runs = [("as built", "site"), ("as built", "256-pixel tile"),
                ("as built", "int32 round trip"), ("as built", "pass S"), ("as built", "pass Q")]
        runs += [(name, "site") for name in VARIANTS if name != "as built"]
        for name, what in runs:
            if what == "256-pixel tile" and cout != 64:
                continue
            fn = libs[name].variant_run

            def call(_what=WHAT[what]):
                err = fn(_what, x.data_ptr(), wk.data_ptr(), y.data_ptr(), out.data_ptr(),
                         stats.data_ptr(), scale.data_ptr(), b, side, side, cin, cout, stream)
                if err:
                    raise RuntimeError(f"variant {name!r} ({what}) failed to launch: cudaError {err}")
            if what == "pass Q":  # on the statistics of a whole run
                fn(WHAT["site"], x.data_ptr(), wk.data_ptr(), y.data_ptr(), out.data_ptr(),
                   stats.data_ptr(), scale.data_ptr(), b, side, side, cin, cout, stream)
            out.zero_()
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            exact = ""
            if name == "as built" and what != "pass S":
                exact = ", equal to the plain version" if torch.equal(out, want) else \
                    ", NOT equal to the plain version"
            ms = []
            for _ in range(args.reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.calls):
                    call()
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end) / args.calls)
            t = float(np.median(ms))
            passes = 1 if what in ("pass S", "pass Q", "int32 round trip") else 2
            label = what if name == "as built" else name
            print(f"[variant] [{b}, {side}, {side}, {cin}] -> {cout} {label}: {t:.4f} ms, "
                  f"{passes * ops / (t * 1e-3) / 1e12:.1f} TOP/s over {passes} pass(es) "
                  f"({passes * ops / (t * 1e-3) / PEAK_INT8_OPS:.1%} of 1,979){exact}", flush=True)
        del x, wk, y, out, stats
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(argv=None))
