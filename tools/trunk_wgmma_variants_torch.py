#!/usr/bin/env python3
"""Where the time of the trunk sites' wgmma pass A goes: variants of the kernel, timed alone.

    python3 tools/trunk_wgmma_variants_torch.py [--reps 5] [--calls 20]

Builds ``msig_tpu_torch/csrc/conv_i8_wgmma.cuh`` as it is and in variants
made by editing its text (each variant one nvcc, all at once, into
``build/msig_kernels/variants/``), and times the pass A kernel alone, launched
back to back ``--calls`` times between two CUDA events, median of ``--reps``,
at the trunk shapes of a 256² and a 512² input, [8, 64, 64, 256] and [8, 128,
128, 256] (seeded int8 inputs and K-major weights). The variants:

* ``as built``, and ``one CTA per tile`` (the same kernel on a grid of one CTA
  per tile in place of one per SM);
* ``3 stages`` (the ring one stage shorter);
* ``no B loads``, ``no A loads``, ``no loads``: the loaders skip the weight
  copies, the input copies, or both (the sums are then wrong; the time says
  what the loads cost);
* ``no statistics``, ``no statistics, no stores``: the consumers skip the
  register-order statistics, and also the stores of the int32 tile.

Prints each time with its int8 rate and share of the card's 1,979 TOP/s, the
card's name and power limit, and ptxas's registers and spills per variant.
Needs a card and nvcc; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_INT8_OPS = 1979e12
SHAPES = ((8, 64, 256), (8, 128, 256))  # (batch, side, channels)

_NO_B = ("cp_async16(sb + n * kBK", "if (0) cp_async16(sb + n * kBK")
_NO_A = ("cp_async16(sa + row * kBK", "if (0) cp_async16(sa + row * kBK")
_NO_STATS = ("warp_stats<BN>(acc[mb], cta, lane);", "(void)0;")
_NO_STORES = ("*reinterpret_cast<int2*>(yr + 8 * j) =", "if (0) *reinterpret_cast<int2*>(yr + 8 * j) =")
# name -> edits (old text, new text) of the header; each old text occurs once
VARIANTS = {
    "as built": [],
    "3 stages": [("constexpr int kMaxStages = 8;", "constexpr int kMaxStages = 3;"),
                 ("static_assert(Layout<256>::kStages == 4,", "static_assert(Layout<256>::kStages == 3,")],
    "no B loads": [_NO_B],
    "no A loads": [_NO_A],
    "no loads": [_NO_B, _NO_A],
    "no statistics": [_NO_STATS],
    "no statistics, no stores": [_NO_STATS, _NO_STORES],
}

# pass A alone on a given grid; the kernel of the header in the same directory
ENTRY = r'''
#include "conv_i8_wgmma.cuh"
using namespace msig::wgmma;
extern "C" int variant_pass_a(const void* x, const void* wk, void* y, void* stats, int B, int H,
                              int W, int C, int grid, void* stream) {
  const Args p{(const int8_t*)x, (const int8_t*)wk, y, (long long*)stats, nullptr, B, H, W, C, C,
               0.f};
  return launch<msig::Conv3x3Geom, 256, Epi::kInt32>(p, (cudaStream_t)stream, grid);
}
'''


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
        d = _build.BUILD_DIR / "variants" / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "conv_i8_wgmma.cuh").write_text(text)
        (d / "entry.cu").write_text(ENTRY)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
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
        libs[name] = ctypes.CDLL(str(d / "variant.so"))
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
    for b, side, c in SHAPES:
        rng = np.random.default_rng(side)
        x = torch.from_numpy(rng.integers(-127, 128, (b, side, side, c), dtype=np.int8)).cuda()
        w = fc.pack_weights(torch.from_numpy(rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8)))
        wk = fc.pack_weights_kmajor(w).cuda()
        y = torch.empty((b, side * side, c), dtype=torch.int32, device="cuda")
        stats = torch.zeros(5 * b * c + b, dtype=torch.int64, device="cuda")
        tiles = b * side * side // 128
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        ops = 2 * b * side * side * c * 9 * c
        runs = [(name, min(tiles, sms)) for name in VARIANTS]
        runs.insert(1, ("one CTA per tile", tiles))
        for name, grid in runs:
            fn = libs["as built" if name == "one CTA per tile" else name].variant_pass_a
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

            def call():
                err = fn(x.data_ptr(), wk.data_ptr(), y.data_ptr(), stats.data_ptr(), b, side,
                         side, c, grid, stream)
                if err:
                    raise RuntimeError(f"variant {name!r} failed to launch: cudaError {err}")
            for _ in range(3):
                call()
            torch.cuda.synchronize()
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
            print(f"[variant] [{b}, {side}, {side}, {c}] {name}, grid {grid}: {t:.4f} ms, "
                  f"{ops / (t * 1e-3) / 1e12:.1f} TOP/s ({ops / (t * 1e-3) / PEAK_INT8_OPS:.1%} of "
                  f"1,979)", flush=True)
        del x, wk, y, stats
    return 0


if __name__ == "__main__":
    sys.exit(main())
