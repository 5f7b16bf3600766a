#!/usr/bin/env python3
"""Where the time of the single-kernel trunk (``csrc/fused_trunk_blocks.cu``) goes.

    python3 tools/trunk_v3_variants_torch.py [--rounds 7] [--calls 10]

Builds ``msig_tpu_torch/csrc/fused_trunk_blocks.cu`` as it is and in variants
made by editing its text at compile time (each variant one nvcc, all at once,
into ``build/msig_kernels/trunk_v3_variants/``), and times its C entry
``msig_fused_trunk_blocks`` at the served trunk's shape, [8, 64, 64, 256] with
8 resblocks (seeded int8 input, weights and affines): ``--calls`` launches back
to back between two CUDA events, each on a fresh statistics block made before
the events, medians of ``--rounds`` rounds in which the variants take turns.

The source tells which design it is, so that copied into an older checkout the
tool measures that tree's kernel:

* ``mma.sync`` (the earlier design: ``conv_int8.cuh``'s ``conv_tile``, weights
  [2N*9C, C]): cut one at a time, conv1 pass A, conv1's epilogue, conv2 pass
  A, conv2's max|hn|, conv2's requant; and all five (the 40 grid barriers
  alone);
* ``wgmma`` (``conv_i8_wgmma.cuh``'s ``produce`` and ``consume``, K-major
  weights [2N*C, 9C]): the same cuts (a conv cut in both roles), and the
  design's choices built another way: the channel tile (BN 128 against
  256), the elementwise phases' stream through 2 or 4 buffers of the ring
  (against 3) and with its loop unrolled four times, and rows 1-4's 56 / 224
  registers for the producer and the consumers (against 64 / 216).

The ``phase clock`` build stamps CTA 0's clock after every grid barrier and
prints each phase's time a block (its SM cycles scaled to the build's median
time), which no cut disturbs. A cut variant computes wrong numbers; its time
says what the cut phase cost (the mma.sync design is built at its own 128
registers throughout, so that a cut keeps two CTAs an SM; the grid barriers
alone run on more CTAs).
Prints each median with the spread of the rounds, the cooperative grid, the
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
B, SIDE, C, N_BLOCKS = 8, 64, 256, 8

# design -> (marker in the source, weights K-major, extra nvcc flags,
# {variant: [(old text, new text)]}); every occurrence of an old text is
# replaced (the wgmma design calls each conv once in each role).
_CONV_TILE = "conv_tile<Conv3x3Geom, 128, int32_t, true, true>"
_MMA_CUTS = {
    "conv1 pass A": (f"{_CONV_TILE}(src, w1,", f"if (0) {_CONV_TILE}(src, w1,"),
    "conv1 epilogue": ("// 2. conv1 epilogue, sample by sample.\n    for (int b = 0; b < B;",
                       "// 2.\n    for (int b = 0; b < 0;"),
    "conv2 pass A": (f"{_CONV_TILE}(p.y1, w2,", f"if (0) {_CONV_TILE}(p.y1, w2,"),
    "conv2 max|hn|": ("st1 - SL;\n    for (int b = 0; b < B;",
                      "st1 - SL;\n    for (int b = 0; b < 0;"),
    "conv2 requant": ("// 5. conv2 requant into dst.\n    for (int b = 0; b < B;",
                      "// 5.\n    for (int b = 0; b < 0;"),
}
_WGMMA_CUTS = {
    "conv1 pass A": ("conv1_pass<BN,", "if (0) conv1_pass<BN,"),
    "conv1 epilogue": ("relu_phase(p,", "if (0) relu_phase(p,"),
    "conv2 pass A": ("conv2_pass<BN,", "if (0) conv2_pass<BN,"),
    "conv2 max|hn|": ("amax_phase(p,", "if (0) amax_phase(p,"),
    "conv2 requant": ("requant_phase(p,", "if (0) requant_phase(p,"),
}
# The phase clock: thread 0 of CTA 0 writes clock64() at the start and after
# every grid barrier (one after each phase) into the int64 words past the
# statistics blocks, which the tool allocates.
_STAMP = r"""
__device__ __forceinline__ void stamp(const TrunkArgs& p, int& k) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    p.stats[(size_t)2 * p.n_blocks * stat_len(p.B, p.C) + k] = clock64();
  ++k;
}
"""
PHASES = ("conv1 pass A", "conv1 epilogue", "conv2 pass A", "conv2 max|hn|", "conv2 requant")
_MMA_CLOCK = [
    ("__global__ void __launch_bounds__(kConvThreads) fused_trunk_kernel",
     _STAMP + "__global__ void __launch_bounds__(kConvThreads) fused_trunk_kernel"),
    ("const int8_t* src = p.x;\n",
     "const int8_t* src = p.x;\n  int nstamp = 0;\n  stamp(p, nstamp);\n"),
    ("grid.sync();", "grid.sync(), stamp(p, nstamp);")]
_KERNEL = "template <int BN>\n__global__ void __launch_bounds__(kThreads, 1) fused_trunk_kernel"
_WGMMA_CLOCK = [
    (_KERNEL, _STAMP + _KERNEL),
    ("if (blk + 1 < p.n_blocks) grid_barrier();", "grid_barrier();"),
    ("wgmma::RingPos pos{0, 0};",
     "wgmma::RingPos pos{0, 0};\n    int nstamp = 0;\n    stamp(p, nstamp);"),
    ("grid_barrier();", "grid_barrier(), stamp(p, nstamp);")]

# With no conv left, the kernel keeps no registers for setmaxnreg to move:
# the barriers alone run without it.
_NO_SETMAXNREG = [
    ('asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(kProducerRegs));', ""),
    ('asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(kConsumerRegs));', ""),
    ("if (attr.numRegs * kThreads <", "if (0 && attr.numRegs * kThreads <")]


_STREAM_LOOP = "    for (int j = t0; j < n; j += kEwThreads) {\n      const int ai"


def _with_cuts(cuts: dict, alone=()) -> dict:
    variants = {"as built": []}
    variants.update({f"no {name}": [edit] for name, edit in cuts.items()})
    variants["grid barriers alone"] = [*cuts.values(), *alone]
    return variants


DESIGNS = {
    # as built the kernel takes 128 registers, two CTAs an SM; the cuts would
    # free registers, change the cooperative grid and time another kernel
    "mma.sync": ("conv_tile<", False, ("-maxrregcount=128",),
                 {**_with_cuts(_MMA_CUTS), "phase clock": _MMA_CLOCK}),
    "wgmma": ("wgmma::consume<", True, (), {
        **_with_cuts(_WGMMA_CUTS, _NO_SETMAXNREG),
        "phase clock": _WGMMA_CLOCK,
        "BN 128": [("constexpr int kTileN = 256;", "constexpr int kTileN = 128;")],
        "2 stream buffers": [("constexpr int kEwStages = 3;", "constexpr int kEwStages = 2;")],
        "4 stream buffers": [("constexpr int kEwStages = 3;", "constexpr int kEwStages = 4;")],
        "stream loop unrolled 4": [(_STREAM_LOOP, "#pragma unroll 4\n" + _STREAM_LOOP)],
        "registers 56/224": [("kProducerRegs = 64;", "kProducerRegs = 56;"),
                             ("kConsumerRegs = 216;", "kConsumerRegs = 224;")],
    }),
}
_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p,
                                                            ctypes.POINTER(ctypes.c_int)]


def design_of(source: str):
    for name, (marker, kmajor, flags, variants) in DESIGNS.items():
        if marker in source:
            # a variant whose text the source no longer holds is dropped
            kept = {k: v for k, v in variants.items()
                    if all(old in source for old, _ in v)}
            return name, kmajor, flags, kept
    raise RuntimeError("fused_trunk_blocks.cu is of no design this tool knows")


def build_variants(_build, variants: dict, flags=()) -> dict:
    """{name: ctypes entry} of every variant, compiled in parallel."""
    source = (_build.CSRC / "fused_trunk_blocks.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = source
        for old, new in edits:
            text = text.replace(old, new)
        d = _build.BUILD_DIR / "trunk_v3_variants" / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "fused_trunk_blocks.cu").write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC), "-o",
               str(d / "variant.so"), str(d / "fused_trunk_blocks.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    entries = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        notes = sorted({line.split(":", 1)[-1].strip() for line in log.splitlines()
                        if "registers" in line or "spill" in line or "setmaxnreg" in line})
        print(f"[build] {name}: " + " | ".join(notes), flush=True)
        fn = ctypes.CDLL(str(d / "variant.so")).msig_fused_trunk_blocks
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        entries[name] = fn
    return entries


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--calls", type=int, default=10)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the variants run on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from msig_tpu_torch.ops import _build
    from msig_tpu_torch.ops import fused_conv_int8_v2 as fc

    design, kmajor, flags, variants = design_of(
        (_build.CSRC / "fused_trunk_blocks.cu").read_text())
    print(f"[design] {design}: variants {', '.join(variants)}; nvcc {' '.join(flags)}", flush=True)
    entries = build_variants(_build, variants, flags)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)

    rng = np.random.default_rng(SIDE + 1)
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.integers(-127, 128, (B, SIDE, SIDE, C), dtype=np.int8)).to(dev)
    hs = torch.from_numpy(rng.uniform(0.5, 2.0, (B, 1)).astype(np.float32)).to(dev)
    packed = [fc.pack_weights(torch.from_numpy(rng.integers(-32, 33, (3, 3, C, C), dtype=np.int8)))
              for _ in range(2 * N_BLOCKS)]
    w = torch.cat([fc.pack_weights_kmajor(wp) if kmajor else wp for wp in packed]).to(dev)
    g = torch.from_numpy(rng.normal(1.0, 0.5, (2 * N_BLOCKS, B, C)).astype(np.float32)).to(dev)
    be = torch.from_numpy(rng.normal(0.0, 0.5, (2 * N_BLOCKS, B, C)).astype(np.float32)).to(dev)
    y = torch.empty((B, SIDE * SIDE, C), dtype=torch.int32, device=dev)
    y1, h_a, out = (torch.empty_like(x) for _ in range(3))
    out_scale = torch.empty((B, 1), dtype=torch.float32, device=dev)
    # the statistics blocks, and room for the phase clock's stamps past them
    n_stats = 2 * N_BLOCKS * (5 * B * C + B)
    stats0 = torch.cat([fc.true_extremes_stats(2 * N_BLOCKS, B, C, dev).reshape(-1),
                        torch.zeros(1 + 5 * N_BLOCKS, dtype=torch.int64, device=dev)])
    stream = torch.cuda.current_stream().cuda_stream
    grid = ctypes.c_int(0)

    def call(fn, stats):
        err = fn(x.data_ptr(), hs.data_ptr(), w.data_ptr(), g.data_ptr(), be.data_ptr(),
                 y.data_ptr(), stats.data_ptr(), y1.data_ptr(), h_a.data_ptr(), out.data_ptr(),
                 out_scale.data_ptr(), B, SIDE, SIDE, C, N_BLOCKS, 1e-5, stream,
                 ctypes.byref(grid))
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    for name, fn in entries.items():  # warm-up; a fault names its variant
        try:
            call(fn, stats0.clone())
            torch.cuda.synchronize()
        except RuntimeError as e:
            raise RuntimeError(f"variant {name!r} failed: {e}") from e
    times = {name: [] for name in entries}
    grids = {}
    for _ in range(args.rounds):
        for name, fn in entries.items():
            pool = [stats0.clone() for _ in range(args.calls)]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for stats in pool:
                call(fn, stats)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / args.calls)
            grids[name] = grid.value
            del pool
    base = float(np.median(times["as built"]))
    for name, ts in times.items():
        t = float(np.median(ts))
        print(f"[variant] {design} [{B}, {SIDE}, {SIDE}, {C}] N = {N_BLOCKS}, {name}: {t:.4f} ms "
              f"(rounds {min(ts):.4f}-{max(ts):.4f}; {t - base:+.4f} against as built), "
              f"cooperative grid {grids[name]}", flush=True)
    if "phase clock" in entries:
        # CTA 0's SM cycles between grid barriers, scaled to the variant's own
        # median time (which also holds the launch: a few microseconds)
        stats = stats0.clone()
        call(entries["phase clock"], stats)
        torch.cuda.synchronize()
        clk = stats[n_stats:].cpu().numpy().astype(np.float64)
        per_cycle = float(np.median(times["phase clock"])) / (clk[-1] - clk[0])
        d = np.diff(clk).reshape(N_BLOCKS, len(PHASES)) * per_cycle
        for j, name in enumerate(PHASES):
            print(f"[phase] {design} {name} (to its grid barrier): {np.median(d[:, j]):.4f} ms a "
                  f"block (blocks {d[:, j].min():.4f}-{d[:, j].max():.4f}), {d[:, j].sum():.4f} ms "
                  f"in all", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
