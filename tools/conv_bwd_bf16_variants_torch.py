#!/usr/bin/env python3
"""Where the time of the bf16 conv-backward core goes: variants of it, timed alone.

    python3 tools/conv_bwd_bf16_variants_torch.py [--variants ...] [--reps 5] [--calls 20]

Builds ``msig_tpu_torch/csrc/conv3x3_bwd_bf16.cuh`` (the bf16 entries of rows
23-24) as it is and in variants made by editing its text (each variant one
nvcc of ``csrc/conv3x3_bwd.cu``, all at once, into
``build/msig_kernels/variants_bf16/``), and times its C entry
``msig_conv3x3_bwd_bf16`` (the counter memset and the kernel), launched back
to back ``--calls`` times between two CUDA events, median of ``--reps``,
without and with the relu input, on seeded bf16 inputs at the trunk shapes
``SHAPES`` ([8|4, 64, 64, 256] of a 256² step at batch 4, [64, 64, 64, 256]
of the bench's train mode, [8, 128, 128, 256] of a 512² step). The variants:

* ``as built``;
* ``cp.async``: the loads by the producer warpgroup's copies where TMA would
  take them (the path of maps whose 128-pixel tiles are not whole rows);
* ``no loads``: neither TMA boxes nor copies (the stages hold what they
  held; the time says what the loads cost); ``no products``: no wgmma (what
  the loads and the hand-over cost alone); ``no stores``: the epilogues
  write nothing;
* ``no relu pass``: the relu warps hand dW's A over untouched; ``no dx
  mask``: dx's epilogue reads no x (both change the result under the relu
  input only);
* ``128 columns``: tiles of 128 x 128 at C = 256 (the narrow tile's ring of
  7 stages);
* ``one chunk per 2048 pixels``: at most 8 (the first rule: more dW items
  than SMs at [4|8, 64, 64, 256]).

The variants' outputs are wrong where they skip work; ``as built`` is held
to the plain version at [8, 64, 64, 256]. Prints each time with its share of
the bound (the products at 989 TFLOP/s of dense bf16), the card's name and
power limit, and ptxas's registers and spills per variant. Needs a card and
nvcc; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = "conv3x3_bwd_bf16.cuh"
SHAPES = ((8, 64), (4, 64), (64, 64), (8, 128))  # (B, side) of [B, side, side, 256]
C = 256
PEAK_BF16 = 989e12

_CP = ('''  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");''', "  (void)dst; (void)src; (void)src_bytes;")
_EXPECT = ("      if (bytes) mbar_expect_tx(bar, bytes);\n      else mbar_arrive(bar);",
           "      mbar_arrive(bar);")
_TMA4 = ('      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"\n'
         '      " [%0], [%1, {%2, %3, %4, %5}], [%6];\\n"', '      ""')
_TMA2 = ('      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"\n'
         '      " [%0], [%1, {%2, %3}], [%4];\\n"', '      ""')
_MMA = ('  asm volatile(\n      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %',
        '  if (da == 1ull && db == 7ull) asm volatile(\n      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %')
_BN = "  p.bn = g.C % 256 == 0 && g.Co % 256 == 0 ? 256 : 128;"
_TMA = "  p.tma = g.H * g.W % kBM == 0"
# name -> edits (old text, new text) of the header; each old text occurs once
# (the products' asm twice: both tile widths)
VARIANTS = {
    "as built": [],
    "cp.async": [(_TMA, "  p.tma = false && g.H * g.W % kBM == 0")],
    "no loads": [_CP, _EXPECT, _TMA4, _TMA2],
    "no products": [_MMA],
    "no stores": [
        ("          *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc[4 * j + 2 * h], "
         "acc[4 * j + 2 * h + 1]);",
         "          if (acc[4 * j + 2 * h] == 1234.5f) *reinterpret_cast<float2*>(o + 8 * j) = "
         "make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);"),
        ("          *reinterpret_cast<uint2*>(a.dx + off + 8 * j) = v;",
         "          if (v.x == 12345u) *reinterpret_cast<uint2*>(a.dx + off + 8 * j) = v;")],
    "no relu pass": [("    if (item >= 0 && item_at(item, a.g, P).dw) {",
                      "    if (item == -7 && item_at(item, a.g, P).dw) {")],
    "no dx mask": [("          if (a.relu) {  // relu'(x): dx is exactly 0 where x <= 0",
                    "          if (a.relu == 7) {"),
                   ("        if (a.relu && p < P.np) {", "        if (a.relu == 7 && p < P.np) {")],
    "128 columns": [(_BN, "  p.bn = 128;")],
    "one chunk per 2048 pixels": [("  int chunks = p.np / (9 * g.Co / 2);",
                                   "  int chunks = (p.np + 2047) / 2048;"),
                                  ("constexpr int kMaxChunks = 7;", "constexpr int kMaxChunks = 8;")],
}


def build(name: str, edits, nvcc: str, flags) -> tuple:
    """(name, library path or None, ptxas's lines or the compiler's output)."""
    csrc = os.path.join(ROOT, "msig_tpu_torch", "csrc")
    out_dir = os.path.join(ROOT, "build", "msig_kernels", "variants_bf16",
                           name.replace(" ", "_").replace(".", ""))
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(csrc, out_dir)
    path = os.path.join(out_dir, HEADER)
    text = open(path).read()
    for old, new in edits:
        if old not in text:
            return name, None, f"edit not found: {old[:80]!r}"
        text = text.replace(old, new)
    open(path, "w").write(text)
    lib = os.path.join(out_dir, "lib.so")
    r = subprocess.run([nvcc, *flags, "-I", out_dir, "-o", lib,
                        os.path.join(out_dir, "conv3x3_bwd.cu")], capture_output=True, text=True)
    log = r.stdout + r.stderr
    if r.returncode != 0:
        return name, None, log[-3000:]
    keep = [ln.strip() for ln in log.splitlines()
            if "Used" in ln or ("spill" in ln and " 0 bytes spill" not in ln)]
    return name, lib, "; ".join(dict.fromkeys(keep))[:200]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", nargs="+", choices=list(VARIANTS), default=list(VARIANTS))
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--calls", type=int, default=20)
    args = p.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("conv_bwd_bf16_variants_torch: no CUDA device", file=sys.stderr)
        return 1
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from msig_tpu_torch.ops import _build
    from msig_tpu_torch.ops import conv3x3_vjp as cv

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(f"[card] {card.stdout.strip() or card.stderr.strip()}", flush=True)
    nvcc = _build.nvcc_path()
    with ThreadPoolExecutor(len(args.variants)) as ex:
        built = list(ex.map(lambda n: build(n, VARIANTS[n], nvcc, _build.NVCC_FLAGS),
                            args.variants))

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(args.reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.calls):
                fn()
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / args.calls)
        return sorted(runs)[len(runs) // 2]

    data = {}
    for b, side in SHAPES:
        rng = np.random.default_rng(b * side)
        t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda().bfloat16()  # noqa: E731
        data[(b, side)] = (t(rng.normal(0, 1, (b, side, side, C))),
                           t(rng.uniform(-1, 1, (3, 3, C, C)) / np.sqrt(9 * C)),
                           t(rng.normal(0, 1, (b, side, side, C))))
    P = ctypes.c_void_p
    for name, lib, info in built:
        if lib is None:
            print(f"[variant {name}] not built: {info}", flush=True)
            return 1
        fn = ctypes.CDLL(lib).msig_conv3x3_bwd_bf16
        fn.argtypes = [P] * 6 + [ctypes.c_int] * 6 + [P]
        cells = []
        for (b, side), (x, w, dy) in data.items():
            dx = torch.empty_like(x)
            dw = torch.empty((3, 3, C, C), dtype=torch.float32, device="cuda")
            # scratch for the most chunks any variant's rule gives (as built's, or
            # the first rule's 8 where that is more)
            floats = max(cv.scratch_floats(b, side, side, C, C, torch.bfloat16), 8 * 9 * C * C + 1)
            part = torch.empty(floats, dtype=torch.float32, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def call(relu, x=x, dy=dy, w=w, dx=dx, dw=dw, part=part, b=b, side=side):
                err = fn(x.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                         part.data_ptr(), b, side, side, C, C, relu, stream)
                if err:
                    raise RuntimeError(f"variant {name}: CUDA error {err}")

            held = ""
            if name == "as built" and (b, side) == (8, 64):
                call(0)
                torch.cuda.synchronize()
                dx_p, dw_p = cv.conv3x3_bwd_plain(x, w, dy)
                e_dw = float((dw.view(3, 3, C, C) - dw_p).abs().max() / dw_p.abs().max())
                e_dx = float((dx.float() - dx_p.float()).abs().max() / dx_p.float().abs().max())
                held = f" (max abs err / max|plain|: dW {e_dw:.1e}, dx {e_dx:.1e})"
            t0, t1 = ms(lambda: call(0)), ms(lambda: call(1))
            bound = 2 * 2 * b * side * side * C * 9 * C / PEAK_BF16 * 1e3
            cells.append(f"[{b}, {side}, {side}, {C}] {t0:.4f} ms ({bound / t0:.1%} of the "
                         f"bound), relu input {t1:.4f}{held}")
        print(f"[variant {name}] {info}: " + "; ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
