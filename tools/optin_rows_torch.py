#!/usr/bin/env python3
"""Where the time of the two opt-in serving rows goes: row 11 (enc1's four-phase
form) and row 18 (the chunked relu epilogue), and row 18's variants.

    python3 tools/optin_rows_torch.py [--parts rows variants] [--rounds 7] [--calls 20]

``rows``: each row through its wrapper, as the served path calls it, at the
main path's shape (seeded inputs): ``fe.enc1_in_relu_requant_im2col`` at
[8, 256, 256, 64] -> 128 with four distinct phase blocks (and the K-major
copy where the wrapper takes one) and ``ec.adain_relu_requant_chunked`` at
[8, 4096, 256] int32 (|x| < 2^20): equal to the plain version or not, the time
per call by CUDA events (``--calls`` calls back to back, median of
``--rounds``; then medians of 30 single calls, each after the L2 was flushed),
the device time by kernel (``torch.profiler`` over 10 calls) and the kernel
launches per call on the card. Then the unfused int8 generator with row 18
(``quantized_generator_apply(..., fused_trunk=False, fused_epilogue=True)``)
and without it on the committed demo checkpoint, two seeded batches of 8 at
256² with seeded styles: a sha256 of each one's uint8 images. The wrappers'
signatures tell the trees apart, so that copied into an older checkout the
part measures that tree's rows.

``variants``: ``msig_tpu_torch/csrc/adain_relu_requant_chunked.cu`` (the one
cooperative launch) as it is and in variants made by editing its text (each
one nvcc, all at once, into ``build/msig_kernels/optin_variants/``), its C
entry timed back to back and with the L2 flushed, in turns: ``phase clock``
(CTA 0's SM clock at the start, after each grid barrier and at its end,
scaled to the build's median time: the statistics, the reduction and CTA 0's
requant); ``no statistics``, ``no reduction``, ``no requant`` and ``barriers
alone`` (a cut variant computes wrong values: its time says what the part
cost); ``two launches`` (the requant as a second, ordinary launch in place of
the second grid barrier, on the same partials); ``rows forward`` (the
requant in the order the statistics read, not the reverse); ``unroll 2`` and
``unroll 8`` (loads in flight a thread, against 4); ``1 CTA an SM`` (the
grid cut to the SMs), ``3 CTAs an SM`` and ``4 CTAs an SM`` (the launch
bounds, against 2). The as-built and the
reordered or re-split builds are held equal to the plain version.

Prints the card's name and power limit and ptxas's registers and spills per
variant. Needs a card and nvcc; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SIDE, C = 8, 64, 256          # row 18: [B, SIDE*SIDE, C]; row 11: [B, 4*SIDE, 4*SIDE, 64]
SOURCE = "adain_relu_requant_chunked.cu"

_KERNEL = "__global__ void __launch_bounds__(kThreads, 2) chunked_epilogue_kernel(Args p) {"
_PHASE1 = "  // 1. Each item's statistics"
_BARRIER2 = "  grid_barrier();\n\n  // 3."
_RETURN = "  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();"
_GRID = "  return coop::cooperative_grid((const void*)chunked_epilogue_kernel, cached, grid);"
# The phase clock: thread 0 of CTA 0 writes clock64() into the int64 words past
# the workspace (the tool allocates them): at the start, after each barrier,
# at its end.
_STAMP = r"""
__device__ __forceinline__ void stamp(const Args& p, int k) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    p.ws[4 * (size_t)p.B * p.parts * p.C + (3 * (size_t)p.B * p.C + 1) / 2 + k] = clock64();
}
"""
_CLOCK = [(_KERNEL, _STAMP + _KERNEL),
          (_PHASE1, "  stamp(p, 0);\n" + _PHASE1),
          ("  grid_barrier();\n\n  // 2.", "  grid_barrier();\n  stamp(p, 1);\n  // 2."),
          (_BARRIER2, "  grid_barrier();\n  stamp(p, 2);\n  // 3."),
          ("sc));\n          });\n    }\n  }\n}\n", "sc));\n          });\n    }\n  }\n  stamp(p, 3);\n}\n")]
_CUTS = {
    "no statistics": ("for (int item = blockIdx.x; item < items; item += gridDim.x) {\n    int b, r0, r1;"
                      "\n    item_rows(item, p.parts, p.S, 1, b, r0, r1);\n    for (int ct = 0;",
                      "for (int item = blockIdx.x; item < 0; item += gridDim.x) {\n    int b, r0, r1;"
                      "\n    item_rows(item, p.parts, p.S, 1, b, r0, r1);\n    for (int ct = 0;"),
    "no reduction": ("unit < p.B * groups;", "unit < 0;"),
    "no requant": ("item >= (int)blockIdx.x; item -= gridDim.x)", "item >= 1 << 30; item -= gridDim.x)"),
}
_ROWS_FORWARD = [
    ("for (int item = last; item >= (int)blockIdx.x; item -= gridDim.x)",
     "for (int item = blockIdx.x; item < items; item += gridDim.x)"),
    ("for (int ct = C / kTileC - 1; ct >= 0; --ct)", "for (int ct = 0; ct < C / kTileC; ++ct)"),
    ("walk_rows<true, kUnroll>(", "walk_rows<false, kUnroll>(")]
VARIANTS = {
    "as built": [],
    "phase clock": _CLOCK,
    **{name: [edit] for name, edit in _CUTS.items()},
    "barriers alone": list(_CUTS.values()),
    "two launches": "split",
    "rows forward": _ROWS_FORWARD,
    "unroll 2": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
    "unroll 8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    "1 CTA an SM": [(_GRID, "  const int err = " + _GRID[9:] + """
  int dev = 0, sms = 0;
  if (err == 0 && cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
      *grid > sms)
    *grid = sms;
  return err;""")],
    "3 CTAs an SM": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")],
    "4 CTAs an SM": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 4)")],
}
EXACT = ("as built", "phase clock", "two launches", "rows forward", "unroll 2", "unroll 8",
         "1 CTA an SM", "3 CTAs an SM", "4 CTAs an SM")


def split_launch(text: str) -> str:
    """The kernel cut at its second grid barrier into two: the cooperative
    launch runs the statistics and the reduction, a second, ordinary launch of
    as many CTAs the requant (its declarations repeated)."""
    start = text.index(_KERNEL)
    prologue = text[start + len(_KERNEL):text.index(_PHASE1)]
    text = text.replace(_BARRIER2, "}\n\n" + _KERNEL.replace("chunked_epilogue_kernel",
                                                             "chunked_requant_kernel")
                        + prologue + "  // 3.")
    return text.replace(_RETURN, "  if (e != cudaSuccess) return (int)e;\n"
                        "  chunked_requant_kernel<<<grid, kThreads, 0, "
                        "reinterpret_cast<cudaStream_t>(stream)>>>(p);\n"
                        "  return (int)cudaGetLastError();")


def variant_text(source: str, edits) -> str:
    """The source with a variant's edits; each old text must occur as often as
    the edit says (once by default)."""
    if edits == "split":
        for marker in (_KERNEL, _PHASE1, _BARRIER2, _RETURN):
            if source.count(marker) != 1:
                raise RuntimeError(f"the split needs {marker!r} once")
        return split_launch(source)
    for old, new, *times in edits:
        if source.count(old) != (times[0] if times else 1):
            raise RuntimeError(f"{old!r} occurs {source.count(old)} times")
        source = source.replace(old, new)
    return source


def build_variants(_build) -> dict:
    """{name: library} of every variant, compiled in parallel."""
    source = (_build.CSRC / SOURCE).read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = _build.BUILD_DIR / "optin_variants" / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCE).write_text(variant_text(source, edits))
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(d / "variant.so"), str(d / SOURCE)]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        notes = sorted({line.split(":", 1)[-1].strip() for line in log.splitlines()
                        if ("registers" in line or "spill" in line) and "used 0 barriers" not in line})
        print(f"[build] {name}: " + " | ".join(notes), flush=True)
        libs[name] = ctypes.CDLL(str(d / "variant.so"))
    return libs


def timed(torch, np, fn, calls: int, rounds: int, flush=None) -> tuple:
    """(median ms per call of ``calls`` back to back, over ``rounds``; median
    of 30 single calls each after ``flush`` was zeroed, or None)."""
    fn()
    torch.cuda.synchronize()
    warm = []
    for _ in range(rounds):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        warm.append(start.elapsed_time(end) / calls)
    cold = None
    if flush is not None:
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(30)]
        for start, end in pairs:
            flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        cold = float(np.median([s.elapsed_time(e) for s, e in pairs]))
    return float(np.median(warm)), min(warm), max(warm), cold


def device_split(torch, fn, calls: int = 10) -> tuple:
    """({kernel name: device ms per call}, kernel launches per call) by torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts, n = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = e.name.split("(")[0].split("<")[0][-48:]
            parts[key] = parts.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
            n += 1
    return parts, n / calls


def rows_part(torch, np, args, flush) -> None:
    from msig_tpu_torch.ops import fused_enc_int8 as fe
    from msig_tpu_torch.ops import int8_epilogue_chunked as ec

    dev = torch.device("cuda")
    rng = np.random.default_rng(4 * SIDE + 64)
    x = torch.from_numpy(rng.integers(0, 128, (B, 4 * SIDE, 4 * SIDE, 64), dtype=np.int8)).to(dev)
    w = torch.cat([fe.pack_conv4x4(torch.from_numpy(rng.integers(-127, 128, (4, 4, 64, 128),
                                                                 dtype=np.int8)))
                   for _ in range(4)]).to(dev)
    kw = {}
    if "w_kmajor" in inspect.signature(fe.enc1_in_relu_requant_im2col).parameters:
        kw = {"w_kmajor": fe.pack_enc1_im2col_kmajor(w)}
    xi = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, (B, SIDE * SIDE, C),
                                       dtype=np.int32)).to(dev)
    g = torch.from_numpy(rng.normal(1.0, 0.5, (B, C)).astype(np.float32)).to(dev)
    be = torch.from_numpy(rng.normal(0.0, 0.5, (B, C)).astype(np.float32)).to(dev)
    for label, call, plain in (
            (f"row 11 [{B}, {4 * SIDE}, {4 * SIDE}, 64] -> 128, four distinct phase blocks"
             + (", K-major copy given" if kw else ""),
             lambda: fe.enc1_in_relu_requant_im2col(x, w, **kw),
             lambda: fe.enc1_in_relu_requant_im2col_plain(x, w)),
            (f"row 18 [{B}, {SIDE * SIDE}, {C}]", lambda: ec.adain_relu_requant_chunked(xi, g, be),
             lambda: ec.adain_relu_requant_chunked_plain(xi, g, be))):
        exact = torch.equal(call(), plain())
        ms, lo, hi, cold = timed(torch, np, call, args.calls, args.rounds, flush)
        parts, n = device_split(torch, call)
        print(f"[rows] {label}: {'equal' if exact else 'NOT equal'} to its plain version; by CUDA "
              f"events {ms:.4f} ms a call back to back (rounds {lo:.4f}-{hi:.4f}), {cold:.4f} ms "
              f"with the L2 flushed; device {sum(parts.values()):.4f} ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
              + f"; {n:g} kernel launches a call", flush=True)


def unfused_digests(torch, np) -> None:
    """sha256 of the unfused int8 generator's uint8 images with and without
    row 18, on the demo checkpoint (two seeded batches of 8 at 256²)."""
    import hashlib

    from msig_tpu_torch.config import InferenceConfig
    from msig_tpu_torch.infer import quantized as tq
    from msig_tpu_torch.infer.engine import InferenceEngine
    from msig_tpu_torch.infer.loading import load_inference_params

    cfg = InferenceConfig(image_size=256, batch_size=B, device="cuda", compute_dtype="float32",
                          quantize="int8")
    demo = os.path.join(ROOT, "results", "tomato_r3b", "demo_checkpoint")
    gen_sd, se_sd, meta, _ = load_inference_params(demo, cfg, 10)
    n_res = meta["n_residual_blocks"]
    eng = InferenceEngine.build(cfg, 10, gen_sd, se_sd, n_res, meta["style_dim"])
    for fused_epilogue in (True, False):
        rng = np.random.default_rng(6)
        digest = hashlib.sha256()
        for _ in range(2):
            imgs = torch.from_numpy(rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8)).cuda()
            styles = torch.from_numpy(rng.normal(size=(B, meta["style_dim"])).astype(np.float32))
            with torch.inference_mode():
                out = tq.quantized_generator_apply(eng.q, imgs, styles.cuda(), n_res=n_res,
                                                   out_dtype=torch.uint8, fused_trunk=False,
                                                   fused_epilogue=fused_epilogue)
            digest.update(out.cpu().numpy().tobytes())
        print(f"[rows] unfused int8 generator, fused_epilogue={fused_epilogue}: images sha256 "
              f"{digest.hexdigest()} (two seeded batches of {B} at 256²)", flush=True)


def variants_part(torch, np, args, flush) -> None:
    sys.path.insert(0, ROOT)
    from msig_tpu_torch.ops import _build
    from msig_tpu_torch.ops import int8_epilogue_chunked as ec

    if "chunked_epilogue_kernel" not in (_build.CSRC / SOURCE).read_text():
        print("[variants] this tree's row 18 is not the one cooperative launch: no variants",
              flush=True)
        return
    libs = build_variants(_build)
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, (B, SIDE * SIDE, C), dtype=np.int32)).to(dev)
    g = torch.from_numpy(rng.normal(1.0, 0.5, (B, C)).astype(np.float32)).to(dev)
    be = torch.from_numpy(rng.normal(0.0, 0.5, (B, C)).astype(np.float32)).to(dev)
    want = ec.adain_relu_requant_chunked_plain(x, g, be)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name, lib in libs.items():
        grid_fn = lib.msig_adain_relu_requant_chunked_grid
        grid_fn.argtypes, grid_fn.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
        grid = ctypes.c_int(0)
        if grid_fn(ctypes.byref(grid)):
            raise RuntimeError(f"variant {name!r}: no cooperative grid")
        parts = ec.parts(grid.value, B)
        ws = torch.zeros(ec.workspace_words(B, C, parts) + 4, dtype=torch.int64, device=dev)
        out = torch.zeros_like(x, dtype=torch.int8)
        fn = lib.msig_adain_relu_requant_chunked
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(fn=fn, ws=ws, out=out, parts=parts, name=name):
            err = fn(x.data_ptr(), g.data_ptr(), be.data_ptr(), ws.data_ptr(), out.data_ptr(), B,
                     SIDE * SIDE, C, parts, 1e-5, stream)
            if err:
                raise RuntimeError(f"variant {name!r}: cudaError {err}")
        call()
        torch.cuda.synchronize()
        if name in EXACT and not torch.equal(out, want):
            raise RuntimeError(f"variant {name!r} is not equal to the plain version")
        calls[name] = (call, ws, grid.value)
    times = {name: [] for name in calls}
    cold = {name: [] for name in calls}
    for _ in range(args.rounds):  # the variants in turns
        for name, (call, _, _) in calls.items():
            ms, _, _, c = timed(torch, np, call, args.calls, 1, flush)
            times[name].append(ms)
            cold[name].append(c)
    base = float(np.median(times["as built"]))
    for name, ts in times.items():
        t = float(np.median(ts))
        print(f"[variant] row 18 [{B}, {SIDE * SIDE}, {C}] {name}: {t:.4f} ms back to back "
              f"(rounds {min(ts):.4f}-{max(ts):.4f}; {t - base:+.4f} against as built), "
              f"{float(np.median(cold[name])):.4f} with the L2 flushed; cooperative grid "
              f"{calls[name][2]}" + ("; equal to the plain version" if name in EXACT else ""),
              flush=True)
    call, ws, _ = calls["phase clock"]
    call()
    torch.cuda.synchronize()
    clk = ws[-4:].cpu().numpy().astype(np.float64)
    per_cycle = float(np.median(times["phase clock"])) / (clk[3] - clk[0])
    for k, label in enumerate(("statistics (to barrier 1)", "reduction (to barrier 2)",
                               "CTA 0's requant")):
        print(f"[phase] row 18 {label}: {(clk[k + 1] - clk[k]) * per_cycle:.4f} ms", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parts", nargs="+", default=["rows", "variants"],
                   choices=["rows", "variants"])
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--calls", type=int, default=20)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the rows run on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MiB, past the L2
    if "rows" in args.parts:
        rows_part(torch, np, args, flush)
        unfused_digests(torch, np)
    if "variants" in args.parts:
        variants_part(torch, np, args, flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
