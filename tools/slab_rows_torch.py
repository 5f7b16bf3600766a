#!/usr/bin/env python3
"""Where the time of the whole-slab epilogues goes: rows 16 and 17 through their wrappers.

    python3 tools/slab_rows_torch.py [--parts rows variants] [--rounds 7] [--calls 20]

``rows``: ``ep.adain_relu_requant`` and ``ep.adain_residual_requant`` (bf16 and fp32
residual) at the main path's [8, 4096, 256] int32 (seeded, |x| < 2^20): equal
to the plain version or not, the time per call by CUDA events (``--calls``
calls back to back, median of ``--rounds``; then the median of 30 single
calls, each after the L2 was flushed), the device time by kernel
(``torch.profiler`` over 10 calls) and the kernel launches per call on the
card. Only the wrappers are called, so that copied into an older checkout
the tool measures that tree's rows.

``variants``: ``msig_tpu_torch/csrc/int8_epilogue.cu`` as it is and in
variants made by editing its text (each one nvcc, all at once, into
``build/msig_kernels/slab_variants/``), its C entries timed back to back and
with the L2 flushed, in turns, for the relu form and the bf16 residual form:
``phase clock`` (thread 0 of CTA 0 writes the global timer into words past the
workspace at the start, after each grid barrier and at its end; each phase's
median over 30 calls, L2 warm); ``no cache`` (no rows kept in shared memory across the barriers: every pass
reads x from the L2 or the HBM); ``no streaming hints`` (the residual loaded
and h and the int8 stored without ``__ldcs`` / ``__stcs``); ``residual unroll
4`` (rows in flight a thread in the residual form's last two passes, against
8); ``unroll 8`` (in the other passes, against 4); ``1 CTA an SM`` (the grid cut to the
SMs, where two fit); ``barriers alone`` (every phase's work cut: the launch and its grid
barriers). The variants that keep the arithmetic are held equal to the plain
version.

Prints the card's name and power limit. Needs a card and nvcc; exits 1 without
a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, C = 8, 4096, 256
SOURCE = "int8_epilogue.cu"
CLOCK_WORDS = 16  # int64 words past the workspace that the phase clock writes
_KERNEL = "template <class R>\n__global__ void __launch_bounds__(kThreads, 2) slab_epilogue_kernel("
_STAMP = r"""// The phase clock: thread 0 of CTA 0 writes the global timer (ns) into word
// k past the workspace (ops/int8_epilogue.py::workspace_words).
template <class R> __device__ __forceinline__ void stamp(const Args<R>& p, int k) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const size_t chunks = (p.S + kRows - 1) / kRows, n = (size_t)p.B * chunks * p.C,
                 bc = (size_t)p.B * p.C;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.ws[3 * n + (4 * bc + bc / 32 + p.B * chunks + 1) / 2 + k] = (long long)t;
  }
}

"""
_CLOCK = [(_KERNEL, _STAMP + _KERNEL),
          ("\n  // 1. Each chunk's sums", "\n  stamp(p, 0);\n  // 1. Each chunk's sums"),
          *[(f"  grid_barrier();\n\n  // {k + 1}.", f"  grid_barrier();\n  stamp(p, {k});\n  // {k + 1}.")
            for k in (1, 2, 3)],
          ("  grid_barrier();\n\n  if constexpr (kRelu) {",
           "  grid_barrier();\n  stamp(p, 4);\n  if constexpr (kRelu) {"),
          ("            });\n      }\n    }\n  } else {",
           "            });\n      }\n    }\n    stamp(p, 5);\n  } else {"),
          ("    grid_barrier();\n\n    // 6.", "    grid_barrier();\n    stamp(p, 5);\n    // 6."),
          ("    }\n  }\n}\n\n// The grid of each form's",
           "    }\n    stamp(p, 6);\n  }\n}\n\n// The grid of each form's")]
_GRID = ("  return coop::cooperative_grid((const void*)slab_epilogue_kernel<R>, cached, grid, "
         "kCacheBytes);")
VARIANTS = {
    "as built": [],
    "phase clock": _CLOCK,
    "no cache": [("constexpr int kCacheBytes = 96 * 1024;", "constexpr int kCacheBytes = 0;")],
    "no streaming hints": [
        ("return __ldcs(reinterpret_cast<const float4*>(p));",
         "return __ldg(reinterpret_cast<const float4*>(p));"),
        ("return __ldcs(reinterpret_cast<const uint2*>(p));",
         "return __ldg(reinterpret_cast<const uint2*>(p));"),
        ("__stcs(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));",
         "*reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);"),
        ("__stcs(reinterpret_cast<uint2*>(p), u);", "*reinterpret_cast<uint2*>(p) = u;"),
        ("__stcs(ob + (size_t)r * C4 + g, make_char4(q[0], q[1], q[2], q[3]));",
         "ob[(size_t)r * C4 + g] = make_char4(q[0], q[1], q[2], q[3]);", 2)],
    "residual unroll 4": [("constexpr int kUnrollRes = 8;", "constexpr int kUnrollRes = 4;")],
    "unroll 8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    "1 CTA an SM": [(_GRID, "  const int err = " + _GRID[9:] + """
  int dev = 0, sms = 0;
  if (err == 0 && cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
      *grid > sms)
    *grid = sms;
  return err;""")],
    "barriers alone": [("item < items; item += gridDim.x", "item < 0; item += gridDim.x", 3),
                       ("unit < p.B * groups;", "unit < 0;", 2),
                       ("  if (mine) {", "  if (mine < 0) {", 2)],
}
EXACT = ("as built", "phase clock", "no cache", "no streaming hints", "residual unroll 4", "unroll 8",
         "1 CTA an SM")
PHASES = {"relu": ("sums", "m", "squares", "k", "requant"),
          "residual": ("sums", "m", "squares", "k", "max|h|", "requant")}


def timed(torch, np, fn, calls: int, rounds: int, flush) -> tuple:
    """(median ms a call of ``calls`` back to back over ``rounds``, the rounds'
    least and most, median of 30 single calls each after ``flush`` was zeroed)."""
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
    """({kernel name: device ms a call}, kernel launches a call) by torch.profiler."""
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


def phase_split(torch, np, fn, words, labels) -> dict:
    """Median ms of each phase over 30 calls of the phase clock's build ``fn``
    (``words``: the global timer of CTA 0 at the start, after each grid
    barrier, at the end)."""
    rows = []
    for _ in range(30):
        fn()
        torch.cuda.synchronize()
        ns = words.cpu().numpy()[:len(labels) + 1].astype(np.float64)
        rows.append(np.diff(ns) / 1e6)
    return dict(zip(labels, (float(v) for v in np.median(np.array(rows), axis=0))))


def variant_text(source: str, edits) -> str:
    """The source with a variant's edits; each old text must occur as often as
    the edit says (once by default)."""
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
        d = _build.BUILD_DIR / "slab_variants" / f"v{i}"
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
                        if "registers" in line and "used 0 barriers" not in line})
        print(f"[build] {name}: " + " | ".join(notes), flush=True)
        libs[name] = ctypes.CDLL(str(d / "variant.so"))
    return libs


def variants_part(torch, np, ep, args, flush, x, g, be, res) -> None:
    from msig_tpu_torch.ops import _build

    libs = build_variants(_build)
    stream = torch.cuda.current_stream().cuda_stream
    r = res.to(torch.bfloat16)
    want = {"relu": (ep.adain_relu_requant_plain(x, g, be),),
            "residual": ep.adain_residual_requant_plain(x, g, be, r)}
    calls, grids, clocked = {}, {}, {}
    for name, lib in libs.items():
        grid_fn = lib.msig_int8_epilogue_grid
        grid_fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        grid_fn.restype = ctypes.c_int
        grid = ctypes.c_int(0)
        err = grid_fn(0, ctypes.byref(grid))
        if err:
            raise RuntimeError(f"variant {name!r}: no cooperative grid, cudaError {err}")
        grids[name] = grid.value
        for form in ("relu", "residual"):
            site = ep.RELU_SITE if form == "relu" else ep.RESIDUAL_SITE
            fn = getattr(lib, f"msig_{site}")
            fn.argtypes, fn.restype = ep._ARGTYPES[site], ctypes.c_int
            extra = CLOCK_WORDS if name == "phase clock" else 0
            ws = torch.empty(ep.workspace_words(B, S, C) + extra, dtype=torch.int64,
                             device="cuda")
            out = torch.empty((B, S, C), dtype=torch.int8, device="cuda")
            h = torch.empty_like(r)
            if form == "relu":
                def call(fn=fn, ws=ws, out=out):
                    return fn(x.data_ptr(), g.data_ptr(), be.data_ptr(), ws.data_ptr(),
                              out.data_ptr(), B, S, C, 1e-5, stream)
                got = (out,)
            else:
                def call(fn=fn, ws=ws, out=out, h=h):
                    return fn(x.data_ptr(), g.data_ptr(), be.data_ptr(), r.data_ptr(),
                              ws.data_ptr(), h.data_ptr(), out.data_ptr(), B, S, C, 1e-5, 1,
                              stream)
                got = (h, out)
            err = call()
            if err:
                raise RuntimeError(f"variant {name!r} ({form}) failed to launch: cudaError {err}")
            torch.cuda.synchronize()
            if name in EXACT and not all(torch.equal(a, b) for a, b in zip(got, want[form])):
                raise RuntimeError(f"variant {name!r} ({form}) is not equal to the plain version")
            calls[(name, form)] = call
            if extra:
                clocked[form] = (call, ws[-extra:])
    times = {key: [] for key in calls}
    cold = {key: [] for key in calls}
    for _ in range(args.rounds):  # the variants in turns
        for key, call in calls.items():
            ms, _, _, c = timed(torch, np, call, args.calls, 1, flush)
            times[key].append(ms)
            cold[key].append(c)
    for form in ("relu", "residual"):
        base = float(np.median(times[("as built", form)]))
        for name in libs:
            ts = times[(name, form)]
            t = float(np.median(ts))
            print(f"[variant] {form} [{B}, {S}, {C}]{' bf16' if form == 'residual' else ''} "
                  f"{name}: {t:.4f} ms back to back (rounds {min(ts):.4f}-{max(ts):.4f}; "
                  f"{t - base:+.4f} against as built), {float(np.median(cold[(name, form)])):.4f} "
                  f"with the L2 flushed; grid {grids[name]}"
                  + ("; equal to the plain version" if name in EXACT else ""), flush=True)
        call, words = clocked[form]
        phases = phase_split(torch, np, call, words, PHASES[form])
        print(f"[phases] {form} [{B}, {S}, {C}]{' bf16' if form == 'residual' else ''} by the "
              "phase clock's build (CTA 0, global timer, median of 30): "
              + ", ".join(f"{k} {v:.4f}" for k, v in phases.items()) + " ms", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parts", nargs="+", default=["rows"], choices=["rows", "variants"])
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--calls", type=int, default=20)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the rows run on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from msig_tpu_torch.ops import int8_epilogue as ep

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MiB, past the L2
    rng = np.random.default_rng(8)
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, (B, S, C), dtype=np.int32)).to(dev)
    g = torch.from_numpy(rng.normal(1.0, 0.5, (B, C)).astype(np.float32)).to(dev)
    be = torch.from_numpy(rng.normal(0.0, 0.5, (B, C)).astype(np.float32)).to(dev)
    res = torch.from_numpy(rng.normal(0, 1.5, (B, S, C)).astype(np.float32)).to(dev)
    cases = [("row 16 relu", None, lambda: ep.adain_relu_requant(x, g, be),
              lambda: ep.adain_relu_requant_plain(x, g, be))]
    for dtype in (torch.bfloat16, torch.float32):
        r = res.to(dtype)
        cases.append((f"row 17 residual {str(dtype)[6:]}", dtype,
                      lambda r=r: ep.adain_residual_requant(x, g, be, r),
                      lambda r=r: ep.adain_residual_requant_plain(x, g, be, r)))
    for label, dtype, call, plain in (cases if "rows" in args.parts else ()):
        got, want = call(), plain()
        pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
        exact = all(torch.equal(a, b) for a, b in pairs)
        ms, lo, hi, cold = timed(torch, np, call, args.calls, args.rounds, flush)
        parts, n = device_split(torch, call)
        line = (f"[rows] {label} [{B}, {S}, {C}]: {'equal' if exact else 'NOT equal'} to its plain "
                f"version; by CUDA events {ms:.4f} ms a call back to back (rounds {lo:.4f}-"
                f"{hi:.4f}), {cold:.4f} ms with the L2 flushed; device "
                f"{sum(parts.values()):.4f} ms: "
                + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
                + f"; {n:g} kernel launches a call")
        if hasattr(ep, "cooperative_grid"):
            line += f"; cooperative grid of {ep.cooperative_grid(dtype)} CTAs"
        print(line, flush=True)
    if "variants" in args.parts:
        variants_part(torch, np, ep, args, flush, x, g, be, res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
