#!/usr/bin/env python3
"""The hi-fi conv2 sites (rows 3-4) on the card: bits, device time by kernel, epilogue variants.

    python3 tools/trunk_hifi_variants_torch.py [--reps 15] [--calls 20]
        [--parts bits split variants batches]

Uses the package and ``chip_smoke.py`` beside it, so that copied into another
checkout it measures that checkout's kernels (a wrapper without the
``w_kmajor`` keyword is called without it). Four parts, all by default:

* bits: rows 3-4 (``fc.conv3x3_adain_residual_hifi``, ``..._hifi2``) at
  ``BIT_SHAPES`` (``chip_smoke.WGMMA_SHAPES``) on seeded inputs (the int8
  map, a normal residual as bf16 and as its two int8 planes with their
  scale), against their plain versions: equal to the bit, or where they
  differ (elements, largest step or bf16 ulp); one launch counted per call;
  a sha256 of the kernel's outputs over all shapes, to hold two trees'
  kernels equal;
* split: at the trunk shapes of a 256² and a 512² input, [8, 64, 64, 256]
  and [8, 128, 128, 256], the time per call by CUDA events (median of 30)
  and the device time of each kernel of a call by ``torch.profiler``:
  the statistics' zero fill, pass A, each epilogue kernel;
* variants (skipped where row 4's source has no ``fixed_group_channels``):
  the two C entries built as they are, row 3 with its carry kernel reading a
  thread's four channels into registers once (fixed where C divides 1024, as
  row 4's kernels read them), and row 4 with its kernels taking the channel
  index at every step, ``(4i) % C``, each one nvcc into
  ``build/msig_kernels/variants_hifi/``; at both shapes each variant's
  outputs equal to the wrapper's to the bit, its time
  per call (``--calls`` launches back to back between two CUDA events, median
  and quartiles of ``--reps`` rounds, the variants in turns within each
  round) and each kernel's device time by ``torch.profiler`` (in the first
  variant measured the trace has read low or held no events on the card;
  the CUDA events are the measure);
* batches: the int8 generator (``InferenceEngine`` on the demo checkpoint,
  seeded uint8 images and styles) at 256² and 512², batch 8, in
  ``MSIG_TRUNK_HIFI`` 0, 1 and 2, with the served uint8 output and the
  engine's default float32 output: its time per batch by CUDA events
  (median of 10 at 256², of 5 at 512²).

Prints the card's name and power limit. Needs a card and nvcc; exits 1
without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import inspect
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (batch, side, channels): chip_smoke.WGMMA_SHAPES, kept here so that two
# trees' digests cover the same maps; and the trunk of a 256² and a 512² input
BIT_SHAPES = ((1, 16, 128), (2, 16, 256), (8, 64, 256), (8, 128, 256), (1, 96, 256), (1, 16, 384))
SPLIT_SHAPES = ((8, 64, 256), (8, 128, 256))
# torch.profiler kernel names -> the parts of a call
GROUPS = (("pass A (wgmma)", "conv3x3_i8_wgmma_kernel"),
          ("pass A (mma.sync)", "conv_i8_stats_kernel"),
          ("carry + max|hn|", "hifi_carry_kernel"), ("int8 copy", "hifi_requant_kernel"),
          ("max|hn|", "hifi2_amax_kernel"), ("two planes", "hifi2_requant_kernel"),
          ("zero fill", "Memset"), ("zero fill", "FillFunctor"))
SOURCES = ("conv3x3_adain_residual_hifi", "conv3x3_adain_residual_hifi2")
# name -> {source: edits (old text, new text), each old text found once}. Row
# 3's carry kernel takes its group's channels at every step; the variant reads
# a thread's four channels, fixed where C divides 1024 (C = 256 here), into
# registers once, as row 4's kernels do (GroupAffine); row 4's variant takes
# the index at every step.
VARIANTS = {
    "as built": {s: [] for s in SOURCES},
    "fixed channels": {SOURCES[0]: [
        ("  float local = 0.f;\n  for (size_t i",
         "  float a[4], d[4];\n  for (int k = 0; k < 4; ++k)\n"
         "    a[k] = a_s[(4 * (int)threadIdx.x) % C + k], d[k] = d_s[(4 * (int)threadIdx.x) % C + k];\n"
         "  float local = 0.f;\n  for (size_t i"),
        ("    const int c = (int)((i * 4) % C);\n", ""),
        ("__fmul_rn((float)vals[k], a_s[c + k]), d_s[c + k])", "__fmul_rn((float)vals[k], a[k]), d[k])")]},
    "channel index at every step": {SOURCES[1]: [
        ("const bool fixed = fixed_group_channels(C);", "const bool fixed = false;")]},
}


def inputs(torch, np, fc, b, side, c, seed):
    """Seeded site inputs on the card: x, the residual as bf16 (hb) and as two
    int8 planes (h1, h2) under hs, weights w and their K-major copy wk,
    gamma, beta."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    h = rng.normal(0, 1.5, (b, side, side, c)).astype(np.float32)
    hs = (np.abs(h).max(axis=(1, 2, 3)) / 127.0).astype(np.float32).reshape(b, 1)
    ht = h / hs.reshape(b, 1, 1, 1)
    h1 = np.clip(np.round(ht), -127, 127)
    h2 = np.clip(np.round((ht - h1) * 254.0), -127, 127)
    w = fc.pack_weights(torch.from_numpy(rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8)))
    return dict(x=t(rng.integers(-127, 128, (b, side, side, c), dtype=np.int8)),
                hb=t(h).to(torch.bfloat16), h1=t(h1.astype(np.int8)), h2=t(h2.astype(np.int8)),
                hs=t(hs), w=w.cuda(), wk=fc.pack_weights_kmajor(w).cuda(),
                gamma=t(rng.normal(1.0, 0.5, (b, c)).astype(np.float32)),
                beta=t(rng.normal(0.0, 0.5, (b, c)).astype(np.float32)))


def sites(fc, t):
    """{name: (kernel call, plain call)} of rows 3-4 on inputs t; the K-major
    copy is passed where the wrapper takes it."""
    out = {}
    for name, res in ((fc.HIFI_SITE, ("hb",)), (fc.HIFI2_SITE, ("h1", "h2", "hs"))):
        fn = getattr(fc, name)
        args = (t["x"], *(t[k] for k in res), t["w"], t["gamma"], t["beta"])
        kw = {"w_kmajor": t["wk"]} if "w_kmajor" in inspect.signature(fn).parameters else {}
        out[name] = ((lambda fn=fn, args=args, kw=kw: fn(*args, **kw)),
                     (lambda fn=getattr(fc, name + "_plain"), args=args: fn(*args)))
    return out


def bits_part(torch, np, cs, fc) -> None:
    digest = {name: hashlib.sha256() for name in (fc.HIFI_SITE, fc.HIFI2_SITE)}
    for b, side, c in BIT_SHAPES:
        t = inputs(torch, np, fc, b, side, c, seed=side + c)
        for name, (kernel, plain) in sites(fc, t).items():
            before = fc.LAUNCHES[name]
            got = kernel()
            torch.cuda.synchronize()
            cs.check(fc.LAUNCHES[name] == before + 1, f"{name}: one launch per call")
            want = plain()
            report = []
            for k, (g, w) in enumerate(zip(got, want)):
                digest[name].update(g.contiguous().view(torch.uint8).cpu().numpy().tobytes())
                if torch.equal(g, w):
                    report.append(f"output {k} equal")
                    continue
                if g.dtype == torch.bfloat16:
                    diff, unit = cs.bf16_ulps(torch, g, w), "ulp"
                elif g.dtype == torch.float32:
                    diff, unit = ((g - w).abs() / w.abs()), "rel"
                else:
                    diff, unit = (g.to(torch.int32) - w.to(torch.int32)).abs(), "step"
                report.append(f"output {k} differs on {int((g != w).sum())} of {g.numel()} "
                              f"(max {float(diff.max()):.3g} {unit})")
            verdict = "equal to the plain version to the bit" if all(
                r.endswith("equal") for r in report) else "; ".join(report)
            print(f"[bits] {name} at {[b, side, side, c]}: {verdict}", flush=True)
        del t
        torch.cuda.empty_cache()
    for name, d in digest.items():
        print(f"[bits] {name}: sha256 of the kernel's outputs at every shape {d.hexdigest()}",
              flush=True)


def split_part(torch, np, cs, fc) -> None:
    for b, side, c in SPLIT_SHAPES:
        t = inputs(torch, np, fc, b, side, c, seed=side)
        for name, (kernel, _) in sites(fc, t).items():
            ms = cs.cuda_ms(torch, kernel, reps=30)
            parts = cs.kernel_split(torch, kernel, groups=GROUPS)
            print(f"[split] {name} at {[b, side, side, c]}: {ms:.4f} ms per call by CUDA events "
                  f"(median of 30); device {sum(parts.values()):.4f} ms by torch.profiler: "
                  + (", ".join(f"{k} {v:.4f}" for k, v in parts.items()) or "not measured"),
                  flush=True)
        del t
        torch.cuda.empty_cache()


def device_ms(torch, fn, calls: int) -> str:
    """Each kernel's device ms per call of ``fn`` over ``calls`` calls
    (``torch.profiler``), by name, with its launches per call. The first trace
    after a variant's library is loaded lost or halved its events on the
    card, so a first trace is taken and dropped."""
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((g for g, k in GROUPS if k in e.name), e.name[:60])
            total[name] = total.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
            count[name] = count.get(name, 0) + 1
    return ", ".join(f"{k} {v / calls:.4f} ({count[k] / calls:g} a call)"
                     for k, v in total.items()) or "not measured (no device events)"


def build_variants(_build) -> dict:
    """{(variant, source): ctypes entry}, every variant compiled in parallel;
    None where the sources are not those the edits were written for."""
    texts = {s: (_build.CSRC / f"{s}.cu").read_text() for s in SOURCES}
    if "fixed_group_channels" not in texts[SOURCES[1]]:
        return None
    procs = {}
    for i, (name, by_source) in enumerate(VARIANTS.items()):
        for source, edits in by_source.items():
            text = texts[source]
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"variant {name!r}: {old!r} occurs {text.count(old)} times "
                                       f"in {source}.cu")
                text = text.replace(old, new)
            d = _build.BUILD_DIR / "variants_hifi" / f"v{i}"
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{source}.cu").write_text(text)
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                   str(d / f"{source}.so"), str(d / f"{source}.cu")]
            procs[(name, source)] = (d / f"{source}.so", subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (name, source), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r} of {source}:\n{log}")
        regs = sorted({line.split(":", 1)[-1].strip() for line in log.splitlines()
                       if "registers" in line or "spill" in line})
        print(f"[build] {source}, {name}: " + " | ".join(regs), flush=True)
        fns[(name, source)] = getattr(ctypes.CDLL(str(lib)), f"msig_{source}")
    return fns


def variants_part(torch, np, cs, fc, _build, args) -> None:
    fns = build_variants(_build)
    if fns is None:
        print("[variant] not built: these sources have no fixed_group_channels switch", flush=True)
        return
    stream = torch.cuda.current_stream().cuda_stream
    for b, side, c in SPLIT_SHAPES:
        t = inputs(torch, np, fc, b, side, c, seed=side)
        y = torch.empty((b, side * side, c), dtype=torch.int32, device="cuda")
        stats = torch.empty(5 * b * c + b, dtype=torch.int64, device="cuda")
        out = {fc.HIFI_SITE: (torch.empty_like(t["x"]), torch.empty_like(t["hb"])),
               fc.HIFI2_SITE: (torch.empty_like(t["x"]), torch.empty_like(t["x"]),
                               torch.empty((b, 1), dtype=torch.float32, device="cuda"))}
        ptrs = {fc.HIFI_SITE: (t["x"], t["hb"], t["wk"], t["gamma"], t["beta"], y, stats,
                               *out[fc.HIFI_SITE]),
                fc.HIFI2_SITE: (t["x"], t["h1"], t["h2"], t["hs"], t["wk"], t["gamma"], t["beta"],
                                y, stats, *out[fc.HIFI2_SITE])}
        want = {name: kernel() for name, (kernel, _) in sites(fc, t).items()}
        calls = {}
        for (variant, source), fn in fns.items():
            fn.argtypes = fc._ARGTYPES[source]
            fn.restype = ctypes.c_int

            def call(fn=fn, source=source, variant=variant):
                err = fn(*(p.data_ptr() for p in ptrs[source]), b, side, side, c, 1e-5, stream)
                if err:
                    raise RuntimeError(f"{source} ({variant}) failed to launch: cudaError {err}")
            call()
            torch.cuda.synchronize()
            cs.check(all(torch.equal(g, w) for g, w in zip(out[source], want[source])),
                     f"{source} ({variant}) at {[b, side, side, c]} equal to the wrapper's outputs")
            calls[(variant, source)] = call
        ms = {key: [] for key in calls}
        for r in range(args.reps):
            order = list(calls) if r % 2 == 0 else list(reversed(list(calls)))
            for key in order:
                for _ in range(2):
                    calls[key]()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                for _ in range(args.calls):
                    calls[key]()
                end.record()
                torch.cuda.synchronize()
                ms[key].append(start.elapsed_time(end) / args.calls)
        for (variant, source), call in calls.items():
            q1, med, q3 = np.percentile(ms[(variant, source)], [25, 50, 75])
            print(f"[variant] {source} at {[b, side, side, c]}, {variant}: {med:.4f} ms per call "
                  f"(median of {args.reps}, quartiles {q1:.4f} / {q3:.4f}; {args.calls} calls "
                  f"back to back, CUDA events; bits equal to the wrapper's); device ms per call "
                  f"by torch.profiler: " + device_ms(torch, call, 10), flush=True)
        del t, y, stats, out, ptrs, want
        torch.cuda.empty_cache()


def batch_part(torch, np, cs) -> None:
    """The int8 generator's time per batch of ``cs.B`` in each trunk mode, at
    256² and 512² (the demo checkpoint, seeded images and styles), with the
    served uint8 output and with the engine's default float32 output (at 512²
    the ``pallas=("trunk",)`` chain)."""
    from msig_tpu_torch.config import InferenceConfig
    from msig_tpu_torch.infer.engine import InferenceEngine
    from msig_tpu_torch.infer.loading import load_inference_params

    for size, reps in ((256, 10), (512, 5)):
        cfg = InferenceConfig(image_size=size, batch_size=cs.B, device="cuda",
                              compute_dtype="float32", quantize="int8")
        gen_sd, se_sd, meta, _ = load_inference_params(cs.DEMO, cfg, 10)
        eng = InferenceEngine.build(cfg, 10, gen_sd, se_sd, meta["n_residual_blocks"],
                                    meta["style_dim"])
        rng = np.random.default_rng(size)
        imgs = torch.from_numpy(rng.integers(0, 256, (cs.B, size, size, 3),
                                             dtype=np.uint8)).cuda()
        styles = torch.from_numpy(rng.normal(size=(cs.B, meta["style_dim"])).astype(
            np.float32)).cuda()
        for out_uint8 in (True, False):
            eng.out_uint8 = out_uint8
            for hifi in ("0", "1", "2"):
                with cs.env(MSIG_TRUNK_HIFI=hifi):
                    ms = cs.cuda_ms(torch, lambda: eng.generate(imgs, styles), reps=reps,
                                    warmup=2)
                print(f"[batch] {size}² MSIG_TRUNK_HIFI={hifi}, "
                      f"{'uint8' if out_uint8 else 'float32'} output: int8 generator, batch "
                      f"{cs.B}: {ms:.3f} ms per batch (median of {reps}, CUDA events)", flush=True)
        del eng, imgs, styles
        torch.cuda.empty_cache()


PARTS = ("bits", "split", "variants", "batches")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=15)
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS))
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the hi-fi kernels run on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from msig_tpu_torch.ops import _build
    from msig_tpu_torch.ops import fused_conv_int8_v2 as fc

    _build.build([fc.HIFI_SITE, fc.HIFI2_SITE])
    print(f"[card] {cs.card_line()}", flush=True)
    if "bits" in args.parts:
        bits_part(torch, np, cs, fc)
    if "split" in args.parts:
        split_part(torch, np, cs, fc)
    if "variants" in args.parts:
        variants_part(torch, np, cs, fc, _build, args)
    if "batches" in args.parts:
        batch_part(torch, np, cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
