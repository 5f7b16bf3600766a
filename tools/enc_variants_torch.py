#!/usr/bin/env python3
"""Where the time of the encoder's two-pass sites goes (rows 7-11): variants, timed alone.

    python3 tools/enc_variants_torch.py [--reps 5] [--calls 20]

Builds ``msig_tpu_torch/csrc/enc0_in_relu_requant.cu`` and
``conv4x4s2_in_relu_requant.cu`` (with ``conv_i8_wgmma.cuh``) as they are and
in variants made by editing their text (each variant one nvcc, all at once,
into ``build/msig_kernels/enc_variants/``), and times each site's entry
launched back to back ``--calls`` times between two CUDA events, median of
``--reps``, at the main path's shapes: enc0 [8, 256, 256, 3] (row 7) and
[8, 512, 512, 3] (row 10, int32 staging), enc1 [8, 256, 256, 64] -> 128
(row 8) and enc2 [8, 128, 128, 128] -> 256 (row 9), and the 4x4/s2 source's
four-phase entry (row 11, enc1 with four distinct phase blocks) at enc1's
shape; seeded inputs, K-major weights for the 4x4/s2 site. What it times,
each as a row:

* ``as built``: the site as its entry runs it (memset, pass S, pass Q);
* ``pass S alone`` and ``pass Q alone`` (pass Q on the statistics of a full
  run made before the timing);
* for enc0: ``no products`` (no wgmma issued), ``no halo loads`` (the
  halo words made from their index, not read from the image), ``no im2col``
  (the im2col rows neither gathered nor stored), ``no statistics`` (pass S
  keeps no partials) and ``no stores`` (pass Q stages its tile but writes
  nothing);
* for the 4x4/s2 site: ``strided walk`` (each CTA takes every gridDim-th
  tile, as rows 1-2's int32 pass walks, in place of a contiguous run; pass Q
  then rebuilds its requant at nearly every tile), ``no statistics``,
  ``no stores``, ``no loads`` (neither operand copied) and ``no products``
  (no wgmma issued); for the four-phase entry the same builds (its strided
  walk is no change: a phased geometry always takes a contiguous run) and
  ``one K block a stage`` (against two, the phased geometries' setting).

A variant computes wrong values (its time says what the part it cuts costs);
the as-built rows are held equal to the plain versions. Prints each time with
the int8 rate of the conv's operations, once per pass, and its share of the
card's 1,979 TOP/s, the card's name and power limit, and ptxas's registers
and spills per variant. Needs a card and nvcc; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_INT8_OPS = 1979e12
E0, S2 = "enc0_in_relu_requant", "conv4x4s2_in_relu_requant"
HEADER = "conv_i8_wgmma.cuh"

_E0_S_ALONE = ("  enc0_i8_requant_kernel<Stage><<<", "  if (0) enc0_i8_requant_kernel<Stage><<<")
_E0_Q_ALONE = [("cudaMemsetAsync(stats, 0, ((size_t)kStatBlocks * B * kE0Cout + B) * sizeof(long long), "
                "st);", "cudaSuccess;"),
               ("  enc0_i8_stats_kernel<<<", "  if (0) enc0_i8_stats_kernel<<<")]
_S2_GEOMS = "std::is_same_v<Geom, Conv4x4s2Geom> || std::is_same_v<Geom, Enc1PhaseGeom>"
_S2_S_ALONE = (f"if constexpr ({_S2_GEOMS})\n    return launch<Geom, BN, Epi::kRequant>(p, st);",
               f"if constexpr ({_S2_GEOMS})\n    return 0;")
_ARGS_P = ("  const Args p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wk), out,\n"
           "               static_cast<long long*>(stats), static_cast<float*>(out_scale), B, "
           "H, W, Cin,\n               Cout, eps};\n")
_S2_Q_ALONE = [("  const int err = launch<Geom, BN, Epi::kStats, int32_t, MB>(p, st);",
                f"  const int err = ({_S2_GEOMS}) ? 0 : "
                "launch<Geom, BN, Epi::kStats, int32_t, MB>(p, st);"),
               ("  const int err = zero_stats(stats, B, Cout, st);\n  if (err != 0) return err;\n"
                + _ARGS_P + "  return two_passes<Enc1PhaseGeom",
                _ARGS_P + "  return two_passes<Enc1PhaseGeom"),
               ("  const int err = zero_stats(stats, B, Cout, st);\n  if (err != 0) return err;\n"
                "  const Args p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wk), out,\n"
                "               static_cast<long long*>(stats), static_cast<float*>(out_scale), B, "
                "H, W, Cin,\n               Cout, eps};\n  if (Cout % 256",
                "  const Args p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wk), out,\n"
                "               static_cast<long long*>(stats), static_cast<float*>(out_scale), B, "
                "H, W, Cin,\n               Cout, eps};\n  if (Cout % 256")]
_S2_NO_STATS = [("warp_stats<BN, kTrue>(acc[mb], cta, lane);", "(void)0;"),
                ("if constexpr (kRegStats) reg.add(acc[mb]);", "if constexpr (kRegStats) (void)0;"),
                ("reg.fold(cta, lane);", "(void)0;")]
# site -> {variant name: [(file, old text, new text[, occurrences]), ...]}; each old
# text occurs once unless the edit says how often
VARIANTS = {
    E0: {
        "as built": [],
        "pass S alone": [(E0, *_E0_S_ALONE)],
        "pass Q alone": [(E0, *e) for e in _E0_Q_ALONE],
        "no products": [(E0, "      wgmma::wgmma_m64n256k32(", "      if (0) wgmma::wgmma_m64n256k32(")],
        "no halo loads": [(E0, "v = enc0_halo_word(img, b, H, W, oy0, ox0, i - sel * kE0Halo);",
                           "v = (uint32_t)i;")],
        "no im2col": [(E0, "        *reinterpret_cast<uint4*>(row + (c >> 3)",
                       "        if (0) *reinterpret_cast<uint4*>(row + (c >> 3)")],
        "no statistics": [(E0, "          ps[s][h] += v0 + v1;  // two values below 2^21.2\n"
                               "          pq[s][h] += (unsigned long long)((long long)v0 * v0) +\n"
                               "                      (unsigned long long)((long long)v1 * v1);\n"
                               "          pmn[s][h] = min(pmn[s][h], min(v0, v1));\n"
                               "          pmx[s][h] = max(pmx[s][h], max(v0, v1));",
                           "          (void)v0, (void)v1, (void)s;")],
        "no stores": [(E0, "        *reinterpret_cast<int4*>(out + (((size_t)bs[s]",
                       "        if (0) *reinterpret_cast<int4*>(out + (((size_t)bs[s]")],
    },
    S2: {
        "as built": [],
        "pass S alone": [(HEADER, *_S2_S_ALONE)],
        "pass Q alone": [(HEADER, *e) for e in _S2_Q_ALONE],
        "strided walk": [(HEADER, "if constexpr (Geom::kPhases > 1 || E != Epi::kInt32) {",
                          "if constexpr (Geom::kPhases > 1) {")],
        "no statistics": [(HEADER, *e) for e in _S2_NO_STATS],
        "no stores": [(HEADER, "*reinterpret_cast<int4*>(yb + (ob",
                       "if (0) *reinterpret_cast<int4*>(yb + (ob")],
        "no loads": [(HEADER, "cp_async16(sa + row * kBK", "if (0) cp_async16(sa + row * kBK"),
                     (HEADER, "cp_async16(sb + n * kBK", "if (0) cp_async16(sb + n * kBK")],
        "no products": [(HEADER, "wgmma_tile<BN>(acc[mb], sw128_desc",
                         "if (0) wgmma_tile<BN>(acc[mb], sw128_desc")],
        "one K block a stage": [(HEADER, "constexpr int kSubBlocks = Geom::kPhases > 1 ? 2 : 1;",
                                 "constexpr int kSubBlocks = Geom::kPhases > 1 && "
                                 "Geom::kStride == 1 ? 2 : 1;")],
    },
}
I2C = "enc1_phases"  # the four-phase entry of the 4x4/s2 source (row 11)
SHAPES = ((E0, 8, 256, 3, 64), (E0, 8, 512, 3, 64), (S2, 8, 256, 64, 128), (S2, 8, 128, 128, 256),
          (I2C, 8, 256, 64, 128))
# site -> (the source whose builds it runs, its C entry)
ENTRIES = {E0: (E0, f"msig_{E0}"), S2: (S2, f"msig_{S2}"),
           I2C: (S2, "msig_enc1_phases_in_relu_requant")}
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARGTYPES = {E0: [P] * 4 + [I] * 3 + [F, I, P], S2: [P] * 5 + [I] * 5 + [F, P]}


def build_variants(_build) -> dict:
    """{(source, name): its library} of every variant, compiled in parallel."""
    procs = {}
    for site, variants in VARIANTS.items():
        for i, (name, edits) in enumerate(variants.items()):
            texts = {f: open(os.path.join(_build.CSRC, f if f.endswith(".cuh") else f + ".cu")).read()
                     for f in (site, HEADER)}
            for f, old, new, *times in edits:
                if texts[f].count(old) != (times[0] if times else 1):
                    raise RuntimeError(f"variant {site}/{name}: {old!r} occurs "
                                       f"{texts[f].count(old)} times")
                texts[f] = texts[f].replace(old, new)
            d = _build.BUILD_DIR / "enc_variants" / f"{site}_v{i}"
            d.mkdir(parents=True, exist_ok=True)
            for f, text in texts.items():  # quoted includes find the edited copies first
                (d / (f if f.endswith(".cuh") else f + ".cu")).write_text(text)
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(d), "-I", str(_build.CSRC),
                   "-o", str(d / "variant.so"), str(d / f"{site}.cu")]
            procs[site, name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (site, name), (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {site}/{name}:\n{log}")
        regs = sorted({line.split(":", 1)[-1].strip() for line in log.splitlines()
                       if ("registers" in line or "spill" in line) and "used 0 barriers" not in line})
        print(f"[build] {site} / {name}: " + " | ".join(regs[:6]), flush=True)
        fns[site, name] = ctypes.CDLL(str(d / "variant.so"))
    return fns


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
    from msig_tpu_torch.ops import fused_enc_int8 as fe

    libs = build_variants(_build)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for site, b, side, cin, cout in SHAPES:
        rng = np.random.default_rng(side + cin)
        if site == E0:
            x = torch.from_numpy(rng.integers(0, 256, (b, side, side, 3), dtype=np.uint8)).cuda()
            w = fe.pack_enc0(torch.from_numpy(
                rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8))).cuda()
            want = fe.enc0_in_relu_requant_plain(x, w)
            out = torch.empty((b, side, side, cout), dtype=torch.int8, device="cuda")
            ops = 2 * b * side * side * cout * 147
            label = f"enc0 [{b}, {side}, {side}, 3]"
        elif site == I2C:
            x = torch.from_numpy(rng.integers(0, 128, (b, side, side, cin), dtype=np.int8)).cuda()
            w = torch.cat([fe.pack_conv4x4(torch.from_numpy(rng.integers(
                -127, 128, (4, 4, cin, cout), dtype=np.int8))) for _ in range(4)]).cuda()
            want = fe.enc1_in_relu_requant_im2col_plain(x, w)
            w = fe.pack_enc1_im2col_kmajor(w)
            out = torch.empty((b, side // 2, side // 2, cout), dtype=torch.int8, device="cuda")
            ops = 2 * b * (side // 2) ** 2 * cout * 16 * cin
            label = f"enc1 four phases [{b}, {side}, {side}, {cin}] -> {cout}"
        else:
            x = torch.from_numpy(rng.integers(0, 128, (b, side, side, cin), dtype=np.int8)).cuda()
            w = fe.pack_conv4x4(torch.from_numpy(
                rng.integers(-127, 128, (4, 4, cin, cout), dtype=np.int8))).cuda()
            want = fe.enc2_in_relu_requant_plain(x, w)[0]
            w = fe.pack_conv4x4_kmajor(w)
            out = torch.empty((b, side // 2, side // 2, cout), dtype=torch.int8, device="cuda")
            ops = 2 * b * (side // 2) ** 2 * cout * 16 * cin
            label = f"conv4x4s2 [{b}, {side}, {side}, {cin}] -> {cout}"
        stats = torch.zeros(5 * b * cout + b, dtype=torch.int64, device="cuda")
        scale = torch.empty(b, dtype=torch.float32, device="cuda")

        def run(fn):
            if site == E0:
                err = fn(x.data_ptr(), w.data_ptr(), stats.data_ptr(), out.data_ptr(), b, side,
                         side, 1e-5, 0, stream)
            else:
                err = fn(x.data_ptr(), w.data_ptr(), stats.data_ptr(), out.data_ptr(),
                         scale.data_ptr(), b, side, side, cin, cout, 1e-5, stream)
            if err:
                raise RuntimeError(f"{label}: cudaError {err}")
        src, entry = ENTRIES[site]
        fns = {}
        for name in VARIANTS[src]:
            fns[name] = getattr(libs[src, name], entry)
            fns[name].argtypes, fns[name].restype = ARGTYPES[src], ctypes.c_int
        for name, fn in fns.items():
            if site == I2C and name == "strided walk":
                continue
            run(fns["as built"])  # the statistics that pass Q alone reads
            out.zero_()
            for _ in range(3):
                run(fn)
            torch.cuda.synchronize()
            exact = ""
            if name == "as built":
                exact = ", equal to the plain version" if torch.equal(out, want) else \
                    ", NOT equal to the plain version"
            ms = []
            for _ in range(args.reps):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(args.calls):
                    run(fn)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end) / args.calls)
            t = float(np.median(ms))
            passes = 1 if name.endswith("alone") else 2
            print(f"[variant] {label} {name}: {t:.4f} ms, "
                  f"{passes * ops / (t * 1e-3) / 1e12:.1f} TOP/s over {passes} pass(es) "
                  f"({passes * ops / (t * 1e-3) / PEAK_INT8_OPS:.1%} of 1,979){exact}", flush=True)
        del x, w, out, stats, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(argv=None))
