#!/usr/bin/env python3
"""Rows 14, 22 and 24 on the card: bits, device time by kernel, batches.

    python3 tools/final7_variants_torch.py [--parts bits split train_split batches]

Uses the package and ``chip_smoke.py`` beside it, so that copied into another
checkout it measures that checkout's kernels (a wrapper without the
``w_packed`` keyword is called without it). Four parts, all by default:

* bits: row 14 (``fd.final7_tanh_u8``) at ``BIT_SHAPES`` on seeded inputs
  against its plain version (equal to the bit, or where it differs), one
  launch counted per call, and a sha256 of the kernel's outputs over all
  shapes, to hold two trees' kernels equal;
* split: row 14 at a 256² and a 512² input's maps, [8, 256, 256, 64] and
  [8, 512, 512, 64]: the time per call by CUDA events (median of 30) and
  each kernel's device time by ``torch.profiler``;
* train_split: rows 22 (``ap.adain_fwd``, ``ap.adain_bwd``) and 24
  (``cv.conv3x3_adain_bwd``) at the train step's trunk, [8|4, 64, 64, 256]
  fp32: the time per call by CUDA events and each kernel's device time by
  ``torch.profiler`` (row 24: the IN backward, the conv core, the
  reductions), beside the bytes bound;
* batches: the int8 generator (``InferenceEngine`` on the demo checkpoint,
  seeded uint8 images and styles, uint8 output) at 256² in
  ``MSIG_TRUNK_HIFI`` 0, 1 and 2 and at 512² in mode 0 with both stagings
  (``MSIG_STAGE_FP16``): its time per batch by CUDA events (median of 10
  at 256², of 5 at 512²).

Prints the card's name and power limit. Needs a card and nvcc; exits 1
without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_INT8_OPS = 1979e12
# (batch, side): chip_smoke.py's and the card tests' maps of row 14
BIT_SHAPES = ((1, 32), (2, 64), (8, 256), (2, 512), (8, 512))
SPLIT_SHAPES = ((8, 256), (8, 512))
GROUPS = (("conv + epilogue (mma.sync)", "final7_mma_kernel"),
          ("conv + epilogue (dp4a)", "final7_tanh_u8_kernel"),
          ("packed copy", "elementwise"), ("packed copy", "Copy"), ("packed copy", "Fill"))


def inputs(torch, np, fd, b, side, seed):
    """Seeded inputs of row 14 on the card (the scales put y * wscale * inv_s
    around +-1.5, across the tanh) and the packed weights where the module
    makes them."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    args = (t(rng.integers(0, 128, (b, side, side, 64), dtype=np.int8)),
            t(rng.integers(-127, 128, (3, 64, 7, 7), dtype=np.int8)),
            t(rng.uniform(1e-4, 2e-4, 3).astype(np.float32)),
            t(rng.uniform(-0.3, 0.3, 3).astype(np.float32)),
            t(rng.uniform(0.02, 0.05, (b, 1)).astype(np.float32)))
    pk = fd.pack_final7_weights(args[1]) if hasattr(fd, "pack_final7_weights") else None
    return args, pk


def final7_call(fd, args, pk):
    """The wrapper as the served decoder calls it: with the packed weights
    where it takes them."""
    kw = {"w_packed": pk} if "w_packed" in inspect.signature(fd.final7_tanh_u8).parameters else {}
    return lambda: fd.final7_tanh_u8(*args, **kw)


def bits_part(torch, np, cs, fd) -> None:
    digest = hashlib.sha256()
    for b, side in BIT_SHAPES:
        args, pk = inputs(torch, np, fd, b, side, seed=side + b)
        before = fd.LAUNCHES[fd.FINAL7_SITE]
        got = final7_call(fd, args, pk)()
        torch.cuda.synchronize()
        cs.check(fd.LAUNCHES[fd.FINAL7_SITE] == before + 1, "final7_tanh_u8: one launch per call")
        want = fd.final7_tanh_u8_plain(*args)
        digest.update(got.cpu().numpy().tobytes())
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        verdict = ("equal to the plain version to the bit" if torch.equal(got, want) else
                   f"differs on {int((diff > 0).sum())} of {got.numel()} (max {int(diff.max())})")
        print(f"[bits] final7_tanh_u8 at {[b, side, side, 64]}: {verdict}", flush=True)
        del args, pk, got, want
        torch.cuda.empty_cache()
    print(f"[bits] final7_tanh_u8: sha256 of the kernel's outputs at every shape "
          f"{digest.hexdigest()}", flush=True)


def own_rate(b, side, ms) -> str:
    """The conv's own int8 operations (3 x 3,136 multiply-adds a pixel) per
    second, and their share of the int8 peak."""
    ops = 2 * b * side * side * 3 * 3136 / (ms * 1e-3)
    return f"{ops / 1e12:.1f} TOP/s ({ops / PEAK_INT8_OPS:.1%} of 1,979)"


def split_part(torch, np, cs, fd) -> None:
    for b, side in SPLIT_SHAPES:
        args, pk = inputs(torch, np, fd, b, side, seed=side)
        call = final7_call(fd, args, pk)
        ms = cs.cuda_ms(torch, call, reps=30)
        parts = cs.kernel_split(torch, call, groups=GROUPS)
        device = sum(parts.values())
        print(f"[split] final7_tanh_u8 at {[b, side, side, 64]}: {ms:.4f} ms per call by CUDA "
              f"events (median of 30); device {device:.4f} ms by torch.profiler: "
              + (", ".join(f"{k} {v:.4f}" for k, v in parts.items()) or "not measured")
              + (f"; the conv's own {own_rate(b, side, device)}" if device else ""), flush=True)
        del args, pk
        torch.cuda.empty_cache()


def adain_inputs(torch, np, b, seed):
    """Row 22's and 24's seeded fp32 inputs at the train step's trunk
    [b, 64, 64, 256]: x, a cotangent g, gamma, beta, conv weights w."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    return (t(rng.normal(0, 1, (b, 64, 64, 256))), t(rng.normal(0, 1, (b, 64, 64, 256))),
            t(rng.normal(1.0, 0.5, (b, 256))), t(rng.normal(0.0, 0.5, (b, 256))),
            t(rng.uniform(-1, 1, (3, 3, 256, 256)) / np.sqrt(9 * 256)))


def train_calls(torch, ap, cv, b, seed):
    """{row: call} of rows 22 (forward, backward) and 24 at [b, 64, 64, 256]."""
    import numpy as np

    x, g, gamma, beta, w = adain_inputs(torch, np, b, seed)
    x3, g3 = x.reshape(b, 4096, 256), g.reshape(b, 4096, 256)
    _, mean, rstd = ap.adain_fwd_plain(x3, gamma, beta)
    _, (y, mu, r) = cv._adain_unit_fwd_impl(x, w, gamma, beta, False)
    return {"adain_pallas_fwd": lambda: ap.adain_fwd(x3, gamma, beta),
            "adain_pallas_bwd": lambda: ap.adain_bwd(x3, gamma, mean, rstd, g3),
            "conv3x3_adain_bwd": lambda: cv.conv3x3_adain_bwd(x, w, y, mu, r, gamma, g)}


TRAIN_GROUPS = (("forward", "adain_fwd_kernel"), ("IN backward", "in_bwd_kernel"),
                ("conv core", "conv3x3_bwd_kernel"), ("reductions", "reduce_kernel"))


def train_split_part(torch, np, cs) -> None:
    """Rows 22 and 24 at the train step's trunk, B = 8 and 4, fp32: the time
    per call by CUDA events (median of 50; 20 for row 24) and each kernel's
    device time by ``torch.profiler``, beside the bytes bound."""
    from msig_tpu_torch.ops import adain_pallas as ap
    from msig_tpu_torch.ops import conv3x3_vjp as cv

    torch.backends.cudnn.allow_tf32 = False
    for b in (8, 4):
        for name, call in train_calls(torch, ap, cv, b, seed=b).items():
            reps = 20 if name.startswith("conv") else 50
            ms = cs.cuda_ms(torch, call, reps=reps)
            parts = cs.kernel_split(torch, call, groups=TRAIN_GROUPS)
            bound_ms, bound_by, _ = cs.train_bound(name, b)
            print(f"[split] {name} at [{b}, 64, 64, 256] fp32: {ms:.4f} ms per call by CUDA "
                  f"events (median of {reps}); device {sum(parts.values()):.4f} ms by "
                  f"torch.profiler: " + (", ".join(f"{k} {v:.4f}" for k, v in parts.items())
                                        or "not measured")
                  + f"; bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        torch.cuda.empty_cache()


def batch_part(torch, np, cs) -> None:
    """The int8 generator's time per batch of ``cs.B``, uint8 output, at 256²
    in each trunk mode and at 512² in mode 0 with both stagings (the demo
    checkpoint, seeded images and styles)."""
    from msig_tpu_torch.config import InferenceConfig
    from msig_tpu_torch.infer.engine import InferenceEngine
    from msig_tpu_torch.infer.loading import load_inference_params

    for size, reps, settings in ((256, 10, [dict(MSIG_TRUNK_HIFI=m) for m in "012"]),
                                 (512, 5, [dict(MSIG_TRUNK_HIFI="0", MSIG_STAGE_FP16=s)
                                           for s in "01"])):
        cfg = InferenceConfig(image_size=size, batch_size=cs.B, device="cuda",
                              compute_dtype="float32", quantize="int8")
        gen_sd, se_sd, meta, _ = load_inference_params(cs.DEMO, cfg, 10)
        eng = InferenceEngine.build(cfg, 10, gen_sd, se_sd, meta["n_residual_blocks"],
                                    meta["style_dim"])
        eng.out_uint8 = True
        rng = np.random.default_rng(size)
        imgs = torch.from_numpy(rng.integers(0, 256, (cs.B, size, size, 3),
                                             dtype=np.uint8)).cuda()
        styles = torch.from_numpy(rng.normal(size=(cs.B, meta["style_dim"])).astype(
            np.float32)).cuda()
        for env in settings:
            with cs.env(**env):
                ms = cs.cuda_ms(torch, lambda: eng.generate(imgs, styles), reps=reps, warmup=2)
            print(f"[batch] {size}² {' '.join(f'{k}={v}' for k, v in env.items())}, uint8 output: "
                  f"int8 generator, batch {cs.B}: {ms:.3f} ms per batch (median of {reps}, CUDA "
                  f"events)", flush=True)
        del eng, imgs, styles
        torch.cuda.empty_cache()


PARTS = ("bits", "split", "train_split", "batches")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS))
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: rows 14 and 22 run on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from msig_tpu_torch.ops import _build
    from msig_tpu_torch.ops import fused_dec_int8 as fd

    _build.build([fd.FINAL7_SITE])
    print(f"[card] {cs.card_line()}", flush=True)
    if "bits" in args.parts:
        bits_part(torch, np, cs, fd)
    if "split" in args.parts:
        split_part(torch, np, cs, fd)
    if "train_split" in args.parts:
        train_split_part(torch, np, cs)
    if "batches" in args.parts:
        batch_part(torch, np, cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
