#!/usr/bin/env python3
"""Rows 23-24 on the card: a digest of their outputs, and the bf16 train step on each route.

    python3 tools/conv_bwd_bf16_torch.py [--parts digest kernel step device] [--steps 10]

Run from the root of a checkout of msig_tpu_torch; copied into a checkout of
another tree, it measures that tree (a tree whose kernels have no bf16 entry
digests the fp32 entries alone and runs the bf16 step on them as that tree
does). Put parent and change in one call, in turns.

- ``digest``: ``conv3x3_bwd`` and ``conv3x3_adain_bwd`` (row 24's residuals
  from ``_adain_unit_fwd_impl``), with and without the relu input, on seeded
  inputs at [8, 64, 64, 256] and [1, 24, 24, 256], in fp32 (TF32 off) and,
  where the tree has them, on the bf16 entries: the sha256 of each call's
  outputs' bytes, and one over all of them per type.
- ``kernel``: the bf16 entries of both conv kernels, with and without the
  relu input, at the trunk shapes ``KERNEL_SHAPES`` ([8|4, 64, 64, 256] and
  [8|4, 128, 128, 256] of the 256² and 512² steps at batch 4, and
  [64|32, 64, 64, 256] of the bench's train mode at batch 32): ms a call (CUDA
  events, the median of 5 runs of 20 calls), cuDNN's bf16
  ``convolution_backward`` (dx and dW) on the same inputs under its default
  and its deterministic algorithms, the bound (the products at 989 TFLOP/s of
  dense bf16, or the bytes at 3.35 TB/s) and the share of it; then the
  device ms a call of each kernel the call launches (``torch.profiler``).
- ``step``: the bf16 train step (``compute_dtype=bfloat16``) at 256², batch 4,
  8 resblocks, style_dim 256, 10 domains, a seeded random VGG, cuDNN
  deterministic, as ``stock``, ``level1+pallas`` and ``level2``: ms per step,
  the median of ``--steps`` after step 1 and a warm-up step, by CUDA events;
  the launches of step 1.
- ``device``: the same step, each configuration in a process of its own (in
  one process, a second ``torch.profiler`` run lost its device events on the
  card): after step 1 and a warm-up step, 3 steps under ``torch.profiler``
  (CUDA activity): device ms a step of all kernels, of the port's kernels
  (the ``msig_*`` namespaces: rows 22-24) and of the rest, and the busy share
  of the span from the first kernel's start to the last one's end.

Prints the card's name and power limit first. Needs a card; exits 1 without
one.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = (("stock", "0", False), ("level1+pallas", "1", True), ("level2", "2", False))
SHAPES = ((8, 64), (1, 24))  # (B, side) of [B, side, side, 256]
KERNEL_SHAPES = ((8, 64), (4, 64), (8, 128), (4, 128), (64, 64), (32, 64))
C = 256
PEAK_BF16, PEAK_FP32, HBM = 989e12, 67e12, 3.35e12  # H100 SXM data sheet, dense


def digest(torch, cv) -> None:
    import numpy as np

    types = [torch.float32]
    if hasattr(cv, "_SUFFIX"):  # the tree's conv kernels have bf16 entries
        types.append(torch.bfloat16)
    for dtype in types:
        whole = hashlib.sha256()
        for b, side in SHAPES:
            rng = np.random.default_rng(b * side)
            t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
            x = t(rng.normal(0, 1, (b, side, side, C))).to(dtype)
            w = t(rng.uniform(-1, 1, (3, 3, C, C)) / np.sqrt(9 * C)).to(dtype)
            gamma, beta = t(rng.normal(1.0, 0.5, (b, C))), t(rng.normal(0.0, 0.5, (b, C)))
            g = t(rng.normal(0, 1, (b, side, side, C))).to(dtype)
            for relu in (False, True):
                _, (y, mu, r) = cv._adain_unit_fwd_impl(x, w, gamma, beta, relu)
                for name, call in (("conv3x3_bwd", lambda: cv.conv3x3_bwd(x, w, g, relu)),
                                   ("conv3x3_adain_bwd", lambda: cv.conv3x3_adain_bwd(
                                       x, w, y, mu, r, gamma, g, relu))):
                    h = hashlib.sha256()
                    for out in call():
                        h.update(out.contiguous().view(torch.uint8).cpu().numpy().tobytes())
                    whole.update(h.digest())
                    print(f"[digest {str(dtype)[6:]}] {name} {[b, side, side, C]} relu={relu}: "
                          f"{h.hexdigest()}", flush=True)
        print(f"[digest {str(dtype)[6:]}] all: {whole.hexdigest()}", flush=True)


def cuda_ms(torch, fn, reps: int = 20, runs: int = 5) -> float:
    """Median over ``runs`` of the mean ms of ``reps`` calls back to back (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return sorted(out)[len(out) // 2]


def bound_ms(name: str, b: int, side: int) -> tuple:
    """(ms, what bounds it) of one bf16 call: the conv's two products at the
    dense bf16 rate (and the unit's IN backward, ~8 flops an element, at the
    fp32 rate) against its bytes (the maps read and dx written in 2 bytes, W
    read in 2, dW written in 4; the unit's five [B, C] vectors in 4)."""
    px = b * side * side
    elems, conv, w = px * C, 2 * 2 * px * C * 9 * C, (2 + 4) * 9 * C * C
    if name == "conv3x3_bwd":
        nbytes, fp = 3 * 2 * elems + w, 0
    else:
        nbytes, fp = 4 * 2 * elems + w + 5 * 4 * b * C, 8 * elems
    t_ops, t_bytes = conv / PEAK_BF16 + fp / PEAK_FP32, nbytes / HBM
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def kernel_times(torch, cv) -> None:
    import numpy as np

    for b, side in KERNEL_SHAPES:
        rng = np.random.default_rng(b * side)
        t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
        x = t(rng.normal(0, 1, (b, side, side, C))).bfloat16()
        w = t(rng.uniform(-1, 1, (3, 3, C, C)) / np.sqrt(9 * C)).bfloat16()
        gamma, beta = t(rng.normal(1.0, 0.5, (b, C))), t(rng.normal(0.0, 0.5, (b, C)))
        g = t(rng.normal(0, 1, (b, side, side, C))).bfloat16()
        nchw = lambda v: v.permute(0, 3, 1, 2)  # noqa: E731
        wl = w.permute(3, 2, 0, 1).contiguous()
        library = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            nchw(g), nchw(x), wl, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [True, True, False])
        lib = {}
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            lib[det] = cuda_ms(torch, library)
        torch.backends.cudnn.deterministic = False
        for relu in (False, True):
            _, (y, mu, r) = cv._adain_unit_fwd_impl(x, w, gamma, beta, relu)
            for name, call in (
                    ("conv3x3_bwd", lambda: cv.conv3x3_bwd(x, w, g, relu)),
                    ("conv3x3_adain_bwd",
                     lambda: cv.conv3x3_adain_bwd(x, w, y, mu, r, gamma, g, relu))):
                ms = cuda_ms(torch, call)
                bound, by = bound_ms(name, b, side)
                split = kernel_split(torch, call) if not relu else {}
                parts = ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                print(f"[kernel bf16] {name} [{b}, {side}, {side}, {C}] relu={relu}: {ms:.4f} ms "
                      f"a call; bound {bound:.4f} ms ({by}), {bound / ms:.1%} of it; cuDNN bf16 "
                      f"convolution_backward {lib[False]:.4f} ms (default algorithms) / "
                      f"{lib[True]:.4f} ms (deterministic)"
                      + (f"; device ms a call by kernel: {parts}" if not relu else ""),
                      flush=True)
        del x, w, g, y
        torch.cuda.empty_cache()


def kernel_split(torch, fn, calls: int = 10) -> dict:
    """Device ms a call of each kernel ``fn`` launches, by ``torch.profiler``
    over ``calls`` calls after one ({} if the trace holds no device events)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("(")[0][:60]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
    return out


def bf16_step(torch, cv, level: str, pallas: bool):
    """(run one step, launches of step 1) of the bf16 step at 256², batch 4, after
    step 1 and a warm-up step."""
    import numpy as np

    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.losses import init_random_vgg
    from msig_tpu_torch.ops import adain_pallas as ap
    from msig_tpu_torch.train import create_train_state, make_train_step

    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    shape = (4, 256, 256, 3)
    batch = {"source": torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev),
             "target": torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev),
             "source_domain": torch.zeros(4, dtype=torch.int32, device=dev),
             "target_domain": torch.from_numpy(rng.integers(1, 10, 4, dtype=np.int32)).to(dev)}
    vgg, weights = init_random_vgg(1234, device="cuda"), [1.0, 10.0, 5.0, 1.0, 1.0]
    os.environ["MSIG_CONV_VJP"] = level
    cfg = TrainConfig(image_size=256, batch_size=4, n_residual_blocks=8, style_dim=256,
                      use_pallas=pallas, compute_dtype="bfloat16", device="cuda")
    state = create_train_state(cfg, 10)
    step = make_train_step(cfg.ema_beta, torch.bfloat16)
    for mod in (ap, cv):
        mod.reset_launch_counts()

    def run():
        return step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)

    run()
    torch.cuda.synchronize()
    launches = {k: v for k, v in {**ap.LAUNCHES, **cv.LAUNCHES}.items() if v}
    run()  # warm-up
    return run, launches


def step_times(torch, cv, steps: int) -> None:
    import numpy as np

    for label, level, pallas in CONFIGS:
        step, launches = bf16_step(torch, cv, level, pallas)
        events = []
        for _ in range(steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        ms = sorted(a.elapsed_time(b) for a, b in events)
        print(f"[step bf16 {label}] 256², batch 4: {float(np.median(ms)):.2f} ms per step (median "
              f"of {steps} after step 1 and a warm-up step; min {ms[0]:.2f}, max {ms[-1]:.2f}); "
              f"launches of step 1 {launches}", flush=True)
        del step
        torch.cuda.empty_cache()
    os.environ.pop("MSIG_CONV_VJP", None)


def device_times(torch, cv, label: str, steps: int = 3) -> None:
    """One configuration's device time a step by ``torch.profiler``."""
    level, pallas = next((lv, pl) for lb, lv, pl in CONFIGS if lb == label)
    step, launches = bf16_step(torch, cv, level, pallas)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"[device bf16 {label}] not measured (the trace holds no device events)", flush=True)
        return
    total = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3 / steps
    port = sum(e.time_range.end - e.time_range.start for e in kernels
               if "msig_" in e.name) / 1e3 / steps
    span = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)) / 1e3
    print(f"[device bf16 {label}] 256², batch 4, {steps} steps under torch.profiler: device "
          f"{total:.2f} ms a step (the port's kernels {port:.2f}, the rest {total - port:.2f}); "
          f"busy {100 * total * steps / span:.1f}% of the span {span / steps:.2f} ms a step; "
          f"launches of step 1 {launches}", flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parts", nargs="+", choices=("digest", "kernel", "step", "device"),
                   default=["digest", "kernel", "step", "device"])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--config", choices=[c[0] for c in CONFIGS], default=None,
                   help="with --parts device: profile this configuration in this process")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("conv_bwd_bf16_torch: no CUDA device", file=sys.stderr)
        return 1
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from msig_tpu_torch.ops import conv3x3_vjp as cv

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.config:
        device_times(torch, cv, args.config)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(f"[card] {card.stdout.strip() or card.stderr.strip()}; tree {ROOT}", flush=True)
    if "digest" in args.parts:
        digest(torch, cv)
    if "kernel" in args.parts:
        kernel_times(torch, cv)
    if "step" in args.parts:
        step_times(torch, cv, args.steps)
    if "device" in args.parts:
        for label, _, _ in CONFIGS:
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--parts", "device",
                                "--config", label], cwd=ROOT, timeout=900)
            if r.returncode != 0:
                return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
