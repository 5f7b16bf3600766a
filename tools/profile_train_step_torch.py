#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one NVIDIA GPU.

    python3 tools/profile_train_step_torch.py [--steps 3] [--out profile.json]

Runs ``msig_tpu_torch.train.make_train_step`` at full width (256², batch 4,
8 resblocks, style_dim 256, 10 domains, a seeded random VGG; fp32, TF32 off)
in the three configurations of ``chip_smoke.py`` (stock autograd,
``MSIG_CONV_VJP=1`` with ``use_pallas``, ``MSIG_CONV_VJP=2``), and traces
``--steps`` steps of each after two warm-up steps with ``torch.profiler``.
For each configuration it prints the wall time per step (CUDA events), the
device-busy time per step (the union of the kernels' intervals) and the idle
share, and the kernel time per step by group (the port's CUDA kernels by name,
cuDNN/cuBLAS convolution and GEMM kernels, elementwise and reduction kernels,
the rest) with the ten largest kernels. Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = (("stock", "0", False), ("level1+pallas", "1", True), ("level2", "2", False))
PORT_KERNELS = re.compile(r"msig_in::|msig_f32::")
LIBRARY = re.compile(r"cudnn|conv|xmma|gemm|sgemm|cutlass|wgrad|dgrad|implicit_convolve", re.I)
ELEMENTWISE = re.compile(r"elementwise|vectorized|unrolled|copy|fill|where|index", re.I)
REDUCTION = re.compile(r"reduce|norm|softmax|sum|max", re.I)


def group_of(name: str) -> str:
    if PORT_KERNELS.search(name):
        return "port CUDA kernels"
    if LIBRARY.search(name):
        return "cuDNN / cuBLAS conv and GEMM"
    if ELEMENTWISE.search(name):
        return "elementwise and copies"
    if REDUCTION.search(name):
        return "reductions"
    return "other"


def union_us(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    import numpy as np
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--out", default=None, help="also write the report as JSON here")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_train_step_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.losses import init_random_vgg
    from msig_tpu_torch.train import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    batch = {"source": torch.from_numpy(rng.integers(0, 256, (4, 256, 256, 3), dtype=np.uint8)).to(dev),
             "target": torch.from_numpy(rng.integers(0, 256, (4, 256, 256, 3), dtype=np.uint8)).to(dev),
             "source_domain": torch.zeros(4, dtype=torch.int32, device=dev),
             "target_domain": torch.from_numpy(rng.integers(1, 10, 4, dtype=np.int32)).to(dev)}
    vgg = init_random_vgg(1234, device=dev)
    weights = [1.0, 10.0, 5.0, 1.0, 1.0]
    report = {"card": card, "configs": {}}
    for label, level, pallas in CONFIGS:
        os.environ["MSIG_CONV_VJP"] = level
        cfg = TrainConfig(image_size=256, batch_size=4, n_residual_blocks=8, style_dim=256,
                          use_pallas=pallas, device="cuda")
        state = create_train_state(cfg, 10)
        step = make_train_step(cfg.ema_beta)
        for _ in range(2):
            step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            start.record()
            for _ in range(args.steps):
                step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
            end.record()
            torch.cuda.synchronize()
        wall_ms = start.elapsed_time(end) / args.steps
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            print(f"[{label}] the trace holds no device events; wall {wall_ms:.2f} ms per step")
            continue
        by_name, by_group = defaultdict(float), defaultdict(float)
        for e in kernels:
            us = e.time_range.end - e.time_range.start
            by_name[e.name] += us / args.steps
            by_group[group_of(e.name)] += us / args.steps
        busy_ms = union_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3 / args.steps
        span = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels))
        idle = 1.0 - busy_ms * args.steps * 1e3 / span
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        report["configs"][label] = dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=idle,
                                        groups_ms={k: v / 1e3 for k, v in by_group.items()},
                                        top_ms=[(n, us / 1e3) for n, us in top])
        print(f"[{label}] wall {wall_ms:.2f} ms per step (CUDA events, {args.steps} traced steps); "
              f"device busy {busy_ms:.2f} ms per step, idle share {100 * idle:.1f}% of the "
              f"traced span", flush=True)
        for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
            print(f"[{label}]   {g}: {us / 1e3:.2f} ms per step ({100 * us / 1e3 / busy_ms:.1f}% of "
                  f"busy)")
        for n, us in top:
            print(f"[{label}]     {us / 1e3:8.2f} ms  {n[:110]}")
        del state, step, prof
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
