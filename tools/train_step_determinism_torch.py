#!/usr/bin/env python3
"""Which op makes the port's train step differ from run to run on the card, and what
cuDNN's deterministic algorithms cost.

    python3 tools/train_step_determinism_torch.py [--steps 5] [--out report.json]

1. Runs step 1 of ``msig_tpu_torch.train.make_train_step`` (256², batch 4, 8
   resblocks, style_dim 256, 10 domains, a seeded random VGG; fp32, TF32 off;
   stock autograd) twice from the same parameters and batch, with a forward
   hook on every module of the six networks and of the VGG that records a
   fingerprint of the module's inputs and outputs (the sum of their bit
   patterns as int64) in call order. It prints the number of module calls
   whose outputs differ between the two runs and the first of them, with
   whether its inputs were equal (then the module's own op is the source),
   under cuDNN's default algorithms and under ``cudnn.deterministic = True``.
2. Times the step both ways in each of the three configurations of
   ``chip_smoke.py`` (stock autograd, ``MSIG_CONV_VJP=1`` with ``use_pallas``,
   ``MSIG_CONV_VJP=2``): median of ``--steps`` steps after a warm-up step, by
   CUDA events, in the order default, deterministic, deterministic, default;
   each way's figure is the mean of its two medians.

Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = (("stock", "0", False), ("level1+pallas", "1", True), ("level2", "2", False))


def fingerprint(torch, obj):
    """Sum of the bit patterns of every floating tensor in ``obj``, on the card."""
    if isinstance(obj, torch.Tensor):
        if not obj.is_floating_point():
            return obj.detach().to(torch.int64).sum()
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[obj.element_size()]
        return obj.detach().contiguous().view(bits).to(torch.int64).sum()
    if isinstance(obj, (tuple, list)):
        parts = [fingerprint(torch, o) for o in obj]
        parts = [p for p in parts if p is not None]
        return torch.stack(parts).sum() if parts else None
    return None


def main() -> int:
    import numpy as np
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--out", default=None, help="also write the report as JSON here")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("train_step_determinism_torch: no CUDA device", file=sys.stderr)
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
    report = {"card": card, "hooks": {}, "step_ms": {}}

    def config(label):
        level, pallas = {c[0]: c[1:] for c in CONFIGS}[label]
        os.environ["MSIG_CONV_VJP"] = level
        return TrainConfig(image_size=256, batch_size=4, n_residual_blocks=8, style_dim=256,
                           use_pallas=pallas, device="cuda")

    def traced_step1():
        """Step 1 from fresh parameters: [(module name, input fp, output fp)] in call order."""
        cfg = config("stock")
        state = create_train_state(cfg, 10)
        step = make_train_step(cfg.ema_beta)
        calls, handles = [], []
        mods = [(f"{k}.", net) for k, net in state.models.nets.items()] + [("vgg.", vgg)]
        for prefix, net in mods:
            for name, mod in net.named_modules():
                handles.append(mod.register_forward_hook(
                    lambda m, i, o, n=prefix + (name or type(mod).__name__): calls.append(
                        (n, type(m).__name__, fingerprint(torch, i), fingerprint(torch, o)))))
        try:
            step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
            torch.cuda.synchronize()
        finally:
            for h in handles:
                h.remove()
        del state, step
        torch.cuda.empty_cache()
        return [(n, t, None if i is None else int(i), None if o is None else int(o))
                for n, t, i, o in calls]

    for mode in ("default", "deterministic"):
        torch.backends.cudnn.deterministic = mode == "deterministic"
        a, b = traced_step1(), traced_step1()
        if [c[:2] for c in a] != [c[:2] for c in b]:
            print(f"[hooks {mode}] the two runs call different modules", flush=True)
            return 1
        differ = [k for k, (x, y) in enumerate(zip(a, b)) if x[3] != y[3]]
        first = None
        for k in differ:
            if a[k][2] == b[k][2]:
                first = k
                break
        row = dict(calls=len(a), outputs_differ=len(differ))
        if differ:
            row.update(first_differing=f"{a[differ[0]][0]} ({a[differ[0]][1]}), call {differ[0]}",
                       first_with_equal_inputs=None if first is None else
                       f"{a[first][0]} ({a[first][1]}), call {first}")
        report["hooks"][mode] = row
        print(f"[hooks {mode}] step 1 twice from the same parameters and batch: {len(a)} module "
              f"calls, {len(differ)} with differing outputs"
              + (f"; first {row['first_differing']}; first whose inputs were equal "
                 f"{row['first_with_equal_inputs']}" if differ else ""), flush=True)
    torch.backends.cudnn.deterministic = False

    for label, _, _ in CONFIGS:
        cfg = config(label)
        ms = {"default": [], "deterministic": []}
        for mode in ("default", "deterministic", "deterministic", "default"):
            torch.backends.cudnn.deterministic = mode == "deterministic"
            state = create_train_state(cfg, 10)
            step = make_train_step(cfg.ema_beta)
            step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)  # warm-up
            events = []
            for _ in range(args.steps):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
                e.record()
                events.append((s, e))
            torch.cuda.synchronize()
            ms[mode].append(float(np.median([s.elapsed_time(e) for s, e in events])))
            del state, step
            torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = False
        d, t = (float(np.mean(ms[k])) for k in ("default", "deterministic"))
        report["step_ms"][label] = dict(ms, cost=t / d - 1.0)
        print(f"[time {label}] ms per step, median of {args.steps} after a warm-up step (CUDA "
              f"events): default {ms['default']}, deterministic {ms['deterministic']}; "
              f"deterministic costs {100 * (t / d - 1.0):+.2f}%", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
