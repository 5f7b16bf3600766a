#!/usr/bin/env python3
"""Run ``python -m msig_tpu_torch.bench`` in each of its modes at its defaults, one after another.

    python3 tools/bench_all_torch.py [--runs inference inference512 latency train train_vjp1
                                             train_vjp2 data e2e] [--out_dir DIR]

One process per run, alone on the card: ``inference`` (256², batches 128 and
256, int8 then bf16), ``inference512`` (``--image_size 512``: 16 and 32),
``latency`` (int8, batches 1, 4, 16), ``train`` (bf16 step, batch 32, 256²;
``train_vjp1`` and ``train_vjp2`` the same under ``MSIG_CONV_VJP=1`` and
``=2``, the trunk on the training kernels), ``data`` (host pipeline) and
``e2e`` (JPEG -> int8 engine -> host); by default all but the two kernel
routes of the train mode. Prints
the card's name and power limit, then per run its exit code, wall time, JSON
line and the bench's per-config lines from stderr; writes each run's stdout
and stderr to ``DIR/<run>.{out,err}`` (default ``build/bench_logs``). Needs a
card: the bench exits 1 without one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {
    "inference": ["--mode", "inference"],
    "inference512": ["--mode", "inference", "--image_size", "512"],
    "latency": ["--mode", "latency"],
    "train": ["--mode", "train"],
    "train_vjp1": ["--mode", "train"],
    "train_vjp2": ["--mode", "train"],
    "data": ["--mode", "data"],
    "e2e": ["--mode", "e2e"],
}
ENV = {"train_vjp1": {"MSIG_CONV_VJP": "1"}, "train_vjp2": {"MSIG_CONV_VJP": "2"}}
DEFAULT = [r for r in RUNS if r not in ENV]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", nargs="+", choices=list(RUNS), default=DEFAULT)
    ap.add_argument("--out_dir", default=os.path.join(ROOT, "build", "bench_logs"))
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(f"[card] {card.stdout.strip() or card.stderr.strip()}", flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    failed = []
    for name in args.runs:
        cmd = [sys.executable, "-m", "msig_tpu_torch.bench", *RUNS[name]]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, env=dict(env, **ENV.get(name, {})), capture_output=True,
                           text=True, timeout=1800)
        wall = time.perf_counter() - t0
        for ext, text in (("out", r.stdout), ("err", r.stderr)):
            with open(os.path.join(args.out_dir, f"{name}.{ext}"), "w") as f:
                f.write(text)
        detail = [ln.strip() for ln in r.stderr.splitlines() if ln.startswith("  ")]
        setting = "".join(f"{k}={v} " for k, v in ENV.get(name, {}).items())
        print(f"[bench {name}] {setting}{' '.join(cmd[1:])}: rc {r.returncode}, {wall:.1f} s; "
              f"{r.stdout.strip()}", flush=True)
        for ln in detail:
            print(f"[bench {name}]   {ln}", flush=True)
        if r.returncode != 0:
            failed.append(name)
            print(f"[bench {name}] stderr tail: {r.stderr[-1500:]}", flush=True)
    print(f"[card] {card.stdout.strip()}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
