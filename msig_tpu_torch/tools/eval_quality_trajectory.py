"""Per-checkpoint quality trajectory: ``eval_quality`` over every epoch checkpoint.

    python -m msig_tpu_torch.tools.eval_quality_trajectory --ckpt_root DIR \\
        [--extra_root DIR] [--out DIR] [--n_images 50] [--source_dir DIR] \\
        [--ref_dir DIR] [--every 1] [--eval_timeout 1800] [--device cuda|cpu]

The port's counterpart of the root ``tools/eval_quality_trajectory.py``, with
its flags and defaults plus ``--device`` (default ``cuda``; a missing card
exits 1). Every ``epoch_N`` checkpoint under ``--ckpt_root`` and
``--extra_root`` (a second root, a resumed run's, skipped when absent; the
first root's checkpoint wins an epoch both hold), every ``--every``-th, is
scored by ``python -m msig_tpu_torch.tools.eval_quality`` in a process of
its own (all domains, no samples, ``--device`` passed on) into
``<out>/epoch_N/``, unless its ``quality.json`` is there; a run that fails or
outlasts ``--eval_timeout`` seconds is retried once, then left out. The
reports make ``trajectory.csv`` / ``trajectory.png`` (``tools/_quality.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from typing import Optional, Sequence

from msig_tpu_torch.tools import _quality as q

# the directory that holds the package, for the evaluation processes
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt_root", default="results/tomato_r2/checkpoints")
    ap.add_argument("--extra_root", default="results/tomato_r3/checkpoints",
                    help="second checkpoint root (the resumed run), skipped when absent")
    ap.add_argument("--out", default="docs/quality/trajectory")
    ap.add_argument("--n_images", type=int, default=50)
    ap.add_argument("--source_dir", default=q.SOURCE_DIR)
    ap.add_argument("--ref_dir", default=q.REF_DIR)
    ap.add_argument("--every", type=int, default=1, help="evaluate every Nth checkpoint")
    ap.add_argument("--eval_timeout", type=int, default=1800,
                    help="seconds per checkpoint eval before it is killed and retried once")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    q.device_or_exit(args.device)
    ckpts = []
    for root in (args.ckpt_root, args.extra_root):
        if not os.path.isdir(root):
            continue
        for d in os.listdir(root):
            m = re.fullmatch(r"epoch_(\d+)", d)
            if m:
                ckpts.append((int(m.group(1)), os.path.join(root, d)))
    ckpts = sorted({e: p for e, p in sorted(ckpts)}.items())
    ckpts = ckpts[:: args.every]
    if not ckpts:
        sys.exit(f"no epoch_* checkpoints under {args.ckpt_root}")
    print(f"evaluating {len(ckpts)} checkpoints: {[e for e, _ in ckpts]}", flush=True)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    os.makedirs(args.out, exist_ok=True)
    rows = {}
    for epoch, path in ckpts:
        dst = os.path.join(args.out, f"epoch_{epoch}")
        qj = os.path.join(dst, "quality.json")
        if not os.path.exists(qj):
            cmd = [sys.executable, "-m", "msig_tpu_torch.tools.eval_quality",
                   "--checkpoint", path, "--out", dst, "--source_dir", args.source_dir,
                   "--ref_dir", args.ref_dir, "--n_images", str(args.n_images),
                   "--domains", "0", "--samples", "0", "--device", args.device]
            rc = None
            for attempt in (1, 2):
                try:
                    rc = subprocess.call(cmd, timeout=args.eval_timeout, env=env)
                except subprocess.TimeoutExpired:
                    print(f"epoch {epoch}: eval timed out after {args.eval_timeout}s "
                          f"(attempt {attempt})", flush=True)
                    rc = None
                    continue
                if rc == 0:
                    break
                print(f"epoch {epoch}: eval failed rc={rc} (attempt {attempt})", flush=True)
            if rc != 0:
                continue
        with open(qj) as f:
            rows[epoch] = json.load(f)
        print(f"epoch {epoch}: done", flush=True)

    if not rows:
        sys.exit("no successful evaluations")
    q.report_written(q.write_trajectory(args.out, rows), len(rows))
    return rows


if __name__ == "__main__":
    main()
