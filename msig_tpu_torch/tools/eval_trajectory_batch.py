"""Single-process quality trajectory over EMA snapshots.

    python -m msig_tpu_torch.tools.eval_trajectory_batch --snap_root DIR --out DIR \\
        [--n_images 50] [--source_dir DIR] [--ref_dir DIR] [--batch_size 32] \\
        [--device cuda|cpu]

The port's counterpart of the root ``tools/eval_trajectory_batch.py``, with
its flags and defaults plus ``--device`` (default ``cuda``; a missing card
exits 1). One engine for every snapshot (``epoch_N/ema_g_se_fp16.npz``; each
swaps the engine's weights, no process a checkpoint), the source-vs-reference
baselines computed once a domain, and per snapshot and domain the images
written under ``<out>/epoch_N/generated/<domain>/`` and scored from there as
``eval_quality`` scores them. Writes a ``quality.json`` an epoch (an existing
one is read back, not recomputed) and ``trajectory.csv`` / ``trajectory.png``
(``tools/_quality.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from msig_tpu_torch.tools import _quality as q


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--snap_root", default="results/tomato_r6/ema_snapshots")
    ap.add_argument("--out", default="docs/quality_r6/trajectory")
    ap.add_argument("--n_images", type=int, default=50)
    ap.add_argument("--source_dir", default=q.SOURCE_DIR)
    ap.add_argument("--ref_dir", default=q.REF_DIR)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from PIL import Image

    from msig_tpu_torch.data import list_image_files
    from msig_tpu_torch.eval.fid import fid_between_dirs
    from msig_tpu_torch.eval.pixel_stats import pixel_metrics_between_dirs

    q.device_or_exit(args.device)
    snaps = q.snapshots(args.snap_root)
    if not snaps:
        sys.exit(f"no snapshots under {args.snap_root}")
    print(f"evaluating {len(snaps)} snapshots: {[e for e, _ in snaps]}", flush=True)

    domains = q.list_domains(args.ref_dir)
    num_domains = len(domains) + 1
    src_files = list_image_files(args.source_dir)[: args.n_images]
    src_imgs = q.load_images(src_files)
    src_names = [os.path.basename(p) for p in src_files]
    ref_imgs = {name: q.load_images(list_image_files(os.path.join(args.ref_dir, name)))
                for name in domains}

    # the checkpoint-independent baselines, once a domain
    base = {}
    for name in domains:
        ref_d = os.path.join(args.ref_dir, name)
        fid_src = fid_between_dirs(args.source_dir, ref_d, image_size=q.IMAGE_SIZE,
                                   device=args.device)
        cf_src, tv_src = pixel_metrics_between_dirs(args.source_dir, ref_d, q.IMAGE_SIZE)
        base[name] = (float(fid_src), float(cf_src), float(tv_src))
        print(f"baseline {name}: proxy-FID {fid_src:.6f}", flush=True)

    cfg = q.inference_config(args.batch_size, args.device)
    os.makedirs(args.out, exist_ok=True)
    rows = {}
    for _, epoch, dst, eng in q.snapshot_engines(snaps, cfg, num_domains, args.out, rows):
        report = {}
        for name in domains:
            ref_d = os.path.join(args.ref_dir, name)
            bank = eng.encode_styles(ref_imgs[name], domains.index(name) + 1)
            out_dir = os.path.join(dst, "generated", name)
            os.makedirs(out_dir, exist_ok=True)
            for u8, names in q.translate(eng, src_imgs, src_names, bank, args.batch_size):
                for img, nm in zip(u8, names):
                    Image.fromarray(img).save(os.path.join(out_dir, nm))
            fid_gen = fid_between_dirs(out_dir, ref_d, image_size=q.IMAGE_SIZE,
                                       device=args.device)
            cf_gen, tv_gen = pixel_metrics_between_dirs(out_dir, ref_d, q.IMAGE_SIZE)
            report[name] = q.quality_row(fid_gen, base[name][0], cf_gen, base[name][1], tv_gen,
                                         base[name][2])
        q.save_report(dst, epoch, report, rows)

    q.report_written(q.write_trajectory(args.out, rows), len(rows))
    return rows


if __name__ == "__main__":
    main()
