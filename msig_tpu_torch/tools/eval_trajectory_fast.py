"""In-memory quality trajectory over EMA snapshots.

    python -m msig_tpu_torch.tools.eval_trajectory_fast --snap_root DIR --out DIR \\
        [--n_images 50] [--source_dir DIR] [--ref_dir DIR] [--batch_size 32] \\
        [--samples 3] [--device cuda|cpu]

The port's counterpart of the root ``tools/eval_trajectory_fast.py``, with its
flags and defaults plus ``--device`` (default ``cuda``; a missing card exits
1). The fastest evaluator of the family: one engine and one feature extractor
for every snapshot (``epoch_N/ema_g_se_fp16.npz``, as the trainer's
``--ema_snapshot_every`` writes them; each swaps the engine's weights), the
metrics computed from the generated arrays in memory (no image files), and
every quantity that does not depend on the checkpoint (the references'
feature and descriptor statistics and histograms, the source-vs-reference
baselines over every source image) computed once. Writes a ``quality.json``
an epoch (``<out>/epoch_N/``; an existing one is read back, not recomputed),
source | generated strips of the last snapshot (``--samples`` a domain), and
``trajectory.csv`` / ``trajectory.png`` (``tools/_quality.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np

from msig_tpu_torch.tools import _quality as q


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--snap_root", default="results/tomato_r6/ema_snapshots")
    ap.add_argument("--out", default="docs/quality_r6/trajectory")
    ap.add_argument("--n_images", type=int, default=50)
    ap.add_argument("--source_dir", default=q.SOURCE_DIR)
    ap.add_argument("--ref_dir", default=q.REF_DIR)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--samples", type=int, default=3,
                    help="sample source|generated strips saved for the LAST checkpoint per "
                         "domain (0 = none)")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from msig_tpu_torch.data import list_image_files
    from msig_tpu_torch.eval.fid import activation_statistics, frechet_distance, vgg_feature_fn
    from msig_tpu_torch.eval.pixel_stats import _pooled_hist, color_texture_descriptor
    from msig_tpu_torch.losses import get_vgg

    q.device_or_exit(args.device)
    snaps = q.snapshots(args.snap_root)
    if not snaps:
        sys.exit(f"no snapshots under {args.snap_root}")
    print(f"evaluating {len(snaps)} snapshots: {[e for e, _ in snaps]}", flush=True)

    domains = q.list_domains(args.ref_dir)
    num_domains = len(domains) + 1
    feature_fn = vgg_feature_fn(get_vgg(None, device=args.device))

    def feats(imgs_u8):
        return np.concatenate([feature_fn(imgs_u8[i: i + args.batch_size])
                               for i in range(0, len(imgs_u8), args.batch_size)], axis=0)

    def fid_from_stats(imgs_u8, ref_stats):
        return frechet_distance(*activation_statistics(feats(imgs_u8)), *ref_stats)

    def cf_from_stats(imgs_u8, ref_stats):
        d = np.stack([color_texture_descriptor(i) for i in imgs_u8])
        return frechet_distance(*activation_statistics(d), *ref_stats)

    def tv_from_hist(imgs_u8, ref_hist):
        return float(0.5 * np.abs(_pooled_hist(imgs_u8) - ref_hist).sum())

    # what does not depend on the checkpoint, once
    src_all = q.load_images(list_image_files(args.source_dir))
    src_eval = src_all[: args.n_images]
    print(f"loaded {len(src_all)} source images", flush=True)
    ref = {}
    for name in domains:
        imgs = q.load_images(list_image_files(os.path.join(args.ref_dir, name)))
        fid_stats = activation_statistics(feats(imgs))
        cf_stats = activation_statistics(np.stack([color_texture_descriptor(i) for i in imgs]))
        hist = _pooled_hist(imgs)
        base = (float(fid_from_stats(src_all, fid_stats)),
                float(cf_from_stats(src_all, cf_stats)), float(tv_from_hist(src_all, hist)))
        ref[name] = (imgs, fid_stats, cf_stats, hist, base)
        print(f"baseline {name}: proxy-FID {base[0]:.6f}", flush=True)

    cfg = q.inference_config(args.batch_size, args.device)
    os.makedirs(args.out, exist_ok=True)
    rows = {}
    names = [str(j) for j in range(len(src_eval))]
    for k, epoch, dst, eng in q.snapshot_engines(snaps, cfg, num_domains, args.out, rows):
        report = {}
        last = k == len(snaps) - 1
        for name in domains:
            ref_imgs, fid_stats, cf_stats, hist, base = ref[name]
            bank = eng.encode_styles(ref_imgs, domains.index(name) + 1)
            gen_imgs = np.concatenate(
                [u8 for u8, _ in q.translate(eng, src_eval, names, bank, args.batch_size)], axis=0)
            report[name] = q.quality_row(fid_from_stats(gen_imgs, fid_stats), base[0],
                                         cf_from_stats(gen_imgs, cf_stats), base[1],
                                         tv_from_hist(gen_imgs, hist), base[2])
            if last and args.samples > 0:
                n = min(args.samples, len(gen_imgs))
                q.save_strip(src_eval[:n], gen_imgs[:n], os.path.join(dst, f"samples_{name}.jpg"))
        q.save_report(dst, epoch, report, rows)

    q.report_written(q.write_trajectory(args.out, rows), len(rows))
    return rows


if __name__ == "__main__":
    main()
