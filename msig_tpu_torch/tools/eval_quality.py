"""Quality evaluation of a trained checkpoint.

    python -m msig_tpu_torch.tools.eval_quality --checkpoint CKPT [--source_dir DIR] \\
        [--ref_dir DIR] [--out docs/quality] [--n_images 100] [--domains 3] \\
        [--batch_size 32] [--samples 6] [--device cuda|cpu]

The port's counterpart of the root ``tools/eval_quality.py``, with its flags
and defaults plus ``--device`` (default ``cuda``; a missing card exits 1).
For each of the first ``--domains`` target domains (0 = all):

  1. translate the first ``--n_images`` source images with the checkpoint's
     (EMA) weights, through the float engine at 256², style mode
     ``average``, into ``<out>/generated/<domain>/``;
  2. proxy-FID (the port's seeded random VGG: a PROXY, self-consistent
     within the port), colour-Fréchet and hist-TV (weights-free,
     ``eval/pixel_stats.py``) of the generated and of the untranslated
     sources against the domain's references.

A working translation moves the generated set toward the references: both
metrics below the source baseline. Writes ``quality.json`` (the root tool's
keys) and a ``samples_<domain>.jpg`` strip (source | generated) a domain.
The checkpoint is a reference-format ``checkpoint.pth`` directory or a demo
export (``infer/loading.py``). ``--source_dir`` and ``--ref_dir`` default to
the reference's data layout (``data/src/Tomato_healthy``, ``data/ref``) under
the working directory.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from msig_tpu_torch.tools import _quality as q


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--source_dir", default=q.SOURCE_DIR)
    ap.add_argument("--ref_dir", default=q.REF_DIR)
    ap.add_argument("--out", default="docs/quality")
    ap.add_argument("--n_images", type=int, default=100)
    ap.add_argument("--domains", type=int, default=3,
                    help="number of target domains to evaluate (0 = all)")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--samples", type=int, default=6,
                    help="sample images copied into the report dir per domain")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from PIL import Image

    from msig_tpu_torch.data import list_image_files
    from msig_tpu_torch.eval.fid import fid_between_dirs
    from msig_tpu_torch.eval.pixel_stats import pixel_metrics_between_dirs
    from msig_tpu_torch.infer.loading import load_inference_params

    q.device_or_exit(args.device)
    domains = q.list_domains(args.ref_dir)
    eval_domains = domains if args.domains <= 0 else domains[: args.domains]
    num_domains = len(domains) + 1

    cfg = q.inference_config(args.batch_size, args.device, args.checkpoint)
    gen_sd, se_sd, meta, used_ema = load_inference_params(args.checkpoint, cfg, num_domains)
    print(f"loaded {'EMA' if used_ema else 'raw'} weights", flush=True)
    eng = q.build_engine(cfg, num_domains, gen_sd, se_sd, meta)

    src_files = list_image_files(args.source_dir)[: args.n_images]
    src_imgs = q.load_images(src_files)
    src_names = [os.path.basename(p) for p in src_files]

    os.makedirs(args.out, exist_ok=True)
    report = {}
    for name in eval_domains:
        d_idx = domains.index(name) + 1
        ref_d = os.path.join(args.ref_dir, name)
        bank = eng.encode_styles(q.load_images(list_image_files(ref_d)), d_idx)

        out_dir = os.path.join(args.out, "generated", name)
        os.makedirs(out_dir, exist_ok=True)
        n_done = 0
        for u8, names in q.translate(eng, src_imgs, src_names, bank, args.batch_size):
            for img, nm in zip(u8, names):
                Image.fromarray(img).save(os.path.join(out_dir, nm))
                n_done += 1
        print(f"{name}: generated {n_done} images", flush=True)

        fid_gen = fid_between_dirs(out_dir, ref_d, image_size=q.IMAGE_SIZE, device=args.device)
        fid_src = fid_between_dirs(args.source_dir, ref_d, image_size=q.IMAGE_SIZE,
                                   device=args.device)
        # weights-free second opinion: the proxy-FID scores with random VGG features
        cf_gen, tv_gen = pixel_metrics_between_dirs(out_dir, ref_d, q.IMAGE_SIZE)
        cf_src, tv_src = pixel_metrics_between_dirs(args.source_dir, ref_d, q.IMAGE_SIZE)
        report[name] = q.quality_row(fid_gen, fid_src, cf_gen, cf_src, tv_gen, tv_src)
        print(f"{name}: proxy-FID gen vs ref = {fid_gen:.6f}  "
              f"(source vs ref baseline = {fid_src:.6f})", flush=True)
        print(f"{name}: color-Frechet gen {cf_gen:.5f} vs src {cf_src:.5f}; "
              f"hist-TV gen {tv_gen:.4f} vs src {tv_src:.4f}", flush=True)

        if args.samples <= 0:
            continue
        k = min(args.samples, len(src_imgs))
        gen = [np.asarray(Image.open(os.path.join(out_dir, src_names[i]))) for i in range(k)]
        q.save_strip(src_imgs[:k], gen, os.path.join(args.out, f"samples_{name}.jpg"))

    with open(os.path.join(args.out, "quality.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
