"""FID between two image directories (e.g. generated outputs vs real target).

    python -m msig_tpu_torch.tools.evaluate_fid --dir_a OUT --dir_b REF/Domain \\
        [--image_size 256] [--batch_size 32] [--vgg_weights vgg19_prefix.npz] \\
        [--inception_weights inception_v3.npz] [--device cuda|cpu]

The flags of the root ``tools/evaluate_fid.py`` plus ``--device`` (default
``cuda``; a missing card raises and exits 1). Prints one JSON line: ``metric``,
``value``, ``dir_a``, ``dir_b``. Without ``--vgg_weights`` and
``--inception_weights`` the score is a PROXY FID on the port's seeded random
VGG: self-consistent across runs of the port, not comparable to published
InceptionV3 FID numbers, nor to the JAX package's proxy (``eval/fid.py``).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir_a", required=True)
    ap.add_argument("--dir_b", required=True)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--vgg_weights", type=str, default=None)
    ap.add_argument("--inception_weights", type=str, default=None,
                    help=".npz from tools/convert_inception_weights.py: canonical "
                         "InceptionV3-pool3 FID (takes precedence)")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from msig_tpu_torch.eval import fid_between_dirs

    # fp32 means fp32 on the card: cuDNN would run the convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    score = fid_between_dirs(args.dir_a, args.dir_b, args.image_size, args.batch_size,
                             args.vgg_weights, args.inception_weights, device=args.device)
    metric = ("fid_inception_pool3" if args.inception_weights
              else "fid_vgg_prefix" if args.vgg_weights
              else "proxy_fid_random_vgg")
    out = {"metric": metric, "value": round(score, 4), "dir_a": args.dir_a, "dir_b": args.dir_b}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
