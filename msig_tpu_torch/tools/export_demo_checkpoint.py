"""Export a portable fp16 demo checkpoint (EMA G_A2B + SE_B) from a full
training checkpoint.

    python -m msig_tpu_torch.tools.export_demo_checkpoint --checkpoint CKPT --out DIR \\
        [--note "..."] [--num_domains 10] [--style_dim N] [--n_residual_blocks N] \\
        [--image_size N] [--device cuda|cpu]

The port's counterpart of the root ``tools/export_demo_checkpoint.py``, with
its flags plus ``--device`` (default ``cuda``; a missing card is an error, as
in every entry point of the port; the conversion itself is host work). It
reads a reference-format ``checkpoint.pth`` directory (the port's trainer
writes one; EMA weights preferred) or a demo directory, through
``infer/loading.py``; an Orbax directory of the JAX package is refused with
the loader's message, which names ``tools/export_torch_checkpoint.py``. It
writes ``ema_g_se_fp16.npz`` (the flatten of ``train/checkpoint.py``'s EMA
snapshot, ``demo_npz_arrays``) and ``meta.json`` with the root tool's fields:
``ema``, ``num_domains``, ``epochs``, ``note`` and, where known,
``style_dim``, ``n_residual_blocks``, ``image_size``. The inference CLIs of
both packages load the export (``--checkpoint_dir DIR``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True,
                    help="full checkpoint dir (torch .pth; an Orbax state/ dir is refused)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--note", default="")
    ap.add_argument("--num_domains", type=int, default=10,
                    help="only needed for torch-format dirs (a demo meta.json carries it); "
                         "bundled dataset = 10")
    ap.add_argument("--style_dim", type=int, default=None)
    ap.add_argument("--n_residual_blocks", type=int, default=None)
    ap.add_argument("--image_size", type=int, default=None)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import numpy as np

    from msig_tpu_torch.config import InferenceConfig
    from msig_tpu_torch.infer.loading import DEMO_NPZ, load_inference_params
    from msig_tpu_torch.tools._quality import device_or_exit
    from msig_tpu_torch.train.checkpoint import demo_npz_arrays

    device_or_exit(args.device)
    overrides = {k: getattr(args, k) for k in ("style_dim", "n_residual_blocks", "image_size")
                 if getattr(args, k) is not None}
    cfg = InferenceConfig(**overrides, device=args.device)
    gen, se, meta, used_ema = load_inference_params(args.checkpoint, cfg,
                                                    num_domains=args.num_domains)
    num_domains = int(meta.get("num_domains", args.num_domains))
    n_res = int(meta.get("n_residual_blocks", cfg.n_residual_blocks))
    flat = demo_npz_arrays(gen, se, n_res, num_domains)
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, DEMO_NPZ), **flat)
    out_meta = {
        "ema": bool(used_ema),
        "num_domains": num_domains,
        "epochs": meta.get("epochs"),
        "note": args.note or ("float16 EMA G_A2B + SE_B export; loadable by inference.py "
                              "(--checkpoint_dir this dir)"),
    }
    for k in ("style_dim", "n_residual_blocks", "image_size"):
        v = meta.get(k, overrides.get(k))
        if v is not None:
            out_meta[k] = int(v)
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(out_meta, f, indent=2)
    size = os.path.getsize(os.path.join(args.out, DEMO_NPZ)) / 1e6
    print(f"exported {len(flat)} tensors ({size:.1f} MB, ema={used_ema}) -> {args.out}")
    return out_meta


if __name__ == "__main__":
    main()
