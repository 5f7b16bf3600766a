#!/usr/bin/env python3
"""sha256 of the images that the port's int8 CLI serves, to hold two trees' outputs equal.

    python3 tools/served_digest_torch.py

Runs ``python -m msig_tpu_torch.inference --quantize int8 --device cuda`` on
the committed demo checkpoint over the 20 seeded inputs and 9 reference
folders that ``chip_smoke.py`` writes (``write_inputs``), batch 8,
``--style_mode average``, at 256² with ``MSIG_TRUNK_HIFI`` 0, 1 and 2 and at
512² with ``MSIG_STAGE_FP16`` 0 and 1 and ``MSIG_TRUNK_HIFI`` 1 and 2 (int32
staging), and prints for each a sha256 over the served images (file name,
then pixels, by file name), the digest ``chip_smoke.py`` prints for its
paths. Then the float output (``256/float``):
the int8 engine with ``out_uint8`` off (its decoder's ConvT site twice, then
the unfused final conv) on two seeded batches of 8 at 256², a sha256 over the
float32 outputs' bytes; and the same for the fp32 float generator
(``256/fp32``, ``--quantize`` off: its reflect-padded 7x7 convs; TF32 off,
as the CLI runs before it set), under cuDNN's default algorithms, as the CLI
serves (whose ``ConvTranspose2d`` may vary in its last bits from run to run),
and under its deterministic ones. It uses the package and ``chip_smoke.py`` beside it,
so that copied into another checkout it digests that checkout's outputs.
Needs a card; exits 1 without one.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = (("256/hifi0", 256, "0", "0"), ("256/hifi1", 256, "1", "0"),
         ("256/hifi2", 256, "2", "0"), ("512", 512, "0", "0"), ("512/fp16", 512, "0", "1"),
         ("512/hifi1", 512, "1", "0"), ("512/hifi2", 512, "2", "0"))


def float_digest(torch, cs, np, quantize="int8") -> str:
    """sha256 of the engine's float32 outputs at 256² (demo checkpoint, two seeded
    batches of 8 images and styles): the int8 engine's, or with ``quantize=None``
    the fp32 float generator's."""
    from msig_tpu_torch.config import InferenceConfig
    from msig_tpu_torch.infer.engine import InferenceEngine
    from msig_tpu_torch.infer.loading import load_inference_params

    cfg = InferenceConfig(image_size=256, batch_size=cs.B, device="cuda",
                          compute_dtype="float32", quantize=quantize)
    gen_sd, se_sd, meta, _ = load_inference_params(cs.DEMO, cfg, 10)
    eng = InferenceEngine.build(cfg, 10, gen_sd, se_sd, meta["n_residual_blocks"],
                                meta["style_dim"])
    eng.out_uint8 = False
    rng = np.random.default_rng(6)
    digest = hashlib.sha256()
    for _ in range(2):
        imgs = torch.from_numpy(rng.integers(0, 256, (cs.B, 256, 256, 3), dtype=np.uint8)).cuda()
        styles = torch.from_numpy(rng.normal(size=(cs.B, meta["style_dim"])).astype(np.float32))
        out = eng.generate(imgs, styles.cuda())
        if out.dtype != torch.float32:
            raise RuntimeError(f"[256/float] the engine returned {out.dtype}, not float32")
        digest.update(out.cpu().numpy().tobytes())
    return digest.hexdigest()


def main() -> int:
    import numpy as np
    import torch
    from PIL import Image

    if not torch.cuda.is_available():
        print("no CUDA device: the int8 CLI serves on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from msig_tpu_torch import inference as cli

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="served_digest_", dir=os.path.join(ROOT, "build"))
    try:
        inp, ref = cs.write_inputs(work)
        for path, size, hifi, fp16 in PATHS:
            out = os.path.join(work, "out_" + path.replace("/", "_"))
            args = cli.build_arg_parser().parse_args([
                "--input_dir", inp, "--ref_domains_dir", ref, "--checkpoint_dir", cs.DEMO,
                "--output_dir", out, "--target_domain", cs.TARGET, "--style_mode", "average",
                "--quantize", "int8", "--image_size", str(size), "--batch_size", str(cs.B),
                "--compute_dtype", "float32", "--device", "cuda"])
            with cs.env(MSIG_TRUNK_HIFI=hifi, MSIG_STAGE_FP16=fp16):
                rc = cli.main(cli.config_from_args(args))
            if rc != 0:
                raise RuntimeError(f"[{path}] inference main exit code {rc}")
            digest = hashlib.sha256()
            names = sorted(os.listdir(out))
            for name in names:
                with Image.open(os.path.join(out, name)) as im:
                    digest.update(name.encode())
                    digest.update(np.asarray(im).tobytes())
            print(f"[digest {path}] served images sha256 {digest.hexdigest()} ({len(names)} "
                  f"images)", flush=True)
        print(f"[digest 256/float] float32 outputs sha256 {float_digest(torch, cs, np)} "
              f"(2 batches of {cs.B})", flush=True)
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            print(f"[digest 256/fp32] the fp32 float generator's outputs sha256 "
                  f"{float_digest(torch, cs, np, None)} (2 batches of {cs.B}; cuDNN's "
                  f"{'deterministic' if deterministic else 'default'} algorithms)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
