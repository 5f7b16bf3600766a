#!/usr/bin/env python3
"""Golden outputs of the JAX package's quality tools, for the port's parity test.

    JAX_PLATFORMS=cpu python tools/quality_tools_golden.py

On a seeded tree (``make_tree``: two 64x72 sources, two target domains of
three references each) and two seeded EMA snapshots (``make_snapshot``: one
resblock, style_dim 16, the port's G_A2B and SE_B at torch's default init,
written as the demo npz), runs the root tools in this process:
``tools/eval_quality.py`` on snapshot 2 (all domains, bf16 as it runs) and
``tools/eval_trajectory_fast.py`` / ``tools/eval_trajectory_batch.py`` over
both, and JAX's float32 engine on the sources in style mode ``average`` at
``FP32_SIZE``; writes ``tests/golden/torch_port_quality_tools.npz``: the
eval tool's generated images and ``quality.json``, the two runners'
``trajectory.csv`` and the fp32 engine's uint8 images.
``tests/test_torch_port_quality_tools.py`` holds the port's tools against it;
its ``-m slow`` test runs :func:`jax_outputs` live (about 40 s of compilation
here, the golden none).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_quality_tools.npz")
SDIM, N_RES, DOMAINS, N_SRC, N_REF = 16, 1, ("A", "B"), 2, 3
ND = len(DOMAINS) + 1
FP32_SIZE = 64  # the fp32 engine check: a small map, cheap to compile
EVAL_ARGS = ("--n_images", str(N_SRC), "--batch_size", "2")


def make_tree(root: str) -> None:
    """``root/src/S`` and ``root/ref/{A,B}``: seeded uint8 PNGs of 64x72."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for d, n in [("src/S", N_SRC)] + [(f"ref/{name}", N_REF) for name in DOMAINS]:
        os.makedirs(os.path.join(root, d), exist_ok=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (64, 72, 3), dtype=np.uint8)).save(
                os.path.join(root, d, f"{i}.png"))


def make_snapshot(path: str, seed: int, epochs: int = 1) -> None:
    """An EMA snapshot (demo npz + meta.json) of a seeded G_A2B and SE_B."""
    import torch

    from msig_tpu_torch.models import MultiDomainStyleEncoder, StyleCycleGANGenerator
    from msig_tpu_torch.train.checkpoint import demo_npz_arrays
    from msig_tpu_torch.train.state import torch_default_init_

    gen = StyleCycleGANGenerator(style_dim=SDIM, n_residual_blocks=N_RES)
    se = MultiDomainStyleEncoder(style_dim=SDIM, num_domains=ND)
    torch_default_init_(gen, torch.Generator().manual_seed(seed))
    torch_default_init_(se, torch.Generator().manual_seed(seed + 1000))
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "ema_g_se_fp16.npz"),
             **demo_npz_arrays(gen.state_dict(), se.state_dict(), N_RES, ND))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"ema": True, "num_domains": ND, "note": "seeded snapshot", "epochs": epochs,
                   "style_dim": SDIM, "n_residual_blocks": N_RES, "image_size": 256}, f)


def make_inputs(root: str) -> None:
    """The tree and ``root/snaps/epoch_{1,2}``."""
    make_tree(root)
    for epoch in (1, 2):
        make_snapshot(os.path.join(root, "snaps", f"epoch_{epoch}"), seed=epoch, epochs=epoch)


def _root_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(mod, argv) -> None:
    saved = sys.argv
    sys.argv = [mod.__file__, *argv]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main()
    finally:
        sys.argv = saved


def load_u8_dir(d: str) -> np.ndarray:
    from PIL import Image

    return np.stack([np.asarray(Image.open(os.path.join(d, f))) for f in sorted(os.listdir(d))])


def jax_fp32_images(root: str, size: int = FP32_SIZE) -> np.ndarray:
    """JAX's float32 engine on the sources at ``size``, style mode
    ``average`` over domain A's references, to uint8 as the tools do."""
    from msig_tpu.config import InferenceConfig
    from msig_tpu.data import list_image_files
    from msig_tpu.data.pipeline import load_inference_image
    from msig_tpu.infer.engine import InferenceEngine
    from msig_tpu.infer.loading import load_inference_params

    snap = os.path.join(root, "snaps", "epoch_2")
    cfg = InferenceConfig(image_size=size, batch_size=N_SRC, compute_dtype="float32")
    gen, se, meta, _ = load_inference_params(snap, cfg, ND)
    eng = InferenceEngine.build(cfg, ND, gen, se, n_residual_blocks=N_RES, style_dim=SDIM)
    load = lambda d: np.stack([load_inference_image(p, size)  # noqa: E731
                               for p in list_image_files(os.path.join(root, d))])
    bank = eng.encode_styles(load("ref/A"), 1)
    (out, _), = eng.translate_batches(iter([(load("src/S"), ["0", "1"])]), bank, "average")
    return np.clip((np.asarray(out, np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def jax_outputs(root: str) -> dict:
    """The root tools' outputs on ``make_inputs(root)``'s tree and snapshots."""
    os.environ["JAX_COMPILATION_CACHE_DIR"] = os.path.join(root, "jax_cache")
    common = ["--source_dir", os.path.join(root, "src", "S"),
              "--ref_dir", os.path.join(root, "ref"), *EVAL_ARGS]
    q = os.path.join(root, "jax_quality")
    _run(_root_tool("eval_quality"), ["--checkpoint", os.path.join(root, "snaps", "epoch_2"),
                                      "--out", q, "--domains", "0", "--samples", "0", *common])
    out = {"quality_json": open(os.path.join(q, "quality.json")).read()}
    for name in DOMAINS:
        out[f"generated_{name}"] = load_u8_dir(os.path.join(q, "generated", name))[:1]
    for tool in ("eval_trajectory_fast", "eval_trajectory_batch"):
        t = os.path.join(root, f"jax_{tool}")
        _run(_root_tool(tool), ["--snap_root", os.path.join(root, "snaps"), "--out", t, *common])
        out[f"{tool}_csv"] = open(os.path.join(t, "trajectory.csv")).read()
    out["fp32_A"] = jax_fp32_images(root)
    return out


def main() -> None:
    import msig_tpu

    msig_tpu.honor_jax_platforms_env()
    with tempfile.TemporaryDirectory() as root:
        make_inputs(root)
        out = jax_outputs(root)
    np.savez_compressed(GOLDEN, **{k: np.asarray(v) for k, v in out.items()})
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes): {sorted(out)}")


if __name__ == "__main__":
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    main()
