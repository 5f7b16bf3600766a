#!/usr/bin/env python3
"""Golden wandb log calls of the JAX package's trainer, for the port's parity test.

    JAX_PLATFORMS=cpu python tools/wandb_logs_golden.py

Runs ``msig_tpu.train.trainer.Trainer.train`` on a seeded tree (``make_tree``:
four 36x36 sources, two target domains) at ``config()`` (32², batch 2, one
resblock, style_dim 16, two epochs of two steps, ``watch_freq`` 2) with a stub
wandb run, and writes ``tests/golden/torch_port_wandb.json``: each ``log()``
call in order as its keys without the gradient histograms and its number of
histograms. ``tests/test_torch_port_wandb.py`` holds the port's trainer
against it; its ``-m slow`` test runs :func:`jax_logs` live (two compilations
of the train step, a few minutes here; the golden none).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_wandb.json")
SIZE, BATCH, SDIM, N_RES, EPOCHS, WATCH_FREQ = 32, 2, 16, 1, 2, 2
N_SRC, DOMAINS = 4, ("A", "B")


def make_tree(root: str) -> None:
    """``root/src/S`` and ``root/ref/{A,B}``: seeded uint8 PNGs of 36x36."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for d, n in [("src/S", N_SRC)] + [(f"ref/{name}", 2) for name in DOMAINS]:
        os.makedirs(os.path.join(root, d), exist_ok=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (36, 36, 3), dtype=np.uint8)).save(
                os.path.join(root, d, f"{i}.png"))


def config(root: str) -> dict:
    """The TrainConfig fields both packages' trainers take here."""
    return dict(source_dir=os.path.join(root, "src", "S"), target_dir=os.path.join(root, "ref"),
                save_dir_base=os.path.join(root, "out"), exp_name="w", epochs=EPOCHS,
                image_size=SIZE, batch_size=BATCH, style_dim=SDIM, n_residual_blocks=N_RES,
                watch_freq=WATCH_FREQ, checkpoint_every=EPOCHS, wandb=True, data_parallel=False)


def summary(logs) -> list:
    """Each log call as (its keys but the histograms', sorted; its histograms)."""
    out = []
    for d in logs:
        hists = [k for k in d if k.startswith("gradients/")]
        out.append({"keys": sorted(k for k in d if k not in hists), "histograms": len(hists)})
    return out


class StubRun:
    def __init__(self):
        self.logs = []

    def log(self, d):
        self.logs.append(dict(d))


def stub_wandb_module() -> types.ModuleType:
    mod = types.ModuleType("wandb")

    class Histogram:
        def __init__(self, np_histogram=None, **kwargs):
            self.counts, self.edges = np_histogram

    mod.Histogram = Histogram
    return mod


def jax_logs(root: str) -> list:
    """The JAX trainer's log calls on ``make_tree(root)``, summarised."""
    from msig_tpu.config import TrainConfig
    from msig_tpu.data import MultiDomainDataset
    from msig_tpu.train.trainer import Trainer

    saved, art = sys.modules.get("wandb"), os.environ.get("MSIG_SKIP_EPOCH_ART")
    sys.modules["wandb"] = stub_wandb_module()
    os.environ["MSIG_SKIP_EPOCH_ART"] = "1"
    try:
        cfg = TrainConfig(**{k: v for k, v in config(root).items() if k != "wandb"},
                          allow_random_vgg=True)
        run = StubRun()
        Trainer(cfg, MultiDomainDataset.build(cfg.source_dir, cfg.target_dir),
                wandb_run=run).train()
    finally:
        if saved is None:
            sys.modules.pop("wandb", None)
        else:
            sys.modules["wandb"] = saved
        if art is None:
            os.environ.pop("MSIG_SKIP_EPOCH_ART")
        else:
            os.environ["MSIG_SKIP_EPOCH_ART"] = art
    return summary(run.logs)


def main() -> None:
    import msig_tpu

    msig_tpu.honor_jax_platforms_env()
    with tempfile.TemporaryDirectory() as root:
        make_tree(root)
        logs = jax_logs(root)
    with open(GOLDEN, "w") as f:
        json.dump({"logs": logs}, f, indent=1)
    print(f"wrote {GOLDEN}: {len(logs)} log calls")


if __name__ == "__main__":
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    main()
