#!/usr/bin/env python3
"""Golden step 1 of the JAX package's bf16 train step on its kernel routes.

    JAX_PLATFORMS=cpu python tools/train_bf16_kernels_golden.py

The configuration of ``tools/train_bf16_golden.py`` (the port's initial state
and seeded random VGG, 64², 2 resblocks, style_dim 16, 3 domains, batch 2:
its 16x16x256 trunk routes to the training kernels), with the JAX package's
fused step run once per route, its Pallas kernels in interpret mode on the
CPU:

  - ``level1+pallas``: ``MSIG_CONV_VJP=1`` with ``use_pallas`` (the trunk's
    convs through ``conv3x3_vjp.conv3x3_bwd``, the AdaINs through
    ``adain_pallas``);
  - ``level2``: ``MSIG_CONV_VJP=2`` (the conv + instance norm + modulation
    units through ``conv3x3_vjp.conv3x3_adain_bwd``).

Writes ``tests/golden/torch_port_train_bf16_kernels.npz``: each route's
arrays as ``train_bf16_golden.golden_arrays`` keeps them, every key prefixed
with ``<route>:``. ``tests/test_torch_port_train_bf16.py`` holds the port's
bf16 step on each route against its own golden. About two minutes here.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_train_bf16_kernels.npz")
ROUTES = {"level1+pallas": ("1", True), "level2": ("2", False)}  # route -> (MSIG_CONV_VJP, use_pallas)


def _base():
    spec = importlib.util.spec_from_file_location(
        "train_bf16_golden", os.path.join(ROOT, "tools", "train_bf16_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def route_arrays(golden: dict, route: str) -> dict:
    """One route's arrays of the golden file, without the prefix."""
    pre = f"{route}:"
    return {k[len(pre):]: v for k, v in golden.items() if k.startswith(pre)}


def main() -> int:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    tg = _base()
    arrays = {}
    for route, (level, use_pallas) in ROUTES.items():
        got = tg.golden_arrays(*tg.jax_step1(level, use_pallas))
        arrays.update({f"{route}:{k}": v for k, v in got.items()})
        print(f"{route}: G_loss {float(got['metric/G_loss']):.6f}", flush=True)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: {len(arrays)} arrays, {os.path.getsize(GOLDEN)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
