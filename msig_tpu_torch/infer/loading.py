"""Resolve inference weights into the port's state_dicts.

Counterpart of ``msig_tpu/infer/loading.py``, same priority order:

  1. an msig_tpu native checkpoint (``meta.json`` + Orbax ``state/``) cannot
     be read without JAX: raise, naming ``tools/export_torch_checkpoint.py``,
     which writes the reference format below;
  2. the portable demo export (``ema_g_se_fp16.npz`` + ``meta.json``), carried
     over with :mod:`msig_tpu_torch.compat.from_jax`;
  3. the reference torch format (``checkpoint.pth`` [+ ``ema_checkpoint.pth``]),
     read natively with ``torch.load``; EMA weights preferred
     (reference inference.py:46-72).

Returns (G_A2B state_dict, SE_B state_dict, meta, used_ema).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from msig_tpu_torch.compat.from_jax import (
    generator_state_dict,
    style_encoder_state_dict,
    unflatten,
)
from msig_tpu_torch.config import InferenceConfig

logger = logging.getLogger(__name__)

DEMO_NPZ = "ema_g_se_fp16.npz"
StateDict = Dict[str, torch.Tensor]


def load_inference_params(checkpoint_dir: str, cfg: InferenceConfig,
                          num_domains: int) -> Tuple[StateDict, StateDict, Dict[str, Any], bool]:
    if os.path.exists(os.path.join(checkpoint_dir, "meta.json")) and os.path.isdir(
            os.path.join(checkpoint_dir, "state")):
        raise ValueError(
            f"{checkpoint_dir} is an msig_tpu Orbax checkpoint, which needs JAX to read. "
            "Convert it first: python tools/export_torch_checkpoint.py writes the "
            "reference-format checkpoint.pth/ema_checkpoint.pth that this port loads")
    if os.path.exists(os.path.join(checkpoint_dir, DEMO_NPZ)):
        logger.info("Loading fp16 demo checkpoint (%s) from %s", DEMO_NPZ, checkpoint_dir)
        return _load_npz(checkpoint_dir, cfg, num_domains)
    if os.path.exists(os.path.join(checkpoint_dir, "checkpoint.pth")):
        logger.info("Loading reference torch checkpoint from %s", checkpoint_dir)
        return _load_torch(checkpoint_dir, cfg, num_domains)
    raise FileNotFoundError(
        f"No reference (checkpoint.pth) or demo ({DEMO_NPZ}) checkpoint in {checkpoint_dir}")


def _load_npz(checkpoint_dir: str, cfg: InferenceConfig, num_domains: int):
    """Demo layout: '/'-joined flat keys ('gen/params/...', 'se/params/...')."""
    with np.load(os.path.join(checkpoint_dir, DEMO_NPZ)) as flat:
        # fp16 is a storage format only; the weights are used as float32.
        trees = unflatten({k: flat[k].astype(np.float32) for k in flat.files})
    meta: Dict[str, Any] = {}
    meta_path = os.path.join(checkpoint_dir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    saved = meta.get("num_domains")
    if saved is not None and int(saved) != num_domains:
        raise ValueError(
            f"Demo checkpoint was trained with {saved} domains but the "
            f"reference directory implies {num_domains} "
            "(same num_domains guard as the native format)")
    n_res = int(meta.get("n_residual_blocks", cfg.n_residual_blocks))
    style_dim = int(meta.get("style_dim", cfg.style_dim))
    gen = generator_state_dict(trees["gen"], n_res)
    se = style_encoder_state_dict(trees["se"], num_domains, style_dim)
    return gen, se, meta, bool(meta.get("ema", True))


def _load_torch(checkpoint_dir: str, cfg: InferenceConfig, num_domains: int):
    meta = {
        "num_domains": num_domains,
        "style_dim": cfg.style_dim,
        "n_residual_blocks": cfg.n_residual_blocks,
    }
    ema_path = os.path.join(checkpoint_dir, "ema_checkpoint.pth")
    if os.path.exists(ema_path):
        ema = torch.load(ema_path, map_location="cpu", weights_only=True)
        return dict(ema["ema_G_A2B"]), dict(ema["ema_SE_B"]), meta, True
    ckpt = torch.load(os.path.join(checkpoint_dir, "checkpoint.pth"), map_location="cpu",
                      weights_only=True)
    return dict(ckpt["G_A2B"]), dict(ckpt["SE_B"]), meta, False
