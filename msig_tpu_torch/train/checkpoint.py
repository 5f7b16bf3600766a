"""Checkpoints in the reference format, and the portable fp16 EMA snapshot.

The JAX package saves Orbax trees, which cannot be read without JAX. The port
writes what the reference writes (reference trainer.py:157-173) and what
``msig_tpu/compat/torch_export.py::save_torch_checkpoint_dir`` writes, so the
reference, the JAX package (``msig_tpu.compat.torch_import``) and the port's
inference loader (``msig_tpu_torch/infer/loading.py``) all read it:

  - ``checkpoint.pth``: the six state_dicts (``G_A2B``, ``G_B2A``, ``SE_A``,
    ``SE_B``, ``D_A``, ``D_B``) under the reference's module names, the two
    optimizers as ``torch.optim.Adam`` state_dicts carrying the Adam moments
    (parameters numbered in the reference's order: G_A2B, G_B2A, SE_A, SE_B;
    then D_A, D_B), the two ``CosineAnnealingLR`` state_dicts,
    ``loss_history`` and ``num_domains``;
  - ``ema_checkpoint.pth``: ``ema_G_A2B``, ``ema_G_B2A``, ``ema_SE_A``, ``ema_SE_B``.

Resuming from a checkpoint is not ported yet (Queue 1 item 8; ``--resume`` raises).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List

import numpy as np
import torch

from msig_tpu_torch.compat.from_jax import generator_params, style_encoder_params
from msig_tpu_torch.train.state import D_KEYS, G_KEYS, AdamState, TrainState

logger = logging.getLogger(__name__)


def _cpu_state_dict(net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}


def adam_state_dict(opt: AdamState, lr: float, b1: float = 0.5, b2: float = 0.999) -> Dict:
    """A ``torch.optim.Adam`` state_dict holding ``opt``'s moments, built from a
    real Adam so its parameter-group keys are those of the installed torch."""
    template = torch.optim.Adam([torch.zeros(1, requires_grad=True)], lr=lr, betas=(b1, b2))
    sd = template.state_dict()
    sd["param_groups"][0]["params"] = list(range(len(opt.mu)))
    sd["state"] = {
        i: {"step": torch.tensor(float(opt.count)), "exp_avg": m.detach().cpu().clone(),
            "exp_avg_sq": v.detach().cpu().clone()}
        for i, (m, v) in enumerate(zip(opt.mu, opt.nu))
    } if opt.count else {}
    return sd


def cosine_scheduler_state_dict(lr: float, total_epochs: int, last_epoch: int,
                                eta_min: float = 1e-6) -> Dict:
    """A ``CosineAnnealingLR`` state_dict stepped ``last_epoch`` times (trainer.py:64-65, 349)."""
    opt = torch.optim.Adam([torch.zeros(1, requires_grad=True)], lr=lr, betas=(0.5, 0.999))
    sd = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=total_epochs,
                                                    eta_min=eta_min).state_dict()
    sd["last_epoch"] = last_epoch
    sd["_step_count"] = last_epoch + 1
    return sd


def save_checkpoint(save_dir: str, state: TrainState, loss_history: Dict[str, List[float]],
                    lr_g: float, lr_d: float, total_epochs: int, eta_min: float = 1e-6) -> None:
    os.makedirs(save_dir, exist_ok=True)
    models = state.models
    last_epoch = len(loss_history.get("G_loss", []))
    ckpt: Dict[str, Any] = {k: _cpu_state_dict(models.nets[k]) for k in G_KEYS + D_KEYS}
    ckpt.update(
        g_optimizer=adam_state_dict(state.opt_g, lr_g),
        d_optimizer=adam_state_dict(state.opt_d, lr_d),
        g_scheduler=cosine_scheduler_state_dict(lr_g, total_epochs, last_epoch, eta_min),
        d_scheduler=cosine_scheduler_state_dict(lr_d, total_epochs, last_epoch, eta_min),
        loss_history={k: list(v) for k, v in loss_history.items()},
        num_domains=models.num_domains,
    )
    torch.save(ckpt, os.path.join(save_dir, "checkpoint.pth"))
    torch.save({f"ema_{k}": _cpu_state_dict(models.ema[k]) for k in G_KEYS},
               os.path.join(save_dir, "ema_checkpoint.pth"))
    logger.info("Saved checkpoint to %s", save_dir)


def save_ema_snapshot(snapshot_dir: str, state: TrainState, meta: Dict[str, Any]) -> None:
    """The fp16 EMA G_A2B + SE_B in the demo-npz layout (``msig_tpu/train/trainer.py:235-278``):
    ``ema_g_se_fp16.npz`` with '/'-joined flax keys (``gen/params/...``,
    ``se/params/...``) and ``meta.json``; the inference CLIs of both packages load it."""
    models = state.models
    n_res = int(meta["n_residual_blocks"])
    trees = {"gen": generator_params(models.ema["G_A2B"].state_dict(), n_res),
             "se": style_encoder_params(models.ema["SE_B"].state_dict(), models.num_domains)}
    flat: Dict[str, np.ndarray] = {}

    def _flatten(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                _flatten(v, f"{prefix}/{k}")
        else:
            flat[prefix] = np.asarray(tree, np.float16)

    for name, tree in trees.items():
        _flatten(tree, name)
    os.makedirs(snapshot_dir, exist_ok=True)
    np.savez(os.path.join(snapshot_dir, "ema_g_se_fp16.npz"), **flat)
    with open(os.path.join(snapshot_dir, "meta.json"), "w") as f:
        json.dump({"ema": True, "num_domains": models.num_domains,
                   "note": "in-training fp16 EMA snapshot", **meta}, f, indent=2)
