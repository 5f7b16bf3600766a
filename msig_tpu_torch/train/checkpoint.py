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

:func:`resume_for_training` reads them back into a train state: the six
networks, the EMA copies, both Adam moment sets with their step counts and
``loss_history`` (reference trainer.py:176-207). The JAX package re-initialises
Adam when it resumes from such a directory (``_resume_from_torch``); the
reference restores the moments, and so does the port. Orbax directories (the
JAX package's own checkpoints) cannot be read without JAX and are refused.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Tuple

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


def demo_npz_arrays(gen_sd: Dict[str, torch.Tensor], se_sd: Dict[str, torch.Tensor],
                    n_residual_blocks: int, num_domains: int) -> Dict[str, np.ndarray]:
    """A G_A2B and an SE_B state_dict as the demo npz's arrays: '/'-joined flax
    keys (``gen/params/...``, ``se/params/...``), float16 (the flatten of
    ``tools/export_demo_checkpoint.py`` and ``msig_tpu/train/trainer.py:235-278``)."""
    trees = {"gen": generator_params(gen_sd, n_residual_blocks),
             "se": style_encoder_params(se_sd, num_domains)}
    flat: Dict[str, np.ndarray] = {}

    def _flatten(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                _flatten(v, f"{prefix}/{k}")
        else:
            flat[prefix] = np.asarray(tree, np.float16)

    for name, tree in trees.items():
        _flatten(tree, name)
    return flat


def save_ema_snapshot(snapshot_dir: str, state: TrainState, meta: Dict[str, Any]) -> None:
    """The fp16 EMA G_A2B + SE_B in the demo-npz layout (``msig_tpu/train/trainer.py:235-278``):
    ``ema_g_se_fp16.npz`` (:func:`demo_npz_arrays`) and ``meta.json``; the
    inference CLIs of both packages load it."""
    models = state.models
    flat = demo_npz_arrays(models.ema["G_A2B"].state_dict(), models.ema["SE_B"].state_dict(),
                           int(meta["n_residual_blocks"]), models.num_domains)
    os.makedirs(snapshot_dir, exist_ok=True)
    np.savez(os.path.join(snapshot_dir, "ema_g_se_fp16.npz"), **flat)
    with open(os.path.join(snapshot_dir, "meta.json"), "w") as f:
        json.dump({"ema": True, "num_domains": models.num_domains,
                   "note": "in-training fp16 EMA snapshot", **meta}, f, indent=2)


_ORBAX_META = "meta.json"  # what the JAX package's save_checkpoint writes beside its Orbax tree


def _load_adam_(opt: AdamState, sd: Dict, what: str) -> None:
    """Copy a ``torch.optim.Adam`` state_dict's moments and step into ``opt``, in place."""
    state = sd.get("state", {})
    if not state:  # saved before the first step
        for m in opt.mu + opt.nu:
            m.zero_()
        opt.count = 0
        return
    if len(state) != len(opt.mu):
        raise ValueError(f"{what} holds {len(state)} parameters' moments, the model has "
                         f"{len(opt.mu)}")
    steps = {int(float(s["step"])) for s in state.values()}
    if len(steps) != 1:
        raise ValueError(f"{what}: the parameters' step counts differ ({sorted(steps)})")
    for i, (m, v) in enumerate(zip(opt.mu, opt.nu)):
        m.copy_(state[i]["exp_avg"])
        v.copy_(state[i]["exp_avg_sq"])
    opt.count = steps.pop()


@torch.no_grad()
def resume_for_training(save_dir: str, state: TrainState,
                        expected_num_domains: int) -> Tuple[TrainState, Dict[str, List[float]], int]:
    """(state, loss_history, start_epoch) from a directory ``save_checkpoint`` wrote.

    Restores ``state`` in place: the six networks, the EMA copies (the raw
    networks' when ``ema_checkpoint.pth`` is absent, as the JAX package does),
    both Adam moment sets and their step counts. ``start_epoch`` is the length
    of ``loss_history["G_loss"]``. A missing directory or checkpoint, or a
    ``num_domains`` that differs from the model's, warns and returns ``state``
    as it was, ``{}`` and 0 (``msig_tpu/train/checkpoint.py:68-145``). An Orbax
    directory of the JAX package raises ValueError."""
    path = os.path.join(save_dir, "checkpoint.pth")
    if not os.path.exists(path):
        if os.path.exists(os.path.join(save_dir, _ORBAX_META)):
            raise ValueError(
                f"{save_dir} is an Orbax checkpoint of the JAX package ({_ORBAX_META}, no "
                "checkpoint.pth); the port reads reference-format .pth directories only. "
                "Export it with tools/export_torch_checkpoint.py.")
        logger.warning("Checkpoint not found at %s. Starting from scratch.", save_dir)
        return state, {}, 0
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    saved_domains = int(ckpt.get("num_domains", 2))
    if saved_domains != expected_num_domains:
        logger.warning("Saved model has %d domains, but current model expects %d - starting "
                       "from scratch", saved_domains, expected_num_domains)
        return state, {}, 0
    models = state.models
    for k in G_KEYS + D_KEYS:
        models.nets[k].load_state_dict(ckpt[k], strict=True)
    ema_path = os.path.join(save_dir, "ema_checkpoint.pth")
    ema = torch.load(ema_path, map_location="cpu", weights_only=True) \
        if os.path.exists(ema_path) else {f"ema_{k}": ckpt[k] for k in G_KEYS}
    for k in G_KEYS:
        models.ema[k].load_state_dict(ema[f"ema_{k}"], strict=True)
    _load_adam_(state.opt_g, ckpt["g_optimizer"], "g_optimizer")
    _load_adam_(state.opt_d, ckpt["d_optimizer"], "d_optimizer")
    state.step = state.opt_g.count
    loss_history = {k: [float(x) for x in v] for k, v in ckpt.get("loss_history", {}).items()}
    start_epoch = len(loss_history.get("G_loss", []))
    logger.info("Resumed from %s (epoch %d, step %d)", save_dir, start_epoch, state.step)
    return state, loss_history, start_epoch
