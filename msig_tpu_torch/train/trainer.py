"""The training loop: epochs, logging, sample grids, plots, checkpoints.

Counterpart of ``msig_tpu/train/trainer.py`` (reference trainer.py:276-360),
without wandb and profiling (not ported yet):

  - shuffled batches, ``drop_last``;
  - per epoch the cosine learning rates and the dynamic loss weights
    (their history is per step, like the reference's);
  - an EMA 2x2 sample grid [Real A, Fake B, Real B, Fake A] every
    ``save_freq`` batches, and loss / weight plots per epoch, both skipped
    with ``MSIG_SKIP_EPOCH_ART=1``;
  - per-epoch loss averages into ``loss_history``, fetched from the device
    once per epoch;
  - reference-format checkpoints every ``checkpoint_every`` epochs and at the
    end, and optional fp16 EMA snapshots.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List

import numpy as np
import torch

from msig_tpu_torch import resolve_device
from msig_tpu_torch.config import TrainConfig
from msig_tpu_torch.data import MultiDomainDataset, TrainLoader
from msig_tpu_torch.losses import get_vgg
from msig_tpu_torch.train.checkpoint import save_checkpoint, save_ema_snapshot
from msig_tpu_torch.train.schedule import (
    WEIGHT_KEYS,
    cosine_lr,
    current_loss_weights,
    weights_vector,
)
from msig_tpu_torch.train.state import create_train_state
from msig_tpu_torch.train.step import make_train_step, prepare_images
from msig_tpu_torch.utils import plot_losses, plot_weight_history, save_sample_grid

logger = logging.getLogger(__name__)

METRIC_KEYS = ["D_loss", "G_loss"] + WEIGHT_KEYS


def _skip_epoch_art() -> bool:
    """``MSIG_SKIP_EPOCH_ART=1``: skip the sample grids and the loss / weight
    plots (as ``msig_tpu/train/trainer.py:54-59``); the loss history and the
    checkpoints are kept."""
    return os.environ.get("MSIG_SKIP_EPOCH_ART", "0") == "1"


class Trainer:
    def __init__(self, cfg: TrainConfig, dataset: MultiDomainDataset):
        self.cfg = cfg
        self.dataset = dataset
        self.device = device = resolve_device(cfg.device)
        self.num_domains = dataset.num_domains
        # first, so that an option not ported yet raises before any network is built
        self.train_step = make_train_step(
            cfg.ema_beta, getattr(torch, cfg.compute_dtype), r1_gamma=cfg.r1_gamma,
            remat=cfg.remat, style_recon_weight=cfg.style_recon_weight,
            diversity_weight=cfg.diversity_weight, grad_clip_norm=cfg.grad_clip_norm,
            adam_b1=cfg.adam_b1, adam_b2=cfg.adam_b2)
        self.state = create_train_state(cfg, self.num_domains)
        self.vgg = get_vgg(cfg.vgg_weights_path, device=device)

        def to_device(batch):
            return {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in batch.items()}

        self.loader = TrainLoader(dataset, cfg.batch_size, cfg.image_size, seed=cfg.seed,
                                  device_put=to_device)
        self.loss_history: Dict[str, List[float]] = {k: [] for k in METRIC_KEYS}
        self.weight_history: Dict[str, List[float]] = {k: [] for k in WEIGHT_KEYS}
        self.step_time_ms: List[float] = []
        self.save_dir = os.path.join(cfg.save_dir_base, cfg.experiment_name)
        self.images_dir = os.path.join(self.save_dir, "images")
        self.checkpoints_dir = os.path.join(self.save_dir, "checkpoints")

    @torch.no_grad()
    def _save_grid(self, batch, epoch: int, batch_idx: int) -> None:
        """EMA 2x2 grid of the batch's first sample (reference trainer.py:219-239)."""
        ema = self.state.models.ema
        real_A = prepare_images(batch["source"][0:1])
        real_B = prepare_images(batch["target"][0:1])
        y_org, y_trg = batch["source_domain"][0:1].long(), batch["target_domain"][0:1].long()
        fake_B = ema["G_A2B"](real_A, ema["SE_B"](real_B, y_trg))
        fake_A = ema["G_B2A"](real_B, ema["SE_A"](real_A, y_org))
        grid = torch.cat([real_A, fake_B, real_B, fake_A]).cpu().numpy()
        target_idx = int(y_trg[0])
        domains = self.dataset.domains
        name = domains[target_idx] if target_idx < len(domains) else f"Domain_{target_idx}"
        labels = [f"Real A ({domains[0]})", f"Fake B ({name})", f"Real B ({name})",
                  f"Fake A ({domains[0]})"]
        path = os.path.join(self.images_dir,
                            f"epoch_{epoch + 1:03d}_batch_{batch_idx:04d}_{name}.png")
        save_sample_grid(grid, path, nrow=2, domain_names=labels)

    def save(self, checkpoint_dir: str) -> None:
        cfg = self.cfg
        save_checkpoint(checkpoint_dir, self.state, self.loss_history, cfg.lr_g, cfg.lr_d,
                        cfg.epochs, cfg.lr_eta_min)

    def save_ema_snapshot(self, snapshot_dir: str) -> None:
        cfg = self.cfg
        save_ema_snapshot(snapshot_dir, self.state, {
            "epochs": len(self.loss_history.get("G_loss", [])), "style_dim": cfg.style_dim,
            "n_residual_blocks": cfg.n_residual_blocks, "image_size": cfg.image_size})

    def train(self, start_epoch: int = 0) -> None:
        cfg = self.cfg
        os.makedirs(self.images_dir, exist_ok=True)
        os.makedirs(self.checkpoints_dir, exist_ok=True)
        steps = self.loader.steps_per_epoch()
        logger.info("Training %d epochs x %d steps, batch %d, %d domains, device %s",
                    cfg.epochs, steps, cfg.batch_size, self.num_domains, self.device)
        for epoch in range(start_epoch, cfg.epochs):
            g_lr = cosine_lr(cfg.lr_g, epoch, cfg.epochs, cfg.lr_eta_min)
            d_lr = cosine_lr(cfg.lr_d, epoch, cfg.epochs, cfg.lr_eta_min)
            weights = current_loss_weights(cfg.loss_weights, epoch, cfg.warmup_epochs,
                                           cfg.decay_epochs)
            w_vec = weights_vector(weights)
            epoch_metrics: List[Dict[str, torch.Tensor]] = []
            t0 = time.time()
            for i, batch in enumerate(self.loader.epoch(epoch)):
                epoch_metrics.append(self.train_step(self.state, batch, self.vgg, g_lr, d_lr,
                                                     w_vec))
                for k in WEIGHT_KEYS:
                    self.weight_history[k].append(weights[k])
                if i % cfg.save_freq == 0 and not _skip_epoch_art():
                    self._save_grid(batch, epoch, i)
            # one device -> host transfer for the whole epoch's metrics
            avg = {}
            if epoch_metrics:
                host = torch.stack([torch.stack([m[k] for k in METRIC_KEYS])
                                    for m in epoch_metrics]).cpu().numpy().astype(np.float64)
                avg = {k: float(v) for k, v in zip(METRIC_KEYS, host.mean(axis=0))}
            for k, v in avg.items():
                self.loss_history[k].append(v)
            dt = time.time() - t0
            ms_per_step = 1000 * dt / max(1, steps)
            self.step_time_ms.append(ms_per_step)
            logger.info("epoch %d/%d  %.1fs (%.1f ms/step)  %s", epoch + 1, cfg.epochs, dt,
                        ms_per_step, "  ".join(f"{k}={v:.3f}" for k, v in avg.items()))
            if not _skip_epoch_art():
                plot_losses(self.loss_history, os.path.join(self.save_dir, "losses.png"))
                plot_weight_history(self.weight_history,
                                    os.path.join(self.save_dir, "weight_history.png"))
            if (epoch + 1) % cfg.checkpoint_every == 0 or (epoch + 1) == cfg.epochs:
                self.save(os.path.join(self.checkpoints_dir, f"epoch_{epoch + 1}"))
            snap = cfg.ema_snapshot_every
            if snap and ((epoch + 1) % snap == 0 or (epoch + 1) == cfg.epochs):
                self.save_ema_snapshot(
                    os.path.join(self.save_dir, "ema_snapshots", f"epoch_{epoch + 1}"))
        logger.info("Multi-domain training completed!")
