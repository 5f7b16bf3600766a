"""The training loop: epochs, logging, sample grids, plots, checkpoints.

Counterpart of ``msig_tpu/train/trainer.py`` (reference trainer.py:276-360):

  - shuffled batches, ``drop_last``, from the host pipeline (``TrainLoader``)
    or, with ``--device_data``, from the device-resident dataset
    (``data/device_data.py``); with a diversity weight both also draw
    ``target2``;
  - per epoch the cosine learning rates and the dynamic loss weights
    (their history is per step, like the reference's);
  - an EMA 2x2 sample grid [Real A, Fake B, Real B, Fake A] every
    ``save_freq`` batches, and loss / weight plots per epoch, both skipped
    with ``MSIG_SKIP_EPOCH_ART=1``;
  - per-epoch loss averages into ``loss_history``, fetched from the device
    once per epoch;
  - reference-format checkpoints every ``checkpoint_every`` epochs and at the
    end, and optional fp16 EMA snapshots;
  - :meth:`Trainer.resume` from such a checkpoint, after which ``train``
    starts at the resumed epoch with that epoch's learning rates and weights;
  - :meth:`Trainer.profile_steps`: a ``torch.profiler`` trace of a few steps;
  - data parallelism (``cfg.data_parallel`` in a process group of k > 1
    ranks, ``parallel/mesh.py``): every rank builds the same global batch
    from the same seed and keeps its rows, the networks, EMA copies and Adam
    moments start from rank 0's (after construction and after a resume), the
    step averages gradients and metrics over the ranks; only rank 0 writes
    checkpoints, grids, plots, snapshots and the profile. ``--device_data``
    stays single-device (ValueError in a group, as the JAX trainer raises);
  - given a wandb run (``wandb_run``; the CLI's ``--wandb`` passes one on the
    rank of each host whose local rank is 0), per-step losses under ``loss/*``,
    per-epoch ``avg_loss/*``, ``lr/*``, ``weight/*``, and every ``watch_freq``
    steps the gradient histograms of a second step function with
    ``grad_hists=64`` (``train/watch.py``), logged with that step's losses
    (reference trainer.py:294, 308-346). With ``cfg.wandb`` every rank steps
    that watch step on the same steps, with or without a run, so that the
    ranks run one program (the histograms, of all-reduced gradients, are equal
    on every rank); only a rank holding a run copies them to the host and
    logs. With neither a run nor ``cfg.wandb``, ``watch_freq`` does nothing,
    as in the JAX trainer. ``watch_steps`` lists the global steps that took
    the watch step.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from msig_tpu_torch import resolve_device
from msig_tpu_torch.config import TrainConfig
from msig_tpu_torch.data import MultiDomainDataset, TrainLoader
from msig_tpu_torch.losses import get_vgg
from msig_tpu_torch.parallel import replicate, shard_batch, world
from msig_tpu_torch.train import watch
from msig_tpu_torch.train.checkpoint import resume_for_training, save_checkpoint, save_ema_snapshot
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
    def __init__(self, cfg: TrainConfig, dataset: MultiDomainDataset, wandb_run=None):
        self.cfg = cfg
        self.dataset = dataset
        self.wandb = wandb_run
        self.device = device = resolve_device(cfg.device)
        if device.type == "cuda" and device.index is None:
            # name the card: the loader's prefetch thread moves the batches, and the
            # current card (torch.cuda.set_device, one a rank) is per thread
            self.device = device = torch.device("cuda", torch.cuda.current_device())
        # without data_parallel each rank of a group trains alone; rank 0 writes
        self.rank, n_ranks = world()
        self.world = n_ranks if cfg.data_parallel else 1
        if cfg.batch_size % self.world:
            raise ValueError(f"batch_size={cfg.batch_size} does not split over {self.world} "
                             "data-parallel ranks: every launched rank takes an equal share")
        if cfg.device_data and self.world > 1:
            raise ValueError(
                "--device_data is single-device only: it keeps the decoded dataset resident "
                f"on ONE device, which conflicts with the {self.world}-rank data-parallel "
                "group. Run with --no_data_parallel, or use the host-fed pipeline for "
                "multi-device training.")
        # With cuDNN's default algorithms the decoders' ConvTranspose2d differs
        # in its last bits from run to run on the card; the deterministic ones
        # cost 0.5-3.3% of a step (tools/train_step_determinism_torch.py).
        torch.backends.cudnn.deterministic = True
        self.num_domains = dataset.num_domains
        # first, so that an unknown option raises before any network is built
        options = dict(r1_gamma=cfg.r1_gamma, remat=cfg.remat,
                       style_recon_weight=cfg.style_recon_weight,
                       diversity_weight=cfg.diversity_weight, grad_clip_norm=cfg.grad_clip_norm,
                       adam_b1=cfg.adam_b1, adam_b2=cfg.adam_b2)
        dtype = getattr(torch, cfg.compute_dtype)
        options["distributed"] = self.world > 1
        self.train_step = make_train_step(cfg.ema_beta, dtype, **options)
        # wandb.watch (reference trainer.py:294): a second step function that also
        # bins every gradient on the device, taken every watch_freq-th step, and
        # only under wandb, as the reference's `if cfg.wandb`: on every rank of a
        # --wandb run, also on those that hold no run.
        self.watch_freq = cfg.watch_freq
        self.train_step_watch = None
        self.watch_steps: List[int] = []
        if self.watch_freq > 0 and (wandb_run is not None or cfg.wandb):
            self.train_step_watch = make_train_step(cfg.ema_beta, dtype, grad_hists=64, **options)
        self.state = create_train_state(cfg, self.num_domains)
        self._replicate_state()
        self.vgg = get_vgg(cfg.vgg_weights_path, device=device)

        def to_device(batch):
            if self.world > 1:
                batch = shard_batch(batch, self.rank, self.world)
            return {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in batch.items()}

        self.loader = TrainLoader(dataset, cfg.batch_size, cfg.image_size, seed=cfg.seed,
                                  device_put=to_device,
                                  second_target=cfg.diversity_weight > 0.0)
        # --device_data: the decoded dataset stays on the device and is augmented
        # there; per step the host sends indices and crop parameters only.
        self.device_data = None
        if cfg.device_data:
            from msig_tpu_torch.data.device_data import DeviceData

            self.device_data = DeviceData(dataset, cfg.image_size,
                                          second_target=cfg.diversity_weight > 0.0,
                                          device=cfg.device)
        self.loss_history: Dict[str, List[float]] = {k: [] for k in METRIC_KEYS}
        self.weight_history: Dict[str, List[float]] = {k: [] for k in WEIGHT_KEYS}
        self.step_time_ms: List[float] = []
        self.save_dir = os.path.join(cfg.save_dir_base, cfg.experiment_name)
        self.images_dir = os.path.join(self.save_dir, "images")
        self.checkpoints_dir = os.path.join(self.save_dir, "checkpoints")

    def _replicate_state(self) -> None:
        """Rank 0's networks, EMA copies and Adam moments on every rank."""
        if self.world == 1:
            return
        st = self.state
        for net in [*st.models.nets.values(), *st.models.ema.values()]:
            replicate(net)
        replicate([*st.opt_g.mu, *st.opt_g.nu, *st.opt_d.mu, *st.opt_d.nu])

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

    def resume(self, checkpoint_dir: str) -> int:
        """Restore the whole train state and the loss history from a checkpoint
        directory; returns the epoch to start at (0 when there is nothing to
        resume from)."""
        self.state, loss_history, start_epoch = resume_for_training(
            checkpoint_dir, self.state, self.num_domains)
        for k, v in loss_history.items():
            if k in self.loss_history:
                self.loss_history[k] = list(v)
        self._replicate_state()
        return start_epoch

    def profile_steps(self, n_steps: int = 5, trace_dir: Optional[str] = None) -> str:
        """Trace ``n_steps`` train steps with ``torch.profiler`` (the card's kernels
        too on ``cuda``) after one untraced step, at epoch 0's learning rates and
        weights; writes ``trace.json`` (Chrome trace format) into ``trace_dir``
        (default ``save_dir/profile``) and returns the directory."""
        from torch.profiler import ProfilerActivity, profile

        cfg = self.cfg
        trace_dir = trace_dir or os.path.join(self.save_dir, "profile")
        w_vec = weights_vector(current_loss_weights(cfg.loss_weights, 0))
        it = self.loader.epoch(0)

        def step(batch):
            return self.train_step(self.state, batch, self.vgg, cfg.lr_g, cfg.lr_d, w_vec)

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        try:
            step(next(it))  # the first step's one-time work stays out of the trace
            sync()
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                for batch in it:
                    step(batch)
                    n_steps -= 1
                    if n_steps <= 0:
                        break
                sync()
        finally:
            it.close()
        if self.rank == 0:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
            logger.info("Wrote profiler trace to %s", trace_dir)
        return trace_dir

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
        writer = self.rank == 0  # the one rank that writes files
        if writer:
            os.makedirs(self.images_dir, exist_ok=True)
            os.makedirs(self.checkpoints_dir, exist_ok=True)
        steps = self.loader.steps_per_epoch()
        logger.info("Training %d epochs x %d steps, batch %d, %d domains, device %s, rank %d of %d",
                    cfg.epochs, steps, cfg.batch_size, self.num_domains, self.device, self.rank,
                    self.world)
        for epoch in range(start_epoch, cfg.epochs):
            g_lr = cosine_lr(cfg.lr_g, epoch, cfg.epochs, cfg.lr_eta_min)
            d_lr = cosine_lr(cfg.lr_d, epoch, cfg.epochs, cfg.lr_eta_min)
            weights = current_loss_weights(cfg.loss_weights, epoch, cfg.warmup_epochs,
                                           cfg.decay_epochs)
            w_vec = weights_vector(weights)
            epoch_metrics: List[Dict[str, torch.Tensor]] = []
            t0 = time.time()
            if self.device_data is not None:
                batches = self.device_data.epoch(epoch, cfg.batch_size, seed=cfg.seed)
            else:
                batches = self.loader.epoch(epoch)
            for i, batch in enumerate(batches):
                watching = (self.train_step_watch is not None
                            and (epoch * steps + i) % self.watch_freq == 0)
                step_fn = self.train_step_watch if watching else self.train_step
                metrics = step_fn(self.state, batch, self.vgg, g_lr, d_lr, w_vec)
                hists = metrics.pop("_grad_hists") if watching else None
                if watching:
                    self.watch_steps.append(epoch * steps + i)
                    hists = watch.to_host(hists) if self.wandb is not None else None
                epoch_metrics.append(metrics)
                for k in WEIGHT_KEYS:
                    self.weight_history[k].append(weights[k])
                if self.wandb is not None:
                    logs = {f"loss/{k}": float(v) for k, v in metrics.items()}
                    if hists is not None:
                        # in the same log call as the step's losses, so that the
                        # histograms share their step
                        logs.update(watch.to_wandb(hists))
                    self.wandb.log(logs)
                if writer and i % cfg.save_freq == 0 and not _skip_epoch_art():
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
            if self.wandb is not None:
                logs = {"epoch": epoch + 1, "perf/step_time_ms": ms_per_step}
                logs.update({f"avg_loss/{k}": v for k, v in avg.items()})
                logs["lr/generator"] = g_lr
                logs["lr/discriminator"] = d_lr
                logs.update({f"weight/{k}": weights[k] for k in WEIGHT_KEYS})
                self.wandb.log(logs)
            if writer and not _skip_epoch_art():
                plot_losses(self.loss_history, os.path.join(self.save_dir, "losses.png"))
                plot_weight_history(self.weight_history,
                                    os.path.join(self.save_dir, "weight_history.png"))
            last = (epoch + 1) == cfg.epochs
            if writer and ((epoch + 1) % cfg.checkpoint_every == 0 or last):
                self.save(os.path.join(self.checkpoints_dir, f"epoch_{epoch + 1}"))
            snap = cfg.ema_snapshot_every
            if writer and snap and ((epoch + 1) % snap == 0 or last):
                self.save_ema_snapshot(
                    os.path.join(self.save_dir, "ema_snapshots", f"epoch_{epoch + 1}"))
        logger.info("Multi-domain training completed!")
