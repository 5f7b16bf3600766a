"""Training CLI of the port: ``python -m msig_tpu_torch.train`` (``train/__main__.py``).

The flags and exit codes of the root ``main.py`` (reference main.py:100-147),
plus ``--device {cuda,cpu}`` (default ``cuda``; a missing card is an error,
never a silent fall back to the CPU):

    python -m msig_tpu_torch.train --source_dir data/src/Tomato_healthy --target_dir data/ref \\
        [--epochs N] [--batch_size B] [--image_size S] [--lr_g F] [--lr_d F] \\
        [--loss_weights '{"gan":1.0,...}'] [--exp_name NAME] [--save_freq K] \\
        [--vgg_weights FILE.npz | --allow_random_vgg] [--pallas] [--device cuda|cpu]

Exits 1 on a missing source or target directory and without a VGG choice
(``--vgg_weights`` or ``--allow_random_vgg``), as ``main.py`` does.
``MSIG_CONV_VJP=1|2`` and ``--pallas`` route the resblock trunk through the
training kernels, as in the JAX package. The number of steps is the dataset's
size over the batch, times ``--epochs``. ``--compute_dtype`` is float32 (the
default, TF32 off on the card) or bfloat16 (the convs, ConvTs and dense layers
in bf16 on fp32 master parameters, the norms' statistics, Grams, losses, clip,
Adam and EMA in fp32; ``train/step.py``). ``--device_data`` keeps the decoded
dataset on the device and augments there (``data/device_data.py``).

The root ``main.py``'s other single-device options:

  - ``--resume DIR``: the whole train state from a checkpoint directory the
    port wrote (networks, EMA, Adam moments, loss history), then training from
    the next epoch; nothing to resume from (or another domain count) starts
    from scratch with a warning;
  - ``--profile_steps N``: trace N steps with ``torch.profiler`` into
    ``<save_dir>/<exp>/profile/trace.json``, print where, and exit 0;
  - ``--remat``: recompute every generator launch in the backward
    (``torch.utils.checkpoint``) instead of keeping its activations;
  - ``--r1_gamma``, ``--style_recon_weight``, ``--diversity_weight``: the
    extension losses (0 = off, the reference's losses);
  - ``--watch_freq N``: with ``--wandb``, gradient histograms every N steps,
    logged with that step's losses; without ``--wandb`` it does nothing, as in
    ``main.py``.

``--wandb`` (``main.py:197-253``): ``wandb`` is imported only under the flag
(without the package the run fails at the import, as ``main.py`` does), the
run starts after the CLI's checks with the JAX CLI's project, ``name`` the
experiment and ``config`` every field of the config, the trainer logs to it,
and ``finish()`` runs in a ``finally`` on the ``--profile_steps`` branch and
the train branch. One run a host: the rank whose local rank is 0 starts it (the
one process of a single-process run, local rank 0 of the CLI's own workers,
of ``torchrun`` or of ``--multihost``), as each JAX process starts one, one a
host. Every rank steps the watch step on the same steps; only the rank holding
the run logs (``train/trainer.py``).

Data parallelism (``parallel/mesh.py``; the step and trainer average the
gradients and metrics of one process per device):

  - by default (``--no_data_parallel`` turns it off), with no launcher in the
    environment, the run takes the most local cards that divide
    ``--batch_size`` (``data_mesh_for_batch``, the JAX package's "all local
    devices") and starts one worker process per card itself
    (``torch.multiprocessing``, NCCL); on one card (or ``--device cpu``) it is
    the single-process run;
  - under a launcher (``torchrun``, which sets ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``), or with
    ``--multihost``, it joins the launcher's group (NCCL on ``cuda``, gloo on
    ``cpu``); a group that fails to start fails the run, a global batch the
    world size does not divide raises, and ``--multihost`` with no launcher
    in the environment runs as one process.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import sys

import msig_tpu_torch.config as default_config
from msig_tpu_torch.config import TrainConfig


def _parse_bool(s: str) -> bool:
    v = s.lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean (true/false), got {s!r}")


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train Multi-Domain StyleCycleGAN (PyTorch port) with custom configurations.")
    parser.add_argument("--source_dir", type=str, default=default_config.SOURCE_DIR,
                        help="Path to source domain directory")
    parser.add_argument("--target_dir", type=str, default=default_config.TARGET_DIR,
                        help="Path to parent directory containing target domain subdirectories")
    parser.add_argument("--save_dir_base", type=str, default=default_config.SAVE_DIR_BASE,
                        help="Base directory for saving results")
    parser.add_argument("--resume", type=str, default=default_config.RESUME_CHECKPOINT,
                        help="Checkpoint directory to resume from")
    parser.add_argument("--exp_name", type=str,
                        help="Experiment name. If not provided, it will be auto-generated.")
    parser.add_argument("--gpu", type=int, default=default_config.GPU,
                        help="Accepted for reference CLI parity; the device is --device")
    parser.add_argument("--epochs", type=int, default=default_config.NUM_EPOCHS)
    parser.add_argument("--image_size", type=int, default=default_config.IMAGE_SIZE)
    parser.add_argument("--batch_size", type=int, default=default_config.BATCH_SIZE)
    parser.add_argument("--save_freq", type=int, default=default_config.SAVE_FREQ)
    parser.add_argument("--lr_g", type=float, default=default_config.LEARNING_RATE_G)
    parser.add_argument("--lr_d", type=float, default=default_config.LEARNING_RATE_D)
    parser.add_argument("--loss_weights", type=str, default=json.dumps(default_config.LOSS_WEIGHTS),
                        help="Loss weights as a JSON string.")
    parser.add_argument("--use_ema", type=_parse_bool, default=default_config.TRAINING_USE_EMA,
                        help="Use EMA models for the sample grids (true/false).")
    parser.add_argument("--wandb", action="store_true", help="Enable Weights & Biases logging")
    parser.add_argument("--compute_dtype", type=str, default=default_config.COMPUTE_DTYPE_TRAIN,
                        choices=["float32", "bfloat16"],
                        help="float32, or bfloat16: the products in bf16 on fp32 master "
                             "parameters")
    parser.add_argument("--vgg_weights", type=str, default=default_config.VGG_WEIGHTS_PATH,
                        help=".npz from tools/convert_vgg_weights.py (perceptual-loss weights)")
    parser.add_argument("--allow_random_vgg", action="store_true",
                        help="Explicitly allow training WITHOUT pretrained VGG19 weights: the "
                             "perceptual loss uses a seeded random VGG drawn with torch, whose "
                             "numbers are not the JAX package's random VGG's")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_data_parallel", action="store_true",
                        help="Train in one process on one device even with several cards")
    parser.add_argument("--pallas", dest="pallas", action="store_true", default=None,
                        help="Route the resblock AdaINs through the fused kernel (adain_pallas)")
    parser.add_argument("--no_pallas", dest="pallas", action="store_false",
                        help="Keep the resblock AdaINs on plain PyTorch")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="Trace N train steps with torch.profiler into <save dir>/profile, "
                             "then exit")
    parser.add_argument("--r1_gamma", type=float, default=0.0,
                        help="R1 gradient penalty weight on real images (extension; 0 = off)")
    parser.add_argument("--remat", action="store_true",
                        help="Recompute the generator forwards in the backward "
                             "(torch.utils.checkpoint) instead of keeping their activations")
    parser.add_argument("--device_data", action="store_true",
                        help="Keep the decoded dataset on the device and augment there "
                             "(single device)")
    parser.add_argument("--style_recon_weight", type=float, default=0.0,
                        help="Style-reconstruction loss weight (extension; 0 = off)")
    parser.add_argument("--diversity_weight", type=float, default=0.0,
                        help="Diversity loss weight (extension; 0 = off); draws a second "
                             "target image per sample")
    parser.add_argument("--multihost", action="store_true",
                        help="Join the process group a launcher (torchrun) configured in the "
                             "environment; without one, run as one process")
    parser.add_argument("--watch_freq", type=int, default=0,
                        help="Log gradient histograms to the wandb run every N steps (0 = off)")
    parser.add_argument("--checkpoint_every", type=int,
                        default=default_config.CHECKPOINT_EVERY_EPOCHS,
                        help="Write a checkpoint every N epochs (the final epoch always does)")
    parser.add_argument("--ema_snapshot_every", type=int, default=0,
                        help="Also export the fp16 EMA (G_A2B + SE_B) demo-npz snapshot every "
                             "N epochs; 0 disables")
    parser.add_argument("--device", type=str, default=default_config.DEVICE,
                        choices=["cuda", "cpu"], help="cuda (default) or cpu")
    return parser


def config_from_args(args) -> TrainConfig:
    return TrainConfig(
        source_dir=args.source_dir,
        target_dir=args.target_dir,
        save_dir_base=args.save_dir_base,
        resume=args.resume,
        exp_name=args.exp_name,
        gpu=args.gpu,
        epochs=args.epochs,
        image_size=args.image_size,
        batch_size=args.batch_size,
        save_freq=args.save_freq,
        lr_g=args.lr_g,
        lr_d=args.lr_d,
        loss_weights=TrainConfig.parse_loss_weights(args.loss_weights),
        use_ema=args.use_ema,
        wandb=args.wandb,
        compute_dtype=args.compute_dtype,
        vgg_weights_path=args.vgg_weights,
        seed=args.seed,
        data_parallel=not args.no_data_parallel,
        use_pallas=(default_config.USE_PALLAS_ADAIN if args.pallas is None else args.pallas),
        profile_steps=args.profile_steps,
        r1_gamma=args.r1_gamma,
        remat=args.remat,
        device_data=args.device_data,
        multihost=args.multihost,
        style_recon_weight=args.style_recon_weight,
        diversity_weight=args.diversity_weight,
        allow_random_vgg=args.allow_random_vgg,
        watch_freq=args.watch_freq,
        checkpoint_every=args.checkpoint_every,
        ema_snapshot_every=args.ema_snapshot_every,
        device=args.device,
    )


WANDB_PROJECT = "Multi-Domain Style-Injected CycleGAN"  # main.py:206


def start_wandb_run(cfg: TrainConfig):
    """``wandb.init`` with ``main.py:203-209``'s arguments on the rank whose
    local rank is 0; None on every other rank and without ``--wandb``."""
    from msig_tpu_torch.parallel import local_rank

    if not cfg.wandb or local_rank() != 0:
        return None
    import wandb

    return wandb.init(project=WANDB_PROJECT, name=cfg.experiment_name,
                      config={k: v for k, v in vars(cfg).items()})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _local_worker(local_rank: int, cfg: TrainConfig, n_workers: int, port: int) -> None:
    """One rank of :func:`launch_local_workers`: the launcher's environment, then main."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(local_rank),
                      WORLD_SIZE=str(n_workers), LOCAL_RANK=str(local_rank))
    rc = main(cfg)
    if rc:
        sys.exit(rc)


def launch_local_workers(cfg: TrainConfig, n_workers: int) -> int:
    """Run :func:`main` in ``n_workers`` spawned processes, one a local device,
    as one process group on a free port of this host; 0 if every worker exits 0."""
    import torch.multiprocessing as mp

    try:
        mp.start_processes(_local_worker, args=(cfg, n_workers, _free_port()),
                           nprocs=n_workers, start_method="spawn")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        print(f"ERROR: a training worker failed: {e}")
        return 1
    return 0


def main(cfg: TrainConfig) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    import torch
    import torch.distributed as dist

    from msig_tpu_torch import resolve_device
    from msig_tpu_torch.parallel import mesh

    try:
        resolve_device(cfg.device)
    except (RuntimeError, ValueError) as e:
        print(f"ERROR: {e}")
        return 1
    # float32 on the card means fp32: by default cuDNN runs fp32 convolutions in TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # Two runs of a step give the same bits (the Trainer sets it too).
    torch.backends.cudnn.deterministic = True

    print(f"--- Starting Multi-Domain Experiment: {cfg.experiment_name} ---")
    for path, what in ((cfg.source_dir, "Source"), (cfg.target_dir, "Target domains")):
        if not os.path.exists(path):
            print(f"ERROR: {what} directory not found: {path}")
            return 1
    # Training with a random VGG must be an explicit, visible decision: the
    # reference loads ImageNet VGG19 (reference losses.py:15).
    if not cfg.vgg_weights_path and not cfg.allow_random_vgg:
        print("ERROR: no pretrained VGG19 weights (--vgg_weights FILE.npz). The perceptual "
              "style/content loss would fall back to a RANDOM feature extractor, which does not "
              "match the reference's ImageNet-VGG19 loss. Convert weights with "
              "tools/convert_vgg_weights.py, or pass --allow_random_vgg to proceed anyway.")
        return 1
    if cfg.vgg_weights_path and not os.path.exists(cfg.vgg_weights_path):
        print(f"ERROR: --vgg_weights file not found: {cfg.vgg_weights_path}")
        return 1

    launched = mesh.rendezvous_configured()
    started = False
    if cfg.multihost or launched:
        started = not dist.is_initialized() and mesh.initialize_multihost(cfg.device)
    try:
        rank, n_ranks = mesh.world()
        if n_ranks > 1:
            print(f"Process group: rank {rank} of {n_ranks} "
                  f"({'data parallel' if cfg.data_parallel else 'no data parallelism'})")
        elif cfg.data_parallel and not launched:
            devices = mesh.data_mesh_for_batch(cfg.batch_size, mesh.local_devices(cfg.device))
            print(f"Data parallel: {len(devices) if devices else 1} device(s)")
            if devices:
                return launch_local_workers(cfg, len(devices))
        return _train(cfg)
    finally:
        if started:
            dist.destroy_process_group()


def _train(cfg: TrainConfig) -> int:
    from msig_tpu_torch.data import MultiDomainDataset
    from msig_tpu_torch.train.trainer import Trainer

    # after the checks of main(): an early error return leaves no empty run behind
    wandb_run = start_wandb_run(cfg)
    try:
        dataset = MultiDomainDataset.build(cfg.source_dir, cfg.target_dir)
        print(f"Found {len(dataset.source_files)} source images")
        print(f"Total domains: {dataset.num_domains} (source: index 0; targets: "
              + ", ".join(f"{i} {n} ({len(dataset.target_files_by_domain[n])} images)"
                          for i, n in enumerate(dataset.domains) if i) + ")")
        trainer = Trainer(cfg, dataset, wandb_run=wandb_run)
        if cfg.profile_steps:
            trace_dir = trainer.profile_steps(cfg.profile_steps)
            print(f"Profiler trace written to {trace_dir}")
            return 0
        start_epoch = 0
        if cfg.resume:
            print(f"Attempting to resume from checkpoint: {cfg.resume}")
            start_epoch = trainer.resume(cfg.resume)
            print(f"Resuming training from epoch {start_epoch + 1}")
        print("Starting multi-domain training...")
        try:
            trainer.train(start_epoch=start_epoch)
        except Exception as e:  # the reference prints the error and exits 1 (main.py:243-250)
            print(f"An error occurred during training: {e}")
            import traceback

            traceback.print_exc()
            return 1
    finally:
        if wandb_run is not None:
            wandb_run.finish()
    print(f"--- Multi-Domain Experiment {cfg.experiment_name} Completed ---")
    return 0
