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
size over the batch, times ``--epochs``. Training runs in float32, with TF32
off on the card. Flags of features not ported yet raise NotImplementedError:
``--resume``, ``--wandb``, ``--profile_steps``, ``--r1_gamma``, ``--remat``,
``--device_data``, ``--style_recon_weight``, ``--diversity_weight``,
``--multihost``, ``--watch_freq`` and ``--compute_dtype bfloat16``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

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
                        help="Checkpoint directory to resume from (not ported yet)")
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
    parser.add_argument("--wandb", action="store_true", help="Weights & Biases logging (not ported yet)")
    parser.add_argument("--compute_dtype", type=str, default=default_config.COMPUTE_DTYPE_TRAIN,
                        choices=["float32", "bfloat16"],
                        help="float32; bfloat16 is not ported yet")
    parser.add_argument("--vgg_weights", type=str, default=default_config.VGG_WEIGHTS_PATH,
                        help=".npz from tools/convert_vgg_weights.py (perceptual-loss weights)")
    parser.add_argument("--allow_random_vgg", action="store_true",
                        help="Explicitly allow training WITHOUT pretrained VGG19 weights: the "
                             "perceptual loss uses a seeded random VGG drawn with torch, whose "
                             "numbers are not the JAX package's random VGG's")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_data_parallel", action="store_true",
                        help="Accepted for parity; the port trains on one device")
    parser.add_argument("--pallas", dest="pallas", action="store_true", default=None,
                        help="Route the resblock AdaINs through the fused kernel (adain_pallas)")
    parser.add_argument("--no_pallas", dest="pallas", action="store_false",
                        help="Keep the resblock AdaINs on plain PyTorch")
    parser.add_argument("--profile_steps", type=int, default=0, help="Not ported yet")
    parser.add_argument("--r1_gamma", type=float, default=0.0, help="Not ported yet")
    parser.add_argument("--remat", action="store_true", help="Not ported yet")
    parser.add_argument("--device_data", action="store_true", help="Not ported yet")
    parser.add_argument("--style_recon_weight", type=float, default=0.0, help="Not ported yet")
    parser.add_argument("--diversity_weight", type=float, default=0.0, help="Not ported yet")
    parser.add_argument("--multihost", action="store_true", help="Not ported yet")
    parser.add_argument("--watch_freq", type=int, default=0, help="Not ported yet")
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


# Flags of features not ported yet, with the ROADMAP.md Queue 1 item that brings them.
# The train step's own options (--r1_gamma, --remat, --style_recon_weight,
# --diversity_weight, --compute_dtype bfloat16) are refused by make_train_step.
_NOT_PORTED = (
    ("resume", "--resume", "Queue 1 item 8"),
    ("wandb", "--wandb", "Queue 1 item 8"),
    ("profile_steps", "--profile_steps", "Queue 1 item 8"),
    ("device_data", "--device_data", "Queue 1 item 9"),
    ("multihost", "--multihost", "Queue 1 item 10"),
    ("watch_freq", "--watch_freq", "Queue 1 item 7"),
)


def check_ported_flags(cfg: TrainConfig) -> None:
    """Raise NotImplementedError for a flag whose feature is not ported yet."""
    for field, flag, item in _NOT_PORTED:
        if getattr(cfg, field):
            raise NotImplementedError(f"{flag} is not yet ported to msig_tpu_torch ({item})")


def main(cfg: TrainConfig) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    check_ported_flags(cfg)
    import torch

    from msig_tpu_torch import resolve_device

    try:
        resolve_device(cfg.device)
    except (RuntimeError, ValueError) as e:
        print(f"ERROR: {e}")
        return 1
    # float32 on the card means fp32: by default cuDNN runs fp32 convolutions in TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from msig_tpu_torch.data import MultiDomainDataset
    from msig_tpu_torch.train.trainer import Trainer

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

    dataset = MultiDomainDataset.build(cfg.source_dir, cfg.target_dir)
    print(f"Found {len(dataset.source_files)} source images")
    print(f"Total domains: {dataset.num_domains} (source: index 0; targets: "
          + ", ".join(f"{i} {n} ({len(dataset.target_files_by_domain[n])} images)"
                      for i, n in enumerate(dataset.domains) if i) + ")")
    trainer = Trainer(cfg, dataset)
    print("Starting multi-domain training...")
    try:
        trainer.train()
    except Exception as e:  # the reference prints the error and exits 1 (main.py:243-250)
        print(f"An error occurred during training: {e}")
        import traceback

        traceback.print_exc()
        return 1
    print(f"--- Multi-Domain Experiment {cfg.experiment_name} Completed ---")
    return 0

