"""Training and inference configuration of the port.

Copies the constants of ``msig_tpu/config.py`` that the two CLIs read (same
names and defaults, reference config.py:1-67), its ``TrainConfig`` and its
``InferenceConfig``, each with a ``device`` field: the port runs on ``cuda``
unless the caller asks for ``cpu``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

GPU = 0  # kept for CLI-flag parity; the device is chosen with --device
IMAGE_SIZE = 256
N_RESIDUAL_BLOCKS = 8
STYLE_DIM = 256

# Training (reference config.py and trainer.py)
SOURCE_DIR = "./data/src/Tomato_Healthy"
TARGET_DIR = "./data/ref2"
SAVE_DIR_BASE = "./results"
NUM_EPOCHS = 200
BATCH_SIZE = 4
SAVE_FREQ = 100
LEARNING_RATE_G = 2e-4
LEARNING_RATE_D = 1e-4
LOSS_WEIGHTS = {"gan": 1.0, "cycle": 10.0, "identity": 5.0, "content": 1.0, "style": 1.0}
TRAINING_USE_EMA = True
RESUME_CHECKPOINT = None
EMA_BETA = 0.995
WARMUP_EPOCHS = 10
DECAY_EPOCHS = 100
GRAD_CLIP_NORM = 1.0
ADAM_B1 = 0.5
ADAM_B2 = 0.999
LR_ETA_MIN = 1e-6
CHECKPOINT_EVERY_EPOCHS = 10
COMPUTE_DTYPE_TRAIN = "float32"
VGG_WEIGHTS_PATH = None

INFERENCE_INPUT_DIR = "./synthetic_target/Tomato_healthy"
INFERENCE_TARGET_DOMAINS_DIR = "./data/ref"
INFERENCE_CHECKPOINT_DIR = "./results/multidomain_exp/checkpoints/epoch_180"
INFERENCE_OUTPUT_DIR = "./output/multidomain_exp/interpolate"
INFERENCE_TARGET_DOMAIN = "Tomato_Bacterial_spot"
INFERENCE_STYLE_MODE = "interpolate"
INFERENCE_NOISE_LEVEL = 0.1
INFERENCE_BATCH_SIZE = 64
COMPUTE_DTYPE_INFER = "bfloat16"
USE_PALLAS_ADAIN = False
DEVICE = "cuda"


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Fully-resolved inference configuration (immutable)."""

    input_dir: str = INFERENCE_INPUT_DIR
    ref_domains_dir: str = INFERENCE_TARGET_DOMAINS_DIR
    checkpoint_dir: str = INFERENCE_CHECKPOINT_DIR
    output_dir: str = INFERENCE_OUTPUT_DIR
    target_domain: str = INFERENCE_TARGET_DOMAIN
    gpu: int = GPU
    image_size: int = IMAGE_SIZE
    style_dim: int = STYLE_DIM
    style_mode: str = INFERENCE_STYLE_MODE
    noise_level: float = INFERENCE_NOISE_LEVEL
    max_styles: Optional[int] = None
    save_grid: bool = False
    batch_size: int = INFERENCE_BATCH_SIZE
    compute_dtype: str = COMPUTE_DTYPE_INFER
    use_pallas: bool = USE_PALLAS_ADAIN
    n_residual_blocks: int = N_RESIDUAL_BLOCKS
    seed: int = 0
    mapping_params: Optional[str] = None
    latent_dim: int = 16
    # Optional int8 quantized generator ('int8' | None).
    quantize: Optional[str] = None
    data_parallel: bool = False
    device: str = DEVICE


def default_experiment_name(loss_weights: Dict[str, float]) -> str:
    """``multi_domain_<key><value with '.' as 'p'>_...`` over the sorted weights
    (reference main.py:139-144)."""
    parts = [f"{k}{str(v).replace('.', 'p')}" for k, v in sorted(loss_weights.items())]
    return "multi_domain_" + "_".join(parts)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Fully-resolved training configuration (immutable); the fields of
    ``msig_tpu/config.py::TrainConfig`` plus ``device``."""

    source_dir: str = SOURCE_DIR
    target_dir: str = TARGET_DIR
    save_dir_base: str = SAVE_DIR_BASE
    resume: Optional[str] = RESUME_CHECKPOINT
    exp_name: Optional[str] = None
    gpu: int = GPU
    epochs: int = NUM_EPOCHS
    image_size: int = IMAGE_SIZE
    batch_size: int = BATCH_SIZE
    save_freq: int = SAVE_FREQ
    lr_g: float = LEARNING_RATE_G
    lr_d: float = LEARNING_RATE_D
    loss_weights: Dict[str, float] = dataclasses.field(default_factory=lambda: dict(LOSS_WEIGHTS))
    use_ema: bool = TRAINING_USE_EMA
    wandb: bool = False
    style_dim: int = STYLE_DIM
    n_residual_blocks: int = N_RESIDUAL_BLOCKS
    ema_beta: float = EMA_BETA
    warmup_epochs: int = WARMUP_EPOCHS
    decay_epochs: int = DECAY_EPOCHS
    grad_clip_norm: float = GRAD_CLIP_NORM
    adam_b1: float = ADAM_B1
    adam_b2: float = ADAM_B2
    lr_eta_min: float = LR_ETA_MIN
    checkpoint_every: int = CHECKPOINT_EVERY_EPOCHS
    seed: int = 0
    compute_dtype: str = COMPUTE_DTYPE_TRAIN
    use_pallas: bool = USE_PALLAS_ADAIN
    vgg_weights_path: Optional[str] = VGG_WEIGHTS_PATH
    data_parallel: bool = True
    profile_steps: int = 0
    r1_gamma: float = 0.0
    remat: bool = False
    device_data: bool = False
    multihost: bool = False
    style_recon_weight: float = 0.0
    diversity_weight: float = 0.0
    allow_random_vgg: bool = False
    watch_freq: int = 0
    ema_snapshot_every: int = 0
    device: str = DEVICE

    @property
    def experiment_name(self) -> str:
        return self.exp_name or default_experiment_name(self.loss_weights)

    @staticmethod
    def parse_loss_weights(s: str) -> Dict[str, float]:
        """Loss weights arrive as a JSON string flag (reference main.py:124-125)."""
        return {str(k): float(v) for k, v in json.loads(s).items()}
