"""Inference configuration of the port.

Copies the constants of ``msig_tpu/config.py`` that the inference CLI reads
(same names and defaults, reference config.py:1-67) and its
``InferenceConfig``, plus a ``device`` field: the port runs on ``cuda``
unless the caller asks for ``cpu``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

GPU = 0  # kept for CLI-flag parity; the device is chosen with --device
IMAGE_SIZE = 256
N_RESIDUAL_BLOCKS = 8
STYLE_DIM = 256

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
