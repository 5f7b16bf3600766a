"""Pure schedules: cosine LR + dynamic loss-weight warmup/decay.

A copy of ``msig_tpu/train/schedule.py``: pure functions of the epoch index,
evaluated on the host once per epoch.

  - :func:`cosine_lr` is the closed form of torch ``CosineAnnealingLR``
    stepped once per epoch (reference trainer.py:64-65).
  - :func:`loss_weight_factor` reproduces ``DynamicWeightScheduler``:
    warmup ``min(1, (epoch+1)/warmup)`` then, from ``epoch >= warmup`` on,
    cosine decay from 1 down to 0.1 over ``decay_epochs``
    (reference utils.py:110-134).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

# Canonical order of the loss-weight vector handed to the train step.
WEIGHT_KEYS: List[str] = ["gan", "cycle", "identity", "content", "style"]


def cosine_lr(base_lr: float, epoch: int, total_epochs: int, eta_min: float = 1e-6) -> float:
    if total_epochs <= 0:
        return base_lr
    t = min(epoch, total_epochs)
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t / total_epochs)) / 2


def loss_weight_factor(epoch: int, warmup_epochs: int = 10, decay_epochs: int = 100) -> float:
    # warmup_epochs=0 disables warmup (factor 1 from epoch 0) instead of
    # dividing by zero; the reference hardcodes 10 (utils.py:110-134).
    warmup = min(1.0, (epoch + 1) / warmup_epochs) if warmup_epochs > 0 else 1.0
    decay = 1.0
    if epoch >= warmup_epochs:
        progress = min(1.0, (epoch - warmup_epochs) / decay_epochs)
        cosine_decay = 0.5 * (1 + math.cos(math.pi * progress))
        decay = 0.1 + 0.9 * cosine_decay
    return warmup * decay


def current_loss_weights(
    init_weights: Dict[str, float],
    epoch: int,
    warmup_epochs: int = 10,
    decay_epochs: int = 100,
) -> Dict[str, float]:
    f = loss_weight_factor(epoch, warmup_epochs, decay_epochs)
    return {k: v * f for k, v in init_weights.items()}


def weights_vector(weights: Dict[str, float], keys: Sequence[str] = WEIGHT_KEYS) -> List[float]:
    return [float(weights[k]) for k in keys]
