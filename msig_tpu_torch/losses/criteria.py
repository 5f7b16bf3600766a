"""GAN / cycle / identity criteria (counterpart of ``msig_tpu/losses/criteria.py``).

LSGAN is the MSE against all-ones or all-zeros patch maps, cycle and identity
plain L1 (reference trainer.py:50-52, 85-86, 99-117), all means in fp32.
"""

from __future__ import annotations

import torch


def lsgan_real(pred: torch.Tensor) -> torch.Tensor:
    """MSE(pred, ones)."""
    return (pred.to(torch.float32) - 1.0).square().mean()


def lsgan_fake(pred: torch.Tensor) -> torch.Tensor:
    """MSE(pred, zeros)."""
    return pred.to(torch.float32).square().mean()


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.float32) - b.to(torch.float32)).abs().mean()
