"""Gram matrices for the VGG style loss (counterpart of ``msig_tpu/ops/gram.py``).

The reference flattens the batch axis into the rows of the feature matrix
(reference losses.py:70-78): for NCHW features ``F = reshape(x, [B*C, H*W])``
and the Gram is ``F @ F.T / (B*C*H*W)``, a ``[B*C, B*C]`` matrix that couples
the samples of a batch. One ``torch.matmul`` in fp32, as the JAX package
leaves it to XLA outside any kernel (TF32 must be off on the card for fp32).
"""

from __future__ import annotations

import torch


def gram_nchw(features: torch.Tensor) -> torch.Tensor:
    """Batch-coupled Gram of NCHW features: ``[B*C, B*C]`` in float32."""
    b, c, h, w = features.shape
    f = features.reshape(b * c, h * w).to(torch.float32)
    return torch.matmul(f, f.t()) / (b * c * h * w)


def gram_matrix(features_nhwc: torch.Tensor) -> torch.Tensor:
    """Batch-coupled Gram of NHWC features ``[B, H, W, C]``: ``[B*C, B*C]`` in float32."""
    return gram_nchw(features_nhwc.permute(0, 3, 1, 2))
