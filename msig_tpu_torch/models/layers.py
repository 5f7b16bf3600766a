"""Building-block layers with torch-default initialization.

Counterpart of ``msig_tpu/models/layers.py``. The modules are the stock torch
layers the reference uses, so their parameters carry the reference's names
and shapes (``weight`` OIHW, ``bias``) and their default init is the
reference's U(-1/sqrt(fan_in), 1/sqrt(fan_in)). They run on NCHW tensors; the
networks convert at their NHWC boundary.
"""

from __future__ import annotations

import torch
from torch import nn

from msig_tpu_torch.ops.norm import instance_norm


class TorchConv(nn.Conv2d):
    """``nn.Conv2d(k, s, p)``; ``pad_mode='reflect'`` for the generator's 7x7 convs."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, strides: int = 1,
                 padding: int = 0, pad_mode: str = "zeros", use_bias: bool = True):
        super().__init__(in_channels, features, kernel_size, stride=strides, padding=padding,
                         padding_mode=pad_mode, bias=use_bias)


class TorchConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d(k=4, s=2, p=1)``: an exact 2x upsampling stage.

    The weight is torch's ``[in, out, kh, kw]``; the JAX package stores the
    equivalent forward-conv kernel, flipped (see ``compat/from_jax.py``)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 4,
                 strides: int = 2, padding: int = 1):
        super().__init__(in_channels, features, kernel_size, stride=strides, padding=padding)


class TorchDense(nn.Linear):
    """``nn.Linear`` with torch's default init."""


class InstanceNorm(nn.Module):
    """Affine-free instance norm of an NCHW tensor (fp32 statistics)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
