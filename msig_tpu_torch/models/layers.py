"""Building-block layers with torch-default initialization.

Counterpart of ``msig_tpu/models/layers.py``. The modules are the stock torch
layers the reference uses, so their parameters carry the reference's names
and shapes (``weight`` OIHW, ``bias``) and their default init is the
reference's U(-1/sqrt(fan_in), 1/sqrt(fan_in)). They run on NCHW tensors; the
networks convert at their NHWC boundary.

Every conv, ConvTranspose and dense layer computes in its input's dtype: the
fp32 parameters are cast to it at the call, as the JAX layers cast input and
kernel to their compute dtype (``msig_tpu/models/layers.py:96-97, 218-225,
249-250``). A bf16 train step feeds bf16 images, so every network runs its
products in bf16 on fp32 master parameters.

``MSIG_CONV_VJP`` routes the resblock trunk's 3x3 convs as the JAX package's
``TorchConv`` does (``msig_tpu/models/layers.py:98-130``): 0 the stock conv,
1 the fused backward of ``ops/conv3x3_vjp.py``, 2 the conv + instance norm +
modulation unit with its one fused backward. Only ``0``, ``1`` and ``2`` are
accepted; the JAX package maps any other value to 1. The kernel routes take
the unit's input and its taps in the input's dtype, as the JAX layers pass
them: in a bf16 step the fused backwards run their bf16 entries.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from msig_tpu_torch.ops import conv3x3_vjp
from msig_tpu_torch.ops.norm import adain_modulate, instance_norm


def conv_vjp_level() -> int:
    """``MSIG_CONV_VJP`` (default 0), read strictly: ``0``, ``1`` or ``2``, else ValueError."""
    v = os.environ.get("MSIG_CONV_VJP", "0")
    if v not in ("0", "1", "2"):
        raise ValueError(f"MSIG_CONV_VJP must be 0, 1 or 2, got {v!r}")
    return int(v)


class TorchConv(nn.Conv2d):
    """``nn.Conv2d(k, s, p)``; ``pad_mode='reflect'`` for the generator's 7x7 convs.

    ``pre_relu``: :meth:`adain_unit` applies relu to its input first (the
    resblock's relu -> conv2), so that the fused backward can take the mask."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, strides: int = 1,
                 padding: int = 0, pad_mode: str = "zeros", use_bias: bool = True,
                 pre_relu: bool = False):
        super().__init__(in_channels, features, kernel_size, stride=strides, padding=padding,
                         padding_mode=pad_mode, bias=use_bias)
        self.pre_relu = pre_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  None if self.bias is None else self.bias.to(x.dtype))

    def adain_unit(self, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, level: int,
                   use_pallas: bool) -> torch.Tensor:
        """``gamma * IN(conv([relu](x))) + beta`` on dense NHWC x, routed by ``level``
        (``MSIG_CONV_VJP``) as ``TorchConv.__call__`` with ``adain_affine`` routes it.

        At level 2 the conv bias is skipped: instance norm removes it, so its
        gradient is exactly zero (the parameter stays, for the state_dict)."""
        w = self.weight.to(x.dtype).permute(2, 3, 1, 0)  # HWIO view of the OIHW parameter
        pad = ((self.padding[0],) * 2, (self.padding[1],) * 2)
        if level and conv3x3_vjp.supported(tuple(x.shape), tuple(w.shape), self.stride[0], pad,
                                           self.padding_mode):
            if level >= 2:
                unit = conv3x3_vjp.relu_conv3x3_adain if self.pre_relu else conv3x3_vjp.conv3x3_adain
                return unit(x, w, gamma, beta)
            y = (conv3x3_vjp.relu_conv3x3 if self.pre_relu else conv3x3_vjp.conv3x3_same)(x, w)
        else:
            xin = torch.relu(x) if self.pre_relu else x
            y = F.conv2d(xin.permute(0, 3, 1, 2), self.weight.to(x.dtype), None, self.stride,
                         self.padding)
            y = y.permute(0, 2, 3, 1).contiguous()
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return adain_modulate(y, gamma, beta, use_pallas=use_pallas)


class TorchConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d(k=4, s=2, p=1)``: an exact 2x upsampling stage.

    The weight is torch's ``[in, out, kh, kw]``; the JAX package stores the
    equivalent forward-conv kernel, flipped (see ``compat/from_jax.py``)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 4,
                 strides: int = 2, padding: int = 1):
        super().__init__(in_channels, features, kernel_size, stride=strides, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride,
                                  self.padding, self.output_padding, self.groups, self.dilation)


class TorchDense(nn.Linear):
    """``nn.Linear`` with torch's default init."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """``where(x >= 0, x, slope * x)``, as the JAX package writes it (its gradient
    at exactly 0 is 1, where ``F.leaky_relu``'s is the slope)."""
    return torch.where(x >= 0, x, negative_slope * x)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.negative_slope)


class InstanceNorm(nn.Module):
    """Affine-free instance norm of an NCHW tensor (fp32 statistics)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
