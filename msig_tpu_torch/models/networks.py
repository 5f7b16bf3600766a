"""The generator and the style encoder as torch modules.

Counterpart of ``msig_tpu/models/networks.py`` (reference model.py:9-151),
with the reference's module tree, so a reference-format state_dict loads with
``load_state_dict(strict=True)``:

  - ``StyleCycleGANGenerator``: ``content_encoder.{0,3,6}`` convs,
    ``decoder.{i}`` AdaIN resblocks (``conv1``, ``adain1.style_modulation``,
    ``conv2``, ``adain2.style_modulation``), ``decoder.{n}`` and
    ``decoder.{n+3}`` ConvTranspose, ``decoder.{n+6}`` the RGB conv;
  - ``MultiDomainStyleEncoder``: ``shared_layers.{0,2,4,6}`` convs and one
    1x1-conv branch per domain, ``domain_branches.{d}.0``.

The public forwards take and return NHWC, as the JAX modules do; inside, the
tensors are NCHW views. ``MultiDomainDiscriminator`` is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from msig_tpu_torch.models.layers import InstanceNorm, TorchConv, TorchConvTranspose, TorchDense
from msig_tpu_torch.ops.norm import adain_modulate


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class AdaIN(nn.Module):
    """``Linear(style_dim -> 2C)`` then ``gamma * IN(x) + beta`` (model.py:9-36).

    The first C outputs are gamma, the last C beta (torch ``chunk(2, dim=1)``)."""

    def __init__(self, channels: int, style_dim: int):
        super().__init__()
        self.style_modulation = TorchDense(style_dim, 2 * channels)

    def affine(self, style: torch.Tensor):
        return self.style_modulation(style).chunk(2, dim=-1)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.affine(style)
        return _nchw(adain_modulate(_nhwc(x), gamma, beta))


class AdaINResBlock(nn.Module):
    """conv3x3 -> AdaIN -> ReLU -> conv3x3 -> AdaIN -> + residual (model.py:39-55)."""

    def __init__(self, channels: int, style_dim: int):
        super().__init__()
        self.conv1 = TorchConv(channels, channels, 3, padding=1)
        self.adain1 = AdaIN(channels, style_dim)
        self.conv2 = TorchConv(channels, channels, 3, padding=1)
        self.adain2 = AdaIN(channels, style_dim)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.adain1(self.conv1(x), style))
        return self.adain2(self.conv2(h), style) + x


class StyleCycleGANGenerator(nn.Module):
    """Content encoder + style-injected decoder (model.py:121-151)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, style_dim: int = 256,
                 n_residual_blocks: int = 8):
        super().__init__()
        self.style_dim = style_dim
        self.n_residual_blocks = n_residual_blocks
        self.content_encoder = nn.Sequential(
            TorchConv(in_channels, 64, 7, padding=3, pad_mode="reflect"), InstanceNorm(), nn.ReLU(),
            TorchConv(64, 128, 4, strides=2, padding=1), InstanceNorm(), nn.ReLU(),
            TorchConv(128, 256, 4, strides=2, padding=1), InstanceNorm(), nn.ReLU(),
        )
        self.decoder = nn.ModuleList(
            [AdaINResBlock(256, style_dim) for _ in range(n_residual_blocks)] + [
                TorchConvTranspose(256, 128), InstanceNorm(), nn.ReLU(),
                TorchConvTranspose(128, 64), InstanceNorm(), nn.ReLU(),
                TorchConv(64, out_channels, 7, padding=3, pad_mode="reflect"), nn.Tanh(),
            ])

    def forward(self, content_image: torch.Tensor, style_code: torch.Tensor) -> torch.Tensor:
        """NHWC image in [-1, 1] + style [B, S] -> NHWC image in [-1, 1]."""
        h = self.content_encoder(_nchw(content_image))
        for layer in self.decoder:
            h = layer(h, style_code) if isinstance(layer, AdaINResBlock) else layer(h)
        return _nhwc(h)


class MultiDomainStyleEncoder(nn.Module):
    """Shared conv trunk + per-domain style heads (model.py:61-118).

    Every branch runs on the pooled features and each sample's
    ``domain_idx`` picks its row, as the reference does (model.py:108-116);
    ``domain_idx=None`` takes branch 0, as the JAX module does."""

    def __init__(self, style_dim: int = 256, num_domains: int = 2):
        super().__init__()
        self.style_dim = style_dim
        self.num_domains = num_domains
        layers = []
        cin = 3
        for feats in (64, 128, 256, 512):
            layers += [TorchConv(cin, feats, 4, strides=2, padding=1), nn.ReLU()]
            cin = feats
        self.shared_layers = nn.Sequential(*layers)
        self.domain_branches = nn.ModuleList(
            [nn.Sequential(TorchConv(512, style_dim, 1)) for _ in range(num_domains)])

    def forward(self, img: torch.Tensor, domain_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.shared_layers(_nchw(img))
        pooled = h.to(torch.float32).mean(dim=(2, 3), keepdim=True).to(h.dtype)  # [B, 512, 1, 1]
        all_styles = torch.stack([br(pooled).flatten(1) for br in self.domain_branches], dim=1)
        if domain_idx is None:
            return all_styles[:, 0]
        return all_styles[torch.arange(all_styles.shape[0], device=all_styles.device),
                          domain_idx.to(torch.long)]
