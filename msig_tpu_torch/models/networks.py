"""The generator and the style encoder as torch modules.

Counterpart of ``msig_tpu/models/networks.py`` (reference model.py:9-151),
with the reference's module tree, so a reference-format state_dict loads with
``load_state_dict(strict=True)``:

  - ``StyleCycleGANGenerator``: ``content_encoder.{0,3,6}`` convs,
    ``decoder.{i}`` AdaIN resblocks (``conv1``, ``adain1.style_modulation``,
    ``conv2``, ``adain2.style_modulation``), ``decoder.{n}`` and
    ``decoder.{n+3}`` ConvTranspose, ``decoder.{n+6}`` the RGB conv;
  - ``MultiDomainStyleEncoder``: ``shared_layers.{0,2,4,6}`` convs and one
    1x1-conv branch per domain, ``domain_branches.{d}.0``;
  - ``MultiDomainDiscriminator``: ``shared_layers.{0,2,5,8}`` convs and one
    head per domain, ``domain_branches.{d}.1`` after its ``ZeroPad2d``.

The public forwards take and return NHWC, as the JAX modules do; inside, the
tensors are NCHW views. The resblock trunk runs on dense NHWC instead when
``MSIG_CONV_VJP`` is 1 or 2 or ``use_pallas`` is set, for the kernels there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from msig_tpu_torch.models.layers import (
    InstanceNorm,
    LeakyReLU,
    TorchConv,
    TorchConvTranspose,
    TorchDense,
    conv_vjp_level,
)
from msig_tpu_torch.ops.norm import adain_modulate


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class AdaIN(nn.Module):
    """``Linear(style_dim -> 2C)`` then ``gamma * IN(x) + beta`` (model.py:9-36).

    The first C outputs are gamma, the last C beta (torch ``chunk(2, dim=1)``).
    :meth:`affine` gives (gamma, beta) for a conv that applies the modulation
    itself (``TorchConv.adain_unit``); ``use_pallas`` routes the modulation to
    the fused kernel where it is supported."""

    def __init__(self, channels: int, style_dim: int, use_pallas: bool = False):
        super().__init__()
        self.use_pallas = use_pallas
        self.style_modulation = TorchDense(style_dim, 2 * channels)

    def affine(self, style: torch.Tensor):
        return self.style_modulation(style).chunk(2, dim=-1)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.affine(style)
        return _nchw(adain_modulate(_nhwc(x), gamma, beta, use_pallas=self.use_pallas))


class AdaINResBlock(nn.Module):
    """conv3x3 -> AdaIN -> ReLU -> conv3x3 -> AdaIN -> + residual (model.py:39-55).

    ``forward`` (NCHW) is the stock chain. ``forward_nhwc`` takes the JAX
    structure (``networks.py:79-96``): the AdaINs give the affines, the convs
    apply them (``TorchConv.adain_unit``), and the relu is conv2's
    ``pre_relu``, so that ``MSIG_CONV_VJP`` and ``use_pallas`` can route each
    site to its kernels."""

    def __init__(self, channels: int, style_dim: int, use_pallas: bool = False):
        super().__init__()
        self.use_pallas = use_pallas
        self.conv1 = TorchConv(channels, channels, 3, padding=1)
        self.adain1 = AdaIN(channels, style_dim, use_pallas)
        self.conv2 = TorchConv(channels, channels, 3, padding=1, pre_relu=True)
        self.adain2 = AdaIN(channels, style_dim, use_pallas)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.adain1(self.conv1(x), style))
        return self.adain2(self.conv2(h), style) + x

    def forward_nhwc(self, x: torch.Tensor, style: torch.Tensor, level: int) -> torch.Tensor:
        """The block on dense NHWC x, its sites routed by ``level`` (``MSIG_CONV_VJP``)."""
        g1, b1 = self.adain1.affine(style)
        g2, b2 = self.adain2.affine(style)
        h = self.conv1.adain_unit(x, g1, b1, level, self.use_pallas)
        h = self.conv2.adain_unit(h, g2, b2, level, self.use_pallas)
        return h + x


class StyleCycleGANGenerator(nn.Module):
    """Content encoder + style-injected decoder (model.py:121-151)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, style_dim: int = 256,
                 n_residual_blocks: int = 8, use_pallas: bool = False):
        super().__init__()
        self.style_dim = style_dim
        self.n_residual_blocks = n_residual_blocks
        self.use_pallas = use_pallas
        self.content_encoder = nn.Sequential(
            TorchConv(in_channels, 64, 7, padding=3, pad_mode="reflect"), InstanceNorm(), nn.ReLU(),
            TorchConv(64, 128, 4, strides=2, padding=1), InstanceNorm(), nn.ReLU(),
            TorchConv(128, 256, 4, strides=2, padding=1), InstanceNorm(), nn.ReLU(),
        )
        self.decoder = nn.ModuleList(
            [AdaINResBlock(256, style_dim, use_pallas) for _ in range(n_residual_blocks)] + [
                TorchConvTranspose(256, 128), InstanceNorm(), nn.ReLU(),
                TorchConvTranspose(128, 64), InstanceNorm(), nn.ReLU(),
                TorchConv(64, out_channels, 7, padding=3, pad_mode="reflect"), nn.Tanh(),
            ])

    def forward(self, content_image: torch.Tensor, style_code: torch.Tensor) -> torch.Tensor:
        """NHWC image in [-1, 1] + style [B, S] -> NHWC image in [-1, 1].

        With ``MSIG_CONV_VJP`` 0 and ``use_pallas`` off the trunk is the stock
        NCHW chain; otherwise it runs on one dense NHWC copy of the encoder's
        output, through the kernels' routes."""
        h = self.content_encoder(_nchw(content_image))
        n, level = self.n_residual_blocks, conv_vjp_level()
        if level or self.use_pallas:
            t = _nhwc(h).contiguous()
            for block in self.decoder[:n]:
                t = block.forward_nhwc(t, style_code, level)
            h = _nchw(t)
        else:
            for block in self.decoder[:n]:
                h = block(h, style_code)
        for layer in self.decoder[n:]:
            h = layer(h)
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


class MultiDomainDiscriminator(nn.Module):
    """PatchGAN with a shared trunk and per-domain heads (model.py:154-213).

    Trunk: conv4x4/s2 3->64 (no IN), 64->128, 128->256, 256->512 with IN, each
    followed by LeakyReLU(0.2). Heads: per domain ``ZeroPad2d((1, 0, 1, 0))`` +
    conv4x4 pad 1, i.e. a conv padded ((2, 1), (2, 1)); they run as one conv
    over the stacked head weights (the JAX package's stacked head), and each
    sample's ``domain_idx`` picks its map. A 256² input gives [B, 16, 16, 1]."""

    def __init__(self, in_channels: int = 3, num_domains: int = 2):
        super().__init__()
        self.num_domains = num_domains
        layers = []
        cin = in_channels
        for feats, norm in ((64, False), (128, True), (256, True), (512, True)):
            layers.append(TorchConv(cin, feats, 4, strides=2, padding=1))
            if norm:
                layers.append(InstanceNorm())
            layers.append(LeakyReLU(0.2))
            cin = feats
        self.shared_layers = nn.Sequential(*layers)
        self.domain_branches = nn.ModuleList(
            [nn.Sequential(nn.ZeroPad2d((1, 0, 1, 0)), TorchConv(512, 1, 4, padding=1))
             for _ in range(num_domains)])

    def forward(self, img: torch.Tensor, domain_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.shared_layers(_nchw(img))
        heads = [br[1] for br in self.domain_branches]
        weight = torch.cat([hd.weight for hd in heads])  # [D, 512, 4, 4]
        bias = torch.cat([hd.bias for hd in heads])
        all_heads = F.conv2d(F.pad(h, (2, 1, 2, 1)), weight, bias)  # [B, D, H', W']
        if domain_idx is None:
            return _nhwc(all_heads[:, 0:1])
        rows = torch.arange(all_heads.shape[0], device=all_heads.device)
        return _nhwc(all_heads[rows, domain_idx.to(torch.long)][:, None])
