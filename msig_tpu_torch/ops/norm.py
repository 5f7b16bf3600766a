"""Instance normalization and AdaIN modulation over NHWC maps.

Counterpart of ``msig_tpu/ops/norm.py``: statistics per (sample, channel)
over the spatial axes in float32, biased variance, eps 1e-5 (torch
``nn.InstanceNorm2d`` semantics), output in the input's dtype. The public
functions take NHWC; a module holding an NCHW tensor passes a permuted view.
"""

from __future__ import annotations

import torch

_EPS = 1e-5


def _stats(x: torch.Tensor, eps: float):
    xf = x.to(torch.float32)
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    return xf, mean, torch.rsqrt(var + eps)


def instance_norm(x: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Instance norm without affine over NHWC ``[B, H, W, C]``."""
    xf, mean, inv = _stats(x, eps)
    return ((xf - mean) * inv).to(x.dtype)


def adain_modulate(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = _EPS, use_pallas: bool = False) -> torch.Tensor:
    """``gamma * IN(x) + beta`` over NHWC; gamma and beta are ``[B, C]``.

    ``use_pallas`` routes an x in the fused kernel's domain to
    ``ops/adain_pallas.py`` (forward and backward kernels), as
    ``msig_tpu/ops/norm.py:67-71`` routes to the Pallas kernel."""
    if use_pallas:
        from msig_tpu_torch.ops import adain_pallas

        if adain_pallas.supported(x):
            return adain_pallas.adain_pallas(x, gamma, beta, eps=eps)
    xf, mean, inv = _stats(x, eps)
    scale = gamma.to(torch.float32)[:, None, None, :] * inv
    shift = beta.to(torch.float32)[:, None, None, :] - mean * scale
    return (xf * scale + shift).to(x.dtype)
