"""Carry flax parameter trees of the JAX package into the port's state_dicts.

The rules are those of ``msig_tpu/compat/torch_export.py:49-111``, kept here
so the port needs nothing of the JAX package:

  - Conv2d kernel HWIO ``[kh, kw, I, O]`` -> weight OIHW ``[O, I, kh, kw]``;
  - ConvTranspose2d: the flax kernel is the flipped equivalent forward conv,
    so flip kh/kw back, then ``[I, O, kh, kw]``;
  - Linear kernel ``[I, O]`` -> weight ``[O, I]``;
  - the style encoder's stacked ``[512, D*S]`` head -> one 1x1 conv per domain.

Input trees are flax variable dicts, ``{"params": {...}}``, holding numpy
arrays (or anything ``np.asarray`` takes); the demo checkpoint's flat
``'/'``-joined keys go through :func:`unflatten` first.
The results load into the port's modules with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

Params = Mapping[str, Any]


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{'gen/params/enc_conv0/kernel': array, ...}`` -> nested dicts."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _conv(sd: Dict[str, torch.Tensor], prefix: str, p: Params) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"], np.float32), (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv_t(sd: Dict[str, torch.Tensor], prefix: str, p: Params) -> None:
    kernel = np.flip(np.asarray(p["kernel"], np.float32), axis=(0, 1))
    sd[f"{prefix}.weight"] = _t(np.transpose(kernel, (2, 3, 0, 1)))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _linear(sd: Dict[str, torch.Tensor], prefix: str, p: Params) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"], np.float32).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def generator_state_dict(params: Params, n_residual_blocks: int = 8) -> Dict[str, torch.Tensor]:
    """flax StyleCycleGANGenerator params -> the port's generator state_dict."""
    p = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "content_encoder.0", p["enc_conv0"])
    _conv(sd, "content_encoder.3", p["enc_conv1"])
    _conv(sd, "content_encoder.6", p["enc_conv2"])
    for i in range(n_residual_blocks):
        rb = p[f"resblock{i}"]
        _conv(sd, f"decoder.{i}.conv1", rb["conv1"])
        _conv(sd, f"decoder.{i}.conv2", rb["conv2"])
        _linear(sd, f"decoder.{i}.adain1.style_modulation", rb["adain1"]["style_mod"])
        _linear(sd, f"decoder.{i}.adain2.style_modulation", rb["adain2"]["style_mod"])
    n = n_residual_blocks
    _conv_t(sd, f"decoder.{n}", p["dec_up0"])
    _conv_t(sd, f"decoder.{n + 3}", p["dec_up1"])
    _conv(sd, f"decoder.{n + 6}", p["dec_conv_out"])
    return sd


def style_encoder_state_dict(params: Params, num_domains: int,
                             style_dim: int) -> Dict[str, torch.Tensor]:
    """flax MultiDomainStyleEncoder params -> the port's style-encoder state_dict."""
    p = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    for i, idx in enumerate((0, 2, 4, 6)):
        _conv(sd, f"shared_layers.{idx}", p[f"conv{i}"])
    kernel = np.asarray(p["branches"]["kernel"], np.float32)  # [512, D*S]
    bias = np.asarray(p["branches"]["bias"], np.float32)
    if kernel.shape[1] != num_domains * style_dim:
        raise ValueError(
            f"style head has {kernel.shape[1]} outputs, expected num_domains*style_dim = "
            f"{num_domains}*{style_dim}")
    for d in range(num_domains):
        cols = slice(d * style_dim, (d + 1) * style_dim)
        sd[f"domain_branches.{d}.0.weight"] = _t(kernel[:, cols].T[:, :, None, None])
        sd[f"domain_branches.{d}.0.bias"] = _t(bias[cols])
    return sd
