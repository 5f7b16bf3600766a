"""Carry flax parameter trees of the JAX package into the port's state_dicts.

The rules are those of ``msig_tpu/compat/torch_export.py:49-111``, kept here
so the port needs nothing of the JAX package:

  - Conv2d kernel HWIO ``[kh, kw, I, O]`` -> weight OIHW ``[O, I, kh, kw]``;
  - ConvTranspose2d: the flax kernel is the flipped equivalent forward conv,
    so flip kh/kw back, then ``[I, O, kh, kw]``;
  - Linear kernel ``[I, O]`` -> weight ``[O, I]``;
  - the style encoder's stacked ``[512, D*S]`` head -> one 1x1 conv per domain;
  - the discriminator's stacked ``[4, 4, 512, D]`` head -> one conv per domain.

Input trees are flax variable dicts, ``{"params": {...}}``, holding numpy
arrays (or anything ``np.asarray`` takes); the demo checkpoint's flat
``'/'``-joined keys go through :func:`unflatten` first.
The results load into the port's modules with ``load_state_dict(strict=True)``.

The reverse direction (``*_params``: a port state_dict, or anything of the
same layout such as its Adam moments, -> a flax tree of numpy arrays) follows
``msig_tpu/compat/torch_import.py``; the trainer writes the demo-npz snapshot
with it, and the tests compare trees leaf by leaf with it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

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


def discriminator_state_dict(params: Params, num_domains: int) -> Dict[str, torch.Tensor]:
    """flax MultiDomainDiscriminator params -> the port's discriminator state_dict."""
    p = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    for i, idx in enumerate((0, 2, 5, 8)):
        _conv(sd, f"shared_layers.{idx}", p[f"conv{i}"])
    kernel = np.asarray(p["heads"]["kernel"], np.float32)  # [4, 4, 512, D]
    bias = np.asarray(p["heads"]["bias"], np.float32)
    if kernel.shape[-1] != num_domains:
        raise ValueError(f"discriminator has {kernel.shape[-1]} heads, expected {num_domains}")
    for d in range(num_domains):
        sd[f"domain_branches.{d}.1.weight"] = _t(np.transpose(kernel[:, :, :, d], (2, 0, 1))[None])
        sd[f"domain_branches.{d}.1.bias"] = _t(bias[d:d + 1])
    return sd


def vgg_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """The JAX package's VGG prefix params ``{"conv{i}": {"kernel", "bias"}}`` (the
    layout of ``msig_tpu/losses/vgg.py``) -> the state_dict of ``losses.vgg.VGGPrefix``."""
    sd: Dict[str, torch.Tensor] = {}
    for name in sorted(params):
        _conv(sd, name, params[name])
    return sd


# ------------------------------------------------------ port -> flax layout

Tensorish = Union[torch.Tensor, np.ndarray]


def _np(x: Tensorish) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)


def _conv_p(sd, prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": np.ascontiguousarray(np.transpose(_np(sd[f"{prefix}.weight"]), (2, 3, 1, 0)))}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _conv_t_p(sd, prefix: str) -> Dict[str, np.ndarray]:
    w = _np(sd[f"{prefix}.weight"])  # [I, O, kh, kw]
    kernel = np.flip(np.transpose(w, (2, 3, 0, 1)), axis=(0, 1))
    return {"kernel": np.ascontiguousarray(kernel), "bias": _np(sd[f"{prefix}.bias"])}


def _linear_p(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": np.ascontiguousarray(_np(sd[f"{prefix}.weight"]).T),
            "bias": _np(sd[f"{prefix}.bias"])}


def generator_params(sd: Mapping[str, Tensorish], n_residual_blocks: int = 8) -> Params:
    """The port's generator state_dict -> flax StyleCycleGANGenerator params."""
    p: Dict[str, Any] = {
        "enc_conv0": _conv_p(sd, "content_encoder.0"),
        "enc_conv1": _conv_p(sd, "content_encoder.3"),
        "enc_conv2": _conv_p(sd, "content_encoder.6"),
    }
    for i in range(n_residual_blocks):
        p[f"resblock{i}"] = {
            "conv1": _conv_p(sd, f"decoder.{i}.conv1"),
            "conv2": _conv_p(sd, f"decoder.{i}.conv2"),
            "adain1": {"style_mod": _linear_p(sd, f"decoder.{i}.adain1.style_modulation")},
            "adain2": {"style_mod": _linear_p(sd, f"decoder.{i}.adain2.style_modulation")},
        }
    n = n_residual_blocks
    p["dec_up0"] = _conv_t_p(sd, f"decoder.{n}")
    p["dec_up1"] = _conv_t_p(sd, f"decoder.{n + 3}")
    p["dec_conv_out"] = _conv_p(sd, f"decoder.{n + 6}")
    return {"params": p}


def style_encoder_params(sd: Mapping[str, Tensorish], num_domains: int) -> Params:
    """The port's style-encoder state_dict -> flax params (stacked ``[512, D*S]`` head)."""
    p: Dict[str, Any] = {f"conv{i}": _conv_p(sd, f"shared_layers.{idx}")
                         for i, idx in enumerate((0, 2, 4, 6))}
    ws = [_np(sd[f"domain_branches.{d}.0.weight"])[:, :, 0, 0].T for d in range(num_domains)]
    bs = [_np(sd[f"domain_branches.{d}.0.bias"]) for d in range(num_domains)]
    p["branches"] = {"kernel": np.concatenate(ws, axis=1), "bias": np.concatenate(bs)}
    return {"params": p}


def discriminator_params(sd: Mapping[str, Tensorish], num_domains: int) -> Params:
    """The port's discriminator state_dict -> flax params (stacked ``[4, 4, 512, D]`` head)."""
    p: Dict[str, Any] = {f"conv{i}": _conv_p(sd, f"shared_layers.{idx}")
                         for i, idx in enumerate((0, 2, 5, 8))}
    ks = [np.transpose(_np(sd[f"domain_branches.{d}.1.weight"])[0], (1, 2, 0))
          for d in range(num_domains)]
    bs = [_np(sd[f"domain_branches.{d}.1.bias"]) for d in range(num_domains)]
    p["heads"] = {"kernel": np.stack(ks, axis=-1), "bias": np.concatenate(bs)}
    return {"params": p}
