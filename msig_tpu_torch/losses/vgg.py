"""VGG19-prefix perceptual features + style/content losses.

Counterpart of ``msig_tpu/losses/vgg.py`` (reference losses.py). The reference's
layers ``relu_1_1 ... relu_5_1`` are VGG19's first five ReLUs, and its content
layer ``relu_4_1`` is the fourth of them, so only the first five convs and two
max pools of VGG19 are run: conv1_1, conv1_2, pool, conv2_1, conv2_2, pool,
conv3_1. Style loss: L1 between the batch-coupled Grams of (generated,
real_style) at all five layers; content loss: L1 between the fourth layer's
features of (generated, real_content). Images come in [-1, 1] NHWC and are
mapped to [0, 1] and ImageNet-normalized; the convs run in the images' dtype,
the Grams and the L1 means in fp32.

Weights: ``load_vgg_params`` reads the ``conv{i}_kernel`` / ``conv{i}_bias``
npz that ``tools/convert_vgg_weights.py`` writes (HWIO). Without one,
``init_random_vgg`` draws a seeded random VGG from a ``torch.Generator``: it
is deterministic, but its numbers are not those of the JAX package's random
VGG (``jax.random``); tests carry the JAX arrays across instead. Each
constructor takes the device as a required keyword (a missing card raises).
"""

from __future__ import annotations

import logging
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from msig_tpu_torch import resolve_device
from msig_tpu_torch.ops.gram import gram_nchw

logger = logging.getLogger(__name__)

# Channel plan of the VGG19 prefix: conv index -> (cin, cout).
_VGG_PREFIX: List[Tuple[int, int]] = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256)]
_POOL_AFTER = {1, 3}  # 2x2/s2 max pool after the ReLU of convs 1 and 3
_CONTENT_INDEX = 3    # the reference's 'relu_4_1'

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class VGGPrefix(nn.Module):
    """The five 3x3 convs of the VGG19 prefix, ``conv0`` ... ``conv4``; frozen."""

    def __init__(self):
        super().__init__()
        for i, (cin, cout) in enumerate(_VGG_PREFIX):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, 3, padding=1))
        self.requires_grad_(False)

    def features(self, x: torch.Tensor, upto: int = 5) -> List[torch.Tensor]:
        """ReLU outputs (NCHW) of the first ``upto`` convs for a normalized NCHW
        input, computed in its dtype (the fp32 weights cast to it)."""
        feats: List[torch.Tensor] = []
        for i in range(upto):
            conv = getattr(self, f"conv{i}")
            x = torch.relu(F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=1))
            feats.append(x)
            if i in _POOL_AFTER and i + 1 < upto:
                x = F.max_pool2d(x, 2)
        return feats


def init_random_vgg(seed: int = 1234, *, device: str) -> VGGPrefix:
    """Seeded random VGG: kernel and bias of each conv from U(-1/sqrt(9*cin), +),
    torch's default distribution, drawn in order from ``torch.Generator(seed)``."""
    gen = torch.Generator().manual_seed(seed)
    vgg = VGGPrefix()
    with torch.no_grad():
        for i, (cin, _) in enumerate(_VGG_PREFIX):
            conv = getattr(vgg, f"conv{i}")
            bound = 1.0 / math.sqrt(9 * cin)
            for t in (conv.weight, conv.bias):
                t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=gen))
    return vgg.to(resolve_device(device))


def load_vgg_params(path: str, *, device: str) -> VGGPrefix:
    """Pretrained weights from the ``conv{i}_kernel`` (HWIO) / ``conv{i}_bias`` npz."""
    dev = resolve_device(device)
    vgg = VGGPrefix()
    with np.load(path) as data, torch.no_grad():
        for i, (cin, cout) in enumerate(_VGG_PREFIX):
            kernel = np.asarray(data[f"conv{i}_kernel"], np.float32)
            if kernel.shape != (3, 3, cin, cout):
                raise ValueError(f"{path}: conv{i}_kernel has shape {kernel.shape}, "
                                 f"expected {(3, 3, cin, cout)}")
            conv = getattr(vgg, f"conv{i}")
            conv.weight.copy_(torch.from_numpy(np.transpose(kernel, (3, 2, 0, 1)).copy()))
            conv.bias.copy_(torch.from_numpy(np.asarray(data[f"conv{i}_bias"], np.float32)))
    return vgg.to(dev)


def get_vgg(path: Optional[str], *, device: str, seed: int = 1234) -> VGGPrefix:
    if path:
        return load_vgg_params(path, device=device)
    logger.warning(
        "No VGG19 weights file given: using a seeded randomly initialised VGG (torch.Generator(%d)) "
        "for the perceptual loss. Its numbers are not those of the JAX package's random VGG, and "
        "perceptual quality does not match the reference; convert pretrained weights with "
        "tools/convert_vgg_weights.py.", seed)
    return init_random_vgg(seed, device=device)


def _normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NHWC -> [0, 1] -> ImageNet-normalized NCHW (losses.py:49-56),
    computed in fp32 and returned in x's dtype: a bf16 train step runs the
    perceptual forward in bf16, as the JAX package's ``vgg_features`` does."""
    x01 = (x.to(torch.float32) + 1.0) * 0.5
    mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(_IMAGENET_STD, dtype=torch.float32, device=x.device)
    dtype = x.dtype if x.is_floating_point() else torch.float32
    return ((x01 - mean) / std).to(dtype).permute(0, 3, 1, 2)


def _features(vgg: VGGPrefix, img: torch.Tensor, upto: int = 5) -> List[torch.Tensor]:
    return vgg.features(_normalize_imagenet(img), upto)


def vgg_features(vgg: VGGPrefix, img: torch.Tensor, upto: int = 5) -> List[torch.Tensor]:
    """NHWC ReLU outputs of the first ``upto`` convs for a [-1, 1] NHWC image."""
    return [f.permute(0, 2, 3, 1) for f in _features(vgg, img, upto)]


def _l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def style_content_loss(vgg: VGGPrefix, generated: torch.Tensor, real_style: torch.Tensor,
                       real_content: torch.Tensor,
                       gram: Callable[[torch.Tensor], torch.Tensor] = gram_nchw,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(content_loss, style_loss), reference losses.py:100-115. ``gram`` forms
    each batch-coupled Gram (a data-parallel step passes one over the global
    batch)."""
    gen_feats = _features(vgg, generated)
    sty_feats = _features(vgg, real_style)
    con_feats = _features(vgg, real_content, upto=_CONTENT_INDEX + 1)
    style_loss = torch.zeros((), dtype=torch.float32, device=generated.device)
    for g, s in zip(gen_feats, sty_feats):
        style_loss = style_loss + _l1(gram(g), gram(s))
    content_loss = _l1(gen_feats[_CONTENT_INDEX].float(), con_feats[_CONTENT_INDEX].float())
    return content_loss, style_loss


def style_content_loss_pair(vgg: VGGPrefix, fake_B, real_B, real_A, fake_A,
                            gram: Callable[[torch.Tensor], torch.Tensor] = gram_nchw):
    """Both perceptual directions with one VGG forward over the 4B images
    ``[fake_B, fake_A, real_A, real_B]``; Grams stay coupled within each B-group
    (``gram`` as in :func:`style_content_loss`).
    Returns ((content_B, style_B), (content_A, style_A))."""
    b = fake_B.shape[0]
    feats = _features(vgg, torch.cat([fake_B, fake_A, real_A, real_B], dim=0))
    zero = torch.zeros((), dtype=torch.float32, device=fake_B.device)
    style_B, style_A = zero, zero
    for f in feats:
        g_fb, g_fa, g_ra, g_rb = (gram(f[i * b:(i + 1) * b]) for i in range(4))
        style_B = style_B + _l1(g_fb, g_rb)
        style_A = style_A + _l1(g_fa, g_ra)
    f4 = feats[_CONTENT_INDEX].float()
    content_B = _l1(f4[:b], f4[2 * b:3 * b])      # fake_B vs real_A
    content_A = _l1(f4[b:2 * b], f4[3 * b:])      # fake_A vs real_B
    return (content_B, style_B), (content_A, style_A)


def style_content_loss_pair2(vgg: VGGPrefix, fake_B, real_B, real_A, fake_A):
    """The result of :func:`style_content_loss_pair` from two 2B forwards,
    ``[fake_B, real_A]`` then ``[fake_A, real_B]``."""
    b = fake_B.shape[0]

    def launch(x, y):
        feats = _features(vgg, torch.cat([x, y], dim=0))
        grams = [(gram_nchw(f[:b]), gram_nchw(f[b:])) for f in feats]
        f4 = feats[_CONTENT_INDEX].float()
        return grams, _l1(f4[:b], f4[b:])

    g1, content_B = launch(fake_B, real_A)
    g2, content_A = launch(fake_A, real_B)
    zero = torch.zeros((), dtype=torch.float32, device=fake_B.device)
    style_B, style_A = zero, zero
    for (g_fb, g_ra), (g_fa, g_rb) in zip(g1, g2):
        style_B = style_B + _l1(g_fb, g_rb)
        style_A = style_A + _l1(g_fa, g_ra)
    return (content_B, style_B), (content_A, style_A)
