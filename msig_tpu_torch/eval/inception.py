"""InceptionV3 pool3 feature extractor — the canonical-FID backbone.

Counterpart of ``msig_tpu/eval/inception.py``. Consumes the ``.npz`` produced
by ``tools/convert_inception_weights.py`` (torchvision ``inception_v3``
state_dict with ``.``→``__`` key mangling) and runs torchvision's eval-mode
forward up to the global average pool: 2048-dim "pool3" features, the layer
canonical FID is defined on. :class:`InceptionV3Pool3` carries torchvision's
module names (``Conv2d_1a_3x3`` … ``Mixed_7c``, each ``BasicConv2d`` a
bias-free conv + BatchNorm(eval, eps 1e-3) + ReLU), so the npz loads with
``load_state_dict(strict=True)`` once the train-time ``AuxLogits`` head and the
BatchNorms' ``num_batches_tracked`` counters are dropped.

Protocol: uint8 images are scaled to [0, 1], resized to 299x299 bilinearly
(antialiased when shrinking, as ``jax.image.resize`` is), and passed through
``transform_input=True``, which after ImageNet normalization is exactly
``x * 2 - 1``. The avg pools of blocks A, C and E divide by 9 everywhere
(``count_include_pad``). Stock PyTorch throughout (cuDNN on the card): the JAX
package runs this network through XLA with no Pallas kernel. On the card,
fp32 means TF32 off (``torch.backends.cudnn.allow_tf32 = False``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from msig_tpu_torch import resolve_device

BN_EPS = 1e-3
SIZE = 299

Pad = Union[int, Tuple[int, int]]


class BatchNormEval(nn.Module):
    """BatchNorm2d in eval mode with torchvision's four tensors and no
    ``num_batches_tracked`` counter (``nn.BatchNorm2d`` adds one to every
    state_dict it loads, which a strict load of the npz then refuses)."""

    def __init__(self, c: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class BasicConv2d(nn.Module):
    """Bias-free conv + BatchNorm(eval, eps=1e-3) + ReLU (torchvision's names)."""

    def __init__(self, cin: int, cout: int, kernel: Pad, stride: int = 1, padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = BatchNormEval(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avgpool3s1p1(x):
    # count_include_pad=True: every window divided by 9, borders included
    return F.avg_pool2d(x, 3, stride=1, padding=1)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), self.branch5x5_2(self.branch5x5_1(x)), b3,
                          self.branch_pool(_avgpool3s1p1(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgpool3s1p1(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        return torch.cat([
            self.branch1x1(x),
            self.branch3x3_2a(b3), self.branch3x3_2b(b3),
            self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd),
            self.branch_pool(_avgpool3s1p1(x))], 1)


class InceptionV3Pool3(nn.Module):
    """torchvision's ``Inception3`` trunk in eval mode, up to the global average pool."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.eval().requires_grad_(False)

    def forward(self, x):
        """NCHW input after ``transform_input`` -> [N, 2048]."""
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # adaptive avgpool (1,1) -> [N, 2048]


def load_inception_params(npz_path: str) -> Dict[str, torch.Tensor]:
    """``convert_inception_weights.py`` npz -> :class:`InceptionV3Pool3`'s
    state_dict (float32): ``__`` back to ``.``, without the train-time
    ``AuxLogits`` head and the ``num_batches_tracked`` counters."""
    sd: Dict[str, torch.Tensor] = {}
    with np.load(npz_path) as flat:
        for key in flat.files:
            parts = key.split("__")
            if parts[0] == "AuxLogits" or parts[-1] == "num_batches_tracked":
                continue  # train-time head / counter: not part of the pool3 path
            sd[".".join(parts)] = torch.from_numpy(np.asarray(flat[key], np.float32).copy())
    return sd


def load_inception(npz_path: str, device: str = "cuda") -> InceptionV3Pool3:
    """:class:`InceptionV3Pool3` with the npz's weights (strict), on ``device``."""
    model = InceptionV3Pool3()
    model.load_state_dict(load_inception_params(npz_path), strict=True)
    return model.to(resolve_device(device))


def _transform_input(x01: torch.Tensor) -> torch.Tensor:
    """torchvision ``transform_input=True`` on ImageNet-normalized input is
    exactly ``x01 * 2 - 1``."""
    return x01 * 2.0 - 1.0


@torch.inference_mode()
def inception_pool3(model: InceptionV3Pool3, x01: torch.Tensor) -> torch.Tensor:
    """[N, 299, 299, 3] float32 in [0, 1] (NHWC, as the JAX function takes it)
    -> [N, 2048] pool3 features."""
    return model(_transform_input(x01).permute(0, 3, 1, 2))


def resize_299(x01_nchw: torch.Tensor) -> torch.Tensor:
    """Bilinear resize to 299x299 with ``jax.image.resize``'s semantics: half-pixel
    centres, and a triangle kernel widened by the scale when shrinking
    (``antialias=True``; when enlarging it is plain bilinear)."""
    return F.interpolate(x01_nchw, size=(SIZE, SIZE), mode="bilinear", align_corners=False,
                         antialias=True)


def inception_feature_fn(npz_path: str,
                         device: str = "cuda") -> Callable[[np.ndarray], np.ndarray]:
    """uint8 [N,H,W,3] batches -> [N,2048] pool3 features (resize to 299), on ``device``."""
    model = load_inception(npz_path, device)
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def extract(imgs_u8: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(imgs_u8)).to(dev).to(torch.float32) / 255.0
        x = resize_299(x.permute(0, 3, 1, 2))
        return model(_transform_input(x)).cpu().numpy()

    return extract
