"""The resblock trunk's two int8 conv sites: CUDA kernels and their plain versions.

Counterpart of ``msig_tpu/ops/fused_conv_int8_v2.py``. The TPU kernels work on
a guard-padded row slab shaped for VMEM; here both sites take and give dense
NHWC int8 ``[B, H, W, C]``. ``guard_rows`` and ``from_padded_rows`` know the
slab layout only so that tests can unpack the JAX kernels' outputs.

Each site has:

* a wrapper (``conv3x3_adain_relu_requant``, ``conv3x3_adain_residual_requant``)
  that, for CUDA tensors, launches the kernel of ``msig_tpu_torch/csrc`` and
  adds one to its entry of ``LAUNCHES``, or raises;
* a plain PyTorch version (``*_plain``) with the same arithmetic, which the
  wrapper runs for CPU tensors and which ``chip_smoke.py`` holds the kernel
  against on the card.

The int8 convolution is exact in both: the plain version convolves in float64,
where every partial sum of int8 products is an exact integer, and reduces the
instance-norm statistics in int64.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from msig_tpu_torch.ops import _build

_EPS = 1e-5

RELU_SITE = "conv3x3_adain_relu_requant"
RESIDUAL_SITE = "conv3x3_adain_residual_requant"
KERNELS = (RELU_SITE, RESIDUAL_SITE)

# Launches per wrapper on CUDA tensors (one per call; the plain version and
# CPU tensors do not count).
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_ARGTYPES = {
    RELU_SITE: [_P] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, _P],
    RESIDUAL_SITE: [_P] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, _P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ slab geometry


def guard_rows(w_img: int) -> int:
    """Zero guard rows of the TPU slab: >= WP+1, rounded up to a 32-row tile."""
    wp = w_img + 8
    return max(128, ((wp + 1 + 31) // 32) * 32)


def from_padded_rows(rows: torch.Tensor, w_img: int) -> torch.Tensor:
    """TPU slab [B, g + H*(W+8) + g, C] -> dense [B, H, W, C] for a square map
    (the inverse of ``msig_tpu/ops/fused_conv_int8_v2.py::to_padded_rows``)."""
    b, _, c = rows.shape
    g, wp = guard_rows(w_img), w_img + 8
    return rows[:, g:g + w_img * wp].reshape(b, w_img, wp, c)[:, :, :w_img]


def pack_weights(w_hwio: torch.Tensor) -> torch.Tensor:
    """[3, 3, C, Co] int8 kernel -> [9C, Co], row (ky*3 + kx)*C + ci.

    The packing of ``msig_tpu/ops/fused_conv_int8.py::pack_weights``."""
    kh, kw, ci, co = w_hwio.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {tuple(w_hwio.shape)}")
    return w_hwio.to(torch.int8).reshape(9 * ci, co)


# ----------------------------------------------------------- plain versions


def conv3x3_i64(x_i8: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """Exact int8 3x3 "same" conv, NHWC -> int64 NHWC."""
    c = x_i8.shape[-1]
    w = w_packed.reshape(3, 3, c, -1).permute(3, 2, 0, 1).to(torch.float64)
    y = F.conv2d(x_i8.permute(0, 3, 1, 2).to(torch.float64), w, padding=1)
    return y.permute(0, 2, 3, 1).to(torch.int64).contiguous()


def _channel_affine(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float):
    """Per-(sample, channel) IN + AdaIN affine from exact int64 statistics.

    fp32 from the sums on, in the TPU kernel's order: mean = sum/n,
    var = max(sumsq/n - mean^2, 0), a = gamma * rsqrt(var + eps),
    d = beta - mean * a. Returns (a, d), each [B, C]."""
    n = float(y.shape[1] * y.shape[2])
    sums = y.sum(dim=(1, 2)).to(torch.float32)
    sumsq = (y * y).sum(dim=(1, 2)).to(torch.float32)
    mean = sums / n
    var = torch.clamp(sumsq / n - mean * mean, min=0.0)
    a = gamma.to(torch.float32) * torch.reciprocal(torch.sqrt(var + eps))
    d = beta.to(torch.float32) - mean * a
    return a, d


def conv3x3_adain_relu_requant_plain(x_i8, w_packed, gamma, beta, eps: float = _EPS):
    """conv3x3 -> IN -> AdaIN -> ReLU -> per-sample requant (``_kernel_relu``).

    The requant amax is the affine image of the zero-masked per-channel min
    and max (fused_conv_int8_v2.py:127-131), not the true max."""
    y = conv3x3_i64(x_i8, w_packed)
    a, d = _channel_affine(y, gamma, beta, eps)
    cmin = torch.clamp(y.amin(dim=(1, 2)), max=0).to(torch.float32)
    cmax = torch.clamp(y.amax(dim=(1, 2)), min=0).to(torch.float32)
    hi = torch.maximum(a * cmax, a * cmin) + d
    amax = torch.clamp(hi, min=0.0).amax(dim=1, keepdim=True)
    s = torch.where(amax > 0, 127.0 / amax, 1.0)
    a2 = (a * s)[:, None, None, :]
    d2 = (d * s)[:, None, None, :]
    t = torch.clamp(y.to(torch.float32) * a2 + d2, 0.0, 127.0)
    return torch.round(t).to(torch.int8)


def conv3x3_adain_residual_requant_plain(y1_i8, h_i8, h_scale, w_packed, gamma, beta,
                                         eps: float = _EPS):
    """conv3x3 -> IN -> AdaIN -> + h*h_scale -> requant with max|hn| (``_kernel_res``).

    Returns (int8 [B, H, W, C], new scale [B, 1] = amax/127)."""
    y = conv3x3_i64(y1_i8, w_packed)
    a, d = _channel_affine(y, gamma, beta, eps)
    hs = h_scale.to(torch.float32).reshape(-1, 1, 1, 1)
    hn = y.to(torch.float32) * a[:, None, None, :] + d[:, None, None, :] + h_i8.to(torch.float32) * hs
    amax = hn.abs().amax(dim=(1, 2, 3)).reshape(-1, 1)
    s = torch.where(amax > 0, 127.0 / amax, 1.0).reshape(-1, 1, 1, 1)
    q = torch.round(torch.clamp(hn * s, -127.0, 127.0)).to(torch.int8)
    return q, torch.where(amax > 0, amax / 127.0, 1.0)


# ------------------------------------------------------------------ wrappers


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_site(x: torch.Tensor, w_packed, gamma, beta) -> Tuple[int, int, int, int]:
    if x.dim() != 4:
        raise ValueError(f"expected NHWC [B, H, W, C], got shape {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c % 128 or (h * w) % 128:
        raise ValueError(f"the CUDA kernel needs C % 128 == 0 and H*W % 128 == 0, got {tuple(x.shape)}")
    # The int64 sum of squares is exact while H*W * max|y|^2 < 2^63.
    if h * w * (128 * 127 * 9 * c) ** 2 >= 2 ** 63:
        raise ValueError(f"map {tuple(x.shape)} too large for the exact int64 statistics")
    _check("weights", w_packed, torch.int8, (9 * c, c))
    _check("gamma", gamma, torch.float32, (b, c))
    _check("beta", beta, torch.float32, (b, c))
    for t in (w_packed, gamma, beta):
        if t.device != x.device:
            raise ValueError(f"all inputs must be on {x.device}, got {t.device}")
    return b, h, w, c


def _scratch(x: torch.Tensor, b: int, hw: int, c: int):
    y = torch.empty((b, hw, c), dtype=torch.int32, device=x.device)
    stats = torch.zeros(4 * b * c + b, dtype=torch.int64, device=x.device)
    return y, stats


def conv3x3_adain_relu_requant(x_i8, w_packed, gamma, beta, eps: float = _EPS):
    """Resblock conv1 site on dense NHWC int8; see the module docstring.

    x_i8 [B, H, W, C] int8, w_packed [9C, C] int8, gamma/beta [B, C] float32.
    """
    if x_i8.device.type == "cpu":
        return conv3x3_adain_relu_requant_plain(x_i8, w_packed, gamma, beta, eps)
    _check("x", x_i8, torch.int8, tuple(x_i8.shape))
    b, h, w, c = _check_site(x_i8, w_packed, gamma, beta)
    fn = _build.load(RELU_SITE, _ARGTYPES[RELU_SITE])
    y, stats = _scratch(x_i8, b, h * w, c)
    out = torch.empty_like(x_i8)
    err = fn(x_i8.data_ptr(), w_packed.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
             y.data_ptr(), stats.data_ptr(), out.data_ptr(), b, h, w, c, eps,
             torch.cuda.current_stream(x_i8.device).cuda_stream)
    _build.check(RELU_SITE, err)
    LAUNCHES[RELU_SITE] += 1
    return out


def conv3x3_adain_residual_requant(y1_i8, h_i8, h_scale, w_packed, gamma, beta,
                                   eps: float = _EPS):
    """Resblock conv2 site on dense NHWC int8; returns (int8, scale [B, 1]).

    y1_i8, h_i8 [B, H, W, C] int8, h_scale [B, 1] float32, w_packed [9C, C]
    int8, gamma/beta [B, C] float32.
    """
    if y1_i8.device.type == "cpu":
        return conv3x3_adain_residual_requant_plain(y1_i8, h_i8, h_scale, w_packed, gamma,
                                                    beta, eps)
    _check("y1", y1_i8, torch.int8, tuple(y1_i8.shape))
    b, h, w, c = _check_site(y1_i8, w_packed, gamma, beta)
    _check("h", h_i8, torch.int8, tuple(y1_i8.shape))
    _check("h_scale", h_scale, torch.float32, (b, 1))
    if h_i8.device != y1_i8.device or h_scale.device != y1_i8.device:
        raise ValueError(f"all inputs must be on {y1_i8.device}")
    fn = _build.load(RESIDUAL_SITE, _ARGTYPES[RESIDUAL_SITE])
    y, stats = _scratch(y1_i8, b, h * w, c)
    out = torch.empty_like(y1_i8)
    out_scale = torch.empty((b, 1), dtype=torch.float32, device=y1_i8.device)
    err = fn(y1_i8.data_ptr(), h_i8.data_ptr(), h_scale.data_ptr(), w_packed.data_ptr(),
             gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), stats.data_ptr(),
             out.data_ptr(), out_scale.data_ptr(), b, h, w, c, eps,
             torch.cuda.current_stream(y1_i8.device).cuda_stream)
    _build.check(RESIDUAL_SITE, err)
    LAUNCHES[RESIDUAL_SITE] += 1
    return out, out_scale
