"""The int8 decoder tail: up1 ConvT site and the final conv7 + tanh -> uint8 site.

Counterpart of ``msig_tpu/ops/fused_dec_int8.py``. The TPU kernels there work
on space-to-depth slabs shaped for VMEM: ``up1_s2d16`` reads up0's s2d-4 slab
and writes the 256² map as an s2d-16 slab whose guard cells it fills with
reflected values, and ``final7_tanh_u8`` runs the 7x7 conv as nine tap
matmuls on that slab. Here both sites take and give dense NHWC:

* ``up1_s2d16``: the ConvT 4x4/s2 + IN + ReLU + requant site of
  ``fused_conv_int8_v2.convt4x4s2_in_relu_requant_ps`` (same CUDA kernel),
  applied to up0's dense output; returns the int8 map and its inverse scale;
* ``up1_s2d16_hbm``: up1 as the chain runs it on a 512² input, where the TPU
  splits the site into a staged pair of kernels: the same CUDA source, with
  the accumulator staged as int32 or as fp16 x 2^-12 (``stage``), counted
  under its own name;
* ``final7_tanh_u8``: ReflectionPad2d(3) by index, exact int8 7x7 conv,
  dequant by ``wscale * inv_s``, bias, tanh, uint8.

Each has a wrapper that launches the kernel for CUDA tensors and adds one to
its entry of ``LAUNCHES``, or raises, and a plain PyTorch version that the
wrapper runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from msig_tpu_torch.ops import _build
from msig_tpu_torch.ops import fused_conv_int8_v2 as fc

_EPS = 1e-5

UP1_SITE = "up1_s2d16"
UP1_HBM_SITE = "up1_s2d16_hbm"
FINAL7_SITE = "final7_tanh_u8"
KERNELS = (UP1_SITE, UP1_HBM_SITE, FINAL7_SITE)
# csrc sources built for this module; both up1 sites run fc.CONVT_SOURCE.
SOURCES = (FINAL7_SITE,)

# Launches per wrapper on CUDA tensors (one per call; the plain versions and
# CPU tensors do not count).
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_FINAL7_ARGTYPES = [_P] * 6 + [ctypes.c_int] * 3 + [_P]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ----------------------------------------------------------- plain versions


up1_s2d16_plain = fc.convt4x4s2_in_relu_requant_ps_plain
up1_s2d16_hbm_plain = fc.convt4x4s2_in_relu_requant_ps_plain


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each row of a ReflectionPad2d(pad) map of n rows."""
    i = torch.arange(-pad, n + pad, device=device)
    return torch.where(i < 0, -i, torch.where(i >= n, 2 * n - 2 - i, i))


def final7_i64(x_i8: torch.Tensor, w_oihw: torch.Tensor) -> torch.Tensor:
    """ReflectionPad2d(3) + exact int8 7x7 conv, NHWC -> int64 [B, H, W, Cout].

    Tap by tap, a [B*H*W, Cin] x [Cin, Cout] product in float64, where every
    partial sum is an exact integer; memory stays at a few copies of x."""
    b, h, w, _ = x_i8.shape
    xr = x_i8[:, _reflect_index(h, 3, x_i8.device)][:, :, _reflect_index(w, 3, x_i8.device)]
    xr = xr.to(torch.float64)
    wf = w_oihw.to(torch.float64)
    y = 0
    for ky in range(7):
        for kx in range(7):
            y = y + xr[:, ky:ky + h, kx:kx + w] @ wf[:, :, ky, kx].t()
    return y.to(torch.int64)


def final7_tanh_u8_plain(x_i8, w_i8, wscale, bias, inv_s):
    """conv7 -> y * (wscale * inv_s) + bias -> tanh -> uint8 (``_kernel_final7``).

    The product ``wscale * inv_s`` is formed first, in fp32, as the TPU kernel
    does (fused_dec_int8.py:593)."""
    y = final7_i64(x_i8, w_i8)
    sv = wscale.to(torch.float32) * inv_s.to(torch.float32).reshape(-1, 1, 1, 1)
    yf = torch.tanh(y.to(torch.float32) * sv + bias.to(torch.float32))
    return torch.clamp(torch.round((yf + 1.0) * 127.5), 0, 255).to(torch.uint8)


# ------------------------------------------------------------------ wrappers


def up1_s2d16(x_i8, w_ps, eps: float = _EPS):
    """Decoder up1 site on up0's dense NHWC int8 output; returns (int8 [B, 2H, 2W, Cout],
    inv_scale [B, 1]).

    The ConvT site of ``fc.convt4x4s2_in_relu_requant_ps`` (the TPU's s2d-16
    layout and reflect guards have no dense counterpart); its launches count
    here, under this site's name.
    """
    if x_i8.device.type == "cpu":
        return up1_s2d16_plain(x_i8, w_ps, eps)
    out = fc.convt4x4s2_kernel(x_i8, w_ps, eps)
    LAUNCHES[UP1_SITE] += 1
    return out


def up1_s2d16_hbm(x_i8, w_ps, eps: float = _EPS, stage: str = "int32"):
    """Decoder up1 site as the chain runs it on maps wider than 128 pixels; returns
    (int8 [B, 2H, 2W, Cout], inv_scale [B, 1]).

    ``stage`` is how the accumulator crosses device memory: "int32", the
    arithmetic of ``up1_s2d16``, or "fp16" (``fc.STAGES``). The TPU kernel's
    reflect fill of the slab's guard cells has no dense counterpart:
    ``final7_tanh_u8`` reflects by index.
    """
    if x_i8.device.type == "cpu":
        return up1_s2d16_hbm_plain(x_i8, w_ps, eps, stage)
    out = fc.convt4x4s2_kernel(x_i8, w_ps, eps, stage)
    LAUNCHES[UP1_HBM_SITE] += 1
    return out


def final7_tanh_u8(x_i8, w_i8, wscale, bias, inv_s):
    """Final decoder site: x_i8 [B, H, W, 64] int8 -> uint8 [B, H, W, 3].

    w_i8 [3, 64, 7, 7] int8 (OIHW), wscale and bias [3] float32, inv_s [B, 1]
    float32 (up1's inverse scale).
    """
    if x_i8.device.type == "cpu":
        return final7_tanh_u8_plain(x_i8, w_i8, wscale, bias, inv_s)
    if x_i8.dim() != 4:
        raise ValueError(f"expected NHWC [B, H, W, 64], got shape {tuple(x_i8.shape)}")
    b, h, w, c = x_i8.shape
    if c != 64 or h % 16 or w % 32:
        raise ValueError(f"the CUDA kernel needs C == 64, H % 16 == 0 and W % 32 == 0, "
                         f"got {tuple(x_i8.shape)}")
    fc._check("x", x_i8, torch.int8, (b, h, w, c))
    fc._check("weights", w_i8, torch.int8, (3, c, 7, 7))
    fc._check("wscale", wscale, torch.float32, (3,))
    fc._check("bias", bias, torch.float32, (3,))
    fc._check("inv_s", inv_s, torch.float32, (b, 1))
    for t in (w_i8, wscale, bias, inv_s):
        if t.device != x_i8.device:
            raise ValueError(f"all inputs must be on {x_i8.device}, got {t.device}")
    fn = _build.load(FINAL7_SITE, _FINAL7_ARGTYPES)
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=x_i8.device)
    err = fn(x_i8.data_ptr(), w_i8.data_ptr(), wscale.data_ptr(), bias.data_ptr(),
             inv_s.data_ptr(), out.data_ptr(), b, h, w,
             torch.cuda.current_stream(x_i8.device).cuda_stream)
    _build.check(FINAL7_SITE, err)
    LAUNCHES[FINAL7_SITE] += 1
    return out
