"""The unfused trunk's relu epilogue on an int32 map: CUDA kernel and plain version.

Counterpart of ``msig_tpu/ops/int8_epilogue_chunked.py``:
``adain_relu_requant_chunked(x_i32 [B, S, C], gamma [B, C], beta [B, C])``
-> int8 [B, S, C]: instance norm over the S rows of a sample, AdaIN, ReLU,
and the per-sample requant whose scale comes from the true per-channel
extremes, unfolded (``fc.relu_requant_true``). The TPU kernel carries fp32
sums across a sequential grid of 512-row chunks; the CUDA kernel
(``csrc/adain_relu_requant_chunked.cu``) reduces exact integer statistics
across CTAs, then requantizes, and its plain version computes the same
integers. The JAX package runs it from ``_xla_trunk(..., fused_epilogue=True)``
where ``supported`` says so.

``adain_relu_requant_chunked`` launches the kernel for a CUDA tensor and adds
one to ``LAUNCHES``, or raises; for a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from msig_tpu_torch.ops import _build
from msig_tpu_torch.ops import fused_conv_int8_v2 as fc

_EPS = 1e-5
_LANES = 128

SITE = "adain_relu_requant_chunked"
SOURCES = (SITE,)

# Launches on CUDA tensors (one per call; CPU tensors do not count).
LAUNCHES: Dict[str, int] = {SITE: 0}

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]


def reset_launch_counts() -> None:
    LAUNCHES[SITE] = 0


def supported(shape) -> bool:
    """The shapes the JAX package sends here (``int8_epilogue_chunked.py:40-45``):
    C a multiple of 128 and S of 8. Any backend of the port takes them."""
    _, s, c = shape
    return c % _LANES == 0 and s % 8 == 0


def adain_relu_requant_chunked_plain(x_i32, gamma, beta, eps: float = _EPS):
    """Exact integer statistics over S, the AdaIN affine in fp32, then
    ``fc.relu_requant_true``. x_i32 [B, S, C] int32 -> int8 [B, S, C]."""
    b, s, c = x_i32.shape
    y = x_i32.to(torch.int64).reshape(b, s, 1, c)
    a, d = fc._channel_affine(y, gamma, beta, eps)
    return fc.relu_requant_true(y, a, d).reshape(b, s, c)


def adain_relu_requant_chunked(x_i32, gamma, beta, eps: float = _EPS):
    """x_i32 [B, S, C] int32, gamma/beta [B, C] float32 -> int8 [B, S, C]."""
    if x_i32.device.type == "cpu":
        return adain_relu_requant_chunked_plain(x_i32, gamma, beta, eps)
    if x_i32.dim() != 3:
        raise ValueError(f"expected [B, S, C], got shape {tuple(x_i32.shape)}")
    b, s, c = x_i32.shape
    if not supported(x_i32.shape):
        raise ValueError(f"the CUDA kernel needs C % 128 == 0 and S % 8 == 0, "
                         f"got {tuple(x_i32.shape)}")
    fc._check("x", x_i32, torch.int32, (b, s, c))
    fc._check("gamma", gamma, torch.float32, (b, c))
    fc._check("beta", beta, torch.float32, (b, c))
    for t in (gamma, beta):
        if t.device != x_i32.device:
            raise ValueError(f"all inputs must be on {x_i32.device}, got {t.device}")
    fn = _build.load(SITE, _ARGTYPES)
    stats = fc.true_extremes_stats(1, b, c, x_i32.device)
    out = torch.empty((b, s, c), dtype=torch.int8, device=x_i32.device)
    err = fn(x_i32.data_ptr(), gamma.data_ptr(), beta.data_ptr(), stats.data_ptr(), out.data_ptr(),
             b, s, c, eps, torch.cuda.current_stream(x_i32.device).cuda_stream)
    _build.check(SITE, err)
    LAUNCHES[SITE] += 1
    return out
