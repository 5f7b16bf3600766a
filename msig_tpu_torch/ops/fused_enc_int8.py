"""The int8 encoder: three conv + IN + ReLU + requant sites, CUDA kernels and plain versions.

Counterpart of ``msig_tpu/ops/fused_enc_int8.py``. The TPU kernels there work
on the 64-cell grid of 4x4-pixel cells: enc0 reads a space-to-depth-4 slab of
the reflect-padded image and writes 16 pixel phases x 64 channels per row in
a b-major lane order, enc1 and enc2 read 2x2 blocks of such lanes. Here all
three sites take and give dense NHWC, so the slab's construction
(``prep_s2d4_input``), the lane orders and the guard rows have no
counterpart:

* ``enc0_in_relu_requant``: uint8 image recentred to int8 (``x ^ 0x80``),
  ReflectionPad2d(3) by index, exact int8 7x7 conv 3 -> 64;
* ``enc1_in_relu_requant``: exact int8 4x4/s2 conv, zero pad 1, 64 -> 128;
* ``enc2_in_relu_requant``: the same conv 128 -> 256, which also returns the
  inverse scale ``amax / 127`` that the trunk's residual carry starts from.

Each conv is followed by an instance norm in fp32 from exact statistics, a
ReLU and the per-sample requant to int8 of the other relu sites
(``fused_conv_int8_v2._relu_requant``). enc1 and enc2 run one CUDA source;
on dense maps it is a single K = 16*Cin product, which is also what the TPU's
``enc1_in_relu_requant_im2col`` computes.

Each site has a wrapper that launches the kernel for CUDA tensors and adds
one to its entry of ``LAUNCHES``, or raises, and a plain PyTorch version that
the wrapper runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from msig_tpu_torch.ops import _build
from msig_tpu_torch.ops import fused_conv_int8_v2 as fc
from msig_tpu_torch.ops import fused_dec_int8 as fd

_EPS = 1e-5

ENC0_SITE = "enc0_in_relu_requant"
ENC1_SITE = "enc1_in_relu_requant"
ENC2_SITE = "enc2_in_relu_requant"
KERNELS = (ENC0_SITE, ENC1_SITE, ENC2_SITE)

# csrc sources, one shared library each; enc1 and enc2 run CONV_S2_SOURCE.
CONV_S2_SOURCE = "conv4x4s2_in_relu_requant"
SOURCES = (ENC0_SITE, CONV_S2_SOURCE)

# Launches per wrapper on CUDA tensors (one per call; the plain versions and
# CPU tensors do not count).
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_ARGTYPES = {
    ENC0_SITE: [_P] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, _P],
    CONV_S2_SOURCE: [_P] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, _P],
}

ENC0_K = 7 * 7 * 3      # 147 rows of the enc0 weight matrix
ENC0_K_PADDED = 160     # zero rows up to 5 mma steps of 32


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------- weight packs


def pack_enc0(w_hwio: torch.Tensor) -> torch.Tensor:
    """[7, 7, 3, 64] int8 kernel -> [160, 64]: row (u*7 + v)*3 + ci, then 13 zero rows."""
    if tuple(w_hwio.shape) != (7, 7, 3, 64):
        raise ValueError(f"expected a [7, 7, 3, 64] kernel, got {tuple(w_hwio.shape)}")
    return F.pad(w_hwio.to(torch.int8).reshape(ENC0_K, 64), (0, 0, 0, ENC0_K_PADDED - ENC0_K))


def pack_conv4x4(w_hwio: torch.Tensor) -> torch.Tensor:
    """[4, 4, Cin, Cout] int8 kernel -> [16*Cin, Cout], row (4u + v)*Cin + ci.

    At [4, 4, 128, 256] bit-equal to ``msig_tpu/ops/fused_enc_int8.py::
    pack_enc2``; at [4, 4, 64, 128] to each of the four phase blocks of
    ``pack_enc1_im2col`` there."""
    if w_hwio.dim() != 4 or tuple(w_hwio.shape[:2]) != (4, 4):
        raise ValueError(f"expected a [4, 4, Cin, Cout] kernel, got {tuple(w_hwio.shape)}")
    return w_hwio.to(torch.int8).reshape(16 * w_hwio.shape[2], w_hwio.shape[3]).contiguous()


# ----------------------------------------------------------- plain versions


def enc0_i64(img_u8: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """Recentre, ReflectionPad2d(3) by index, exact int8 7x7 conv: uint8 NHWC -> int64 NHWC.

    In float64, where every partial sum of int8 products is an exact integer."""
    _, h, w, _ = img_u8.shape
    x = (img_u8 ^ 0x80).view(torch.int8)
    x = x[:, fd._reflect_index(h, 3, x.device)][:, :, fd._reflect_index(w, 3, x.device)]
    wf = w_packed[:ENC0_K].reshape(7, 7, 3, -1).permute(3, 2, 0, 1).to(torch.float64)
    y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float64), wf)
    return y.permute(0, 2, 3, 1).to(torch.int64).contiguous()


def conv4x4s2_i64(x_i8: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """Exact int8 conv 4x4 / stride 2 / zero pad 1, NHWC -> int64 NHWC."""
    cin = x_i8.shape[-1]
    wf = w_packed.reshape(4, 4, cin, -1).permute(3, 2, 0, 1).to(torch.float64)
    y = F.conv2d(x_i8.permute(0, 3, 1, 2).to(torch.float64), wf, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(torch.int64).contiguous()


def enc0_in_relu_requant_plain(img_u8, w_packed, eps: float = _EPS):
    """enc0: conv7 on the recentred, reflected image -> IN -> ReLU -> requant (``_kernel_enc0``)."""
    return fc.in_relu_requant_i64(enc0_i64(img_u8, w_packed), eps)[0]


def enc1_in_relu_requant_plain(x_i8, w_packed, eps: float = _EPS):
    """enc1: conv 4x4/s2 -> IN -> ReLU -> requant (``_kernel_enc1``, ``_kernel_enc1_im2col``)."""
    return fc.in_relu_requant_i64(conv4x4s2_i64(x_i8, w_packed), eps)[0]


def enc2_in_relu_requant_plain(x_i8, w_packed, eps: float = _EPS):
    """enc2: as enc1, returning (int8, inverse scale [B, 1]) (``_kernel_enc2``)."""
    return fc.in_relu_requant_i64(conv4x4s2_i64(x_i8, w_packed), eps)


# ------------------------------------------------------------------ wrappers


def _same_device(x: torch.Tensor, w: torch.Tensor) -> None:
    if w.device != x.device:
        raise ValueError(f"all inputs must be on {x.device}, got {w.device}")


def _check_conv4x4s2(x: torch.Tensor, w_packed: torch.Tensor) -> Tuple[int, int, int, int, int]:
    if x.dim() != 4 or w_packed.dim() != 2:
        raise ValueError(f"expected x [B, H, W, Cin] and w [16*Cin, Cout], got "
                         f"{tuple(x.shape)} and {tuple(w_packed.shape)}")
    b, h, w, cin = x.shape
    cout = w_packed.shape[1]
    if cin % 64 or cout % 64 or h % 2 or w % 2 or (h // 2 * (w // 2)) % 128:
        raise ValueError(f"the CUDA kernel needs Cin % 64 == 0, Cout % 64 == 0, H and W even "
                         f"and (H/2)*(W/2) % 128 == 0, got x {tuple(x.shape)}, Cout {cout}")
    # Each output sums 16*Cin products of magnitude <= 128*127: the int64 sum
    # of squares over a channel's outputs is exact while it stays below 2^63.
    if (h // 2) * (w // 2) * (128 * 127 * 16 * cin) ** 2 >= 2 ** 63:
        raise ValueError(f"map {tuple(x.shape)} too large for the exact int64 statistics")
    fc._check("x", x, torch.int8, tuple(x.shape))
    fc._check("weights", w_packed, torch.int8, (16 * cin, cout))
    _same_device(x, w_packed)
    return b, h, w, cin, cout


def _conv4x4s2_kernel(x_i8: torch.Tensor, w_packed: torch.Tensor, eps: float):
    """Launch the 4x4/s2 site's CUDA kernel; returns (int8, inv_scale). Counts no launch."""
    b, h, w, cin, cout = _check_conv4x4s2(x_i8, w_packed)
    fn = _build.load(CONV_S2_SOURCE, _ARGTYPES[CONV_S2_SOURCE])
    y, stats = fc._scratch(x_i8, b, (h // 2) * (w // 2), cout)
    out = torch.empty((b, h // 2, w // 2, cout), dtype=torch.int8, device=x_i8.device)
    out_scale = torch.empty((b, 1), dtype=torch.float32, device=x_i8.device)
    err = fn(x_i8.data_ptr(), w_packed.data_ptr(), y.data_ptr(), stats.data_ptr(), out.data_ptr(),
             out_scale.data_ptr(), b, h, w, cin, cout, eps,
             torch.cuda.current_stream(x_i8.device).cuda_stream)
    _build.check(CONV_S2_SOURCE, err)
    return out, out_scale


def enc0_in_relu_requant(img_u8, w_packed, eps: float = _EPS):
    """First encoder site: uint8 image [B, H, W, 3] -> int8 [B, H, W, 64].

    w_packed [160, 64] int8 from ``pack_enc0``."""
    if img_u8.device.type == "cpu":
        return enc0_in_relu_requant_plain(img_u8, w_packed, eps)
    if img_u8.dim() != 4:
        raise ValueError(f"expected NHWC [B, H, W, 3], got shape {tuple(img_u8.shape)}")
    b, h, w, c = img_u8.shape
    if c != 3 or h % 8 or w % 16:
        raise ValueError(f"the CUDA kernel needs C == 3, H % 8 == 0 and W % 16 == 0, "
                         f"got {tuple(img_u8.shape)}")
    if h * w * (128 * 127 * ENC0_K) ** 2 >= 2 ** 63:
        raise ValueError(f"map {tuple(img_u8.shape)} too large for the exact int64 statistics")
    fc._check("image", img_u8, torch.uint8, (b, h, w, c))
    fc._check("weights", w_packed, torch.int8, (ENC0_K_PADDED, 64))
    _same_device(img_u8, w_packed)
    fn = _build.load(ENC0_SITE, _ARGTYPES[ENC0_SITE])
    y, stats = fc._scratch(img_u8, b, h * w, 64)
    out = torch.empty((b, h, w, 64), dtype=torch.int8, device=img_u8.device)
    err = fn(img_u8.data_ptr(), w_packed.data_ptr(), y.data_ptr(), stats.data_ptr(),
             out.data_ptr(), b, h, w, eps, torch.cuda.current_stream(img_u8.device).cuda_stream)
    _build.check(ENC0_SITE, err)
    LAUNCHES[ENC0_SITE] += 1
    return out


def enc1_in_relu_requant(x_i8, w_packed, eps: float = _EPS):
    """Second encoder site: int8 [B, H, W, Cin] -> int8 [B, H/2, W/2, Cout].

    w_packed [16*Cin, Cout] int8 from ``pack_conv4x4``."""
    if x_i8.device.type == "cpu":
        return enc1_in_relu_requant_plain(x_i8, w_packed, eps)
    out, _ = _conv4x4s2_kernel(x_i8, w_packed, eps)
    LAUNCHES[ENC1_SITE] += 1
    return out


def enc2_in_relu_requant(x_i8, w_packed, eps: float = _EPS):
    """Third encoder site: int8 [B, H, W, Cin] -> (int8 [B, H/2, W/2, Cout], inv_scale [B, 1])."""
    if x_i8.device.type == "cpu":
        return enc2_in_relu_requant_plain(x_i8, w_packed, eps)
    out = _conv4x4s2_kernel(x_i8, w_packed, eps)
    LAUNCHES[ENC2_SITE] += 1
    return out
