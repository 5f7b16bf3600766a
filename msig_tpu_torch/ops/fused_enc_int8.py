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
``enc1_in_relu_requant_im2col`` computes. Both CUDA entries run the conv
twice, so that no int32 accumulator reaches device memory: pass S takes the
exact statistics, pass Q recomputes the conv and writes int8 from the
registers. enc1 and enc2 run it on ``wgmma``, which reads the weights
K-major: their wrappers take the ``[Cout, 16*Cin]`` copy of
``pack_conv4x4_kmajor`` as the keyword ``w_kmajor`` (made once at
quantization) and make it themselves where it is not given.

``enc1_in_relu_requant_im2col`` is enc1 as the JAX package runs it under
``MSIG_ENC1_IM2COL=1``: the dense K = 1024 product per output phase against
that phase's own block of ``pack_enc1_im2col``'s [4 * 1024, 128] weights.
Its entry of the 4x4/s2 source runs the same two ``wgmma`` passes over a
four-phase geometry (a quarter of the output map a phase), reading each
phase's block K-major (``pack_enc1_im2col_kmajor``, [4 * 128, 1024], the
keyword ``w_kmajor``). With four equal blocks it is enc1's function bit for
bit.

``enc0_hbm`` is enc0 as the all-kernel chain runs it on a 512² input, where
the TPU splits the site into a staged pair of kernels (``_enc0_hbm``): the
same CUDA source, the accumulator read as the staging type would pass it on,
int32 or fp16 x 2^-12 (``stage``), counted under its own name.

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
ENC0_HBM_SITE = "enc0_hbm"
ENC1_I2C_SITE = "enc1_in_relu_requant_im2col"
KERNELS = (ENC0_SITE, ENC0_HBM_SITE, ENC1_SITE, ENC1_I2C_SITE, ENC2_SITE)

# csrc sources, one shared library each; enc1 and enc2 run CONV_S2_SOURCE.
CONV_S2_SOURCE = "conv4x4s2_in_relu_requant"
SOURCES = (ENC0_SITE, CONV_S2_SOURCE)

# Launches per wrapper on CUDA tensors (one per call; the plain versions and
# CPU tensors do not count).
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_ARGTYPES = {
    ENC0_SITE: [_P] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, _P],
    CONV_S2_SOURCE: [_P] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, _P],
}
ENC1_I2C_ENTRY = "msig_enc1_phases_in_relu_requant"  # the same arguments as CONV_S2_SOURCE's

ENC0_K = 7 * 7 * 3      # 147 rows of the enc0 weight matrix
ENC0_K_PADDED = 160     # 147 rows and 13 zero rows (the kernel reads the 147)


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


def pack_conv4x4_kmajor(w_packed: torch.Tensor) -> torch.Tensor:
    """[16*Cin, Cout] packed int8 weights (``pack_conv4x4``) -> [Cout, 16*Cin],
    the transpose: row co holds the K = (4u + v)*Cin + ci of output channel co
    contiguous, as ``wgmma`` takes an 8-bit B operand (K-major only)."""
    if w_packed.dim() != 2 or w_packed.shape[0] % 16:
        raise ValueError(f"expected packed weights [16*Cin, Cout], got {tuple(w_packed.shape)}")
    return w_packed.to(torch.int8).t().contiguous()


def conv4x4_kmajor_shape(w_packed: torch.Tensor) -> Tuple[int, int]:
    """The shape [Cout, 16*Cin] of ``pack_conv4x4_kmajor(w_packed)``."""
    return w_packed.shape[1], w_packed.shape[0]


def pack_enc1_im2col(w_hwio: torch.Tensor) -> torch.Tensor:
    """[4, 4, 64, 128] int8 kernel -> [4 * 1024, 128]: one block per output
    phase q = 2*qy + qx, each ``pack_conv4x4(w)`` (row (4u + v)*64 + ci).

    Bit-equal to ``msig_tpu/ops/fused_enc_int8.py::pack_enc1_im2col``."""
    if tuple(w_hwio.shape) != (4, 4, 64, 128):
        raise ValueError(f"expected a [4, 4, 64, 128] kernel, got {tuple(w_hwio.shape)}")
    return pack_conv4x4(w_hwio).repeat(4, 1).contiguous()


def pack_enc1_im2col_kmajor(w_i2c: torch.Tensor) -> torch.Tensor:
    """[4 * 16*Cin, Cout] phase blocks (``pack_enc1_im2col``) -> [4 * Cout,
    16*Cin]: block q's transpose, row q*Cout + co holding the K = (4u + v)*Cin
    + ci of phase q's output channel co contiguous, as ``wgmma`` takes an
    8-bit B operand (K-major only). Each phase keeps its own block."""
    if w_i2c.dim() != 2 or w_i2c.shape[0] % 64:
        raise ValueError(f"expected phase blocks [4 * 16*Cin, Cout], got {tuple(w_i2c.shape)}")
    k, cout = w_i2c.shape[0] // 4, w_i2c.shape[1]
    return w_i2c.to(torch.int8).reshape(4, k, cout).transpose(1, 2).reshape(4 * cout, k).contiguous()


def enc1_im2col_kmajor_shape(w_i2c: torch.Tensor) -> Tuple[int, int]:
    """The shape [4 * Cout, 16*Cin] of ``pack_enc1_im2col_kmajor(w_i2c)``."""
    return 4 * w_i2c.shape[1], w_i2c.shape[0] // 4


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


def enc0_in_relu_requant_plain(img_u8, w_packed, eps: float = _EPS, stage: str = "int32"):
    """enc0: conv7 on the recentred, reflected image -> IN -> ReLU -> requant
    (``_kernel_enc0``; with ``stage``, the staged pair of ``_enc0_hbm``)."""
    return fc.in_relu_requant_i64(enc0_i64(img_u8, w_packed), eps, stage)[0]


enc0_hbm_plain = enc0_in_relu_requant_plain


def enc1_in_relu_requant_plain(x_i8, w_packed, eps: float = _EPS):
    """enc1: conv 4x4/s2 -> IN -> ReLU -> requant (``_kernel_enc1``, ``_kernel_enc1_im2col``)."""
    return fc.in_relu_requant_i64(conv4x4s2_i64(x_i8, w_packed), eps)[0]


def conv4x4s2_phases_i64(x_i8: torch.Tensor, w_i2c: torch.Tensor) -> torch.Tensor:
    """Exact int8 conv 4x4 / stride 2 / zero pad 1 whose output pixel
    (2I + qy, 2J + qx) takes the weights of block q = 2*qy + qx of ``w_i2c``
    [4 * 16*Cin, Cout]: per phase, a stride-4 conv of the padded input from
    offset (2qy, 2qx), in float64. NHWC int8 -> int64 [B, H/2, W/2, Cout]."""
    b, h, w, cin = x_i8.shape
    k = 16 * cin
    xp = F.pad(x_i8.permute(0, 3, 1, 2).to(torch.float64), (1, 1, 1, 1))
    y = xp.new_empty((b, w_i2c.shape[1], h // 2, w // 2))
    for q in range(4):
        qy, qx = divmod(q, 2)
        wq = w_i2c[q * k:(q + 1) * k].reshape(4, 4, cin, -1).permute(3, 2, 0, 1).to(torch.float64)
        y[:, :, qy::2, qx::2] = F.conv2d(xp[:, :, 2 * qy:, 2 * qx:], wq, stride=4)
    return y.permute(0, 2, 3, 1).to(torch.int64).contiguous()


def enc1_in_relu_requant_im2col_plain(x_i8, w_i2c, eps: float = _EPS):
    """enc1 with a weight block per output phase -> IN -> ReLU -> requant
    (``_kernel_enc1_im2col``)."""
    return fc.in_relu_requant_i64(conv4x4s2_phases_i64(x_i8, w_i2c), eps)[0]


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
    fc.check_statistics(x.shape, (h // 2) * (w // 2), 16 * cin)
    fc._check("x", x, torch.int8, tuple(x.shape))
    fc._check("weights", w_packed, torch.int8, (16 * cin, cout))
    _same_device(x, w_packed)
    return b, h, w, cin, cout


def _conv4x4s2_kernel(x_i8: torch.Tensor, w_packed: torch.Tensor, eps: float, w_kmajor=None):
    """Launch the 4x4/s2 site's CUDA kernel; returns (int8, inv_scale). Counts no launch.

    The kernel reads the K-major weights: ``w_kmajor`` (``pack_conv4x4_kmajor(w_packed)``),
    checked, or the copy made here where it is None."""
    b, h, w, cin, cout = _check_conv4x4s2(x_i8, w_packed)
    wk = fc._kmajor(w_packed, w_kmajor, pack_conv4x4_kmajor, (cout, 16 * cin))
    fn = _build.load(CONV_S2_SOURCE, _ARGTYPES[CONV_S2_SOURCE])
    # the statistics block only: the C entry zeroes it on the stream
    stats = torch.empty(5 * b * cout + b, dtype=torch.int64, device=x_i8.device)
    out = torch.empty((b, h // 2, w // 2, cout), dtype=torch.int8, device=x_i8.device)
    out_scale = torch.empty((b, 1), dtype=torch.float32, device=x_i8.device)
    err = fn(x_i8.data_ptr(), wk.data_ptr(), stats.data_ptr(), out.data_ptr(),
             out_scale.data_ptr(), b, h, w, cin, cout, eps,
             torch.cuda.current_stream(x_i8.device).cuda_stream)
    _build.check(CONV_S2_SOURCE, err)
    return out, out_scale


def conv4x4s2_wgmma_config() -> Dict[str, int]:
    """The 4x4/s2 site's two wgmma passes as built (entry
    ``msig_conv4x4s2_i8_wgmma_config``): tile pixels, and for pass S and pass Q
    at each channel tile the bytes of K a stage, the stages of the ring and the
    dynamic shared memory per CTA. Builds the source."""
    fn = _build.load(CONV_S2_SOURCE, [ctypes.POINTER(ctypes.c_int)],
                     entry="msig_conv4x4s2_i8_wgmma_config")
    out = (ctypes.c_int * 19)()
    _build.check(CONV_S2_SOURCE, fn(out))
    keys = ["tile_m"] + [f"{what}_{p}_n{bn}" for bn in (256, 128, 64) for p in ("stats", "requant")
                         for what in ("k_bytes", "stages", "smem_bytes")]
    return dict(zip(keys, out))


def _enc0_kernel(img_u8: torch.Tensor, w_packed: torch.Tensor, eps: float, stage: str):
    """Launch enc0's CUDA kernel; returns int8 [B, H, W, 64]. Counts no launch."""
    if img_u8.dim() != 4:
        raise ValueError(f"expected NHWC [B, H, W, 3], got shape {tuple(img_u8.shape)}")
    b, h, w, c = img_u8.shape
    if c != 3 or h % 8 or w % 16:
        raise ValueError(f"the CUDA kernel needs C == 3, H % 8 == 0 and W % 16 == 0, "
                         f"got {tuple(img_u8.shape)}")
    fc.check_statistics(img_u8.shape, h * w, ENC0_K)
    if stage not in fc.STAGES:
        raise ValueError(f"stage must be one of {fc.STAGES}, got {stage!r}")
    fc._check("image", img_u8, torch.uint8, (b, h, w, c))
    fc._check("weights", w_packed, torch.int8, (ENC0_K_PADDED, 64))
    _same_device(img_u8, w_packed)
    fn = _build.load(ENC0_SITE, _ARGTYPES[ENC0_SITE])
    # the statistics block only: the C entry zeroes it on the stream
    stats = torch.empty(5 * b * 64 + b, dtype=torch.int64, device=img_u8.device)
    out = torch.empty((b, h, w, 64), dtype=torch.int8, device=img_u8.device)
    err = fn(img_u8.data_ptr(), w_packed.data_ptr(), stats.data_ptr(), out.data_ptr(), b, h, w,
             eps, int(stage == "fp16"), torch.cuda.current_stream(img_u8.device).cuda_stream)
    _build.check(ENC0_SITE, err)
    return out


def enc0_in_relu_requant(img_u8, w_packed, eps: float = _EPS):
    """First encoder site: uint8 image [B, H, W, 3] -> int8 [B, H, W, 64].

    w_packed [160, 64] int8 from ``pack_enc0``."""
    if img_u8.device.type == "cpu":
        return enc0_in_relu_requant_plain(img_u8, w_packed, eps)
    out = _enc0_kernel(img_u8, w_packed, eps, "int32")
    LAUNCHES[ENC0_SITE] += 1
    return out


def enc0_hbm(img_u8, w_packed, eps: float = _EPS, stage: str = "int32"):
    """First encoder site as the chain runs it on inputs wider than 256 pixels:
    uint8 image [B, H, W, 3] -> int8 [B, H, W, 64].

    ``stage`` is how the staged pair passes its accumulator on, and so how
    the requant reads each value: "int32", the arithmetic of
    ``enc0_in_relu_requant``, or "fp16" x 2^-12 (``fc.STAGES``); the kernel
    applies it in registers."""
    if img_u8.device.type == "cpu":
        return enc0_hbm_plain(img_u8, w_packed, eps, stage)
    out = _enc0_kernel(img_u8, w_packed, eps, stage)
    LAUNCHES[ENC0_HBM_SITE] += 1
    return out


def enc1_in_relu_requant(x_i8, w_packed, eps: float = _EPS, *, w_kmajor=None):
    """Second encoder site: int8 [B, H, W, Cin] -> int8 [B, H/2, W/2, Cout].

    w_packed [16*Cin, Cout] int8 from ``pack_conv4x4``; w_kmajor, optional,
    ``pack_conv4x4_kmajor(w_packed)``, which the kernel reads."""
    if x_i8.device.type == "cpu":
        fc._check_kmajor_shape(w_kmajor, conv4x4_kmajor_shape(w_packed))
        return enc1_in_relu_requant_plain(x_i8, w_packed, eps)
    out, _ = _conv4x4s2_kernel(x_i8, w_packed, eps, w_kmajor)
    LAUNCHES[ENC1_SITE] += 1
    return out


def enc2_in_relu_requant(x_i8, w_packed, eps: float = _EPS, *, w_kmajor=None):
    """Third encoder site: int8 [B, H, W, Cin] -> (int8 [B, H/2, W/2, Cout], inv_scale [B, 1]).

    w_kmajor as at ``enc1_in_relu_requant``."""
    if x_i8.device.type == "cpu":
        fc._check_kmajor_shape(w_kmajor, conv4x4_kmajor_shape(w_packed))
        return enc2_in_relu_requant_plain(x_i8, w_packed, eps)
    out = _conv4x4s2_kernel(x_i8, w_packed, eps, w_kmajor)
    LAUNCHES[ENC2_SITE] += 1
    return out


def enc1_in_relu_requant_im2col(x_i8, w_i2c, eps: float = _EPS, *, w_kmajor=None):
    """Second encoder site in the dense K = 1024 form: int8 [B, H, W, 64] ->
    int8 [B, H/2, W/2, 128].

    w_i2c [4 * 1024, 128] int8 from ``pack_enc1_im2col``; w_kmajor, optional,
    ``pack_enc1_im2col_kmajor(w_i2c)``, which the kernel reads."""
    if x_i8.device.type == "cpu":
        fc._check_kmajor_shape(w_kmajor, enc1_im2col_kmajor_shape(w_i2c))
        return enc1_in_relu_requant_im2col_plain(x_i8, w_i2c, eps)
    if x_i8.dim() != 4 or w_i2c.dim() != 2:
        raise ValueError(f"expected x [B, H, W, 64] and w [4096, Cout], got "
                         f"{tuple(x_i8.shape)} and {tuple(w_i2c.shape)}")
    b, h, w, cin = x_i8.shape
    cout = w_i2c.shape[1]
    if cin != 64 or cout % 128 or h % 4 or w % 4 or (h // 4 * (w // 4)) % 128:
        raise ValueError(f"the CUDA kernel needs Cin == 64, Cout % 128 == 0, H and W multiples "
                         f"of 4 and (H/4)*(W/4) % 128 == 0, got x {tuple(x_i8.shape)}, Cout {cout}")
    fc.check_statistics(x_i8.shape, (h // 2) * (w // 2), 16 * cin)
    fc._check("x", x_i8, torch.int8, tuple(x_i8.shape))
    fc._check("weights", w_i2c, torch.int8, (4 * 16 * cin, cout))
    _same_device(x_i8, w_i2c)
    wk = fc._kmajor(w_i2c, w_kmajor, pack_enc1_im2col_kmajor, (4 * cout, 16 * cin))
    fn = _build.load(CONV_S2_SOURCE, _ARGTYPES[CONV_S2_SOURCE], ENC1_I2C_ENTRY)
    # the statistics block only: the C entry zeroes it on the stream
    stats = torch.empty(5 * b * cout + b, dtype=torch.int64, device=x_i8.device)
    out = torch.empty((b, h // 2, w // 2, cout), dtype=torch.int8, device=x_i8.device)
    out_scale = torch.empty((b, 1), dtype=torch.float32, device=x_i8.device)
    err = fn(x_i8.data_ptr(), wk.data_ptr(), stats.data_ptr(), out.data_ptr(),
             out_scale.data_ptr(), b, h, w, cin, cout, eps,
             torch.cuda.current_stream(x_i8.device).cuda_stream)
    _build.check(ENC1_I2C_ENTRY, err)
    LAUNCHES[ENC1_I2C_SITE] += 1
    return out
