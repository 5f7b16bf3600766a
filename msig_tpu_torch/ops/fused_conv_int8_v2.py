"""The int8 conv sites that end in an instance norm: CUDA kernels and their plain versions.

Counterpart of ``msig_tpu/ops/fused_conv_int8_v2.py``: the resblock trunk's
two 3x3 sites and the decoder's phase-split ConvT 4x4/s2 site; the encoder's
sites (``fused_enc_int8.py``) share the epilogue and the checks here. The TPU
kernels work on a guard-padded row slab (and the ConvT on a space-to-depth
slab) shaped for VMEM; here every site takes and gives dense NHWC int8
``[B, H, W, C]``. ``guard_rows`` and ``from_padded_rows`` know the row slab
only so that tests can unpack the JAX kernels' outputs.

Each site has:

* a wrapper (``conv3x3_adain_relu_requant``, ``conv3x3_adain_residual_requant``,
  ``convt4x4s2_in_relu_requant_ps``) that, for CUDA tensors, launches the
  kernel of ``msig_tpu_torch/csrc`` and adds one to its entry of
  ``LAUNCHES``, or raises;
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
CONVT_SITE = "convt4x4s2_in_relu_requant_ps"
KERNELS = (RELU_SITE, RESIDUAL_SITE, CONVT_SITE)

# csrc sources, one shared library each. The ConvT source also serves
# ``fused_dec_int8.up1_s2d16``, which counts its launches there.
CONVT_SOURCE = "convt4x4s2_in_relu_requant"
SOURCES = (RELU_SITE, RESIDUAL_SITE, CONVT_SOURCE)

# Launches per wrapper on CUDA tensors (one per call; the plain version and
# CPU tensors do not count).
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_ARGTYPES = {
    RELU_SITE: [_P] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, _P],
    RESIDUAL_SITE: [_P] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, _P],
    CONVT_SOURCE: [_P] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, _P],
}

# Per-phase (dy, dx) taps of the phase-split ConvT, phase q = 2*qy + qx, in
# the block order of ``pack_convt_weights_ps``.
PS_TAPS = tuple(
    tuple((dy, dx)
          for dy in ((-1, 0) if qy == 0 else (0, 1))
          for dx in ((-1, 0) if qx == 0 else (0, 1)))
    for qy in (0, 1) for qx in (0, 1)
)


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


def pack_convt_weights_ps(w_hwio: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """ConvT 4x4/s2 kernel [4, 4, cin, cout] -> [16*cin, cout] int8, phase-major.

    ``w_hwio`` is the forward-conv (flipped) kernel, HWIO, as the JAX package
    stores it. Output phase q = (qy, qx) keeps only its 2x2 taps (``PS_TAPS``):
    out(2I+qy, 2J+qx) = sum x(I+dy, J+dx) * w[2dy+2-qy, 2dx+2-qx]. Block order
    [q][tap][cin], bit-equal to ``msig_tpu/ops/fused_conv_int8_v2.py::
    pack_convt_weights_ps`` (whose second result, the taps, is ``PS_TAPS``).
    """
    if tuple(w_hwio.shape) != (4, 4, cin, cout):
        raise ValueError(f"expected a [4, 4, {cin}, {cout}] kernel, got {tuple(w_hwio.shape)}")
    w = w_hwio.to(torch.int8)
    blocks = [w[2 * dy + 2 - q // 2, 2 * dx + 2 - q % 2]
              for q, taps in enumerate(PS_TAPS) for dy, dx in taps]
    return torch.cat(blocks, dim=0).contiguous()


# ----------------------------------------------------------- plain versions


def div_rn(numerator: float, t: torch.Tensor) -> torch.Tensor:
    """``numerator / t`` rounded once, as jnp and the kernels' ``__fdiv_rn``
    divide. PyTorch evaluates ``float / Tensor`` as ``t.reciprocal() *
    numerator``, which is one ulp off for about a quarter of fp32 inputs."""
    return torch.full_like(t, numerator) / t


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


def convt4x4s2_i64(x_i8: torch.Tensor, w_ps: torch.Tensor) -> torch.Tensor:
    """Exact int8 ConvT 4x4/s2/p1, NHWC [B, H, W, Cin] -> int64 [B, 2H, 2W, Cout].

    Phase by phase, as the kernel runs it: the four shifted input maps of the
    phase's taps, concatenated along channels, times the phase's [4*Cin, Cout]
    block of ``w_ps``, in float64, where every partial sum is an exact integer."""
    b, h, w, cin = x_i8.shape
    xp = F.pad(x_i8.to(torch.float64), (0, 0, 1, 1, 1, 1))
    wf = w_ps.to(torch.float64)
    y = xp.new_empty((b, 2 * h, 2 * w, w_ps.shape[1]))
    for q, taps in enumerate(PS_TAPS):
        cols = torch.cat([xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w] for dy, dx in taps], dim=3)
        y[:, q // 2::2, q % 2::2] = cols @ wf[4 * q * cin:4 * (q + 1) * cin]
    return y.to(torch.int64)


def _relu_requant(y: torch.Tensor, a: torch.Tensor, d: torch.Tensor):
    """IN affine -> ReLU -> per-sample requant of an exact int64 conv output.

    The amax is the affine image of the zero-masked per-channel min and max
    (fused_conv_int8_v2.py:127-131, :634-637), not the true max. Returns
    (int8, inverse scale [B, 1] = amax/127, or 1 where amax is 0)."""
    cmin = torch.clamp(y.amin(dim=(1, 2)), max=0).to(torch.float32)
    cmax = torch.clamp(y.amax(dim=(1, 2)), min=0).to(torch.float32)
    hi = torch.maximum(a * cmax, a * cmin) + d
    amax = torch.clamp(hi, min=0.0).amax(dim=1, keepdim=True)
    s = torch.where(amax > 0, div_rn(127.0, amax), 1.0)
    a2 = (a * s)[:, None, None, :]
    d2 = (d * s)[:, None, None, :]
    t = torch.clamp(y.to(torch.float32) * a2 + d2, 0.0, 127.0)
    return torch.round(t).to(torch.int8), torch.where(amax > 0, amax / 127.0, 1.0)


def conv3x3_adain_relu_requant_plain(x_i8, w_packed, gamma, beta, eps: float = _EPS):
    """conv3x3 -> IN -> AdaIN -> ReLU -> per-sample requant (``_kernel_relu``)."""
    y = conv3x3_i64(x_i8, w_packed)
    return _relu_requant(y, *_channel_affine(y, gamma, beta, eps))[0]


def in_relu_requant_i64(y: torch.Tensor, eps: float = _EPS):
    """Plain IN -> ReLU -> per-sample requant of an exact int64 conv output [B, H, W, C].

    The epilogue of the ConvT and encoder sites: the relu site's affine with
    gamma = 1, beta = 0 (same bits as the TPU kernels' ``rsqrt`` and
    ``-mean * a``). Returns (int8, inverse scale [B, 1])."""
    b, c = y.shape[0], y.shape[-1]
    ones = torch.ones((b, c), dtype=torch.float32, device=y.device)
    return _relu_requant(y, *_channel_affine(y, ones, torch.zeros_like(ones), eps))


def convt4x4s2_in_relu_requant_ps_plain(x_i8, w_ps, eps: float = _EPS):
    """ConvT 4x4/s2 -> IN -> ReLU -> per-sample requant (``_kernel_up_ps``).

    IN statistics per output channel over all four phases. Returns (int8
    [B, 2H, 2W, Cout], inverse scale [B, 1])."""
    return in_relu_requant_i64(convt4x4s2_i64(x_i8, w_ps), eps)


def conv3x3_adain_residual_requant_plain(y1_i8, h_i8, h_scale, w_packed, gamma, beta,
                                         eps: float = _EPS):
    """conv3x3 -> IN -> AdaIN -> + h*h_scale -> requant with max|hn| (``_kernel_res``).

    Returns (int8 [B, H, W, C], new scale [B, 1] = amax/127)."""
    y = conv3x3_i64(y1_i8, w_packed)
    a, d = _channel_affine(y, gamma, beta, eps)
    hs = h_scale.to(torch.float32).reshape(-1, 1, 1, 1)
    hn = y.to(torch.float32) * a[:, None, None, :] + d[:, None, None, :] + h_i8.to(torch.float32) * hs
    amax = hn.abs().amax(dim=(1, 2, 3)).reshape(-1, 1)
    s = torch.where(amax > 0, div_rn(127.0, amax), 1.0).reshape(-1, 1, 1, 1)
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


def _check_convt(x: torch.Tensor, w_ps: torch.Tensor) -> Tuple[int, int, int, int, int]:
    if x.dim() != 4 or w_ps.dim() != 2:
        raise ValueError(f"expected x [B, H, W, Cin] and w [16*Cin, Cout], got "
                         f"{tuple(x.shape)} and {tuple(w_ps.shape)}")
    b, h, w, cin = x.shape
    cout = w_ps.shape[1]
    if cin % 64 or cout % 64 or (h * w) % 128:
        raise ValueError(f"the CUDA kernel needs Cin % 64 == 0, Cout % 64 == 0 and "
                         f"H*W % 128 == 0, got x {tuple(x.shape)}, Cout {cout}")
    # Each output sums 4*Cin products: the int64 sum of squares over the
    # 4*H*W outputs of a channel is exact while 4*H*W * max|y|^2 < 2^63.
    if 4 * h * w * (128 * 127 * 4 * cin) ** 2 >= 2 ** 63:
        raise ValueError(f"map {tuple(x.shape)} too large for the exact int64 statistics")
    _check("x", x, torch.int8, tuple(x.shape))
    _check("weights", w_ps, torch.int8, (16 * cin, cout))
    if w_ps.device != x.device:
        raise ValueError(f"all inputs must be on {x.device}, got {w_ps.device}")
    return b, h, w, cin, cout


def convt4x4s2_kernel(x_i8: torch.Tensor, w_ps: torch.Tensor, eps: float = _EPS):
    """Launch the ConvT site's CUDA kernel on dense NHWC int8; returns (int8, inv_scale).

    Checks its inputs and raises on what the kernel does not take. It counts
    no launch: the two sites that run it (``convt4x4s2_in_relu_requant_ps``
    here, ``fused_dec_int8.up1_s2d16``) each count their own."""
    b, h, w, _, cout = _check_convt(x_i8, w_ps)
    fn = _build.load(CONVT_SOURCE, _ARGTYPES[CONVT_SOURCE])
    y, stats = _scratch(x_i8, b, 4 * h * w, cout)
    out = torch.empty((b, 2 * h, 2 * w, cout), dtype=torch.int8, device=x_i8.device)
    out_scale = torch.empty((b, 1), dtype=torch.float32, device=x_i8.device)
    err = fn(x_i8.data_ptr(), w_ps.data_ptr(), y.data_ptr(), stats.data_ptr(), out.data_ptr(),
             out_scale.data_ptr(), b, h, w, x_i8.shape[3], cout, eps,
             torch.cuda.current_stream(x_i8.device).cuda_stream)
    _build.check(CONVT_SOURCE, err)
    return out, out_scale


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


def convt4x4s2_in_relu_requant_ps(x_i8, w_ps, eps: float = _EPS):
    """Decoder up0 site on dense NHWC int8; returns (int8 [B, 2H, 2W, Cout], inv_scale [B, 1]).

    x_i8 [B, H, W, Cin] int8, w_ps [16*Cin, Cout] int8 from
    ``pack_convt_weights_ps``.
    """
    if x_i8.device.type == "cpu":
        return convt4x4s2_in_relu_requant_ps_plain(x_i8, w_ps, eps)
    out = convt4x4s2_kernel(x_i8, w_ps, eps)
    LAUNCHES[CONVT_SITE] += 1
    return out
