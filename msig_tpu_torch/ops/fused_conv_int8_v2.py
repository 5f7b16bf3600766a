"""The int8 conv sites that end in an instance norm: CUDA kernels and their plain versions.

Counterpart of ``msig_tpu/ops/fused_conv_int8_v2.py``: the resblock trunk's
3x3 sites (conv1, and conv2 with each of its three residual carries) and the
decoder's phase-split ConvT 4x4/s2 site; the encoder's
sites (``fused_enc_int8.py``) share the epilogue and the checks here. The TPU
kernels work on a guard-padded row slab (and the ConvT on a space-to-depth
slab) shaped for VMEM; here every site takes and gives dense NHWC int8
``[B, H, W, C]``. ``guard_rows`` and ``from_padded_rows`` know the row slab
only so that tests can unpack the JAX kernels' outputs.

Each site has:

* a wrapper (``conv3x3_adain_relu_requant``, ``conv3x3_adain_residual_requant``,
  ``conv3x3_adain_residual_hifi``, ``conv3x3_adain_residual_hifi2``,
  ``convt4x4s2_in_relu_requant_ps``) that, for CUDA tensors, launches the
  kernel of ``msig_tpu_torch/csrc`` and adds one to its entry of
  ``LAUNCHES``, or raises;
* a plain PyTorch version (``*_plain``) with the same arithmetic, which the
  wrapper runs for CPU tensors and which ``chip_smoke.py`` holds the kernel
  against on the card.

The int8 convolution is exact in both: the plain version convolves in float64,
where every partial sum of int8 products is an exact integer, and reduces the
instance-norm statistics in integers: the sum in int64, the sum of squares in
two int64 words (``sumsq_words``), since a 512² input's maps pass 2^63, rounded
once to fp32 (``words_to_f32``).
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
HIFI_SITE = "conv3x3_adain_residual_hifi"
HIFI2_SITE = "conv3x3_adain_residual_hifi2"
CONVT_SITE = "convt4x4s2_in_relu_requant_ps"
KERNELS = (RELU_SITE, RESIDUAL_SITE, HIFI_SITE, HIFI2_SITE, CONVT_SITE)

# csrc sources, one shared library each. The ConvT source also serves
# ``fused_dec_int8.up1_s2d16`` and ``up1_s2d16_hbm``, which count their launches there.
CONVT_SOURCE = "convt4x4s2_in_relu_requant"
SOURCES = (RELU_SITE, RESIDUAL_SITE, HIFI_SITE, HIFI2_SITE, CONVT_SOURCE)

# How pass A's accumulator crosses device memory to the epilogue: as int32,
# or as fp16 holding y * 2^-12 (``STAGE_SCALE`` of
# ``msig_tpu/ops/fused_dec_int8.py``), which the staged 512² sites may take.
STAGES = ("int32", "fp16")
STAGE_SCALE = float(2.0 ** -12)

# Launches per wrapper on CUDA tensors (one per call; the plain version and
# CPU tensors do not count).
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_ARGTYPES = {
    RELU_SITE: [_P] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, _P],
    RESIDUAL_SITE: [_P] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, _P],
    HIFI_SITE: [_P] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float, _P],
    HIFI2_SITE: [_P] * 12 + [ctypes.c_int] * 4 + [ctypes.c_float, _P],
    CONVT_SOURCE: [_P] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, _P],
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


def div_by(t: torch.Tensor, denominator: float) -> torch.Tensor:
    """``t / denominator`` rounded once, as the kernels' ``__fdiv_rn``. On the
    card PyTorch evaluates ``Tensor / float`` as ``t * (1 / denominator)``,
    which is one ulp off for some inputs where the reciprocal is inexact."""
    return t / torch.full_like(t, denominator)


def conv3x3_i64(x_i8: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """Exact int8 3x3 "same" conv, NHWC -> int64 NHWC."""
    c = x_i8.shape[-1]
    w = w_packed.reshape(3, 3, c, -1).permute(3, 2, 0, 1).to(torch.float64)
    y = F.conv2d(x_i8.permute(0, 3, 1, 2).to(torch.float64), w, padding=1)
    return y.permute(0, 2, 3, 1).to(torch.int64).contiguous()


def sumsq_words(y: torch.Tensor):
    """Exact per-(sample, channel) sum of squares of an int64 map [B, H, W, C]
    as two int64 words (hi, lo), the sum being hi * 2^32 + lo.

    One int64 overflows from H*W * max|y|^2 >= 2^63 on, which the trunk's maps
    of a 512² input reach; each square (< 2^62) is split at bit 32 and the
    halves are summed apart, as the kernels' statistics block keeps them."""
    sq = y * y
    return (sq >> 32).sum(dim=(1, 2)), (sq & 0xFFFFFFFF).sum(dim=(1, 2))


def words_to_f32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The integer hi * 2^32 + lo (int64 words, hi < 2^62 after lo's carry)
    rounded once to fp32, as ``sumsq_to_float`` of ``csrc/conv_int8.cuh`` does.

    Up to 62 bits the integer converts directly. Above, it is cut to its top
    62 bits with the bits cut off ORed into the last one: that bit lies far
    below fp32's rounding position, so the single rounding sees what the full
    integer would show it, and the power of two restores the magnitude
    exactly. A route through float64 would round twice."""
    hi = hi + (lo >> 32)
    lo = lo & 0xFFFFFFFF
    pow2 = 2 ** torch.arange(63, dtype=torch.int64, device=hi.device)
    s = torch.clamp((hi.unsqueeze(-1) >= pow2).sum(dim=-1) - 30, min=0)  # bit length - 30
    one = torch.ones_like(s)
    sticky = (lo & ((one << s) - 1)) != 0
    m = (hi << (32 - s)) | (lo >> s) | sticky.to(torch.int64)
    return m.to(torch.float32) * (one << s).to(torch.float32)


def _channel_affine(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float):
    """Per-(sample, channel) IN + AdaIN affine from exact integer statistics.

    fp32 from the sums on, in the TPU kernel's order: mean = sum/n,
    var = max(sumsq/n - mean^2, 0), a = gamma * rsqrt(var + eps),
    d = beta - mean * a. Returns (a, d), each [B, C]."""
    n = float(y.shape[1] * y.shape[2])
    sums = y.sum(dim=(1, 2)).to(torch.float32)
    sumsq = words_to_f32(*sumsq_words(y))
    mean = div_by(sums, n)
    var = torch.clamp(div_by(sumsq, n) - mean * mean, min=0.0)
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


def _relu_requant(y: torch.Tensor, a: torch.Tensor, d: torch.Tensor, stage: str = "int32"):
    """IN affine -> ReLU -> per-sample requant of an exact int64 conv output.

    The amax is the affine image of the zero-masked per-channel min and max
    (fused_conv_int8_v2.py:127-131, :634-637), not the true max. With
    ``stage="fp16"`` the requant reads y as the staged sites pass it on:
    fp32(y) * 2^-12 rounded to fp16, with 2^12 folded into a2 after the
    product a * s (fused_dec_int8.py:307-312, :425-428); the statistics, and
    so a, d and the scale, stay those of the exact y. Returns (int8, inverse
    scale [B, 1] = amax/127, or 1 where amax is 0)."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    cmin = torch.clamp(y.amin(dim=(1, 2)), max=0).to(torch.float32)
    cmax = torch.clamp(y.amax(dim=(1, 2)), min=0).to(torch.float32)
    hi = torch.maximum(a * cmax, a * cmin) + d
    amax = torch.clamp(hi, min=0.0).amax(dim=1, keepdim=True)
    s = torch.where(amax > 0, div_rn(127.0, amax), 1.0)
    a2 = (a * s)[:, None, None, :]
    d2 = (d * s)[:, None, None, :]
    yf = y.to(torch.float32)
    if stage == "fp16":
        yf = (yf * STAGE_SCALE).to(torch.float16).to(torch.float32)
        a2 = a2 * (1.0 / STAGE_SCALE)
    t = torch.clamp(yf * a2 + d2, 0.0, 127.0)
    return torch.round(t).to(torch.int8), torch.where(amax > 0, div_by(amax, 127.0), 1.0)


def relu_requant_true(y: torch.Tensor, a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """IN affine -> ReLU -> per-sample requant with the true extremes, unfolded.

    The epilogue of the single-kernel trunk's conv1 (``fused_trunk_v3.py:112-124``)
    and of the chunked epilogue (``int8_epilogue_chunked.py:79-95``): amax is
    the largest of max(a*max y, a*min y) + d and 0 over the channels, with the
    true per-channel min and max, and q = clip(round(max(y*a + d, 0) * s), +-127),
    s = 127/amax (``true_relu_amax`` and ``relu_requant_unfolded`` of
    ``csrc/conv_int8.cuh``). y: exact int64 [B, H, W, C]; a, d: [B, C]."""
    cmin = y.amin(dim=(1, 2)).to(torch.float32)
    cmax = y.amax(dim=(1, 2)).to(torch.float32)
    hi = torch.maximum(a * cmax, a * cmin) + d
    amax = torch.clamp(hi, min=0.0).amax(dim=1, keepdim=True)
    s = torch.where(amax > 0, div_rn(127.0, amax), 1.0)[:, :, None, None]
    t = torch.clamp(y.to(torch.float32) * a[:, None, None, :] + d[:, None, None, :], min=0.0) * s
    return torch.clamp(torch.round(t), -127, 127).to(torch.int8)


def conv3x3_adain_relu_requant_plain(x_i8, w_packed, gamma, beta, eps: float = _EPS):
    """conv3x3 -> IN -> AdaIN -> ReLU -> per-sample requant (``_kernel_relu``)."""
    y = conv3x3_i64(x_i8, w_packed)
    return _relu_requant(y, *_channel_affine(y, gamma, beta, eps))[0]


def in_relu_requant_i64(y: torch.Tensor, eps: float = _EPS, stage: str = "int32"):
    """Plain IN -> ReLU -> per-sample requant of an exact int64 conv output [B, H, W, C].

    The epilogue of the ConvT and encoder sites: the relu site's affine with
    gamma = 1, beta = 0 (same bits as the TPU kernels' ``rsqrt`` and
    ``-mean * a``). Returns (int8, inverse scale [B, 1])."""
    b, c = y.shape[0], y.shape[-1]
    ones = torch.ones((b, c), dtype=torch.float32, device=y.device)
    return _relu_requant(y, *_channel_affine(y, ones, torch.zeros_like(ones), eps), stage)


def convt4x4s2_in_relu_requant_ps_plain(x_i8, w_ps, eps: float = _EPS, stage: str = "int32"):
    """ConvT 4x4/s2 -> IN -> ReLU -> per-sample requant (``_kernel_up_ps``).

    IN statistics per output channel over all four phases. Returns (int8
    [B, 2H, 2W, Cout], inverse scale [B, 1])."""
    return in_relu_requant_i64(convt4x4s2_i64(x_i8, w_ps), eps, stage)


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
    return q, torch.where(amax > 0, div_by(amax, 127.0), 1.0)


def conv3x3_adain_residual_hifi_plain(y1_i8, h_bf16, w_packed, gamma, beta, eps: float = _EPS):
    """conv3x3 -> IN -> AdaIN -> + the bf16 residual -> (int8 copy, bf16 carry)
    (``_kernel_res_hifi``).

    hn = y*a + d + float(h) in fp32; the carry out is hn rounded to bf16; the
    amax is taken from the fp32 hn, and the int8 copy is quantized from the
    rounded carry (fused_conv_int8_v2.py:227-239)."""
    y = conv3x3_i64(y1_i8, w_packed)
    a, d = _channel_affine(y, gamma, beta, eps)
    hn = y.to(torch.float32) * a[:, None, None, :] + d[:, None, None, :] + h_bf16.to(torch.float32)
    carry = hn.to(torch.bfloat16)
    amax = hn.abs().amax(dim=(1, 2, 3)).reshape(-1, 1)
    s = torch.where(amax > 0, div_rn(127.0, amax), 1.0).reshape(-1, 1, 1, 1)
    q = torch.round(torch.clamp(carry.to(torch.float32) * s, -127.0, 127.0)).to(torch.int8)
    return q, carry


def conv3x3_adain_residual_hifi2_plain(y1_i8, h1_i8, h2_i8, h_scale, w_packed, gamma, beta,
                                       eps: float = _EPS):
    """conv3x3 -> IN -> AdaIN -> + (h1 + h2/254)*h_scale -> two int8 planes
    (``_kernel_res_hifi2``).

    hn = y*a + d + h1*hs + h2*hs2 with hs2 = hs * fp32(1/254), added in that
    order; t = hn * 127/amax, q1 = round(clip(t)), q2 = round(clip((t - q1) *
    254)) (fused_conv_int8_v2.py:283-302). Returns (q1, q2, new scale [B, 1] =
    amax/127)."""
    y = conv3x3_i64(y1_i8, w_packed)
    a, d = _channel_affine(y, gamma, beta, eps)
    hs = h_scale.to(torch.float32).reshape(-1, 1, 1, 1)
    hs2 = hs * torch.tensor(1.0 / 254.0, dtype=torch.float32, device=hs.device)
    hn = (y.to(torch.float32) * a[:, None, None, :] + d[:, None, None, :]
          + h1_i8.to(torch.float32) * hs + h2_i8.to(torch.float32) * hs2)
    amax = hn.abs().amax(dim=(1, 2, 3)).reshape(-1, 1)
    t = hn * torch.where(amax > 0, div_rn(127.0, amax), 1.0).reshape(-1, 1, 1, 1)
    q1 = torch.round(torch.clamp(t, -127.0, 127.0))
    q2 = torch.round(torch.clamp((t - q1) * 254.0, -127.0, 127.0))
    return q1.to(torch.int8), q2.to(torch.int8), torch.where(amax > 0, div_by(amax, 127.0), 1.0)


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


def check_statistics(shape, n_out: int, k: int) -> None:
    """The kernels' integer statistics are exact for ``n_out`` outputs per
    (sample, channel), each a sum of ``k`` int8 products of magnitude at most
    128 * 127: a warp's partial sum of squares must fit one word (max|y| <
    2^29, which also keeps the int32 accumulator exact), and the whole sum
    the two words of the statistics block (< 2^94). Every site takes a 1024²
    input's maps (the trunk's [B, 256, 256, 256] can reach 2^66.3)."""
    max_y = 128 * 127 * k
    if max_y >= 2 ** 29 or n_out * max_y ** 2 >= 2 ** 94:
        raise ValueError(f"map {tuple(shape)} too large for the exact two-word statistics: "
                         f"{n_out} outputs per channel of magnitude up to {max_y}")


def _check_site(x: torch.Tensor, w_packed, gamma, beta) -> Tuple[int, int, int, int]:
    if x.dim() != 4:
        raise ValueError(f"expected NHWC [B, H, W, C], got shape {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c % 128 or (h * w) % 128:
        raise ValueError(f"the CUDA kernel needs C % 128 == 0 and H*W % 128 == 0, got {tuple(x.shape)}")
    check_statistics(x.shape, h * w, 9 * c)
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
    check_statistics(x.shape, 4 * h * w, 4 * cin)
    _check("x", x, torch.int8, tuple(x.shape))
    _check("weights", w_ps, torch.int8, (16 * cin, cout))
    if w_ps.device != x.device:
        raise ValueError(f"all inputs must be on {x.device}, got {w_ps.device}")
    return b, h, w, cin, cout


def convt4x4s2_kernel(x_i8: torch.Tensor, w_ps: torch.Tensor, eps: float = _EPS,
                      stage: str = "int32"):
    """Launch the ConvT site's CUDA kernel on dense NHWC int8; returns (int8, inv_scale).

    Checks its inputs and raises on what the kernel does not take. It counts
    no launch: the sites that run it (``convt4x4s2_in_relu_requant_ps`` here,
    ``fused_dec_int8.up1_s2d16`` and ``up1_s2d16_hbm``) each count their own."""
    b, h, w, _, cout = _check_convt(x_i8, w_ps)
    fn = _build.load(CONVT_SOURCE, _ARGTYPES[CONVT_SOURCE])
    y, stats = _scratch(x_i8, b, 4 * h * w, cout, stage)
    out = torch.empty((b, 2 * h, 2 * w, cout), dtype=torch.int8, device=x_i8.device)
    out_scale = torch.empty((b, 1), dtype=torch.float32, device=x_i8.device)
    err = fn(x_i8.data_ptr(), w_ps.data_ptr(), y.data_ptr(), stats.data_ptr(), out.data_ptr(),
             out_scale.data_ptr(), b, h, w, x_i8.shape[3], cout, eps, int(stage == "fp16"),
             torch.cuda.current_stream(x_i8.device).cuda_stream)
    _build.check(CONVT_SOURCE, err)
    return out, out_scale


def _scratch(x: torch.Tensor, b: int, hw: int, c: int, stage: str = "int32"):
    """Pass A's accumulator scratch [b, hw, c] and the zeroed statistics block."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    y = torch.empty((b, hw, c), dtype=torch.float16 if stage == "fp16" else torch.int32,
                    device=x.device)
    stats = torch.zeros(5 * b * c + b, dtype=torch.int64, device=x.device)
    return y, stats


def true_extremes_stats(n_sites: int, b: int, c: int, device) -> torch.Tensor:
    """``n_sites`` statistics blocks [n_sites, 5*b*c + b] for the true-extremes
    mode of ``csrc/conv_int8.cuh``: zero, but the min block at INT64_MAX and
    the max block at INT64_MIN."""
    stats = torch.zeros((n_sites, 5 * b * c + b), dtype=torch.int64, device=device)
    stats[:, 2 * b * c:3 * b * c] = torch.iinfo(torch.int64).max
    stats[:, 3 * b * c:4 * b * c] = torch.iinfo(torch.int64).min
    return stats


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


def conv3x3_adain_residual_hifi(y1_i8, h_bf16, w_packed, gamma, beta, eps: float = _EPS):
    """Resblock conv2 site with a bf16 residual carry; returns (int8, bf16 carry).

    y1_i8 [B, H, W, C] int8, h_bf16 [B, H, W, C] bfloat16, w_packed [9C, C]
    int8, gamma/beta [B, C] float32. The int8 copy feeds the next conv1 (or
    the decoder), the carry the next conv2.
    """
    if y1_i8.device.type == "cpu":
        return conv3x3_adain_residual_hifi_plain(y1_i8, h_bf16, w_packed, gamma, beta, eps)
    _check("y1", y1_i8, torch.int8, tuple(y1_i8.shape))
    b, h, w, c = _check_site(y1_i8, w_packed, gamma, beta)
    _check("h", h_bf16, torch.bfloat16, tuple(y1_i8.shape))
    if h_bf16.device != y1_i8.device:
        raise ValueError(f"all inputs must be on {y1_i8.device}")
    fn = _build.load(HIFI_SITE, _ARGTYPES[HIFI_SITE])
    y, stats = _scratch(y1_i8, b, h * w, c)
    out = torch.empty_like(y1_i8)
    out_h = torch.empty_like(h_bf16)
    err = fn(y1_i8.data_ptr(), h_bf16.data_ptr(), w_packed.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), y.data_ptr(), stats.data_ptr(), out.data_ptr(), out_h.data_ptr(),
             b, h, w, c, eps, torch.cuda.current_stream(y1_i8.device).cuda_stream)
    _build.check(HIFI_SITE, err)
    LAUNCHES[HIFI_SITE] += 1
    return out, out_h


def conv3x3_adain_residual_hifi2(y1_i8, h1_i8, h2_i8, h_scale, w_packed, gamma, beta,
                                 eps: float = _EPS):
    """Resblock conv2 site with a two-plane int8 residual carry; returns (q1, q2, scale [B, 1]).

    y1_i8, h1_i8, h2_i8 [B, H, W, C] int8, h_scale [B, 1] float32, w_packed
    [9C, C] int8, gamma/beta [B, C] float32. The residual is (h1 + h2/254) *
    h_scale; q1 feeds the next conv1 (or the decoder), both planes and the
    scale the next conv2.
    """
    if y1_i8.device.type == "cpu":
        return conv3x3_adain_residual_hifi2_plain(y1_i8, h1_i8, h2_i8, h_scale, w_packed, gamma,
                                                  beta, eps)
    _check("y1", y1_i8, torch.int8, tuple(y1_i8.shape))
    b, h, w, c = _check_site(y1_i8, w_packed, gamma, beta)
    _check("h1", h1_i8, torch.int8, tuple(y1_i8.shape))
    _check("h2", h2_i8, torch.int8, tuple(y1_i8.shape))
    _check("h_scale", h_scale, torch.float32, (b, 1))
    for t in (h1_i8, h2_i8, h_scale):
        if t.device != y1_i8.device:
            raise ValueError(f"all inputs must be on {y1_i8.device}, got {t.device}")
    fn = _build.load(HIFI2_SITE, _ARGTYPES[HIFI2_SITE])
    y, stats = _scratch(y1_i8, b, h * w, c)
    out1, out2 = torch.empty_like(y1_i8), torch.empty_like(y1_i8)
    out_scale = torch.empty((b, 1), dtype=torch.float32, device=y1_i8.device)
    err = fn(y1_i8.data_ptr(), h1_i8.data_ptr(), h2_i8.data_ptr(), h_scale.data_ptr(),
             w_packed.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
             stats.data_ptr(), out1.data_ptr(), out2.data_ptr(), out_scale.data_ptr(),
             b, h, w, c, eps, torch.cuda.current_stream(y1_i8.device).cuda_stream)
    _build.check(HIFI2_SITE, err)
    LAUNCHES[HIFI2_SITE] += 1
    return out1, out2, out_scale


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
