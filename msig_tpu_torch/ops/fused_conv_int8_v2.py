"""The int8 conv sites that end in an instance norm: CUDA kernels and their plain versions.

Counterpart of ``msig_tpu/ops/fused_conv_int8_v2.py``: the resblock trunk's
3x3 sites (conv1, and conv2 with each of its three residual carries), the
decoder's phase-split ConvT 4x4/s2 site and its 9-tap K-concat form
(``convt4x4s2_in_relu_requant``, the same function on the [9*Cin, 4*Cout]
operand of ``fused_conv_int8.pack_convt_weights``); the encoder's
sites (``fused_enc_int8.py``) share the epilogue and the checks here. The TPU
kernels work on a guard-padded row slab (and the ConvT on a space-to-depth
slab) shaped for VMEM; here every site takes and gives dense NHWC int8
``[B, H, W, C]``. ``guard_rows`` and ``from_padded_rows`` know the row slab
only so that tests can unpack the JAX kernels' outputs.

Each site has:

* a wrapper (``conv3x3_adain_relu_requant``, ``conv3x3_adain_residual_requant``,
  ``conv3x3_adain_residual_hifi``, ``conv3x3_adain_residual_hifi2``,
  ``convt4x4s2_in_relu_requant_ps``, ``convt4x4s2_in_relu_requant``) that,
  for CUDA tensors, launches the
  kernel of ``msig_tpu_torch/csrc`` and adds one to its entry of
  ``LAUNCHES``, or raises;
* a plain PyTorch version (``*_plain``) with the same arithmetic, which the
  wrapper runs for CPU tensors and which ``chip_smoke.py`` holds the kernel
  against on the card.

Every site runs its conv on ``wgmma`` (``csrc/conv_i8_wgmma.cuh``), which
reads the weights K-major: the wrappers take the ``[C, 9C]`` copy of
``pack_weights_kmajor`` (the ConvT's ``[4, Cout, 4*Cin]`` copy of
``pack_convt_weights_ps_kmajor``, the 9-tap site's of
``pack_convt_kcat_kmajor``) as the keyword ``w_kmajor`` (made once at
quantization) and make it themselves when a caller passes only the packed
weights. Both ConvT sites run their conv twice, once for the statistics and
once to write int8, and allocate no accumulator scratch.

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
KCAT_SITE = "convt4x4s2_in_relu_requant"
KERNELS = (RELU_SITE, RESIDUAL_SITE, HIFI_SITE, HIFI2_SITE, CONVT_SITE, KCAT_SITE)

# csrc sources, one shared library each. The ConvT source also serves
# ``fused_dec_int8.up1_s2d16`` and ``up1_s2d16_hbm``, which count their launches
# there, and (entry ``msig_convt4x4s2_kcat``) the K-concat site here and the v1
# ConvT site of ``fused_conv_int8``; the relu and residual sources also serve
# the v1 trunk sites there.
CONVT_SOURCE = "convt4x4s2_in_relu_requant"
SOURCES = (RELU_SITE, RESIDUAL_SITE, HIFI_SITE, HIFI2_SITE, CONVT_SOURCE)

# How pass A's accumulator crosses device memory to the epilogue: as int32,
# or as fp16 holding y * 2^-12 (``STAGE_SCALE`` of
# ``msig_tpu/ops/fused_dec_int8.py``), which the staged 512² sites may take
# (the ConvT site, which keeps its accumulator on chip, rounds it the same way
# in registers).
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
    CONVT_SOURCE: [_P] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, _P],
}
# entry msig_convt4x4s2_kcat of CONVT_SOURCE
_KCAT_ARGTYPES = [_P] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, _P]

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


def pack_weights_kmajor(w_packed: torch.Tensor) -> torch.Tensor:
    """[9C, Co] packed int8 weights -> [Co, 9C], the transpose: row co holds
    the K = (ky*3 + kx)*C + ci of output channel co contiguous, as ``wgmma``
    takes an 8-bit B operand (K-major only)."""
    if w_packed.dim() != 2 or w_packed.shape[0] % 9:
        raise ValueError(f"expected packed weights [9C, Co], got {tuple(w_packed.shape)}")
    return w_packed.to(torch.int8).t().contiguous()


def pack_convt_weights(w_hwio: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """ConvT 4x4/s2 kernel [4, 4, cin, cout] -> [9*cin, 4*cout] int8, the 9-tap K-concat.

    Row block t = (dy+1)*3 + dx+1 (dy, dx in -1, 0, 1), column block q = 2*qy + qx
    holds w[2dy+2-qy, 2dx+2-qx] where both indices lie in [0, 4), else zeros
    (20 of the 36 blocks): bit-equal to ``msig_tpu/ops/fused_conv_int8.py::
    pack_convt_weights``."""
    if tuple(w_hwio.shape) != (4, 4, cin, cout):
        raise ValueError(f"expected a [4, 4, {cin}, {cout}] kernel, got {tuple(w_hwio.shape)}")
    w = w_hwio.to(torch.int8)
    packed = torch.zeros((9 * cin, 4 * cout), dtype=torch.int8, device=w.device)
    for t in range(9):
        dy, dx = t // 3 - 1, t % 3 - 1
        for q in range(4):
            u, v = 2 * dy + 2 - q // 2, 2 * dx + 2 - q % 2
            if 0 <= u < 4 and 0 <= v < 4:
                packed[t * cin:(t + 1) * cin, q * cout:(q + 1) * cout] = w[u, v]
    return packed


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


def pack_convt_weights_ps_kmajor(w_ps: torch.Tensor) -> torch.Tensor:
    """[16*Cin, Cout] phase-major ConvT weights (``pack_convt_weights_ps``) ->
    [4, Cout, 4*Cin]: each phase's [4*Cin, Cout] block transposed, so that row
    co of phase q holds its K = t*Cin + ci contiguous, as ``wgmma`` takes an
    8-bit B operand (K-major only)."""
    if w_ps.dim() != 2 or w_ps.shape[0] % 16:
        raise ValueError(f"expected packed ConvT weights [16*Cin, Cout], got {tuple(w_ps.shape)}")
    return w_ps.to(torch.int8).reshape(4, w_ps.shape[0] // 4, w_ps.shape[1]).transpose(1, 2) \
        .contiguous()


def pack_convt_kcat_kmajor(w_kcat: torch.Tensor) -> torch.Tensor:
    """[9*Cin, 4*Cout] 9-tap K-concat ConvT weights (``pack_convt_weights``) ->
    [4, Cout, 4*Cin], the K-major copy of its 16 nonzero blocks: phase q's
    K index t*Cin + ci is tap t of ``PS_TAPS[q]``, (dy, dx), read from row
    block (dy+1)*3 + dx+1 of column block q. For an operand made by
    ``pack_convt_weights(w)`` it equals
    ``pack_convt_weights_ps_kmajor(pack_convt_weights_ps(w))``; the 20 blocks
    that packing leaves zero are not read."""
    if w_kcat.dim() != 2 or w_kcat.shape[0] % 9 or w_kcat.shape[1] % 4:
        raise ValueError(f"expected K-concat ConvT weights [9*Cin, 4*Cout], got "
                         f"{tuple(w_kcat.shape)}")
    cin, cout = w_kcat.shape[0] // 9, w_kcat.shape[1] // 4
    w = w_kcat.to(torch.int8).contiguous()
    # Phase q = (qy, qx) takes tap t = (a, b) from row block (qy + a, qx + b) of
    # the 3 x 3 and column block q (PS_TAPS: dy + 1 = qy + a, dx + 1 = qx + b):
    # one strided view [qy, qx, a, b, ci, co] of the operand, copied once.
    s_ry, s_rx, s_qy, s_qx = 3 * cin * 4 * cout, cin * 4 * cout, 2 * cout, cout
    v = w.as_strided((2, 2, 2, 2, cin, cout),
                     (s_ry + s_qy, s_rx + s_qx, s_ry, s_rx, 4 * cout, 1))
    return v.permute(0, 1, 5, 2, 3, 4).reshape(4, cout, 4 * cin).contiguous()


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


def convt4x4s2_kcat_i64(x_i8: torch.Tensor, w_kcat: torch.Tensor) -> torch.Tensor:
    """Exact int8 ConvT 4x4/s2/p1 from the 9-tap K-concat operand, NHWC
    [B, H, W, Cin] -> int64 [B, 2H, 2W, Cout].

    As the TPU kernels compute it: the nine shifted input maps concatenated
    along channels times ``w_kcat`` [9*Cin, 4*Cout] give the four phases side
    by side (space-to-depth), in float64, where every partial sum is an exact
    integer; then each phase goes to its pixels."""
    b, h, w, cin = x_i8.shape
    cout = w_kcat.shape[1] // 4
    xp = F.pad(x_i8.to(torch.float64), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dim=3)
    y = (cols @ w_kcat.to(torch.float64)).reshape(b, h, w, 2, 2, cout)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, cout).to(torch.int64)


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


def true_relu_amax(y: torch.Tensor, a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The largest of max(a*max y, a*min y) + d and 0 over the channels, with the
    true per-channel extremes of y [B, H, W, C] (``true_relu_amax`` of
    ``csrc/conv_int8.cuh``); [B, 1]."""
    cmin = y.amin(dim=(1, 2)).to(torch.float32)
    cmax = y.amax(dim=(1, 2)).to(torch.float32)
    hi = torch.maximum(a * cmax, a * cmin) + d
    return torch.clamp(hi, min=0.0).amax(dim=1, keepdim=True)


def relu_requant_true(y: torch.Tensor, a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """IN affine -> ReLU -> per-sample requant with the true extremes, unfolded.

    The epilogue of the single-kernel trunk's conv1 (``fused_trunk_v3.py:112-124``)
    and of the chunked epilogue (``int8_epilogue_chunked.py:79-95``): amax is
    the largest of max(a*max y, a*min y) + d and 0 over the channels, with the
    true per-channel min and max, and q = clip(round(max(y*a + d, 0) * s), +-127),
    s = 127/amax (``true_relu_amax`` and ``relu_requant_unfolded`` of
    ``csrc/conv_int8.cuh``). y: exact int64 [B, H, W, C]; a, d: [B, C]."""
    amax = true_relu_amax(y, a, d)
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


def convt4x4s2_in_relu_requant_plain(x_i8, w_kcat, eps: float = _EPS):
    """The K-concat ConvT -> IN -> ReLU -> per-sample requant (``_kernel_up``):
    row 5's epilogue on the same int64 sums. Returns (int8 [B, 2H, 2W, Cout],
    inverse scale [B, 1])."""
    return in_relu_requant_i64(convt4x4s2_kcat_i64(x_i8, w_kcat), eps)


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


def _kmajor(w_packed: torch.Tensor, w_kmajor, pack, shape, name: str = "w_kmajor"
            ) -> torch.Tensor:
    """The kernel's own weight copy on the card (the K-major weights of the
    wgmma sites, the fragment order of the final conv): ``w_kmajor`` checked
    (int8 of ``shape``, contiguous, on ``w_packed``'s device), or the copy
    ``pack(w_packed)`` where it is None. ``name`` is the keyword it came by."""
    if w_kmajor is None:
        return pack(w_packed)
    _check(name, w_kmajor, torch.int8, shape)
    if w_kmajor.device != w_packed.device:
        raise ValueError(f"all inputs must be on {w_packed.device}, got {w_kmajor.device}")
    return w_kmajor


def _check_kmajor_shape(w_kmajor, shape, name: str = "w_kmajor") -> None:
    """The CPU side of ``_kmajor``: the plain versions read the packed
    weights, so a kernel's copy given with CPU tensors is only checked for
    dtype and shape."""
    if w_kmajor is not None and (w_kmajor.dtype != torch.int8
                                 or tuple(w_kmajor.shape) != tuple(shape)):
        raise ValueError(f"{name} must be int8 of shape {tuple(shape)}, got {w_kmajor.dtype} "
                         f"{tuple(w_kmajor.shape)}")


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


def _check_convt_kcat(x: torch.Tensor, w_kcat: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """Checks of the K-concat ConvT sites on CUDA tensors; returns (b, h, w, cin, cout)."""
    if x.dim() != 4 or w_kcat.dim() != 2 or w_kcat.shape[1] % 4:
        raise ValueError(f"expected x [B, H, W, Cin] and w [9*Cin, 4*Cout], got "
                         f"{tuple(x.shape)} and {tuple(w_kcat.shape)}")
    b, h, w, cin = x.shape
    cout = w_kcat.shape[1] // 4
    if cin % 64 or cout % 64 or (h * w) % 128:
        raise ValueError(f"the CUDA kernel needs Cin % 64 == 0, Cout % 64 == 0 and "
                         f"H*W % 128 == 0, got x {tuple(x.shape)}, Cout {cout}")
    check_statistics(x.shape, 4 * h * w, 4 * cin)
    _check("x", x, torch.int8, tuple(x.shape))
    _check("weights", w_kcat, torch.int8, (9 * cin, 4 * cout))
    if w_kcat.device != x.device:
        raise ValueError(f"all inputs must be on {x.device}, got {w_kcat.device}")
    return b, h, w, cin, cout


def convt4x4s2_kcat_kernel(x_i8: torch.Tensor, w_kcat: torch.Tensor, eps: float = _EPS,
                           true_extremes: bool = False, *, w_kmajor=None):
    """Launch the K-concat ConvT kernel (entry ``msig_convt4x4s2_kcat``: the
    ConvT site's two ``wgmma`` passes) on dense NHWC int8; returns (int8
    [B, 2H, 2W, Cout], inv_scale [B, 1]).

    The kernel reads the K-major copy of the operand's nonzero blocks:
    ``w_kmajor`` (``pack_convt_kcat_kmajor(w_kcat)``), checked, or the copy
    made here where it is None. ``true_extremes`` picks the v1 statistics and
    requant (true per-channel extremes, unfolded) over the v2 ones
    (zero-masked, folded). It counts no launch: ``convt4x4s2_in_relu_requant``
    here and the v1 site of ``fused_conv_int8`` each count their own."""
    b, h, w, cin, cout = _check_convt_kcat(x_i8, w_kcat)
    wk = _kmajor(w_kcat, w_kmajor, pack_convt_kcat_kmajor, convt_kcat_kmajor_shape(w_kcat))
    fn = _build.load(CONVT_SOURCE, _KCAT_ARGTYPES, entry="msig_convt4x4s2_kcat")
    # the statistics block only: the C entry sets it on the stream
    stats = torch.empty(5 * b * cout + b, dtype=torch.int64, device=x_i8.device)
    out = torch.empty((b, 2 * h, 2 * w, cout), dtype=torch.int8, device=x_i8.device)
    out_scale = torch.empty((b, 1), dtype=torch.float32, device=x_i8.device)
    err = fn(x_i8.data_ptr(), wk.data_ptr(), stats.data_ptr(), out.data_ptr(),
             out_scale.data_ptr(), b, h, w, cin, cout, eps, int(true_extremes),
             torch.cuda.current_stream(x_i8.device).cuda_stream)
    _build.check(CONVT_SOURCE, err)
    return out, out_scale


def convt_kmajor_shape(w_ps: torch.Tensor) -> Tuple[int, int, int]:
    """The shape [4, Cout, 4*Cin] of ``pack_convt_weights_ps_kmajor(w_ps)``."""
    return 4, w_ps.shape[1], w_ps.shape[0] // 4


def convt_kcat_kmajor_shape(w_kcat: torch.Tensor) -> Tuple[int, int, int]:
    """The shape [4, Cout, 4*Cin] of ``pack_convt_kcat_kmajor(w_kcat)``."""
    return 4, w_kcat.shape[1] // 4, 4 * (w_kcat.shape[0] // 9)


def convt4x4s2_kernel(x_i8: torch.Tensor, w_ps: torch.Tensor, eps: float = _EPS,
                      stage: str = "int32", *, w_kmajor=None):
    """Launch the ConvT site's CUDA kernel on dense NHWC int8; returns (int8, inv_scale).

    The kernel reads the K-major weights: ``w_kmajor``
    (``pack_convt_weights_ps_kmajor(w_ps)``), checked, or the copy made here
    where it is None. Checks its inputs and raises on what the kernel does not
    take. It counts no launch: the sites that run it
    (``convt4x4s2_in_relu_requant_ps`` here, ``fused_dec_int8.up1_s2d16`` and
    ``up1_s2d16_hbm``) each count their own."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    b, h, w, cin, cout = _check_convt(x_i8, w_ps)
    wk = _kmajor(w_ps, w_kmajor, pack_convt_weights_ps_kmajor, convt_kmajor_shape(w_ps))
    fn = _build.load(CONVT_SOURCE, _ARGTYPES[CONVT_SOURCE])
    # the statistics block only: the C entry zeroes it on the stream
    stats = torch.empty(5 * b * cout + b, dtype=torch.int64, device=x_i8.device)
    out = torch.empty((b, 2 * h, 2 * w, cout), dtype=torch.int8, device=x_i8.device)
    out_scale = torch.empty((b, 1), dtype=torch.float32, device=x_i8.device)
    err = fn(x_i8.data_ptr(), wk.data_ptr(), stats.data_ptr(), out.data_ptr(),
             out_scale.data_ptr(), b, h, w, cin, cout, eps, int(stage == "fp16"),
             torch.cuda.current_stream(x_i8.device).cuda_stream)
    _build.check(CONVT_SOURCE, err)
    return out, out_scale


def wgmma_config() -> Dict[str, int]:
    """The trunk sites' wgmma pass A as built (entry ``msig_conv3x3_i8_wgmma_config``
    of the relu source): tile, ring, threads, registers after ``setmaxnreg`` and
    dynamic shared memory per CTA at each channel tile. Builds the source."""
    fn = _build.load(RELU_SITE, [ctypes.POINTER(ctypes.c_int)],
                     entry="msig_conv3x3_i8_wgmma_config")
    out = (ctypes.c_int * 8)()
    _build.check(RELU_SITE, fn(out))
    keys = ("tile_m", "tile_k_bytes", "stages", "threads", "producer_regs", "consumer_regs",
            "smem_bytes_n256", "smem_bytes_n128")
    return dict(zip(keys, out))


def convt_wgmma_config() -> Dict[str, int]:
    """The ConvT site's two wgmma passes as built (entry
    ``msig_convt_i8_wgmma_config`` of the ConvT source): tile pixels, and for
    pass S and pass Q at each channel tile the bytes of K a stage, the stages
    of the ring and the dynamic shared memory per CTA. Builds the source."""
    fn = _build.load(CONVT_SOURCE, [ctypes.POINTER(ctypes.c_int)],
                     entry="msig_convt_i8_wgmma_config")
    out = (ctypes.c_int * 13)()
    _build.check(CONVT_SOURCE, fn(out))
    keys = ["tile_m"] + [f"{what}_{p}_n{bn}" for bn in (128, 64) for p in ("stats", "requant")
                         for what in ("k_bytes", "stages", "smem_bytes")]
    return dict(zip(keys, out))


def _scratch(x: torch.Tensor, b: int, hw: int, c: int, stage: str = "int32"):
    """Pass A's accumulator scratch [b, hw, c] and the statistics block, not
    zeroed (the wgmma sites' C entries zero it on the stream)."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    y = torch.empty((b, hw, c), dtype=torch.float16 if stage == "fp16" else torch.int32,
                    device=x.device)
    return y, torch.empty(5 * b * c + b, dtype=torch.int64, device=x.device)


def true_extremes_stats(n_sites: int, b: int, c: int, device) -> torch.Tensor:
    """``n_sites`` statistics blocks [n_sites, 5*b*c + b] for the true-extremes
    mode of ``csrc/conv_int8.cuh`` (the single-kernel trunk's): zero, but the
    min block at INT64_MAX and the max block at INT64_MIN. (The v1 sites' C
    entries set theirs on the stream, the extremes at the int32 ends.)"""
    stats = torch.zeros((n_sites, 5 * b * c + b), dtype=torch.int64, device=device)
    stats[:, 2 * b * c:3 * b * c] = torch.iinfo(torch.int64).max
    stats[:, 3 * b * c:4 * b * c] = torch.iinfo(torch.int64).min
    return stats


def conv3x3_adain_relu_requant(x_i8, w_packed, gamma, beta, eps: float = _EPS, *,
                               w_kmajor=None):
    """Resblock conv1 site on dense NHWC int8; see the module docstring.

    x_i8 [B, H, W, C] int8, w_packed [9C, C] int8, gamma/beta [B, C] float32;
    w_kmajor, optional, ``pack_weights_kmajor(w_packed)``, which the kernel reads.
    """
    if x_i8.device.type == "cpu":
        _check_kmajor_shape(w_kmajor, (x_i8.shape[-1], 9 * x_i8.shape[-1]))
        return conv3x3_adain_relu_requant_plain(x_i8, w_packed, gamma, beta, eps)
    _check("x", x_i8, torch.int8, tuple(x_i8.shape))
    b, h, w, c = _check_site(x_i8, w_packed, gamma, beta)
    wk = _kmajor(w_packed, w_kmajor, pack_weights_kmajor, (c, 9 * c))
    fn = _build.load(RELU_SITE, _ARGTYPES[RELU_SITE])
    y, stats = _scratch(x_i8, b, h * w, c)
    out = torch.empty_like(x_i8)
    err = fn(x_i8.data_ptr(), wk.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
             y.data_ptr(), stats.data_ptr(), out.data_ptr(), b, h, w, c, eps,
             torch.cuda.current_stream(x_i8.device).cuda_stream)
    _build.check(RELU_SITE, err)
    LAUNCHES[RELU_SITE] += 1
    return out


def conv3x3_adain_residual_requant(y1_i8, h_i8, h_scale, w_packed, gamma, beta,
                                   eps: float = _EPS, *, w_kmajor=None):
    """Resblock conv2 site on dense NHWC int8; returns (int8, scale [B, 1]).

    y1_i8, h_i8 [B, H, W, C] int8, h_scale [B, 1] float32, w_packed [9C, C]
    int8, gamma/beta [B, C] float32; w_kmajor, optional,
    ``pack_weights_kmajor(w_packed)``, which the kernel reads.
    """
    if y1_i8.device.type == "cpu":
        _check_kmajor_shape(w_kmajor, (y1_i8.shape[-1], 9 * y1_i8.shape[-1]))
        return conv3x3_adain_residual_requant_plain(y1_i8, h_i8, h_scale, w_packed, gamma,
                                                    beta, eps)
    out = residual_kernel(y1_i8, h_i8, h_scale, w_packed, gamma, beta, eps, w_kmajor=w_kmajor)
    LAUNCHES[RESIDUAL_SITE] += 1
    return out


def residual_kernel(y1_i8, h_i8, h_scale, w_packed, gamma, beta, eps: float = _EPS, *,
                    w_kmajor=None):
    """Check the inputs of the residual site and launch its kernel; returns
    (int8, scale [B, 1]). It counts no launch: ``conv3x3_adain_residual_requant``
    here and the v1 site of ``fused_conv_int8`` each count their own."""
    _check("y1", y1_i8, torch.int8, tuple(y1_i8.shape))
    b, h, w, c = _check_site(y1_i8, w_packed, gamma, beta)
    _check("h", h_i8, torch.int8, tuple(y1_i8.shape))
    _check("h_scale", h_scale, torch.float32, (b, 1))
    if h_i8.device != y1_i8.device or h_scale.device != y1_i8.device:
        raise ValueError(f"all inputs must be on {y1_i8.device}")
    wk = _kmajor(w_packed, w_kmajor, pack_weights_kmajor, (c, 9 * c))
    fn = _build.load(RESIDUAL_SITE, _ARGTYPES[RESIDUAL_SITE])
    y, stats = _scratch(y1_i8, b, h * w, c)
    out = torch.empty_like(y1_i8)
    out_scale = torch.empty((b, 1), dtype=torch.float32, device=y1_i8.device)
    err = fn(y1_i8.data_ptr(), h_i8.data_ptr(), h_scale.data_ptr(), wk.data_ptr(),
             gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), stats.data_ptr(),
             out.data_ptr(), out_scale.data_ptr(), b, h, w, c, eps,
             torch.cuda.current_stream(y1_i8.device).cuda_stream)
    _build.check(RESIDUAL_SITE, err)
    return out, out_scale


def conv3x3_adain_residual_hifi(y1_i8, h_bf16, w_packed, gamma, beta, eps: float = _EPS, *,
                                w_kmajor=None):
    """Resblock conv2 site with a bf16 residual carry; returns (int8, bf16 carry).

    y1_i8 [B, H, W, C] int8, h_bf16 [B, H, W, C] bfloat16, w_packed [9C, C]
    int8, gamma/beta [B, C] float32; w_kmajor, optional,
    ``pack_weights_kmajor(w_packed)``, which the kernel reads. The int8 copy
    feeds the next conv1 (or the decoder), the carry the next conv2.
    """
    if y1_i8.device.type == "cpu":
        _check_kmajor_shape(w_kmajor, (y1_i8.shape[-1], 9 * y1_i8.shape[-1]))
        return conv3x3_adain_residual_hifi_plain(y1_i8, h_bf16, w_packed, gamma, beta, eps)
    _check("y1", y1_i8, torch.int8, tuple(y1_i8.shape))
    b, h, w, c = _check_site(y1_i8, w_packed, gamma, beta)
    _check("h", h_bf16, torch.bfloat16, tuple(y1_i8.shape))
    if h_bf16.device != y1_i8.device:
        raise ValueError(f"all inputs must be on {y1_i8.device}")
    wk = _kmajor(w_packed, w_kmajor, pack_weights_kmajor, (c, 9 * c))
    fn = _build.load(HIFI_SITE, _ARGTYPES[HIFI_SITE])
    y, stats = _scratch(y1_i8, b, h * w, c)
    out = torch.empty_like(y1_i8)
    out_h = torch.empty_like(h_bf16)
    err = fn(y1_i8.data_ptr(), h_bf16.data_ptr(), wk.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), y.data_ptr(), stats.data_ptr(), out.data_ptr(), out_h.data_ptr(),
             b, h, w, c, eps, torch.cuda.current_stream(y1_i8.device).cuda_stream)
    _build.check(HIFI_SITE, err)
    LAUNCHES[HIFI_SITE] += 1
    return out, out_h


def conv3x3_adain_residual_hifi2(y1_i8, h1_i8, h2_i8, h_scale, w_packed, gamma, beta,
                                 eps: float = _EPS, *, w_kmajor=None):
    """Resblock conv2 site with a two-plane int8 residual carry; returns (q1, q2, scale [B, 1]).

    y1_i8, h1_i8, h2_i8 [B, H, W, C] int8, h_scale [B, 1] float32, w_packed
    [9C, C] int8, gamma/beta [B, C] float32; w_kmajor, optional,
    ``pack_weights_kmajor(w_packed)``, which the kernel reads. The residual is
    (h1 + h2/254) * h_scale; q1 feeds the next conv1 (or the decoder), both
    planes and the scale the next conv2.
    """
    if y1_i8.device.type == "cpu":
        _check_kmajor_shape(w_kmajor, (y1_i8.shape[-1], 9 * y1_i8.shape[-1]))
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
    wk = _kmajor(w_packed, w_kmajor, pack_weights_kmajor, (c, 9 * c))
    fn = _build.load(HIFI2_SITE, _ARGTYPES[HIFI2_SITE])
    y, stats = _scratch(y1_i8, b, h * w, c)
    out1, out2 = torch.empty_like(y1_i8), torch.empty_like(y1_i8)
    out_scale = torch.empty((b, 1), dtype=torch.float32, device=y1_i8.device)
    err = fn(y1_i8.data_ptr(), h1_i8.data_ptr(), h2_i8.data_ptr(), h_scale.data_ptr(),
             wk.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
             stats.data_ptr(), out1.data_ptr(), out2.data_ptr(), out_scale.data_ptr(),
             b, h, w, c, eps, torch.cuda.current_stream(y1_i8.device).cuda_stream)
    _build.check(HIFI2_SITE, err)
    LAUNCHES[HIFI2_SITE] += 1
    return out1, out2, out_scale


def convt4x4s2_in_relu_requant_ps(x_i8, w_ps, eps: float = _EPS, *, w_kmajor=None):
    """Decoder up0 site on dense NHWC int8; returns (int8 [B, 2H, 2W, Cout], inv_scale [B, 1]).

    x_i8 [B, H, W, Cin] int8, w_ps [16*Cin, Cout] int8 from
    ``pack_convt_weights_ps``; w_kmajor, optional,
    ``pack_convt_weights_ps_kmajor(w_ps)``, which the kernel reads.
    """
    if x_i8.device.type == "cpu":
        _check_kmajor_shape(w_kmajor, convt_kmajor_shape(w_ps))
        return convt4x4s2_in_relu_requant_ps_plain(x_i8, w_ps, eps)
    out = convt4x4s2_kernel(x_i8, w_ps, eps, w_kmajor=w_kmajor)
    LAUNCHES[CONVT_SITE] += 1
    return out


def convt4x4s2_in_relu_requant(x_i8, w_kcat, eps: float = _EPS, *, w_kmajor=None):
    """The 9-tap K-concat up site on dense NHWC int8; returns (int8 [B, 2H, 2W,
    Cout], inv_scale [B, 1]).

    x_i8 [B, H, W, Cin] int8 of a square map, H % 16 == 0 (the TPU kernel's
    16-row chunks), w_kcat [9*Cin, 4*Cout] int8, which must come from
    ``pack_convt_weights`` (as the TPU kernel's docstring requires): the
    kernel reads only the 16 blocks that packing fills, through their K-major
    copy ``w_kmajor`` (``pack_convt_kcat_kmajor(w_kcat)``, optional, made
    here where it is None), so the result is ``convt4x4s2_in_relu_requant_ps``'s
    on the same weights, its kernel's to the bit. The plain version multiplies
    all nine row blocks, as the TPU does."""
    if x_i8.dim() != 4 or x_i8.shape[1] != x_i8.shape[2] or x_i8.shape[1] % 16:
        raise ValueError(f"expected a square map [B, H, H, Cin] with H % 16 == 0, got "
                         f"{tuple(x_i8.shape)}")
    if w_kcat.dim() != 2 or w_kcat.shape[0] != 9 * x_i8.shape[3] or w_kcat.shape[1] % 4:
        raise ValueError(f"expected weights [9*Cin, 4*Cout] for Cin {x_i8.shape[3]}, got "
                         f"{tuple(w_kcat.shape)}")
    if x_i8.device.type == "cpu":
        _check_kmajor_shape(w_kmajor, convt_kcat_kmajor_shape(w_kcat))
        return convt4x4s2_in_relu_requant_plain(x_i8, w_kcat, eps)
    out = convt4x4s2_kcat_kernel(x_i8, w_kcat, eps, w_kmajor=w_kmajor)
    LAUNCHES[KCAT_SITE] += 1
    return out
