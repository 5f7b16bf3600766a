"""The v1 fused int8 conv sites: CUDA kernels and their plain versions.

Counterpart of ``msig_tpu/ops/fused_conv_int8.py``, the first form of the
TPU's fused sites, which the JAX package runs only from its tools
(``tools/bench_v1_v2.py``, ``tools/profile_fused_stages.py``; here
``msig_tpu_torch/tools``):

* ``conv3x3_adain_relu_requant``: 3x3 conv -> IN -> AdaIN -> ReLU -> requant
  of a 64x64 map, C % 128 == 0 (``_kernel``);
* ``conv3x3_adain_residual_requant``: 3x3 conv -> IN -> AdaIN -> + the int8
  residual times its scale -> requant with the true max|hn| (``_kernel_res``);
* ``convt4x4s2_in_relu_requant``: ConvT 4x4/s2 on the 9-tap K-concat weight
  operand of ``pack_convt_weights`` -> IN -> ReLU -> requant, any square map
  (``_kernel_up``).

The TPU kernels work on a slab of flattened rows with zero guard rows (and
the ConvT writes space-to-depth); every site here takes and gives dense NHWC
int8, as the port's other sites do. The slab helpers (``pad_to_rows``,
``pad_rows``, ``unpad_rows``, ``unphase_s2d``) and constants (``SROWS``,
``XROWS``, ``GUARD``) have no caller in the package: they are kept for the
tests, which pack inputs for the JAX kernels and unpack their outputs.

The v1 relu and ConvT sites differ from v2's in their requant: the true
per-channel extremes (the TPU starts them at +-inf) and the unfolded
``max(y*a + d, 0) * s`` (``fc.relu_requant_true``), where v2 zero-masks the
extremes and folds s into a and d. The residual site computes v2's function.

Kernels (``msig_tpu_torch/csrc``), all on the ``wgmma`` main loop of
``conv_i8_wgmma.cuh``: the relu site is the second entry of
``conv3x3_adain_relu_requant.cu`` (row 1's pass A with the true extremes,
then the unfolded epilogue), the residual site row 2's entry of
``conv3x3_adain_residual_requant.cu``, the ConvT site the K-concat entry of
``convt4x4s2_in_relu_requant.cu`` in its true-extremes mode (the phase-split
site's two passes). They read K-major weights: each wrapper takes them as
the keyword ``w_kmajor`` (``fc.pack_weights_kmajor(w_packed)`` for the 3x3
sites, ``fc.pack_convt_kcat_kmajor(w_kcat)`` for the ConvT), or makes them
where a caller passes none. Each wrapper launches its kernel for CUDA tensors
and adds one to its entry of ``LAUNCHES``, or raises; for CPU tensors it
runs its plain version. Both check the shapes the JAX wrapper asserts.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from msig_tpu_torch.ops import _build
from msig_tpu_torch.ops import fused_conv_int8_v2 as fc

_EPS = 1e-5

# The TPU slab of the 64x64 trunk map (fused_conv_int8.py:51-56).
W_IMG = 64
SROWS = W_IMG * W_IMG
GUARD = 128
XROWS = SROWS + 2 * GUARD

RELU_SITE = "conv3x3_adain_relu_requant_v1"
RESIDUAL_SITE = "conv3x3_adain_residual_requant_v1"
CONVT_SITE = "convt4x4s2_in_relu_requant_v1"
KERNELS = (RELU_SITE, RESIDUAL_SITE, CONVT_SITE)
# Shared with fused_conv_int8_v2 (see the module docstring).
SOURCES = (fc.RELU_SITE, fc.RESIDUAL_SITE, fc.CONVT_SOURCE)

# Launches per wrapper on CUDA tensors (one per call; CPU tensors do not count).
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_RELU_ENTRY = "msig_conv3x3_adain_relu_requant_v1"

# The packings are v1's (fused_conv_int8.py:69-73, :162-191), and the
# kernels' K-major copies of them.
pack_weights = fc.pack_weights
pack_convt_weights = fc.pack_convt_weights
pack_weights_kmajor = fc.pack_weights_kmajor
pack_convt_kcat_kmajor = fc.pack_convt_kcat_kmajor


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supported(c: int) -> bool:
    """The channel counts of the 3x3 sites (``fused_conv_int8.py:60-62``):
    multiples of 128. Any device of the port takes them."""
    return c % 128 == 0


# ------------------------------------------------------------- slab layout


def pad_rows(x_flat: torch.Tensor, guard: int) -> torch.Tensor:
    """[B, S, C] -> [B, S + 2*guard, C] with zero guard rows."""
    return F.pad(x_flat, (0, 0, guard, guard))


def pad_to_rows(x_flat: torch.Tensor) -> torch.Tensor:
    """[B, 4096, C] -> [B, XROWS, C], the 64x64 trunk map's slab."""
    return pad_rows(x_flat, GUARD)


def unpad_rows(x_rows: torch.Tensor, guard: int = GUARD) -> torch.Tensor:
    """Slab [B, S + 2*guard, C] of a square map -> dense [B, H, H, C]."""
    b, rows, c = x_rows.shape
    side = int(round((rows - 2 * guard) ** 0.5))
    return x_rows[:, guard:rows - guard].reshape(b, side, side, c)


def unphase_s2d(y_s2d: torch.Tensor, w_img: int, cout: int) -> torch.Tensor:
    """Space-to-depth [B, w_img*w_img, 4*cout] -> dense [B, 2*w_img, 2*w_img, cout]
    (``tools/profile_fused_stages.py:205``)."""
    b = y_s2d.shape[0]
    y = y_s2d.reshape(b, w_img, w_img, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * w_img, 2 * w_img, cout)


# ------------------------------------------------------------------ gates


def _check_trunk_site(x: torch.Tensor, w_packed: torch.Tensor) -> None:
    """What ``fused_conv_int8.py:387, :435`` assert, with ``supported``: a
    64x64 map, C % 128 == 0, weights [9C, C]."""
    if x.dim() != 4 or tuple(x.shape[1:3]) != (W_IMG, W_IMG) or not supported(x.shape[3]):
        raise ValueError(f"the v1 trunk sites take a [B, {W_IMG}, {W_IMG}, C] map with "
                         f"C % 128 == 0, got {tuple(x.shape)}")
    c = x.shape[3]
    if tuple(w_packed.shape) != (9 * c, c):
        raise ValueError(f"expected weights [{9 * c}, {c}], got {tuple(w_packed.shape)}")


def _check_convt_site(x: torch.Tensor, w_kcat: torch.Tensor) -> None:
    """What ``fused_conv_int8.py:282-286`` assert: a square map (srows =
    w_img^2) and weights [9*Cin, 4*Cout]."""
    if x.dim() != 4 or x.shape[1] != x.shape[2]:
        raise ValueError(f"the v1 ConvT site takes a square map [B, H, H, Cin], got "
                         f"{tuple(x.shape)}")
    if w_kcat.dim() != 2 or w_kcat.shape[0] != 9 * x.shape[3] or w_kcat.shape[1] % 4:
        raise ValueError(f"expected weights [9*Cin, 4*Cout] for Cin {x.shape[3]}, got "
                         f"{tuple(w_kcat.shape)}")


# ----------------------------------------------------------- plain versions


def conv3x3_adain_relu_requant_plain(x_i8, w_packed, gamma, beta, eps: float = _EPS):
    """conv3x3 -> IN -> AdaIN -> ReLU -> requant with the true extremes, unfolded."""
    y = fc.conv3x3_i64(x_i8, w_packed)
    return fc.relu_requant_true(y, *fc._channel_affine(y, gamma, beta, eps))


# The residual site computes v2's function (``fused_conv_int8.py:339-364``).
conv3x3_adain_residual_requant_plain = fc.conv3x3_adain_residual_requant_plain


def convt4x4s2_in_relu_requant_plain(x_i8, w_kcat, eps: float = _EPS):
    """ConvT (K-concat) -> IN -> ReLU -> requant with the true extremes, unfolded.

    Statistics per output channel over the four phases (n = 4*H*W), a = rsqrt,
    d = -mean*a; amax from the true extremes over all phases; inverse scale
    amax/127, or 1 (``fused_conv_int8.py:220-264``). Returns (int8 [B, 2H, 2W,
    Cout], inverse scale [B, 1])."""
    y = fc.convt4x4s2_kcat_i64(x_i8, w_kcat)
    b, c = y.shape[0], y.shape[-1]
    ones = torch.ones((b, c), dtype=torch.float32, device=y.device)
    a, d = fc._channel_affine(y, ones, torch.zeros_like(ones), eps)
    amax = fc.true_relu_amax(y, a, d)
    return fc.relu_requant_true(y, a, d), torch.where(amax > 0, fc.div_by(amax, 127.0), 1.0)


# ------------------------------------------------------------------ wrappers


def conv3x3_adain_relu_requant(x_i8, w_packed, gamma, beta, eps: float = _EPS, *,
                               w_kmajor=None):
    """v1 resblock conv1 site: x_i8 [B, 64, 64, C] int8, w_packed [9C, C] int8,
    gamma/beta [B, C] float32 -> int8 [B, 64, 64, C]; w_kmajor, optional,
    ``fc.pack_weights_kmajor(w_packed)``, which the kernel reads."""
    _check_trunk_site(x_i8, w_packed)
    if x_i8.device.type == "cpu":
        fc._check_kmajor_shape(w_kmajor, (x_i8.shape[-1], 9 * x_i8.shape[-1]))
        return conv3x3_adain_relu_requant_plain(x_i8, w_packed, gamma, beta, eps)
    fc._check("x", x_i8, torch.int8, tuple(x_i8.shape))
    b, h, w, c = fc._check_site(x_i8, w_packed, gamma, beta)
    wk = fc._kmajor(w_packed, w_kmajor, fc.pack_weights_kmajor, (c, 9 * c))
    fn = _build.load(fc.RELU_SITE, fc._ARGTYPES[fc.RELU_SITE], entry=_RELU_ENTRY)
    # the int32 scratch and the statistics block, which the C entry sets
    y, stats = fc._scratch(x_i8, b, h * w, c)
    out = torch.empty_like(x_i8)
    err = fn(x_i8.data_ptr(), wk.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
             y.data_ptr(), stats.data_ptr(), out.data_ptr(), b, h, w, c, eps,
             torch.cuda.current_stream(x_i8.device).cuda_stream)
    _build.check(RELU_SITE, err)
    LAUNCHES[RELU_SITE] += 1
    return out


def conv3x3_adain_residual_requant(y1_i8, h_i8, h_scale, w_packed, gamma, beta,
                                   eps: float = _EPS, *, w_kmajor=None):
    """v1 resblock conv2 site: y1_i8, h_i8 [B, 64, 64, C] int8, h_scale [B, 1]
    float32, w_packed [9C, C] int8, gamma/beta [B, C] float32 -> (int8, new
    scale [B, 1]); w_kmajor, optional, ``fc.pack_weights_kmajor(w_packed)``,
    which the kernel reads."""
    _check_trunk_site(y1_i8, w_packed)
    if y1_i8.device.type == "cpu":
        fc._check_kmajor_shape(w_kmajor, (y1_i8.shape[-1], 9 * y1_i8.shape[-1]))
        return conv3x3_adain_residual_requant_plain(y1_i8, h_i8, h_scale, w_packed, gamma, beta,
                                                    eps)
    out = fc.residual_kernel(y1_i8, h_i8, h_scale, w_packed, gamma, beta, eps,
                             w_kmajor=w_kmajor)
    LAUNCHES[RESIDUAL_SITE] += 1
    return out


def convt4x4s2_in_relu_requant(x_i8, w_kcat, eps: float = _EPS, *, w_kmajor=None):
    """v1 up site: x_i8 [B, H, H, Cin] int8, w_kcat [9*Cin, 4*Cout] int8, which
    must come from ``pack_convt_weights`` (as the TPU kernel's docstring
    requires: the kernel reads only the 16 blocks that packing fills) ->
    (int8 [B, 2H, 2H, Cout], inverse scale [B, 1]); w_kmajor, optional,
    ``fc.pack_convt_kcat_kmajor(w_kcat)``, which the kernel reads.

    The TPU's ``w_img`` is H; its ``guard`` and ``chunk`` shape the slab only."""
    _check_convt_site(x_i8, w_kcat)
    if x_i8.device.type == "cpu":
        fc._check_kmajor_shape(w_kmajor, fc.convt_kcat_kmajor_shape(w_kcat))
        return convt4x4s2_in_relu_requant_plain(x_i8, w_kcat, eps)
    out = fc.convt4x4s2_kcat_kernel(x_i8, w_kcat, eps, true_extremes=True, w_kmajor=w_kmajor)
    LAUNCHES[CONVT_SITE] += 1
    return out
