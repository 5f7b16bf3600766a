"""The whole residual trunk as one kernel: CUDA kernel and plain version.

Counterpart of ``msig_tpu/ops/fused_trunk_v3.py``, which the JAX package runs
under ``MSIG_TRUNK_V3=1`` on the 64-grid: N AdaIN resblocks in one
``pallas_call``. Dense NHWC here, like every site of the port:

    fused_trunk_blocks(x_i8 [B, H, W, C], h_scale [B, 1], w_stack [2N*9C, C],
                       gammas [B, 2N, C], betas [B, 2N, C], n_blocks)
        -> (int8 [B, H, W, C], scale [B, 1])

Per block: conv1 -> IN -> AdaIN -> ReLU -> requant, whose scale comes from the
true per-channel extremes and whose requant is unfolded
(``fc.relu_requant_true``), then conv2 -> IN -> AdaIN -> + h * hs -> requant
with the true max|hn| (the conv2 site's formulas,
``fc.conv3x3_adain_residual_requant_plain``), hs <- amax/127. That differs
from the chain of ``fc.conv3x3_adain_relu_requant`` and
``fc.conv3x3_adain_residual_requant``, whose conv1 takes the zero-masked
extremes and folds the scale into the affine: the two agree to one step on
almost every element, and part where a channel's conv1 output has one sign.

``fused_trunk_blocks`` launches the CUDA kernel (``csrc/fused_trunk_blocks.cu``,
one cooperative launch per call, its convs on ``wgmma`` with K-major weights:
``w_packed``, ``pack_trunk_weights_kmajor``) for CUDA tensors and adds one to
``LAUNCHES``, or raises; for CPU tensors it runs ``fused_trunk_blocks_plain``,
which convolves exactly in float64 and reduces integer statistics, as the
kernel does.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping

import torch

from msig_tpu_torch.ops import _build
from msig_tpu_torch.ops import fused_conv_int8_v2 as fc

_EPS = 1e-5

SITE = "fused_trunk_blocks"
SOURCES = (SITE,)

# Launches on CUDA tensors (one per call; CPU tensors do not count).
LAUNCHES: Dict[str, int] = {SITE: 0}
# CTAs of the last launch: the occupancy calculator's blocks per SM x SMs.
LAST_GRID: Dict[str, int] = {SITE: 0}
# What the kernel's elementwise phases have for a site's [B, C] affines and
# three floats per sample: the ring of its conv phases (196,608 bytes of
# shared memory) less the buffers they stream through (122,880).
_STAGING_BYTES = 73728

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float, _P, ctypes.POINTER(ctypes.c_int)]


def reset_launch_counts() -> None:
    LAUNCHES[SITE] = 0


def pack_trunk_weights(q: Mapping[str, torch.Tensor], n_blocks: int) -> torch.Tensor:
    """The packed [9C, C] weights ``res{i}_conv{1,2}_p`` concatenated site-major:
    block 0's conv1, block 0's conv2, block 1's conv1, ... (the stack of
    ``msig_tpu/ops/fused_trunk_v3.py::pack_trunk_weights``)."""
    return torch.cat([q[f"res{i}_{c}_p"] for i in range(n_blocks) for c in ("conv1", "conv2")],
                     dim=0).contiguous()


def pack_trunk_weights_kmajor(q: Mapping[str, torch.Tensor], n_blocks: int) -> torch.Tensor:
    """The K-major [C, 9C] weights ``res{i}_conv{1,2}_pk`` stacked site-major,
    [2N*C, 9C]: the operand the kernel's ``wgmma`` convs read."""
    return torch.cat([q[f"res{i}_{c}_pk"] for i in range(n_blocks) for c in ("conv1", "conv2")],
                     dim=0).contiguous()


def stack_kmajor(w_stack: torch.Tensor) -> torch.Tensor:
    """``pack_trunk_weights``' [2N*9C, C] stack -> ``pack_trunk_weights_kmajor``'s
    [2N*C, 9C]: each site's block transposed (``fc.pack_weights_kmajor``)."""
    c = w_stack.shape[1]
    if w_stack.dim() != 2 or w_stack.shape[0] % (9 * c):
        raise ValueError(f"expected a stack of [9C, C] blocks, got {tuple(w_stack.shape)}")
    n_sites = w_stack.shape[0] // (9 * c)
    return w_stack.reshape(n_sites, 9 * c, c).transpose(1, 2).reshape(n_sites * c, 9 * c) \
        .to(torch.int8).contiguous()


def fused_trunk_blocks_plain(x_i8, h_scale, w_stack, gammas, betas, n_blocks: int,
                             eps: float = _EPS):
    """The trunk's arithmetic block by block; see the module docstring."""
    c = x_i8.shape[-1]
    h, hs = x_i8, h_scale.to(torch.float32)
    for i in range(n_blocks):
        w1 = w_stack[(2 * i) * 9 * c:(2 * i + 1) * 9 * c]
        w2 = w_stack[(2 * i + 1) * 9 * c:(2 * i + 2) * 9 * c]
        y = fc.conv3x3_i64(h, w1)
        a, d = fc._channel_affine(y, gammas[:, 2 * i], betas[:, 2 * i], eps)
        y1 = fc.relu_requant_true(y, a, d)
        h, hs = fc.conv3x3_adain_residual_requant_plain(y1, h, hs, w2, gammas[:, 2 * i + 1],
                                                        betas[:, 2 * i + 1], eps)
    return h, hs


def fused_trunk_blocks(x_i8, h_scale, w_stack, gammas, betas, n_blocks: int, eps: float = _EPS,
                       *, w_packed=None):
    """N resblocks on dense NHWC int8; returns (int8 [B, H, W, C], scale [B, 1]).

    x_i8 [B, H, W, C] int8 with its scale h_scale [B, 1] float32, w_stack
    [2N*9C, C] int8 from ``pack_trunk_weights``, gammas/betas [B, 2N, C] float32
    (site-major: block i's conv1 at 2i, conv2 at 2i + 1). w_packed, optional,
    must be ``pack_trunk_weights_kmajor`` of the same weights (= ``stack_kmajor
    (w_stack)``): on the card the kernel reads only this copy, made here where
    it is not given; the CPU path reads w_stack.
    """
    if x_i8.device.type == "cpu":
        if x_i8.dim() == 4:
            c = x_i8.shape[-1]
            fc._check_kmajor_shape(w_packed, (2 * n_blocks * c, 9 * c), "w_packed")
        return fused_trunk_blocks_plain(x_i8, h_scale, w_stack, gammas, betas, n_blocks, eps)
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be at least 1, got {n_blocks}")
    if x_i8.dim() != 4:
        raise ValueError(f"expected NHWC [B, H, W, C], got shape {tuple(x_i8.shape)}")
    fc._check("x", x_i8, torch.int8, tuple(x_i8.shape))
    b, h, w, c = x_i8.shape
    if c % 128 or (h * w) % 128:
        raise ValueError(f"the CUDA kernel needs C % 128 == 0 and H*W % 128 == 0, "
                         f"got {tuple(x_i8.shape)}")
    fc.check_statistics(x_i8.shape, h * w, 9 * c)
    if b * h * w * c >= 2 ** 31 or (2 * b * c + 3 * b) * 4 > _STAGING_BYTES:
        raise ValueError(f"the CUDA kernel needs B*H*W*C < 2^31 and a site's [B, C] affines "
                         f"within {_STAGING_BYTES} bytes of shared memory, got "
                         f"{tuple(x_i8.shape)}")
    fc._check("h_scale", h_scale, torch.float32, (b, 1))
    fc._check("w_stack", w_stack, torch.int8, (2 * n_blocks * 9 * c, c))
    fc._check("gammas", gammas, torch.float32, (b, 2 * n_blocks, c))
    fc._check("betas", betas, torch.float32, (b, 2 * n_blocks, c))
    for t in (h_scale, w_stack, gammas, betas):
        if t.device != x_i8.device:
            raise ValueError(f"all inputs must be on {x_i8.device}, got {t.device}")
    fn = _build.load(SITE, _ARGTYPES)
    wk = fc._kmajor(w_stack, w_packed, stack_kmajor, (2 * n_blocks * c, 9 * c), "w_packed")
    dev = x_i8.device
    y = torch.empty((b, h * w, c), dtype=torch.int32, device=dev)
    stats = fc.true_extremes_stats(2 * n_blocks, b, c, dev)
    y1, h_a, out = (torch.empty_like(x_i8) for _ in range(3))
    out_scale = torch.empty((b, 1), dtype=torch.float32, device=dev)
    # The kernel reads one site's affines as a [B, C] block: site-major here.
    g_sites = gammas.transpose(0, 1).contiguous()
    b_sites = betas.transpose(0, 1).contiguous()
    grid = ctypes.c_int(0)
    err = fn(x_i8.data_ptr(), h_scale.data_ptr(), wk.data_ptr(), g_sites.data_ptr(),
             b_sites.data_ptr(), y.data_ptr(), stats.data_ptr(), y1.data_ptr(), h_a.data_ptr(),
             out.data_ptr(), out_scale.data_ptr(), b, h, w, c, n_blocks, eps,
             torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(grid))
    _build.check(SITE, err)
    LAUNCHES[SITE] += 1
    LAST_GRID[SITE] = grid.value
    return out, out_scale
