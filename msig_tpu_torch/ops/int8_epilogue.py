"""Whole-slab int8 epilogues of an int32 conv output: CUDA kernels and plain versions.

Counterpart of ``msig_tpu/ops/int8_epilogue.py``: on x [B, S, C] int32 (the S
rows of a sample's map), gamma and beta [B, C] float32,

* ``adain_relu_requant`` -> int8: y = relu(norm_mod(x)), requantized by max y;
* ``adain_residual_requant`` -> (h, int8): h = norm_mod(x) + residual, h in
  the residual's dtype (bfloat16 or float32), the int8 from the fp32 h
  requantized by max|h|;

with norm_mod(x) = (fp32(x) - m) * (rsqrt(v + eps) * gamma) + beta, m the
mean of fp32(x) and v the mean of the squared deviations (two passes, as the
TPU computes them, ``int8_epilogue.py:55-62``), and q = clip(round(v * 127 /
amax), +-127) (1 in place of 127/amax where amax is 0).

The statistics are those sums done exactly (m: the int32 -> fp32 casts are
integers, summed in int64) or in float64 in a fixed order (v: the fp32
squares, ``deviation_sq_sum``), each rounded once to fp32; the TPU sums in
fp32, so the two may part in the last bits of m and v. The CUDA kernel
(``csrc/int8_epilogue.cu``, one cooperative launch a call) computes the same
roundings in the same order, so it equals the plain version to the bit.
Nothing in the JAX package calls these two but their tests.

Each wrapper launches its kernel for CUDA tensors and adds one to its entry
of ``LAUNCHES``, or raises; for CPU tensors it runs its plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from msig_tpu_torch.ops import _build
from msig_tpu_torch.ops import fused_conv_int8_v2 as fc

_EPS = 1e-5
_LANES = 128
_MAX_SLAB_BYTES = 8 * 1024 * 1024
ROWS = 128      # rows of a statistics chunk (the kernel's item, kRows)
ROW_LANES = 8   # row lanes of a chunk (the kernel's warps): lane l adds rows l, l + 8, ...

RELU_SITE = "adain_relu_requant"
RESIDUAL_SITE = "adain_residual_requant"
SOURCE = "int8_epilogue"
SOURCES = (SOURCE,)
RESIDUAL_DTYPES = (torch.bfloat16, torch.float32)
# the C entry's form of each launch: 0 relu, 1 and 2 the residual in bf16 or fp32
FORMS = {None: 0, torch.bfloat16: 1, torch.float32: 2}

# Launches per wrapper on CUDA tensors (one per call; CPU tensors do not count).
LAUNCHES: Dict[str, int] = {RELU_SITE: 0, RESIDUAL_SITE: 0}

_P = ctypes.c_void_p
_ARGTYPES = {
    RELU_SITE: [_P] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, _P],
    RESIDUAL_SITE: [_P] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, _P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supported(shape, dtype_bytes: int = 4) -> bool:
    """The JAX package's gate (``int8_epilogue.py:40-48``): C a multiple of 128
    and a sample's slab S*C*dtype_bytes at most 8 MB. Any device of the port
    qualifies. A caller's gate, as in JAX (the wrappers check only C % 128):
    nothing in the package calls it, the tests hold it to the JAX gate."""
    _, s, c = shape
    return c % _LANES == 0 and s * c * dtype_bytes <= _MAX_SLAB_BYTES


# ----------------------------------------------------------- plain versions


def pairwise_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over ``dim`` as a tree of adjacent pairs, ((t0 + t1) + (t2 + t3))
    + ..., a level at a time; a level of odd length gets a +0.0 at its end,
    which leaves every sum of non-negative terms as it is (the same tree as
    padding the whole length to a power of two)."""
    while t.shape[dim] > 1:
        if t.shape[dim] % 2:
            t = torch.cat([t, torch.zeros_like(t.narrow(dim, 0, 1))], dim)
        pairs = t.unflatten(dim, (-1, 2))
        t = pairs.select(dim + 1, 0) + pairs.select(dim + 1, 1)
    return t.squeeze(dim)


def deviation_sq_sum(xc: torch.Tensor) -> torch.Tensor:
    """The sum over the S rows of the fp32 squares of ``xc`` [B, S, C] (fp32),
    in float64, in a fixed order that depends on neither C nor any grid:
    the rows in chunks of ``ROWS`` (the last one padded with +0.0 rows, which
    is exact); in a chunk, lane l (of ``ROW_LANES``) adds its rows l, l + 8,
    ..., l + 120 in that order, and the lanes meet as a pairwise tree
    (``pairwise_sum``); the chunks' sums meet as a pairwise tree of adjacent
    chunks. The CUDA kernel adds in this order (its warps are the lanes).
    Returns float64 [B, C]."""
    b, s, c = xc.shape
    chunks = -(-s // ROWS)
    sq = F.pad((xc * xc).to(torch.float64), (0, 0, 0, chunks * ROWS - s))
    t = sq.view(b, chunks, ROWS // ROW_LANES, ROW_LANES, c)  # [B, chunk, step, lane, C]
    acc = t[:, :, 0]
    for step in range(1, ROWS // ROW_LANES):
        acc = acc + t[:, :, step]
    return pairwise_sum(pairwise_sum(acc, 2), 1)


def sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """fp32 sqrt rounded once, as the kernel's ``__fsqrt_rn``. PyTorch's float32
    sqrt on a CPU with AVX-512 can be one ulp off (e.g. at 1.5273133e18); the
    float64 sqrt rounded to float32 is the correctly rounded one (53 >= 2*24 + 2
    bits), on the CPU and on the card."""
    return torch.sqrt(t.to(torch.float64)).to(torch.float32)


def norm_mod(x_i32: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             eps: float = _EPS) -> torch.Tensor:
    """(fp32(x) - m) * (rsqrt(v + eps) * gamma) + beta over the S rows, fp32 [B, S, C];
    v from ``deviation_sq_sum``."""
    s = x_i32.shape[1]
    xf = x_i32.to(torch.float32)
    m = fc.div_by(xf.to(torch.int64).sum(dim=1).to(torch.float32), float(s))
    xc = xf - m[:, None, :]
    v = fc.div_by(deviation_sq_sum(xc).to(torch.float32), float(s))
    k = torch.reciprocal(sqrt_rn(v + eps)) * gamma.to(torch.float32)
    return xc * k[:, None, :] + beta.to(torch.float32)[:, None, :]


def _requant(v: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """clip(round(v * 127/amax), +-127) per sample; amax [B]."""
    s = torch.where(amax > 0, fc.div_rn(127.0, amax), 1.0)[:, None, None]
    return torch.clamp(torch.round(v * s), -127, 127).to(torch.int8)


def adain_relu_requant_plain(x_i32, gamma, beta, eps: float = _EPS):
    y = torch.clamp(norm_mod(x_i32, gamma, beta, eps), min=0.0)
    return _requant(y, y.amax(dim=(1, 2)))


def adain_residual_requant_plain(x_i32, gamma, beta, residual, eps: float = _EPS):
    h = norm_mod(x_i32, gamma, beta, eps) + residual.to(torch.float32)
    return h.to(residual.dtype), _requant(h, h.abs().amax(dim=(1, 2)))


# ------------------------------------------------------------------ wrappers


def _check(x_i32, gamma, beta):
    if x_i32.dim() != 3:
        raise ValueError(f"expected [B, S, C], got shape {tuple(x_i32.shape)}")
    b, s, c = x_i32.shape
    if c % _LANES:
        raise ValueError(f"the CUDA kernel needs C % 128 == 0, got {tuple(x_i32.shape)}")
    fc._check("x", x_i32, torch.int32, (b, s, c))
    fc._check("gamma", gamma, torch.float32, (b, c))
    fc._check("beta", beta, torch.float32, (b, c))
    for t in (gamma, beta):
        if t.device != x_i32.device:
            raise ValueError(f"all inputs must be on {x_i32.device}, got {t.device}")
    return b, s, c


def workspace_words(b: int, s: int, c: int) -> int:
    """int64 words of the kernel's workspace (``Work`` of the CUDA source): per
    (chunk, channel) the sum, the squares' partial and the extremes (two int32
    in one); per (sample, channel) m, k and the extremes (float32, int32); the
    amax parts per (sample, 32 channels) and the max|h| per chunk (float32).
    Every word is written before it is read: ``torch.empty``, no fill."""
    chunks = -(-s // ROWS)
    return 3 * b * chunks * c + (4 * b * c + b * c // 32 + b * chunks + 1) // 2


def cooperative_grid(residual_dtype: Optional[torch.dtype] = None) -> int:
    """The CTAs of one launch on the current device (the relu form, or the
    residual form with that dtype): as many as the card holds at once. A
    sample's items are its ceil(S / 128) chunks, whatever the grid."""
    fn = _build.load(SOURCE, [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                     entry="msig_int8_epilogue_grid")
    grid = ctypes.c_int(0)
    _build.check(SOURCE, fn(FORMS[residual_dtype], ctypes.byref(grid)))
    return grid.value


def adain_relu_requant(x_i32, gamma, beta, eps: float = _EPS):
    """x_i32 [B, S, C] int32, gamma/beta [B, C] float32 -> int8 [B, S, C]."""
    if x_i32.device.type == "cpu":
        return adain_relu_requant_plain(x_i32, gamma, beta, eps)
    b, s, c = _check(x_i32, gamma, beta)
    fn = _build.load(SOURCE, _ARGTYPES[RELU_SITE], entry="msig_adain_relu_requant")
    ws = torch.empty(workspace_words(b, s, c), dtype=torch.int64, device=x_i32.device)
    out = torch.empty((b, s, c), dtype=torch.int8, device=x_i32.device)
    err = fn(x_i32.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ws.data_ptr(), out.data_ptr(),
             b, s, c, eps, torch.cuda.current_stream(x_i32.device).cuda_stream)
    _build.check(RELU_SITE, err)
    LAUNCHES[RELU_SITE] += 1
    return out


def adain_residual_requant(x_i32, gamma, beta, residual, eps: float = _EPS):
    """x_i32 [B, S, C] int32, gamma/beta [B, C] float32, residual [B, S, C]
    bfloat16 or float32 -> (h in the residual's dtype, int8 [B, S, C])."""
    if residual.dtype not in RESIDUAL_DTYPES:
        raise ValueError(f"the residual must be one of {RESIDUAL_DTYPES}, got {residual.dtype}")
    if x_i32.device.type == "cpu":
        return adain_residual_requant_plain(x_i32, gamma, beta, residual, eps)
    b, s, c = _check(x_i32, gamma, beta)
    fc._check("residual", residual, residual.dtype, (b, s, c))
    if residual.device != x_i32.device:
        raise ValueError(f"all inputs must be on {x_i32.device}, got {residual.device}")
    fn = _build.load(SOURCE, _ARGTYPES[RESIDUAL_SITE], entry="msig_adain_residual_requant")
    ws = torch.empty(workspace_words(b, s, c), dtype=torch.int64, device=x_i32.device)
    h = torch.empty_like(residual)
    out = torch.empty((b, s, c), dtype=torch.int8, device=x_i32.device)
    err = fn(x_i32.data_ptr(), gamma.data_ptr(), beta.data_ptr(), residual.data_ptr(),
             ws.data_ptr(), h.data_ptr(), out.data_ptr(), b, s, c, eps,
             int(residual.dtype == torch.bfloat16),
             torch.cuda.current_stream(x_i32.device).cuda_stream)
    _build.check(RESIDUAL_SITE, err)
    LAUNCHES[RESIDUAL_SITE] += 1
    return h, out
