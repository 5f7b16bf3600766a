"""3x3 stride-1 SAME convs with a fused backward: CUDA kernels and plain versions.

Counterpart of ``msig_tpu/ops/conv3x3_vjp.py``. The forward of every function
here is the stock convolution (XLA's in the JAX package, cuDNN's here); the
backward is a kernel:

* ``conv3x3_same(x, w)`` and ``relu_conv3x3(x, w)`` (= ``conv3x3_same(relu(x),
  w)``): ``MSIG_CONV_VJP=1``; the backward is ``conv3x3_bwd``, dx (masked by
  ``x > 0`` for the relu input) and dW in one call;
* ``conv3x3_adain(x, w, gamma, beta)`` and ``relu_conv3x3_adain``: the unit
  ``z = gamma * IN(conv3x3([relu](x), w)) + beta`` of ``MSIG_CONV_VJP=2``,
  whose backward ``conv3x3_adain_bwd`` also runs the instance norm's: dx, dW,
  dgamma and dbeta.

Layouts are the JAX package's: x and the cotangents dense NHWC ``[B, H, W,
C]``, w HWIO ``[3, 3, C, Co]``, gamma and beta ``[B, Co]``. ``conv3x3_bwd`` and
``conv3x3_adain_bwd`` launch the kernels of ``msig_tpu_torch/csrc`` for CUDA
tensors and add one to their entry of ``LAUNCHES``, or raise; for CPU tensors
they run the plain versions (``*_plain``), the TPU kernels' formulas tap by
tap in PyTorch, which ``chip_smoke.py`` holds the kernels against on the card.

Each kernel has an fp32 entry (3xTF32 products, ``csrc/conv3x3_bwd.cuh``)
and a bf16 one (bf16 operands, fp32 accumulation, ``csrc/conv3x3_bwd_bf16.cuh``:
wgmma, a persistent grid, dW's K in the chunks of ``bf16_plan``), the
configuration the JAX package's bf16 train step runs its Pallas kernels in.
x, dy (or y and g) and w are of one of the two types; dx comes back in it,
dW, dgamma and dbeta in fp32. The autograd functions below cast w to x's
type, as the JAX wrappers cast the taps (``conv3x3_vjp.py:143, 298``), pass
bf16 tensors through as they are, and give dW back in w's type; the unit's
dy is rounded to x's type before the conv backward, where JAX rounds it
(its padded slab is in x's type, ``conv3x3_vjp.py:279-282, 329-330``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from msig_tpu_torch.ops import _build
from msig_tpu_torch.ops import adain_pallas as ap

_IN_EPS = 1e-5  # torch nn.InstanceNorm2d default (ops/norm.py)
_MAX_K = 2304  # the most K a kernel tile accumulates (kMaxK of csrc/conv3x3_bwd.cuh)
# csrc/conv3x3_bwd_bf16.cuh: the tile's rows (its columns: bf16_plan's "bn"), K a
# stage, and dW's chunks of K
_BF16_TILE, _BF16_BK = 128, 64
_BF16_MAX_CHUNKS, _BF16_MAX_CHUNK_PX = 7, 4864

BWD = "conv3x3_bwd"
ADAIN_BWD = "conv3x3_adain_bwd"
KERNELS = SOURCES = (BWD, ADAIN_BWD)  # one csrc/<name>.cu each

# Launches per kernel on CUDA tensors; COPIES counts the cotangents that
# arrived in another layout than dense NHWC and were copied for the kernel.
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
COPIES: Dict[str, int] = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_ARGTYPES = {
    BWD: [_P] * 6 + [ctypes.c_int] * 6 + [_P],
    ADAIN_BWD: [_P] * 13 + [ctypes.c_int] * 7 + [_P],
}
# The C entry of each kernel and its configuration query, by operand type.
_DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}
_CONFIG_KEYS = {
    torch.float32: ("tile_m", "tile_n", "tile_k", "stages", "threads", "max_k", "smem_bytes",
                    "ctas_per_sm", "ctas_per_sm_relu"),
    torch.bfloat16: ("tile_m", "tile_n", "tile_k", "stages", "threads", "smem_bytes",
                     "ctas_per_sm", "producer_regs", "consumer_regs", "kernel_regs",
                     "max_chunks", "max_chunk_pixels", "stages_n128",
                     "least_kernel_regs"),
}


def reset_launch_counts() -> None:
    for d in (LAUNCHES, COPIES):
        for name in d:
            d[name] = 0


def _geom(h: int, w: int):
    wp = w + 8
    return wp, (h + 4) * wp


def supported(x_shape, kernel_shape, strides, padding, pad_mode) -> bool:
    """The TPU kernels' domain (``conv3x3_vjp.py:384-401``), so that the same
    sites route in both packages: 3x3, stride 1, symmetric zero SAME padding,
    C and Co multiples of 128, a square map with H % 8 == 0 whose padded bf16
    slabs stay under 24 MB."""
    kh, kw, cin, cout = kernel_shape
    if (kh, kw) != (3, 3) or strides != 1:
        return False
    if pad_mode != "zeros" or padding != ((1, 1), (1, 1)):
        return False
    if cin % 128 or cout % 128:
        return False
    _, h, w, c = x_shape
    if c != cin or h != w or h % 8:
        return False
    _, rows = _geom(h, w)
    return rows * (cin + cout) * 2 < 24 * 1024 * 1024


def _acc(t: torch.Tensor) -> torch.Tensor:
    """fp32 for the sums; float64 stays float64 (gradcheck)."""
    return t if t.dtype == torch.float64 else t.to(torch.float32)


def _shift(t: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """out[b, h, w] = t[b, h + dh, w + dw], zero outside the map (|dh|, |dw| <= 1)."""
    _, h, w, _ = t.shape
    p = F.pad(t, (0, 0, 1, 1, 1, 1))
    return p[:, 1 + dh:1 + dh + h, 1 + dw:1 + dw + w, :]


def conv3x3_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The stock 3x3 SAME conv on NHWC x and HWIO w; dense NHWC result."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


# ----------------------------------------------------------- plain versions


def conv3x3_bwd_plain(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                      relu_input: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_conv_bwd_core``: dx [B, H, W, C] in x's type and dW [3, 3, C, Co] fp32."""
    b, h, wd, c = x.shape
    co = w.shape[-1]
    xin = torch.relu(_acc(x)) if relu_input else _acc(x)
    dyf, wf = _acc(dy), _acc(w)
    dx = torch.zeros((b, h, wd, c), dtype=dyf.dtype, device=x.device)
    dw = torch.empty((3, 3, c, co), dtype=dyf.dtype, device=x.device)
    dy2 = dyf.reshape(-1, co)
    for di in range(3):
        for dj in range(3):
            dx = dx + _shift(dyf, 1 - di, 1 - dj) @ wf[di, dj].t()
            dw[di, dj] = _shift(xin, di - 1, dj - 1).reshape(-1, c).t() @ dy2
    if relu_input:  # relu'(x): exactly 0 where x <= 0
        dx = torch.where(_acc(x) > 0, dx, torch.zeros_like(dx))
    return dx.to(x.dtype), dw


def in_bwd_dy_plain(y, mu, r, gamma, g) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unit's instance-norm backward (``_bwd_adain_kernel`` passes 1-2):
    (dy in g's accumulation type, sg = sum(g), sgy = sum(g * yhat)) per (B, Co)."""
    gf = _acc(g)
    yh = (_acc(y) - mu[:, None, None, :]) * r[:, None, None, :]
    sg = gf.sum(dim=(1, 2))
    sgy = (gf * yh).sum(dim=(1, 2))
    n = float(y.shape[1] * y.shape[2])
    gr = (_acc(gamma) * r)[:, None, None, :]
    dy = gr * (gf - (sg / n)[:, None, None, :] - yh * (sgy / n)[:, None, None, :])
    return dy, sg, sgy


def conv3x3_adain_bwd_plain(x, w, y, mu, r, gamma, g, relu_input: bool = False):
    """(dx, dW, dgamma, dbeta) for z = gamma * IN(conv3x3([relu](x), w)) + beta."""
    dy, sg, sgy = in_bwd_dy_plain(y, mu, r, gamma, g)
    dx, dw = conv3x3_bwd_plain(x, w, dy.to(x.dtype), relu_input)
    return dx, dw, sgy, sg


# ------------------------------------------------------------------ kernels


def _check(name: str, t: torch.Tensor, shape, device, dtype, dense: bool = True) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if dense and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (dense NHWC)")


def kernel_shape_error(x_shape, w_shape) -> Optional[str]:
    """Why the CUDA kernels cannot take x of ``x_shape`` and w of ``w_shape``,
    or None: x [B, H, W, C] and w [3, 3, C, Co] with C and Co multiples of 128
    (a CTA's 128-wide tile of channels). Any B*H*W: the kernels mask the
    ragged pixel edge."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return (f"expected x [B, H, W, C] and w [3, 3, C, Co], got {tuple(x_shape)} "
                f"and {tuple(w_shape)}")
    c, co = x_shape[-1], w_shape[-1]
    if c % 128 or co % 128:
        return (f"the CUDA kernel needs C and Co multiples of 128, got x {tuple(x_shape)}, "
                f"Co {co}")
    return None


def _check_conv(x: torch.Tensor, w: torch.Tensor) -> Tuple[int, int, int, int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
    err = kernel_shape_error(tuple(x.shape), tuple(w.shape))
    if err:
        raise ValueError(err)
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16 (the CUDA kernels' types), got {x.dtype}")
    b, h, wd, c = x.shape
    co = w.shape[-1]
    _check("x", x, x.shape, x.device, x.dtype)
    _check("w", w, (3, 3, c, co), x.device, x.dtype, dense=False)  # any strides: _taps copies it
    return b, h, wd, c, co


def _taps(w: torch.Tensor) -> torch.Tensor:
    """The taps as the core of w's type reads them: fp32, transposed [9, Co, C]
    (the dx product's B); bf16, HWIO [3, 3, C, Co] as it is, dense (wgmma
    reads it K-major)."""
    if w.dtype == torch.bfloat16:
        return w.contiguous()
    c, co = w.shape[2], w.shape[3]
    return w.reshape(9, c, co).transpose(1, 2).contiguous()


def bf16_plan(b: int, h: int, w: int, c: int, co: int) -> Dict[str, int]:
    """The bf16 core's work (``dw_plan`` of csrc/conv3x3_bwd_bf16.cuh), from the
    shape alone: dW's K (the pixels) in ``chunks`` chunks of ``chunk_px``
    pixels (one per 9*Co / 2 pixels, half a dx item's K, at most
    ``_BF16_MAX_CHUNKS`` so that the dW items are fewer than the card's SMs,
    unless a chunk would pass ``_BF16_MAX_CHUNK_PX``:
    the tensor cores' fp32 sums lose bits with their length; whole 64-pixel
    stages, the last may be short), the tile's columns ``bn`` (256 where C
    and Co are multiples of 256, else 128), whether TMA loads the tiles
    (``tma``: a 128-pixel tile is whole rows of one image or a part of one
    row), the dx and dW items (128 x bn tiles; dW's a chunk each), the stages
    of a dx item, and which kind is dealt first (the longer)."""
    cdiv = lambda a, d: -(-a // d)  # noqa: E731
    n = b * h * w
    bn = 256 if c % 256 == 0 and co % 256 == 0 else 128
    chunks = min(max(n // (9 * co // 2), 1), _BF16_MAX_CHUNKS)
    chunks = max(chunks, cdiv(n, _BF16_MAX_CHUNK_PX))
    chunk_px = cdiv(cdiv(n, chunks), _BF16_BK) * _BF16_BK
    chunks = cdiv(n, chunk_px)
    dw_tiles = 9 * c // _BF16_TILE * (co // bn)
    dx_nk = 9 * co // _BF16_BK
    tma = (h * w) % _BF16_TILE == 0 and (w % _BF16_TILE == 0 or _BF16_TILE % w == 0)
    return dict(bn=bn, tma=tma, np=n, chunks=chunks, chunk_px=chunk_px,
                n_dx=cdiv(n, _BF16_TILE) * (c // bn), dw_tiles=dw_tiles,
                n_dw=dw_tiles * chunks, dx_nk=dx_nk, dw_first=chunk_px // _BF16_BK >= dx_nk)


def scratch_floats(b: int, h: int, w: int, c: int, co: int,
                   dtype: torch.dtype = torch.float32) -> int:
    """Floats of the kernels' scratch. fp32 (``part_floats`` of
    csrc/conv3x3_bwd.cuh): dW's partials over chunks of ``_MAX_K`` pixels,
    then dx's over parts of at most ``_MAX_K`` of its K = 9*Co where 9*Co
    exceeds it. bf16 (csrc/conv3x3_bwd_bf16.cuh): dW's partials where
    ``bf16_plan`` has more than one chunk, then the item counter."""
    if dtype == torch.bfloat16:
        chunks = bf16_plan(b, h, w, c, co)["chunks"]
        return (chunks * 9 * c * co if chunks > 1 else 0) + 1
    cdiv = lambda a, d: -(-a // d)  # noqa: E731
    dx_splits = cdiv(9 * co, _MAX_K)
    dx_part = dx_splits * b * h * w * c if dx_splits > 1 else 0
    return cdiv(b * h * w, _MAX_K) * 9 * c * co + dx_part


def _part(x: torch.Tensor, c: int, co: int) -> torch.Tensor:
    return torch.empty(scratch_floats(*x.shape[:3], c, co, x.dtype), dtype=torch.float32,
                       device=x.device)


def kernel_config(dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """The conv core's configuration for operands of ``dtype``; builds the
    kernel. fp32: tiles, ring stages, the longest K a tile accumulates (dW's
    chunk), shared memory, the CTAs the card keeps resident per SM (occupancy
    API) without and with the relu input. bf16: tiles, ring stages, shared
    memory, CTAs per SM, the producer's and consumers' registers after
    setmaxnreg and the kernel's as compiled, and dW's chunk limits."""
    keys = _CONFIG_KEYS[dtype]
    out = (ctypes.c_int * len(keys))()
    fn = _build.load(BWD, [_P], entry=f"msig_conv3x3_bwd{_SUFFIX[dtype]}_config")
    _build.check(BWD, fn(ctypes.addressof(out)))
    return dict(zip(keys, out))


def conv3x3_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, relu_input: bool = False):
    """(dx, dW) for y = conv3x3_same([relu](x), w); x, dy NHWC, w HWIO.

    The CUDA kernel for CUDA tensors (x, w, dy all fp32 or all bf16; dx in
    that type, dW fp32), else the plain version."""
    if x.device.type == "cpu":
        return conv3x3_bwd_plain(x, w, dy, relu_input)
    b, h, wd, c, co = _check_conv(x, w)
    _check("dy", dy, (b, h, wd, co), x.device, x.dtype)
    fn = _build.load(BWD, _ARGTYPES[BWD], entry=f"msig_{BWD}{_SUFFIX[x.dtype]}")
    wt, part = _taps(w), _part(x, c, co)
    dx = torch.empty_like(x)
    dw = torch.empty((3, 3, c, co), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), dy.data_ptr(), wt.data_ptr(), dx.data_ptr(), dw.data_ptr(),
             part.data_ptr(), b, h, wd, c, co, int(relu_input),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(BWD, err)
    LAUNCHES[BWD] += 1
    return dx, dw


def conv3x3_adain_bwd(x, w, y, mu, r, gamma, g, relu_input: bool = False):
    """(dx, dW, dgamma, dbeta) for z = gamma * IN(conv3x3([relu](x), w)) + beta.

    y is the saved conv output, mu and r its per-(B, Co) mean and rsqrt(var +
    eps), g the cotangent of z. The CUDA kernel for CUDA tensors (x, w, y, g
    all fp32 or all bf16, mu, r, gamma fp32; dx in x's type, dW, dgamma and
    dbeta fp32), else the plain version."""
    if x.device.type == "cpu":
        return conv3x3_adain_bwd_plain(x, w, y, mu, r, gamma, g, relu_input)
    b, h, wd, c, co = _check_conv(x, w)
    for name, t in (("y", y), ("g", g)):
        _check(name, t, (b, h, wd, co), x.device, x.dtype)
    for name, t in (("mu", mu), ("r", r), ("gamma", gamma)):
        _check(name, t, (b, co), x.device, torch.float32)
    fn = _build.load(ADAIN_BWD, _ARGTYPES[ADAIN_BWD], entry=f"msig_{ADAIN_BWD}{_SUFFIX[x.dtype]}")
    p = ap._launch_plan(x.device.index, h * wd, co, x.dtype, True)  # the IN backward
    dx = torch.empty_like(x)
    dw = torch.empty((3, 3, c, co), dtype=torch.float32, device=x.device)
    dgamma = torch.empty((b, co), dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    dy, wt, part = torch.empty_like(y), _taps(w), _part(x, c, co)  # dy in x's type, as JAX's slab
    err = fn(x.data_ptr(), y.data_ptr(), g.data_ptr(), mu.data_ptr(), r.data_ptr(),
             gamma.data_ptr(), wt.data_ptr(), dx.data_ptr(), dw.data_ptr(), dgamma.data_ptr(),
             dbeta.data_ptr(), dy.data_ptr(), part.data_ptr(), b, h, wd, c, co, int(relu_input),
             p.cluster, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(ADAIN_BWD, err)
    LAUNCHES[ADAIN_BWD] += 1
    return dx, dw, dgamma, dbeta


def _dense(t: torch.Tensor, kernel: str) -> torch.Tensor:
    if t.is_contiguous():
        return t
    COPIES[kernel] += 1
    return t.contiguous()


# -------------------------------------------------------- autograd.Functions


class _Conv3x3(torch.autograd.Function):
    """Stock forward, ``conv3x3_bwd`` backward."""

    @staticmethod
    def forward(ctx, x, w, relu_input):
        wc = w.to(x.dtype)
        ctx.save_for_backward(x, wc)
        ctx.relu_input, ctx.w_dtype = relu_input, w.dtype
        return conv3x3_nhwc(torch.relu(x) if relu_input else x, wc)

    @staticmethod
    def backward(ctx, dy):
        x, wc = ctx.saved_tensors
        dx, dw = conv3x3_bwd(x, wc, _dense(dy, BWD).to(x.dtype), relu_input=ctx.relu_input)
        return dx, dw.to(ctx.w_dtype), None


def _adain_unit_fwd_impl(x, w, gamma, beta, relu_input):
    """The forward of ``conv3x3_vjp.py:341-354``, formula for formula: two-pass
    variance, ``z = yf * scale + shift`` in x's type; saves (y, mu, r)."""
    y = conv3x3_nhwc(torch.relu(x) if relu_input else x, w)
    yf = _acc(y)
    mu = yf.mean(dim=(1, 2))
    var = (yf - mu[:, None, None, :]).square().mean(dim=(1, 2))
    r = torch.rsqrt(var + _IN_EPS)
    g32, b32 = _acc(gamma), _acc(beta)
    scale = (g32 * r)[:, None, None, :]
    shift = (b32 - mu * g32 * r)[:, None, None, :]
    z = (yf * scale + shift).to(x.dtype)
    return z, (y, mu, r)


class _Conv3x3Adain(torch.autograd.Function):
    """Stock conv + instance norm + modulation forward, ``conv3x3_adain_bwd`` backward."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, relu_input):
        wc = w.to(x.dtype)
        z, (y, mu, r) = _adain_unit_fwd_impl(x, wc, gamma, beta, relu_input)
        ctx.save_for_backward(x, wc, y, mu, r, _acc(gamma).contiguous())
        ctx.relu_input, ctx.w_dtype, ctx.gamma_dtype = relu_input, w.dtype, gamma.dtype
        return z

    @staticmethod
    def backward(ctx, g):
        x, wc, y, mu, r, gamma = ctx.saved_tensors
        dx, dw, dgm, dbt = conv3x3_adain_bwd(x, wc, y, mu, r, gamma,
                                             _dense(g, ADAIN_BWD).to(x.dtype),
                                             relu_input=ctx.relu_input)
        return (dx, dw.to(ctx.w_dtype), dgm.to(ctx.gamma_dtype), dbt.to(ctx.gamma_dtype), None)


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv, NHWC x, HWIO w: stock forward, fused backward."""
    return _Conv3x3.apply(x, w, False)


def relu_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv3x3_same(relu(x), w)`` with the relu mask folded into the backward's dx."""
    return _Conv3x3.apply(x, w, True)


def conv3x3_adain(x, w, gamma, beta) -> torch.Tensor:
    """``gamma * IN(conv3x3(x, w)) + beta`` with the one fused backward."""
    return _Conv3x3Adain.apply(x, w, gamma, beta, False)


def relu_conv3x3_adain(x, w, gamma, beta) -> torch.Tensor:
    """``gamma * IN(conv3x3(relu(x), w)) + beta`` (the resblock conv2 site)."""
    return _Conv3x3Adain.apply(x, w, gamma, beta, True)
