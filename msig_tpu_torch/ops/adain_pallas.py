"""Fused instance norm + AdaIN modulation with its backward: CUDA kernels and plain versions.

Counterpart of ``msig_tpu/ops/adain_pallas.py``: ``gamma * IN(x) + beta`` over
NHWC ``[B, H, W, C]`` with fp32 statistics (biased variance, two passes), the
forward saving (mean, rstd) for a backward that gives dx, dgamma and dbeta
(``dx = g*r*(dy - mean(dy) - xhat*mean(dy*xhat))``).

* ``adain_pallas`` is a ``torch.autograd.Function``; its forward and backward
  call ``adain_fwd`` and ``adain_bwd``.
* ``adain_fwd`` / ``adain_bwd``: for CUDA tensors they launch the kernels of
  ``msig_tpu_torch/csrc/adain_pallas.cu`` and add one to their entry of
  ``LAUNCHES``, or raise; for CPU tensors they run the plain versions
  ``adain_fwd_plain`` / ``adain_bwd_plain``, the TPU kernels' formulas in
  PyTorch, which ``chip_smoke.py`` holds the kernels against on the card.
* ``plan``: how the kernels (``csrc/in_norm.cuh``) split a [S, 32]-channel
  slab over a thread-block cluster: the cluster's CTAs and the pixel rows
  each takes. ``conv3x3_vjp.conv3x3_adain_bwd``'s IN backward runs the same
  plan.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from msig_tpu_torch.ops import _build

_EPS = 1e-5
_LANES = 128
_MAX_SLAB_BYTES = 8 * 1024 * 1024  # the TPU kernel's per-buffer VMEM budget

SOURCE = "adain_pallas"
FWD, BWD = "adain_pallas_fwd", "adain_pallas_bwd"
KERNELS = (FWD, BWD)

# Launches per kernel on CUDA tensors; COPIES counts the inputs (x, and the
# cotangent) that arrived in another layout than dense NHWC and were copied
# for the kernel.
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
COPIES: Dict[str, int] = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_ARGTYPES = {
    FWD: [_P] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2 + [_P],
    BWD: [_P] * 8 + [ctypes.c_int] * 5 + [_P],
}
_CLUSTERS_ARGTYPES = [ctypes.c_int] * 5 + [_P]

# csrc/in_norm.cuh: channels a cluster, threads a CTA and the pixel rows they
# cover at once, a CTA's shared memory (the scratch of the reductions), and
# the largest cluster (the portable size).
GROUP, THREADS, SLOTS = 32, 512, 64
STATIC_SMEM = (2 * SLOTS * GROUP + 4 * GROUP) * 4
CLUSTER_MAX = 8


class Plan(NamedTuple):
    """A launch of the cluster kernels on [B, S, C]: ``cluster`` CTAs a
    (sample, 32-channel group), each taking ``rows`` pixel rows;
    ``ctas_per_sample`` = cluster * C / 32."""
    cluster: int
    rows: int
    ctas_per_sample: int


def plan(s: int, c: int) -> Plan:
    """The plan of the forward and the backward at S pixels and C channels:
    the largest power of two R up to 8 with at least 32 pixel rows a CTA. At
    [4096, 256]: 8 CTAs of 512 pixel rows."""
    cluster = min(CLUSTER_MAX, 1 << max(0, (s // GROUP).bit_length() - 1))
    return Plan(cluster, -(-s // cluster), cluster * (c // GROUP))


def max_active_clusters(p: Plan, s: int, c: int, dtype: torch.dtype, backward: bool) -> int:
    """cudaOccupancyMaxActiveClusters of the forward (or ``backward``) at
    plan ``p`` on the current card (builds the kernels)."""
    fn = _build.load(SOURCE, _CLUSTERS_ARGTYPES, "msig_adain_pallas_clusters")
    out = ctypes.c_int(0)
    _build.check("adain_pallas_clusters", fn(int(backward), int(dtype == torch.bfloat16), s, c,
                                             p.cluster, ctypes.byref(out)))
    return out.value


@functools.lru_cache(maxsize=None)
def _launch_plan(device: int, s: int, c: int, dtype: torch.dtype, backward: bool) -> Plan:
    """The plan of a launch on card ``device``, refused where no cluster of
    it fits the card; kept per shape, so that a call asks the card once."""
    p = plan(s, c)
    with torch.cuda.device(device):
        n = max_active_clusters(p, s, c, dtype, backward)
    if n <= 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters is {n} for {p}: no cluster of "
                           f"{p.cluster} CTAs fits this card")
    return p


def reset_launch_counts() -> None:
    for d in (LAUNCHES, COPIES):
        for name in d:
            d[name] = 0


def supported(x: torch.Tensor) -> bool:
    """The TPU kernel's domain (``adain_pallas.py:32-43``): 4-D, C % 128 == 0,
    fp32 or bf16, a [H*W, 128] slab of at most 8 MB, on the card or the CPU."""
    if x.dim() != 4:
        return False
    _, h, w, c = x.shape
    if c % _LANES or x.dtype not in (torch.float32, torch.bfloat16):
        return False
    if h * w * _LANES * x.element_size() > _MAX_SLAB_BYTES:
        return False
    return x.device.type in ("cuda", "cpu")


def _acc(t: torch.Tensor) -> torch.Tensor:
    """fp32 for the statistics; float64 stays float64 (gradcheck)."""
    return t if t.dtype == torch.float64 else t.to(torch.float32)


# ----------------------------------------------------------- plain versions


def adain_fwd_plain(x3: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = _EPS) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_fwd_kernel`` on x [B, S, C]: (y [B, S, C] in x's type, mean [B, C], rstd [B, C])."""
    x = _acc(x3)
    m = x.mean(dim=1, keepdim=True)
    xc = x - m
    v = (xc * xc).mean(dim=1, keepdim=True)
    r = torch.rsqrt(v + eps)
    g, b = _acc(gamma)[:, None, :], _acc(beta)[:, None, :]
    y = (xc * (r * g) + b).to(x3.dtype)
    return y, m[:, 0], r[:, 0]


def adain_bwd_plain(x3, gamma, mean, rstd, dy3) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_bwd_kernel``: (dx [B, S, C] in dy's type, dgamma [B, C], dbeta [B, C])."""
    x, dy = _acc(x3), _acc(dy3)
    m, r, g = mean[:, None, :], rstd[:, None, :], _acc(gamma)[:, None, :]
    xhat = (x - m) * r
    db = dy.sum(dim=1, keepdim=True)
    dg = (dy * xhat).sum(dim=1, keepdim=True)
    s = x.shape[1]
    dx = (g * r) * (dy - db / s - xhat * (dg / s))
    return dx.to(dy3.dtype), dg[:, 0], db[:, 0]


# ------------------------------------------------------------------ kernels


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_x(x3: torch.Tensor) -> Tuple[int, int, int]:
    if x3.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x3.device}")
    if x3.dim() != 3 or x3.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"expected x [B, S, C] fp32 or bf16, got {tuple(x3.shape)} {x3.dtype}")
    b, s, c = x3.shape
    if c % 32:
        raise ValueError(f"the CUDA kernel needs C % 32 == 0, got {tuple(x3.shape)}")
    _check("x", x3, x3.dtype, x3.shape, x3.device)
    return b, s, c


def _check_aligned(*ts: torch.Tensor) -> None:
    """The kernels move four channels at once (16 bytes of fp32, 8 of bf16)."""
    for t in ts:
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"the CUDA kernel needs {4 * t.element_size()}-byte aligned maps")


def adain_fwd(x3: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = _EPS):
    """(y, mean, rstd) of x [B, S, C]; the CUDA kernel for CUDA tensors, else the plain version."""
    if x3.device.type == "cpu":
        return adain_fwd_plain(x3, gamma, beta, eps)
    b, s, c = _check_x(x3)
    _check("gamma", gamma, torch.float32, (b, c), x3.device)
    _check("beta", beta, torch.float32, (b, c), x3.device)
    _check_aligned(x3)
    fn = _build.load(SOURCE, _ARGTYPES[FWD], "msig_" + FWD)
    p = _launch_plan(x3.device.index, s, c, x3.dtype, False)
    y = torch.empty_like(x3)
    mean = torch.empty((b, c), dtype=torch.float32, device=x3.device)
    rstd = torch.empty_like(mean)
    err = fn(x3.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), mean.data_ptr(),
             rstd.data_ptr(), b, s, c, eps, int(x3.dtype == torch.bfloat16), p.cluster,
             torch.cuda.current_stream(x3.device).cuda_stream)
    _build.check(FWD, err)
    LAUNCHES[FWD] += 1
    return y, mean, rstd


def adain_bwd(x3: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
              dy3: torch.Tensor):
    """(dx, dgamma, dbeta); the CUDA kernel for CUDA tensors, else the plain version."""
    if x3.device.type == "cpu":
        return adain_bwd_plain(x3, gamma, mean, rstd, dy3)
    b, s, c = _check_x(x3)
    _check("dy", dy3, x3.dtype, x3.shape, x3.device)
    for name, t in (("gamma", gamma), ("mean", mean), ("rstd", rstd)):
        _check(name, t, torch.float32, (b, c), x3.device)
    _check_aligned(x3, dy3)
    fn = _build.load(SOURCE, _ARGTYPES[BWD], "msig_" + BWD)
    p = _launch_plan(x3.device.index, s, c, x3.dtype, True)
    dx = torch.empty_like(dy3)
    dgamma = torch.empty((b, c), dtype=torch.float32, device=x3.device)
    dbeta = torch.empty_like(dgamma)
    err = fn(x3.data_ptr(), dy3.data_ptr(), mean.data_ptr(), rstd.data_ptr(), gamma.data_ptr(),
             dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), b, s, c,
             int(x3.dtype == torch.bfloat16), p.cluster,
             torch.cuda.current_stream(x3.device).cuda_stream)
    _build.check(BWD, err)
    LAUNCHES[BWD] += 1
    return dx, dgamma, dbeta


# --------------------------------------------------------- autograd.Function


def _dense(t: torch.Tensor, kernel: str) -> torch.Tensor:
    if t.is_contiguous():
        return t
    COPIES[kernel] += 1
    return t.contiguous()


class _AdainPallas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        b, h, w, c = x.shape
        g32, b32 = _acc(gamma).contiguous(), _acc(beta).contiguous()
        y3, mean, rstd = adain_fwd(x.reshape(b, h * w, c), g32, b32, eps)
        ctx.save_for_backward(x, g32, mean, rstd)
        ctx.gamma_dtype = gamma.dtype
        return y3.reshape(b, h, w, c)

    @staticmethod
    def backward(ctx, dy):
        x, g32, mean, rstd = ctx.saved_tensors
        b, h, w, c = x.shape
        dy = _dense(dy, BWD)
        dx3, dgamma, dbeta = adain_bwd(x.reshape(b, h * w, c), g32, mean, rstd,
                                       dy.reshape(b, h * w, c))
        return (dx3.reshape(b, h, w, c), dgamma.to(ctx.gamma_dtype), dbeta.to(ctx.gamma_dtype),
                None)


def adain_pallas(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 eps: float = _EPS) -> torch.Tensor:
    """``gamma * IN(x) + beta`` over NHWC x through the fused forward and backward;
    an x that is not dense NHWC is copied once, and the copy counted."""
    return _AdainPallas.apply(_dense(x, FWD), gamma, beta, eps)
