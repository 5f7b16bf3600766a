"""The fused AdaIN forward and backward (row 22) across a thread-block cluster,
on the CPU: the launcher's plan, and the kernels' summation order emulated in
numpy float32.

``csrc/in_norm.cuh`` runs each (sample, 32-channel group) on a cluster of R
CTAs (``ap.plan``) that split the S pixels; each CTA reduces its share and
reads it again in each later pass, and the CTAs' partial sums meet through
distributed shared memory in rank order. The kernels cannot run here.
``plan`` is plain Python and is tested over the whole domain of
``ap.supported``; the sums' order (each thread's pixel rows in order, the CTA's rows of threads in slot
order, the CTAs in rank order) is emulated in float32 and held to the plain
versions within the card's bars (rtol 1e-4, atol 1e-5 x max; dgamma and
dbeta 1e-5 / 1e-6), as tests/test_torch_port_train_cuda.py and chip_smoke.py
hold the kernels on the card. tests/test_torch_port_train_ops.py holds the
plain versions against the JAX kernels.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from msig_tpu_torch.ops import adain_pallas as ap

F32 = np.float32
HEADER = Path(ap.__file__).resolve().parent.parent / "csrc" / "in_norm.cuh"


def test_plan_constants_are_the_kernels():
    text = HEADER.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kLanes") == ap.GROUP and const("kThreads") == ap.THREADS
    assert ap.THREADS // (ap.GROUP // 4) == ap.SLOTS
    assert const("kMaxCluster") == ap.CLUSTER_MAX == 8  # the portable cluster size
    # red[2][kSlots][kLanes], part[2][kLanes], tot[2][kLanes] floats
    assert ap.STATIC_SMEM == (2 * ap.SLOTS * ap.GROUP + 4 * ap.GROUP) * 4


def _domain():
    """(S, C, dtype) across ``supported``: every S up to the 8 MB slab at the
    ends and edges, C = 128 .. 512."""
    for dtype, s_max in ((torch.float32, 16384), (torch.bfloat16, 32768)):
        for s in sorted({1, 2, 31, 32, 33, 63, 64, 65, 255, 256, 576, 999, 1024, 4096, 4097,
                         8191, 12288, 16383, 16384, s_max - 1, s_max}):
            if s <= s_max:
                for c in (128, 256, 512):
                    yield s, c, dtype


def test_plan_covers_the_supported_domain():
    for s, c, dtype in _domain():
        h = w = int(math.isqrt(s))
        if h * w == s:
            assert ap.supported(torch.zeros((1, h, w, c), dtype=dtype))
        p = ap.plan(s, c)
        assert 1 <= p.cluster <= ap.CLUSTER_MAX and p.cluster & (p.cluster - 1) == 0
        assert p.rows * p.cluster >= s > p.rows * (p.cluster - 1)  # every CTA has rows
        assert p.cluster == 1 or p.rows >= ap.GROUP
        # the largest R: twice as many CTAs would hold fewer than 32 rows each
        assert p.cluster == ap.CLUSTER_MAX or s // (2 * p.cluster) < ap.GROUP
        assert p.ctas_per_sample == p.cluster * c // 32


@pytest.mark.parametrize("s,c,want", [
    (4096, 256, (8, 512, 64)),  # the train step's trunk: 512 CTAs at B = 8
    (4096, 128, (8, 512, 32)),
    (16384, 128, (8, 2048, 32)),  # the TPU kernel's 8 MB fp32 slab
    (16384, 256, (8, 2048, 64)),
    (32768, 128, (8, 4096, 32)),  # its bf16 slab
    (256, 256, (8, 32, 64)),
    # small maps: at least 32 pixel rows a CTA
    (64, 256, (2, 32, 16)),
    (999, 256, (8, 125, 64)),
    (255, 128, (4, 64, 16)),
    (40, 128, (1, 40, 4)),
])
def test_plan_at_the_paths_shapes(s, c, want):
    assert tuple(ap.plan(s, c)) == want


# ------------------------------------------------ the kernels' summation order


def _fma(a, b, c):
    """fmaf: one rounding of a * b + c (the product exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(F32)


def _thread_sums(terms, p, mul=None):
    """Each thread's running sums over its pixel rows, in order: terms [B, S,
    C] float32 -> [B, R, SLOTS, C]; thread (q, slot) of CTA `rank` adds rows
    rank*rows + slot, + SLOTS, ... below min(S, rank*rows + rows), each in
    one rounding: v + t, or fmaf(t, mul, v) where ``mul`` is given."""
    b, s, c = terms.shape
    out = np.zeros((b, p.cluster, ap.SLOTS, c), F32)
    for rank in range(p.cluster):
        p0, p1 = rank * p.rows, min(s, rank * p.rows + p.rows)
        for k in range(p0, p1, ap.SLOTS):
            n = min(ap.SLOTS, p1 - k)
            if mul is None:
                out[:, rank, :n] += terms[:, k:k + n]
            else:
                out[:, rank, :n] = _fma(terms[:, k:k + n], mul[:, k:k + n], out[:, rank, :n])
    return out


def _cluster_sum(terms, p, mul=None):
    """cluster_sum: the slots in order within each CTA, then the CTAs in rank
    order; every CTA gets these bits. [B, S, C] -> [B, C] float32."""
    per_thread = _thread_sums(terms, p, mul)
    part = np.zeros(per_thread.shape[:2] + per_thread.shape[3:], F32)
    for k in range(ap.SLOTS):
        part += per_thread[:, :, k]
    tot = np.zeros((terms.shape[0], terms.shape[2]), F32)
    for r in range(p.cluster):
        tot += part[:, r]
    return tot


def emulate_fwd(x, gamma, beta, eps, p):
    s = F32(x.shape[1])
    m = _cluster_sum(x, p) / s
    d = x - m[:, None]
    v = _cluster_sum(d, p, mul=d) / s  # fmaf(d, d, v)
    r = F32(1) / np.sqrt(v + F32(eps))
    rg = r * gamma
    y = _fma(d, rg[:, None], beta[:, None])
    return y, m, r


def emulate_bwd(x, gamma, mean, rstd, dy, p):
    s = F32(x.shape[1])
    xhat = (x - mean[:, None]) * rstd[:, None]
    db = _cluster_sum(dy, p)
    dg = _cluster_sum(dy, p, mul=xhat)  # fmaf(dy, xhat, dg)
    gr, mb, mg = gamma * rstd, db / s, dg / s
    dx = gr[:, None] * (dy - mb[:, None] - xhat * mg[:, None])
    return dx, dg, db


def _close(got, want, name, rtol=1e-4, atol_rel=1e-5):
    want = np.asarray(want, F32)
    np.testing.assert_allclose(np.asarray(got, F32), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()), err_msg=name)


def _inputs(b, s, c, seed, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0.3, 2.0, (b, s, c)).astype(F32)).to(dtype)
    dy = torch.from_numpy(rng.normal(0, 1, (b, s, c)).astype(F32)).to(dtype)
    gamma = torch.from_numpy(rng.normal(1.0, 0.5, (b, c)).astype(F32))
    beta = torch.from_numpy(rng.normal(0.0, 0.5, (b, c)).astype(F32))
    return x, dy, gamma, beta


# [4, 4096, 256]: the train step's trunk (R = 8); [1, 16384, 128]: the TPU
# kernel's largest fp32 slab; [2, 999, 256]: a last CTA with fewer rows;
# [3, 64, 128]: R = 2; bf16 at 4096.
@pytest.mark.parametrize("b,s,c,dtype", [(4, 4096, 256, torch.float32),
                                         (1, 16384, 128, torch.float32),
                                         (2, 999, 256, torch.float32),
                                         (3, 64, 128, torch.float32),
                                         (2, 4096, 128, torch.bfloat16)])
def test_emulated_sums_meet_the_bars_against_the_plain_versions(b, s, c, dtype):
    x, dy, gamma, beta = _inputs(b, s, c, seed=s + c, dtype=dtype)
    xf, dyf, g, be = (t.to(torch.float32).numpy() for t in (x, dy, gamma, beta))
    y_p, m_p, r_p = ap.adain_fwd_plain(x, gamma, beta)
    y, m, r = emulate_fwd(xf, g, be, ap._EPS, ap.plan(s, c))
    tol = {} if dtype == torch.float32 else dict(rtol=2e-2, atol_rel=2e-2)  # one bf16 rounding
    _close(torch.from_numpy(y).to(dtype).float(), y_p.float(), "y", **tol)
    _close(m, m_p, "mean")
    _close(r, r_p, "rstd")
    dx_p, dg_p, db_p = ap.adain_bwd_plain(x, gamma, m_p, r_p, dy)
    dx, dg, db = emulate_bwd(xf, g, m_p.numpy(), r_p.numpy(), dyf, ap.plan(s, c))
    _close(torch.from_numpy(dx).to(dtype).float(), dx_p.float(), "dx", **tol)
    _close(dg, dg_p, "dgamma", rtol=1e-5, atol_rel=1e-6)
    _close(db, db_p, "dbeta", rtol=1e-5, atol_rel=1e-6)
