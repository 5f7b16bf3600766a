"""Why the port's fp32 conv backward runs three TF32 passes, held on the CPU.

The CUDA kernels of rows 23-24 (``csrc/conv3x3_bwd.cuh``, behind
``msig_tpu_torch.ops.conv3x3_vjp.conv3x3_bwd`` and ``conv3x3_adain_bwd``)
compute dx and dW on the tensor cores in 3xTF32: each operand v splits into
big = tf32_rna(v) and small = tf32_rna(v - big), and each m16n8k8 step adds
small*big, big*small and big*big to an fp32 accumulator, no tile running more
than ``_MAX_K`` of K (dW's pixel chunks, dx's parts of K = 9*Co), the parts
then added in order. This file emulates that arithmetic in torch (the
rounding as integer bit operations) at small widths and holds it against the
plain version, ``conv3x3_bwd_plain``, within the port's fp32 bars (rtol 1e-4,
atol 1e-5 x max|plain|); one TF32 pass (big*big alone) misses them. It also
holds the wrapper's shape precondition, a pure function, against every trunk
shape ``supported()`` admits: B*H*W needs no multiple of 128 any more.

The emulation sums each K step exactly in fp32; the tensor cores add with
truncation, which the card tests (``tests/test_torch_port_train_cuda.py``)
and ``chip_smoke.py`` measure.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msig_tpu.ops import conv3x3_vjp as jcv
from msig_tpu_torch.ops import conv3x3_vjp as cv

RTOL, ATOL_REL = 1e-4, 1e-5  # the port's fp32 bars on dx and dW
SHAPES = [(2, 8, 128), (1, 24, 128)]  # (B, side, C); 24² x 1 = 576 pixels, no multiple of 128
TAPS = [(di, dj) for di in range(3) for dj in range(3)]


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: fp32 rounded to 10 mantissa bits, to nearest, ties away
    from zero, on the bits (add half a unit of the 13 dropped bits, clear them)."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def _split(t):
    big = tf32_rna(t)
    return big, tf32_rna(t - big)


def gemm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the kernel's tile adds it: fp32 accumulator, one m16n8k8 step
    (8 of K) at a time, small*big, big*small, big*big (or big*big alone)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        if passes == 3:
            acc = acc + al[:, s] @ bh[s]
            acc = acc + ah[:, s] @ bl[s]
        acc = acc + ah[:, s] @ bh[s]
    return acc


def gemm_parts(a, b, part: int, passes: int):
    """K in parts of ``part``, each a tile's accumulation, the partials added in order."""
    out = None
    for k0 in range(0, a.shape[1], part):
        p = gemm_tf32(a[:, k0:k0 + part], b[k0:k0 + part], passes)
        out = p if out is None else out + p
    return out


def emulate_conv3x3_bwd(x, w, dy, relu: bool, passes: int = 3):
    """(dx, dW) by the kernel's arithmetic: dx = im2col(dy) [B*H*W, 9*Co] @ wt
    [9*Co, C], dW_t = xin shifted by tap t [C, B*H*W] @ dy [B*H*W, Co]."""
    b, h, wd, c = x.shape
    co = w.shape[-1]
    cdiv = lambda n, d: -(-n // d)  # noqa: E731
    a = torch.cat([cv._shift(dy, 1 - di, 1 - dj).reshape(-1, co) for di, dj in TAPS], dim=1)
    wt = w.reshape(9, c, co).transpose(1, 2).reshape(9 * co, c)
    splits = cdiv(9 * co, cv._MAX_K)
    dx = gemm_parts(a, wt, 32 * cdiv(9 * co // 32, splits), passes).reshape(b, h, wd, c)
    if relu:
        dx = torch.where(x > 0, dx, torch.zeros_like(dx))
    xin = torch.relu(x) if relu else x
    d2 = dy.reshape(-1, co)
    dw = torch.stack([gemm_parts(cv._shift(xin, di - 1, dj - 1).reshape(-1, c).t(), d2,
                                 cv._MAX_K, passes) for di, dj in TAPS])
    return dx, dw.reshape(3, 3, c, co)


def _inputs(b, side, c, seed, x_scale=1.0, dy_scale=1.0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    x = t(rng.normal(0, 1, (b, side, side, c)) * x_scale)
    w = t(rng.uniform(-1, 1, (3, 3, c, c)) / np.sqrt(9 * c))
    dy = t(rng.normal(0, 1, (b, side, side, c)) * dy_scale)
    return x, w, dy


def share_of_bar(got, want) -> float:
    """max |got - want| / (RTOL |want| + ATOL_REL max|want|): at most 1 within the bars."""
    atol = ATOL_REL * float(want.abs().max())
    return float(((got - want).abs() / (RTOL * want.abs() + atol)).max())


# ------------------------------------------------------------------ rounding


def test_tf32_rna_rounds_to_nearest_with_ties_away_from_zero():
    ulp = 2.0 ** -10  # TF32's unit at 1.0
    v = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2**-23, 1 + ulp / 4, -(1 + ulp / 2), 3.0, 0.0,
                      -0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, 1.0, 1.0, -(1 + ulp), 3.0, 0.0, -0.0], dtype=torch.float32)
    got = tf32_rna(v)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_tf32_rna_matches_a_float64_rounding_and_the_split_is_exact_to_fp32():
    v = torch.from_numpy(np.random.default_rng(0).normal(0, 100, 4096).astype(np.float32))
    m, e = np.frexp(v.double().numpy())  # v = m * 2^e, 0.5 <= |m| < 1: 11 significant bits
    want = np.sign(m) * np.floor(np.abs(m) * 2**11 + 0.5) / 2**11 * 2.0**e
    assert np.array_equal(tf32_rna(v).double().numpy(), want)
    big, small = _split(v)
    rest = (v.double() - big.double() - small.double()).abs()
    assert float((rest / v.double().abs()).max()) <= 2.0**-21  # what small*small would carry


# ------------------------------------------------ the three passes, the bars


@pytest.mark.parametrize("b,side,c", SHAPES)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("out", ["dx", "dw"])
def test_three_tf32_passes_meet_the_fp32_bars(b, side, c, relu, out):
    x, w, dy = _inputs(b, side, c, seed=side + b)
    got = emulate_conv3x3_bwd(x, w, dy, relu)
    want = cv.conv3x3_bwd_plain(x, w, dy, relu_input=relu)
    k = ("dx", "dw").index(out)
    assert share_of_bar(got[k], want[k]) <= 1.0
    if relu and out == "dx":
        assert bool((got[0][x <= 0] == 0).all())


@pytest.mark.parametrize("b,side,c", SHAPES)
@pytest.mark.parametrize("out", ["dx", "dw"])
def test_one_tf32_pass_misses_the_fp32_bars(b, side, c, out):
    x, w, dy = _inputs(b, side, c, seed=side + b)
    got = emulate_conv3x3_bwd(x, w, dy, False, passes=1)
    want = cv.conv3x3_bwd_plain(x, w, dy)
    k = ("dx", "dw").index(out)
    assert share_of_bar(got[k], want[k]) > 3.0


@pytest.mark.parametrize("relu", [False, True])
def test_the_small_halves_carry_large_and_small_magnitudes(relu):
    x, w, dy = _inputs(1, 24, 128, seed=11, x_scale=1e3, dy_scale=1e-3)
    want = cv.conv3x3_bwd_plain(x, w, dy, relu_input=relu)
    three = emulate_conv3x3_bwd(x, w, dy, relu)
    one = emulate_conv3x3_bwd(x, w, dy, relu, passes=1)
    for k in range(2):
        assert share_of_bar(three[k], want[k]) <= 1.0
        assert share_of_bar(one[k], want[k]) > 3.0


@pytest.mark.parametrize("relu", [False, True])
def test_the_emulated_kernel_agrees_with_the_jax_kernel(relu):
    """The TPU kernel, in interpret mode, within the bar the port's train-ops
    tests hold the plain version to (rtol 1e-3, atol 1e-4 x max)."""
    x, w, dy = _inputs(2, 8, 256, seed=5)
    got = emulate_conv3x3_bwd(x, w, dy, relu)
    want = jcv.conv3x3_bwd(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                           jnp.asarray(dy.numpy()), relu_input=relu)
    for g, j in zip(got, want):
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-3, atol=1e-4 * float(np.abs(j).max()))


def test_a_k_longer_than_a_tile_takes_runs_in_parts():
    """Co = 384: dx's K = 3456 runs as two parts of 1728, added in order."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (1, 8, 8, 128)).astype(np.float32))
    w = torch.from_numpy((rng.uniform(-1, 1, (3, 3, 128, 384)) / 34).astype(np.float32))
    dy = torch.from_numpy(rng.normal(0, 1, (1, 8, 8, 384)).astype(np.float32))
    got = emulate_conv3x3_bwd(x, w, dy, True)
    want = cv.conv3x3_bwd_plain(x, w, dy, relu_input=True)
    for g, p in zip(got, want):
        assert share_of_bar(g, p) <= 1.0
    assert cv.scratch_floats(1, 8, 8, 128, 384) == 9 * 128 * 384 + 2 * 64 * 128


# ---------------------------------------------------- the wrapper's precondition


@pytest.mark.parametrize("image", range(32, 513, 32))
def test_every_trunk_shape_supported_admits_passes_the_kernel_precondition(image):
    """The generator's trunk at image size ``image`` runs at side image / 4 on
    batches B, 2B and 2B (the train step's launches), B = 1 .. 8."""
    side, c = image // 4, 256
    for batch in range(1, 9):
        for launch in (batch, 2 * batch):
            x_shape, k_shape = (launch, side, side, c), (3, 3, c, c)
            assert cv.supported(x_shape, k_shape, 1, ((1, 1), (1, 1)), "zeros")
            assert cv.kernel_shape_error(x_shape, k_shape) is None, (x_shape, k_shape)


def test_the_precondition_takes_a_ragged_pixel_count_and_rejects_other_widths():
    assert (1 * 24 * 24) % 128 and cv.kernel_shape_error((1, 24, 24, 256), (3, 3, 256, 256)) is None
    assert "multiples of 128" in cv.kernel_shape_error((2, 8, 8, 64), (3, 3, 64, 64))
    assert "multiples of 128" in cv.kernel_shape_error((2, 8, 8, 256), (3, 3, 256, 192))
    assert "expected x" in cv.kernel_shape_error((8, 8, 256), (3, 3, 256, 256))


def test_scratch_holds_dw_chunks_and_no_dx_parts_at_the_trunk_width():
    # [8, 64, 64, 256]: 32768 pixels in 15 chunks of at most 2304; dx's K = 2304 in one part
    assert cv.scratch_floats(8, 64, 64, 256, 256) == 15 * 9 * 256 * 256
    assert cv.scratch_floats(1, 24, 24, 256, 256) == 9 * 256 * 256
