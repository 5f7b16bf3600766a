"""The v1 sites and the 9-tap ConvT site on the wgmma main loop (rows 6, 19,
21), on the CPU: the K-major copy of the 9-tap operand, the kernels' schedule
in the true-extremes mode emulated in numpy, the statistics block's start and
the wrappers' ``w_kmajor`` keyword.

Row 6 (``fc.convt4x4s2_in_relu_requant``) runs row 5's two passes on the
K-major copy of the operand's nonzero blocks (``fc.pack_convt_kcat_kmajor``);
row 21 (``v1.convt4x4s2_in_relu_requant``) runs the same passes in
``conv_i8_wgmma.cuh``'s kTrue mode: pass S keeps the true per-channel
extremes (``warp_stats<BN, true>``, and at BN = 64 ``RegStats`` from the
int32 ends), pass Q maps its registers by ``relu_requant_unfolded``. Row 19
(``v1.conv3x3_adain_relu_requant``) runs rows 1-4's pass A in the kTrue mode,
then ``true_relu_requant_kernel``. Each site's statistics block starts at the
mode's neutral values, set by the C entry on the stream (the extremes at the
int32 ends). The emulations follow the kernels' index arithmetic
(``test_torch_port_convt_wgmma``'s passes, ``test_torch_port_trunk_v3_wgmma``'s
pass A) and are held to the bit against the plain versions. The plain
versions' parity with the Pallas kernels is in tests/test_torch_port_v1.py; on
the card tests/test_torch_port_cuda.py holds the kernels themselves.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_convt_wgmma import INT32_MAX, INT32_MIN, pass_q, pass_s, start
from test_torch_port_trunk_v3_wgmma import _affine, _scale, conv_pass

from msig_tpu.ops import fused_conv_int8 as jfc
from msig_tpu_torch.ops import _build
from msig_tpu_torch.ops import fused_conv_int8 as v1
from msig_tpu_torch.ops import fused_conv_int8_v2 as fc


def _convt_weights(cin, cout, seed, one_sign=False):
    w = np.random.default_rng(seed).integers(-127, 128, (4, 4, cin, cout), dtype=np.int8)
    if one_sign:  # channels 0-3 non-positive: with x >= 0 their outputs are <= 0
        w[..., :4] = -np.abs(w[..., :4])
    return w


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 64), (256, 128)])
def test_pack_convt_kcat_kmajor_is_the_phase_split_copy(cin, cout):
    """The K-major copy of the 9-tap operand equals the phase-split packing's
    K-major copy, and the nonzero blocks of the JAX package's operand."""
    w = _convt_weights(cin, cout, seed=cin + cout)
    kcat = fc.pack_convt_weights(torch.from_numpy(w), cin, cout)
    jk = np.asarray(jfc.pack_convt_weights(jnp.asarray(w), cin, cout))
    np.testing.assert_array_equal(kcat.numpy(), jk)
    got = fc.pack_convt_kcat_kmajor(kcat)
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert tuple(got.shape) == fc.convt_kcat_kmajor_shape(kcat) == (4, cout, 4 * cin)
    want = fc.pack_convt_weights_ps_kmajor(fc.pack_convt_weights_ps(torch.from_numpy(w), cin,
                                                                   cout))
    assert torch.equal(got, want)
    blocks = jk.reshape(9, cin, 4, cout)
    for q, taps in enumerate(fc.PS_TAPS):
        for t, (dy, dx) in enumerate(taps):
            np.testing.assert_array_equal(got[q, :, t * cin:(t + 1) * cin].numpy(),
                                          blocks[(dy + 1) * 3 + dx + 1, :, q].T)
    with pytest.raises(ValueError, match="9\\*Cin, 4\\*Cout"):
        fc.pack_convt_kcat_kmajor(kcat[:-1])


def _convt_case(w, h, cin, cout, seed, one_sign=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (2, h, w, cin), dtype=np.int8)
    if one_sign:
        x = np.abs(x.astype(np.int16)).astype(np.int8)
    kcat = fc.pack_convt_weights(torch.from_numpy(_convt_weights(cin, cout, seed, one_sign)),
                                 cin, cout)
    return x, kcat, fc.pack_convt_kcat_kmajor(kcat).numpy()


def _as_int32(q):
    return q.numpy().astype(np.int32)


# (W, H, Cin, Cout, grid): BN = 64 (RegStats) and 128 (warp_stats), Cin 64
# (two taps a K block), tile edges inside image rows (W = 24), several CTAs a
# sample; on one CTA a 64 x 10 map gives 20 tiles a sample, past the 16 that
# RegStats holds.
TRUE_SCHEDULE = [(16, 8, 64, 64, 5), (24, 16, 128, 64, 3), (16, 8, 256, 128, 5),
                 (64, 10, 64, 64, 1)]


@pytest.mark.parametrize("w,h,cin,cout,grid", TRUE_SCHEDULE)
def test_true_two_passes_equal_the_v1_plain_site_to_the_bit(w, h, cin, cout, grid):
    """Row 21: pass S's statistics are the plain version's exact sums and true
    extremes, and pass Q's int8 map and scale its bits."""
    x, kcat, wk = _convt_case(w, h, cin, cout, seed=w + cin + cout)
    stats = pass_s(x, wk, cout, grid=grid, true_extremes=True)
    y = fc.convt4x4s2_kcat_i64(torch.from_numpy(x), kcat)
    np.testing.assert_array_equal(stats[0], y.sum(dim=(1, 2)).numpy())
    hi, lo = fc.sumsq_words(y)
    np.testing.assert_array_equal(stats[4].astype(object) * 2 ** 32 + stats[1].astype(object),
                                  hi.numpy().astype(object) * 2 ** 32 + lo.numpy())
    np.testing.assert_array_equal(stats[2], y.amin(dim=(1, 2)).numpy())
    np.testing.assert_array_equal(stats[3], y.amax(dim=(1, 2)).numpy())
    got_q, got_s = pass_q(x, wk, stats, cout, grid=grid, stage="int32", true_extremes=True)
    want_q, want_s = v1.convt4x4s2_in_relu_requant_plain(torch.from_numpy(x), kcat)
    np.testing.assert_array_equal(got_q, _as_int32(want_q))
    np.testing.assert_array_equal(got_s.view(np.int32), want_s.numpy().view(np.int32))


def _apart(a, b):
    """The two int8 maps part by more than the 1-step bar of the card tests."""
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return diff.max() > 1 or (diff > 0).mean() >= 0.01


@pytest.mark.parametrize("cout", [64, 128])
def test_one_sign_channels_part_rows_21_and_6(cout):
    """On channels whose outputs are all negative the true extremes and the
    zero-masked ones set different amax: the kTrue passes equal row 21's plain
    version, the zero-masked ones row 6's, and the two part."""
    x, kcat, wk = _convt_case(16, 8, 64, cout, seed=11, one_sign=True)
    y = fc.convt4x4s2_kcat_i64(torch.from_numpy(x), kcat)
    assert int(y[..., :4].max()) < 0
    true_q, _ = pass_q(x, wk, pass_s(x, wk, cout, 3, true_extremes=True), cout, 3, "int32",
                       true_extremes=True)
    masked_q, _ = pass_q(x, wk, pass_s(x, wk, cout, 3), cout, 3, "int32")
    np.testing.assert_array_equal(
        true_q, _as_int32(v1.convt4x4s2_in_relu_requant_plain(torch.from_numpy(x), kcat)[0]))
    np.testing.assert_array_equal(
        masked_q, _as_int32(fc.convt4x4s2_in_relu_requant_plain(torch.from_numpy(x), kcat)[0]))
    assert _apart(true_q, masked_q)


def _conv1_case(c, h, w, seed, one_sign=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (2, h, w, c), dtype=np.int8)
    wt = rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8)
    gamma = rng.normal(1.0, 0.5, (2, c)).astype(np.float32)
    beta = rng.normal(0.0, 0.5, (2, c)).astype(np.float32)
    if one_sign:  # channels 0-3 all positive, the largest modulated value at their minimum
        x = np.abs(x.astype(np.int16)).astype(np.int8)
        wt[..., :4] = np.abs(wt[..., :4]) + 1
        gamma[:, :4], beta[:, :4] = -1.5, 3.0
    packed = fc.pack_weights(torch.from_numpy(wt))
    return x, packed, torch.from_numpy(gamma), torch.from_numpy(beta)


def emulate_conv1(x, packed, gamma, beta, grid, true_extremes=True):
    """Row 19 (and with the zero-masked statistics the epilogue on row 1's
    block): the C entry's fill, pass A (rows 1-4's schedule in the kTrue
    mode), then true_relu_requant_kernel: the affine, amax over the block's
    extremes, the unfolded requant. Returns (int8 [B, H, W, C], the block)."""
    b_, h, w, c = x.shape
    st = np.concatenate([np.repeat(start(true_extremes), b_ * c), np.zeros(b_, np.int64)])
    y = conv_pass(x, fc.pack_weights_kmajor(packed).numpy(), st, grid, true_extremes)
    bc = b_ * c
    a, d = _affine(st, gamma, beta, b_, c, float(h * w))
    cmin = torch.from_numpy(st[2 * bc:3 * bc].reshape(b_, c)).to(torch.float32)
    cmax = torch.from_numpy(st[3 * bc:4 * bc].reshape(b_, c)).to(torch.float32)
    amax = torch.clamp(torch.maximum(a * cmax, a * cmin) + d, min=0.0).amax(dim=1)
    s = _scale(amax)[0]
    t = torch.clamp(torch.from_numpy(y).to(torch.float32) * a[:, None] + d[:, None],
                    min=0.0) * s[:, None, None]
    q = torch.clamp(torch.round(t), -127, 127).to(torch.int8).numpy().reshape(x.shape)
    return q, st


# (C, H, W, grid): BN = 128 and 256 (row 1's channel tiles), one and several
# tiles a CTA, the card's 132 CTAs.
CONV1_CASES = [(128, 8, 16, 5), (256, 8, 16, 3), (128, 16, 16, 132)]


@pytest.mark.parametrize("c,h,w,grid", CONV1_CASES)
def test_true_pass_a_equals_the_v1_conv1_plain_site_to_the_bit(c, h, w, grid):
    """Row 19: pass A's block holds the exact sums and the true extremes, and
    the epilogue on it gives the plain version's bits."""
    x, packed, gamma, beta = _conv1_case(c, h, w, seed=c + h + grid)
    got, st = emulate_conv1(x, packed, gamma, beta, grid)
    y = fc.conv3x3_i64(torch.from_numpy(x), packed)
    bc = 2 * c
    np.testing.assert_array_equal(st[:bc].reshape(2, c), y.sum(dim=(1, 2)).numpy())
    np.testing.assert_array_equal(st[2 * bc:3 * bc].reshape(2, c), y.amin(dim=(1, 2)).numpy())
    np.testing.assert_array_equal(st[3 * bc:4 * bc].reshape(2, c), y.amax(dim=(1, 2)).numpy())
    want = v1.conv3x3_adain_relu_requant_plain(torch.from_numpy(x), packed, gamma, beta)
    np.testing.assert_array_equal(got, want.numpy())


def test_one_sign_channels_part_rows_19_and_1():
    """Channels whose conv output is all positive, with gamma < 0: the kTrue
    pass A equals row 19's plain version; the zero-masked block (row 1's) holds
    0 as those channels' minimum and gives another amax, and rows 19 and 1
    part by more than the bar."""
    x, packed, gamma, beta = _conv1_case(128, 8, 16, seed=9, one_sign=True)
    y = fc.conv3x3_i64(torch.from_numpy(x), packed)
    assert int(y[..., :4].min()) > 0
    got, _ = emulate_conv1(x, packed, gamma, beta, grid=5)
    masked, st = emulate_conv1(x, packed, gamma, beta, grid=5, true_extremes=False)
    assert (st[2 * 256:2 * 256 + 4] == 0).all()
    want19 = v1.conv3x3_adain_relu_requant_plain(torch.from_numpy(x), packed, gamma, beta)
    want1 = fc.conv3x3_adain_relu_requant_plain(torch.from_numpy(x), packed, gamma, beta)
    np.testing.assert_array_equal(got, want19.numpy())
    assert not np.array_equal(masked, got)
    assert _apart(want19.numpy(), want1.numpy())


def test_statistics_block_starts_at_the_int32_ends():
    """The v1 sites' C entries fill the block with stat_neutral<true> (the
    extremes' blocks at the int32 ends, the rest 0), where a CTA's shared
    block starts too, so the flush's skip of entries left at the start is
    right in both; the ends lie past every accumulator the wrappers admit
    (max|y| < 2^29, fc.check_statistics)."""
    header = (_build.CSRC / "conv_i8_wgmma.cuh").read_text()
    assert "k == 2 ? 0x7fffffffll : (k == 3 ? -0x80000000ll : 0ll)" in header
    fill = re.search(r"stats_fill_kernel\(.*?\n}\n", header, re.S).group(0)
    assert "k < (size_t)kStatBlocks ? stat_neutral<kTrue>((int)k) : 0ll" in fill
    assert "stats_fill_kernel<true><<<" in header
    assert list(start(True)) == [0, 0, INT32_MAX, INT32_MIN, 0]
    assert (INT32_MAX, INT32_MIN) == (0x7FFFFFFF, -0x80000000)
    k_max = (2 ** 29 - 1) // (128 * 127)
    fc.check_statistics((1, 1, 1, 1), 1, k_max)
    with pytest.raises(ValueError, match="too large"):
        fc.check_statistics((1, 1, 1, 1), 1, k_max + 1)
    assert 128 * 127 * k_max < INT32_MAX and -128 * 127 * k_max > INT32_MIN


def _trunk_args():
    rng = np.random.default_rng(4)
    c = 128
    x = torch.from_numpy(rng.integers(-127, 128, (1, 64, 64, c), dtype=np.int8))
    packed = fc.pack_weights(torch.from_numpy(rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8)))
    g = torch.from_numpy(rng.normal(1.0, 0.5, (1, c)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0.0, 0.5, (1, c)).astype(np.float32))
    hs = torch.full((1, 1), 0.02)
    return x, packed, g, b, hs


@pytest.mark.parametrize("site", ["relu_v1", "residual_v1", "convt_v1", "convt_9tap"])
def test_wrappers_take_the_kmajor_copy_on_the_cpu(site):
    """The four wrappers' ``w_kmajor`` on CPU tensors: given, the same result
    as absent (the plain version reads the packed weights); of a wrong shape
    or dtype, a ValueError that names it."""
    if site.startswith("convt"):
        x, kcat, _ = _convt_case(16, 16, 64, 64, seed=3)
        x = torch.from_numpy(x)
        wk = fc.pack_convt_kcat_kmajor(kcat)
        fn = v1.convt4x4s2_in_relu_requant if site == "convt_v1" else fc.convt4x4s2_in_relu_requant
        call = lambda **kw: fn(x, kcat, **kw)  # noqa: E731
        bad = (wk[:2], wk.transpose(1, 2), wk.to(torch.int16), kcat)
    else:
        x, packed, g, b, hs = _trunk_args()
        wk = v1.pack_weights_kmajor(packed)
        if site == "relu_v1":
            call = lambda **kw: v1.conv3x3_adain_relu_requant(x, packed, g, b, **kw)  # noqa: E731
        else:
            call = lambda **kw: v1.conv3x3_adain_residual_requant(  # noqa: E731
                x, x, hs, packed, g, b, **kw)
        bad = (wk[:64], wk.t(), wk.to(torch.int32), packed)
    given, absent = call(w_kmajor=wk), call()
    given, absent = (given if isinstance(given, tuple) else (given,),
                     absent if isinstance(absent, tuple) else (absent,))
    assert all(torch.equal(p, q) for p, q in zip(given, absent))
    for w in bad:
        with pytest.raises(ValueError, match="w_kmajor"):
            call(w_kmajor=w)
