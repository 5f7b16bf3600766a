"""The decoder's ConvT site on wgmma (rows 5, 12, 13) on the CPU: the K-major
weights, the sites with and without them, their callers, and the kernel's two
passes emulated in numpy.

``csrc/conv_i8_wgmma.cuh`` runs the site's phase-split ConvT twice on
``wgmma``, which reads the weights K-major (``fc.pack_convt_weights_ps_kmajor``,
[4, Cout, 4*Cin]): pass S folds the exact statistics from the registers and
stores nothing else; pass Q rebuilds each sample's requant from the finished
statistics and maps its registers straight to int8. The kernel cannot run here.
Its arithmetic is exact integer arithmetic and the epilogue's fp32 operations,
so what can go wrong is the schedule: which tiles a CTA walks, which tap and
channels each 16-byte chunk of a stage holds (two taps at Cin = 64), the zero
halo, which column of the statistics each lane ends with after the
fragment-order reduction, when a CTA's block leaves, and where each staged
int8 row lands. The emulation below follows the kernel's index arithmetic and
is held to the bit against the plain version. On the card,
tests/test_torch_port_cuda.py holds the kernel to the bit against the plain
versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msig_tpu.ops import fused_conv_int8_v2 as jf2
from msig_tpu_torch.infer import quantized as tq
from msig_tpu_torch.ops import fused_conv_int8_v2 as fc
from msig_tpu_torch.ops import fused_dec_int8 as fd

# csrc/conv_i8_wgmma.cuh: pixels a tile, bytes of K a stage, consumer warps;
# the ConvT's channel tile is 128 where Cout % 128 == 0, else 64.
BM, BK, WARPS, EPS = 128, 128, 8, 1e-5
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def start(true_extremes=False):
    """stat_neutral of the header for the five blocks: where a CTA's block, a
    RegStats partial and (the v1 sites' fill) the global block start."""
    return np.array([0, 0, INT32_MAX, INT32_MIN, 0] if true_extremes else [0] * 5, np.int64)


def tile_n(cout: int) -> int:
    return 128 if cout % 128 == 0 else 64


def _convt_weights(cin, cout, seed=0):
    return np.random.default_rng(seed).integers(-127, 128, (4, 4, cin, cout), dtype=np.int8)


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 64), (256, 128)])
def test_pack_convt_weights_ps_kmajor_is_the_per_phase_transpose_of_jax_packing(cin, cout):
    w = _convt_weights(cin, cout, seed=cin + cout)
    want_ps, _ = jf2.pack_convt_weights_ps(jnp.asarray(w), cin, cout)
    want = np.asarray(want_ps).reshape(4, 4 * cin, cout).transpose(0, 2, 1)
    got = fc.pack_convt_weights_ps_kmajor(fc.pack_convt_weights_ps(torch.from_numpy(w), cin, cout))
    assert got.dtype == torch.int8 and got.is_contiguous() and tuple(got.shape) == (4, cout, 4 * cin)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="16\\*Cin, Cout"):
        fc.pack_convt_weights_ps_kmajor(got.reshape(4 * cout, 4 * cin)[:-1])


def _site_inputs(b, side, cin, cout, seed=1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-127, 128, (b, side, side, cin), dtype=np.int8))
    return x, fc.pack_convt_weights_ps(torch.from_numpy(_convt_weights(cin, cout, seed)), cin, cout)


def _sites(x, w, **kw):
    """The three sites of the entry: up0, up1, and up1 staged in both stagings."""
    return (fc.convt4x4s2_in_relu_requant_ps(x, w, **kw), fd.up1_s2d16(x, w, **kw),
            *(fd.up1_s2d16_hbm(x, w, stage=stage, **kw) for stage in fc.STAGES))


@pytest.mark.parametrize("b,side,cin,cout", [(1, 16, 64, 64), (2, 8, 256, 128)])
def test_sites_with_and_without_the_kmajor_copy_agree(b, side, cin, cout):
    x, w = _site_inputs(b, side, cin, cout)
    without = _sites(x, w)
    with_copy = _sites(x, w, w_kmajor=fc.pack_convt_weights_ps_kmajor(w))
    for (q, s), (wq, ws) in zip(with_copy, without):
        assert torch.equal(q, wq) and torch.equal(s, ws)


def test_sites_reject_a_wrong_kmajor_copy():
    x, w = _site_inputs(1, 16, 64, 64)
    wk = fc.pack_convt_weights_ps_kmajor(w)
    for bad in (w, wk.to(torch.int16), wk.transpose(1, 2), wk[:, :32], wk.reshape(-1)):
        for site in (fc.convt4x4s2_in_relu_requant_ps, fd.up1_s2d16, fd.up1_s2d16_hbm):
            with pytest.raises(ValueError, match="w_kmajor"):
                site(x, w, w_kmajor=bad)


@pytest.mark.parametrize("cin,cout", [(64, 64), (256, 128)])
def test_sites_with_the_kmajor_copy_match_pallas(cin, cout):
    """The keyword changes nothing of the function: the port with the copy
    against the Pallas kernel in interpret mode, at the bars of the parity
    tests in tests/test_torch_port_dec.py."""
    x, w = _site_inputs(2, 16, cin, cout, seed=5)
    want_q, want_s = jf2.convt4x4s2_in_relu_requant_ps(
        jf2.to_padded_rows(jnp.asarray(x.numpy())), jnp.asarray(w.numpy()), jf2.PS_TAPS, 16)
    want_q = np.asarray(jf2.unphase_s2d(want_q, 16, cout)).astype(np.int32)
    for got_q, got_s in _sites(x, w, w_kmajor=fc.pack_convt_weights_ps_kmajor(w))[:3]:
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s).reshape(-1, 1), rtol=1e-5)
        diff = np.abs(got_q.numpy().astype(np.int32) - want_q)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01


# ------------------------------------------------ the kernel's two passes


def _fold8(v, op):
    """fold8 of the header over a warp: v [..., 32 lanes, 8] -> [..., 32]. Each
    round, a lane keeps the half of its columns that its lane bit names and
    sends the other half to the lane across that bit."""
    lane = np.arange(32)
    for mask, half in ((16, 4), (8, 2), (4, 1)):
        bit = ((lane & mask) != 0)[:, None]
        send = np.where(bit, v[..., :half], v[..., half:2 * half])
        keep = np.where(bit, v[..., half:2 * half], v[..., :half])
        v = op(keep, send[..., lane ^ mask, :])
    return v[..., 0]


def _tile_stats(acc, true_extremes=False):
    """The CTA's [5, BN] share of a tile's int64 outputs acc [BM, BN], as the
    kernel's warp_stats<BN, kTrue> and its shared atomics build it: per warp
    (16 rows), lane (g, q) folds its two rows of columns 8j + 2q + e, the 8
    lanes of one q halve their columns, and lane g ends with column 32c +
    8(g/2) + 2q + g%2 of chunk c; the sum of squares is split into 32-bit
    words per warp; the extremes zero-masked, or true."""
    bn = acc.shape[1]
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    k = np.arange(8)
    rows = 16 * np.arange(WARPS)[:, None, None, None] + g[None, None, :, None]
    cols = (8 * (4 * np.arange(bn // 32)[None, :, None, None] + k // 2)
            + 2 * q[None, None, :, None] + k % 2)
    v0, v1 = acc[rows, cols], acc[rows + 8, cols]
    s = _fold8(v0 + v1, np.add)
    sq = _fold8(v0 * v0 + v1 * v1, np.add)
    lo_mn, lo_mx = np.minimum(v0, v1), np.maximum(v0, v1)
    if not true_extremes:
        lo_mn, lo_mx = np.minimum(0, lo_mn), np.maximum(0, lo_mx)
    mn, mx = _fold8(lo_mn, np.minimum), _fold8(lo_mx, np.maximum)
    col = (32 * np.arange(bn // 32)[:, None] + 8 * (g // 2) + 2 * q + g % 2).ravel()
    assert np.array_equal(np.sort(col), np.arange(bn)), "each column ends in one lane"
    cta = np.repeat(start(true_extremes)[:, None], bn, axis=1)
    for w in range(WARPS):
        np.add.at(cta[0], col, s[w].ravel())
        np.add.at(cta[1], col, sq[w].ravel() & 0xFFFFFFFF)
        np.minimum.at(cta[2], col, mn[w].ravel())
        np.maximum.at(cta[3], col, mx[w].ravel())
        np.add.at(cta[4], col, sq[w].ravel() >> 32)
    return cta


def _tile_at(tile, tiles_n, mblocks, bn):
    """tile_at of the header: channel tiles fastest, then phases, pixel blocks,
    samples; returns (b, q, m0, n0, key)."""
    tn, r = tile % tiles_n, tile // tiles_n
    q, r2 = r % 4, r // 4
    b = r2 // mblocks
    return b, q, (r2 % mblocks) * BM, tn * bn, b * tiles_n + tn


def _runs(tiles, grid):
    """The contiguous run of tiles of each CTA of a phased geometry (the launch
    takes min(tiles, grid) CTAs)."""
    grid = min(tiles, grid)
    return [range(i * tiles // grid, (i + 1) * tiles // grid) for i in range(grid)]


def _conv_tile(x, wk, b, q, m0, n0, bn):
    """One tile's int64 accumulator [BM, bn] as the producer stages it: chunk
    jc of 128-byte K block kb (two a stage) holds K index 128 kb + 16 jc, its
    tap and channel advanced by 128 bytes a block (two taps a block at Cin =
    64); rows outside the map are zeros; each block is one product with the
    K-major weight rows."""
    _, h, w, cin = x.shape
    m = m0 + np.arange(BM)
    gy, gx = m // w, m % w
    acc = np.zeros((BM, bn), np.float64)  # exact: |partial sums| < 2^53
    taps = [divmod(16 * jc, cin) for jc in range(8)]  # (tap, c0) of each chunk
    for kb in range(4 * cin // BK):
        a = np.zeros((BM, BK), np.float64)
        for jc, (t, c0) in enumerate(taps):
            dy = (t >> 1) - int((q >> 1) == 0)  # ConvT4x4s2Geom::tap
            dx = (t & 1) - int((q & 1) == 0)
            yy, xx = gy + dy, gx + dx
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            a[inside, 16 * jc:16 * jc + 16] = x[b, yy[inside], xx[inside], c0:c0 + 16]
        acc += a @ wk[q, n0:n0 + bn, kb * BK:(kb + 1) * BK].T.astype(np.float64)
        for jc, (t, c0) in enumerate(taps):
            c0 += BK
            while c0 >= cin:
                c0, t = c0 - cin, t + 1
            taps[jc] = (t, c0)
    return acc.astype(np.int64)


def _out_pixel(q, gy, gx, w):
    return (2 * gy + (q >> 1)) * (2 * w) + 2 * gx + (q & 1)


def _merge(block, part):
    block[[0, 1, 4]] += part[[0, 1, 4]]
    block[2], block[3] = np.minimum(block[2], part[2]), np.maximum(block[3], part[3])


class RegStats:
    """RegStats of the header (pass S at BN = 64): per warp, lane and column k
    = 2j + e (column 8j + 2q + e) the sum, the low and high words of the
    squares, the min and max (zero-masked: from 0; true: from the int32
    ends), gathered over tiles; fold() reduces them as warp_stats does and
    adds them to the CTA's block."""
    TILES = 16

    def __init__(self, bn, true_extremes=False):
        self.bn, self.tiles = bn, 0
        self.start = start(true_extremes)[:, None, None, None]
        self.v = np.zeros((5, WARPS, 32, bn // 4), np.int64) + self.start
        lane = np.arange(32)
        k = np.arange(bn // 4)
        self.rows = 16 * np.arange(WARPS)[:, None, None] + (lane // 4)[None, :, None]
        self.cols = 8 * (k // 2)[None, None, :] + 2 * (lane % 4)[None, :, None] + (k % 2)

    def add(self, acc):
        v0, v1 = acc[self.rows, self.cols], acc[self.rows + 8, self.cols]
        sq = v0 * v0 + v1 * v1
        self.v[0] += v0 + v1
        self.v[1] += sq & 0xFFFFFFFF
        self.v[2] = np.minimum(self.v[2], np.minimum(v0, v1))
        self.v[3] = np.maximum(self.v[3], np.maximum(v0, v1))
        self.v[4] += sq >> 32
        assert (self.v[4] < 2 ** 32).all(), "the high words fit 32 bits"

    def fold(self, block):
        lane = np.arange(32)
        g, q = lane // 4, lane % 4
        for c in range(self.bn // 32):
            col = 32 * c + 8 * (g // 2) + 2 * q + g % 2
            part = np.repeat(self.start[:, 0, 0], self.bn, axis=1)
            for w in range(WARPS):
                vals = self.v[:, w, :, 8 * c:8 * c + 8]
                for i, op in enumerate((np.add, np.add, np.minimum, np.maximum, np.add)):
                    op.at(part[i], col, _fold8(vals[i], op))
            _merge(block, part)
        self.v[:] = self.start
        self.tiles = 0


def pass_s(x, wk, cout, grid, seed=0, true_extremes=False):
    """Pass S: every CTA's run of tiles, in a shuffled order of CTAs; a CTA's
    shared block gathers its tiles (by warp_stats per tile, or at BN = 64 by
    the register partials folded every RegStats.TILES tiles) and leaves when
    the next tile is of another (sample, channel tile), or after its last,
    skipping the entries still at their start. The statistics block and the
    CTA's start at their neutral values (``start``: the memset, or with
    ``true_extremes`` the v1 sites' fill). Returns stats [5, B, Cout]."""
    b_, h, w, _ = x.shape
    bn = tile_n(cout)
    tiles_n, mblocks = cout // bn, h * w // BM
    runs = _runs(b_ * 4 * mblocks * tiles_n, grid)
    neutral = start(true_extremes)[:, None]
    stats = np.zeros((5, b_, cout), np.int64) + neutral[:, :, None]
    for cta in np.random.default_rng(seed).permutation(len(runs)):
        block = np.repeat(neutral, bn, axis=1)
        reg = RegStats(bn, true_extremes)
        for tile in runs[cta]:
            b, q, m0, n0, key = _tile_at(tile, tiles_n, mblocks, bn)
            acc = _conv_tile(x, wk, b, q, m0, n0, bn)
            if bn == 64:
                reg.add(acc)
            else:
                _merge(block, _tile_stats(acc, true_extremes))
            nxt = tile + 1
            leaves = nxt >= runs[cta].stop or _tile_at(nxt, tiles_n, mblocks, bn)[4] != key
            if bn == 64:
                reg.tiles += 1
                if leaves or reg.tiles == RegStats.TILES:
                    reg.fold(block)
            if leaves:
                dst = stats[:, b, n0:n0 + bn]
                keep = block != neutral
                part = np.where(keep, block, neutral)
                dst[[0, 1, 4]] += part[[0, 1, 4]]
                dst[2], dst[3] = np.minimum(dst[2], part[2]), np.maximum(dst[3], part[3])
                block[:] = neutral
    return stats


F32 = np.float32


def _load_requant(stats, b, n0, bn, n_out, stage, true_extremes=False):
    """load_requant of the header (in_affine, relu_hi, relu_scale, fold_relu of
    csrc/conv_int8.cuh) in fp32: (amax, a2 [bn], d2 [bn]); with
    ``true_extremes`` (the kTrue mode: true_relu_hi's operations on the true
    extremes) a and d unfolded in place of a2 and d2."""
    sums = stats[0, b].astype(F32)
    sumsq = fc.words_to_f32(torch.from_numpy(stats[4, b]), torch.from_numpy(stats[1, b])).numpy()
    mean = sums / F32(n_out)
    var = np.maximum(sumsq / F32(n_out) - mean * mean, F32(0))
    a = F32(1) * (F32(1) / np.sqrt(var + F32(EPS)))
    d = F32(0) - mean * a
    hi = np.maximum(a * stats[3, b].astype(F32), a * stats[2, b].astype(F32)) + d
    amax = max(F32(0), hi.max())
    if true_extremes:
        return amax, a[n0:n0 + bn], d[n0:n0 + bn]
    s = F32(127) / amax if amax > 0 else F32(1)
    unscale = F32(4096) if stage == "fp16" else F32(1)
    a2, d2 = (a * s) * unscale, d * s
    return amax, a2[n0:n0 + bn], d2[n0:n0 + bn]


def _through(acc, stage):
    """StageOf<Stage>::through: the value as the epilogue reads it."""
    v = acc.astype(F32)
    if stage == "fp16":
        v = (v * F32(2.0 ** -12)).astype(np.float16).astype(F32)
    return v


def pass_q(x, wk, stats, cout, grid, stage, seed=1, true_extremes=False):
    """Pass Q: every CTA's run of tiles, the requant rebuilt when the key
    changes; each tile's values through the staging type and the folded map
    (with ``true_extremes`` the unfolded map of relu_requant_unfolded),
    staged per warp (16 rows, lane (g, q) writes columns 8j + 2q, +1 of rows g
    and g + 8) and read back as 16-byte chunks to their output pixels; the
    tile (q 0, pixel 0, channel 0) of a sample writes its inverse scale.
    Returns (int8 [B, 2H, 2W, Cout], scale [B, 1])."""
    b_, h, w, _ = x.shape
    bn = tile_n(cout)
    tiles_n, mblocks = cout // bn, h * w // BM
    runs = _runs(b_ * 4 * mblocks * tiles_n, grid)
    out = np.full((b_, 4 * h * w, cout), -1000, np.int32)  # -1000: not written
    scale = np.full((b_, 1), np.nan, F32)
    lane = np.arange(32)
    g, qd = lane // 4, lane % 4
    chunks = bn // 16
    for cta in np.random.default_rng(seed).permutation(len(runs)):
        held = None
        for tile in runs[cta]:
            b, q, m0, n0, key = _tile_at(tile, tiles_n, mblocks, bn)
            if key != held:
                amax, a2, d2 = _load_requant(stats, b, n0, bn, 4 * h * w, stage, true_extremes)
                held = key
            t = _through(_conv_tile(x, wk, b, q, m0, n0, bn), stage) * a2 + d2
            if true_extremes:  # max(v*a + d, 0) * s, rounded, clipped to +-127
                s = F32(127) / amax if amax > 0 else F32(1)
                qv = np.clip(np.rint(np.maximum(t, F32(0)) * s), -127, 127).astype(np.int32)
            else:
                qv = np.rint(np.clip(t, F32(0), F32(127))).astype(np.int32)
            for wi in range(WARPS):
                staging = np.full((16, bn + 16), -1000, np.int32)
                for j in range(bn // 8):
                    for hh in range(2):
                        for e in range(2):
                            staging[g + 8 * hh, 8 * j + 2 * qd + e] = \
                                qv[16 * wi + g + 8 * hh, 8 * j + 2 * qd + e]
                for i in range(16 * chunks):  # lane i % 32 reads chunk i
                    rr, ch = divmod(i, chunks)
                    m = m0 + 16 * wi + rr
                    dst = out[b, _out_pixel(q, m // w, m % w, w), n0 + 16 * ch:n0 + 16 * ch + 16]
                    assert (dst == -1000).all(), "written once"
                    dst[:] = staging[rr, 16 * ch:16 * ch + 16]
            if q == 0 and m0 == 0 and n0 == 0:
                scale[b] = amax / F32(127) if amax > 0 else F32(1)
    return out.reshape(b_, 2 * h, 2 * w, cout), scale


# (W, H) with H*W % 128 == 0: W = 24 and 96 put tile edges inside image rows;
# Cin = 64 puts two taps in a stage. On 5 CTAs; on one CTA, a 64 x 10 map
# gives a run of 20 tiles per sample, past the 16 that RegStats holds.
SCHEDULE = [(w, h, cin, cout, stage, 5)
            for w, h in ((16, 8), (24, 16), (64, 2), (96, 4))
            for cin in (64, 128, 256) for cout in (64, 128) for stage in ("int32", "fp16")]
SCHEDULE += [(64, 10, 64, 64, "int32", 1), (64, 10, 128, 64, "fp16", 1),
             (64, 10, 256, 128, "int32", 1)]


@pytest.mark.parametrize("w,h,cin,cout,stage,grid", SCHEDULE)
def test_two_passes_equal_the_plain_site_to_the_bit(w, h, cin, cout, stage, grid):
    b = 2
    rng = np.random.default_rng(w * 1000 + cin + cout)
    x = rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)
    w_ps = fc.pack_convt_weights_ps(torch.from_numpy(_convt_weights(cin, cout, seed=w)), cin, cout)
    wk = fc.pack_convt_weights_ps_kmajor(w_ps).numpy()
    stats = pass_s(x, wk, cout, grid=grid)
    y = fc.convt4x4s2_i64(torch.from_numpy(x), w_ps)  # [B, 2H, 2W, Cout]
    np.testing.assert_array_equal(stats[0], y.sum(dim=(1, 2)).numpy())
    hi, lo = fc.sumsq_words(y)
    np.testing.assert_array_equal(stats[4].astype(object) * 2 ** 32 + stats[1].astype(object),
                                  hi.numpy().astype(object) * 2 ** 32 + lo.numpy())
    np.testing.assert_array_equal(stats[2], y.amin(dim=(1, 2)).clamp(max=0).numpy())
    np.testing.assert_array_equal(stats[3], y.amax(dim=(1, 2)).clamp(min=0).numpy())
    got_q, got_s = pass_q(x, wk, stats, cout, grid=grid, stage=stage)
    want_q, want_s = fc.convt4x4s2_in_relu_requant_ps_plain(torch.from_numpy(x), w_ps,
                                                            stage=stage)
    np.testing.assert_array_equal(got_q, want_q.numpy().astype(np.int32))
    np.testing.assert_array_equal(got_s.view(np.int32), want_s.numpy().view(np.int32))


# ------------------------------------------------------- the decoder's callers


def _fake_generator_sd(n_res, sdim=8, seed=3):
    """A state_dict at full width (64, 128, 256 channels) with random weights."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))  # noqa: E731
    sd = {"content_encoder.0.weight": t(64, 3, 7, 7), "content_encoder.3.weight": t(128, 64, 4, 4),
          "content_encoder.6.weight": t(256, 128, 4, 4),
          f"decoder.{n_res}.weight": t(256, 128, 4, 4),       # ConvTranspose [I, O, kh, kw]
          f"decoder.{n_res + 3}.weight": t(128, 64, 4, 4),
          f"decoder.{n_res + 6}.weight": t(3, 64, 7, 7), f"decoder.{n_res + 6}.bias": t(3)}
    for i in range(n_res):
        for c in ("conv1", "conv2"):
            sd[f"decoder.{i}.{c}.weight"] = t(256, 256, 3, 3)
        for a in ("adain1", "adain2"):
            sd[f"decoder.{i}.{a}.style_modulation.weight"] = t(512, sdim)
            sd[f"decoder.{i}.{a}.style_modulation.bias"] = t(512)
    return sd


def test_quantize_generator_params_stores_the_kmajor_copies():
    q = tq.quantize_generator_params(_fake_generator_sd(1), 1)
    for i, (cin, cout) in enumerate(((256, 128), (128, 64))):
        assert tuple(q[f"up{i}_ps"].shape) == (16 * cin, cout)
        assert torch.equal(q[f"up{i}_ps_pk"], fc.pack_convt_weights_ps_kmajor(q[f"up{i}_ps"]))
        assert q[f"up{i}_ps_pk"].is_contiguous()


@pytest.mark.parametrize("grid,out_dtype", [(64, torch.uint8), (128, torch.uint8),
                                            (64, torch.float32), (128, torch.float32)])
def test_decoder_hands_every_convt_call_its_kmajor_copy(grid, out_dtype, monkeypatch):
    """``_fused_decoder`` passes ``up{i}_ps_pk`` to each ConvT call: up0 and up1
    for uint8 output (up1 staged on a 128-cell grid, a 512² image), and the
    two ConvT calls of the float path."""
    q = {f"up{i}_ps": torch.zeros((16 * cin, cin // 2), dtype=torch.int8)
         for i, cin in enumerate((256, 128))}
    q.update({f"up{i}_ps_pk": fc.pack_convt_weights_ps_kmajor(q[f"up{i}_ps"]) for i in (0, 1)})
    q.update(dict.fromkeys(("out_kernel_i8", "out_wscale", "out_bias")))
    seen = []

    def spy(name):
        def site(x, w_ps, *a, **kw):
            seen.append((name, w_ps, kw.get("w_kmajor")))
            b, h, w, _ = x.shape
            return (torch.zeros((b, 2 * h, 2 * w, w_ps.shape[1]), dtype=torch.int8),
                    torch.ones((b, 1)))
        return site
    monkeypatch.setattr(tq.fc, "convt4x4s2_in_relu_requant_ps", spy("up"))
    monkeypatch.setattr(tq.fd, "up1_s2d16", spy("up1_s2d16"))
    monkeypatch.setattr(tq.fd, "up1_s2d16_hbm", spy("up1_s2d16_hbm"))
    monkeypatch.setattr(tq.fd, "final7_tanh_u8", lambda *a, **k: "image")
    monkeypatch.setattr(tq, "_final_conv_i8", lambda *a: "image")
    assert tq._fused_decoder(q, torch.zeros((1, grid, grid, 256), dtype=torch.int8),
                             out_dtype) == "image"
    up1 = "up" if out_dtype != torch.uint8 else ("up1_s2d16_hbm" if grid > 64 else "up1_s2d16")
    assert [name for name, _, _ in seen] == ["up", up1]
    for i, (_, w_ps, w_kmajor) in enumerate(seen):
        assert w_ps is q[f"up{i}_ps"] and w_kmajor is q[f"up{i}_ps_pk"]
