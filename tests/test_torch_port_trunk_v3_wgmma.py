"""The single-kernel trunk (row 15) on the wgmma main loop, on the CPU: its
schedule emulated in numpy, the K-major weight stack and the quantizer's copy.

``csrc/fused_trunk_blocks.cu`` runs all N resblocks in one cooperative launch,
one CTA per SM, its producer warpgroup loading the convs' operands and its
consumer warpgroups running everything else. Per block: conv1 on
``conv_i8_wgmma.cuh``'s main loop (pass A:
int32 rows, and statistics with the true per-channel extremes), a grid
barrier, conv1's epilogue over all samples, a barrier, conv2's pass A, a
barrier, conv2's max|hn|, a barrier, conv2's requant into the other residual
map, and a barrier before the next block. The kernel cannot run here. The
emulation below follows its index arithmetic: the split of tiles over a grid,
the statistics in fragment order from their neutral values, the CTA's block
leaving when the (sample, channel tile) changes, each CTA's share of the
elementwise groups, and the phases of each block in order with the scales
handed on from block to block. It is held to the bit against
``fused_trunk_blocks_plain``. On the card tests/test_torch_port_cuda.py and
chip_smoke.py hold the kernel itself to the bit.
"""

import numpy as np
import pytest
import torch

from msig_tpu_torch.infer import quantized as tq
from msig_tpu_torch.models.networks import StyleCycleGANGenerator
from msig_tpu_torch.ops import fused_conv_int8_v2 as fc
from msig_tpu_torch.ops import fused_trunk_v3 as f3

# csrc/conv_i8_wgmma.cuh: pixels a tile, consumer warps (16 rows each).
BM, WARPS, EPS = 128, 8, 1e-5
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def tile_n(c: int) -> int:
    """The convs' channel tile (fused_trunk_blocks.cu: kTileN where C % kTileN == 0)."""
    return 256 if c % 256 == 0 else 128


def neutral(k: int, true_extremes: bool) -> int:
    """stat_neutral of the header: where a CTA's statistics block starts."""
    if not true_extremes:
        return 0
    return {2: INT32_MAX, 3: INT32_MIN}.get(k, 0)


def _fold8(v, op):
    """fold8 of the header over a warp: v [..., 32 lanes, 8] -> [..., 32]."""
    lane = np.arange(32)
    for mask, half in ((16, 4), (8, 2), (4, 1)):
        bit = ((lane & mask) != 0)[:, None]
        send = np.where(bit, v[..., :half], v[..., half:2 * half])
        keep = np.where(bit, v[..., half:2 * half], v[..., :half])
        v = op(keep, send[..., lane ^ mask, :])
    return v[..., 0]


def _add_tile(cta, acc, true_extremes):
    """warp_stats<BN, kTrue> of every warp of a tile acc [BM, BN] into the CTA's
    block cta [5, BN]: lane (g, q) of a warp folds its two rows of columns 8j +
    2q + e, the 8 lanes of one q halve their columns, and lane g ends with
    column 32c + 8(g/2) + 2q + g%2 of chunk c; the sum of squares leaves as
    its two 32-bit words per warp."""
    bn = acc.shape[1]
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    k = np.arange(8)
    rows = 16 * np.arange(WARPS)[:, None, None, None] + g[None, None, :, None]
    cols = (8 * (4 * np.arange(bn // 32)[None, :, None, None] + k // 2)
            + 2 * q[None, None, :, None] + k % 2)
    v0, v1 = acc[rows, cols], acc[rows + 8, cols]
    lo_mn, lo_mx = np.minimum(v0, v1), np.maximum(v0, v1)
    if not true_extremes:
        lo_mn, lo_mx = np.minimum(lo_mn, 0), np.maximum(lo_mx, 0)
    s, sq = _fold8(v0 + v1, np.add), _fold8(v0 * v0 + v1 * v1, np.add)
    mn, mx = _fold8(lo_mn, np.minimum), _fold8(lo_mx, np.maximum)
    col = (32 * np.arange(bn // 32)[:, None] + 8 * (g // 2) + 2 * q + g % 2).ravel()
    assert np.array_equal(np.sort(col), np.arange(bn)), "each column ends in one lane"
    for w in range(WARPS):
        np.add.at(cta[0], col, s[w].ravel())
        np.add.at(cta[1], col, sq[w].ravel() & 0xFFFFFFFF)
        np.minimum.at(cta[2], col, mn[w].ravel())
        np.maximum.at(cta[3], col, mx[w].ravel())
        np.add.at(cta[4], col, sq[w].ravel() >> 32)


def conv_pass(x, wk, st, grid, true_extremes=True, seed=0):
    """Pass A as ``produce`` and ``consume<Conv3x3Geom, BN, Epi::kInt32, int32_t,
    1, true>`` run it: CTA k walks tiles k, k + grid, ... (channel tiles fastest); a
    tile is BM pixels of one sample by BN channels, its taps read the shifted
    window with zeros outside the map; the CTA's block starts from the neutral
    values and leaves into st (the site's statistics block, [5*B*C + B]) when
    the next tile is of another (sample, channel tile), skipping entries still
    at their neutral value. The CTAs run in a shuffled order. Returns the
    int32 rows [B, H*W, C] (int64)."""
    b_, h, w, c = x.shape
    hw, bn = h * w, tile_n(c)
    mblocks, tiles_n = hw // BM, c // bn
    tiles = b_ * mblocks * tiles_n
    bc = b_ * c
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    y = np.full((b_, hw, c), np.iinfo(np.int64).min, np.int64)

    def key(tile):
        return (tile // tiles_n) // mblocks * tiles_n + tile % tiles_n

    for cta in np.random.default_rng(seed).permutation(grid):
        walk = list(range(cta, tiles, grid))
        block = np.array([[neutral(k, true_extremes)] * bn for k in range(5)], np.int64)
        for i, tile in enumerate(walk):
            tn, r = tile % tiles_n, tile // tiles_n
            b, m0, n0 = r // mblocks, (r % mblocks) * BM, tn * bn
            m = m0 + np.arange(BM)
            py, px = m // w, m % w
            cols = np.concatenate([xp[b, py + 1 + t // 3 - 1, px + 1 + t % 3 - 1]
                                   for t in range(9)], axis=1)  # [BM, 9C], K = t*C + ci
            acc = (cols @ wk[n0:n0 + bn].astype(np.float64).T).astype(np.int64)
            assert (y[b, m0:m0 + BM, n0:n0 + bn] == np.iinfo(np.int64).min).all(), "once"
            y[b, m0:m0 + BM, n0:n0 + bn] = acc
            _add_tile(block, acc, true_extremes)
            if i + 1 == len(walk) or key(walk[i + 1]) != key(tile):
                for k in range(5):
                    dst = st[k * bc + b * c + n0:k * bc + b * c + n0 + bn]
                    v = block[k]
                    keep = v != neutral(k, true_extremes)
                    if k == 2:
                        dst[keep] = np.minimum(dst[keep], v[keep])
                    elif k == 3:
                        dst[keep] = np.maximum(dst[keep], v[keep])
                    else:
                        dst[keep] += v[keep]
                    block[k] = neutral(k, true_extremes)
    assert (y != np.iinfo(np.int64).min).all(), "every row written"
    return y


def _affine(st, gamma, beta, b_, c, n_out):
    """in_affine<true> of every (sample, channel) from the block, [B, C] each."""
    bc = b_ * c
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    mean = fc.div_by(t(st[:bc]).to(torch.float32), n_out)
    sumsq = fc.words_to_f32(t(st[4 * bc:5 * bc]), t(st[bc:2 * bc]))
    var = torch.clamp(fc.div_by(sumsq, n_out) - mean * mean, min=0.0)
    a = gamma.reshape(-1) * torch.reciprocal(torch.sqrt(var + EPS))
    return a.reshape(b_, c), (beta.reshape(-1) - mean * a).reshape(b_, c)


def _scale(amax):
    """relu_scale and relu_inv_scale."""
    return (torch.where(amax > 0, fc.div_rn(127.0, amax), 1.0),
            torch.where(amax > 0, fc.div_by(amax, 127.0), 1.0))


def cta_groups(n_groups, grid):
    """my_groups of the kernel: CTA k's contiguous share of the groups, in
    runs of four (16 bytes of the int8 residual, which the stream copies)."""
    n4 = n_groups // 4
    return [(4 * (n4 * k // grid), 4 * (n4 * (k + 1) // grid)) for k in range(grid)]


def amax_slot(st, b_, c, b):
    return np.uint32(st[5 * b_ * c + b]).view(np.float32)


def emulate_trunk(x, hs, wk_stack, gammas, betas, n_blocks, grid, true_extremes=True):
    """The kernel's phases, block by block: (int8 [B, H, W, C], scale [B, 1],
    the number of grid barriers)."""
    b_, h, w, c = x.shape
    hw, bc = h * w, b_ * c
    n_groups = b_ * hw * c // 4
    shares = cta_groups(n_groups, grid)
    assert shares[0][0] == 0 and shares[-1][1] == n_groups
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:])), "every group once"
    assert all(lo % 4 == 0 and hi % 4 == 0 for lo, hi in shares), "16-byte residual pieces"
    stats = fc.true_extremes_stats(2 * n_blocks, b_, c, "cpu").numpy()
    sample = (4 * np.arange(n_groups)) // (hw * c)  # e / SC of each group
    src, maps, barriers = x, {}, 0
    out_scale = None
    for blk in range(n_blocks):
        dst = "out" if (n_blocks - 1 - blk) % 2 == 0 else "h_a"
        st1, st2 = stats[2 * blk], stats[2 * blk + 1]
        g1, b1 = gammas[:, 2 * blk], betas[:, 2 * blk]
        g2, b2 = gammas[:, 2 * blk + 1], betas[:, 2 * blk + 1]
        w1 = wk_stack[2 * blk * c:(2 * blk + 1) * c]
        w2 = wk_stack[(2 * blk + 1) * c:(2 * blk + 2) * c]
        # 1. conv1 pass A
        y = conv_pass(src, w1, st1, grid, true_extremes)
        barriers += 1
        # 2. conv1's epilogue: amax over the block's extremes, unfolded requant
        a, d = _affine(st1, g1, b1, b_, c, float(hw))
        cmin = torch.from_numpy(st1[2 * bc:3 * bc].reshape(b_, c)).to(torch.float32)
        cmax = torch.from_numpy(st1[3 * bc:4 * bc].reshape(b_, c)).to(torch.float32)
        amax = torch.clamp(torch.maximum(a * cmax, a * cmin) + d, min=0.0).amax(dim=1)
        s1 = _scale(amax)[0]
        yf = torch.from_numpy(y).to(torch.float32)
        t = torch.clamp(yf * a[:, None] + d[:, None], min=0.0) * s1[:, None, None]
        y1 = torch.clamp(torch.round(t), -127, 127).to(torch.int8).numpy().reshape(x.shape)
        barriers += 1
        # 3. conv2 pass A on y1
        y = conv_pass(y1, w2, st2, grid, true_extremes, seed=blk + 1)
        barriers += 1
        # 4. max|hn|: hs from the block before; each CTA's share, per sample
        if blk == 0:
            hs_b = torch.from_numpy(hs.reshape(-1))
        else:
            prev = torch.tensor([amax_slot(stats[2 * blk - 1], b_, c, b) for b in range(b_)])
            hs_b = _scale(prev)[1]
        a, d = _affine(st2, g2, b2, b_, c, float(hw))
        hn = (torch.from_numpy(y).to(torch.float32) * a[:, None] + d[:, None]
              + torch.from_numpy(src.reshape(b_, hw, c)).to(torch.float32) * hs_b[:, None, None])
        hn_g = hn.abs().reshape(-1, 4).amax(dim=1).numpy()
        for lo, hi in shares:
            for b in np.unique(sample[lo:hi]):
                m = hn_g[lo:hi][sample[lo:hi] == b].max()
                st2[5 * bc + b] = max(st2[5 * bc + b], int(np.float32(m).view(np.uint32)))
        barriers += 1
        # 5. requant into dst; the last block's inverse scale
        amax2 = torch.tensor([amax_slot(st2, b_, c, b) for b in range(b_)])
        s2, inv2 = _scale(amax2)
        q = torch.round(torch.clamp(hn * s2[:, None, None], -127.0, 127.0)).to(torch.int8)
        maps[dst] = q.numpy().reshape(x.shape)
        out_scale = inv2.reshape(b_, 1)
        if blk + 1 < n_blocks:
            barriers += 1
        src = maps[dst]
    assert src is maps["out"], "the last block writes out"
    return maps["out"], out_scale, barriers


def _inputs(c, h, w, n, seed=0, one_sign=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (2, h, w, c), dtype=np.int8)
    ws = [rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8) for _ in range(2 * n)]
    if one_sign:  # block 0's conv1 channels 0-3: non-negative input, positive weights
        x = np.abs(x.astype(np.int16)).astype(np.int8)
        ws[0][..., :4] = np.abs(ws[0][..., :4]) + 1
    hs = rng.uniform(0.5, 2.0, (2, 1)).astype(np.float32)
    g = rng.normal(1.0, 0.5, (2, 2 * n, c)).astype(np.float32)
    be = rng.normal(0.0, 0.5, (2, 2 * n, c)).astype(np.float32)
    if one_sign:  # where the largest modulated value sits at the minimum
        g[:, 0, :4], be[:, 0, :4] = -1.5, 3.0
    packed = [fc.pack_weights(torch.from_numpy(wi)) for wi in ws]
    return x, hs, packed, g, be


# (C, H, W, N, grid): both channel tiles, 8x16 and 16x16 maps, 1-3 blocks,
# the card's 132 CTAs (most of them without a tile) and small ragged grids.
CASES = [(128, 8, 16, 1, 132), (128, 16, 16, 2, 5), (128, 8, 16, 3, 7),
         (256, 8, 16, 2, 132), (256, 16, 16, 1, 3), (256, 16, 16, 3, 132)]


@pytest.mark.parametrize("c,h,w,n,grid", CASES)
def test_schedule_equals_the_plain_trunk(c, h, w, n, grid):
    x, hs, packed, g, be = _inputs(c, h, w, n, seed=c + h + n)
    wk = f3.stack_kmajor(torch.cat(packed)).numpy()
    got, got_s, barriers = emulate_trunk(x, hs, wk, torch.from_numpy(g), torch.from_numpy(be),
                                         n, grid)
    want, want_s = f3.fused_trunk_blocks_plain(torch.from_numpy(x), torch.from_numpy(hs),
                                               torch.cat(packed), torch.from_numpy(g),
                                               torch.from_numpy(be), n)
    assert barriers == 5 * n - 1
    np.testing.assert_array_equal(got, want.numpy())
    assert torch.equal(got_s, want_s)


def test_one_sign_channels_need_the_true_extremes():
    """On channels whose conv1 output has one sign, the emulation with the
    zero-masked statistics of rows 1-4 parts from the plain trunk, and with
    the true extremes (kV3) equals it."""
    c, h, w, n = 128, 8, 16, 1
    x, hs, packed, g, be = _inputs(c, h, w, n, seed=9, one_sign=True)
    y = fc.conv3x3_i64(torch.from_numpy(x), packed[0])
    assert int(y[..., :4].min()) > 0
    wk = f3.stack_kmajor(torch.cat(packed)).numpy()
    args = (torch.from_numpy(g), torch.from_numpy(be), n, 132)
    want, _ = f3.fused_trunk_blocks_plain(torch.from_numpy(x), torch.from_numpy(hs),
                                          torch.cat(packed), *args[:3])
    got = emulate_trunk(x, hs, wk, *args)[0]
    masked = emulate_trunk(x, hs, wk, *args, true_extremes=False)[0]
    np.testing.assert_array_equal(got, want.numpy())
    assert not np.array_equal(masked, want.numpy())


def test_statistics_blocks_start_from_their_neutral_values():
    """A tile whose column has one sign keeps its true min (or max) in the
    CTA's block; the zero-masked fold clamps it at 0."""
    rng = np.random.default_rng(3)
    acc = rng.integers(1, 1000, (BM, 256)).astype(np.int64)
    acc[:, 1] *= -1
    for true_extremes, lo, hi in ((True, acc[:, 0].min(), acc[:, 1].max()), (False, 0, 0)):
        block = np.array([[neutral(k, true_extremes)] * 256 for k in range(5)], np.int64)
        _add_tile(block, acc, true_extremes)
        assert block[2, 0] == lo and block[3, 1] == hi
        assert block[0, 0] == acc[:, 0].sum()


EW_THREADS, EW_CHUNK = 256, 2048  # fused_trunk_blocks.cu: kEwThreads, kEwChunk


def stream_walk(b_, hw, c, grid):
    """stream_groups' walk: per CTA, chunk and consumer thread, the groups it
    takes and the (sample, channel) it carries to each by increments, from
    one division at the chunk's start. Returns [(group, sample, channel)]."""
    sc, dc = hw * c, 4 * EW_THREADS % c
    out = []
    for lo, hi in cta_groups(b_ * hw * c // 4, grid):
        for g0 in range(lo, hi, EW_CHUNK):
            n = min(EW_CHUNK, hi - g0)
            for t in range(EW_THREADS):
                e = 4 * (g0 + t)
                b, ch, left = e // sc, e % c, sc - e % sc
                for j in range(t, n, EW_THREADS):
                    out.append((g0 + j, b, ch))
                    ch += dc
                    if ch >= c:
                        ch -= c
                    left -= 4 * EW_THREADS
                    if left <= 0:
                        b, left = b + 1, left + sc
    return out


@pytest.mark.parametrize("b_,hw,c,grid", [(8, 4096, 256, 132), (2, 128, 128, 5),
                                          (3, 256, 384, 7), (1, 9216, 384, 132)])
def test_stream_walk_carries_sample_and_channel(b_, hw, c, grid):
    """Every group once, with the sample and channel that e / (H*W*C) and
    e % C give (C = 384 moves the channel at every step)."""
    walk = np.array(stream_walk(b_, hw, c, grid))
    order = np.argsort(walk[:, 0])
    g, b, ch = walk[order].T
    np.testing.assert_array_equal(g, np.arange(b_ * hw * c // 4))
    np.testing.assert_array_equal(b, 4 * g // (hw * c))
    np.testing.assert_array_equal(ch, 4 * g % c)


# ------------------------------------------------------------- the weights


def _q(n, c, seed=2):
    rng = np.random.default_rng(seed)
    q = {}
    for i in range(n):
        for k in ("conv1", "conv2"):
            q[f"res{i}_{k}_p"] = fc.pack_weights(torch.from_numpy(
                rng.integers(-127, 128, (3, 3, c, c), dtype=np.int8)))
            q[f"res{i}_{k}_pk"] = fc.pack_weights_kmajor(q[f"res{i}_{k}_p"])
    return q


@pytest.mark.parametrize("n,c", [(1, 128), (3, 256)])
def test_kmajor_stack_is_the_per_site_blocks_stacked(n, c):
    q = _q(n, c)
    got = f3.pack_trunk_weights_kmajor(q, n)
    want = torch.cat([fc.pack_weights_kmajor(q[f"res{i}_{k}_p"])
                      for i in range(n) for k in ("conv1", "conv2")])
    assert got.dtype == torch.int8 and got.is_contiguous() and tuple(got.shape) == (2 * n * c, 9 * c)
    assert torch.equal(got, want)
    assert torch.equal(f3.stack_kmajor(f3.pack_trunk_weights(q, n)), got)


def test_cpu_wrapper_checks_the_kmajor_stack_and_reads_w_stack():
    c, n = 128, 1
    x, hs, packed, g, be = _inputs(c, 8, 16, n)
    args = (torch.from_numpy(x), torch.from_numpy(hs), torch.cat(packed), torch.from_numpy(g),
            torch.from_numpy(be), n)
    wk = f3.stack_kmajor(args[2])
    want = f3.fused_trunk_blocks(*args)
    got = f3.fused_trunk_blocks(*args, w_packed=wk)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for bad in (wk[:-1], wk.to(torch.int16)):
        with pytest.raises(ValueError, match="w_packed"):
            f3.fused_trunk_blocks(*args, w_packed=bad)


@pytest.mark.parametrize("v3", ["0", "1"])
def test_quantization_under_v3_keeps_the_kmajor_stack(monkeypatch, v3):
    monkeypatch.setenv("MSIG_TRUNK_V3", v3)
    torch.manual_seed(0)
    gen = StyleCycleGANGenerator(style_dim=8, n_residual_blocks=2)
    q = tq.quantize_generator_params(gen.state_dict(), 2)
    if v3 == "0":
        assert "trunk_w_stack" not in q and "trunk_w_stack_pk" not in q
        return
    assert torch.equal(q["trunk_w_stack_pk"], f3.pack_trunk_weights_kmajor(q, 2))
    assert torch.equal(q["trunk_w_stack_pk"], f3.stack_kmajor(q["trunk_w_stack"]))


def test_trunk_hands_the_kernel_its_kmajor_stack(monkeypatch):
    """``_fused_trunk_rows`` passes ``trunk_w_stack_pk`` as ``w_packed``
    (the kernel stubbed)."""
    monkeypatch.setenv("MSIG_TRUNK_V3", "1")
    monkeypatch.setenv("MSIG_TRUNK_HIFI", "0")
    n, c, sdim = 2, 8, 4
    q = {f"res{i}_{a}_{k}": (torch.ones((sdim, 2 * c)) if k == "k" else torch.zeros(2 * c))
         for i in range(n) for a in ("adain1", "adain2") for k in ("k", "b")}
    q["trunk_w_stack"] = torch.zeros((2 * n * 9 * c, c), dtype=torch.int8)
    q["trunk_w_stack_pk"] = torch.zeros((2 * n * c, 9 * c), dtype=torch.int8)
    seen = []

    def record(x, hs, w_stack, gammas, betas, n_blocks, **kw):
        seen.append((w_stack, n_blocks, kw))
        return x, hs
    monkeypatch.setattr(tq.f3, "fused_trunk_blocks", record)
    hq = torch.zeros((1, 64, 64, c), dtype=torch.int8)
    tq._fused_trunk_rows(q, hq, torch.ones((1, 1)), torch.ones((1, sdim)), n)
    assert len(seen) == 1
    w_stack, n_blocks, kw = seen[0]
    assert w_stack is q["trunk_w_stack"] and n_blocks == n
    assert kw.keys() == {"w_packed"} and kw["w_packed"] is q["trunk_w_stack_pk"]
