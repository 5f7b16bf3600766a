"""The trunk's wgmma sites (rows 1-2) on the CPU: the K-major weights, the
sites with and without them, and the kernel's tile schedule emulated in numpy.

``csrc/conv_i8_wgmma.cuh`` runs the int8 3x3 conv of the conv1 site and of
the int8-carry conv2 site on ``wgmma``, which reads the weights K-major
(``fc.pack_weights_kmajor``). The kernel cannot run here; its arithmetic is
exact integer arithmetic, so what can go wrong is the schedule: which pixels a
tile covers, the zero halo of the nine shifted windows, and which column of
the statistics each lane ends with after the fragment-order reduction. The
emulation below follows the kernel's index arithmetic and is held to the bit
against ``conv3x3_i64`` and the plain statistics. On the card,
tests/test_torch_port_cuda.py holds the kernels to the bit against the plain
versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msig_tpu.ops import fused_conv_int8 as jfc
from msig_tpu.ops import fused_conv_int8_v2 as jf2
from msig_tpu_torch.infer import quantized as tq
from msig_tpu_torch.ops import fused_conv_int8_v2 as fc

# csrc/conv_i8_wgmma.cuh: pixels a tile, bytes (channels) of K a stage,
# consumer warps, and the channel tile: 256 where C % 256 == 0, else 128.
BM, BK, WARPS = 128, 128, 8


def tile_n(c: int) -> int:
    return 256 if c % 256 == 0 else 128


def _weights(c, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-127, 128, (3, 3, c, c), dtype=np.int8)


@pytest.mark.parametrize("c", [32, 128, 256])
def test_pack_weights_kmajor_is_the_transpose_of_jax_pack_weights(c):
    w = _weights(c, seed=c)
    want = np.asarray(jfc.pack_weights(jnp.asarray(w))).T
    got = fc.pack_weights_kmajor(fc.pack_weights(torch.from_numpy(w)))
    assert got.dtype == torch.int8 and got.is_contiguous() and tuple(got.shape) == (c, 9 * c)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="9C, Co"):
        fc.pack_weights_kmajor(got[:, :-1])


def _site_inputs(b, side, c, seed=1):
    rng = np.random.default_rng(seed)
    t = dict(x=rng.integers(-127, 128, (b, side, side, c), dtype=np.int8),
             hq=rng.integers(-127, 128, (b, side, side, c), dtype=np.int8),
             hs=rng.uniform(0.01, 0.05, (b, 1)).astype(np.float32),
             gamma=rng.normal(1.0, 0.5, (b, c)).astype(np.float32),
             beta=rng.normal(0.0, 0.5, (b, c)).astype(np.float32))
    t = {k: torch.from_numpy(v) for k, v in t.items()}
    t["w"] = fc.pack_weights(torch.from_numpy(rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8)))
    return t


def _sites(t, **kw):
    relu = fc.conv3x3_adain_relu_requant(t["x"], t["w"], t["gamma"], t["beta"], **kw)
    res = fc.conv3x3_adain_residual_requant(t["x"], t["hq"], t["hs"], t["w"], t["gamma"],
                                            t["beta"], **kw)
    return relu, *res


@pytest.mark.parametrize("b,side,c", [(1, 16, 128), (2, 8, 256)])
def test_sites_with_and_without_the_kmajor_copy_agree(b, side, c):
    t = _site_inputs(b, side, c)
    without = _sites(t)
    with_copy = _sites(t, w_kmajor=fc.pack_weights_kmajor(t["w"]))
    for a, w in zip(with_copy, without):
        assert torch.equal(a, w)
    for bad in (t["w"], fc.pack_weights_kmajor(t["w"]).to(torch.int16)):
        with pytest.raises(ValueError, match="w_kmajor"):
            _sites(t, w_kmajor=bad)


def _carry(t, seed=4):
    """A residual h [B, H, W, C] fp32 of t's shape and its two-plane int8
    carry (h1 + h2/254) * hs, as tests/test_torch_port_hifi512.py makes them."""
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 1.5, tuple(t["x"].shape)).astype(np.float32)
    hs = (np.abs(h).max(axis=(1, 2, 3)) / 127.0).astype(np.float32).reshape(-1, 1)
    ht = h / hs.reshape(-1, 1, 1, 1)
    h1 = np.clip(np.round(ht), -127, 127)
    h2 = np.clip(np.round((ht - h1) * 254.0), -127, 127)
    return {k: torch.from_numpy(v) for k, v in (("h", h), ("hs", hs), ("h1", h1.astype(np.int8)),
                                                ("h2", h2.astype(np.int8)))}


def _bf16_ordered(x):
    """Bit patterns of a bf16 array (jax or torch) as int32, ordered like the
    values (+0 and -0 coincide)."""
    if isinstance(x, torch.Tensor):
        bits = x.view(torch.int16).numpy().astype(np.int32)
    else:
        bits = np.asarray(x.view(jnp.int16)).astype(np.int32)
    return np.where(bits >= 0, bits, -(bits & 0x7FFF))


def _assert_bf16_close(got, want):
    """Within 1 ulp on < 1%, as tests/test_torch_port_hifi512.py holds the bf16
    carry; where conv*a + d and the residual cancel to under 2^-16 of the
    sample's largest value, the bar is absolute, 2^-22 of that value."""
    want_f = np.asarray(want.astype(jnp.float32))
    ulps = np.abs(_bf16_ordered(got) - _bf16_ordered(want))
    amax = np.abs(want_f).max(axis=(1, 2, 3), keepdims=True)
    cancelled = np.abs(want_f) < amax * 2.0 ** -16
    assert ulps[~cancelled].max() <= 1 and (ulps[~cancelled] > 0).mean() < 0.01
    assert cancelled.mean() < 1e-3
    assert (np.abs(got.float().numpy() - want_f) <= amax * 2.0 ** -22)[cancelled].all()


@pytest.mark.parametrize("site", [fc.RELU_SITE, fc.RESIDUAL_SITE, fc.HIFI_SITE, fc.HIFI2_SITE])
def test_sites_with_the_kmajor_copy_match_pallas(site):
    """The keyword changes nothing of the function: the port with the copy
    against the Pallas kernel in interpret mode, at the bars of the parity
    tests in tests/test_torch_port_ops.py and tests/test_torch_port_hifi512.py."""
    w_img, c = 16, 256
    t = _site_inputs(2, w_img, c, seed=3)
    wp = t["w"].numpy()
    rows = lambda a: jf2.to_padded_rows(jnp.asarray(a.numpy()))  # noqa: E731
    unpack = lambda a: fc.from_padded_rows(torch.from_numpy(np.array(a)), w_img)  # noqa: E731
    kw = {"w_kmajor": fc.pack_weights_kmajor(t["w"])}
    jtail = (jnp.asarray(wp), jnp.asarray(t["gamma"].numpy()), jnp.asarray(t["beta"].numpy()))
    tail = (t["w"], t["gamma"], t["beta"])
    if site == fc.RELU_SITE:
        want = unpack(jf2.conv3x3_adain_relu_requant(rows(t["x"]), *jtail, w_img=w_img))
        got = fc.conv3x3_adain_relu_requant(t["x"], *tail, **kw)
    elif site == fc.RESIDUAL_SITE:
        want_q, want_s = jf2.conv3x3_adain_residual_requant(
            rows(t["x"]), rows(t["hq"]), jnp.asarray(t["hs"].numpy()), *jtail, w_img=w_img)
        got, got_s = fc.conv3x3_adain_residual_requant(t["x"], t["hq"], t["hs"], *tail, **kw)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s).reshape(-1, 1), rtol=1e-5)
        want = unpack(want_q)
    elif site == fc.HIFI_SITE:
        hb = _carry(t)["h"].to(torch.bfloat16)
        want_q, want_h = jf2.conv3x3_adain_residual_hifi(
            rows(t["x"]), jf2.to_padded_rows(jnp.asarray(hb.float().numpy()).astype(jnp.bfloat16)),
            *jtail, w_img=w_img)
        got, got_h = fc.conv3x3_adain_residual_hifi(t["x"], hb, *tail, **kw)
        g = fc.guard_rows(w_img)
        _assert_bf16_close(got_h, want_h[:, g:g + w_img * (w_img + 8)]
                           .reshape(2, w_img, w_img + 8, c)[:, :, :w_img])
        want = unpack(want_q)
    else:
        r = _carry(t)
        want_q, want_q2, want_s = jf2.conv3x3_adain_residual_hifi2(
            rows(t["x"]), rows(r["h1"]), rows(r["h2"]),
            jnp.asarray(r["hs"].numpy()).reshape(-1, 1, 1), *jtail, w_img=w_img)
        got, got_q2, got_s = fc.conv3x3_adain_residual_hifi2(t["x"], r["h1"], r["h2"], r["hs"],
                                                             *tail, **kw)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s).reshape(-1, 1), rtol=1e-5)
        diff = (got_q2.to(torch.int32) - unpack(want_q2).to(torch.int32)).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 0.01
        want = unpack(want_q)
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 0.01


# ------------------------------------------------ the kernel's tile schedule


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


def _tile_stats(acc):
    """The CTA's [5, BN] block of a tile's int64 outputs acc [BM, BN], as the
    kernel's warp_stats and its shared atomics build it: per warp (16 rows),
    lane (g, q) folds its two rows of columns 8j + 2q + e, the 8 lanes of one q
    halve their columns, and lane g ends with column 32c + 8(g/2) + 2q + g%2
    of chunk c; the sum of squares is split into 32-bit words per warp."""
    bn = acc.shape[1]
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    k = np.arange(8)
    rows = (16 * np.arange(WARPS)[:, None, None, None]  # [warp, chunk, lane, k]
            + g[None, None, :, None])
    cols = (8 * (4 * np.arange(bn // 32)[None, :, None, None] + k // 2)
            + 2 * q[None, None, :, None] + k % 2)
    v0, v1 = acc[rows, cols], acc[rows + 8, cols]
    s = _fold8(v0 + v1, np.add)
    sq = _fold8(v0 * v0 + v1 * v1, np.add)
    mn = _fold8(np.minimum(0, np.minimum(v0, v1)), np.minimum)
    mx = _fold8(np.maximum(0, np.maximum(v0, v1)), np.maximum)
    col = 32 * np.arange(bn // 32)[:, None] + 8 * (g // 2) + 2 * q + g % 2  # [chunk, lane]
    cta = np.zeros((5, bn), np.int64)
    for w in range(WARPS):
        c = col.ravel()
        assert np.array_equal(np.sort(c), np.arange(bn)), "each column ends in one lane"
        np.add.at(cta[0], c, s[w].ravel())
        np.add.at(cta[1], c, sq[w].ravel() & 0xFFFFFFFF)
        np.minimum.at(cta[2], c, mn[w].ravel())
        np.maximum.at(cta[3], c, mx[w].ravel())
        np.add.at(cta[4], c, sq[w].ravel() >> 32)
    return cta


def _staged_chunk(r, c):
    """staged_chunk of the header: where 16-byte chunk c of staged row r sits."""
    return c ^ (2 * (r & 3))


def _through_staging(half):
    """One consumer warpgroup's 64 rows [64, BN] as the storers write them:
    lane (g, q) of warp w puts columns 8j + 2q, +1 of rows 16w + g (+8) at
    chunk staged_chunk(r, 2j + q/2), 8 bytes in where q is odd; a storer reads
    16-byte chunk c of row r from staged_chunk(r, c)."""
    bn = half.shape[1]
    lane = np.arange(32)
    g, q = (lane // 4)[None, None, :, None], (lane % 4)[None, None, :, None]
    j = np.arange(bn // 8)[None, None, None, :]
    r = 16 * np.arange(4)[:, None, None, None] + g + 8 * np.arange(2)[None, :, None, None]
    r, col = np.broadcast_arrays(r, 8 * j + 2 * q)
    idx = 4 * _staged_chunk(r, 2 * j + (q >> 1)) + 2 * (q & 1)
    staging = np.full((64, bn), np.iinfo(np.int64).min, np.int64)
    staging[r, idx], staging[r, idx + 1] = half[r, col], half[r, col + 1]
    rr, cc = np.meshgrid(np.arange(64), np.arange(bn // 4), indexing="ij")
    return staging.reshape(64, bn // 4, 4)[rr, _staged_chunk(rr, cc)].reshape(64, bn)


def emulate(x, wk, grid=132, seed=0):
    """Pass A as the kernel schedules it: persistent CTAs walk the tiles
    blockIdx.x + i * gridDim.x (channel tiles fastest); a tile is BM pixels of
    one sample by BN channels; stage ks is tap ks / (C/BK) and channels
    (ks % (C/BK)) * BK, its pixel window shifted by the tap with zeros outside
    the map; each half of the tile leaves through the staging buffer. The CTAs'
    blocks meet in a shuffled order. Returns (y [B, H*W, C], stats [5, B, C])."""
    b_, h, w, c = x.shape
    hw, bn, chunks = h * w, tile_n(c), c // BK
    tiles_per_sample, tiles_n = hw // BM, c // bn
    tiles = b_ * tiles_per_sample * tiles_n
    y = np.full((b_, hw, c), np.iinfo(np.int64).min, np.int64)
    stats = np.zeros((5, b_, c), np.int64)
    ctas = [list(range(cta, tiles, grid)) for cta in range(min(tiles, grid))]
    for cta in np.random.default_rng(seed).permutation(len(ctas)):
        for tile in ctas[cta]:
            tn, tm = tile % tiles_n, tile // tiles_n
            b, m0, n0 = tm // tiles_per_sample, (tm % tiles_per_sample) * BM, tn * bn
            m = m0 + np.arange(BM)
            py, px = m // w, m % w
            acc = np.zeros((BM, bn), np.float64)  # exact: |partial sums| < 2^53
            for ks in range(9 * chunks):
                tap, c0 = ks // chunks, (ks % chunks) * BK
                yy, xx = py + tap // 3 - 1, px + tap % 3 - 1
                inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                a = np.zeros((BM, BK), np.float64)
                a[inside] = x[b, yy[inside], xx[inside], c0:c0 + BK]
                bt = wk[n0:n0 + bn, tap * c + c0:tap * c + c0 + BK].astype(np.float64)
                acc += a @ bt.T
            acc = acc.astype(np.int64)
            assert (y[b, m0:m0 + BM, n0:n0 + bn] == np.iinfo(np.int64).min).all(), "written once"
            y[b, m0:m0 + BM, n0:n0 + bn] = np.concatenate(
                [_through_staging(acc[:BM // 2]), _through_staging(acc[BM // 2:])])
            cta_block = _tile_stats(acc)
            stats[(0, 1, 4), b, n0:n0 + bn] += cta_block[[0, 1, 4]]
            stats[2, b, n0:n0 + bn] = np.minimum(stats[2, b, n0:n0 + bn], cta_block[2])
            stats[3, b, n0:n0 + bn] = np.maximum(stats[3, b, n0:n0 + bn], cta_block[3])
    return y, stats


# (W, H) with H*W % 128 == 0: W = 24 and 96 put tile edges inside image rows;
# C = 384 takes three channel tiles of 128.
SCHEDULE = [(w, h, c) for w, h in ((16, 16), (24, 16), (64, 4), (96, 4), (128, 2))
            for c in (128, 256)] + [(16, 8, 384)]


@pytest.mark.parametrize("w,h,c", SCHEDULE)
def test_tile_schedule_equals_the_plain_conv_and_statistics(w, h, c):
    b = 2
    rng = np.random.default_rng(w * 1000 + c)
    x = rng.integers(-127, 128, (b, h, w, c), dtype=np.int8)
    w_packed = fc.pack_weights(torch.from_numpy(rng.integers(-127, 128, (3, 3, c, c),
                                                             dtype=np.int8)))
    y, stats = emulate(x, fc.pack_weights_kmajor(w_packed).numpy(), grid=3)
    want = fc.conv3x3_i64(torch.from_numpy(x), w_packed)  # [B, H, W, C]
    np.testing.assert_array_equal(y, want.reshape(b, h * w, c).numpy())
    np.testing.assert_array_equal(stats[0], want.sum(dim=(1, 2)).numpy())
    hi, lo = fc.sumsq_words(want)
    got_sq = stats[4].astype(object) * 2 ** 32 + stats[1].astype(object)
    np.testing.assert_array_equal(got_sq, hi.numpy().astype(object) * 2 ** 32 + lo.numpy())
    np.testing.assert_array_equal(
        fc.words_to_f32(torch.from_numpy(stats[4]), torch.from_numpy(stats[1])).numpy(),
        fc.words_to_f32(hi, lo).numpy())
    np.testing.assert_array_equal(stats[2], want.amin(dim=(1, 2)).clamp(max=0).numpy())
    np.testing.assert_array_equal(stats[3], want.amax(dim=(1, 2)).clamp(min=0).numpy())


# ------------------------------------------------------- the trunk's callers


def _trunk_q(n_res, c, s, seed=4):
    rng = np.random.default_rng(seed)
    q = {}
    for i in range(n_res):
        for conv in ("conv1", "conv2"):
            q[f"res{i}_{conv}_p"] = fc.pack_weights(torch.from_numpy(
                rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8)))
            q[f"res{i}_{conv}_pk"] = fc.pack_weights_kmajor(q[f"res{i}_{conv}_p"])
        for a in ("adain1", "adain2"):
            q[f"res{i}_{a}_k"] = torch.from_numpy(rng.normal(0, 0.1, (s, 2 * c)).astype(np.float32))
            q[f"res{i}_{a}_b"] = torch.from_numpy(
                np.concatenate([np.ones(c), np.zeros(c)]).astype(np.float32))
    return q


@pytest.mark.parametrize("hifi", ["0", "1", "2"])
def test_trunk_hands_the_wgmma_sites_their_kmajor_copies(hifi, monkeypatch):
    """``_fused_trunk_rows`` passes each resblock's K-major copies to conv1 and
    to conv2 in every mode (the three conv2 sites run their conv on wgmma);
    the output is the same without the copies in ``q``."""
    n_res, c, s, b, side = 2, 128, 8, 1, 16
    monkeypatch.setenv("MSIG_TRUNK_HIFI", hifi)
    q = _trunk_q(n_res, c, s)
    rng = np.random.default_rng(5)
    hq = torch.from_numpy(rng.integers(-127, 128, (b, side, side, c), dtype=np.int8))
    hs = torch.full((b, 1), 0.02)
    style = torch.from_numpy(rng.normal(size=(b, s)).astype(np.float32))
    seen = []
    for name in ("conv3x3_adain_relu_requant", "conv3x3_adain_residual_requant",
                 "conv3x3_adain_residual_hifi", "conv3x3_adain_residual_hifi2"):
        def record(*args, _name=name, _fn=getattr(fc, name), **kw):
            seen.append((_name, kw.get("w_kmajor")))
            return _fn(*args, **kw)
        monkeypatch.setattr(fc, name, record)
    got = tq._fused_trunk_rows(q, hq, hs, style, n_res)
    conv2 = {"0": "conv3x3_adain_residual_requant", "1": "conv3x3_adain_residual_hifi",
             "2": "conv3x3_adain_residual_hifi2"}[hifi]
    assert [n for n, _ in seen] == ["conv3x3_adain_relu_requant", conv2] * n_res
    for i in range(n_res):
        assert seen[2 * i][1] is q[f"res{i}_conv1_pk"]
        assert seen[2 * i + 1][1] is q[f"res{i}_conv2_pk"]
    plain_q = {k: v for k, v in q.items() if not k.endswith("_pk")}
    assert torch.equal(got, tq._fused_trunk_rows(plain_q, hq, hs, style, n_res))
