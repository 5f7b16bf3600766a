"""The encoder's two-pass sites (rows 7-11) on the CPU: the K-major weights of
the 4x4/s2 site, the sites with and without them, their callers, and both
CUDA entries' passes emulated in numpy.

``csrc/conv4x4s2_in_relu_requant.cu`` runs enc1 and enc2 twice on the
``wgmma`` main loop of ``csrc/conv_i8_wgmma.cuh``, which reads the weights
K-major (``fe.pack_conv4x4_kmajor``, [Cout, 16*Cin]) and whose grid is the
output map: pass S folds the exact statistics from the registers, pass Q
rebuilds each sample's requant and maps its registers straight to int8.
The same source runs enc1's four-phase form (``fe.enc1_in_relu_requant_im2col``,
``MSIG_ENC1_IM2COL=1``) on the same two passes over ``Enc1PhaseGeom``, a
quarter of the output map a phase, K-major blocks ``fe.pack_enc1_im2col_kmajor``.
``csrc/enc0_in_relu_requant.cu`` runs enc0 (and the staged 512² site) as two
passes over the same tile producer: a reflected halo of one word a pixel, a
K laid out by tap slot, register partials of the statistics. The kernels
cannot run here. Their arithmetic is exact integer arithmetic and the
epilogue's fp32 operations, so what can go wrong is the schedule: which tiles
a CTA walks, each 16-byte chunk's tap and channels (two taps a K block at
Cin = 64), the in-map bits at both edges (stride 2, and stride 4 in the
four-phase form, whose tiles of phase q read weight block q), which
statistics column a lane ends with, enc0's slot layout of A and B and its
reflected halo, where each int8 row lands, and pass Q's rounding in both
stagings. The emulation
below follows the kernels' index arithmetic and is held to the bit against
the plain versions. On the card, tests/test_torch_port_cuda.py and
chip_smoke.py hold the kernels to the bit against the plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_convt_wgmma import (BK, BM, WARPS, RegStats, _fake_generator_sd, _load_requant,
                                         _merge, _out_pixel, _runs, _through, _tile_stats)
from test_torch_port_convt_wgmma import _tile_at as _tile_at_phased

from msig_tpu.ops import fused_enc_int8 as jfe
from msig_tpu_torch.infer import quantized as tq
from msig_tpu_torch.ops import fused_enc_int8 as fe

F32 = np.float32


def tile_n(cout: int) -> int:
    """The 4x4/s2 site's channel tile (conv_i8_wgmma.cuh::conv4x4s2_i8)."""
    return 256 if cout % 256 == 0 else (128 if cout % 128 == 0 else 64)


def _conv4x4_weights(cin, cout, seed=0):
    return np.random.default_rng(seed).integers(-127, 128, (4, 4, cin, cout), dtype=np.int8)


# ------------------------------------------------- the K-major weights


def test_pack_conv4x4_kmajor_is_the_transpose_of_jax_packing():
    """At enc2's [4, 4, 128, 256] the transpose of ``pack_enc2``; at enc1's
    [4, 4, 64, 128] of each phase block of ``pack_enc1_im2col``."""
    w2 = _conv4x4_weights(128, 256, seed=2)
    got = fe.pack_conv4x4_kmajor(fe.pack_conv4x4(torch.from_numpy(w2)))
    assert got.dtype == torch.int8 and got.is_contiguous() and tuple(got.shape) == (256, 2048)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfe.pack_enc2(w2)).T)
    w1 = _conv4x4_weights(64, 128, seed=1)
    got = fe.pack_conv4x4_kmajor(fe.pack_conv4x4(torch.from_numpy(w1))).numpy()
    blocks = np.asarray(jfe.pack_enc1_im2col(w1)).reshape(4, 1024, 128)
    for q in range(4):
        np.testing.assert_array_equal(got, blocks[q].T)
    with pytest.raises(ValueError, match="16\\*Cin, Cout"):
        fe.pack_conv4x4_kmajor(torch.zeros((1000, 128), dtype=torch.int8))


def _site_inputs(b, side, cin, cout, seed=1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-127, 128, (b, side, side, cin), dtype=np.int8))
    return x, fe.pack_conv4x4(torch.from_numpy(_conv4x4_weights(cin, cout, seed)))


@pytest.mark.parametrize("cin,cout", [(64, 128), (128, 256), (64, 64)])
def test_sites_with_and_without_the_kmajor_copy_agree(cin, cout):
    x, w = _site_inputs(2, 16, cin, cout)
    wk = fe.pack_conv4x4_kmajor(w)
    assert torch.equal(fe.enc1_in_relu_requant(x, w, w_kmajor=wk), fe.enc1_in_relu_requant(x, w))
    for a, b in zip(fe.enc2_in_relu_requant(x, w, w_kmajor=wk), fe.enc2_in_relu_requant(x, w)):
        assert torch.equal(a, b)


def test_sites_reject_a_wrong_kmajor_copy():
    x, w = _site_inputs(1, 16, 64, 128)
    wk = fe.pack_conv4x4_kmajor(w)
    for bad in (w, wk.to(torch.int16), wk[:64], wk.reshape(-1)):
        for site in (fe.enc1_in_relu_requant, fe.enc2_in_relu_requant):
            with pytest.raises(ValueError, match="w_kmajor"):
                site(x, w, w_kmajor=bad)


def test_quantize_generator_params_stores_the_kmajor_copies():
    q = tq.quantize_generator_params(_fake_generator_sd(1), 1)
    for i, (cin, cout) in ((1, (64, 128)), (2, (128, 256))):
        assert tuple(q[f"enc{i}_p"].shape) == (16 * cin, cout)
        assert torch.equal(q[f"enc{i}_pk"], fe.pack_conv4x4_kmajor(q[f"enc{i}_p"]))
        assert q[f"enc{i}_pk"].is_contiguous()


def test_encoder_hands_enc1_and_enc2_their_kmajor_copies(monkeypatch):
    q = tq.quantize_generator_params(_fake_generator_sd(1), 1)
    seen = []

    def spy(name):
        def site(x, w, *a, **kw):
            seen.append((name, w, kw.get("w_kmajor")))
            b, h, wd, _ = x.shape
            y = torch.zeros((b, h // 2, wd // 2, w.shape[1]), dtype=torch.int8)
            return y if name == "enc1" else (y, torch.ones((b, 1)))
        return site
    monkeypatch.setattr(tq.fe, "enc1_in_relu_requant", spy("enc1"))
    monkeypatch.setattr(tq.fe, "enc2_in_relu_requant", spy("enc2"))
    tq._fused_encoder(q, torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
    assert [(n, w is q[f"{n}_p"], wk is q[f"{n}_pk"]) for n, w, wk in seen] == \
        [("enc1", True, True), ("enc2", True, True)]


# ------------------------------------- the 4x4/s2 site's two wgmma passes


def _tile_at(tile, tiles_n, mblocks, bn):
    """tile_at of the header for one phase: channel tiles fastest, then pixel
    blocks, samples; returns (b, m0, n0, key)."""
    tn, r = tile % tiles_n, tile // tiles_n
    b = r // mblocks
    return b, (r % mblocks) * BM, tn * bn, b * tiles_n + tn


def _pix(m0, gh, gw, w_in, cin):
    """The producer's rows: each input pixel's offset (2*gy*W + 2*gx)*Cin and the
    in-map bits of rows 2gy - 1, 2gy .. 2gy + 1, 2gy + 2 (0-2), columns alike (3-5)."""
    m = m0 + np.arange(BM)
    gy, gx = m // gw, m % gw
    bits = ((gy > 0) | 2 | (gy < gh - 1) << 2 | (gx > 0) << 3 | 16 | (gx < gw - 1) << 5)
    return 2 * (gy * w_in + gx) * cin, bits.astype(np.int64), gy, gx


def _conv_tile_s2(x, wk, b, m0, n0, bn):
    """One tile's int64 accumulator [BM, bn] as the producer stages it: chunk jc
    of 128-byte K block kb holds K index 128 kb + 16 jc, its tap t = 4u + v and
    channel advanced by 128 bytes a block (two taps a block at Cin = 64); a row's
    chunk is zeros where the tap's in-map bits say so; each block is one
    product with the K-major weight rows."""
    _, h, w, cin = x.shape
    gh, gw = h // 2, w // 2
    off, bits, gy, gx = _pix(m0, gh, gw, w, cin)
    xf = x[b].reshape(-1).astype(np.float64)
    acc = np.zeros((BM, bn), np.float64)  # exact: |partial sums| < 2^53
    taps = [divmod(16 * jc, cin) for jc in range(8)]  # (tap, c0) of each chunk
    for kb in range(16 * cin // BK):
        a = np.zeros((BM, BK), np.float64)
        for jc, (t, c0) in enumerate(taps):
            dy, dx = (t >> 2) - 1, (t & 3) - 1  # Conv4x4s2Geom::tap
            rb = 0 if dy < 0 else (1 if dy < 2 else 2)
            cb = 3 if dx < 0 else (4 if dx < 2 else 5)
            inside = ((bits >> rb) & (bits >> cb) & 1).astype(bool)
            want = (2 * gy + dy >= 0) & (2 * gy + dy < h) & (2 * gx + dx >= 0) & (2 * gx + dx < w)
            assert np.array_equal(inside, want), "the in-map bits are the map's bounds"
            src = off[inside] + (dy * w + dx) * cin + c0
            a[inside, 16 * jc:16 * jc + 16] = xf[src[:, None] + np.arange(16)]
        acc += a @ wk[n0:n0 + bn, kb * BK:(kb + 1) * BK].T.astype(np.float64)
        for jc, (t, c0) in enumerate(taps):
            c0 += BK
            while c0 >= cin:
                c0, t = c0 - cin, t + 1
            taps[jc] = (t, c0)
    return acc.astype(np.int64)


def s2_pass_s(x, wk, cout, grid, seed=0):
    """Pass S: every CTA's run of tiles, in a shuffled order of CTAs; a CTA's
    shared block gathers its tiles (by warp_stats per tile, or at BN = 64 by
    the register partials folded every RegStats.TILES tiles) and leaves when
    the next tile is of another (sample, channel tile), or after its last.
    Returns stats [5, B, Cout]."""
    b_, h, w, _ = x.shape
    bn = tile_n(cout)
    tiles_n, mblocks = cout // bn, (h // 2) * (w // 2) // BM
    runs = _runs(b_ * mblocks * tiles_n, grid)
    stats = np.zeros((5, b_, cout), np.int64)
    for cta in np.random.default_rng(seed).permutation(len(runs)):
        block = np.zeros((5, bn), np.int64)
        reg = RegStats(bn)
        for tile in runs[cta]:
            b, m0, n0, key = _tile_at(tile, tiles_n, mblocks, bn)
            acc = _conv_tile_s2(x, wk, b, m0, n0, bn)
            if bn == 64:
                reg.add(acc)
            else:
                _merge(block, _tile_stats(acc))
            nxt = tile + 1
            leaves = nxt >= runs[cta].stop or _tile_at(nxt, tiles_n, mblocks, bn)[3] != key
            if bn == 64:
                reg.tiles += 1
                if leaves or reg.tiles == RegStats.TILES:
                    reg.fold(block)
            if leaves:
                dst = stats[:, b, n0:n0 + bn]
                dst[[0, 1, 4]] += block[[0, 1, 4]]
                dst[2], dst[3] = np.minimum(dst[2], block[2]), np.maximum(dst[3], block[3])
                block[:] = 0
    return stats


def s2_pass_q(x, wk, stats, cout, grid, seed=1):
    """Pass Q: every CTA's run of tiles, the requant rebuilt when the key
    changes; each tile's values through the folded map, staged per warp (16
    rows, lane (g, q) writes columns 8j + 2q, +1 of rows g and g + 8) and read
    back as 16-byte chunks to their output pixels (row m of the grid is output
    pixel m); the tile (pixel 0, channel 0) of a sample writes its inverse
    scale. Returns (int8 [B, H/2, W/2, Cout], scale [B, 1])."""
    b_, h, w, _ = x.shape
    bn = tile_n(cout)
    n_out = (h // 2) * (w // 2)
    tiles_n, mblocks = cout // bn, n_out // BM
    runs = _runs(b_ * mblocks * tiles_n, grid)
    out = np.full((b_, n_out, cout), -1000, np.int32)  # -1000: not written
    scale = np.full((b_, 1), np.nan, F32)
    lane = np.arange(32)
    g, qd = lane // 4, lane % 4
    chunks = bn // 16
    for cta in np.random.default_rng(seed).permutation(len(runs)):
        held = None
        for tile in runs[cta]:
            b, m0, n0, key = _tile_at(tile, tiles_n, mblocks, bn)
            if key != held:
                amax, a2, d2 = _load_requant(stats, b, n0, bn, n_out, "int32")
                held = key
            t = _through(_conv_tile_s2(x, wk, b, m0, n0, bn), "int32") * a2 + d2
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
                    dst = out[b, m0 + 16 * wi + rr, n0 + 16 * ch:n0 + 16 * ch + 16]
                    assert (dst == -1000).all(), "written once"
                    dst[:] = staging[rr, 16 * ch:16 * ch + 16]
            if m0 == 0 and n0 == 0:
                scale[b] = amax / F32(127) if amax > 0 else F32(1)
    return out.reshape(b_, h // 2, w // 2, cout), scale


# (W, H) of the input with (H/2)*(W/2) % 128 == 0: W = 48 puts tile edges
# inside output rows; Cin = 64 puts two taps in a K block; Cout 256, 128, 64
# are the three channel tiles. On 5 CTAs; on one CTA, a 64 x 80 input gives a
# run of 20 tiles per sample, past the 16 that RegStats holds at BN = 64.
S2_SCHEDULE = [(w, h, cin, cout, 5)
               for w, h in ((32, 32), (48, 32), (64, 16))
               for cin in (64, 128) for cout in (64, 128, 256)]
S2_SCHEDULE += [(64, 80, 64, 64, 1), (64, 80, 128, 256, 1)]


@pytest.mark.parametrize("w,h,cin,cout,grid", S2_SCHEDULE)
def test_conv4x4s2_two_passes_equal_the_plain_site_to_the_bit(w, h, cin, cout, grid):
    b = 2
    rng = np.random.default_rng(w * 1000 + h + cin + cout)
    x = rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)
    w_p = fe.pack_conv4x4(torch.from_numpy(_conv4x4_weights(cin, cout, seed=w + h)))
    wk = fe.pack_conv4x4_kmajor(w_p).numpy()
    stats = s2_pass_s(x, wk, cout, grid=grid)
    y = fe.conv4x4s2_i64(torch.from_numpy(x), w_p)  # [B, H/2, W/2, Cout]
    np.testing.assert_array_equal(stats[0], y.sum(dim=(1, 2)).numpy())
    hi, lo = tq.fc.sumsq_words(y)
    np.testing.assert_array_equal(stats[4].astype(object) * 2 ** 32 + stats[1].astype(object),
                                  hi.numpy().astype(object) * 2 ** 32 + lo.numpy())
    np.testing.assert_array_equal(stats[2], y.amin(dim=(1, 2)).clamp(max=0).numpy())
    np.testing.assert_array_equal(stats[3], y.amax(dim=(1, 2)).clamp(min=0).numpy())
    got_q, got_s = s2_pass_q(x, wk, stats, cout, grid=grid)
    want_q, want_s = fe.enc2_in_relu_requant_plain(torch.from_numpy(x), w_p)
    np.testing.assert_array_equal(got_q, want_q.numpy().astype(np.int32))
    np.testing.assert_array_equal(got_s.view(np.int32), want_s.numpy().view(np.int32))


# -------------------- enc1's four-phase form: its weights, its callers


def _i2c_blocks(seed, cin=64, cout=128):
    """Four distinct phase blocks [4 * 16*Cin, Cout], each ``pack_conv4x4`` of a
    kernel of its own (``pack_enc1_im2col`` makes four equal ones)."""
    rng = np.random.default_rng(seed)
    return torch.cat([fe.pack_conv4x4(torch.from_numpy(
        rng.integers(-127, 128, (4, 4, cin, cout), dtype=np.int8))) for _ in range(4)])


def test_pack_enc1_im2col_kmajor_is_the_per_block_transpose_of_jax_packing():
    """Block q of [4 * Cout, 1024] is the transpose of rows q*1024 .. of JAX's
    ``pack_enc1_im2col``; distinct blocks stay apart."""
    w1 = _conv4x4_weights(64, 128, seed=4)
    jp = np.array(jfe.pack_enc1_im2col(w1))
    got = fe.pack_enc1_im2col_kmajor(fe.pack_enc1_im2col(torch.from_numpy(w1)))
    assert got.dtype == torch.int8 and got.is_contiguous() and tuple(got.shape) == (512, 1024)
    assert fe.enc1_im2col_kmajor_shape(torch.from_numpy(jp)) == (512, 1024)
    slab = _i2c_blocks(5)
    got4 = fe.pack_enc1_im2col_kmajor(slab).numpy()
    for q in range(4):
        np.testing.assert_array_equal(got.numpy()[128 * q:128 * (q + 1)],
                                      jp[1024 * q:1024 * (q + 1)].T)
        np.testing.assert_array_equal(got4[128 * q:128 * (q + 1)],
                                      slab.numpy()[1024 * q:1024 * (q + 1)].T)
    with pytest.raises(ValueError, match="4 \\* 16\\*Cin, Cout"):
        fe.pack_enc1_im2col_kmajor(torch.zeros((1000, 128), dtype=torch.int8))


def test_im2col_site_with_and_without_the_kmajor_copy_agree():
    x = torch.from_numpy(np.random.default_rng(6).integers(-127, 128, (2, 32, 64, 64),
                                                           dtype=np.int8))
    w = _i2c_blocks(6)
    got = fe.enc1_in_relu_requant_im2col(x, w, w_kmajor=fe.pack_enc1_im2col_kmajor(w))
    assert torch.equal(got, fe.enc1_in_relu_requant_im2col(x, w))
    assert torch.equal(got, fe.enc1_in_relu_requant_im2col_plain(x, w))


def test_im2col_site_rejects_a_wrong_kmajor_copy():
    x = torch.zeros((1, 32, 64, 64), dtype=torch.int8)
    w = _i2c_blocks(7)
    wk = fe.pack_enc1_im2col_kmajor(w)
    for bad in (w, wk.to(torch.int16), wk[:128], wk.reshape(4, 128, 1024), wk.reshape(-1)):
        with pytest.raises(ValueError, match="w_kmajor"):
            fe.enc1_in_relu_requant_im2col(x, w, w_kmajor=bad)


def test_quantize_generator_params_stores_the_im2col_kmajor_copy(monkeypatch):
    assert "enc1_i2c_pk" not in tq.quantize_generator_params(_fake_generator_sd(1), 1)
    monkeypatch.setenv("MSIG_ENC1_IM2COL", "1")
    q = tq.quantize_generator_params(_fake_generator_sd(1), 1)
    assert tuple(q["enc1_i2c_p"].shape) == (4096, 128)
    assert torch.equal(q["enc1_i2c_pk"], fe.pack_enc1_im2col_kmajor(q["enc1_i2c_p"]))
    assert q["enc1_i2c_pk"].is_contiguous() and tuple(q["enc1_i2c_pk"].shape) == (512, 1024)


def test_encoder_hands_the_im2col_site_its_kmajor_copy(monkeypatch):
    monkeypatch.setenv("MSIG_ENC1_IM2COL", "1")
    q = tq.quantize_generator_params(_fake_generator_sd(1), 1)
    seen = []

    def site(x, w, *a, **kw):
        seen.append((w is q["enc1_i2c_p"], kw.get("w_kmajor") is q["enc1_i2c_pk"]))
        b, h, wd, _ = x.shape
        return torch.zeros((b, h // 2, wd // 2, 128), dtype=torch.int8)
    monkeypatch.setattr(tq.fe, "enc1_in_relu_requant_im2col", site)
    monkeypatch.setattr(tq.fe, "enc1_in_relu_requant", None)  # not called under the flag
    tq._fused_encoder(q, torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
    assert seen == [(True, True)]


# ----------------------------------- enc1's four-phase form: the two passes

I2C_BN = 128  # conv_i8_wgmma.cuh::enc1_phases_i8: one channel tile of 128 for every Cout
I2C_KS = 2    # kSubBlocks of a phased geometry: two 128-byte K blocks a stage


def _pix4(m0, gh, gw, w_in, cin):
    """The producer's rows at stride 4: each grid pixel's input offset
    (4*gy*W + 4*gx)*Cin and the in-map bits of rows 4gy - 1 (bit 0),
    4gy .. 4gy + 3 (bit 1, always), 4gy + 4 (bit 2), columns alike (3-5)."""
    m = m0 + np.arange(BM)
    gy, gx = m // gw, m % gw
    bits = ((gy > 0) | 2 | (gy < gh - 1) << 2 | (gx > 0) << 3 | 16 | (gx < gw - 1) << 5)
    return 4 * (gy * w_in + gx) * cin, bits.astype(np.int64), gy, gx


def _conv_tile_phase(x, wk, b, q, m0, n0, bn):
    """One tile of phase q: the int64 accumulator [BM, bn] as the producer stages
    it, I2C_KS K blocks a stage; chunk jc of K block kb holds K index 128 kb +
    16 jc, tap t = 4u + v read at (4gy + 2qy + u - 1, 4gx + 2qx + v - 1)
    (Enc1PhaseGeom::tap), zeros where the in-map bits say so; each block is a
    product with rows q*Cout + n0 .. of the K-major blocks [4 * Cout, K]."""
    _, h, w, cin = x.shape
    gh, gw, cout = h // 4, w // 4, wk.shape[0] // 4
    off, bits, gy, gx = _pix4(m0, gh, gw, w, cin)
    xf = x[b].reshape(-1).astype(np.float64)
    acc = np.zeros((BM, bn), np.float64)  # exact: |partial sums| < 2^53
    taps = [divmod(16 * jc, cin) for jc in range(8)]  # (tap, c0) of each chunk
    for ks in range(16 * cin // (I2C_KS * BK)):
        for sub in range(I2C_KS):
            kb = I2C_KS * ks + sub
            a = np.zeros((BM, BK), np.float64)
            for jc, (t, c0) in enumerate(taps):
                dy, dx = 2 * (q >> 1) + (t >> 2) - 1, 2 * (q & 1) + (t & 3) - 1
                rb = 0 if dy < 0 else (1 if dy < 4 else 2)
                cb = 3 if dx < 0 else (4 if dx < 4 else 5)
                inside = ((bits >> rb) & (bits >> cb) & 1).astype(bool)
                want = ((4 * gy + dy >= 0) & (4 * gy + dy < h) & (4 * gx + dx >= 0)
                        & (4 * gx + dx < w))
                assert np.array_equal(inside, want), "the in-map bits are the map's bounds"
                src = off[inside] + (dy * w + dx) * cin + c0
                a[inside, 16 * jc:16 * jc + 16] = xf[src[:, None] + np.arange(16)]
            rows = wk[q * cout + n0:q * cout + n0 + bn, kb * BK:(kb + 1) * BK]
            acc += a @ rows.T.astype(np.float64)
            for jc, (t, c0) in enumerate(taps):
                c0 += BK
                while c0 >= cin:
                    c0, t = c0 - cin, t + 1
                taps[jc] = (t, c0)
    return acc.astype(np.int64)


def i2c_pass_s(x, wk, grid, seed=0):
    """Pass S over the four-phase walk: channel tiles fastest, then the four
    phases of a pixel block, pixel blocks, samples, a contiguous run a CTA
    (CTAs in a shuffled order); a CTA's shared block leaves when the next tile
    is of another (sample, channel tile), or after its last. [5, B, Cout]."""
    b_, h, w, _ = x.shape
    cout = wk.shape[0] // 4
    tiles_n, mblocks = cout // I2C_BN, (h // 4) * (w // 4) // BM
    runs = _runs(b_ * 4 * mblocks * tiles_n, grid)
    stats = np.zeros((5, b_, cout), np.int64)
    seen = np.zeros((b_, 4, mblocks, tiles_n), np.int64)
    for cta in np.random.default_rng(seed).permutation(len(runs)):
        block = np.zeros((5, I2C_BN), np.int64)
        for tile in runs[cta]:
            b, q, m0, n0, key = _tile_at_phased(tile, tiles_n, mblocks, I2C_BN)
            seen[b, q, m0 // BM, n0 // I2C_BN] += 1
            _merge(block, _tile_stats(_conv_tile_phase(x, wk, b, q, m0, n0, I2C_BN)))
            nxt = tile + 1
            if nxt >= runs[cta].stop or _tile_at_phased(nxt, tiles_n, mblocks, I2C_BN)[4] != key:
                dst = stats[:, b, n0:n0 + I2C_BN]
                dst[[0, 1, 4]] += block[[0, 1, 4]]
                dst[2], dst[3] = np.minimum(dst[2], block[2]), np.maximum(dst[3], block[3])
                block[:] = 0
    assert (seen == 1).all(), "every tile once"
    return stats


def i2c_pass_q(x, wk, stats, grid, seed=1):
    """Pass Q over the same walk: the requant rebuilt where the key changes
    (n_out = 4 * GHW outputs a channel), staged per warp and written as
    16-byte chunks at out_pixel(q, gy, gx, GW) of the [H/2, W/2] map; the
    tile (q 0, pixel 0, channel 0) of a sample writes its inverse scale.
    Returns (int8 [B, H/2, W/2, Cout], scale [B, 1])."""
    b_, h, w, _ = x.shape
    cout = wk.shape[0] // 4
    gw, ghw = w // 4, (h // 4) * (w // 4)
    tiles_n, mblocks = cout // I2C_BN, ghw // BM
    runs = _runs(b_ * 4 * mblocks * tiles_n, grid)
    out = np.full((b_, 4 * ghw, cout), -1000, np.int32)  # -1000: not written
    scale = np.full((b_, 1), np.nan, F32)
    lane = np.arange(32)
    g, qd = lane // 4, lane % 4
    chunks = I2C_BN // 16
    for cta in np.random.default_rng(seed).permutation(len(runs)):
        held = None
        for tile in runs[cta]:
            b, q, m0, n0, key = _tile_at_phased(tile, tiles_n, mblocks, I2C_BN)
            if key != held:
                amax, a2, d2 = _load_requant(stats, b, n0, I2C_BN, 4 * ghw, "int32")
                held = key
            t = _through(_conv_tile_phase(x, wk, b, q, m0, n0, I2C_BN), "int32") * a2 + d2
            qv = np.rint(np.clip(t, F32(0), F32(127))).astype(np.int32)
            for wi in range(WARPS):
                staging = np.full((16, I2C_BN + 16), -1000, np.int32)
                for j in range(I2C_BN // 8):
                    for hh in range(2):
                        for e in range(2):
                            staging[g + 8 * hh, 8 * j + 2 * qd + e] = \
                                qv[16 * wi + g + 8 * hh, 8 * j + 2 * qd + e]
                for i in range(16 * chunks):  # lane i % 32 reads chunk i
                    rr, ch = divmod(i, chunks)
                    m = m0 + 16 * wi + rr
                    dst = out[b, _out_pixel(q, m // gw, m % gw, gw), n0 + 16 * ch:n0 + 16 * ch + 16]
                    assert (dst == -1000).all(), "written once"
                    dst[:] = staging[rr, 16 * ch:16 * ch + 16]
            if q == 0 and m0 == 0 and n0 == 0:
                scale[b] = amax / F32(127) if amax > 0 else F32(1)
    assert (out != -1000).all(), "every output written"
    return out.reshape(b_, h // 2, w // 2, cout), scale


# (H, W) with (H/4)*(W/4) % 128 == 0: 32 x 64 is one pixel block a phase;
# 32 x 192 puts tile edges inside grid rows (GW = 48) and 64 x 32 is taller
# than wide; Cout 256 takes two channel tiles. On 5 CTAs (runs that start and
# end inside a pixel block's phases, and cross samples) and on one.
I2C_SCHEDULE = [(32, 64, 128, 5), (32, 192, 128, 5), (64, 32, 256, 5), (32, 192, 256, 1)]


@pytest.mark.parametrize("h,w,cout,grid", I2C_SCHEDULE)
def test_enc1_phase_two_passes_equal_the_plain_site_to_the_bit(h, w, cout, grid):
    """Four distinct phase blocks, Cin = 64 (two taps a K block)."""
    b = 2
    rng = np.random.default_rng(h * 1000 + w + cout)
    x = rng.integers(-127, 128, (b, h, w, 64), dtype=np.int8)
    w_i2c = _i2c_blocks(h + w + cout, cout=cout)
    wk = fe.pack_enc1_im2col_kmajor(w_i2c).numpy()
    stats = i2c_pass_s(x, wk, grid=grid)
    y = fe.conv4x4s2_phases_i64(torch.from_numpy(x), w_i2c)  # [B, H/2, W/2, Cout]
    np.testing.assert_array_equal(stats[0], y.sum(dim=(1, 2)).numpy())
    hi, lo = tq.fc.sumsq_words(y)
    np.testing.assert_array_equal(stats[4].astype(object) * 2 ** 32 + stats[1].astype(object),
                                  hi.numpy().astype(object) * 2 ** 32 + lo.numpy())
    np.testing.assert_array_equal(stats[2], y.amin(dim=(1, 2)).clamp(max=0).numpy())
    np.testing.assert_array_equal(stats[3], y.amax(dim=(1, 2)).clamp(min=0).numpy())
    got_q, got_s = i2c_pass_q(x, wk, stats, grid=grid)
    want_q = fe.enc1_in_relu_requant_im2col_plain(torch.from_numpy(x), w_i2c)
    np.testing.assert_array_equal(got_q, want_q.numpy().astype(np.int32))
    want_s = tq.fc.in_relu_requant_i64(y)[1]
    np.testing.assert_array_equal(got_s.view(np.int32), want_s.numpy().view(np.int32))
    # phase q's own block: the same passes on block 0 alone give another map
    wk0 = np.tile(wk[:cout], (4, 1))
    assert (i2c_pass_q(x, wk0, i2c_pass_s(x, wk0, grid), grid)[0] != got_q).mean() > 0.1


def test_enc_variants_tool_edits_apply_to_the_sources():
    """Every variant of ``tools/enc_variants_torch.py`` finds its text in the
    sources as often as it says, so the tool builds on the card."""
    import importlib.util

    from msig_tpu_torch.ops import _build
    spec = importlib.util.spec_from_file_location(
        "enc_variants_torch", _build.CSRC.parents[1] / "tools" / "enc_variants_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for site, variants in tool.VARIANTS.items():
        for name, edits in variants.items():
            texts = {f: (_build.CSRC / (f if f.endswith(".cuh") else f + ".cu")).read_text()
                     for f in (site, tool.HEADER)}
            for f, old, _, *times in edits:
                assert texts[f].count(old) == (times[0] if times else 1), (site, name, old)
    assert {site for site, _ in tool.ENTRIES.values()} <= set(tool.VARIANTS)


# ------------------------------------------------ enc0's two passes

TH, TW, PAD, HALO_W = 8, 16, 3, 22  # a tile of 8 x 16 pixels; its halo 14 x 22 words
HALO = (TH + 2 * PAD) * HALO_W      # 308
STEPS, CHUNKS, N, WG = 7, 14, 256, 128  # K steps, 16-byte chunks of K, a unit's pixels, threads


def _swizzled(rows, k_bytes, row, kb):
    """Byte kb of K of row ``row`` in two 128-byte swizzle atoms of ``rows`` rows
    (chunk c of a row at chunk c ^ (row % 8)), as wgmma reads a K-major operand."""
    a, b = divmod(kb, 128)
    return a * rows * 128 + row * 128 + (((b >> 4) ^ (row & 7)) << 4) + (b & 15)


def _a_operand(w_packed):
    """The weights as the kernel lays them out once per CTA, read back as wgmma
    reads them: [64 channels, 224 K bytes], K byte 4T + e channel e of tap slot
    T (zero for e = 3 and the 7 pad slots)."""
    w = w_packed.numpy()
    smem = np.full(2 * 64 * 128, 99, np.int8)
    for i in range(2 * 64 * 128):
        a, n, kb = i // 8192, (i % 8192) // 128, i % 128
        t, e = (128 * a + kb) >> 2, kb & 3
        smem[a * 8192 + n * 128 + (((kb >> 4) ^ (n & 7)) << 4) + (kb & 15)] = \
            w[t * 3 + e, n] if t < 49 and e < 3 else 0
    got = np.array([[smem[_swizzled(64, 256, n, k)] for k in range(32 * STEPS)] for n in range(64)])
    for k in range(32 * STEPS):
        t, e = divmod(k, 4)
        np.testing.assert_array_equal(got[:, k], w[t * 3 + e] if t < 49 and e < 3 else 0)
    return got


def _halo(img, b, oy0, ox0):
    """enc0_halo_word over a tile's 14 x 22 halo: the reflected pixel's channels
    recentred (x ^ 0x80 read as int8) and a zero byte; [308, 4] int8."""
    _, h, w, _ = img.shape
    i = np.arange(HALO)
    iy = oy0 - PAD + i // HALO_W
    ix = ox0 - PAD + i % HALO_W
    iy = np.where(iy < 0, -iy, np.where(iy >= h, 2 * h - 2 - iy, iy))
    ix = np.where(ix < 0, -ix, np.where(ix >= w, 2 * w - 2 - ix, ix))
    words = np.zeros((HALO, 4), np.int8)
    words[:, :3] = (img[b, iy, ix] ^ 0x80).view(np.int8)
    return words


def _im2col(halos):
    """A unit's im2col rows as the kernel stores them and wgmma reads them back:
    thread t builds row t (pixel t of the first tile) and row 128 + t (of the
    second), chunk c holding slots 4c .. 4c + 3 from the halo at the row's pixel
    plus (T / 7) * 22 + T % 7 (zero for the pad slots). Returns [256, 224]."""
    smem = np.zeros(2 * N * 128, np.int8)
    for s, halo in enumerate(halos):
        for t in range(WG):
            src = (t // TW) * HALO_W + t % TW
            for c in range(CHUNKS):
                for e in range(4):
                    slot = 4 * c + e
                    word = halo[src + (slot // 7) * HALO_W + slot % 7] if slot < 49 else np.zeros(4)
                    for byte in range(4):
                        smem[_swizzled(N, 256, 128 * s + t, 16 * c + 4 * e + byte)] = word[byte]
    return np.array([[smem[_swizzled(N, 256, p, k)] for k in range(32 * STEPS)] for p in range(N)])


def _units(b_, h, w, grid):
    """Each CTA's units: pairs of consecutive tiles of its run (the second
    absent at an odd run's end), warpgroup wg taking units wg, wg + 2, ..."""
    per_sample = (h // TH) * (w // TW)
    runs = _runs(b_ * per_sample, grid)
    return per_sample, [[list(r[2 * u:2 * u + 2]) for u in range((len(r) + 1) // 2)] for r in runs]


def _origin(tile, per_sample, w):
    b, r = divmod(tile, per_sample)
    return b, (r // (w // TW)) * TH, (r % (w // TW)) * TW


def _unit_acc(img, a_op, tiles, per_sample, w):
    """A unit's int64 accumulator D^T [64 channels, 256 pixels] = W X^T."""
    halos = [_halo(img, *_origin(t, per_sample, w)) for t in tiles]
    return a_op.astype(np.int64) @ _im2col(halos).astype(np.int64).T


def _lanes():
    """Thread (warp, lane (g, t4)) of a warpgroup: its channels 16 warp + g + 8h
    [4, 32, 2] and pixel columns 8j + 2 t4 + e [4, 32, 32, 2] of acc."""
    lane = np.arange(32)
    g, t4 = lane // 4, lane % 4
    ch = 16 * np.arange(4)[:, None, None] + g[None, :, None] + 8 * np.arange(2)[None, None, :]
    px = 8 * np.arange(32)[None, :, None] + 2 * t4[:, None, None] + np.arange(2)[None, None, :]
    return ch, np.broadcast_to(px, (4, 32, 32, 2))


def enc0_pass_s(img, a_op, grid, seed=0):
    """Pass S: each thread keeps, per half unit (tile) and channel, the sum, the
    sum of squares in one unsigned 64-bit word, the zero-masked min and max of
    its 32 pixel columns over its warpgroup's units of a sample; at a change of
    sample (or the end) the 4 lanes of a channel fold and the sum of squares
    goes into the block as its low and high words."""
    b_, h, w, _ = img.shape
    per_sample, cta_units = _units(b_, h, w, grid)
    stats = np.zeros((5, b_, 64), np.int64)
    seen = np.zeros((b_, h, w, 64), np.int64)
    ch, px = _lanes()

    def flush(part, b):
        s, q, mn, mx = part  # [4 warps, 32 lanes, 2 channels]
        assert (q < 2 ** 64).all(), "a thread's sum of squares fits its word"
        q4 = q.reshape(4, 8, 4, 2).sum(axis=2)  # the 4 lanes (t4) of one g
        assert (q4 < 2 ** 64).all()
        c = ch.reshape(4, 8, 4, 2)[:, :, 0].reshape(-1)
        np.add.at(stats[0, b], c, s.reshape(4, 8, 4, 2).sum(axis=2).reshape(-1).astype(np.int64))
        np.add.at(stats[1, b], c, (q4 & 0xFFFFFFFF).reshape(-1).astype(np.int64))
        np.add.at(stats[4, b], c, (q4 >> 32).reshape(-1).astype(np.int64))
        np.minimum.at(stats[2, b], c, mn.reshape(4, 8, 4, 2).min(axis=2).reshape(-1))
        np.maximum.at(stats[3, b], c, mx.reshape(4, 8, 4, 2).max(axis=2).reshape(-1))

    def fresh():
        return [np.zeros((4, 32, 2), object), np.zeros((4, 32, 2), object),
                np.zeros((4, 32, 2), np.int64), np.zeros((4, 32, 2), np.int64)]

    for cta in np.random.default_rng(seed).permutation(len(cta_units)):
        for wg in range(2):
            held, part = [None, None], [fresh(), fresh()]
            for tiles in cta_units[cta][wg::2]:
                for s, tile in enumerate(tiles):
                    b = _origin(tile, per_sample, w)[0]
                    if b != held[s]:
                        if held[s] is not None:
                            flush(part[s], held[s])
                        held[s], part[s] = b, fresh()
                acc = _unit_acc(img, a_op, tiles, per_sample, w)
                for s, tile in enumerate(tiles):
                    b, oy0, ox0 = _origin(tile, per_sample, w)
                    cols = px[..., 16 * s:16 * s + 16, :].reshape(4, 32, 32)  # its 32 columns
                    v = acc[ch[:, :, :, None], cols[:, :, None, :]]  # [4, 32, 2, 32]
                    part[s][0] += v.sum(axis=-1)
                    part[s][1] += (v.astype(object) ** 2).sum(axis=-1)
                    part[s][2] = np.minimum(part[s][2], v.min(axis=-1))
                    part[s][3] = np.maximum(part[s][3], v.max(axis=-1))
                    pp = cols - 128 * s
                    np.add.at(seen, (b, oy0 + pp[:, :, None, :] // TW, ox0 + pp[:, :, None, :] % TW,
                                     ch[:, :, :, None]), 1)
            for s in range(2):
                if held[s] is not None:
                    flush(part[s], held[s])
    assert (seen == 1).all(), "each output is added once"
    return stats


def enc0_pass_q(img, a_op, stats, grid, stage, seed=1):
    """Pass Q: the requant rebuilt per half unit at each change of sample; each
    value through the staging type and the folded map into the staged tile at
    pixel * 80 + channel; thread t's chunk i = t + 128k (row p = i / 4, chunk i %
    4) goes to its pixel's 16 channels."""
    b_, h, w, _ = img.shape
    per_sample, cta_units = _units(b_, h, w, grid)
    out = np.full((b_, h, w, 64), -1000, np.int32)
    ch, px = _lanes()
    for cta in np.random.default_rng(seed).permutation(len(cta_units)):
        for wg in range(2):
            held, aff = [None, None], [None, None]
            for tiles in cta_units[cta][wg::2]:
                for s, tile in enumerate(tiles):
                    b = _origin(tile, per_sample, w)[0]
                    if b != held[s]:
                        _, a2, d2 = _load_requant(stats, b, 0, 64, h * w, stage)
                        held[s], aff[s] = b, (a2, d2)
                acc = _unit_acc(img, a_op, tiles, per_sample, w)
                stg = np.full((N, 80), -1000, np.int32)
                for s in range(len(tiles)):
                    cols = px[..., 16 * s:16 * s + 16, :].reshape(4, 32, 32)
                    a2, d2 = (x[ch][:, :, :, None] for x in aff[s])
                    v = _through(acc[ch[:, :, :, None], cols[:, :, None, :]], stage)
                    q = np.rint(np.clip(v * a2 + d2, F32(0), F32(127))).astype(np.int32)
                    dst = (cols[:, :, None, :], ch[:, :, :, None])
                    assert (stg[dst] == -1000).all(), "staged once"
                    stg[dst] = q
                for k in range(N * 4 // WG):
                    for t in range(WG):
                        i = t + k * WG
                        p, c = i >> 2, i & 3
                        if p // 128 >= len(tiles):
                            continue
                        b, oy0, ox0 = _origin(tiles[p // 128], per_sample, w)
                        pp = p % 128
                        dst = out[b, oy0 + pp // TW, ox0 + pp % TW, 16 * c:16 * c + 16]
                        assert (dst == -1000).all(), "written once"
                        dst[:] = stg[p, 16 * c:16 * c + 16]
    return out


# [B, H, W] on a grid of CTAs: H % 8 == 0, W % 16 == 0; 24 x 48 reflects along
# both edges of tiles inside the map, runs of 9 tiles a sample on 4 CTAs cross
# samples inside a unit and end on a unit of one tile; 8 x 16 is one tile,
# reflected on all sides; 16 x 32 on 3 CTAs leaves a warpgroup idle.
@pytest.mark.parametrize("b,h,w,grid", [(2, 24, 48, 4), (3, 8, 16, 2), (1, 16, 32, 3)])
def test_enc0_two_passes_equal_the_plain_site_to_the_bit(b, h, w, grid):
    rng = np.random.default_rng(h * 100 + w)
    img = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    w_packed = fe.pack_enc0(torch.from_numpy(rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8)))
    a_op = _a_operand(w_packed)
    y = fe.enc0_i64(torch.from_numpy(img), w_packed)  # [B, H, W, 64]
    per_sample, cta_units = _units(b, h, w, grid)
    for units in cta_units:  # the slot layout and the im2col rows against the plain conv
        for tiles in units:
            acc = _unit_acc(img, a_op, tiles, per_sample, w)
            for s, tile in enumerate(tiles):
                tb, oy0, ox0 = _origin(tile, per_sample, w)
                np.testing.assert_array_equal(acc[:, 128 * s:128 * s + 128].T.reshape(TH, TW, 64),
                                              y[tb, oy0:oy0 + TH, ox0:ox0 + TW].numpy())
    stats = enc0_pass_s(img, a_op, grid)
    np.testing.assert_array_equal(stats[0], y.sum(dim=(1, 2)).numpy())
    hi, lo = tq.fc.sumsq_words(y)
    np.testing.assert_array_equal(stats[4].astype(object) * 2 ** 32 + stats[1].astype(object),
                                  hi.numpy().astype(object) * 2 ** 32 + lo.numpy())
    np.testing.assert_array_equal(stats[2], y.amin(dim=(1, 2)).clamp(max=0).numpy())
    np.testing.assert_array_equal(stats[3], y.amax(dim=(1, 2)).clamp(min=0).numpy())
    for stage in ("int32", "fp16"):
        got = enc0_pass_q(img, a_op, stats, grid, stage)
        want = fe.enc0_hbm_plain(torch.from_numpy(img), w_packed, stage=stage)
        np.testing.assert_array_equal(got, want.numpy().astype(np.int32))


def test_enc0_wrapper_rejects_an_unknown_stage():
    with pytest.raises(ValueError, match="stage"):
        fe._enc0_kernel(torch.zeros((1, 8, 16, 3), dtype=torch.uint8),
                        torch.zeros((160, 64), dtype=torch.int8), 1e-5, "bf16")
