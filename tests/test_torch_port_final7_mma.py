"""The decoder's final conv (row 14) on mma.sync tensor cores, on the CPU: the
packed weights, the wrapper's ``w_packed`` keyword, the served chain's copy,
and the kernel's schedule emulated in numpy.

``csrc/final7_tanh_u8.cu`` runs the reflect-padded int8 7x7 conv 64 -> 3 as
``mma.sync.m16n8k32`` products with kx folded into N (columns co * 7 + kx,
21 of 24), reading the weights in the order of ``fd.pack_final7_weights``,
then adds each output's seven partials in shared memory. The kernel cannot
run here. Its sums are exact integers, so what can go wrong is the schedule:
the output tile each CTA takes, the reflected halo it stages, the lane order
its weights are rearranged into,
the fragments ``ldmatrix.x4`` hands each lane, the rows that send halo row
j = p + ky against the weights of kernel row ky into the accumulator of
output row p, which partial columns each lane stores and which A tile owns
the overlapping halo columns, and the fold's sum over kx. ``emulate``
follows the kernel's index arithmetic, builds each mma's operands from the
lanes' registers by the PTX fragment layouts, and is held to the bit against
``fd.final7_tanh_u8_plain``, which tests/test_torch_port_dec.py holds against
the JAX kernel and the card holds the kernel to (tests/test_torch_port_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch
from test_torch_port_convt_wgmma import _fake_generator_sd

from msig_tpu_torch.infer import quantized as tq
from msig_tpu_torch.ops import fused_dec_int8 as fd

# csrc/final7_tanh_u8.cu: output tile, halo, staged pixel pitch, n8 tiles,
# A tiles (halo columns 0, 16, 22), output rows a warp, warps, partial pitch.
TW, TH, PAD, K, PITCH = 32, 16, 3, 7, 80
HALO_W, HALO_H = TW + 2 * PAD, TH + 2 * PAD
N_TILES, COLS, COL_TILES, WARP_ROWS, P_PITCH = 3, 21, 3, 4, 25
WARPS = COL_TILES * (TH // WARP_ROWS)
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4


def _inputs(b, h, w, seed=3):
    rng = np.random.default_rng(seed)
    t = dict(x=rng.integers(0, 128, (b, h, w, 64), dtype=np.int8),
             w=rng.integers(-127, 128, (3, 64, 7, 7), dtype=np.int8),
             ws=rng.uniform(1e-4, 2e-4, 3).astype(np.float32),
             bias=rng.uniform(-0.3, 0.3, 3).astype(np.float32),
             inv_s=rng.uniform(0.02, 0.05, (b, 1)).astype(np.float32))
    return {k: torch.from_numpy(v) for k, v in t.items()}


def _reflect(i, n):
    return np.where(i < 0, -i, np.where(i >= n, 2 * n - 2 - i, i))


def _words(u8):
    """Little-endian 32-bit words of a byte array's last axis (length 4k)."""
    powers = 256 ** np.arange(4, dtype=np.uint32)
    return u8.reshape(*u8.shape[:-1], -1, 4).astype(np.uint32) @ powers


def _bytes(words):
    """int8 values of 32-bit words, low byte first: [..., n] -> [..., n, 4]."""
    shifted = words[..., None] >> (8 * np.arange(4, dtype=np.uint32))
    return (shifted & 255).astype(np.uint8).view(np.int8)


# PTX fragment layouts of mma.m16n8k32 .s8 (lane L, g = L // 4, t = L % 4):
# A register r holds row g + 8 (r & 1), columns 16 (r >> 1) + 4t .. +3;
# B register r holds column g, rows (K) 16 r + 4t .. +3;
# D register r holds row g + 8 (r >> 1), column 2t + (r & 1).
def _a_matrix(regs):
    """regs [..., 32 lanes, 4] uint32 -> A [..., 16, 32] int64."""
    a = np.zeros(regs.shape[:-2] + (16, 32), np.int64)
    vals = _bytes(regs).astype(np.int64)  # [..., 32, 4 regs, 4 bytes]
    for r in range(4):
        for e in range(4):
            a[..., G + 8 * (r & 1), 16 * (r >> 1) + 4 * T + e] = vals[..., :, r, e]
    return a


def _b_matrix(regs):
    """regs [..., 32 lanes, 2] uint32 -> B [..., 32 (K), 8 (N)] int64."""
    bm = np.zeros(regs.shape[:-2] + (32, 8), np.int64)
    vals = _bytes(regs).astype(np.int64)
    for r in range(2):
        for e in range(4):
            bm[..., 16 * r + 4 * T + e, G] = vals[..., :, r, e]
    return bm


def _d_registers(d):
    """D [..., 16, 8] -> lane registers [..., 32, 4]."""
    return np.stack([d[..., G + 8 * (r >> 1), 2 * T + (r & 1)] for r in range(4)], axis=-1)


def stage_weights(wpk):
    """The kernel's rearranged copy in shared memory, as 32-bit words: chunk i
    of 16 bytes (block i // 16, column (i // 2) % 8, half-chunk i % 2) lands
    at words (i // 16) * 64 + ((i // 2) % 8) * 8 + (i % 2) + 2k, k = 0..3."""
    chunks = _words(wpk.numpy().reshape(-1, 16).view(np.uint8))  # [672, 4]
    ws = np.zeros(chunks.shape[0] * 4, np.uint32)
    i = np.arange(chunks.shape[0])
    base = (i >> 4) * 64 + ((i >> 1) & 7) * 8 + (i & 1)
    for k in range(4):
        ws[base + 2 * k] = chunks[:, k]
    return ws


def tile_origin(t, h, w):
    """``Tile``: output tile t (the CTA's blockIdx.x) of a [B, H, W] map,
    row-major: (b, oy0, ox0)."""
    tw, th = w // TW, h // TH
    return t // (tw * th), (t // tw % th) * TH, (t % tw) * TW


def stage_halo(x, b, oy0, ox0):
    """``copy_halo``: the tile's halo, pixel p = hr * 38 + hc at byte p * 80,
    its 64 channels from the reflected source pixel."""
    h, w = x.shape[1:3]
    smem = np.zeros(HALO_H * HALO_W * PITCH, np.uint8)
    p = np.arange(HALO_H * HALO_W)
    iy = _reflect(oy0 - PAD + p // HALO_W, h)
    ix = _reflect(ox0 - PAD + p % HALO_W, w)
    smem.reshape(-1, PITCH)[:, :64] = x[b].numpy().view(np.uint8)[iy, ix]
    return smem


def _ldmatrix_x4(smem, addr):
    """ldmatrix.x4 over addr [..., 32]: lane 8m + r gives the address of row r
    of matrix m; lane L receives word L % 4 of row L // 4 of each matrix m as
    its register m. Returns [..., 32 lanes, 4]."""
    words = _words(smem[addr[..., None] + np.arange(16)])  # [..., 32, 4]
    return np.stack([words[..., 8 * m + G, T] for m in range(4)], axis=-1)


def _tile_partials(smem, ws):
    """One tile's products and the partials they leave: P [16 rows, 38 halo
    columns, 21 columns co * 7 + kx], -1 where nothing was written."""
    warp = np.arange(WARPS)
    ctile, r0 = warp % COL_TILES, (warp // COL_TILES) * WARP_ROWS
    ct = np.where(ctile == COL_TILES - 1, HALO_W - 16, ctile * 16)
    a_off = ((r0 * HALO_W + ct)[:, None] + (LANE & 15)) * PITCH + 16 * (LANE >> 4)  # [12, 32]
    acc = np.zeros((WARPS, WARP_ROWS, N_TILES, 16, 8), np.int64)
    for ky in range(K):
        for half in range(2):
            blocks = (ky * 2 + half) * N_TILES + np.arange(N_TILES)
            bmat = _b_matrix(ws[blocks[:, None, None] * 64 + 2 * LANE[:, None] + np.arange(2)])
            for p in range(WARP_ROWS):
                a = _a_matrix(_ldmatrix_x4(smem, a_off + (p + ky) * HALO_W * PITCH + 32 * half))
                acc[:, p] += a[:, None] @ bmat[None]
    regs = _d_registers(acc)  # [12, rows, n tiles, 32, 4]
    part = np.full((TH, HALO_W, P_PITCH), -1, np.int64)
    for wi in range(WARPS):
        for r in range(4):
            i, col = G + 8 * (r >> 1), 2 * T + (r & 1)
            for n in range(N_TILES):
                keep = (n * 8 + col < COLS) & ((ctile[wi] < COL_TILES - 1) | (ct[wi] + i >= 32))
                for p in range(WARP_ROWS):
                    part[r0[wi] + p, ct[wi] + i[keep], n * 8 + col[keep]] = regs[wi, p, n, keep, r]
    return part[:, :, :COLS]


def emulate(x, wpk, wscale, bias, inv_s):
    """The kernel, CTA by CTA (output tile blockIdx.x) and warp by warp:
    uint8 [B, H, W, 3]."""
    b_, h, w, _ = x.shape
    ws = stage_weights(wpk)
    acc = np.full((b_, h, w, 3), -1, np.int64)
    for cta in range(b_ * (h // TH) * (w // TW)):
        b, oy0, ox0 = tile_origin(cta, h, w)
        part = _tile_partials(stage_halo(x, b, oy0, ox0), ws)
        idx = np.arange(TH * TW * 3)
        co, xx, row = idx % 3, idx // 3 % TW, idx // (3 * TW)
        terms = np.stack([part[row, xx + kx, co * K + kx] for kx in range(K)])
        assert (terms != -1).all(), "every partial an output adds was written"
        assert (acc[b, oy0 + row, ox0 + xx, co] == -1).all(), "each output written once"
        acc[b, oy0 + row, ox0 + xx, co] = terms.sum(axis=0)
    assert (acc != -1).all(), "every output was written"
    # the epilogue's fp32 operations, in the kernel's order (as the plain version's)
    sv = wscale * inv_s.reshape(-1, 1, 1, 1)
    y = torch.tanh(torch.from_numpy(acc).to(torch.float32) * sv + bias)
    return torch.clamp(torch.round((y + 1.0) * 127.5), 0, 255).to(torch.uint8)


def test_pack_final7_weights_folds_kx_into_the_columns():
    w = _inputs(1, 16, 32)["w"]
    pk = fd.pack_final7_weights(w)
    assert pk.dtype == torch.int8 and pk.is_contiguous()
    assert tuple(pk.shape) == fd.FINAL7_PACKED_SHAPE and pk.numel() == 10752
    wn, cols = w.numpy(), pk.numpy().reshape(7, 2, 24, 32)
    for ky in range(7):
        for half in range(2):
            for co in range(3):
                for kx in range(7):
                    np.testing.assert_array_equal(cols[ky, half, co * 7 + kx],
                                                  wn[co, 32 * half:32 * half + 32, ky, kx])
    assert not cols[:, :, 21:].any(), "columns 21-23 are zero"
    with pytest.raises(ValueError, match="3, 64, 7, 7"):
        fd.pack_final7_weights(w[:, :32].contiguous())
    with pytest.raises(ValueError, match="int8"):
        fd.pack_final7_weights(w.to(torch.int16))


def test_staged_weights_give_each_lane_its_b_fragment():
    """Word 2L + r of block (ky, half, n8 tile) is register r of lane L's B
    fragment: channels 32 half + 16 r + 4t .. +3 of column 8 * tile + g."""
    w = _inputs(1, 16, 32, seed=5)["w"]
    ws = stage_weights(fd.pack_final7_weights(w))
    for ky, half, n in ((0, 0, 0), (3, 1, 2), (6, 1, 1)):
        blk = (ky * 2 + half) * N_TILES + n
        bmat = _b_matrix(ws[blk * 64 + 2 * LANE[:, None] + np.arange(2)])
        want = np.zeros((32, 8), np.int64)
        for g in range(8):
            col = n * 8 + g
            if col < COLS:
                want[:, g] = w.numpy()[col // 7, 32 * half:32 * half + 32, ky, col % 7]
        np.testing.assert_array_equal(bmat, want)


# [1, 16, 32]: one tile, whose halo touches all four reflected edges;
# [2, 32, 64]: 2 x 2 tiles a sample, inner edges read across tiles;
# [1, 48, 32]: a map taller than it is wide, three tiles down.
@pytest.mark.parametrize("b,h,w", [(1, 16, 32), (2, 32, 64), (1, 48, 32)])
def test_emulated_schedule_equals_the_plain_version_to_the_bit(b, h, w):
    t = _inputs(b, h, w, seed=h + w)
    got = emulate(t["x"], fd.pack_final7_weights(t["w"]), t["ws"], t["bias"], t["inv_s"])
    want = fd.final7_tanh_u8_plain(t["x"], t["w"], t["ws"], t["bias"], t["inv_s"])
    assert got.dtype == torch.uint8 and got.shape == (b, h, w, 3)
    assert len(np.unique(want.numpy())) > 50  # the data spans the tanh
    assert torch.equal(got, want)


def test_tiles_cover_the_map_once():
    for b, h, w in ((1, 16, 32), (2, 32, 64), (8, 256, 256)):
        seen = {tile_origin(t, h, w) for t in range(b * (h // TH) * (w // TW))}
        assert seen == {(i, y, x) for i in range(b) for y in range(0, h, TH)
                        for x in range(0, w, TW)}


def test_emulated_halo_is_reflection_pad():
    """The staged halo of a corner CTA equals ReflectionPad2d(3) of the map."""
    t = _inputs(1, 16, 32, seed=8)
    smem = stage_halo(t["x"], 0, 0, 0).reshape(HALO_H, HALO_W, PITCH)
    xp = torch.nn.functional.pad(t["x"].permute(0, 3, 1, 2).float(), (3, 3, 3, 3),
                                 mode="reflect").permute(0, 2, 3, 1).to(torch.int8)
    np.testing.assert_array_equal(smem[:, :, :64].view(np.int8), xp[0].numpy())
    assert not smem[:, :, 64:].any()


def test_wrapper_checks_w_packed_on_the_cpu_path():
    t = _inputs(1, 16, 32)
    args = (t["x"], t["w"], t["ws"], t["bias"], t["inv_s"])
    want = fd.final7_tanh_u8(*args)
    got = fd.final7_tanh_u8(*args, w_packed=fd.pack_final7_weights(t["w"]))
    assert torch.equal(got, want)
    pk = fd.pack_final7_weights(t["w"])
    for bad in (pk.reshape(42, 8, 32), pk[:, :, :, :3].contiguous(), pk.to(torch.int16)):
        with pytest.raises(ValueError, match="w_packed"):
            fd.final7_tanh_u8(*args, w_packed=bad)
    assert fd.LAUNCHES[fd.FINAL7_SITE] == 0  # CPU tensors run the plain version


def test_quantized_params_carry_the_packed_copy_and_the_decoder_passes_it(monkeypatch):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(0, 0.05, (3, 64, 7, 7)).astype(np.float32))
    q = {"out_kernel_i8": torch.clamp(torch.round(w / w.abs().amax() * 127), -127,
                                      127).to(torch.int8)}
    pk = fd.pack_final7_weights(q["out_kernel_i8"])
    q.update(out_kernel_pk=pk, out_wscale=torch.ones(3), out_bias=torch.zeros(3),
             up0_ps=None, up1_ps=None)
    seen = []
    monkeypatch.setattr(tq.fc, "convt4x4s2_in_relu_requant_ps",
                        lambda x, *a, **k: (torch.zeros((1, 32, 32, 128), dtype=torch.int8), None))
    monkeypatch.setattr(tq.fd, "up1_s2d16", lambda x, *a, **k: (
        torch.zeros((1, 64, 64, 64), dtype=torch.int8), torch.ones((1, 1))))
    monkeypatch.setattr(tq.fd, "final7_tanh_u8", lambda *a, **k: seen.append(k) or "image")
    assert tq._fused_decoder(q, torch.zeros((1, 16, 16, 256), dtype=torch.int8),
                             torch.uint8) == "image"
    assert len(seen) == 1 and seen[0]["w_packed"] is pk


def test_quantize_generator_params_packs_the_final_conv():
    q = tq.quantize_generator_params(_fake_generator_sd(1), 1)
    assert torch.equal(q["out_kernel_pk"], fd.pack_final7_weights(q["out_kernel_i8"]))
    assert q["out_kernel_pk"].is_contiguous()
