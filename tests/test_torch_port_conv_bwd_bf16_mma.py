"""The bf16 conv backward core's schedule, emulated in numpy on the CPU.

``csrc/conv3x3_bwd_bf16.cuh`` (the bf16 entries of rows 23-24) computes dx
and dW as two implicit GEMMs on ``mma.sync.m16n8k16`` bf16, its operands
staged in shared memory by 16-byte ``cp.async`` copies (zero-filled at the
halo and past the ragged pixel edge) and read into fragments by
``ldmatrix`` (plain for dx's A, ``.trans`` for dW's A and both B tiles). No
compiler or card runs here, so this file replays that schedule: each
thread's copies into a stage of the padded shared-memory tile, each lane's
``ldmatrix`` address, the eight-row matrices it gathers and the fragment
each lane receives (PTX: plain, lane l holds row l / 4, columns 2 (l % 4)
and + 1; ``.trans``, the same of the transpose), the m16n8k16 fragment
layouts, the accumulator's layout in the epilogue, the ReLU on bf16 bits, dW's
chunks and dx's K parts added in order. The tile constants are read from the
header. The emulated dx (bf16) and dW (fp32) are held against the plain
version, ``conv3x3_bwd_plain``, at small maps: a whole tile, a ragged pixel
edge, a K longer than a tile takes (Co = 384: two dx parts) and more pixels
than a dW chunk (two chunks).

Bars: the products of bf16 values are exact in fp32, so the two differ only
by the order of the fp32 sums: dW within rtol 1e-4 and atol 1e-5 x max|plain|
(the port's fp32 bars), dx at most 1 bf16 step apart on under 1% of its
elements (a sum near a rounding boundary may round the other way).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from msig_tpu_torch.ops import conv3x3_vjp as cv

CSRC = Path(cv.__file__).resolve().parent.parent / "csrc"


def header_constants(path: Path, known=None) -> dict:
    """The ``constexpr int`` names of a header, evaluated in order (C++'s / on
    ints as //)."""
    out = dict(known or {})
    for line in path.read_text().splitlines():
        m = re.match(r"\s*constexpr int (.*);", line)
        if not m:
            continue
        for decl in m.group(1).split(","):
            name, expr = (s.strip() for s in decl.split("=", 1))
            out[name] = int(eval(expr.replace("/", "//"), {}, dict(out)))  # noqa: S307
    return out


K32 = header_constants(CSRC / "conv3x3_bwd.cuh")
K = header_constants(CSRC / "conv3x3_bwd_bf16.cuh", {"kMaxK": K32["kMaxK"]})
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4


def to_bf16(a: np.ndarray) -> np.ndarray:
    """fp32 -> bf16 (round to nearest even) -> fp32, as the kernels store bf16."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def relu2(v: np.ndarray) -> np.ndarray:
    """``relu2`` of the header on bf16 values held as fp32: the sign bit set -> +0."""
    bits = torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(torch.bfloat16).view(torch.int16)
    return np.where(bits.numpy() < 0, np.float32(0), v).astype(np.float32)


def ldmatrix_x4(smem: np.ndarray, addr: np.ndarray, trans: bool) -> np.ndarray:
    """Registers [4, 32 lanes, 2 halves] of ``ldmatrix...x4[.trans].b16`` with
    lane l giving the element address of row l % 8 of matrix l / 8."""
    m = smem[addr[:, None] + np.arange(8)].reshape(4, 8, 8)  # [matrix, row, column]
    if trans:
        return np.stack([m[:, 2 * T, G], m[:, 2 * T + 1, G]], axis=-1)
    return np.stack([m[:, G, 2 * T], m[:, G, 2 * T + 1]], axis=-1)


def mma_m16n8k16(acc: np.ndarray, a: np.ndarray, b: np.ndarray) -> None:
    """acc [..., 32, 4] += A B of the fragments a [..., 4, 32, 2] and b [..., 2, 32, 2]
    (PTX's m16n8k16 layouts); the products are exact, the sum into fp32."""
    A = np.zeros(a.shape[:-3] + (16, 16))
    B = np.zeros(b.shape[:-3] + (16, 8))
    for i, (r, c) in enumerate(((G, 2 * T), (G + 8, 2 * T), (G, 2 * T + 8), (G + 8, 2 * T + 8))):
        for j in range(2):
            A[..., r, c + j] = a[..., i, :, j]
    for i, r in enumerate((2 * T, 2 * T + 8)):
        for j in range(2):
            B[..., r + j, G] = b[..., i, :, j]
    d = A @ B
    acc += np.stack([d[..., G, 2 * T], d[..., G, 2 * T + 1], d[..., G + 8, 2 * T],
                     d[..., G + 8, 2 * T + 1]], axis=-1).astype(np.float32)


def mma_stage(smem, a_off, b_off, acc, kmk: bool, relu: bool) -> None:
    """``mma_stage``: the four warps' fragments of one stage and their products;
    acc [warps, kMI, kNI, 32, 4]. Each warp's kMI x kNI products of a k16 step
    run as one batch."""
    r8, q1, q2 = LANE & 7, (LANE >> 3) & 1, LANE >> 4
    for warp in range(4):
        wm, wn = warp // K["kWarpsN"], warp % K["kWarpsN"]
        for kk in range(0, K["kBK"], 16):
            b = np.zeros((K["kNI"], 2, 32, 2), np.float32)
            for nj in range(0, K["kNI"], 2):
                r = ldmatrix_x4(smem, b_off + (kk + r8 + 8 * q1) * K["kLdKN"] + wn * K["kWN"]
                                + nj * 8 + 8 * q2, trans=True)
                b[nj], b[nj + 1] = r[0:2], r[2:4]
            a = np.zeros((K["kMI"], 4, 32, 2), np.float32)
            for mi in range(K["kMI"]):
                m0 = wm * K["kWM"] + mi * 16
                if kmk:
                    a[mi] = ldmatrix_x4(smem, a_off + (m0 + (LANE & 15)) * K["kLdMK"] + kk
                                        + 8 * q2, trans=False)
                else:
                    a[mi] = ldmatrix_x4(smem, a_off + (kk + r8 + 8 * q2) * K["kLdKN"] + m0
                                        + 8 * q1, trans=True)
                    if relu:
                        a[mi] = relu2(a[mi])
            mma_m16n8k16(acc[warp], a[:, None], b[None, :])


def gemm_ring(nk: int, load, kmk: bool, relu: bool) -> np.ndarray:
    smem = np.full(K["kStages"] * K["kStageElems"], np.nan, np.float32)
    acc = np.zeros((4, K["kMI"], K["kNI"], 32, 4), np.float32)
    for kb in range(nk):
        stage = (kb % K["kStages"]) * K["kStageElems"]
        load(smem, stage, kb)
        mma_stage(smem, stage, stage + K["kAElems"], acc, kmk, relu)
    return acc


def copy16(smem, dst: np.ndarray, src: np.ndarray, ok: np.ndarray, flat: np.ndarray) -> None:
    """cp.async of 16 bytes (8 bf16) per (dst, src); zero-filled where not ok."""
    j = np.arange(8)
    vals = np.where(ok[..., None], flat[np.where(ok, src, 0)[..., None] + j], 0)
    smem[dst[..., None] + j] = vals


def epilogue_rows(acc, m0, n0):
    """(row, column, value) of every accumulator value of a CTA tile."""
    rows, cols, vals = [], [], []
    for warp in range(4):
        wm, wn = warp // K["kWarpsN"], warp % K["kWarpsN"]
        for mi in range(K["kMI"]):
            for ni in range(K["kNI"]):
                for r in range(4):
                    rows.append(m0 + wm * K["kWM"] + mi * 16 + G + 8 * (r // 2))
                    cols.append(n0 + wn * K["kWN"] + ni * 8 + 2 * T + (r % 2))
                    vals.append(acc[warp, mi, ni, :, r])
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def emulate(x: np.ndarray, w: np.ndarray, dy: np.ndarray, relu: bool):
    """(dx bf16-valued fp32, dW fp32) by the core's schedule; x, w, dy bf16-valued."""
    b, h, wd, c = x.shape
    co = w.shape[-1]
    n_pix, hw = b * h * wd, h * wd
    bm, bn, bk = K["kBM"], K["kBN"], K["kBK"]
    max_k = K["kMaxK"]
    wt = w.reshape(9, c, co).transpose(0, 2, 1).reshape(-1)  # [9, Co, C], the wrapper's _taps_t
    xf, dyf = x.reshape(-1), dy.reshape(-1)
    tid = np.arange(K["kThreads"])

    # dx: tiles (split, m, n); K = 9 Co in parts of at most kMaxK
    splits = -(-9 * co // max_k)
    nkb = 9 * co // bk
    per = -(-nkb // splits)
    part = np.zeros((splits, n_pix, c), np.float32)
    a_row, a_col = tid >> 3, (tid & 7) * 8
    rows_a = a_row[:, None] + K["kRowsMK"] * np.arange(K["kItMK"])
    b_row, b_col = tid >> 4, (tid & 15) * 8
    rows_b = b_row[:, None] + K["kRowsKN"] * np.arange(K["kItKN"])
    for split in range(splits):
        kb0 = split * per
        for m0 in range(0, n_pix, bm):
            pix = m0 + rows_a
            ah = np.where(pix < n_pix, pix % hw // wd, -4)
            aw = pix % hw % wd
            for n0 in range(0, c, bn):
                def load(smem, stage, kb_in, n0=n0, ah=ah, aw=aw, m0=m0, kb0=kb0):
                    kb = kb0 + kb_in
                    tap, co0 = kb // (co // bk), kb % (co // bk) * bk
                    sh, sw = 1 - tap // 3, 1 - tap % 3
                    hh, ww = ah + sh, aw + sw
                    ok = (hh >= 0) & (hh < h) & (ww >= 0) & (ww < wd)
                    src = (m0 + rows_a + sh * wd + sw) * co + co0 + a_col[:, None]
                    copy16(smem, stage + rows_a * K["kLdMK"] + a_col[:, None], src, ok, dyf)
                    src = (kb * bk + rows_b) * c + n0 + b_col[:, None]
                    copy16(smem, stage + K["kAElems"] + rows_b * K["kLdKN"] + b_col[:, None], src,
                           np.ones_like(src, bool), wt)
                acc = gemm_ring(min(nkb, kb0 + per) - kb0, load, kmk=True, relu=False)
                r, cc, v = epilogue_rows(acc, m0, n0)
                keep = r < n_pix  # the ragged edge
                part[split, r[keep], cc[keep]] = v[keep]
    dx = part[0]
    for s in range(1, splits):  # in order
        dx = dx + part[s]
    if relu:
        dx = np.where(x.reshape(n_pix, c) > 0, dx, 0).astype(np.float32)

    # dW: tiles (chunk z, m, n) over [9 C, Co]; K = the chunk's pixels
    chunks = -(-n_pix // max_k)
    dw_part = np.zeros((chunks, 9 * c, co), np.float32)
    k_row, col = tid >> 4, (tid & 15) * 8
    rows_k = k_row[:, None] + K["kRowsKN"] * np.arange(K["kItKN"])
    for z in range(chunks):
        p_begin, p_end = z * max_k, min(n_pix, (z + 1) * max_k)
        for m0 in range(0, 9 * c, bm):
            tap, ci0 = m0 // c, m0 % c
            di, dj = tap // 3 - 1, tap % 3 - 1
            for n0 in range(0, co, bn):
                def load(smem, stage, kb, n0=n0, ci0=ci0, di=di, dj=dj, p_begin=p_begin,
                         p_end=p_end):
                    p = p_begin + kb * bk + rows_k
                    inside = p < p_end
                    hh, ww = p % hw // wd + di, p % hw % wd + dj
                    ok = inside & (hh >= 0) & (hh < h) & (ww >= 0) & (ww < wd)
                    src = (p + di * wd + dj) * c + ci0 + col[:, None]
                    copy16(smem, stage + rows_k * K["kLdKN"] + col[:, None], src, ok, xf)
                    src = p * co + n0 + col[:, None]
                    copy16(smem, stage + K["kAElems"] + rows_k * K["kLdKN"] + col[:, None], src,
                           inside, dyf)
                acc = gemm_ring(-(-(p_end - p_begin) // bk), load, kmk=False, relu=relu)
                r, cc, v = epilogue_rows(acc, m0, n0)
                dw_part[z, r, cc] = v
    dw = dw_part[0]
    for z in range(1, chunks):  # in chunk order
        dw = dw + dw_part[z]
    return to_bf16(dx).reshape(x.shape), dw.reshape(3, 3, c, co)


def _bf16_inputs(b, side, c, co, seed):
    rng = np.random.default_rng(seed)
    x = to_bf16(rng.normal(0, 1, (b, side, side, c)))
    w = to_bf16(rng.uniform(-1, 1, (3, 3, c, co)) / np.sqrt(9 * c))
    dy = to_bf16(rng.normal(0, 1, (b, side, side, co)))
    return x, w, dy


def test_header_constants_are_the_designs():
    """The tile, ring and pitches the file's emulation reads (and the docs state)."""
    assert (K["kBM"], K["kBN"], K["kBK"], K["kStages"], K["kThreads"]) == (128, 128, 64, 3, 128)
    assert (K["kLdMK"] * 2, K["kLdKN"] * 2, K["kSmemBytes"]) == (144, 272, 107520)
    assert (K["kBM"], K["kBN"], K["kMaxK"]) == (K32["kBM"], K32["kBN"], cv._MAX_K)


@pytest.mark.parametrize("pitch", ["kLdMK", "kLdKN"])
def test_ldmatrix_rows_fall_in_distinct_bank_groups(pitch):
    """The 8 row addresses of an 8x8 matrix (16 bytes each) cover the 32 banks once."""
    groups = {(r * K[pitch] * 2 // 16) % 8 for r in range(8)}
    assert groups == set(range(8))


def test_relu2_zeroes_every_value_with_its_sign_bit_set():
    v = np.array([1.5, -1.5, 0.0, -0.0, 3e-40, -3e-40, 2.0**-100], np.float32)
    got = relu2(to_bf16(v))
    assert np.array_equal(got, np.maximum(to_bf16(v), 0)) and not np.signbit(got).any()


@pytest.mark.parametrize("trans", [False, True])
def test_ldmatrix_model_gives_an_mma_its_operands(trans):
    """One k16 step of the model: A [16, 16] staged [m][k] and read plain, or
    staged [k][m] and read transposed, times B [16, 8] staged [k][n] and read
    transposed, equals A @ B."""
    rng = np.random.default_rng(int(trans))
    a, bmat = to_bf16(rng.normal(size=(16, 16))), to_bf16(rng.normal(size=(16, 8)))
    ld = 24
    smem = np.zeros(2 * 16 * ld, np.float32)
    if trans:
        smem[:16 * ld].reshape(16, ld)[:, :16] = a.T
        addr = (LANE & 7) + 8 * (LANE >> 4)  # rows k; m offset 8 q1 below
        frag = ldmatrix_x4(smem, addr * ld + 8 * ((LANE >> 3) & 1), trans=True)
    else:
        smem[:16 * ld].reshape(16, ld)[:, :16] = a
        frag = ldmatrix_x4(smem, (LANE & 15) * ld + 8 * (LANE >> 4), trans=False)
    smem[16 * ld:].reshape(16, ld)[:, :8] = bmat
    b = ldmatrix_x4(smem, 16 * ld + ((LANE & 7) + 8 * ((LANE >> 3) & 1)) * ld + 8 * (LANE >> 4),
                    trans=True)[0:2]
    acc = np.zeros((32, 4), np.float32)
    mma_m16n8k16(acc, frag, b)
    d = a.astype(np.float64) @ bmat
    want = np.stack([d[G, 2 * T], d[G, 2 * T + 1], d[G + 8, 2 * T], d[G + 8, 2 * T + 1]], -1)
    np.testing.assert_allclose(acc, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("b,side,c,co", [
    (1, 8, 128, 128),    # one dx tile (half of it past the pixel edge), one stage of dW
    (1, 10, 128, 256),   # 100 pixels: a ragged edge in both products, two channel tiles of dW
    (1, 4, 128, 384),    # 9 Co > kMaxK: two dx parts added in order
])
def test_emulated_core_matches_the_plain_version(b, side, c, co, relu):
    x, w, dy = _bf16_inputs(b, side, c, co, seed=side + co)
    dx, dw = emulate(x, w, dy, relu)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    dx_p, dw_p = cv.conv3x3_bwd_plain(t(x), t(w), t(dy), relu_input=relu)
    np.testing.assert_allclose(dw, dw_p.numpy(), rtol=1e-4, atol=1e-5 * float(dw_p.abs().max()))
    steps = np.abs(t(dx).view(torch.int16).int().numpy() - dx_p.view(torch.int16).int().numpy())
    assert steps.max() <= 1 and (steps > 0).mean() < 0.01
    if relu:
        assert not dx[x <= 0].any()


def test_emulated_dw_adds_two_pixel_chunks():
    """2,401 pixels: dW's K in a chunk of kMaxK (2,304) pixels and one of 97."""
    x, w, dy = _bf16_inputs(1, 49, 128, 128, seed=49)
    assert -(-49 * 49 // K["kMaxK"]) == 2
    _, dw = emulate(x, w, dy, relu=True)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    _, dw_p = cv.conv3x3_bwd_plain(t(x), t(w), t(dy), relu_input=True)
    np.testing.assert_allclose(dw, dw_p.numpy(), rtol=1e-4, atol=1e-5 * float(dw_p.abs().max()))
