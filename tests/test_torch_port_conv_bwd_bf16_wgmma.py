"""The bf16 conv backward core on wgmma, its schedule emulated in numpy on the CPU.

``csrc/conv3x3_bwd_bf16.cuh`` (the bf16 entries of rows 23-24) computes dx
and dW as two implicit GEMMs on ``wgmma.mma_async`` m64nBNk16 bf16 -> fp32
(BN = 256 where C and Co allow, else 128), both operands read from shared
memory by descriptor in the 128-byte swizzle: dx's A (dy rows) and B (the
HWIO taps as they are) K-major, dW's A (x rows) and B (dy rows) MN-major. A
producer fills a ring of stages: by TMA boxes of 4-D tensor maps (zeros
outside the map) where a 128-pixel tile is whole rows of one image or a part
of one row, else by the producer warpgroup's 16-byte ``cp.async`` copies
(zero-filled at the halo and past the ragged pixel edge). Each consumer
warpgroup zeroes the negative values of its half of dW's A in shared memory
before its products (the relu). Items (128 x BN tiles of dx and of each chunk
of dW's K) are dealt from a counter, the longer kind first, and dW's chunk
partials are added in chunk order.

No compiler or card runs here, so this file replays that schedule: each
producer thread's copies into the byte addresses of a stage, and the boxes a
TMA load writes (rows of 128 bytes in the box's order; the same bytes as the
copies, held here), the swizzle (16-byte chunk c of 128-byte row r at chunk
c ^ (r % 8)), the relu pass, the matrices each descriptor reads (CUTLASS's
canonical GMMA layouts: K-major ((8, n), 2) : ((8, SBO), 1) and MN-major
((8, n), (8, k)) : ((1, LBO), (8, SBO)) in 16-byte units, then the swizzle on
the byte address), the accumulator's layout in the epilogue, and the chunk
plan. The tile constants are read from the header. The emulated dx (bf16)
and dW (fp32) are held against the plain version, ``conv3x3_bwd_plain``, at
small maps: a whole tile, ragged pixel edges, a K of 9 * 384, maps loaded by
TMA and by copies, both tile widths, and more pixels than a dW chunk.

Bars: the products of bf16 values are exact in fp32, so the two differ only
by the order of the fp32 sums: dW within rtol 1e-4 and atol 1e-5 x max|plain|
(the port's fp32 bars), dx on under 1% of its elements, each at most 1 bf16
step apart (a sum near a rounding boundary may round the other way) or,
where the sum cancels to under 1e-3 x max|plain|, within 1e-3 x max|plain|.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from msig_tpu_torch.ops import conv3x3_vjp as cv

CSRC = Path(cv.__file__).resolve().parent.parent / "csrc"


def header_constants(path: Path) -> dict:
    """The ``constexpr int`` names at a header's namespace scope (unindented),
    evaluated in order (C++'s / on ints as //)."""
    out: dict = {}
    for line in path.read_text().splitlines():
        m = re.match(r"constexpr int (.*?);", line)
        if not m:
            continue
        for decl in m.group(1).split(","):
            name, expr = (s.strip() for s in decl.split("=", 1))
            out[name] = int(eval(expr.replace("/", "//"), {}, dict(out)))  # noqa: S307
    return out


K = header_constants(CSRC / "conv3x3_bwd_bf16.cuh")
BM, BK, TILE = K["kBM"], K["kBK"], K["kATile"]


def layout(bn: int) -> dict:
    """``Layout<BN>`` of the header: a stage (A, then B of bn rows or columns)
    and the ring of as many stages as fit, up to kMaxStages."""
    stage = TILE + bn * BK * 2
    fixed = K["kMaxStages"] * (3 * 8 + 4) + 2 * 4
    stages = min((K["kSmemLimit"] - 1024 - fixed) // stage, K["kMaxStages"])
    return dict(stage=stage, stages=stages, smem=stages * stage + fixed + 1024)
T = np.arange(128)  # the producer warpgroup's threads
LANE = np.arange(32)


def to_bf16(a: np.ndarray) -> np.ndarray:
    """fp32 -> bf16 (round to nearest even) -> fp32, as the kernels store bf16."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def relu2(v: np.ndarray) -> np.ndarray:
    """``relu2`` of the header on bf16 values held as fp32: the sign bit set -> +0."""
    bits = torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(torch.bfloat16).view(torch.int16)
    return np.where(bits.numpy() < 0, np.float32(0), v).astype(np.float32)


def swizzle(addr):
    """The 128-byte swizzle on a byte address: bits 4-6 ^= bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


# ------------------------------------------------------------------ producer
# Destinations of thread t's chunks within a tile (Producer's dx_dst, dw_dst):
# a dx row i adds 2048 bytes, a dW row i 1024.
DX_DST = (T >> 3) * 128 + (((T & 7) ^ ((T >> 3) & 7)) << 4)
DW_DST = ((T & 15) >> 3) * 8192 + (T >> 4) * 128 + ((((T & 15) & 7) ^ ((T >> 4) & 7)) << 4)


def copy16(smem, dst_bytes, src_elems, ok, flat):
    """cp.async of 16 bytes (8 bf16) per destination; zero-filled where not ok.
    smem holds bf16 values as fp32, one per 2 bytes."""
    j = np.arange(8)
    vals = np.where(ok[..., None], flat[np.where(ok, src_elems, 0)[..., None] + j], 0)
    smem[(dst_bytes // 2)[..., None] + j] = vals


def dx_stage(smem, sa, g, it, kb, dy, w):
    """Producer.dx_item's copies of stage kb of a dx item into the stage at byte sa."""
    b, h, wd, c, co = g
    np_, hw = b * h * wd, h * wd
    i = np.arange(8)
    p = it["m0"] + (T >> 3)[:, None] + 16 * i
    r = p % hw
    ph, pw = r // wd, r % wd
    blocks = co // BK
    tp, co0 = kb // blocks, kb % blocks * BK
    sh, sw = 1 - tp // 3, 1 - tp % 3
    ok = (p < np_) & (ph + sh >= 0) & (ph + sh < h) & (pw + sw >= 0) & (pw + sw < wd)
    src = (p + sh * wd + sw) * co + co0 + 8 * (T & 7)[:, None]
    copy16(smem, sa + DX_DST[:, None] + 2048 * i, src, ok, dy.reshape(-1))
    ib = np.arange(it["bn"] // 16)
    n = it["n0"] + (T >> 3)[:, None] + 16 * ib
    src = (tp * c + n) * co + co0 + 8 * (T & 7)[:, None]
    copy16(smem, sa + TILE + DX_DST[:, None] + 2048 * ib, src, np.ones(src.shape, bool),
           w.reshape(-1))


def dw_stage(smem, sa, g, it, kb, x, dy):
    """Producer.dw_item's copies of stage kb of a dW item into the stage at byte sa."""
    b, h, wd, c, co = g
    hw = h * wd
    i = np.arange(8)
    tap = it["m0"] // c
    ci0, di, dj = it["m0"] % c, tap // 3 - 1, tap % 3 - 1
    p = it["p0"] + kb * BK + (T >> 4)[:, None] + 8 * i
    r = p % hw
    hh, ww = r // wd + di, r % wd + dj
    inside = p < it["p1"]
    ok = inside & (hh >= 0) & (hh < h) & (ww >= 0) & (ww < wd)
    j16 = (T & 15)[:, None]
    copy16(smem, sa + DW_DST[:, None] + 1024 * i, (p + di * wd + dj) * c + ci0 + 8 * j16, ok,
           x.reshape(-1))
    for hb in range(it["bn"] // 128):  # B: 128 co at a time, two 64-wide blocks 16 KB on
        copy16(smem, sa + TILE + 16384 * hb + DW_DST[:, None] + 1024 * i,
               p * co + it["n0"] + 128 * hb + 8 * j16, inside, dy.reshape(-1))


def tma_box(smem, dst, tensor, c0, coords, box):
    """A TMA load of a box of ``box`` = (64 channels, w, h) pixels of ``tensor``
    [B, H, W, C] at channel c0 and (w0, h0, b) = coords (signed; zeros outside),
    or of (64 columns, rows) of a 2-D tensor at (c0, row0): box row r (the
    box's pixels or rows in order) at 128 r bytes from dst, swizzled."""
    cols = c0 + np.arange(64)
    if tensor.ndim == 2:
        rows = coords[0] + np.arange(box[1])
        vals = tensor[rows[:, None], cols[None, :]]
    else:
        w0, h0, b = coords
        ww, hh = np.meshgrid(w0 + np.arange(box[1]), h0 + np.arange(box[2]))  # [h, w]
        ww, hh = ww.reshape(-1), hh.reshape(-1)
        inside = (ww >= 0) & (ww < tensor.shape[2]) & (hh >= 0) & (hh < tensor.shape[1])
        vals = np.where(inside[:, None],
                        tensor[b, np.clip(hh, 0, tensor.shape[1] - 1)[:, None],
                               np.clip(ww, 0, tensor.shape[2] - 1)[:, None], cols[None, :]], 0)
    r = np.arange(vals.shape[0])[:, None]
    addr = dst + r * 128 + 2 * np.arange(64)[None, :]
    smem[swizzle(addr) // 2] = vals


def dx_stage_tma(smem, sa, g, it, kb, dy, w):
    """Producer.dx_item's two boxes (TMA) of stage kb of a dx item."""
    b, h, wd, c, co = g
    tw = min(wd, BM)
    bi, r = divmod(it["m0"], h * wd)
    h0, w0 = divmod(r, wd)
    tp, co0 = kb // (co // BK), kb % (co // BK) * BK
    tma_box(smem, sa, dy, co0, (w0 + 1 - tp % 3, h0 + 1 - tp // 3, bi), (64, tw, BM // tw))
    tma_box(smem, sa + TILE, w.reshape(9 * c, co), co0, (tp * c + it["n0"],), (64, it["bn"]))


def dw_stage_tma(smem, sa, g, it, kb, x, dy):
    """Producer.dw_item's 2 + bn / 64 boxes (TMA) of stage kb of a dW item."""
    b, h, wd, c, co = g
    rw = min(wd, BK)
    tap = it["m0"] // c
    ci0, di, dj = it["m0"] % c, tap // 3 - 1, tap % 3 - 1
    bi, r = divmod(it["p0"] + kb * BK, h * wd)
    hh, ww = divmod(r, wd)
    for blk in range(2):
        tma_box(smem, sa + 8192 * blk, x, ci0 + 64 * blk, (ww + dj, hh + di, bi), (64, rw, BK // rw))
    for blk in range(it["bn"] // 64):
        tma_box(smem, sa + TILE + 8192 * blk, dy, it["n0"] + 64 * blk, (ww, hh, bi),
                (64, rw, BK // rw))


def relu_pass(smem, sa, cw):
    """consume's pass of warpgroup cw over its 8 KB half of dW's A (where the
    copies load it): thread ct's chunks ct + 128 i, i < 4."""
    q = sa + cw * 8192 + 16 * (np.arange(128)[:, None] + 128 * np.arange(4))
    idx = (q // 2)[..., None] + np.arange(8)
    smem[idx] = relu2(smem[idx])


def relu_warps_pass(smem, sa):
    """relu_warps' pass over the whole 16 KB of dW's A (by TMA): thread ht < 96
    takes chunks ht + 96 i below 1024."""
    q = [sa + 16 * c for ht in range(96) for c in range(ht, TILE // 16, 96)]
    idx = (np.array(q) // 2)[:, None] + np.arange(8)
    smem[idx] = relu2(smem[idx])


def dx_quad_stores(acc_rows):
    """The dx epilogue's regrouping within a row's 4 lanes: acc_rows [4 lanes,
    bn / 2 registers] of one row (register 4 j + e: column 8 j + 2 q + e, the
    row half h = 0) -> {column: value} as the lanes store them, 4 columns a
    lane a pair of groups, via the header's shuffle sources."""
    out = {}
    bn = acc_rows.shape[1] * 2
    for q in range(4):
        src = (2 * q) & 3
        for j in range(0, bn // 8, 2):
            grp = j if q < 2 else j + 1  # the group lanes src, src + 1 send
            vals = [acc_rows[src + k, 4 * grp + e] for k in range(2) for e in range(2)]
            for i, v in enumerate(vals):
                out[8 * j + 4 * q + i] = v
    return out


# ------------------------------------------------------------------ consumer


def desc_read(smem, start, lbo, sbo, rows, mn_major):
    """The [rows, 16] matrix (row = M or N index, column = k) that a 128-byte
    swizzle descriptor reads: K-major ((8, n), 2) : ((8, SBO), 1), MN-major
    ((8, n), (8, k)) : ((1, LBO), (8, SBO)), in 16-byte units (CUTLASS's
    make_gmma_desc), then the swizzle on the byte address."""
    m, k = np.arange(rows)[:, None], np.arange(16)[None, :]
    if mn_major:
        addr = start + (m // 64) * lbo + (m % 64) * 2 + (k % 8) * 128 + (k // 8) * sbo
    else:
        addr = start + (m // 8) * sbo + (m % 8) * 128 + (k // 8) * 16 + (k % 8) * 2
    return smem[swizzle(addr) // 2]


def consume_stage(smem, sa, acc, dw: bool, relu: bool, tma: bool):
    """The consumers' four k16 steps on the stage at byte sa (consume): each
    warpgroup cw reads its 64 rows of A at + 8192 cw, after the relu pass
    where the item is dW's and the input relu'd (the relu warps' by TMA, the
    warpgroup's own by copies); acc [2, 64, bn] fp32."""
    bn = acc.shape[-1]
    if dw and relu and tma:
        relu_warps_pass(smem, sa)
    for cw in range(2):
        if dw and relu and not tma:
            relu_pass(smem, sa, cw)
        for kk in range(BK // 16):
            if dw:
                a = desc_read(smem, sa + cw * 8192 + 2048 * kk, 8192, 1024, 64, True)
                bt = desc_read(smem, sa + TILE + 2048 * kk, 8192, 1024, bn, True)
            else:
                a = desc_read(smem, sa + cw * 8192 + 32 * kk, 16, 1024, 64, False)
                bt = desc_read(smem, sa + TILE + 32 * kk, 16, 1024, bn, False)
            acc[cw] += (a.astype(np.float64) @ bt.T.astype(np.float64)).astype(np.float32)


def fragment(acc):
    """(row, column, value) of every accumulator value, as a consumer thread
    holds it: warp w, lane l of warpgroup cw, register 4 j + 2 h + e = row
    64 cw + 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4) + e."""
    rows, cols, regs = [], [], []
    for cw in range(2):
        for warp in range(4):
            for j in range(acc.shape[-1] // 8):
                for h in range(2):
                    for e in range(2):
                        r = 64 * cw + 16 * warp + (LANE >> 2) + 8 * h
                        cc = 8 * j + 2 * (LANE & 3) + e
                        rows.append(r)
                        cols.append(cc)
                        regs.append(acc[cw, r - 64 * cw, cc])
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(regs)


# ------------------------------------------------------------------ the core


def item_at(item, plan, c, co):
    """item_at of the header: the kind dealt first holds tickets 0 ..."""
    bn = plan["bn"]
    first = item < (plan["n_dw"] if plan["dw_first"] else plan["n_dx"])
    dw = first == plan["dw_first"]
    j = item if first else item - (plan["n_dw"] if plan["dw_first"] else plan["n_dx"])
    if dw:
        z, r = divmod(j, plan["dw_tiles"])
        p0 = z * plan["chunk_px"]
        p1 = min(plan["np"], p0 + plan["chunk_px"])
        return dict(dw=True, bn=bn, z=z, m0=r // (co // bn) * BM, n0=r % (co // bn) * bn, p0=p0,
                    p1=p1, nk=-(-(p1 - p0) // BK))
    return dict(dw=False, bn=bn, z=0, m0=j // (c // bn) * BM, n0=j % (c // bn) * bn,
                nk=plan["dx_nk"])


def emulate(x, w, dy, relu: bool, tma=None):
    """(dx bf16-valued fp32, dW fp32) by the core's schedule on one CTA that
    takes every ticket in turn, the stages round the ring; x, w, dy
    bf16-valued. tma: load by TMA boxes or by copies (default: the plan's)."""
    b, h, wd, c = x.shape
    co = w.shape[-1]
    g = (b, h, wd, c, co)
    plan = cv.bf16_plan(b, h, wd, c, co)
    tma = plan["tma"] if tma is None else tma
    n_pix, bn, lay = plan["np"], plan["bn"], layout(plan["bn"])
    smem = np.full(lay["stages"] * lay["stage"] // 2, np.nan, np.float32)
    dx = np.zeros((n_pix, c), np.float32)
    part = np.zeros((plan["chunks"], 9 * c, co), np.float32)
    stage = 0
    for ticket in range(plan["n_dx"] + plan["n_dw"]):
        it = item_at(ticket, plan, c, co)
        acc = np.zeros((2, 64, bn), np.float32)
        for kb in range(it["nk"]):
            sa = stage * lay["stage"]
            if it["dw"]:
                (dw_stage_tma if tma else dw_stage)(smem, sa, g, it, kb, x, dy)
            else:
                (dx_stage_tma if tma else dx_stage)(smem, sa, g, it, kb, dy, w)
            consume_stage(smem, sa, acc, it["dw"], relu, tma)
            stage = (stage + 1) % lay["stages"]
        r, cc, v = fragment(acc)
        if it["dw"]:
            part[it["z"], it["m0"] + r, it["n0"] + cc] = v
        else:
            keep = it["m0"] + r < n_pix  # the ragged edge
            dx[it["m0"] + r[keep], it["n0"] + cc[keep]] = v[keep]
    if relu:  # relu'(x): exactly 0 where x <= 0
        dx = np.where(x.reshape(n_pix, c) > 0, dx, 0).astype(np.float32)
    dw = part[0]
    for z in range(1, plan["chunks"]):  # in chunk order
        dw = dw + part[z]
    return to_bf16(dx).reshape(x.shape), dw.reshape(3, 3, c, co)


def _bf16_inputs(b, side, c, co, seed):
    rng = np.random.default_rng(seed)
    x = to_bf16(rng.normal(0, 1, (b, side, side, c)))
    w = to_bf16(rng.uniform(-1, 1, (3, 3, c, co)) / np.sqrt(9 * c))
    dy = to_bf16(rng.normal(0, 1, (b, side, side, co)))
    return x, w, dy


def _hold(dx, dw, x, w, dy, relu):
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    dx_p, dw_p = cv.conv3x3_bwd_plain(t(x), t(w), t(dy), relu_input=relu)
    np.testing.assert_allclose(dw, dw_p.numpy(), rtol=1e-4, atol=1e-5 * float(dw_p.abs().max()))
    ordered = lambda v: np.where(v >= 0, v, -(v & 0x7FFF))  # noqa: E731  (+0 and -0 coincide)
    steps = np.abs(ordered(t(dx).view(torch.int16).int().numpy())
                   - ordered(dx_p.view(torch.int16).int().numpy()))
    small = np.abs(dx_p.float().numpy()) < 1e-3 * float(dx_p.float().abs().max())
    assert steps[~small].max() <= 1 and (steps > 0).mean() < 0.01
    assert (np.abs(dx - dx_p.float().numpy()) <= 1e-3 * float(dx_p.float().abs().max()))[small].all()
    if relu:
        assert not dx[x <= 0].any()


# --------------------------------------------------------------------- tests


def test_header_constants_are_the_designs():
    """The tile, rings and register budget the file's emulation reads (and the docs state)."""
    assert (BM, BK, K["kThreads"], K["kMaxStages"]) == (128, 64, 384, 7)
    assert (layout(256)["stages"], layout(128)["stages"]) == (4, 7)
    assert max(layout(256)["smem"], layout(128)["smem"]) <= K["kSmemLimit"] == 232448
    assert 128 * K["kProducerRegs"] + 256 * K["kConsumerRegs"] <= 168 * K["kThreads"]
    assert (cv._BF16_TILE, cv._BF16_BK) == (BM, BK)
    assert (cv._BF16_MAX_CHUNKS, cv._BF16_MAX_CHUNK_PX) == (K["kMaxChunks"], K["kMaxChunkPixels"])


@pytest.mark.parametrize("b,side,c,co,chunks,tma", [
    (8, 64, 256, 256, 7, True), (4, 64, 256, 256, 7, True), (64, 64, 256, 256, 54, True),
    (8, 128, 256, 256, 27, True), (4, 128, 256, 256, 14, True), (1, 24, 256, 256, 1, False),
    (1, 49, 128, 128, 4, False), (3, 8, 256, 256, 1, False), (1, 16, 128, 128, 1, True)])
def test_chunk_plan_from_the_shape(b, side, c, co, chunks, tma):
    """dW's K in whole 64-pixel stages, one chunk per 9 Co / 2 pixels, at most
    7 (at the trunk's width fewer dW items than the card's 132 SMs) unless a
    chunk would pass 4864 pixels, that cover the pixels once; the tile's
    columns 256 where C and Co allow; TMA where a 128-pixel tile is whole rows
    of one image (or part of one row); the partials a call writes (with the
    counter) are what ``scratch_floats`` gives, and at the trunk's [8, 64, 64,
    256] under half the 35 MB of the 15 chunks before."""
    p = cv.bf16_plan(b, side, side, c, co)
    n = b * side * side
    assert p["chunks"] == chunks and p["chunk_px"] % BK == 0 and p["tma"] == tma
    assert (p["chunks"] - 1) * p["chunk_px"] < n <= p["chunks"] * p["chunk_px"]
    assert p["chunk_px"] <= max(K["kMaxChunkPixels"], -(-n // K["kMaxChunks"]) + BK)
    assert p["bn"] == (256 if c % 256 == 0 and co % 256 == 0 else 128)
    assert p["n_dw"] == 9 * c // BM * (co // p["bn"]) * chunks
    if (c, co) == (256, 256) and chunks <= K["kMaxChunks"]:
        assert p["n_dw"] < 132  # the dW items, one an SM at most
    floats = cv.scratch_floats(b, side, side, c, co, torch.bfloat16)
    assert floats == (chunks * 9 * c * co if chunks > 1 else 0) + 1
    if (b, side) == (8, 64):
        assert (floats - 1) * 4 < 35e6 / 2


def _stage_rows(kind: str, bn: int):
    """Each producer thread's destinations in a stage: (A's, B's) byte offsets."""
    if kind == "dx":
        return (DX_DST[:, None] + 2048 * np.arange(8),
                TILE + DX_DST[:, None] + 2048 * np.arange(bn // 16))
    b = [TILE + 16384 * hb + DW_DST[:, None] + 1024 * np.arange(8) for hb in range(bn // 128)]
    return DW_DST[:, None] + 1024 * np.arange(8), np.concatenate(b, axis=1)


@pytest.mark.parametrize("bn", [128, 256])
@pytest.mark.parametrize("kind", ["dx", "dw"])
def test_a_stage_covers_each_tile_byte_once(kind, bn):
    """The 128 producer threads' 16-byte chunks fill the 16 KB A tile and the
    bn x 128-byte B tile of a stage exactly once."""
    a, b = _stage_rows(kind, bn)
    starts = np.sort(np.concatenate([a.reshape(-1), b.reshape(-1)]))
    np.testing.assert_array_equal(starts, np.arange(0, layout(bn)["stage"], 16))


@pytest.mark.parametrize("bn", [128, 256])
@pytest.mark.parametrize("kind", ["dx", "dw"])
def test_descriptors_read_the_operands_the_producer_wrote(kind, bn):
    """One stage with known operands: what each warpgroup's descriptors read
    (the model of the hardware layouts) is the operand the producer's
    addressing meant, for every k16 step: dx K-major (A [64 rows, k], B [n, k]),
    dW MN-major (A [ci, pixel], B [pixel, co])."""
    rng = np.random.default_rng(len(kind) + bn)
    smem = np.full(layout(bn)["stage"] // 2, np.nan, np.float32)
    a, bm = to_bf16(rng.normal(size=(BM, BK))), to_bf16(rng.normal(size=(bn, BK)))  # [m|n, k]
    da, db = _stage_rows(kind, bn)
    j = np.arange(8)
    if kind == "dx":  # row r of a tile: 64 K values; chunk t % 8 of rows t / 8 + 16 i
        jc = 8 * (T & 7)[:, None, None] + j
        rows_a = ((T >> 3)[:, None] + 16 * np.arange(8))[..., None]
        rows_b = ((T >> 3)[:, None] + 16 * np.arange(bn // 16))[..., None]
        smem[(da // 2)[..., None] + j] = a[rows_a, jc]
        smem[(db // 2)[..., None] + j] = bm[rows_b, jc]
    else:  # K row k of a tile: 64-wide blocks of M (or N); chunk t % 16 (+ 16 hb) of rows t / 16 + 8 i
        krow = ((T >> 4)[:, None] + 8 * np.arange(8))[..., None]
        smem[(da // 2)[..., None] + j] = a[8 * (T & 15)[:, None, None] + j, krow]
        cols = np.concatenate([np.broadcast_to(8 * (T & 15)[:, None] + 128 * hb, (128, 8))
                               for hb in range(bn // 128)], axis=1)[..., None] + j
        krow_b = np.concatenate([krow] * (bn // 128), axis=1)
        smem[(db // 2)[..., None] + j] = bm[cols, krow_b]
    for cw in range(2):
        for kk in range(BK // 16):
            if kind == "dx":
                ga = desc_read(smem, cw * 8192 + 32 * kk, 16, 1024, 64, False)
                gb = desc_read(smem, TILE + 32 * kk, 16, 1024, bn, False)
            else:
                ga = desc_read(smem, cw * 8192 + 2048 * kk, 8192, 1024, 64, True)
                gb = desc_read(smem, TILE + 2048 * kk, 8192, 1024, bn, True)
            np.testing.assert_array_equal(ga, a[64 * cw:64 * cw + 64, 16 * kk:16 * kk + 16])
            np.testing.assert_array_equal(gb, bm[:, 16 * kk:16 * kk + 16])


def test_relu2_zeroes_every_value_with_its_sign_bit_set():
    v = np.array([1.5, -1.5, 0.0, -0.0, 3e-40, -3e-40, 2.0**-100], np.float32)
    got = relu2(to_bf16(v))
    assert np.array_equal(got, np.maximum(to_bf16(v), 0)) and not np.signbit(got).any()


def test_relu_warps_cover_a_once():
    """relu_warps' 96 threads zero every negative value of dW's A tile, chunk by
    chunk once, and leave the B tile as it is."""
    rng = np.random.default_rng(6)
    smem = to_bf16(rng.normal(size=layout(128)["stage"] // 2))
    before = smem.copy()
    chunks = sorted(c for ht in range(96) for c in range(ht, TILE // 16, 96))
    assert chunks == list(range(TILE // 16))
    relu_warps_pass(smem, 0)
    np.testing.assert_array_equal(smem[:TILE // 2], np.maximum(before[:TILE // 2], 0))
    np.testing.assert_array_equal(smem[TILE // 2:], before[TILE // 2:])


@pytest.mark.parametrize("bn", [128, 256])
def test_dx_epilogue_quads_store_each_column_once(bn):
    """The regrouping by shuffles: lane q of a row's quad stores columns
    8 j + 4 q .. + 3 of each pair of groups, every column of the row once,
    with the value the accumulator holds for it."""
    acc = np.zeros((4, bn // 2))
    for q in range(4):
        for j in range(bn // 8):
            for e in range(2):
                acc[q, 4 * j + e] = 8 * j + 2 * q + e  # the column it holds
    out = dx_quad_stores(acc)
    assert sorted(out) == list(range(bn)) and all(out[c] == c for c in out)


def test_relu_pass_covers_its_warpgroups_half_of_a_once():
    """consume's pass: warpgroup cw zeroes the negative values of its 64-wide
    block of dW's A (every one of them, 4 chunks a thread) and touches
    neither the other block nor the B tile."""
    rng = np.random.default_rng(5)
    smem = to_bf16(rng.normal(size=layout(256)["stage"] // 2))
    before = smem.copy()
    q = 16 * (np.arange(128)[:, None] + 128 * np.arange(4))
    np.testing.assert_array_equal(np.sort(q.reshape(-1)), np.arange(0, 8192, 16))
    relu_pass(smem, 0, 1)
    half = slice(4096, 8192)  # block 1 of A, in bf16 elements
    np.testing.assert_array_equal(smem[half], np.maximum(before[half], 0))
    np.testing.assert_array_equal(smem[:4096], before[:4096])
    np.testing.assert_array_equal(smem[8192:], before[8192:])


@pytest.mark.parametrize("kind", ["dx", "dw"])
@pytest.mark.parametrize("b,side,c,co", [(2, 16, 128, 128), (1, 64, 256, 256), (1, 128, 128, 256)])
def test_tma_boxes_write_what_the_copies_write(kind, b, side, c, co):
    """Where the plan loads by TMA, each stage's boxes (the tap's shifted
    window with zeros outside the map; 64-pixel runs of x and dy) put in
    shared memory the bytes that the producer warpgroup's copies put there,
    at the first, a middle and the last stage of the first and the last item
    of the kind."""
    x, w, dy = _bf16_inputs(b, side, c, co, seed=side + c)
    plan = cv.bf16_plan(b, side, side, c, co)
    assert plan["tma"]
    g, stage = (b, side, side, c, co), layout(plan["bn"])["stage"]
    lo = 0 if plan["dw_first"] == (kind == "dw") else (plan["n_dw"] if kind == "dx" else plan["n_dx"])
    n = plan["n_dw"] if kind == "dw" else plan["n_dx"]
    for ticket in (lo, lo + n - 1):
        it = item_at(ticket, plan, c, co)
        assert it["dw"] == (kind == "dw")
        for kb in sorted({0, it["nk"] // 2, it["nk"] - 1}):
            by_copy = np.full(stage // 2, np.nan, np.float32)
            by_tma = by_copy.copy()
            if kind == "dw":
                dw_stage(by_copy, 0, g, it, kb, x, dy)
                dw_stage_tma(by_tma, 0, g, it, kb, x, dy)
            else:
                dx_stage(by_copy, 0, g, it, kb, dy, w)
                dx_stage_tma(by_tma, 0, g, it, kb, dy, w)
            assert not np.isnan(by_tma).any()
            np.testing.assert_array_equal(by_tma, by_copy)


def test_items_deal_the_longer_kind_first():
    """At the trunk's shape dW's chunks (74 stages) go before dx's tiles (36
    stages), 128 x 256 tiles; the tickets cover each tile of both products once."""
    p = cv.bf16_plan(8, 64, 64, 256, 256)
    assert p["dw_first"] and p["chunk_px"] // BK == 74 and p["dx_nk"] == 36 and p["bn"] == 256
    items = [item_at(i, p, 256, 256) for i in range(p["n_dx"] + p["n_dw"])]
    assert all(it["dw"] for it in items[:p["n_dw"]]) and not any(it["dw"] for it in items[p["n_dw"]:])
    assert len({(it["z"], it["m0"], it["n0"]) for it in items[:p["n_dw"]]}) == p["n_dw"]
    assert len({(it["m0"], it["n0"]) for it in items[p["n_dw"]:]}) == p["n_dx"]
    q = cv.bf16_plan(1, 10, 10, 128, 256)  # 100 pixels: one short chunk, dx's tiles first
    assert not q["dw_first"] and q["chunks"] == 1


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("b,side,c,co", [
    (1, 8, 128, 128),    # one dx tile (half of it past the pixel edge), one stage of dW
    (1, 10, 128, 256),   # 100 pixels: a ragged edge in both products, two channel tiles of dW
    (1, 4, 128, 384),    # K = 9 * 384 in one dx item
    (1, 24, 128, 128),   # a 96² trunk's map: 576 pixels, 128-pixel tiles not whole rows
    (1, 8, 256, 256),    # the trunk's width: 128 x 256 tiles, a ring of 4 stages
    (1, 24, 256, 256),   # ... at the 96² trunk's map
    (2, 16, 128, 128),   # loaded by TMA: a tile is 8 whole rows, a dW stage 4
    (1, 16, 256, 256),   # ... at the trunk's width
])
def test_emulated_core_matches_the_plain_version(b, side, c, co, relu):
    x, w, dy = _bf16_inputs(b, side, c, co, seed=side + co)
    dx, dw = emulate(x, w, dy, relu)
    _hold(dx, dw, x, w, dy, relu)


def test_emulated_dw_adds_pixel_chunks():
    """2,401 pixels at Co = 128: dW's K in four chunks, three of 640 pixels
    and one of 481, added in order."""
    x, w, dy = _bf16_inputs(1, 49, 128, 128, seed=49)
    p = cv.bf16_plan(1, 49, 49, 128, 128)
    assert (p["chunks"], p["chunk_px"]) == (4, 640)
    dx, dw = emulate(x, w, dy, relu=True)
    _hold(dx, dw, x, w, dy, relu=True)
