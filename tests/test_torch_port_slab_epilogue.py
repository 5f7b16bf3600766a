"""The cooperative schedule of the whole-slab epilogues (rows 16-17), emulated on the CPU.

``csrc/int8_epilogue.cu`` runs each call as one cooperative launch: items are
the 128-row chunks of each sample, each CTA takes items blockIdx.x,
+ grid, ...; phase 1 writes each chunk's sums (and extremes) to its slot;
phase 2 reduces them per (sample, 32 channels) to m; phase 3 sums each
chunk's fp64 squared deviations (warps' rows in order, the warps as a tree);
phase 4 adds the chunks as a tree of adjacent pairs in blocks of 64 and
writes k (and the relu form's amax parts from the extremes); then the relu
form requantizes, the residual form takes max|h| per chunk and then writes h
and its int8 last-read first. ``slab_emulated`` repeats that index
arithmetic in numpy, with the CTAs in a shuffled order, and each case must
equal the plain version of ``msig_tpu_torch/ops/int8_epilogue.py`` to the bit.
The plain version itself is held against the Pallas kernels in
``tests/test_torch_port_int8_epilogue.py`` and the kernel against the plain
version on the card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from msig_tpu_torch.ops import int8_epilogue as ep

WARPS, TILE_C, ROWS, TREE = 8, 128, 128, 64  # csrc/int8_epilogue.cu (256 threads)
F32 = np.float32
INT_MAX, INT_MIN = 2 ** 31 - 1, -2 ** 31


def _items(b, s, grid):
    """Each CTA's items (blockIdx.x, + grid, ...), the CTAs in a shuffled order;
    item i = chunk i % chunks of sample i / chunks, rows [128 k, min(128 k + 128, S))."""
    chunks = -(-s // ROWS)
    rows = [(i // chunks, i % chunks * ROWS, min(s, (i % chunks + 1) * ROWS))
            for i in range(b * chunks)]
    order = np.random.default_rng(grid + s).permutation(grid)
    return chunks, rows, [(cta, list(range(cta, len(rows), grid))) for cta in order]


def _warp_rows(r0, r1, warp):
    """A warp's rows of an item in the order it adds them: r0 + warp, + 8, ..."""
    return list(range(r0 + warp, r1, WARPS))


def _norm_mod(x, m, k, beta):
    return (x.astype(F32) - m) * k + beta


def _tree(vals, tree):
    """Phase 4's sum of a unit's chunk partials [chunks, 32]: blocks of ``tree``
    chunks, each a tree of adjacent pairs over a power-of-two width (zero
    padded); past one block each block's sum goes back to slot ``block`` and
    the blocks' sums are added the same way."""
    vals = vals.copy()
    length = len(vals)
    while True:
        blocks = -(-length // tree)
        for blk in range(blocks):
            cnt = min(tree, length - blk * tree)
            width = 1
            while width < cnt:
                width *= 2
            t = np.zeros((width, vals.shape[1]))
            t[:cnt] = vals[blk * tree:blk * tree + cnt]
            s = 1
            while s < width:
                t[0:width:2 * s] = t[0:width:2 * s] + t[s:width:2 * s]
                s *= 2
            if blocks > 1:
                vals[blk] = t[0]
        if blocks == 1:
            return t[0]
        length = blocks


def slab_emulated(x, gamma, beta, grid, residual=None, eps=1e-5, tree=TREE):
    """Rows 16-17's launch with the kernel's index arithmetic. ``residual``:
    None for the relu form, else a torch tensor (bf16 or fp32). Returns the
    int8 output (and h in the residual's dtype)."""
    b_, s_, c_ = x.shape
    relu = residual is None
    chunks, rows, ctas = _items(b_, s_, grid)
    n_items, tiles, groups = len(rows), c_ // TILE_C, c_ // 32
    slot_sum = np.full((n_items, c_), -7, np.int64)  # -7: not written
    slot_mn, slot_mx = np.zeros((n_items, c_), np.int64), np.zeros((n_items, c_), np.int64)
    xf = x.astype(F32)
    # 1. each chunk's sums of fp32(x) (exact integers) and true extremes, warps in order
    for _, mine in ctas:
        for item in mine:
            b, r0, r1 = rows[item]
            for ct in range(tiles):
                cols = slice(ct * TILE_C, (ct + 1) * TILE_C)
                s, mn, mx = 0, np.full(TILE_C, INT_MAX), np.full(TILE_C, INT_MIN)
                for warp in range(WARPS):
                    r = _warp_rows(r0, r1, warp)
                    s = s + xf[b, r, cols].astype(np.int64).sum(0)
                    mn = np.minimum(mn, x[b, r, cols].min(0, initial=INT_MAX))
                    mx = np.maximum(mx, x[b, r, cols].max(0, initial=INT_MIN))
                assert (slot_sum[item, cols] == -7).all(), "each slot written once"
                slot_sum[item, cols], slot_mn[item, cols], slot_mx[item, cols] = s, mn, mx
    assert (slot_sum != -7).all(), "every slot written"
    # 2. per (sample, 32 channels): warp k adds chunks k, k + 8, ...; the warps in order
    m = np.zeros((b_, c_), F32)
    cmn, cmx = np.zeros((b_, c_), np.int64), np.zeros((b_, c_), np.int64)
    for unit in range(b_ * groups):
        b, c = unit // groups, (unit % groups) * 32 + np.arange(32)
        idx = [[b * chunks + k for k in range(w, chunks, WARPS)] for w in range(WARPS)]
        s = sum(slot_sum[i][:, c].sum(0) for i in idx)
        m[b, c] = F32(s.astype(F32)) / F32(s_)
        cmn[b, c] = np.min([slot_mn[i][:, c].min(0, initial=INT_MAX) for i in idx], 0)
        cmx[b, c] = np.max([slot_mx[i][:, c].max(0, initial=INT_MIN) for i in idx], 0)
    # 3. each chunk's fp64 sum of squared deviations: the CTA's items and tiles
    # from the last, each warp's rows in order, the warps as a tree
    sq = np.full((n_items, c_), np.nan)
    for _, mine in ctas:
        for item in reversed(mine):
            b, r0, r1 = rows[item]
            for ct in reversed(range(tiles)):
                cols = slice(ct * TILE_C, (ct + 1) * TILE_C)
                q = np.zeros((WARPS, TILE_C))
                for warp in range(WARPS):
                    for r in _warp_rows(r0, r1, warp):
                        d = xf[b, r, cols] - m[b, cols]
                        q[warp] = q[warp] + (d * d).astype(np.float64)
                sq[item, cols] = ((q[0] + q[1]) + (q[2] + q[3])) + ((q[4] + q[5]) + (q[6] + q[7]))
    assert not np.isnan(sq).any(), "every partial written"
    # 4. per (sample, 32 channels): the chunks as a tree, v, k; the relu form's
    # amax part of the 32 channels from their extremes
    k = np.zeros((b_, c_), F32)
    hi = np.zeros((b_, groups), F32)
    for unit in range(b_ * groups):
        b, g = unit // groups, unit % groups
        c = g * 32 + np.arange(32)
        t = _tree(sq[b * chunks:(b + 1) * chunks, c], tree)
        v = t.astype(F32) / F32(s_)
        k[b, c] = (F32(1) / np.sqrt(v + F32(eps))) * gamma[b, c]
        hi[b, g] = np.maximum(_norm_mod(cmn[b, c], m[b, c], k[b, c], beta[b, c]),
                              _norm_mod(cmx[b, c], m[b, c], k[b, c], beta[b, c])).max()
    out = np.full(x.shape, -1000, np.int32)  # -1000: not written
    if relu:
        # 5. the CTA's items from the first, the sample's scale from its parts
        for _, mine in ctas:
            for item in mine:
                b, r0, r1 = rows[item]
                amax = max(F32(0), hi[b].max())
                sc = F32(127) / amax if amax > 0 else F32(1)
                for ct in range(tiles):
                    cols = slice(ct * TILE_C, (ct + 1) * TILE_C)
                    for warp in range(WARPS):
                        r = _warp_rows(r0, r1, warp)
                        y = np.maximum(_norm_mod(x[b, r, cols], m[b, cols], k[b, cols],
                                                 beta[b, cols]), F32(0))
                        assert (out[b, r, cols] == -1000).all(), "written once"
                        out[b, r, cols] = np.clip(np.rint(y * sc), -127, 127)
        assert (out != -1000).all(), "every output written"
        return out
    res = residual.to(torch.float32).numpy()
    # 5. max|h| of each chunk, into its slot
    slot_amax = np.full(n_items, np.nan, F32)
    for _, mine in ctas:
        for item in mine:
            b, r0, r1 = rows[item]
            local = F32(0)
            for ct in range(tiles):
                cols = slice(ct * TILE_C, (ct + 1) * TILE_C)
                for warp in range(WARPS):
                    r = _warp_rows(r0, r1, warp)
                    h = (_norm_mod(x[b, r, cols], m[b, cols], k[b, cols], beta[b, cols])
                         + res[b, r, cols])
                    local = max(local, np.abs(h).max(initial=0))
            slot_amax[item] = local
    assert not np.isnan(slot_amax).any()
    # 6. h and its int8: the CTA's items, tiles and rows from the last
    h_out = np.full(x.shape, np.nan, F32)
    for _, mine in ctas:
        for item in reversed(mine):
            b, r0, r1 = rows[item]
            amax = max(F32(0), slot_amax[b * chunks:(b + 1) * chunks].max())
            sc = F32(127) / amax if amax > 0 else F32(1)
            for ct in reversed(range(tiles)):
                cols = slice(ct * TILE_C, (ct + 1) * TILE_C)
                for warp in range(WARPS):
                    r = _warp_rows(r0, r1, warp)[::-1]
                    h = (_norm_mod(x[b, r, cols], m[b, cols], k[b, cols], beta[b, cols])
                         + res[b, r, cols])
                    assert (out[b, r, cols] == -1000).all(), "written once"
                    h_out[b, r, cols] = h
                    out[b, r, cols] = np.clip(np.rint(h * sc), -127, 127)
    assert (out != -1000).all() and not np.isnan(h_out).any(), "every output written"
    return torch.from_numpy(h_out).to(residual.dtype), out


def _inputs(b, s, c, lim, seed):
    """Seeded x in (-lim, lim), with the edge channels of every sample: channel
    1 constant (v = 0), 2 with gamma = 0, 3 with gamma < 0; sample 1 (where
    there is one) with gamma = 0 and beta <= 0 throughout, so its y is all
    <= 0 (amax 0, scale 1)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-lim, lim, (b, s, c), dtype=np.int64).astype(np.int32)
    gamma = rng.normal(1.0, 0.5, (b, c)).astype(F32)
    beta = rng.normal(0.0, 0.5, (b, c)).astype(F32)
    x[:, :, 1] = x[:, :1, 1]
    gamma[:, 2] = 0.0
    gamma[:, 3] = -np.abs(gamma[:, 3]) - 0.25
    if b > 1:
        gamma[1], beta[1] = 0.0, -np.abs(beta[1])
    res = rng.normal(0.0, 1.5, (b, s, c)).astype(F32)
    return x, gamma, beta, res


def _plain(x, gamma, beta, res=None):
    t = [torch.from_numpy(a) for a in (x, gamma, beta)]
    if res is None:
        return ep.adain_relu_requant_plain(*t)
    return ep.adain_residual_requant_plain(*t, res)


# (B, S, C, |x| <): S = 1000 (a ragged last chunk), two channel tiles, the
# whole int32 range (the fp32 cast rounds) and values of a conv's size.
SHAPES = [(2, 1000, 256, 2 ** 31 - 1), (2, 1000, 256, 2 ** 20), (3, 200, 128, 3000)]
GRIDS = (1, 7, 132, 264)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("b,s,c,lim", SHAPES)
def test_relu_schedule_equals_the_plain_version_to_the_bit(b, s, c, lim, grid):
    x, g, be, _ = _inputs(b, s, c, lim, seed=s + c)
    got = slab_emulated(x, g, be, grid)
    want = _plain(x, g, be)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int32))
    if b > 1:
        assert (want[1] == 0).all(), "the sample whose y is all <= 0 requantizes to 0"


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_residual_schedule_equals_the_plain_version_to_the_bit(dtype, grid):
    b, s, c, lim = SHAPES[0]
    x, g, be, r = _inputs(b, s, c, lim, seed=grid)
    res = torch.from_numpy(r).to(dtype)
    got_h, got = slab_emulated(x, g, be, grid, residual=res)
    want_h, want = _plain(x, g, be, res)
    assert got_h.dtype == dtype and torch.equal(got_h, want_h)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int32))


@pytest.mark.parametrize("tree", [2, 4])
def test_tree_past_one_block_equals_the_plain_order(tree):
    """Phase 4's in-place blocks, exercised with blocks of 2 and 4 chunks (the
    kernel's 64 take 8,193 rows a sample): a tree of adjacent pairs in
    aligned power-of-two blocks is the one tree, whatever the block."""
    b, s, c, lim = 1, 9 * ROWS + 5, 128, 2 ** 31 - 1
    x, g, be, r = _inputs(b, s, c, lim, seed=tree)
    np.testing.assert_array_equal(slab_emulated(x, g, be, 3, tree=tree),
                                  _plain(x, g, be).numpy().astype(np.int32))
    res = torch.from_numpy(r).to(torch.bfloat16)
    got_h, got = slab_emulated(x, g, be, 5, residual=res, tree=tree)
    want_h, want = _plain(x, g, be, res)
    assert torch.equal(got_h, want_h)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int32))


def test_relu_amax_from_the_extremes_is_the_slabs_max():
    """Row 16's amax, the largest of each channel's norm_mod at its min and its
    max x (and 0), is max y over the slab exactly, also on the constant
    channel and those with gamma < 0 and gamma = 0."""
    x, g, be, _ = _inputs(2, 1000, 256, 2 ** 31 - 1, seed=11)
    xt = torch.from_numpy(x)
    z = ep.norm_mod(xt, torch.from_numpy(g), torch.from_numpy(be))
    at = [torch.gather(z, 1, (xt == e[:, None, :]).to(torch.int64).argmax(1)[:, None, :])[:, 0]
          for e in (xt.amin(1), xt.amax(1))]
    parts = torch.clamp(torch.maximum(*at), min=0.0).amax(1)
    assert torch.equal(parts, torch.clamp(z, min=0.0).amax(dim=(1, 2)))
    assert float(parts[1]) == 0.0  # the sample whose y is all <= 0


def test_plain_sums_the_squares_in_the_stated_order():
    """A slab whose fp64 sum of squares parts between orders: rows of xc = 1
    beside one row of 2^27 (square 2^54, where fp64 steps by 4). Rows in order
    lose every 1 after the big one; the stated order (lanes of a chunk each in
    order, lanes and chunks as trees) keeps the sixteen-row sums of the other
    lanes and the second chunk."""
    s = 2 * ROWS
    xc = torch.ones((1, s, 1), dtype=torch.float32)
    xc[0, 0, 0] = 2.0 ** 27
    sq = [float(v) ** 2 for v in xc[0, :, 0]]

    def lane(chunk, l):
        acc = 0.0
        for r in range(chunk * ROWS + l, (chunk + 1) * ROWS, 8):
            acc += sq[r]
        return acc

    def tree8(v):
        return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]))

    stated = tree8([lane(0, l) for l in range(8)]) + tree8([lane(1, l) for l in range(8)])
    in_order = 0.0
    for v in sq:
        in_order += v
    assert stated == 2.0 ** 54 + 240 and in_order == 2.0 ** 54
    got = ep.deviation_sq_sum(xc)
    assert got.dtype == torch.float64 and float(got[0, 0]) == stated


def test_pairwise_sum_pads_odd_levels_as_a_power_of_two_would():
    rng = np.random.default_rng(3)
    t = torch.from_numpy(rng.uniform(0, 2.0 ** 40, (5, 2)) * rng.uniform(0, 1, (5, 2)) ** 30)
    padded = torch.cat([t, torch.zeros((3, 2), dtype=t.dtype)])
    assert torch.equal(ep.pairwise_sum(t, 0), ep.pairwise_sum(padded, 0))
    want = ((t[0] + t[1]) + (t[2] + t[3])) + t[4]
    assert torch.equal(ep.pairwise_sum(t, 0), want)


def test_workspace_and_items_do_not_depend_on_the_grid():
    """The workspace holds three int64 words a (chunk, channel), and per
    sample m, k, the extremes, the amax parts and the chunks' max|h|."""
    assert (ep.workspace_words(8, 4096, 256)
            == 3 * 8 * 32 * 256 + (4 * 8 * 256 + 8 * 8 + 8 * 32) // 2)
    assert ep.workspace_words(1, 1, 128) == 3 * 128 + (4 * 128 + 4 + 1 + 1) // 2
    for grid in GRIDS:
        chunks, rows, _ = _items(2, 1000, grid)
        assert chunks == 8 and rows[7] == (0, 896, 1000) and rows[8] == (1, 0, 128)


CACHE_BYTES = 96 * 1024  # csrc/int8_epilogue.cu: kCacheBytes, the dynamic shared memory a CTA


@pytest.mark.parametrize("b,s,c,grid", [(8, 4096, 256, 264), (8, 4096, 256, 132), (2, 1000, 384, 7),
                                        (1, 16384, 128, 264), (3, 40, 4096, 2)])
def test_cache_slots_are_distinct_and_fit(b, s, c, grid):
    """Each CTA's cached rows (the first nr rows of each of its chunks' tiles,
    32 int4 a row) land on distinct int4 slots inside its kCacheBytes; at the
    main path's shape and two CTAs an SM, 96 of each tile's 128 rows."""
    chunks, rows, ctas = _items(b, s, grid)
    tiles = c // TILE_C
    for cta, mine in ctas:
        if not mine:
            continue
        nr = min(ROWS, CACHE_BYTES // 512 // (len(mine) * tiles))
        slots = [((k * tiles + ct) * nr + (r - rows[item][1])) * 32 + lane
                 for k, item in enumerate(mine) for ct in range(tiles)
                 for r in range(rows[item][1], min(rows[item][2], rows[item][1] + nr))
                 for lane in range(32)]
        assert len(set(slots)) == len(slots) and max(slots, default=0) < CACHE_BYTES // 16
        if (b, s, c, grid) == (8, 4096, 256, 264):
            assert nr == 96


def test_variants_tool_edits_apply_to_the_source():
    """Every variant of ``tools/slab_rows_torch.py`` finds its text in the CUDA
    source as often as it says, so the tool builds on the card."""
    import importlib.util

    from msig_tpu_torch.ops import _build
    spec = importlib.util.spec_from_file_location(
        "slab_rows_torch", _build.CSRC.parents[1] / "tools" / "slab_rows_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    source = (_build.CSRC / tool.SOURCE).read_text()
    for name, edits in tool.VARIANTS.items():
        assert (tool.variant_text(source, edits) == source) == (name == "as built"), name
    assert set(tool.EXACT) == set(tool.VARIANTS) - {"barriers alone"}


def test_sqrt_rn_is_the_correctly_rounded_fp32_sqrt():
    """The plain version's sqrt, as the kernel's ``__fsqrt_rn``: rounded once,
    also where a CPU's float32 sqrt may be one ulp off (1.5273133e18)."""
    from decimal import Decimal, getcontext

    getcontext().prec = 60
    v = np.concatenate([np.array([1.5273133e18], F32),
                        np.random.default_rng(0).uniform(0, 2.0 ** 62, 256).astype(F32)])
    got = ep.sqrt_rn(torch.from_numpy(v)).numpy()
    for a, r in zip(v, got):
        exact = Decimal(float(a)).sqrt()
        below, above = np.nextafter(r, F32(0)), np.nextafter(r, F32(np.inf))
        assert abs(Decimal(float(r)) - exact) <= abs(Decimal(float(below)) - exact)
        assert abs(Decimal(float(r)) - exact) <= abs(Decimal(float(above)) - exact)
