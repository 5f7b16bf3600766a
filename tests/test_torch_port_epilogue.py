"""Parity of the port's chunked relu epilogue (``fused_epilogue``) with the JAX package.

``adain_relu_requant_chunked`` of ``msig_tpu_torch/ops/int8_epilogue_chunked.py``
(its plain version, which the CPU runs) against the Pallas kernel of
``msig_tpu/ops/int8_epilogue_chunked.py`` in interpret mode; its exact
statistics over the whole int32 range; ``supported``; and the unfused int8
generator, ``quantized_generator_apply(..., fused_trunk=False,
fused_epilogue=True)``, against the JAX package's at the configuration of
tests/test_quantized.py::test_fused_epilogue_matches_unfused. The CUDA kernel
is held against the plain version on the card (tests/test_torch_port_cuda.py,
chip_smoke.py).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msig_tpu.infer import quantized as jq
from msig_tpu.models import StyleCycleGANGenerator as JGenerator
from msig_tpu.ops import int8_epilogue_chunked as jec
from msig_tpu_torch.compat.from_jax import generator_state_dict
from msig_tpu_torch.infer import quantized as tq
from msig_tpu_torch.ops import _build
from msig_tpu_torch.ops import fused_conv_int8_v2 as tf2
from msig_tpu_torch.ops import int8_epilogue_chunked as tec


def _inputs(shape, seed, lim=3000):
    rng = np.random.default_rng(seed)
    b, _, c = shape
    return (rng.integers(-lim, lim, shape).astype(np.int32),
            rng.standard_normal((b, c)).astype(np.float32),
            rng.standard_normal((b, c)).astype(np.float32))


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


# ----------------------------------------------------------- the kernel


@pytest.mark.parametrize("shape,chunk", [((2, 64, 128), 512), ((2, 1024, 256), 256)])
def test_plain_matches_pallas(shape, chunk):
    """Bar: at most 1 step apart on under 1% of the elements (fp32 sums
    chunk by chunk on the TPU, exact integers here)."""
    x, g, b = _inputs(shape, seed=shape[1])
    want = np.asarray(jec.adain_relu_requant_chunked(jnp.asarray(x), jnp.asarray(g),
                                                     jnp.asarray(b), chunk=chunk))
    got = tec.adain_relu_requant_chunked(torch.from_numpy(x), torch.from_numpy(g),
                                         torch.from_numpy(b)).numpy()
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape == shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (diff.max(), (diff > 0).mean())


def test_true_extremes_not_zero_masked():
    """The scale comes from each channel's true min and max: a channel of
    positive values with a negative gamma has its largest output at its
    minimum, where the zero-masked rule of the conv sites would put it at 0."""
    x, g, b = _inputs((1, 64, 128), seed=9)
    x[..., 0] = np.abs(x[..., 0]) + 1000
    g[:, 0], b[:, 0] = -2.0, 4.0
    want = np.asarray(jec.adain_relu_requant_chunked(jnp.asarray(x), jnp.asarray(g),
                                                     jnp.asarray(b)))
    xt = torch.from_numpy(x)
    got = tec.adain_relu_requant_chunked(xt, torch.from_numpy(g), torch.from_numpy(b)).numpy()
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    y = xt.to(torch.int64).reshape(1, 64, 1, 128)
    masked = tf2._relu_requant(y, *tf2._channel_affine(y, torch.from_numpy(g),
                                                       torch.from_numpy(b), 1e-5))[0]
    assert np.abs(masked.reshape(got.shape).numpy().astype(np.int32) - got).max() > 1


def test_statistics_exact_over_the_whole_int32_range():
    """No range check: each square of an int32 (< 2^62) is split into two
    words element by element, so the sums are exact integers for any input.
    Held against Python's integers on the extremes of the range."""
    vals = np.array([-2 ** 31, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 1, 12345, -1, 0, 7] * 4,
                    dtype=np.int64)
    y = torch.from_numpy(vals).reshape(1, 32, 1, 1)
    hi, lo = tf2.sumsq_words(y)
    assert int(hi) * 2 ** 32 + int(lo) == sum(int(v) ** 2 for v in vals)
    assert float(tf2.words_to_f32(hi, lo)) == np.float32(sum(int(v) ** 2 for v in vals))
    x = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        vals[np.arange(64) % 32][None, :, None], (1, 64, 128))).astype(np.int32))
    out = tec.adain_relu_requant_chunked(x, torch.ones((1, 128)), torch.zeros((1, 128)))
    assert out.dtype == torch.int8 and int(out.max()) == 127 and int(out.min()) == 0


@pytest.mark.parametrize("shape", [(1, 4096, 256), (1, 65536, 128), (1, 4096, 64), (2, 60, 128),
                                   (8, 64, 384)])
def test_supported_mirrors_jax(shape):
    assert tec.supported(shape) == jec.supported(shape)


# ------------------------------------------- the cooperative kernel's schedule

WARPS, TILE_C, UNROLL = 8, 128, 4  # csrc/adain_relu_requant_chunked.cu (256 threads)
F32 = np.float32
INT_MAX, INT_MIN = 2 ** 31 - 1, -2 ** 31  # the neutral min and max of a thread's int32


def _items(b, s, grid):
    """The kernel's items: each sample's S rows cut into parts(grid, B) shares,
    item i = share i % parts of sample i / parts, rows [r0, r1)."""
    parts = tec.parts(grid, b)
    return parts, [(i // parts, i % parts * s // parts, (i % parts + 1) * s // parts)
                   for i in range(b * parts)]


def _ctas(n_items, grid, seed):
    """Each CTA's items (blockIdx.x, + grid, ...), the CTAs in a shuffled order."""
    return [(cta, list(range(cta, n_items, grid)))
            for cta in np.random.default_rng(seed).permutation(grid)]


def _warp_rows(r0, r1, warp):
    """The rows a warp adds: r = r0 + warp, + 32, ..., kUnroll loads 8 rows apart each."""
    return [r + u * WARPS for r in range(r0 + warp, r1, WARPS * UNROLL) for u in range(UNROLL)
            if r + u * WARPS < r1]


def chunked_emulated(x, gamma, beta, grid, eps=1e-5, seed=0):
    """The three phases of the one launch with the kernel's index arithmetic:
    each item's statistics per 128-channel tile, per warp over its rows and
    met in warp order, into the item's slot; per (sample, 32 channels) the
    warps' shares of the items summed and met in warp order, then the affine
    and each channel's amax part in fp32; each CTA's items in reverse, tiles
    and rows from the last read, through the sample's scale. Returns (the
    statistics [5, B, C] as the reduction leaves them, int8 [B, S, C])."""
    b_, s_, c_ = x.shape
    parts, items = _items(b_, s_, grid)
    xi = x.astype(np.int64)
    slot = np.zeros((5, len(items), c_), np.int64)  # sum, lo, hi, min, max; every slot written
    written = np.zeros((len(items), c_), np.int64)
    for _, mine in _ctas(len(items), grid, seed):
        for item in mine:
            b, r0, r1 = items[item]
            cover = np.zeros(s_, np.int64)
            for ct in range(c_ // TILE_C):
                cols = slice(ct * TILE_C, (ct + 1) * TILE_C)
                part = np.zeros((5, WARPS, TILE_C), np.int64)
                for warp in range(WARPS):
                    rows = _warp_rows(r0, r1, warp)
                    cover[rows] += 1
                    v = xi[b, rows, cols]
                    sq = v * v  # < 2^62
                    part[:, warp] = (v.sum(0), (sq & 0xFFFFFFFF).sum(0), (sq >> 32).sum(0),
                                     v.min(0, initial=INT_MAX), v.max(0, initial=INT_MIN))
                fold = part[:, 0].copy()
                for warp in range(1, WARPS):  # the warps in order
                    fold[:3] += part[:3, warp]
                    fold[3], fold[4] = np.minimum(fold[3], part[3, warp]), np.maximum(fold[4],
                                                                                    part[4, warp])
                slot[:, item, cols] = fold
                written[item, cols] += 1
            assert np.array_equal(cover[r0:r1], np.full(r1 - r0, c_ // TILE_C)), "each row once"
    assert (written == 1).all(), "every slot written once"
    stats = np.zeros((5, b_, c_), np.int64)
    for unit in range(b_ * c_ // 32):
        b, c = unit // (c_ // 32), (unit % (c_ // 32)) * 32 + np.arange(32)
        share = [slot[:, [b * parts + k for k in range(warp, parts, WARPS)]][:, :, c]
                 for warp in range(WARPS)]
        fold = np.stack([share[0][i].sum(0) if i < 3 else (share[0][i].min(0, initial=INT_MAX)
                         if i == 3 else share[0][i].max(0, initial=INT_MIN))
                         for i in range(5)])
        for warp in range(1, WARPS):
            fold[:3] += share[warp][:3].sum(1)
            fold[3] = np.minimum(fold[3], share[warp][3].min(0, initial=INT_MAX))
            fold[4] = np.maximum(fold[4], share[warp][4].max(0, initial=INT_MIN))
        stats[:, b, c] = fold
    # in_affine (affine_of) and true_relu_hi in fp32, as the kernel's thread l
    n = F32(s_)
    mean = stats[0].astype(F32) / n
    sumsq = tf2.words_to_f32(torch.from_numpy(stats[2]), torch.from_numpy(stats[1])).numpy()
    var = np.maximum(sumsq / n - mean * mean, F32(0))
    a = gamma * (F32(1) / np.sqrt(var + F32(eps)))
    d = beta - mean * a
    hi = np.maximum(a * stats[4].astype(F32), a * stats[3].astype(F32)) + d
    out = np.full(x.shape, -1000, np.int32)  # -1000: not written
    for cta, mine in _ctas(len(items), grid, seed + 1):
        for item in reversed(mine):
            b, r0, r1 = items[item]
            amax = max(F32(0), hi[b].max())
            sc = F32(127) / amax if amax > 0 else F32(1)
            for ct in reversed(range(c_ // TILE_C)):
                cols = slice(ct * TILE_C, (ct + 1) * TILE_C)
                for warp in range(WARPS):
                    rows = [r - u * WARPS for r in range(r1 - 1 - warp, r0 - 1, -WARPS * UNROLL)
                            for u in range(UNROLL) if r - u * WARPS >= r0]
                    t = np.maximum(x[b, rows, cols].astype(F32) * a[b, cols] + d[b, cols],
                                   F32(0)) * sc
                    dst = out[b, rows, cols]
                    assert (dst == -1000).all(), "written once"
                    out[b, rows, cols] = np.clip(np.rint(t), -127, 127)
    assert (out != -1000).all(), "every output written"
    return stats, out


# (B, S, C, grid, |x| <): S ragged against the items (100 rows in 7 shares),
# three channel tiles (C = 384), the whole int32 range, more items than rows
# (parts 66 > S = 24: empty items), and more samples than CTAs (B = 3 on 2:
# one item a sample, CTAs walking two).
CHUNKED_SCHEDULE = [(1, 100, 128, 7, 3000), (2, 72, 256, 5, 2 ** 31), (3, 40, 384, 16, 2 ** 20),
                    (2, 24, 128, 132, 2 ** 31), (3, 8, 256, 2, 3000)]


@pytest.mark.parametrize("b,s,c,grid,lim", CHUNKED_SCHEDULE)
def test_cooperative_schedule_equals_the_plain_version_to_the_bit(b, s, c, grid, lim):
    rng = np.random.default_rng(s + c + grid)
    x = rng.integers(-lim, lim, (b, s, c), dtype=np.int64).astype(np.int32)
    g = rng.standard_normal((b, c)).astype(np.float32)
    be = rng.standard_normal((b, c)).astype(np.float32)
    stats, got = chunked_emulated(x, g, be, grid)
    y = torch.from_numpy(x).to(torch.int64)
    np.testing.assert_array_equal(stats[0], y.sum(1).numpy())
    hi, lo = tf2.sumsq_words(y.reshape(b, s, 1, c))
    np.testing.assert_array_equal(stats[2].astype(object) * 2 ** 32 + stats[1].astype(object),
                                  hi.numpy().astype(object) * 2 ** 32 + lo.numpy())
    np.testing.assert_array_equal(stats[3], y.amin(1).numpy())
    np.testing.assert_array_equal(stats[4], y.amax(1).numpy())
    want = tec.adain_relu_requant_chunked_plain(torch.from_numpy(x), torch.from_numpy(g),
                                                torch.from_numpy(be))
    np.testing.assert_array_equal(got, want.numpy().astype(np.int32))


def test_parts_and_workspace():
    """Every CTA of the grid gets an item where the samples allow it; the
    workspace holds four int64 words an item and channel and the [3, B, C]
    fp32 affine."""
    assert [tec.parts(396, b) for b in (1, 3, 8, 500)] == [396, 132, 49, 1]
    assert tec.workspace_words(8, 256, 49) == 4 * 8 * 49 * 256 + 3 * 8 * 256 // 2
    assert tec.workspace_words(1, 128, 1) == 4 * 128 + 192


def test_variants_tool_edits_apply_to_the_source():
    """Every variant of ``tools/optin_rows_torch.py`` finds its text in the
    CUDA source as often as it says, so the tool builds on the card."""
    import importlib.util
    root = _build.CSRC.parents[1]
    spec = importlib.util.spec_from_file_location("optin_rows_torch",
                                                  root / "tools" / "optin_rows_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    source = (_build.CSRC / tool.SOURCE).read_text()
    for name, edits in tool.VARIANTS.items():
        assert (tool.variant_text(source, edits) == source) == (name == "as built"), name
    split = tool.variant_text(source, "split")
    assert split.count("grid_barrier();") == 1 and "chunked_requant_kernel<<<" in split


# ------------------------------------------------------ no silent fallback


def _fake_cuda(shape, dtype):
    t = mock.Mock(spec=torch.Tensor)
    t.device, t.dtype, t.shape = torch.device("cuda", 0), dtype, torch.Size(shape)
    t.dim.return_value = len(shape)
    t.is_contiguous.return_value = True
    return t


def test_cuda_tensor_without_nvcc_raises(monkeypatch):
    """A CUDA tensor launches the kernel or raises: with no build, it raises;
    a CPU tensor counts no launch."""
    x, g, b = _inputs((1, 64, 128), seed=1)
    tec.reset_launch_counts()
    tec.adain_relu_requant_chunked(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    assert tec.LAUNCHES == {tec.SITE: 0}
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "library_path", lambda name: mock.Mock(exists=lambda: False))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    monkeypatch.setenv("NVCC", "")
    with mock.patch.object(tec, "adain_relu_requant_chunked_plain") as plain:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tec.adain_relu_requant_chunked(_fake_cuda((8, 4096, 256), torch.int32),
                                           _fake_cuda((8, 256), torch.float32),
                                           _fake_cuda((8, 256), torch.float32))
        plain.assert_not_called()
    assert tec.LAUNCHES == {tec.SITE: 0}


@pytest.mark.parametrize("case,match", [("meta", "CUDA tensor"), ("shape", "C % 128"),
                                        ("dtype", "must be torch.int32")])
def test_inputs_the_kernel_does_not_take_raise(case, match):
    if case == "meta":
        args = [torch.empty(s, dtype=d, device="meta") for s, d in
                (((1, 64, 128), torch.int32), ((1, 128), torch.float32), ((1, 128), torch.float32))]
    else:
        c = 64 if case == "shape" else 128
        args = [_fake_cuda((1, 64, c), torch.int32 if case == "shape" else torch.int64),
                _fake_cuda((1, c), torch.float32), _fake_cuda((1, c), torch.float32)]
    with pytest.raises(ValueError, match=match):
        tec.adain_relu_requant_chunked(*args)


# ----------------------------------------------- the unfused generator, 32²


@pytest.fixture(scope="module")
def gen32():
    """tests/test_quantized.py::test_fused_epilogue_matches_unfused: 2 resblocks,
    style_dim 16, two 32² images, whose trunk is [2, 8, 8, 256]."""
    gen = JGenerator(style_dim=16, n_residual_blocks=2)
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    style = rng.standard_normal((2, 16)).astype(np.float32)
    params = gen.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), jnp.asarray(style))
    return (jq.quantize_generator_params(params, 2),
            tq.quantize_generator_params(generator_state_dict(params, 2), 2), img, style)


@pytest.mark.parametrize("fused_epilogue", [True, False])
def test_unfused_generator_matches_jax(gen32, fused_epilogue):
    jqp, q, img, style = gen32
    want = np.asarray(jq.quantized_generator_apply(
        jqp, jnp.asarray(img), jnp.asarray(style), n_res=2, out_dtype=jnp.uint8,
        fused_trunk=False, fused_epilogue=fused_epilogue))
    tec.reset_launch_counts()
    with mock.patch.object(tq.ec, "adain_relu_requant_chunked",
                           wraps=tq.ec.adain_relu_requant_chunked) as spy, \
            mock.patch.object(tq.fc, "conv3x3_adain_relu_requant", side_effect=AssertionError):
        got = tq.quantized_generator_apply(q, torch.from_numpy(img), torch.from_numpy(style),
                                           n_res=2, out_dtype=torch.uint8, fused_trunk=False,
                                           fused_epilogue=fused_epilogue).numpy()
    assert spy.call_count == (2 if fused_epilogue else 0)
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, 32, 32, 3)
    assert _psnr(got, want) >= 40.0


def test_fused_epilogue_close_to_unfused(gen32):
    """The JAX package's bar between its two epilogues (test_quantized.py: > 35 dB)."""
    _, q, img, style = gen32
    a, b = (tq.quantized_generator_apply(q, torch.from_numpy(img), torch.from_numpy(style),
                                         n_res=2, out_dtype=torch.float32, fused_trunk=False,
                                         fused_epilogue=f).numpy() for f in (False, True))
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    assert 10 * np.log10(4.0 / mse) > 35.0


def test_epilogue_feeds_conv2_its_int8_without_a_second_requant(gen32, monkeypatch):
    """Each relu site's int8 goes straight into conv2 (``quantized.py:423-435``):
    ``_requant`` runs once per block, on conv1's input, and once more per
    decoder site."""
    _, q, img, style = gen32
    calls = []
    real = tq._requant
    monkeypatch.setattr(tq, "_requant", lambda x: calls.append(tuple(x.shape)) or real(x))
    h = tq._xla_encoder(q, torch.from_numpy(img))
    calls.clear()
    tq._xla_trunk(q, h, torch.from_numpy(style), 2, fused_epilogue=True)
    assert calls == [(2, 8, 8, 256)] * 2
    calls.clear()
    tq._xla_trunk(q, h, torch.from_numpy(style), 2, fused_epilogue=False)
    assert calls == [(2, 8, 8, 256)] * 4
