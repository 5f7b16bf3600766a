"""Parity of the port's 512² chain and hi-fi trunk modes with the JAX package.

The two hi-fi conv2 sites (bf16 carry, two-plane int8 carry), the staged enc0
and up1 sites in both ``MSIG_STAGE_FP16`` modes, the trunk in
``MSIG_TRUNK_HIFI`` 1 and 2, the strict reading of the three environment
settings, the two-word sum of squares, and which chain each input size and
output type takes. The JAX side runs eagerly on the CPU with its Pallas
kernels in interpret mode (the staged pairs on the 64-cell grid, as the JAX
package's own quick tests run them); the port runs its kernels' plain versions
(the CUDA kernels are held against those on the card:
tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msig_tpu.infer import quantized as jq
from msig_tpu.models import StyleCycleGANGenerator as JGenerator
from msig_tpu.ops import fused_conv_int8 as jfc
from msig_tpu.ops import fused_conv_int8_v2 as jf2
from msig_tpu.ops import fused_dec_int8 as jfd
from msig_tpu.ops import fused_enc_int8 as jfe
from msig_tpu_torch.compat.from_jax import generator_state_dict
from msig_tpu_torch.infer import quantized as tq
from msig_tpu_torch.ops import fused_conv_int8_v2 as tf2
from msig_tpu_torch.ops import fused_dec_int8 as tfd
from msig_tpu_torch.ops import fused_enc_int8 as tfe

W_IMG = 16
N_RES, SDIM = 2, 64


def _assert_int8_close(got, want):
    """At most 1 step apart, on under 1% of the elements (tests/test_fused_enc_int8.py:84)."""
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()


def _bf16_bits(x):
    """Bit patterns of a bf16 array (jax or torch) as int32, ordered like the
    values (+0 and -0 coincide)."""
    if isinstance(x, torch.Tensor):
        bits = x.view(torch.int16).numpy().astype(np.int32)
    else:
        bits = np.asarray(jax.lax.bitcast_convert_type(x, jnp.int16)).astype(np.int32)
    return np.where(bits >= 0, bits, -(bits & 0x7FFF))


def _dense(rows):
    return tf2.from_padded_rows(torch.from_numpy(np.array(rows)), W_IMG).numpy()


# ---------------------------------------------------- hi-fi sites vs Pallas


def _site_inputs(c, b=2, seed=3):
    rng = np.random.default_rng(seed)
    shape = (b, W_IMG, W_IMG, c)
    x = rng.integers(-127, 128, shape, dtype=np.int8)
    w = np.array(jfc.pack_weights(jnp.asarray(rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8))))
    gamma = rng.normal(1.0, 0.5, (b, c)).astype(np.float32)
    beta = rng.normal(0.0, 0.5, (b, c)).astype(np.float32)
    h = rng.normal(0, 1.5, shape).astype(np.float32)
    hs = (np.abs(h).max(axis=(1, 2, 3)) / 127.0).astype(np.float32).reshape(b, 1)
    ht = h / hs.reshape(b, 1, 1, 1)
    h1 = np.clip(np.round(ht), -127, 127)
    h2 = np.clip(np.round((ht - h1) * 254.0), -127, 127).astype(np.int8)
    return dict(x=x, w=w, gamma=gamma, beta=beta, h=h, hs=hs, h1=h1.astype(np.int8), h2=h2)


@pytest.mark.parametrize("c", [128, 256])
def test_hifi_site_plain_matches_pallas(c):
    """bf16 carry: the int8 copy within 1 step on < 1%, the carry within 1 bf16
    ulp on < 1% (the statistics are summed in another order, in fp32, there).
    Where conv*a + d and the residual cancel to under 2^-16 of the sample's
    largest value, an ulp of the result is finer than the fp32 rounding of
    the addends: there the bar is absolute, 2^-22 of that largest value."""
    t = _site_inputs(c)
    hb = jnp.asarray(t["h"]).astype(jnp.bfloat16)
    want_q, want_h = jf2.conv3x3_adain_residual_hifi(
        jf2.to_padded_rows(jnp.asarray(t["x"])), jf2.to_padded_rows(hb), jnp.asarray(t["w"]),
        jnp.asarray(t["gamma"]), jnp.asarray(t["beta"]), w_img=W_IMG)
    got_q, got_h = tf2.conv3x3_adain_residual_hifi(
        torch.from_numpy(t["x"]), torch.from_numpy(t["h"]).to(torch.bfloat16),
        torch.from_numpy(t["w"]), torch.from_numpy(t["gamma"]), torch.from_numpy(t["beta"]))
    assert got_h.dtype == torch.bfloat16 and got_h.shape == t["x"].shape

    def body(a):
        g = jf2.guard_rows(W_IMG)
        return a[:, g:g + W_IMG * (W_IMG + 8)].reshape(-1, W_IMG, W_IMG + 8, c)[:, :, :W_IMG]

    want_f = body(np.asarray(want_h.astype(jnp.float32)))
    ulps = np.abs(_bf16_bits(got_h) - body(_bf16_bits(want_h)))
    amax = np.abs(want_f).max(axis=(1, 2, 3), keepdims=True)
    cancelled = np.abs(want_f) < amax * 2.0 ** -16
    assert ulps[~cancelled].max() <= 1, ulps[~cancelled].max()
    assert (ulps[~cancelled] > 0).mean() < 0.01, (ulps[~cancelled] > 0).mean()
    assert cancelled.mean() < 1e-3
    assert (np.abs(got_h.float().numpy() - want_f) <= amax * 2.0 ** -22)[cancelled].all()
    _assert_int8_close(got_q.numpy(), _dense(want_q))


@pytest.mark.parametrize("c", [128, 256])
def test_hifi2_site_plain_matches_pallas(c):
    """Two-plane carry: both planes within 1 step on < 1%, the scale within rtol 1e-5."""
    t = _site_inputs(c, seed=4)
    want = jf2.conv3x3_adain_residual_hifi2(
        *(jf2.to_padded_rows(jnp.asarray(t[k])) for k in ("x", "h1", "h2")),
        jnp.asarray(t["hs"]).reshape(-1, 1, 1), jnp.asarray(t["w"]), jnp.asarray(t["gamma"]),
        jnp.asarray(t["beta"]), w_img=W_IMG)
    got = tf2.conv3x3_adain_residual_hifi2(
        *(torch.from_numpy(t[k]) for k in ("x", "h1", "h2", "hs", "w", "gamma", "beta")))
    assert got[2].shape == (2, 1) and got[2].dtype == torch.float32
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]).reshape(-1, 1), rtol=1e-5)
    _assert_int8_close(got[0].numpy(), _dense(want[0]))
    _assert_int8_close(got[1].numpy(), _dense(want[1]))
    assert np.abs(got[1].numpy()).max() > 100  # the second plane carries what the first rounds away


def test_hifi_int8_copy_is_quantized_from_the_rounded_carry():
    """The two sources the bf16 site must not swap. With a zero conv, hn is
    beta + h. (1) The int8 copy comes from the bf16 carry: hn = 100.7 is
    carried as 100.5, and under s = 1 its copy is round(100.5) = 100, not
    round(100.7) = 101. (2) amax comes from the fp32 hn: 300.9 is carried as
    300, and the copy of the carry 200 is round(200 * 127 / 300.9) = 84, not
    round(200 * 127 / 300) = 85."""
    c = 128
    x = torch.zeros((1, W_IMG, W_IMG, c), dtype=torch.int8)
    w = torch.zeros((9 * c, c), dtype=torch.int8)
    gamma, beta = torch.ones((1, c)), torch.zeros((1, c))

    def site(h0, h1, b0, b1):
        h = torch.zeros((1, W_IMG, W_IMG, c))
        h[..., 0], h[..., 1] = h0, h1
        beta[0, 0], beta[0, 1] = b0, b1
        q, carry = tf2.conv3x3_adain_residual_hifi(x, h.to(torch.bfloat16), w, gamma, beta)
        return [(float(carry[0, 3, 3, k]), int(q[0, 3, 3, k])) for k in (0, 1)]

    assert site(127.0, 100.0, 0.0, 0.7) == [(127.0, 127), (100.5, 100)]
    assert site(300.0, 199.0, 0.9, 0.9) == [(300.0, 127), (200.0, 84)]


# ------------------------------------------------ staged sites vs Pallas


def _unlayout_enc0(o, wc):
    """enc0 slab -> [B, 4wc, 4wc, 64]; lanes [by, bx][py, px][c] (tests/test_torch_port_enc.py)."""
    wp, srows, _, _, g, _ = jfe.enc_geometry(wc)
    o = np.asarray(o)
    t = o[:, g:g + srows].reshape(o.shape[0], wc, wp, o.shape[-1])[:, :, :wc]
    t = t.reshape(-1, wc, wc, 2, 2, 2, 2, 64)
    return t.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, 4 * wc, 4 * wc, 64)


def _enc0_pair(w_cells, stage, monkeypatch):
    rng = np.random.default_rng(w_cells)
    img = rng.integers(0, 256, (1, 4 * w_cells, 4 * w_cells, 3), dtype=np.uint8)
    w0 = rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8)
    monkeypatch.setenv("MSIG_STAGE_FP16", "1" if stage == "fp16" else "0")
    want = jfe._enc0_hbm(jfe.prep_s2d4_input(jnp.asarray(img)), jfe.pack_enc0(w0), 1e-5, w_cells)
    got = tfe.enc0_hbm(torch.from_numpy(img), tfe.pack_enc0(torch.from_numpy(w0)), stage=stage)
    return got.numpy(), _unlayout_enc0(want, w_cells)


def _up1_pair(w_cells, stage, monkeypatch):
    rng = np.random.default_rng(w_cells + 1)
    w_up0 = jnp.asarray(rng.integers(-127, 128, (4, 4, 256, 128), dtype=np.int8))
    w_up1 = rng.integers(-127, 128, (4, 4, 128, 64), dtype=np.int8)
    hq = jnp.asarray(rng.integers(-127, 128, (1, w_cells, w_cells, 256), dtype=np.int8))
    up0_ps, _ = jf2.pack_convt_weights_ps(w_up0, 256, 128)
    y0g, _ = jf2.convt4x4s2_in_relu_requant_ps(jf2.to_padded_rows(hq), up0_ps, jf2.PS_TAPS,
                                               w_cells, guarded_out=True)
    monkeypatch.setenv("MSIG_STAGE_FP16", "1" if stage == "fp16" else "0")
    want_q, want_s = jfd.up1_s2d16_hbm(y0g, jfd.pack_up1_s2d16(w_up1), w_cells=w_cells)
    g = jf2.guard_rows(w_cells)
    y0 = np.array(jf2.unphase_s2d(y0g[:, g:-g], w_cells, 128))
    got_q, got_s = tfd.up1_s2d16_hbm(
        torch.from_numpy(y0), tf2.pack_convt_weights_ps(torch.from_numpy(w_up1), 128, 64),
        stage=stage)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s).reshape(-1, 1), rtol=1e-5)
    return got_q.numpy(), np.asarray(jfd.unphase_s2d16(want_q, 64, w_cells=w_cells))


@pytest.mark.parametrize("stage", tf2.STAGES)
def test_enc0_hbm_plain_matches_pallas_64(stage, monkeypatch):
    """The staged pair on the 64-cell grid, int32 and fp16 x 2^-12 staging: int8
    within 1 step on < 1% (both sides narrow the same exact accumulator)."""
    _assert_int8_close(*_enc0_pair(64, stage, monkeypatch))


@pytest.mark.parametrize("stage", tf2.STAGES)
def test_up1_hbm_plain_matches_pallas_64(stage, monkeypatch):
    """As above for up1: int8 within 1 step on < 1%, inverse scale within rtol 1e-5."""
    _assert_int8_close(*_up1_pair(64, stage, monkeypatch))


@pytest.mark.slow
@pytest.mark.parametrize("site", ["enc0", "up1"])
def test_staged_site_plain_matches_pallas_128(site, monkeypatch):
    """One live cross-check per staged site on the 128-cell grid of a 512² input."""
    _assert_int8_close(*(_enc0_pair if site == "enc0" else _up1_pair)(128, "int32", monkeypatch))


def test_staged_int32_is_the_unstaged_arithmetic_and_fp16_is_not():
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8))
    w0 = tfe.pack_enc0(torch.from_numpy(rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8)))
    x = torch.from_numpy(rng.integers(0, 128, (1, 16, 16, 128), dtype=np.int8))
    w1 = tf2.pack_convt_weights_ps(
        torch.from_numpy(rng.integers(-127, 128, (4, 4, 128, 64), dtype=np.int8)), 128, 64)
    assert torch.equal(tfe.enc0_hbm(img, w0), tfe.enc0_in_relu_requant(img, w0))
    q32, s32 = tfd.up1_s2d16_hbm(x, w1)
    assert torch.equal(q32, tfd.up1_s2d16(x, w1)[0])
    q16, s16 = tfd.up1_s2d16_hbm(x, w1, stage="fp16")
    assert torch.equal(s16, s32)            # the statistics precede the narrowing
    diff = (q16.int() - q32.int()).abs()
    assert 0 < int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 0.10
    with pytest.raises(ValueError, match="stage must be one of"):
        tfd.up1_s2d16_hbm(x, w1, stage="fp32")
    with pytest.raises(ValueError, match="stage must be one of"):
        tfe.enc0_hbm(img, w0, stage=1)


# --------------------------------------------------- the trunk's hi-fi modes


@pytest.fixture(scope="module")
def trunk_inputs():
    jgen = JGenerator(style_dim=SDIM, n_residual_blocks=N_RES, dtype=jnp.bfloat16)
    params = jgen.init(jax.random.PRNGKey(4), jnp.zeros((1, 64, 64, 3), jnp.bfloat16),
                       jnp.zeros((1, SDIM), jnp.bfloat16))
    rng = np.random.default_rng(6)
    hq = rng.integers(0, 128, (2, W_IMG, W_IMG, 256), dtype=np.int8)
    hs = rng.uniform(0.02, 0.04, (2, 1)).astype(np.float32)
    style = rng.normal(0, 1, (2, SDIM)).astype(np.float32)
    return (jq.quantize_generator_params(params, N_RES),
            tq.quantize_generator_params(generator_state_dict(params, N_RES), N_RES),
            hq, hs, style)


@pytest.mark.parametrize("hifi", [1, 2])
def test_fused_trunk_rows_hifi_matches_jax(trunk_inputs, hifi, monkeypatch):
    """Two resblocks with the bf16 or the two-plane carry set up as
    msig_tpu/infer/quantized.py:220-245 sets them up: the trunk's int8 output
    within 1 step on < 1% of the elements."""
    jqp, q, hq, hs, style = trunk_inputs
    want = jq._fused_trunk_rows(jqp, jf2.to_padded_rows(jnp.asarray(hq)), jnp.asarray(hs),
                                jnp.asarray(style), N_RES, w_img=W_IMG, hifi=hifi)
    monkeypatch.setenv("MSIG_TRUNK_HIFI", str(hifi))
    got = tq._fused_trunk_rows(q, torch.from_numpy(hq), torch.from_numpy(hs),
                               torch.from_numpy(style), N_RES)
    _assert_int8_close(got.numpy(), _dense(want))
    monkeypatch.setenv("MSIG_TRUNK_HIFI", "0")
    stock = tq._fused_trunk_rows(q, torch.from_numpy(hq), torch.from_numpy(hs),
                                 torch.from_numpy(style), N_RES)
    assert not torch.equal(stock, got)


def test_trunk_carries_start_as_the_jax_function_starts_them(trunk_inputs, monkeypatch):
    """Mode 1 starts from the bf16 product int8 x scale (both factors bf16),
    mode 2 from a zero second plane under enc2's scale."""
    _, q, hq, hs, style = trunk_inputs
    seen = {}
    for name in ("conv3x3_adain_residual_hifi", "conv3x3_adain_residual_hifi2"):
        real = getattr(tq.fc, name)
        monkeypatch.setattr(tq.fc, name, lambda *a, _r=real, _n=name, **kw: (
            seen.setdefault(_n, a), _r(*a, **kw))[1])
    args = (q, torch.from_numpy(hq), torch.from_numpy(hs), torch.from_numpy(style), N_RES)
    monkeypatch.setenv("MSIG_TRUNK_HIFI", "1")
    tq._fused_trunk_rows(*args)
    hb = seen["conv3x3_adain_residual_hifi"][1]
    want = torch.from_numpy(hq).to(torch.bfloat16) * \
        torch.from_numpy(hs).reshape(-1, 1, 1, 1).to(torch.bfloat16)
    assert hb.dtype == torch.bfloat16 and torch.equal(hb, want)
    monkeypatch.setenv("MSIG_TRUNK_HIFI", "2")
    tq._fused_trunk_rows(*args)
    _, h1, h2, scale = seen["conv3x3_adain_residual_hifi2"][:4]
    assert torch.equal(h1, torch.from_numpy(hq)) and not h2.any() and h2.dtype == torch.int8
    assert torch.equal(scale, torch.from_numpy(hs))


# ------------------------------------------------- environment settings


@pytest.mark.parametrize("name,value", [
    ("MSIG_TRUNK_HIFI", "3"), ("MSIG_TRUNK_HIFI", "true"), ("MSIG_TRUNK_HIFI", ""),
    ("MSIG_STAGE_FP16", "2"), ("MSIG_STAGE_FP16", "yes"), ("MSIG_STAGE_FP16", "fp16"),
    ("MSIG_512_FUSED", "off"), ("MSIG_512_FUSED", "2"), ("MSIG_512_FUSED", ""),
])
def test_environment_settings_are_read_strictly(name, value, monkeypatch):
    """Anything but the documented values raises before any work is done (the
    JAX package reads a junk MSIG_TRUNK_HIFI as 1 and a junk flag as off)."""
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=name):
        tq.quantized_generator_apply({}, torch.zeros((1, 512, 512, 3), dtype=torch.uint8),
                                     torch.zeros((1, SDIM)))


def test_environment_settings_default_and_documented_values(monkeypatch):
    for name in ("MSIG_TRUNK_HIFI", "MSIG_STAGE_FP16"):
        monkeypatch.delenv(name, raising=False)
    assert (tq._trunk_hifi_mode(), tq._stage_mode()) == (0, "int32")
    for value, mode in (("0", 0), ("1", 1), ("2", 2)):
        monkeypatch.setenv("MSIG_TRUNK_HIFI", value)
        assert tq._trunk_hifi_mode() == mode
    for value, stage in (("0", "int32"), ("1", "fp16")):
        monkeypatch.setenv("MSIG_STAGE_FP16", value)
        assert tq._stage_mode() == stage


# --------------------------------------------- the two-word sum of squares


def _round_to_f32(t: int) -> float:
    """A non-negative Python integer rounded once to fp32, to nearest even."""
    excess = t.bit_length() - 24
    if excess <= 0:
        return float(t)
    q, rem, half = t >> excess, t & ((1 << excess) - 1), 1 << (excess - 1)
    q += rem > half or (rem == half and q & 1)
    return float(q) * 2.0 ** excess


def test_sum_of_squares_split_is_exact_past_one_int64_word():
    """A [2, 256, 256, 3] map of conv outputs near the trunk's extreme
    128 * 127 * 9 * 256: each channel's sum of squares is about 2^66, which one
    int64 wraps; the two words give the Python integer, and its fp32 value is
    the integer rounded once."""
    rng = np.random.default_rng(7)
    top = 128 * 127 * 9 * 256
    y = torch.from_numpy(rng.integers(top - 2 ** 20, top + 1, (2, 256, 256, 3)))
    y = y * torch.from_numpy(rng.choice([-1, 1], (2, 256, 256, 3)))
    exact = [[sum(v * v for v in y[b, :, :, c].flatten().tolist()) for c in range(3)]
             for b in range(2)]
    assert min(min(row) for row in exact) > 2 ** 65
    assert not torch.equal((y * y).sum(dim=(1, 2)), torch.tensor(exact, dtype=torch.float64).long())
    hi, lo = tf2.sumsq_words(y)
    assert [[(int(h) << 32) + int(l) for h, l in zip(hr, lr)]
            for hr, lr in zip(hi.tolist(), lo.tolist())] == exact
    got = tf2.words_to_f32(hi, lo)
    assert got.dtype == torch.float32
    assert got.tolist() == [[_round_to_f32(t) for t in row] for row in exact]


def test_words_to_f32_rounds_once():
    """Random integers up to 2^93 and the halfway cases around them, given as
    words whose low part may itself pass 2^32: every one equals the integer
    rounded once to nearest even, where a route through float64 would differ."""
    rnd = random.Random(0)
    totals, his, los = [], [], []
    for i in range(20000):
        bits = rnd.randint(0, 93)
        t = rnd.getrandbits(bits) if bits else 0
        if i % 3 == 0 and bits > 30:
            cut = bits - 24
            t = (t >> cut << cut) + (1 << (cut - 1)) + rnd.choice([-1, 0, 1])
        lo = t & 0xFFFFFFFF
        extra = rnd.getrandbits(rnd.randint(0, 30)) << 32
        if extra <= t - lo:
            lo += extra
        totals.append(t), his.append((t - lo) >> 32), los.append(lo)
    got = tf2.words_to_f32(torch.tensor(his), torch.tensor(los)).double().numpy()
    want = np.array([_round_to_f32(t) for t in totals])
    np.testing.assert_array_equal(got, want)
    twice = np.array([float(np.float32(float(t))) for t in totals])
    assert (twice != want).sum() > 100


def test_channel_affine_on_a_map_past_one_word_matches_python_integers():
    """The plain version's affine at 2^66: var = sumsq/n - mean^2 from the
    single-rounded sums, in fp32, against the same formula on Python integers."""
    rng = np.random.default_rng(8)
    top = 128 * 127 * 9 * 256
    y = torch.from_numpy(rng.integers(-top, top + 1, (1, 256, 256, 2)))
    a, d = tf2._channel_affine(y, torch.ones((1, 2)), torch.zeros((1, 2)), 1e-5)
    n = np.float32(256 * 256)
    for c in range(2):
        vals = y[0, :, :, c].flatten().tolist()
        mean = np.float32(_round_to_f32(abs(sum(vals)))) * np.float32(np.sign(sum(vals))) / n
        var = np.float32(_round_to_f32(sum(v * v for v in vals))) / n - mean * mean
        want = np.float32(1.0) / np.sqrt(var + np.float32(1e-5))
        np.testing.assert_allclose(float(a[0, c]), want, rtol=1e-6)
        np.testing.assert_allclose(float(d[0, c]), -mean * want, rtol=1e-6, atol=1e-12)


# ------------------------------------------------ which chain, which sites


_ALL_KERNELS = ["_fused_encoder", "_fused_trunk_rows", "_fused_decoder"]
_TRUNK_ONLY = ["_xla_encoder", "_fused_trunk", "_xla_decoder"]
_UNFUSED = ["_xla_encoder", "_xla_trunk", "_xla_decoder"]


@pytest.mark.parametrize("side,out_dtype,fused_512,chain", [
    (256, torch.uint8, "1", _ALL_KERNELS), (256, torch.float32, "1", _ALL_KERNELS),
    (256, torch.uint8, "0", _ALL_KERNELS),
    (512, torch.uint8, "1", _ALL_KERNELS), (512, torch.uint8, None, _ALL_KERNELS),
    (512, torch.float32, "1", _TRUNK_ONLY), (512, torch.uint8, "0", _TRUNK_ONLY),
    (384, torch.uint8, "1", _UNFUSED), (1024, torch.uint8, "1", _UNFUSED),
])
def test_chain_is_chosen_by_size_and_output_type(side, out_dtype, fused_512, chain, monkeypatch):
    """msig_tpu/infer/quantized.py:352-400: 256² all-kernel; 512² all-kernel for
    uint8 output unless MSIG_512_FUSED=0, else ``pallas=("trunk",)``; other
    sizes the unfused chain throughout (``_xla_trunk``)."""
    calls = []
    hq = torch.zeros((1, 1, 1, 1), dtype=torch.int8)

    def fake(name, result):
        return lambda *args: calls.append(name) or result

    monkeypatch.setattr(tq, "_xla_encoder", fake("_xla_encoder", hq.to(torch.bfloat16)))
    monkeypatch.setattr(tq, "_fused_encoder", fake("_fused_encoder", (hq, torch.ones((1, 1)))))
    for name in ("_fused_trunk", "_fused_trunk_rows", "_xla_trunk"):
        monkeypatch.setattr(tq, name, fake(name, hq))
    for name in ("_xla_decoder", "_fused_decoder"):
        monkeypatch.setattr(tq, name, fake(name, None))
    if fused_512 is None:
        monkeypatch.delenv("MSIG_512_FUSED", raising=False)
    else:
        monkeypatch.setenv("MSIG_512_FUSED", fused_512)
    tq.quantized_generator_apply({}, torch.zeros((1, side, side, 3), dtype=torch.uint8),
                                 torch.zeros((1, SDIM)), out_dtype=out_dtype)
    assert calls == chain


@pytest.mark.parametrize("side,fp16,enc0,up1", [
    (256, "0", "enc0_in_relu_requant", "up1_s2d16"),
    (256, "1", "enc0_in_relu_requant", "up1_s2d16"),
    (512, "0", "enc0_hbm:int32", "up1_s2d16_hbm:int32"),
    (512, "1", "enc0_hbm:fp16", "up1_s2d16_hbm:fp16"),
])
def test_staged_sites_are_chosen_by_the_cell_grid(side, fp16, enc0, up1, monkeypatch):
    """Wider than 64 cells, enc0 and up1 are the staged sites
    (msig_tpu/ops/fused_enc_int8.py:617, msig_tpu/infer/quantized.py:308), with
    the staging MSIG_STAGE_FP16 names; up to 64 cells the setting is not used."""
    calls = []
    small = torch.zeros((1, side // 4, side // 4, 1), dtype=torch.int8)
    monkeypatch.setenv("MSIG_STAGE_FP16", fp16)
    monkeypatch.setattr(tq.fe, "enc0_in_relu_requant",
                        lambda *a: calls.append("enc0_in_relu_requant") or small)
    monkeypatch.setattr(tq.fe, "enc0_hbm",
                        lambda *a, stage: calls.append(f"enc0_hbm:{stage}") or small)
    monkeypatch.setattr(tq.fe, "enc1_in_relu_requant", lambda *a, **k: small)
    monkeypatch.setattr(tq.fe, "enc2_in_relu_requant", lambda *a, **k: (small, None))
    monkeypatch.setattr(tq.fc, "convt4x4s2_in_relu_requant_ps", lambda *a, **k: (small, None))
    monkeypatch.setattr(tq.fd, "up1_s2d16",
                        lambda *a, **k: calls.append("up1_s2d16") or (small, None))
    monkeypatch.setattr(tq.fd, "up1_s2d16_hbm", lambda *a, stage, **k: calls.append(
        f"up1_s2d16_hbm:{stage}") or (small, None))
    monkeypatch.setattr(tq.fd, "final7_tanh_u8", lambda *a, **k: None)
    q = dict.fromkeys(("enc0_p", "enc1_p", "enc2_p", "up0_ps", "up1_ps", "out_kernel_i8",
                       "out_wscale", "out_bias"))
    tq._fused_encoder(q, torch.zeros((1, side, side, 3), dtype=torch.uint8))
    tq._fused_decoder(q, small, torch.uint8)
    assert calls == [enc0, up1]


def test_generator_512_runs_the_staged_sites_end_to_end(monkeypatch):
    """The entry point at 512² on the CPU, one resblock cut to its call order:
    the trunk's sites are replaced by pass-throughs (their parity is held
    above and in tests/test_torch_port_ops.py), the encoder and decoder run
    their plain versions at full size, staged sites included."""
    jgen = JGenerator(style_dim=SDIM, n_residual_blocks=1, dtype=jnp.bfloat16)
    params = jgen.init(jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 3), jnp.bfloat16),
                       jnp.zeros((1, SDIM), jnp.bfloat16))
    q = tq.quantize_generator_params(generator_state_dict(params, 1), 1)
    seen = []
    for mod, name in ((tq.fe, "enc0_hbm"), (tq.fe, "enc0_in_relu_requant"),
                      (tq.fd, "up1_s2d16_hbm"), (tq.fd, "up1_s2d16")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            seen.append((_n, tuple(a[0].shape), k)), _r(*a, **k))[1])
    monkeypatch.setattr(tq.fc, "conv3x3_adain_relu_requant", lambda x, *a, **k: x)
    monkeypatch.setattr(tq.fc, "conv3x3_adain_residual_requant",
                        lambda y1, h, hs, *a, **k: (h, hs))
    img = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (1, 512, 512, 3),
                                                             dtype=np.uint8))
    out = tq.quantized_generator_apply(q, img, torch.zeros((1, SDIM)), n_res=1,
                                       out_dtype=torch.uint8)
    assert out.dtype == torch.uint8 and out.shape == (1, 512, 512, 3)
    assert len(np.unique(out.numpy())) > 50
    # up1 gets its K-major weight copy (the ConvT sites' w_kmajor)
    assert seen[1][2].pop("w_kmajor") is q["up1_ps_pk"]
    assert seen == [("enc0_hbm", (1, 512, 512, 3), {"stage": "int32"}),
                    ("up1_s2d16_hbm", (1, 256, 256, 128), {"stage": "int32"})]
