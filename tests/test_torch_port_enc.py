"""Parity of the port's int8 encoder slice with the JAX package.

The encoder's three kernel sites (enc0 conv7, enc1 and enc2 conv 4x4/s2, each
with IN + ReLU + requant), the fused encoder as a whole, the int8 generator at
256² in the all-kernel composition ``pallas=("enc", "trunk", "dec")``, and
``quantized_generator_apply_staged`` in all eight compositions. The JAX side
runs eagerly on the CPU with its Pallas kernels in interpret mode, and its
slabs are unpacked to dense NHWC as tests/test_fused_enc_int8.py unpacks them;
the port runs its kernels' plain versions (the CUDA kernels are held against
those on the card: tests/test_torch_port_cuda.py, chip_smoke.py). Each site is
fed the JAX kernel's own output of the site before it, so roundings do not
compound.
"""

import functools
import itertools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msig_tpu.infer import quantized as jq
from msig_tpu.infer.loading import _load_npz
from msig_tpu.models import StyleCycleGANGenerator as JGenerator
from msig_tpu.ops import fused_enc_int8 as jfe
from msig_tpu_torch.compat.from_jax import generator_state_dict
from msig_tpu_torch.infer import quantized as tq
from msig_tpu_torch.ops import _build
from msig_tpu_torch.ops import fused_enc_int8 as tfe

N_RES, SDIM = 1, 64
DEMO = "results/tomato_r3b/demo_checkpoint"
SUBSETS = [tuple(s for s, keep in zip(tq.ALL_STAGES, mask) if keep)
           for mask in itertools.product((False, True), repeat=3)]


@pytest.fixture(scope="module")
def jparams():
    """One random generator at full width, JAX parameters."""
    jgen = JGenerator(style_dim=SDIM, n_residual_blocks=N_RES, dtype=jnp.bfloat16)
    return jgen.init(jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3), jnp.bfloat16),
                     jnp.zeros((1, SDIM), jnp.bfloat16))


@pytest.fixture(scope="module")
def qparams(jparams):
    """int8 weights of one random generator at full width, in both packages."""
    return (jq.quantize_generator_params(jparams, N_RES),
            tq.quantize_generator_params(generator_state_dict(jparams, N_RES), N_RES))


# ------------------------------------------------- unpacking the JAX slabs


def _body(o, w_cells):
    """Slab [B, g + w_cells*(w_cells+8) + g, L] -> the grid's cells [B, w_cells, w_cells, L]."""
    wp, srows, _, _, g, _ = jfe.enc_geometry(w_cells)
    o = np.asarray(o)
    return o[:, g:g + srows].reshape(o.shape[0], w_cells, wp, o.shape[-1])[:, :, :w_cells]


def _unlayout_enc0(o, wc):
    """enc0 slab -> [B, 4wc, 4wc, 64]; lanes [by, bx][py, px][c], pixel (4I + 2by + py, ...)."""
    t = _body(o, wc).reshape(-1, wc, wc, 2, 2, 2, 2, 64)
    return t.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, 4 * wc, 4 * wc, 64)


def _unlayout_enc1(o, wc):
    """enc1 slab -> [B, 2wc, 2wc, 128]; lanes [by, bx][c]."""
    t = _body(o, wc).reshape(-1, wc, wc, 2, 2, 128)
    return t.transpose(0, 1, 3, 2, 4, 5).reshape(-1, 2 * wc, 2 * wc, 128)


@functools.lru_cache(maxsize=None)
def _jax_chain(w_cells):
    """The JAX encoder kernels on a seeded image of (4*w_cells)², in chain order,
    each output unpacked to dense NHWC; batch 2 on the 16-cell grid, 1 on the 64-cell."""
    rng = np.random.default_rng(w_cells)
    b = 2 if w_cells < 64 else 1
    img = rng.integers(0, 256, (b, 4 * w_cells, 4 * w_cells, 3), dtype=np.uint8)
    w0 = rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8)
    w1 = rng.integers(-127, 128, (4, 4, 64, 128), dtype=np.int8)
    w2 = rng.integers(-127, 128, (4, 4, 128, 256), dtype=np.int8)
    h0 = jfe.enc0_in_relu_requant(jfe.prep_s2d4_input(jnp.asarray(img)), jfe.pack_enc0(w0),
                                  w_cells=w_cells)
    h1 = jfe.enc1_in_relu_requant(h0, jfe.pack_enc1(w1), w_cells=w_cells)
    h1_i2c = jfe.enc1_in_relu_requant_im2col(h0, jfe.pack_enc1_im2col(w1), w_cells=w_cells)
    h2, s2 = jfe.enc2_in_relu_requant(h1, jfe.pack_enc2(w2), w_cells=w_cells)
    return dict(img=img, w0=w0, w1=w1, w2=w2, h0=_unlayout_enc0(h0, w_cells),
                h1=_unlayout_enc1(h1, w_cells), h1_i2c=_unlayout_enc1(h1_i2c, w_cells),
                h2=_body(h2, w_cells), s2=np.asarray(s2).reshape(-1, 1))


def _assert_int8_close(got, want):
    """tests/test_fused_enc_int8.py:84."""
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


# ------------------------------------------------------------- weights


def test_enc2_pack_bit_equal_to_jax(qparams):
    jqp, q = qparams
    np.testing.assert_array_equal(q["enc2_p"].numpy(), np.asarray(jqp["enc2_p"]))


@pytest.mark.parametrize("phase", range(4))
def test_enc1_pack_equals_each_im2col_phase_block(qparams, phase):
    jqp, q = qparams
    want = np.asarray(jfe.pack_enc1_im2col(np.asarray(jqp["enc_conv1"])))
    assert q["enc1_p"].shape == (1024, 128)
    np.testing.assert_array_equal(q["enc1_p"].numpy(), want[1024 * phase:1024 * (phase + 1)])


def test_enc0_pack_rows_and_zero_padding(qparams):
    jqp, q = qparams
    w = np.asarray(jqp["enc_conv0"])
    assert q["enc0_p"].shape == (160, 64) and q["enc0_p"].dtype == torch.int8
    np.testing.assert_array_equal(q["enc0_p"][:147].numpy(), w.reshape(147, 64))
    assert not q["enc0_p"][147:].any()
    u, v, ci = 5, 2, 1
    np.testing.assert_array_equal(q["enc0_p"][(u * 7 + v) * 3 + ci].numpy(), w[u, v, ci])


def test_packs_reject_other_kernels():
    with pytest.raises(ValueError, match=r"\[7, 7, 3, 64\]"):
        tfe.pack_enc0(torch.zeros((7, 7, 64, 3), dtype=torch.int8))
    with pytest.raises(ValueError, match=r"\[4, 4, Cin, Cout\]"):
        tfe.pack_conv4x4(torch.zeros((3, 3, 64, 64), dtype=torch.int8))


# --------------------------------------------- the exact convs, plain torch


def test_enc0_conv_matches_conv2d_on_reflection_pad():
    """Tap order, recentring and reflection of the plain conv, on a map that is
    neither square nor symmetric."""
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.integers(0, 256, (2, 9, 12, 3), dtype=np.uint8))
    w = torch.from_numpy(rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8))
    x = (img.to(torch.int32) - 128).permute(0, 3, 1, 2).double()
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x, (3, 3, 3, 3), mode="reflect"), w.permute(3, 2, 0, 1).double())
    got = tfe.enc0_i64(img, tfe.pack_enc0(w))
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1).long(), rtol=0, atol=0)


@pytest.mark.parametrize("cin,cout", [(64, 128), (128, 256)])
def test_conv4x4s2_matches_conv_i8(cin, cout):
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 10, 14, cin), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (4, 4, cin, cout), dtype=np.int8))
    want = tq._conv_i8(x, w.permute(3, 2, 0, 1), 2, 1)
    got = tfe.conv4x4s2_i64(x, tfe.pack_conv4x4(w))
    assert got.shape == (2, 5, 7, cout)
    torch.testing.assert_close(got, want.long(), rtol=0, atol=0)


# ---------------------------------------------------- sites vs Pallas


@pytest.mark.parametrize("w_cells", [16, 64])
@pytest.mark.parametrize("site", ["enc0", "enc1", "enc2"])
def test_site_plain_matches_pallas(site, w_cells):
    c = _jax_chain(w_cells)
    if site == "enc0":
        got = tfe.enc0_in_relu_requant(torch.from_numpy(c["img"]),
                                       tfe.pack_enc0(torch.from_numpy(c["w0"])))
        _assert_int8_close(got.numpy(), c["h0"])
    elif site == "enc1":
        got = tfe.enc1_in_relu_requant(torch.from_numpy(c["h0"]),
                                       tfe.pack_conv4x4(torch.from_numpy(c["w1"])))
        _assert_int8_close(got.numpy(), c["h1"])
    else:
        got, got_s = tfe.enc2_in_relu_requant(torch.from_numpy(c["h1"]),
                                              tfe.pack_conv4x4(torch.from_numpy(c["w2"])))
        assert got_s.dtype == torch.float32 and got_s.shape == c["s2"].shape
        np.testing.assert_allclose(got_s.numpy(), c["s2"], rtol=1e-5)
        _assert_int8_close(got.numpy(), c["h2"])


def test_enc1_plain_matches_im2col_pallas():
    """The dense K = 1024 form (``enc1_in_relu_requant_im2col``) computes the
    function of the phase-packed site, which is the port's one enc1."""
    c = _jax_chain(16)
    np.testing.assert_array_equal(c["h1_i2c"], c["h1"])
    got = tfe.enc1_in_relu_requant(torch.from_numpy(c["h0"]),
                                   tfe.pack_conv4x4(torch.from_numpy(c["w1"])))
    _assert_int8_close(got.numpy(), c["h1_i2c"])


# ------------------------------------- enc1 in its dense K = 1024 form


@pytest.mark.parametrize("w_cells", [16, 64])
def test_enc1_im2col_plain_matches_pallas(w_cells):
    """``enc1_in_relu_requant_im2col`` against its Pallas kernel, on the output
    of the JAX enc0 and the packing of ``pack_enc1_im2col``."""
    c = _jax_chain(w_cells)
    w = tfe.pack_enc1_im2col(torch.from_numpy(c["w1"]))
    got = tfe.enc1_in_relu_requant_im2col(torch.from_numpy(c["h0"]), w)
    _assert_int8_close(got.numpy(), c["h1_i2c"])
    # with four equal phase blocks, enc1's function to the bit
    want = tfe.enc1_in_relu_requant(torch.from_numpy(c["h0"]),
                                    tfe.pack_conv4x4(torch.from_numpy(c["w1"])))
    assert torch.equal(got, want)


def test_enc1_im2col_phase_blocks_follow_jax():
    """Four different weight blocks: block q = 2*qy + qx must serve the output
    pixels (2I + qy, 2J + qx), as ``_enc1_phase_slices`` maps them."""
    c = _jax_chain(16)
    rng = np.random.default_rng(11)
    slab = np.concatenate([np.asarray(jfe.pack_enc1_im2col(
        rng.integers(-127, 128, (4, 4, 64, 128), dtype=np.int8)))[1024 * q:1024 * (q + 1)]
        for q in range(4)])
    h0 = jfe.enc0_in_relu_requant(jfe.prep_s2d4_input(jnp.asarray(c["img"])),
                                  jfe.pack_enc0(c["w0"]), w_cells=16)
    want = _unlayout_enc1(jfe.enc1_in_relu_requant_im2col(h0, jnp.asarray(slab), w_cells=16), 16)
    np.testing.assert_array_equal(_unlayout_enc0(h0, 16), c["h0"])
    got = tfe.enc1_in_relu_requant_im2col(torch.from_numpy(c["h0"]), torch.from_numpy(slab))
    _assert_int8_close(got.numpy(), want)
    one_block = tfe.enc1_in_relu_requant_im2col(
        torch.from_numpy(c["h0"]), torch.from_numpy(np.tile(slab[:1024], (4, 1))))
    assert (one_block.numpy() != want).mean() > 0.1


def test_enc1_i2c_p_bit_equal_to_jax(jparams, monkeypatch):
    monkeypatch.setenv("MSIG_ENC1_IM2COL", "1")
    want = np.asarray(jq.quantize_generator_params(jparams, N_RES)["enc1_i2c_p"])
    q = tq.quantize_generator_params(generator_state_dict(jparams, N_RES), N_RES)
    assert q["enc1_i2c_p"].shape == (4096, 128) == want.shape
    np.testing.assert_array_equal(q["enc1_i2c_p"].numpy(), want)


@pytest.mark.parametrize("side", [64, 256])
def test_fused_encoder_takes_enc1_im2col_under_the_flag(jparams, monkeypatch, side):
    """Weights built under the flag and the flag set when the encoder runs:
    enc1 is the dense site, and the encoder's output and scale are those of
    the phase-packed one to the bit. Set after quantization, the flag changes
    nothing (``quantized.py:280``)."""
    q = tq.quantize_generator_params(generator_state_dict(jparams, N_RES), N_RES)
    monkeypatch.setenv("MSIG_ENC1_IM2COL", "1")
    q_i2c = tq.quantize_generator_params(generator_state_dict(jparams, N_RES), N_RES)
    img = torch.from_numpy(np.random.default_rng(side).integers(0, 256, (1, side, side, 3),
                                                                dtype=np.uint8))
    calls = []
    for name in ("enc1_in_relu_requant", "enc1_in_relu_requant_im2col"):
        real = getattr(tfe, name)
        monkeypatch.setattr(tfe, name, lambda *a, real=real, name=name, **k: calls.append(name)
                            or real(*a, **k))
    got_q, got_s = tq._fused_encoder(q_i2c, img)
    assert calls == ["enc1_in_relu_requant_im2col"]
    want_q, want_s = tq._fused_encoder(q, img)
    assert calls[1:] == ["enc1_in_relu_requant"]
    assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)


@pytest.mark.parametrize("value", ["true", "2"])
def test_enc1_im2col_junk_values_raise(monkeypatch, value):
    """The JAX package reads them as off; here they raise."""
    monkeypatch.setenv("MSIG_ENC1_IM2COL", value)
    with pytest.raises(ValueError, match="MSIG_ENC1_IM2COL"):
        tq.quantize_generator_params({}, 1)


def test_enc1_im2col_wrapper_raises_without_nvcc_or_on_bad_shapes(monkeypatch):
    with pytest.raises(ValueError, match="Cin == 64"):
        tfe.enc1_in_relu_requant_im2col(_fake_cuda((1, 256, 256, 128), torch.int8),
                                        _fake_cuda((8192, 128), torch.int8))
    with pytest.raises(ValueError, match=r"\(H/4\)\*\(W/4\) % 128"):
        tfe.enc1_in_relu_requant_im2col(_fake_cuda((1, 32, 32, 64), torch.int8),
                                        _fake_cuda((4096, 128), torch.int8))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "library_path", lambda name: mock.Mock(exists=lambda: False))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    monkeypatch.setenv("NVCC", "")
    tfe.reset_launch_counts()
    with mock.patch.object(tfe, "enc1_in_relu_requant_im2col_plain") as plain:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tfe.enc1_in_relu_requant_im2col(_fake_cuda((8, 256, 256, 64), torch.int8),
                                            _fake_cuda((4096, 128), torch.int8))
        plain.assert_not_called()
    assert set(tfe.LAUNCHES.values()) == {0}


# ------------------------------------------------ the encoder, the slice


def test_fused_encoder_matches_jax_on_demo_weights():
    """The three sites chained. On the same input each site's scale agrees to
    rtol 1e-5 (above); chained, a few one-step flips out of enc0 (from the
    fp32 statistics' summation order) reach enc1 and enc2, whose amax is
    the affine image of a channel's extreme conv outputs, so enc2's scale
    moves by ~1.5e-4: the chain's scale bar is rtol 1e-3."""
    gen, _, meta, _ = _load_npz(DEMO, 10)
    n_res = meta["n_residual_blocks"]
    jqp = jq.quantize_generator_params(gen, n_res)
    q = tq.quantize_generator_params(generator_state_dict(gen, n_res), n_res)
    img = np.random.default_rng(6).integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)
    want_q, want_s = jq._fused_encoder(jqp, jnp.asarray(img))
    got_q, got_s = tq._fused_encoder(q, torch.from_numpy(img))
    assert got_q.shape == (1, 64, 64, 256) and got_s.shape == (1, 1)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-3)
    _assert_int8_close(got_q.numpy(), _body(want_q, 64))


@pytest.fixture(scope="module")
def gen_inputs():
    rng = np.random.default_rng(3)
    return (rng.integers(0, 256, (1, 256, 256, 3), dtype=np.uint8),
            rng.normal(0, 1, (1, SDIM)).astype(np.float32))


def test_generator_256_matches_jax_all_kernels(qparams, gen_inputs):
    """The served composition at 256². No bf16 step is left between image and
    trunk, but the chains still part at enc0: the TPU kernel sums its IN
    statistics in fp32 chunk by chunk, the port exactly, so a few of enc0's
    4.2 M int8 codes flip by one step, ~1e-3 of the trunk's input codes after
    enc2, and the trunk and decoder spread each flip over its receptive
    field. From the same encoder output the rest of the chain is within 1 on
    99.99% of pixels; end to end the share is 76.4%, so the bar is PSNR, and
    the share is pinned at what holds."""
    jqp, q = qparams
    img, style = gen_inputs
    want = np.asarray(jq.quantized_generator_apply_staged(
        jqp, jnp.asarray(img), jnp.asarray(style), n_res=N_RES, out_dtype=jnp.uint8,
        pallas=("enc", "trunk", "dec")))
    tfe.reset_launch_counts()
    got = tq.quantized_generator_apply(q, torch.from_numpy(img), torch.from_numpy(style),
                                       n_res=N_RES, out_dtype=torch.uint8).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (1, 256, 256, 3)
    assert _psnr(got, want) >= 40.0
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (diff <= 1).mean() >= 0.70, (diff <= 1).mean()
    assert (diff <= 2).mean() >= 0.90, (diff <= 2).mean()
    assert set(tfe.LAUNCHES.values()) == {0}  # CPU tensors: the plain versions


def test_trunk_and_decoder_within_1_on_jax_encoder_output(qparams, gen_inputs):
    """Where the chains part is the encoder's statistics, not what follows:
    given the JAX encoder's int8 map and scale, trunk and decoder agree."""
    jqp, q = qparams
    img, style = gen_inputs
    hq_rows, hs = jq._fused_encoder(jqp, jnp.asarray(img))
    rows = jq._fused_trunk_rows(jqp, hq_rows, hs, jnp.asarray(style), N_RES, w_img=64)
    want = np.asarray(jq._fused_decoder(jqp, rows, jnp.uint8, w_cells=64))
    hq = tq._fused_trunk_rows(q, torch.from_numpy(_body(hq_rows, 64).copy()),
                              torch.from_numpy(np.array(hs).reshape(-1, 1)),
                              torch.from_numpy(style), N_RES)
    _assert_int8_close(hq.numpy(), _body(rows, 64))
    got = tq._fused_decoder(q, hq, torch.uint8).numpy()
    assert (np.abs(got.astype(np.int32) - want.astype(np.int32)) <= 1).mean() >= 0.999


@pytest.mark.parametrize("pallas", SUBSETS, ids=lambda p: "+".join(p) or "none")
def test_staged_matches_jax(qparams, gen_inputs, pallas):
    jqp, q = qparams
    img, style = gen_inputs
    want = np.asarray(jq.quantized_generator_apply_staged(
        jqp, jnp.asarray(img), jnp.asarray(style), n_res=N_RES, out_dtype=jnp.uint8,
        pallas=pallas))
    got = tq.quantized_generator_apply_staged(q, torch.from_numpy(img), torch.from_numpy(style),
                                              n_res=N_RES, out_dtype=torch.uint8,
                                              pallas=pallas).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (1, 256, 256, 3)
    assert _psnr(got, want) >= 40.0


def test_staged_refuses_unknown_stage():
    with pytest.raises(ValueError, match="unknown stages"):
        tq.quantized_generator_apply_staged({}, torch.zeros((1, 64, 64, 3), dtype=torch.uint8),
                                            torch.zeros((1, SDIM)), pallas=("encoder",))


def test_encoder_hands_trunk_enc2_scale_without_requant(qparams, monkeypatch):
    """The all-kernel chain passes enc2's int8 map and inverse scale straight
    to the trunk's first residual site."""
    _, q = qparams
    img = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (1, 64, 64, 3),
                                                              dtype=np.uint8))
    hq, hs = tq._fused_encoder(q, img)
    seen = []
    real = tq.fc.conv3x3_adain_residual_requant
    monkeypatch.setattr(tq.fc, "conv3x3_adain_residual_requant",
                        lambda y1, h, s, *a, **k: seen.append((h, s)) or real(y1, h, s, *a, **k))
    monkeypatch.setattr(tq, "_requant_with_inv_scale", mock.Mock(side_effect=AssertionError))
    tq.quantized_generator_apply_staged(q, img, torch.zeros((1, SDIM)), n_res=N_RES,
                                        out_dtype=torch.uint8, pallas=tq.ALL_STAGES)
    assert len(seen) == N_RES
    assert torch.equal(seen[0][0], hq) and torch.equal(seen[0][1], hs)


# ---------------------------------------------------- no silent fallback


def test_cpu_wrappers_count_no_launches():
    c = _jax_chain(16)
    tfe.reset_launch_counts()
    tfe.enc0_in_relu_requant(torch.from_numpy(c["img"][:, :16, :16]).contiguous(),
                             tfe.pack_enc0(torch.from_numpy(c["w0"])))
    x = torch.from_numpy(c["h0"][:, :16, :16]).contiguous()
    tfe.enc1_in_relu_requant(x, tfe.pack_conv4x4(torch.from_numpy(c["w1"])))
    tfe.enc2_in_relu_requant(x, tfe.pack_conv4x4(torch.from_numpy(c["w1"])))
    assert tfe.LAUNCHES == {tfe.ENC0_SITE: 0, tfe.ENC0_HBM_SITE: 0, tfe.ENC1_SITE: 0,
                            tfe.ENC1_I2C_SITE: 0, tfe.ENC2_SITE: 0}


def _fake_cuda(shape, dtype):
    t = mock.Mock(spec=torch.Tensor)
    t.device, t.dtype, t.shape = torch.device("cuda", 0), dtype, torch.Size(shape)
    t.dim.return_value = len(shape)
    t.is_contiguous.return_value = True
    return t


def _call_site(site, make, b=2, side=256):
    if site == "enc0":
        return tfe.enc0_in_relu_requant(make((b, side, side, 3), torch.uint8),
                                        make((160, 64), torch.int8))
    if site == "enc1":
        return tfe.enc1_in_relu_requant(make((b, side, side, 64), torch.int8),
                                        make((1024, 128), torch.int8))
    return tfe.enc2_in_relu_requant(make((b, side // 2, side // 2, 128), torch.int8),
                                    make((2048, 256), torch.int8))


@pytest.mark.parametrize("site", ["enc0", "enc1", "enc2"])
def test_cuda_tensor_without_nvcc_raises(site, monkeypatch):
    """A CUDA tensor launches the kernel or raises: with no build, it raises."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "library_path", lambda name: mock.Mock(exists=lambda: False))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    monkeypatch.setenv("NVCC", "")
    tfe.reset_launch_counts()
    with mock.patch.object(tfe, "enc0_in_relu_requant_plain") as p0, \
            mock.patch.object(tfe, "enc1_in_relu_requant_plain") as p1, \
            mock.patch.object(tfe, "enc2_in_relu_requant_plain") as p2:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _call_site(site, _fake_cuda)
        for plain in (p0, p1, p2):
            plain.assert_not_called()
    assert set(tfe.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("site", ["enc0", "enc1", "enc2"])
def test_non_cuda_device_raises(site):
    with pytest.raises(ValueError, match="CUDA tensor"):
        _call_site(site, lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta"),
                   b=1, side=64)


@pytest.mark.parametrize("site,shape,match", [
    ("enc0", (1, 260, 256, 3), "H % 8"),
    ("enc0", (1, 256, 256, 4), "C == 3"),
    ("enc1", (1, 30, 32, 64), r"\(H/2\)\*\(W/2\) % 128"),
    ("enc1", (1, 64, 64, 32), "Cin % 64"),
])
def test_shapes_the_kernels_do_not_take_raise(site, shape, match):
    w = (160, 64) if site == "enc0" else (16 * shape[-1], 128)
    fn = tfe.enc0_in_relu_requant if site == "enc0" else tfe.enc1_in_relu_requant
    with pytest.raises(ValueError, match=match):
        fn(_fake_cuda(shape, torch.uint8 if site == "enc0" else torch.int8),
           _fake_cuda(w, torch.int8))


def test_int64_statistics_guard(monkeypatch):
    """Exact integers (max |y| = 128 * 127 * K per output): a 512² enc1 passes
    one int64 word for the sum of squares and is taken all the same, since
    the sum is kept in two words; the guard holds max |y| below 2^29 and the
    sum below 2^94, which every site's maps of a 1024² input meet."""
    assert 256 * 256 * (128 * 127 * 16 * 64) ** 2 >= 2 ** 63
    for n_out, k in ((1024 * 1024, 147), (512 * 512, 16 * 64), (256 * 256, 16 * 128),
                     (256 * 256, 9 * 256), (512 * 512, 4 * 256), (1024 * 1024, 4 * 128)):
        assert 128 * 127 * k < 2 ** 29 and n_out * (128 * 127 * k) ** 2 < 2 ** 94
        tfe.fc.check_statistics((1, 1, n_out, k), n_out, k)
    launched = []
    monkeypatch.setattr(_build, "load", lambda name, _: launched.append(name) or (lambda *a: 0))
    monkeypatch.setattr(tfe.fc, "_scratch", lambda *a: (mock.Mock(), mock.Mock()))
    monkeypatch.setattr(torch, "empty", lambda *a, **k: mock.Mock())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda _: mock.Mock(cuda_stream=0))
    tfe.enc1_in_relu_requant(_fake_cuda((1, 512, 512, 64), torch.int8),
                             _fake_cuda((1024, 128), torch.int8))
    assert launched == [tfe.CONV_S2_SOURCE]
    # max |y| reaches 2^29 at K = 33027; the sum reaches 2^94 first on no real map.
    tfe.fc.check_statistics((1,), 1, 33026)
    for n_out, k in ((1, 33027), (2 ** 38, 33026)):
        with pytest.raises(ValueError, match="too large for the exact two-word statistics"):
            tfe.fc.check_statistics((1,), n_out, k)
    with pytest.raises(ValueError, match="too large for the exact two-word statistics"):
        tfe.enc1_in_relu_requant(_fake_cuda((1, 64, 64, 2112), torch.int8),
                                 _fake_cuda((16 * 2112, 128), torch.int8))
