"""Parity of the port's int8 serving slice, style modes and loading with the JAX package.

(d) the int8 path end to end against
``quantized_generator_apply_staged(..., pallas=("trunk",))`` on random
weights at 64², with the JAX trunk kernels in interpret mode and the port's
wrappers on their plain versions, and where the two packages part; (f) the
style modes, the random ones fed the draws ``jax.random`` makes. JAX runs
eagerly throughout: under ``jax.jit`` XLA keeps ``_requant``'s product
``x * scale`` in fp32 instead of rounding it to bf16, which changes int8
codes.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from msig_tpu.data import dataset as jdataset
from msig_tpu.infer import quantized as jq
from msig_tpu.infer.styles import sample_styles as jax_sample_styles
from msig_tpu.ops import fused_conv_int8_v2 as jf2
from msig_tpu.models import StyleCycleGANGenerator as JGenerator
from msig_tpu_torch.compat.from_jax import generator_state_dict
from msig_tpu_torch.config import InferenceConfig
from msig_tpu_torch.data import dataset as tdataset
from msig_tpu_torch.infer import loading, quantized as tq
from msig_tpu_torch.infer.engine import InferenceEngine
from msig_tpu_torch.infer.styles import STYLE_MODES, sample_styles

N_RES, SDIM = 2, 64


@pytest.fixture(scope="module")
def random_gen():
    jgen = JGenerator(style_dim=SDIM, n_residual_blocks=N_RES, dtype=jnp.bfloat16)
    params = jgen.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.bfloat16),
                       jnp.zeros((1, SDIM), jnp.bfloat16))
    return params, generator_state_dict(params, N_RES)


def _psnr_u8(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


# ------------------------------------------------------------ int8 weights


def test_int8_weights_match_jax(random_gen):
    params, sd = random_gen
    jqp = jq.quantize_generator_params(params, N_RES)
    q = tq.quantize_generator_params(sd, N_RES)
    for i in range(N_RES):
        for c in ("conv1", "conv2"):
            np.testing.assert_array_equal(q[f"res{i}_{c}_p"].numpy(),
                                          np.asarray(jqp[f"res{i}_{c}_p"]))
        for a in ("adain1", "adain2"):
            np.testing.assert_array_equal(q[f"res{i}_{a}_k"].numpy(),
                                          np.asarray(jqp[f"res{i}_{a}_k"]))
    for name in ("enc_conv0", "enc_conv1", "enc_conv2", "dec_up0", "dec_up1"):
        # port: OIHW of the forward conv; JAX: HWIO
        np.testing.assert_array_equal(q[name].permute(2, 3, 1, 0).numpy(),
                                      np.asarray(jqp[name]), err_msg=name)
    np.testing.assert_array_equal(q["out_kernel_i8"].permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jqp["out_kernel_i8"])[..., :3])
    np.testing.assert_array_equal(q["out_wscale"].numpy(), np.asarray(jqp["out_wscale"])[:3])


# ------------------------------------------- (d) the slice end to end, 64²


@pytest.mark.parametrize("stride,pad,dilate,k,cin,cout", [
    (1, 0, False, 7, 3, 64),      # enc0 after the reflect pad: K = 147, padded to 152
    (2, 1, False, 4, 64, 128),    # enc1 / enc2
    (1, 2, True, 4, 32, 16),      # dec_up0 / dec_up1: zero-inserted input
    (1, 0, False, 7, 16, 3),      # final conv: N = 3, padded to 8
])
def test_conv_i8_matches_jax_exactly(stride, pad, dilate, k, cin, cout):
    rng = np.random.default_rng(9)
    x = rng.integers(-127, 128, (2, 9, 11, cin), dtype=np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)
    want = np.asarray(jq._conv_i8(jnp.asarray(x), jnp.asarray(w), stride, ((pad, pad), (pad, pad)),
                                  lhs_dilation=(2, 2) if dilate else None))
    got = tq._conv_i8(torch.from_numpy(x), torch.from_numpy(w).permute(3, 2, 0, 1), stride, pad,
                      lhs_dilation=dilate)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def slice_inputs(random_gen):
    params, sd = random_gen
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    style = rng.normal(0, 1, (2, SDIM)).astype(np.float32)
    return (jq.quantize_generator_params(params, N_RES), tq.quantize_generator_params(sd, N_RES),
            img, style)


def test_int8_slice_matches_jax_staged_trunk(slice_inputs):
    """End to end. The first encoder IN's fp32 statistics are summed in
    another order than XLA's, so a few bf16 outputs differ by one ulp (see
    the two tests below), and the bf16 encoder chain amplifies those into
    int8 steps: the bar is PSNR. The trunk and the decoder are held
    bit-exact below."""
    jqp, q, img, style = slice_inputs
    want = np.asarray(jq.quantized_generator_apply_staged(
        jqp, jnp.asarray(img), jnp.asarray(style), n_res=N_RES, out_dtype=jnp.uint8,
        pallas=("trunk",)))
    got = tq.quantized_generator_apply_staged(q, torch.from_numpy(img), torch.from_numpy(style),
                                              n_res=N_RES, out_dtype=torch.uint8,
                                              pallas=("trunk",)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, 64, 64, 3)
    assert _psnr_u8(got, want) >= 40.0


@pytest.mark.parametrize("out_dtype", ["uint8", None])
def test_generator_away_from_256_and_512_takes_the_jax_chain(random_gen, out_dtype):
    """At 128² both entry points run the unfused chain throughout, the port's
    ``_xla_trunk`` between its unfused encoder and decoder
    (``msig_tpu/infer/quantized.py:399-400``); None leaves ``out_dtype`` at its
    default, float32 in [-1, 1] on both sides. The bar is the slice's: 40 dB
    (the float output over its range of 2)."""
    params, sd = random_gen
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (1, 128, 128, 3), dtype=np.uint8)
    style = rng.normal(0, 1, (1, SDIM)).astype(np.float32)
    kw_j = {} if out_dtype is None else {"out_dtype": getattr(jnp, out_dtype)}
    kw_t = {} if out_dtype is None else {"out_dtype": getattr(torch, out_dtype)}
    want = np.asarray(jq.quantized_generator_apply(
        jq.quantize_generator_params(params, N_RES), jnp.asarray(img), jnp.asarray(style),
        n_res=N_RES, **kw_j))
    got = tq.quantized_generator_apply(tq.quantize_generator_params(sd, N_RES),
                                       torch.from_numpy(img), torch.from_numpy(style),
                                       n_res=N_RES, **kw_t).numpy()
    assert got.dtype == want.dtype == (np.float32 if out_dtype is None else np.uint8)
    assert got.shape == want.shape == (1, 128, 128, 3)
    if out_dtype is None:
        assert np.abs(got).max() <= 1.0
        mse = np.mean((got.astype(np.float64) - want.astype(np.float64)) ** 2)
        assert 10 * np.log10(4.0 / mse) >= 40.0
    else:
        assert _psnr_u8(got, want) >= 40.0


def test_generator_entry_points_default_to_float32():
    """As the JAX package's (``msig_tpu/infer/quantized.py:337, 490``)."""
    import inspect
    for fn in (tq.quantized_generator_apply, tq.quantized_generator_apply_staged):
        assert inspect.signature(fn).parameters["out_dtype"].default is torch.float32


def test_int8_trunk_and_decoder_bit_exact_on_jax_encoder_output(slice_inputs):
    """From the same encoder output, the trunk (plain kernel versions vs the
    Pallas kernels in interpret mode) and the unfused decoder agree exactly."""
    jqp, q, img, style = slice_inputs
    h = jq._xla_encoder(jqp, jnp.asarray(img))
    hq, inv_s = jq._requant_with_inv_scale(h)
    rows = jq._fused_trunk_rows(jqp, jf2.to_padded_rows(hq),
                                inv_s.reshape(-1, 1).astype(jnp.float32), jnp.asarray(style),
                                N_RES, w_img=16)
    want_trunk = np.asarray(jq._rows_to_body(rows, 16))
    ht = torch.from_numpy(np.array(h.astype(jnp.float32))).to(torch.bfloat16)
    got_trunk = tq._fused_trunk(q, ht, torch.from_numpy(style), N_RES)
    np.testing.assert_array_equal(got_trunk.numpy(), want_trunk)
    want = np.asarray(jq._xla_decoder(jqp, jnp.asarray(want_trunk), jnp.uint8, int8_body=True))
    got = tq._xla_decoder(q, got_trunk, torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def conv0_out(slice_inputs):
    """The first encoder conv's int32 output, from the JAX chain."""
    jqp, _, img, _ = slice_inputs
    x = (jnp.asarray(img).astype(jnp.int32) - 128).astype(jnp.int8)
    x = jnp.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)), mode="reflect")
    return np.array(jq._conv_i8(x, jqp["enc_conv0"], 1, ((0, 0), (0, 0))))


def _jax_in_relu(y_i32):
    return jnp.maximum(jq.instance_norm(jnp.asarray(y_i32).astype(jnp.bfloat16)), 0)


def test_in_relu_parts_from_jax_only_by_reduction_order(conv0_out):
    """Where the packages part: given the same int32 conv0 output, relu(IN) in
    bf16 differs from eager JAX only where the fp32 statistics, reduced in
    another order, differ in the last bit: on <= 1e-4 of the elements, each
    by at most one bf16 ulp."""
    want = _jax_in_relu(conv0_out)
    want_bits = np.asarray(jax.lax.bitcast_convert_type(want, jnp.int16)).astype(np.int32)
    got = tq._in_relu(torch.from_numpy(conv0_out))
    assert got.dtype == torch.bfloat16
    got_bits = got.view(torch.int16).numpy().astype(np.int32)
    # relu outputs are >= 0, where bf16 bit patterns are ordered; -0 is 0.
    want_bits[np.asarray(want) == 0] = 0
    got_bits[got.float().numpy() == 0] = 0
    ulps = np.abs(got_bits - want_bits)
    assert ulps.max() <= 1, ulps.max()
    assert (ulps > 0).mean() <= 1e-4, (ulps > 0).mean()


@pytest.mark.parametrize("fn", ["_requant", "_requant_with_inv_scale"])
def test_requant_bit_identical_to_eager_jax(conv0_out, fn):
    h = _jax_in_relu(conv0_out)
    got = getattr(tq, fn)(torch.from_numpy(np.array(h.astype(jnp.float32))).to(torch.bfloat16))
    want = getattr(jq, fn)(h)
    if fn == "_requant":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_trunk_hands_the_kernels_dense_contiguous_tensors(slice_inputs, monkeypatch):
    """What the CUDA wrappers demand of their inputs, checked on the CPU path."""
    _, q, img, style = slice_inputs
    seen = []

    def spy(real):
        def call(*args, **kw):  # kw: the K-major weight copy, which the kernels read
            for a in (*args, *kw.values()):
                assert a.is_contiguous() and a.device.type == "cpu"
            seen.append(tuple(args[0].shape))
            return real(*args, **kw)
        return call

    monkeypatch.setattr(tq.fc, "conv3x3_adain_relu_requant",
                        spy(tq.fc.conv3x3_adain_relu_requant))
    monkeypatch.setattr(tq.fc, "conv3x3_adain_residual_requant",
                        spy(tq.fc.conv3x3_adain_residual_requant))
    tq.quantized_generator_apply_staged(q, torch.from_numpy(img), torch.from_numpy(style),
                                        n_res=N_RES, pallas=("trunk",))
    assert seen == [(2, 16, 16, 256)] * (2 * N_RES)


@pytest.mark.parametrize("value", ["1", "2", "yes"])
def test_trunk_hifi_modes_are_refused(value, monkeypatch, slice_inputs):
    """Junk values are refused (the JAX package reads them as 1); 1 and 2 are
    taken and run the trunk on their conv2 site, N_RES launches of it."""
    monkeypatch.setenv("MSIG_TRUNK_HIFI", value)
    if value not in ("1", "2"):
        with pytest.raises(ValueError, match="MSIG_TRUNK_HIFI"):
            tq.quantized_generator_apply_staged({}, torch.zeros((1, 64, 64, 3), dtype=torch.uint8),
                                                torch.zeros((1, SDIM)), out_dtype=torch.uint8,
                                                pallas=("trunk",))
        return
    _, q, img, style = slice_inputs
    name = {"1": "conv3x3_adain_residual_hifi", "2": "conv3x3_adain_residual_hifi2"}[value]
    real, calls = getattr(tq.fc, name), []
    monkeypatch.setattr(tq.fc, name, lambda *a, **kw: calls.append(name) or real(*a, **kw))
    monkeypatch.setattr(tq.fc, "conv3x3_adain_residual_requant",
                        lambda *a, **kw: pytest.fail("the stock carry ran"))
    out = tq.quantized_generator_apply_staged(q, torch.from_numpy(img), torch.from_numpy(style),
                                              n_res=N_RES, out_dtype=torch.uint8,
                                              pallas=("trunk",))
    assert calls == [name] * N_RES
    assert out.dtype == torch.uint8 and out.shape == (2, 64, 64, 3)


# ---------------------------------------------------------- (f) styles


def _jax_draws(mode, key, batch, n, s):
    """The draws jax sample_styles makes for ``key`` (msig_tpu/infer/styles.py:40-57)."""
    if mode == "random":
        return {"index": jax.random.randint(key, (batch,), 0, n)}
    if mode == "interpolate":
        k1, k2, k3 = jax.random.split(key, 3)
        return {"index": jax.random.randint(k1, (batch,), 0, n),
                "second": jax.random.randint(k2, (batch,), 0, n - 1),
                "alpha": jax.random.uniform(k3, (batch, 1))}
    if mode == "noise":
        k1, k2 = jax.random.split(key)
        return {"index": jax.random.randint(k1, (batch,), 0, n),
                "normal": jax.random.normal(k2, (batch, s))}
    return None


@pytest.mark.parametrize("mode", STYLE_MODES)
def test_style_modes_match_jax(mode):
    rng = np.random.default_rng(5)
    bank = rng.normal(0, 1, (5, 32)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_sample_styles(jnp.asarray(bank), mode, key, 6, 0.1))
    draws = _jax_draws(mode, key, 6, 5, 32)
    if draws is not None:
        draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    got = sample_styles(torch.from_numpy(bank), mode, None, 6, 0.1, draws=draws).numpy()
    assert got.shape == (6, 32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["random", "interpolate", "noise"])
def test_random_modes_draw_from_generator(mode):
    bank = torch.randn(4, 8)
    a = sample_styles(bank, mode, torch.Generator().manual_seed(1), 16, 0.1)
    b = sample_styles(bank, mode, torch.Generator().manual_seed(1), 16, 0.1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    if mode == "random":
        assert all(any(torch.equal(r, row) for row in bank) for r in a)


def test_interpolate_single_vector_bank():
    bank = torch.randn(1, 8)
    out = sample_styles(bank, "interpolate", torch.Generator().manual_seed(0), 3)
    torch.testing.assert_close(out, bank.expand(3, 8), rtol=0, atol=0)


def test_unknown_style_mode_raises():
    with pytest.raises(ValueError, match="Unknown style mode"):
        sample_styles(torch.randn(2, 4), "latent", None, 1)


# ----------------------------------------------------------------- data


def test_data_listing_matches_jax(tmp_path):
    for d in ("b_dom", "a_dom", "empty"):
        (tmp_path / d).mkdir()
    for name in ("x.png", "y.JPG", "z.jpeg", "notes.txt"):
        (tmp_path / "a_dom" / name).write_bytes(b"")
    assert tdataset.list_image_files(str(tmp_path / "a_dom")) == \
        jdataset.list_image_files(str(tmp_path / "a_dom"))
    assert tdataset.discover_inference_domains(str(tmp_path)) == \
        jdataset.discover_inference_domains(str(tmp_path))
    with pytest.raises(ValueError):
        tdataset.discover_inference_domains(str(tmp_path / "missing"))


# -------------------------------------------------------------- loading


def test_npz_num_domains_guard():
    with pytest.raises(ValueError, match="10 domains"):
        loading.load_inference_params("results/tomato_r3b/demo_checkpoint", InferenceConfig(), 4)


def test_orbax_checkpoint_names_the_export_tool(tmp_path):
    (tmp_path / "state").mkdir()
    (tmp_path / "meta.json").write_text(json.dumps({"num_domains": 3}))
    with pytest.raises(ValueError, match="tools/export_torch_checkpoint.py"):
        loading.load_inference_params(str(tmp_path), InferenceConfig(), 3)


def test_reference_pth_prefers_ema(tmp_path, random_gen):
    _, sd = random_gen
    se = {"w": torch.zeros(1)}
    raw = {k: v + 1.0 for k, v in sd.items()}
    torch.save({"G_A2B": raw, "SE_B": se, "num_domains": 3}, tmp_path / "checkpoint.pth")
    cfg = InferenceConfig(n_residual_blocks=N_RES, style_dim=SDIM)
    g, _, meta, used_ema = loading.load_inference_params(str(tmp_path), cfg, 3)
    assert not used_ema and torch.equal(g["content_encoder.0.weight"],
                                        raw["content_encoder.0.weight"])
    torch.save({"ema_G_A2B": sd, "ema_SE_B": se}, tmp_path / "ema_checkpoint.pth")
    g, _, meta, used_ema = loading.load_inference_params(str(tmp_path), cfg, 3)
    assert used_ema and torch.equal(g["content_encoder.0.weight"], sd["content_encoder.0.weight"])
    assert meta == {"num_domains": 3, "style_dim": SDIM, "n_residual_blocks": N_RES}


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        loading.load_inference_params(str(tmp_path), InferenceConfig(), 3)


# --------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def demo_params():
    return loading.load_inference_params("results/tomato_r3b/demo_checkpoint",
                                         InferenceConfig(), 10)


def _engine(demo_params, **kw):
    gen, se, meta, _ = demo_params
    cfg = InferenceConfig(image_size=64, batch_size=2, device="cpu", **kw)
    return InferenceEngine.build(cfg, 10, gen, se, meta["n_residual_blocks"], meta["style_dim"])


def test_engine_refuses_data_parallel(demo_params):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _engine(demo_params, data_parallel=True)


def test_engine_without_card_raises(demo_params):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    gen, se, meta, _ = demo_params
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine.build(InferenceConfig(), 10, gen, se)


def test_engine_pads_last_batch_and_skips_unreadable(demo_params, tmp_path):
    rng = np.random.default_rng(7)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(
            tmp_path / f"im{i}.png")
    (tmp_path / "broken.jpg").write_bytes(b"not an image")
    eng = _engine(demo_params, quantize="int8")
    eng.out_uint8 = True
    bank = eng.encode_styles(rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8), 2)
    assert bank.shape == (3, 256) and bank.dtype == torch.float32
    outs = list(eng.translate_batches(eng.iter_input_batches(str(tmp_path)), bank, "average"))
    names = [n for _, ns in outs for n in ns]
    # Batches are cut from the sorted file list before decoding, so the
    # unreadable broken.jpg leaves its batch one image short.
    assert names == ["im0.png", "im1.png", "im2.png"]
    assert [o.shape for o, _ in outs] == [(1, 64, 64, 3), (2, 64, 64, 3)]
    assert all(o.dtype == np.uint8 for o, _ in outs)


def test_engine_early_close_stops_producer(demo_params, tmp_path):
    for i in range(6):
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / f"im{i}.png")
    eng = _engine(demo_params)
    it = eng.iter_input_batches(str(tmp_path), prefetch=1)
    first = next(it)
    it.close()
    assert first[0].shape == (2, 64, 64, 3)
    assert not any(t.name == "msig-torch-infer-prefetch" and t.is_alive()
                   for t in threading.enumerate())


def test_float_and_int8_engines_agree(demo_params):
    """The int8 serving path stays close to the float path of the same weights."""
    rng = np.random.default_rng(8)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    styles = torch.from_numpy(rng.normal(0, 1, (2, 256)).astype(np.float32))
    outs = []
    for kw in ({"compute_dtype": "float32"}, {"quantize": "int8"}):
        eng = _engine(demo_params, **kw)
        eng.out_uint8 = True
        outs.append(eng.generate(imgs, styles).numpy())
    assert _psnr_u8(outs[0], outs[1]) >= 25.0
    assert os.environ.get("MSIG_TRUNK_HIFI", "0") == "0"
