"""Parity of the port's single-kernel trunk (``MSIG_TRUNK_V3``) with the JAX package.

``fused_trunk_blocks`` of ``msig_tpu_torch/ops/fused_trunk_v3.py`` (its plain
version, which the CPU runs) against the Pallas kernel of
``msig_tpu/ops/fused_trunk_v3.py`` in interpret mode, at the configuration of
tests/test_fused_trunk_v3.py (16-pixel map, 4-row chunks) and at C = 128;
against the port's own per-site chain; on a channel whose conv output has one
sign, where the two rules for conv1's requant scale part; the stacked
weights; and the dispatch of ``MSIG_TRUNK_V3`` in ``infer/quantized.py``, with
the generator at 256² against the JAX package's under the flag. The CUDA
kernel is held against the plain version on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msig_tpu.infer import quantized as jq
from msig_tpu.models import StyleCycleGANGenerator as JGenerator
from msig_tpu.ops import fused_conv_int8 as jfc
from msig_tpu.ops import fused_conv_int8_v2 as jf2
from msig_tpu.ops import fused_trunk_v3 as jf3
from msig_tpu_torch.compat.from_jax import generator_state_dict
from msig_tpu_torch.infer import quantized as tq
from msig_tpu_torch.ops import _build
from msig_tpu_torch.ops import fused_conv_int8_v2 as tf2
from msig_tpu_torch.ops import fused_trunk_v3 as tf3

W_IMG, CHUNK_ROWS, B = 16, 4, 2
CASES = [(8, 1), (8, 3), (128, 1)]   # (C, n_blocks)


def _inputs(c, n_blocks, seed=0, x_lo=-127):
    """tests/test_fused_trunk_v3.py::_mk_inputs at width c: int8 map, scale,
    the 2N packed weights, and the affines [B, 2N, C]."""
    rng = np.random.default_rng(seed)
    x = rng.integers(x_lo, 128, (B, W_IMG, W_IMG, c), dtype=np.int8)
    hs = rng.uniform(0.5, 2.0, (B, 1)).astype(np.float32)
    ws = [rng.integers(-127, 128, (3, 3, c, c), dtype=np.int8) for _ in range(2 * n_blocks)]
    gs = rng.uniform(0.5, 1.5, (B, 2 * n_blocks, c)).astype(np.float32)
    bs = rng.uniform(-0.5, 0.5, (B, 2 * n_blocks, c)).astype(np.float32)
    return x, hs, ws, gs, bs


def _jax_v3(x, hs, ws, gs, bs, n_blocks):
    w_stack = jnp.concatenate([jfc.pack_weights(jnp.asarray(w)) for w in ws], axis=0)
    out, s = jf3.fused_trunk_blocks(jf2.to_padded_rows(jnp.asarray(x)), jnp.asarray(hs), w_stack,
                                    jnp.asarray(gs), jnp.asarray(bs), n_blocks, w_img=W_IMG,
                                    chunk_rows=CHUNK_ROWS)
    return tf2.from_padded_rows(torch.from_numpy(np.array(out)), W_IMG).numpy(), np.asarray(s)


def _port(x, hs, ws, gs, bs, n_blocks, chain=False):
    """The port's v3 (plain) or, with ``chain``, its per-site chain of rows 1-2."""
    t = torch.from_numpy
    wp = [tf2.pack_weights(t(w)) for w in ws]
    if not chain:
        out, s = tf3.fused_trunk_blocks(t(x), t(hs), torch.cat(wp), t(gs), t(bs), n_blocks)
        return out.numpy(), s.numpy()
    h, s = t(x), t(hs)
    for i in range(n_blocks):
        y1 = tf2.conv3x3_adain_relu_requant(h, wp[2 * i], t(gs[:, 2 * i]), t(bs[:, 2 * i]))
        h, s = tf2.conv3x3_adain_residual_requant(y1, h, s, wp[2 * i + 1], t(gs[:, 2 * i + 1]),
                                                  t(bs[:, 2 * i + 1]))
    return h.numpy(), s.numpy()


def _diff(a, b):
    assert a.dtype == b.dtype == np.int8 and a.shape == b.shape
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


# ----------------------------------------------------------- the kernel


@pytest.mark.parametrize("c,n_blocks", CASES)
def test_plain_matches_jax_v3(c, n_blocks):
    """Bars: int8 at most 1 step apart on under 1% (the statistics: fp32 sums
    over 16-row chunks on the TPU, exact integers here), scales rtol 1e-5."""
    args = _inputs(c, n_blocks)
    want, want_s = _jax_v3(*args, n_blocks)
    got, got_s = _port(*args, n_blocks)
    assert got_s.shape == (B, 1) and got_s.dtype == np.float32
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=0)
    d = _diff(got, want)
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("c,n_blocks", CASES)
def test_plain_matches_the_port_chain(c, n_blocks):
    """Where every channel's conv output has both signs the zero-masked and
    the true extremes coincide, and v3 parts from the chain only by the
    unfolded requant's rounding: the JAX package's own bar
    (tests/test_fused_trunk_v3.py:61-65)."""
    args = _inputs(c, n_blocks)
    got, got_s = _port(*args, n_blocks)
    want, want_s = _port(*args, n_blocks, chain=True)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=0)
    d = _diff(got, want)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def test_one_sign_channel_follows_v3_not_the_chain():
    """Channel 0 of conv1 sees a positive input through positive weights, so
    its output is positive everywhere; with a negative gamma its largest
    modulated value sits at its minimum. The chain's zero-masked rule puts
    that value at y = 0 instead and takes a coarser scale for conv1's int8
    (about 1.45x here). conv2's instance norm absorbs the scale, so what
    remains at the block's output is rounding: the port's v3 keeps the true
    extremes and agrees with the TPU kernel to the bit on this input, the
    chain parts from it on about 4% of the elements, past the 1% bar."""
    x, hs, ws, gs, bs = _inputs(8, 1, seed=5, x_lo=1)
    ws[0][..., 0] = np.abs(ws[0][..., 0]) + 1
    gs[:, 0, 0], bs[:, 0, 0] = -1.5, 3.0
    y = tf2.conv3x3_i64(torch.from_numpy(x), tf2.pack_weights(torch.from_numpy(ws[0])))
    assert int(y[..., 0].min()) > 0
    a, d = tf2._channel_affine(y, torch.from_numpy(gs[:, 0]), torch.from_numpy(bs[:, 0]), 1e-5)
    y1_true = tf2.relu_requant_true(y, a, d)
    y1_masked = tf2._relu_requant(y, a, d)[0]
    assert int((y1_true.to(torch.int32) - y1_masked.to(torch.int32)).abs().max()) > 1
    want, want_s = _jax_v3(x, hs, ws, gs, bs, 1)
    got, got_s = _port(x, hs, ws, gs, bs, 1)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=0)
    diff = _diff(got, want)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    chain, _ = _port(x, hs, ws, gs, bs, 1, chain=True)
    assert (_diff(chain, want) > 0).mean() > 0.01


def test_pack_trunk_weights_is_site_major():
    ws = {f"res{i}_conv{k}_p": torch.full((18, 2), 10 * i + k, dtype=torch.int8)
          for i in range(3) for k in (1, 2)}
    stack = tf3.pack_trunk_weights(ws, 3)
    assert stack.shape == (6 * 18, 2)
    assert stack[::18, 0].tolist() == [1, 2, 11, 12, 21, 22]


# ------------------------------------------------------ no silent fallback


def test_cpu_wrapper_counts_no_launch():
    tf3.reset_launch_counts()
    _port(*_inputs(8, 1), 1)
    assert tf3.LAUNCHES == {tf3.SITE: 0}


def _fake_cuda(shape, dtype):
    t = mock.Mock(spec=torch.Tensor)
    t.device, t.dtype, t.shape = torch.device("cuda", 0), dtype, torch.Size(shape)
    t.dim.return_value = len(shape)
    t.is_contiguous.return_value = True
    return t


def _call(make, b=2, side=64, c=256, n=8):
    return tf3.fused_trunk_blocks(make((b, side, side, c), torch.int8),
                                  make((b, 1), torch.float32),
                                  make((2 * n * 9 * c, c), torch.int8),
                                  make((b, 2 * n, c), torch.float32),
                                  make((b, 2 * n, c), torch.float32), n)


def test_cuda_tensor_without_nvcc_raises(monkeypatch):
    """A CUDA tensor launches the kernel or raises: with no build, it raises."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "library_path", lambda name: mock.Mock(exists=lambda: False))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    monkeypatch.setenv("NVCC", "")
    tf3.reset_launch_counts()
    with mock.patch.object(tf3, "fused_trunk_blocks_plain") as plain:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _call(_fake_cuda)
        plain.assert_not_called()
    assert tf3.LAUNCHES == {tf3.SITE: 0}


@pytest.mark.parametrize("case,match", [
    ("meta", "CUDA tensor"),
    ("channels", "C % 128"),
    ("stack", "w_stack must have shape"),
])
def test_inputs_the_kernel_does_not_take_raise(case, match):
    if case == "meta":
        with pytest.raises(ValueError, match=match):
            _call(lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta"), b=1, side=16)
        return
    make = _fake_cuda
    with pytest.raises(ValueError, match=match):
        if case == "channels":
            _call(make, c=192)
        else:
            tf3.fused_trunk_blocks(make((2, 64, 64, 256), torch.int8), make((2, 1), torch.float32),
                                   make((9 * 256, 256), torch.int8),
                                   make((2, 4, 256), torch.float32),
                                   make((2, 4, 256), torch.float32), 2)


# ------------------------------------------------- MSIG_TRUNK_V3 dispatch

N_RES, SDIM = 1, 64


@pytest.fixture(scope="module")
def gen_params():
    jgen = JGenerator(style_dim=SDIM, n_residual_blocks=2, dtype=jnp.bfloat16)
    return jgen.init(jax.random.PRNGKey(7), jnp.zeros((1, 64, 64, 3), jnp.bfloat16),
                     jnp.zeros((1, SDIM), jnp.bfloat16))


def test_trunk_w_stack_bit_equal_to_jax(gen_params, monkeypatch):
    monkeypatch.setenv("MSIG_TRUNK_V3", "1")
    want = np.asarray(jq.quantize_generator_params(gen_params, 2)["trunk_w_stack"])
    q = tq.quantize_generator_params(generator_state_dict(gen_params, 2), 2)
    assert q["trunk_w_stack"].shape == (4 * 9 * 256, 256) == want.shape
    np.testing.assert_array_equal(q["trunk_w_stack"].numpy(), want)


def _tiny_q(n_res, c=8, sdim=4):
    """Style affines of n_res blocks at width c; the sites are stubbed below."""
    q = {}
    for i in range(n_res):
        for a in ("adain1", "adain2"):
            q[f"res{i}_{a}_k"] = torch.ones((sdim, 2 * c))
            q[f"res{i}_{a}_b"] = torch.zeros(2 * c)
        for k in ("conv1", "conv2"):
            q[f"res{i}_{k}_p"] = torch.zeros((9 * c, c), dtype=torch.int8)
    q["trunk_w_stack"] = tf3.pack_trunk_weights(q, n_res)
    return q


@pytest.fixture
def stub_sites(monkeypatch):
    """Records which trunk route ran, with no convolution computed."""
    calls = []
    monkeypatch.setattr(tq.fc, "conv3x3_adain_relu_requant",
                        lambda x, *a, **k: calls.append("relu") or x)
    for name in ("conv3x3_adain_residual_requant", "conv3x3_adain_residual_hifi",
                 "conv3x3_adain_residual_hifi2"):
        monkeypatch.setattr(tq.fc, name, lambda y1, *a, name=name, **k: calls.append(name) or (
            y1, *a[:(2 if name.endswith("hifi2") else 1)]))
    monkeypatch.setattr(tq.f3, "fused_trunk_blocks",
                        lambda x, hs, *a: calls.append("v3") or (x, hs))
    return calls


@pytest.mark.parametrize("side,hifi,want", [
    (64, "0", ["v3"]),
    (128, "0", ["relu", "conv3x3_adain_residual_requant"] * 2),   # 512²: the per-site chain
    (32, "0", ["relu", "conv3x3_adain_residual_requant"] * 2),
])
def test_v3_runs_on_the_64_grid_only(stub_sites, monkeypatch, side, hifi, want):
    monkeypatch.setenv("MSIG_TRUNK_V3", "1")
    monkeypatch.setenv("MSIG_TRUNK_HIFI", hifi)
    hq = torch.zeros((1, side, side, 8), dtype=torch.int8)
    tq._fused_trunk_rows(_tiny_q(2), hq, torch.ones((1, 1)), torch.ones((1, 4)), 2)
    assert stub_sites == want


def test_v3_with_a_hifi_mode_warns_and_runs_the_hifi_chain(stub_sites, monkeypatch):
    monkeypatch.setenv("MSIG_TRUNK_V3", "1")
    monkeypatch.setenv("MSIG_TRUNK_HIFI", "1")
    hq = torch.zeros((1, 64, 64, 8), dtype=torch.int8)
    with pytest.warns(UserWarning, match="MSIG_TRUNK_V3 is being IGNORED"):
        tq._fused_trunk_rows(_tiny_q(2), hq, torch.ones((1, 1)), torch.ones((1, 4)), 2)
    assert stub_sites == ["relu", "conv3x3_adain_residual_hifi"] * 2


def test_flag_set_after_quantization_changes_nothing(stub_sites, monkeypatch):
    """The branch needs ``trunk_w_stack``, which only a quantization under the
    flag builds (``quantized.py:193``)."""
    q = _tiny_q(2)
    del q["trunk_w_stack"]
    monkeypatch.setenv("MSIG_TRUNK_V3", "1")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tq._fused_trunk_rows(q, torch.zeros((1, 64, 64, 8), dtype=torch.int8), torch.ones((1, 1)),
                             torch.ones((1, 4)), 2)
    assert stub_sites == ["relu", "conv3x3_adain_residual_requant"] * 2


@pytest.mark.parametrize("value", ["yes", "2"])
def test_junk_values_of_the_flag_raise(monkeypatch, value):
    """The JAX package reads them as off; here they raise, as do the port's
    other settings."""
    monkeypatch.setenv("MSIG_TRUNK_V3", value)
    with pytest.raises(ValueError, match="MSIG_TRUNK_V3"):
        tq.quantized_generator_apply({}, torch.zeros((1, 64, 64, 3), dtype=torch.uint8),
                                     torch.zeros((1, SDIM)))


def test_generator_256_under_v3_matches_jax(gen_params, monkeypatch):
    """The served composition at 256² with the flag set at quantization, one
    resblock: one trunk call against the JAX package's v3 kernel in interpret
    mode. The chains part at enc0's statistics as without the flag
    (tests/test_torch_port_enc.py), so the bar is PSNR."""
    monkeypatch.setenv("MSIG_TRUNK_V3", "1")
    jgen = JGenerator(style_dim=SDIM, n_residual_blocks=N_RES, dtype=jnp.bfloat16)
    params = jgen.init(jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3), jnp.bfloat16),
                       jnp.zeros((1, SDIM), jnp.bfloat16))
    jqp = jq.quantize_generator_params(params, N_RES)
    q = tq.quantize_generator_params(generator_state_dict(params, N_RES), N_RES)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)
    style = rng.normal(0, 1, (1, SDIM)).astype(np.float32)
    with mock.patch.object(jf3, "fused_trunk_blocks", wraps=jf3.fused_trunk_blocks) as jv3:
        want = np.asarray(jq.quantized_generator_apply_staged(
            jqp, jnp.asarray(img), jnp.asarray(style), n_res=N_RES, out_dtype=jnp.uint8))
    assert jv3.call_count == 1
    with mock.patch.object(tq.f3, "fused_trunk_blocks", wraps=tq.f3.fused_trunk_blocks) as tv3, \
            mock.patch.object(tq.fc, "conv3x3_adain_relu_requant", side_effect=AssertionError):
        got = tq.quantized_generator_apply(q, torch.from_numpy(img), torch.from_numpy(style),
                                           n_res=N_RES, out_dtype=torch.uint8).numpy()
    assert tv3.call_count == 1
    assert got.shape == want.shape == (1, 256, 256, 3)
    mse = np.mean((got.astype(np.float64) - want.astype(np.float64)) ** 2)
    assert 10 * np.log10(255.0 ** 2 / mse) >= 40.0
