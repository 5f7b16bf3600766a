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
