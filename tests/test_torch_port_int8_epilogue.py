"""Parity of the port's whole-slab int8 epilogues with the JAX package.

``msig_tpu_torch/ops/int8_epilogue.py`` (rows 16-17 of PERF.md's kernel
table) against ``msig_tpu/ops/int8_epilogue.py``'s Pallas kernels in
interpret mode, on the inputs of ``tests/test_int8_epilogue.py`` (``_data``,
seeds 0, 1 and 3). Bars: int8 at most 1 step apart on under 1% of the
elements; h within 1 bf16 ulp on under 1% (bfloat16 residual), or rtol 1e-5
and atol 1e-5 x max|h| (float32). The CUDA kernels are held against the
plain versions on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msig_tpu.ops import int8_epilogue as jep
from msig_tpu_torch.ops import int8_epilogue as tep


def _data(b=2, s=64, c=128, seed=0):
    """``tests/test_int8_epilogue.py::_data``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2000, 2000, (b, s, c)).astype(np.int32)
    g = rng.standard_normal((b, c)).astype(np.float32)
    be = rng.standard_normal((b, c)).astype(np.float32)
    return x, g, be


def _assert_int8_close(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


def _bf16_ulps(a, b):
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits >= 0, bits, -(bits & 0x7FFF))
    return (ordered(a) - ordered(b)).abs()


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_relu_plain_matches_pallas(seed):
    x, g, b = _data(seed=seed)
    want = np.asarray(jep.adain_relu_requant(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    got = tep.adain_relu_requant(*_t(x, g, b))
    assert got.dtype == torch.int8 and got.shape == x.shape
    _assert_int8_close(got.numpy(), want)


def test_relu_identity_style_matches_pallas():
    """gamma = 1, beta = 0: the plain IN + ReLU case (``TestReluRequant``)."""
    x, _, _ = _data(seed=3)
    ones, zeros = np.ones((2, 128), np.float32), np.zeros((2, 128), np.float32)
    want = np.asarray(jep.adain_relu_requant(*map(jnp.asarray, (x, ones, zeros))))
    _assert_int8_close(tep.adain_relu_requant(*_t(x, ones, zeros)).numpy(), want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("seed", [0, 1, 3])
def test_residual_plain_matches_pallas(seed, dtype):
    x, g, b = _data(seed=seed)
    res = np.random.default_rng(9).standard_normal((2, 64, 128)).astype(np.float32)
    jres = jnp.asarray(res).astype(getattr(jnp, dtype))
    want_h, want_o = jep.adain_residual_requant(*map(jnp.asarray, (x, g, b)), jres)
    tres = torch.from_numpy(res).to(getattr(torch, dtype))
    got_h, got_o = tep.adain_residual_requant(*_t(x, g, b), tres)
    assert got_h.dtype == tres.dtype and got_o.dtype == torch.int8
    _assert_int8_close(got_o.numpy(), np.asarray(want_o))
    if dtype == "bfloat16":
        want = torch.from_numpy(np.array(want_h.astype(jnp.float32))).to(torch.bfloat16)
        ulps = _bf16_ulps(got_h, want)
        assert int(ulps.max()) <= 1 and float((ulps > 0).float().mean()) < 0.01
    else:
        want = np.asarray(want_h)
        np.testing.assert_allclose(got_h.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_conv_sized_values_take_statistics_of_the_fp32_cast():
    """Above 2^24 the int32 -> fp32 cast rounds; conv outputs reach 7.5e7. The
    statistics are the fp32 cast's, as the TPU takes them."""
    rng = np.random.default_rng(5)
    x = rng.integers(-(2 ** 27), 2 ** 27, (2, 256, 128)).astype(np.int32)
    g = rng.normal(1.0, 0.5, (2, 128)).astype(np.float32)
    b = rng.normal(0.0, 0.5, (2, 128)).astype(np.float32)
    want = np.asarray(jep.adain_relu_requant(*map(jnp.asarray, (x, g, b))))
    _assert_int8_close(tep.adain_relu_requant(*_t(x, g, b)).numpy(), want)
    res = rng.standard_normal((2, 256, 128)).astype(np.float32)
    _, want_o = jep.adain_residual_requant(*map(jnp.asarray, (x, g, b, res)))
    _assert_int8_close(tep.adain_residual_requant(*_t(x, g, b, res))[1].numpy(),
                       np.asarray(want_o))


@pytest.mark.parametrize("shape", [(1, 4096, 256), (1, 65536, 64), (1, 65536, 256),
                                   (2, 8192, 256), (2, 8193, 256), (1, 64, 384)])
def test_supported_agrees_with_jax(shape):
    """The cases of ``TestSupported`` and the edges of the 8 MB slab."""
    assert tep.supported(shape) == jep.supported(shape)


def test_residual_dtype_the_kernel_does_not_take_raises():
    x, g, b = _data()
    res = torch.zeros((2, 64, 128), dtype=torch.float16)
    with pytest.raises(ValueError, match="residual must be one of"):
        tep.adain_residual_requant(*_t(x, g, b), res)


def test_cpu_wrappers_count_no_launches():
    x, g, b = _data()
    tep.reset_launch_counts()
    tep.adain_relu_requant(*_t(x, g, b))
    tep.adain_residual_requant(*_t(x, g, b), torch.zeros((2, 64, 128)))
    assert tep.LAUNCHES == {tep.RELU_SITE: 0, tep.RESIDUAL_SITE: 0}
