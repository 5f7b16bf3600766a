"""Parity of the port's ops with the JAX package: norms and the trunk kernel sites.

The same inputs, made with a seeded numpy RNG, go through the JAX function
(its Pallas kernels in interpret mode on the CPU, as the JAX tests run them)
and through the port. On the CPU the port's wrappers run their plain PyTorch
versions; the CUDA kernels themselves are held against those plain versions
on the card (tests/test_torch_port_cuda.py, and chip_smoke.py).
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msig_tpu.ops import fused_conv_int8 as jfc
from msig_tpu.ops import fused_conv_int8_v2 as jf2
from msig_tpu.ops import norm as jnorm
from msig_tpu_torch.ops import _build
from msig_tpu_torch.ops import fused_conv_int8_v2 as tf2
from msig_tpu_torch.ops import norm as tnorm

W_IMG = 16


# ------------------------------------------------------------------ (a) norm


@pytest.mark.parametrize("fn", ["instance_norm", "adain_modulate"])
def test_norm_matches_jax_fp32(fn):
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 2.0, (2, 8, 8, 16)).astype(np.float32)
    gamma = rng.normal(1.0, 0.5, (2, 16)).astype(np.float32)
    beta = rng.normal(0.0, 0.5, (2, 16)).astype(np.float32)
    if fn == "instance_norm":
        want = np.asarray(jnorm.instance_norm(jnp.asarray(x)))
        got = tnorm.instance_norm(torch.from_numpy(x)).numpy()
    else:
        want = np.asarray(jnorm.adain_modulate(jnp.asarray(x), jnp.asarray(gamma),
                                               jnp.asarray(beta)))
        got = tnorm.adain_modulate(torch.from_numpy(x), torch.from_numpy(gamma),
                                   torch.from_numpy(beta)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_norm_keeps_bf16_dtype():
    x = torch.randn(1, 4, 4, 8, dtype=torch.bfloat16)
    assert tnorm.instance_norm(x).dtype == torch.bfloat16


# ---------------------------------------------------------- slab geometry


@pytest.mark.parametrize("w_img", [16, 64])
def test_from_padded_rows_inverts_jax_packing(w_img):
    rng = np.random.default_rng(1)
    x = rng.integers(-127, 128, (2, w_img, w_img, 32), dtype=np.int8)
    rows = torch.from_numpy(np.array(jf2.to_padded_rows(jnp.asarray(x))))
    np.testing.assert_array_equal(tf2.from_padded_rows(rows, w_img).numpy(), x)
    assert tf2.guard_rows(w_img) == jf2.guard_rows(w_img)


def test_pack_weights_matches_jax():
    rng = np.random.default_rng(2)
    w = rng.integers(-127, 128, (3, 3, 32, 32), dtype=np.int8)
    np.testing.assert_array_equal(tf2.pack_weights(torch.from_numpy(w)).numpy(),
                                  np.asarray(jfc.pack_weights(jnp.asarray(w))))


# ------------------------------------------- (b) kernel sites vs Pallas


def _site_inputs(c, b=2, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, W_IMG, W_IMG, c), dtype=np.int8)
    w = rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8)
    gamma = rng.normal(1.0, 0.5, (b, c)).astype(np.float32)
    beta = rng.normal(0.0, 0.5, (b, c)).astype(np.float32)
    h = rng.normal(0, 1.5, (b, W_IMG, W_IMG, c)).astype(np.float32)
    hs = (np.abs(h).max(axis=(1, 2, 3)) / 127.0).astype(np.float32).reshape(b, 1)
    hq = np.clip(np.round(h / hs.reshape(b, 1, 1, 1)), -127, 127).astype(np.int8)
    return x, np.array(jfc.pack_weights(jnp.asarray(w))), gamma, beta, hq, hs


def _assert_int8_close(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()


@pytest.mark.parametrize("c", [32, 256])
def test_relu_site_plain_matches_pallas(c):
    x, wp, gamma, beta, _, _ = _site_inputs(c)
    want = jf2.conv3x3_adain_relu_requant(jf2.to_padded_rows(jnp.asarray(x)), jnp.asarray(wp),
                                          jnp.asarray(gamma), jnp.asarray(beta), w_img=W_IMG)
    want = tf2.from_padded_rows(torch.from_numpy(np.array(want)), W_IMG).numpy()
    got = tf2.conv3x3_adain_relu_requant(torch.from_numpy(x), torch.from_numpy(wp),
                                         torch.from_numpy(gamma), torch.from_numpy(beta))
    assert got.dtype == torch.int8 and got.shape == x.shape
    _assert_int8_close(got.numpy(), want)


@pytest.mark.parametrize("c", [32, 256])
def test_residual_site_plain_matches_pallas(c):
    x, wp, gamma, beta, hq, hs = _site_inputs(c)
    want_q, want_s = jf2.conv3x3_adain_residual_requant(
        jf2.to_padded_rows(jnp.asarray(x)), jf2.to_padded_rows(jnp.asarray(hq)),
        jnp.asarray(hs), jnp.asarray(wp), jnp.asarray(gamma), jnp.asarray(beta), w_img=W_IMG)
    want_q = tf2.from_padded_rows(torch.from_numpy(np.array(want_q)), W_IMG).numpy()
    got_q, got_s = tf2.conv3x3_adain_residual_requant(
        torch.from_numpy(x), torch.from_numpy(hq), torch.from_numpy(hs), torch.from_numpy(wp),
        torch.from_numpy(gamma), torch.from_numpy(beta))
    assert got_s.shape == (x.shape[0], 1) and got_s.dtype == torch.float32
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s).reshape(-1, 1), rtol=1e-5)
    _assert_int8_close(got_q.numpy(), want_q)


def test_cpu_wrappers_count_no_launches():
    x, wp, gamma, beta, hq, hs = _site_inputs(32, b=1)
    tf2.reset_launch_counts()
    tf2.conv3x3_adain_relu_requant(torch.from_numpy(x), torch.from_numpy(wp),
                                   torch.from_numpy(gamma), torch.from_numpy(beta))
    assert tf2.LAUNCHES == {tf2.RELU_SITE: 0, tf2.RESIDUAL_SITE: 0, tf2.HIFI_SITE: 0,
                            tf2.HIFI2_SITE: 0, tf2.CONVT_SITE: 0}


# ---------------------------------------------------- no silent fallback


def _fake_cuda(shape, dtype):
    t = mock.Mock(spec=torch.Tensor)
    t.device, t.dtype, t.shape = torch.device("cuda", 0), dtype, torch.Size(shape)
    t.dim.return_value = len(shape)
    t.is_contiguous.return_value = True
    return t


@pytest.mark.parametrize("site", [tf2.RELU_SITE, tf2.RESIDUAL_SITE])
def test_cuda_tensor_without_nvcc_raises(site, monkeypatch):
    """A CUDA tensor launches the kernel or raises: with no build, it raises."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "library_path", lambda name: mock.Mock(exists=lambda: False))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    monkeypatch.setenv("NVCC", "")
    b, c = 2, 256
    x = _fake_cuda((b, 64, 64, c), torch.int8)
    w = _fake_cuda((9 * c, c), torch.int8)
    g = _fake_cuda((b, c), torch.float32)
    tf2.reset_launch_counts()
    with mock.patch.object(tf2, "conv3x3_adain_relu_requant_plain") as plain_relu, \
            mock.patch.object(tf2, "conv3x3_adain_residual_requant_plain") as plain_res:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            if site == tf2.RELU_SITE:
                tf2.conv3x3_adain_relu_requant(x, w, g, g)
            else:
                tf2.conv3x3_adain_residual_requant(x, x, _fake_cuda((b, 1), torch.float32),
                                                   w, g, g)
        plain_relu.assert_not_called()
        plain_res.assert_not_called()
    assert tf2.LAUNCHES[site] == 0


def test_non_cuda_device_raises():
    x = torch.empty((1, 16, 16, 128), dtype=torch.int8, device="meta")
    w = torch.empty((9 * 128, 128), dtype=torch.int8, device="meta")
    g = torch.empty((1, 128), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tf2.conv3x3_adain_relu_requant(x, w, g, g)
