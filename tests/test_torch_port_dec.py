"""Parity of the port's int8 decoder slice with the JAX package.

The decoder's three kernel sites (up0 ConvT, up1 ConvT, final conv7 + tanh +
uint8), the fused decoder as a whole, and the int8 generator at 256² in the
composition ``quantized_generator_apply_staged(..., pallas=("trunk", "dec"))``.
The JAX side runs eagerly on the CPU with its Pallas kernels in interpret
mode, and its outputs are unpacked with its own ``unphase_*`` functions; the
port runs its kernels' plain versions (the CUDA kernels are held against those
on the card: tests/test_torch_port_cuda.py, chip_smoke.py). Module fixtures
run each JAX kernel once, at B = 1 on the 64-cell grid the JAX decoder kernels
are fixed to.
"""

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
from msig_tpu.ops import fused_dec_int8 as jfd
from msig_tpu_torch.compat.from_jax import generator_state_dict
from msig_tpu_torch.infer import quantized as tq
from msig_tpu_torch.ops import _build
from msig_tpu_torch.ops import fused_conv_int8_v2 as tf2
from msig_tpu_torch.ops import fused_dec_int8 as tfd

N_RES, SDIM = 1, 64


@pytest.fixture(scope="module")
def qparams():
    """int8 weights of one random generator at full width, in both packages."""
    jgen = JGenerator(style_dim=SDIM, n_residual_blocks=N_RES, dtype=jnp.bfloat16)
    params = jgen.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3), jnp.bfloat16),
                       jnp.zeros((1, SDIM), jnp.bfloat16))
    return (jq.quantize_generator_params(params, N_RES),
            tq.quantize_generator_params(generator_state_dict(params, N_RES), N_RES))


@pytest.fixture(scope="module")
def trunk_out():
    """A trunk output: int8 [1, 64, 64, 256] with an absorbed scale."""
    return np.random.default_rng(0).integers(-127, 128, (1, 64, 64, 256), dtype=np.int8)


@pytest.fixture(scope="module")
def jax_chain(qparams, trunk_out):
    """The three JAX decoder kernels in the order ``_fused_decoder`` runs them,
    each output unpacked to dense NHWC."""
    jqp, _ = qparams
    y0, s0 = jf2.convt4x4s2_in_relu_requant_ps(jf2.to_padded_rows(jnp.asarray(trunk_out)),
                                               jqp["up0_ps"], jf2.PS_TAPS, 64, guarded_out=True)
    y1, s1 = jfd.up1_s2d16(y0, jqp["up1_s16"])
    u8 = jfd.final7_tanh_u8(y1, jqp["final_s16"], jqp["out_wscale"], jqp["out_bias"], s1)
    g = jf2.guard_rows(64)
    return dict(y0=np.array(jf2.unphase_s2d(y0[:, g:-g], 64, 128)),
                s0=np.array(s0).reshape(-1, 1),
                y1=np.array(jfd.unphase_s2d16(y1, 64)), s1=np.array(s1).reshape(-1, 1),
                u8=np.array(jfd.unphase_s2d16_u8(u8)))


def _assert_int8_close(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()


def _assert_uint8_close(got, want):
    """tests/test_fused_dec_int8.py:103-104."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()


def _psnr(a, b, peak=255.0):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(peak ** 2 / mse)


# ------------------------------------------------------------- weights


@pytest.mark.parametrize("name", ["up0_ps", "up1_ps"])
def test_pack_convt_weights_ps_matches_jax(qparams, name):
    jqp, q = qparams
    np.testing.assert_array_equal(q[name].numpy(), np.asarray(jqp[name]))


def test_ps_taps_match_jax():
    assert tf2.PS_TAPS == jf2.PS_TAPS


# ---------------------------------------------------- sites vs Pallas


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 64), (256, 128)])
def test_convt_site_plain_matches_pallas_small(cin, cout):
    rng = np.random.default_rng(cin + cout)
    x = rng.integers(-127, 128, (2, 16, 16, cin), dtype=np.int8)
    w = rng.integers(-127, 128, (4, 4, cin, cout), dtype=np.int8)
    wp, _ = jf2.pack_convt_weights_ps(jnp.asarray(w), cin, cout)
    want_q, want_s = jf2.convt4x4s2_in_relu_requant_ps(jf2.to_padded_rows(jnp.asarray(x)), wp,
                                                       jf2.PS_TAPS, 16)
    got_q, got_s = tf2.convt4x4s2_in_relu_requant_ps(
        torch.from_numpy(x), tf2.pack_convt_weights_ps(torch.from_numpy(w), cin, cout))
    assert got_q.dtype == torch.int8 and got_q.shape == (2, 32, 32, cout)
    assert got_s.dtype == torch.float32 and got_s.shape == (2, 1)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s).reshape(-1, 1), rtol=1e-5)
    _assert_int8_close(got_q.numpy(), np.asarray(jf2.unphase_s2d(want_q, 16, cout)))


def test_convt_site_plain_matches_9tap_pallas():
    """The 9-tap K-concat form (``fused_conv_int8_v2.convt4x4s2_in_relu_requant``)
    computes the same function as the phase-split site the port runs."""
    rng = np.random.default_rng(7)
    x = rng.integers(-127, 128, (2, 16, 16, 64), dtype=np.int8)
    w = rng.integers(-127, 128, (4, 4, 64, 64), dtype=np.int8)
    want_q, want_s = jf2.convt4x4s2_in_relu_requant(
        jf2.to_padded_rows(jnp.asarray(x)), jfc.pack_convt_weights(jnp.asarray(w), 64, 64), 16)
    got_q, got_s = tf2.convt4x4s2_in_relu_requant_ps(
        torch.from_numpy(x), tf2.pack_convt_weights_ps(torch.from_numpy(w), 64, 64))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s).reshape(-1, 1), rtol=1e-5)
    _assert_int8_close(got_q.numpy(), np.asarray(jf2.unphase_s2d(want_q, 16, 64)))


def test_up0_site_plain_matches_pallas(qparams, trunk_out, jax_chain):
    _, q = qparams
    got_q, got_s = tf2.convt4x4s2_in_relu_requant_ps(torch.from_numpy(trunk_out), q["up0_ps"])
    np.testing.assert_allclose(got_s.numpy(), jax_chain["s0"], rtol=1e-5)
    _assert_int8_close(got_q.numpy(), jax_chain["y0"])


def test_up1_site_plain_matches_pallas(qparams, jax_chain):
    """Given up0's output, up1 on the dense map equals the s2d-4 -> s2d-16 kernel."""
    _, q = qparams
    got_q, got_s = tfd.up1_s2d16(torch.from_numpy(jax_chain["y0"]), q["up1_ps"])
    assert got_q.shape == (1, 256, 256, 64)
    np.testing.assert_allclose(got_s.numpy(), jax_chain["s1"], rtol=1e-5)
    _assert_int8_close(got_q.numpy(), jax_chain["y1"])


def test_final7_plain_matches_pallas(qparams, jax_chain):
    """Given up1's output and scale, the reflect-by-index conv7 site equals the
    slab kernel fed up1's reflect-filled guard cells, border included."""
    _, q = qparams
    got = tfd.final7_tanh_u8(torch.from_numpy(jax_chain["y1"]), q["out_kernel_i8"],
                             q["out_wscale"], q["out_bias"], torch.from_numpy(jax_chain["s1"]))
    assert got.dtype == torch.uint8 and got.shape == (1, 256, 256, 3)
    assert len(np.unique(got.numpy())) > 100  # the data spans the tanh, not its tails
    _assert_uint8_close(got.numpy(), jax_chain["u8"])


def test_final7_reflects_like_reflection_pad():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-127, 128, (1, 9, 7, 5), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (2, 5, 7, 7), dtype=np.int8))
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x.permute(0, 3, 1, 2).double(), (3, 3, 3, 3), mode="reflect"),
        w.double())
    torch.testing.assert_close(tfd.final7_i64(x, w), want.permute(0, 2, 3, 1).long(),
                               rtol=0, atol=0)


# ------------------------------------------------ the decoder, the slice


@pytest.mark.parametrize("out_dtype", ["uint8", "float32"])
def test_fused_decoder_matches_jax(qparams, trunk_out, out_dtype):
    """Given the same trunk output. up1's scale comes from independently
    ordered fp32 statistics, so isolated one-step int8 flips spread through
    the 7x7 conv: PSNR, as tests/test_fused_dec_int8.py:134-139 gates it."""
    jqp, q = qparams
    want = np.asarray(jq._fused_decoder(jqp, jf2.to_padded_rows(jnp.asarray(trunk_out)),
                                        getattr(jnp, out_dtype), w_cells=64))
    got = tq._fused_decoder(q, torch.from_numpy(trunk_out), getattr(torch, out_dtype)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (1, 256, 256, 3)
    assert _psnr(got, want, peak=255.0 if out_dtype == "uint8" else 2.0) >= 40.0


def test_generator_256_matches_jax_staged_trunk_dec(qparams):
    jqp, q = qparams
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)
    style = rng.normal(0, 1, (1, SDIM)).astype(np.float32)
    want = np.asarray(jq.quantized_generator_apply_staged(
        jqp, jnp.asarray(img), jnp.asarray(style), n_res=N_RES, out_dtype=jnp.uint8,
        pallas=("trunk", "dec")))
    got = tq.quantized_generator_apply_staged(q, torch.from_numpy(img), torch.from_numpy(style),
                                              n_res=N_RES, out_dtype=torch.uint8,
                                              pallas=("trunk", "dec")).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (1, 256, 256, 3)
    assert _psnr(got, want) >= 40.0


_ALL_KERNELS = ["_fused_encoder", "_fused_trunk_rows", "_fused_decoder"]
_UNFUSED = ["_xla_encoder", "_xla_trunk", "_xla_decoder"]


@pytest.mark.parametrize("side,chain", [(64, _UNFUSED), (128, _UNFUSED),
                                        (256, _ALL_KERNELS)])
def test_decoder_is_chosen_by_input_size(side, chain, monkeypatch):
    """256² takes the all-kernel chain (``pallas=("enc", "trunk", "dec")``):
    the kernel encoder, the trunk straight on its int8 output and scale, the
    kernel decoder. Sizes other than 256² and 512² take the unfused chain
    throughout, as ``msig_tpu/infer/quantized.py:399-400`` does."""
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
    tq.quantized_generator_apply({}, torch.zeros((1, side, side, 3), dtype=torch.uint8),
                                 torch.zeros((1, SDIM)))
    assert calls == chain


# ---------------------------------------------------- no silent fallback


def test_cpu_wrappers_count_no_launches(qparams, jax_chain):
    _, q = qparams
    tf2.reset_launch_counts()
    tfd.reset_launch_counts()
    y0 = torch.from_numpy(jax_chain["y0"][:, :32, :32]).contiguous()
    tfd.up1_s2d16(y0, q["up1_ps"])
    tf2.convt4x4s2_in_relu_requant_ps(y0, q["up1_ps"])
    assert set(tf2.LAUNCHES.values()) == set(tfd.LAUNCHES.values()) == {0}


def _fake_cuda(shape, dtype):
    t = mock.Mock(spec=torch.Tensor)
    t.device, t.dtype, t.shape = torch.device("cuda", 0), dtype, torch.Size(shape)
    t.dim.return_value = len(shape)
    t.is_contiguous.return_value = True
    return t


@pytest.mark.parametrize("site", ["up0", "up1", "final7"])
def test_cuda_tensor_without_nvcc_raises(site, monkeypatch):
    """A CUDA tensor launches the kernel or raises: with no build, it raises."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "library_path", lambda name: mock.Mock(exists=lambda: False))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    monkeypatch.setenv("NVCC", "")
    tf2.reset_launch_counts()
    tfd.reset_launch_counts()
    with mock.patch.object(tf2, "convt4x4s2_in_relu_requant_ps_plain") as plain_up0, \
            mock.patch.object(tfd, "up1_s2d16_plain") as plain_up1, \
            mock.patch.object(tfd, "final7_tanh_u8_plain") as plain_final7:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            if site == "up0":
                tf2.convt4x4s2_in_relu_requant_ps(_fake_cuda((2, 64, 64, 256), torch.int8),
                                                  _fake_cuda((16 * 256, 128), torch.int8))
            elif site == "up1":
                tfd.up1_s2d16(_fake_cuda((2, 128, 128, 128), torch.int8),
                              _fake_cuda((16 * 128, 64), torch.int8))
            else:
                tfd.final7_tanh_u8(_fake_cuda((2, 256, 256, 64), torch.int8),
                                   _fake_cuda((3, 64, 7, 7), torch.int8),
                                   _fake_cuda((3,), torch.float32), _fake_cuda((3,), torch.float32),
                                   _fake_cuda((2, 1), torch.float32))
        for plain in (plain_up0, plain_up1, plain_final7):
            plain.assert_not_called()
    assert set(tf2.LAUNCHES.values()) == set(tfd.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("site", ["up0", "final7"])
def test_non_cuda_device_raises(site):
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        if site == "up0":
            tf2.convt4x4s2_in_relu_requant_ps(torch.empty((1, 16, 16, 64), dtype=torch.int8, **meta),
                                              torch.empty((16 * 64, 64), dtype=torch.int8, **meta))
        else:
            tfd.final7_tanh_u8(torch.empty((1, 16, 32, 64), dtype=torch.int8, **meta),
                               torch.empty((3, 64, 7, 7), dtype=torch.int8, **meta),
                               torch.empty(3, **meta), torch.empty(3, **meta),
                               torch.empty((1, 1), **meta))
