"""Parity of the port's float networks and weight carry with the JAX package.

The same flax params go into both packages (the port's through
``compat.from_jax``); outputs are compared in fp32 with the bar of
tests/test_torch_import.py (rtol 1e-3, atol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msig_tpu.compat.torch_export import export_generator, export_style_encoder
from msig_tpu.infer.loading import _load_npz
from msig_tpu.models import MultiDomainStyleEncoder as JStyleEncoder
from msig_tpu.models import StyleCycleGANGenerator as JGenerator
from msig_tpu_torch.compat.from_jax import generator_state_dict, style_encoder_state_dict
from msig_tpu_torch.models import MultiDomainStyleEncoder, StyleCycleGANGenerator

DEMO = "results/tomato_r3b/demo_checkpoint"


@pytest.fixture(autouse=True)
def _full_fp32():
    """The float parity checks compare true fp32 (no TF32 on a card)."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _port_generator(params, n_res, style_dim):
    g = StyleCycleGANGenerator(style_dim=style_dim, n_residual_blocks=n_res)
    g.load_state_dict(generator_state_dict(params, n_res), strict=True)
    return g.eval()


def _port_style_encoder(params, num_domains, style_dim):
    se = MultiDomainStyleEncoder(style_dim=style_dim, num_domains=num_domains)
    se.load_state_dict(style_encoder_state_dict(params, num_domains, style_dim), strict=True)
    return se.eval()


@pytest.fixture(scope="module")
def demo():
    gen, se, meta, _ = _load_npz(DEMO, 10)
    return gen, se, meta


# ------------------------------------------------ (c) random params at 64²


def test_generator_matches_jax_fp32():
    n_res, sdim = 2, 64
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    style = rng.normal(0, 1, (2, sdim)).astype(np.float32)
    jgen = JGenerator(style_dim=sdim, n_residual_blocks=n_res)
    params = jgen.init(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(style))
    want = np.asarray(jgen.apply(params, jnp.asarray(img), jnp.asarray(style)))
    with torch.no_grad():
        got = _port_generator(params, n_res, sdim)(torch.from_numpy(img),
                                                   torch.from_numpy(style)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_style_encoder_matches_jax_fp32():
    ndom, sdim = 3, 16
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    idx = np.array([2, 0, 1], np.int32)
    jse = JStyleEncoder(style_dim=sdim, num_domains=ndom)
    params = jse.init(jax.random.PRNGKey(1), jnp.asarray(img), jnp.asarray(idx))
    se = _port_style_encoder(params, ndom, sdim)
    with torch.no_grad():
        for d in (idx, None):
            want = np.asarray(jse.apply(params, jnp.asarray(img),
                                        None if d is None else jnp.asarray(d)))
            got = se(torch.from_numpy(img),
                     None if d is None else torch.from_numpy(d)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def test_port_init_is_torch_default():
    """TorchConv/TorchDense keep torch's U(-1/sqrt(fan_in), 1/sqrt(fan_in)) init."""
    torch.manual_seed(0)
    g = StyleCycleGANGenerator(style_dim=8, n_residual_blocks=1)
    w = g.decoder[0].conv1.weight
    bound = 1.0 / np.sqrt(256 * 9)
    m = float(w.detach().abs().max())
    assert 0.9 * bound < m <= bound


# ------------------------------------- from_jax vs the reference exporter


def test_from_jax_matches_torch_export_on_demo(demo):
    gen, se, meta = demo
    n_res, sdim = meta["n_residual_blocks"], meta["style_dim"]
    for got, want in ((generator_state_dict(gen, n_res), export_generator(gen, n_res)),
                      (style_encoder_state_dict(se, 10, sdim), export_style_encoder(se, 10, sdim))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_from_jax_rejects_wrong_domain_count(demo):
    _, se, meta = demo
    with pytest.raises(ValueError, match="num_domains"):
        style_encoder_state_dict(se, 9, meta["style_dim"])


# ----------------------------------------- (e) demo checkpoint at 256², B=1


def test_demo_generator_matches_jax_fp32_256(demo):
    gen, se, meta = demo
    n_res, sdim = meta["n_residual_blocks"], meta["style_dim"]
    rng = np.random.default_rng(2)
    img = rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    ref = rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    idx = np.array([4], np.int32)
    jse = JStyleEncoder(style_dim=sdim, num_domains=10)
    jgen = JGenerator(style_dim=sdim, n_residual_blocks=n_res)
    style = jse.apply(se, jnp.asarray(ref), jnp.asarray(idx))
    want = np.asarray(jgen.apply(gen, jnp.asarray(img), style))
    with torch.no_grad():
        tstyle = _port_style_encoder(se, 10, sdim)(torch.from_numpy(ref), torch.from_numpy(idx))
        np.testing.assert_allclose(tstyle.numpy(), np.asarray(style), rtol=1e-3, atol=1e-4)
        got = _port_generator(gen, n_res, sdim)(
            torch.from_numpy(img), torch.from_numpy(np.array(style))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
