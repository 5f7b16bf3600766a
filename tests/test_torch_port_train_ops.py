"""Parity of the port's training ops, losses and networks with the JAX package, on the CPU.

Each kernel's plain version against the JAX kernel in Pallas interpret mode
(rows 22-24 of PERF.md's table: ``adain_pallas`` forward and backward,
``conv3x3_bwd``, ``conv3x3_adain_bwd``), at the trunk shape of a 32² train
step ([2, 8, 8, 256], fp32). Bars: rtol 1e-4 / atol 1e-5 for the AdaIN
forward (``tests/test_adain_pallas.py:35``); rtol 1e-3 / atol 1e-4 x max|ref|
for every gradient; dx exactly 0 under the relu mask; dbeta exactly sum(g).
Each ``autograd.Function`` against finite differences (``gradcheck``, float64).
The discriminator, VGG features, Gram, criteria, perceptual losses and
schedules against JAX in fp32 at rtol 1e-3 / atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msig_tpu.losses import criteria as jcrit
from msig_tpu.losses import vgg as jvgg
from msig_tpu.models import MultiDomainDiscriminator as JDisc
from msig_tpu.models import StyleCycleGANGenerator as JGen
from msig_tpu.ops import adain_pallas as jap
from msig_tpu.ops import conv3x3_vjp as jcv
from msig_tpu.ops.gram import gram_matrix as jgram
from msig_tpu.train import schedule as jsched

from msig_tpu_torch.compat import from_jax as fj
from msig_tpu_torch.losses import criteria, vgg
from msig_tpu_torch.models import MultiDomainDiscriminator, StyleCycleGANGenerator
from msig_tpu_torch.models.layers import conv_vjp_level, leaky_relu
from msig_tpu_torch.ops import adain_pallas as ap
from msig_tpu_torch.ops import conv3x3_vjp as cv
from msig_tpu_torch.ops.gram import gram_matrix
from msig_tpu_torch.train import schedule

B, S, C = 2, 8, 256  # the trunk of a 32² train step


def _rand(shape, seed, scale=1.0, loc=0.0):
    return np.random.default_rng(seed).normal(loc, scale, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _grad_close(got, want, name):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-3,
                               atol=1e-4 * float(np.abs(want).max()), err_msg=name)


# ------------------------------------------------------------ row 22: adain_pallas


def test_adain_fwd_plain_matches_pallas():
    x = _rand((B, S * S, C), 0, 2.0, 0.3)
    g, b = _rand((B, C), 1, 0.5, 1.0), _rand((B, C), 2, 0.5)
    want = jap._call_fwd(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5)
    got = ap.adain_fwd(_t(x), _t(g), _t(b))
    for name, gt, wt in zip(("y", "mean", "rstd"), got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-4, atol=1e-5, err_msg=name)


def test_adain_bwd_plain_matches_pallas():
    x, dy = _rand((B, S * S, C), 3, 2.0, 0.3), _rand((B, S * S, C), 4)
    g = _rand((B, C), 5, 0.5, 1.0)
    _, m, r = jap._call_fwd(jnp.asarray(x), jnp.asarray(g), jnp.zeros((B, C)), 1e-5)
    want = jap._call_bwd(jnp.asarray(x), jnp.asarray(g), m, r, jnp.asarray(dy))
    got = ap.adain_bwd(_t(x), _t(g), _t(m), _t(r), _t(dy))
    for name, gt, wt in zip(("dx", "dgamma", "dbeta"), got, want):
        _grad_close(gt.numpy(), wt, name)
    assert torch.equal(got[2], _t(dy).sum(dim=1)), "dbeta is exactly sum(dy)"


def test_adain_pallas_grads_match_jax_custom_vjp():
    """The autograd.Function end to end against ``jax.vjp`` of the JAX custom_vjp."""
    x, gy = _rand((B, S, S, C), 6, 1.5), _rand((B, S, S, C), 7)
    g, b = _rand((B, C), 8, 0.5, 1.0), _rand((B, C), 9, 0.5)
    y_j, vjp = jax.vjp(lambda x, g, b: jap.adain_pallas(x, g, b), jnp.asarray(x), jnp.asarray(g),
                       jnp.asarray(b))
    want = vjp(jnp.asarray(gy))
    xt, gt, bt = (_t(a).requires_grad_() for a in (x, g, b))
    y = ap.adain_pallas(xt, gt, bt)
    y.backward(_t(gy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), rtol=1e-4, atol=1e-5)
    for name, got, w in zip(("dx", "dgamma", "dbeta"), (xt.grad, gt.grad, bt.grad), want):
        _grad_close(got.numpy(), w, name)


def test_adain_pallas_copies_a_non_dense_input_once_and_counts_it():
    """An x or cotangent that is not dense NHWC is copied by the wrapper, and
    each copy counted in ``COPIES``; a dense one is not."""
    x = _rand((B, C, S, S), 61)  # NCHW storage: its NHWC view is not dense
    gamma, beta, g = _rand((B, C), 62, 0.5, 1.0), _rand((B, C), 63), _rand((B, C, S, S), 64)
    want = ap.adain_pallas(_t(x).permute(0, 2, 3, 1).contiguous(), _t(gamma), _t(beta))
    ap.reset_launch_counts()
    xt = _t(x).requires_grad_()
    y = ap.adain_pallas(xt.permute(0, 2, 3, 1), _t(gamma), _t(beta))
    assert ap.COPIES == {ap.FWD: 1, ap.BWD: 0}
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    y.backward(_t(g).permute(0, 2, 3, 1))
    assert ap.COPIES == {ap.FWD: 1, ap.BWD: 1}
    ap.reset_launch_counts()
    ap.adain_pallas(want.contiguous(), _t(gamma), _t(beta))
    assert ap.COPIES == {ap.FWD: 0, ap.BWD: 0}


@pytest.mark.parametrize("shape,dtype,ok", [
    ((2, 8, 8, 256), torch.float32, True), ((2, 8, 8, 128), torch.bfloat16, True),
    ((2, 8, 8, 64), torch.float32, False), ((2, 8, 8, 256), torch.float64, False),
    ((1, 160, 160, 128), torch.float32, False), ((8, 256), torch.float32, False)])
def test_adain_supported_follows_the_tpu_domain(shape, dtype, ok):
    x = torch.zeros(shape, dtype=dtype)
    assert ap.supported(x) == ok
    if len(shape) == 4 and dtype != torch.float64:
        assert jap.supported(jnp.zeros(shape, getattr(jnp, str(dtype)[6:]))) == ok


# --------------------------------------------------- rows 23-24: conv3x3 backward


@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_bwd_plain_matches_pallas(relu):
    x = _rand((B, S, S, C), 10)
    w = _rand((3, 3, C, C), 11, 1.0 / 48)
    dy = _rand((B, S, S, C), 12)
    dx_j, dw_j = jcv.conv3x3_bwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(dy), relu_input=relu)
    dx, dw = cv.conv3x3_bwd(_t(x), _t(w), _t(dy), relu_input=relu)
    _grad_close(dx.numpy(), dx_j, "dx")
    _grad_close(dw.numpy(), dw_j, "dw")
    if relu:
        assert (dx.numpy()[x <= 0] == 0).all(), "dx is exactly 0 where x <= 0"


@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_adain_bwd_plain_matches_pallas(relu):
    x = _rand((B, S, S, C), 13)
    w = _rand((3, 3, C, C), 14, 1.0 / 48)
    gamma, beta, g = _rand((B, C), 15, 0.5, 1.0), _rand((B, C), 16, 0.5), _rand((B, S, S, C), 17)
    _, (y, mu, r) = jcv._adain_unit_fwd_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gamma),
                                             jnp.asarray(beta), relu)
    want = jcv.conv3x3_adain_bwd(jnp.asarray(x), jnp.asarray(w), y, mu, r, jnp.asarray(gamma),
                                 jnp.asarray(g), relu_input=relu)
    got = cv.conv3x3_adain_bwd(_t(x), _t(w), _t(y), _t(mu), _t(r), _t(gamma), _t(g),
                               relu_input=relu)
    for name, gt, wt in zip(("dx", "dw", "dgamma", "dbeta"), got, want):
        _grad_close(gt.numpy(), wt, name)
    assert torch.equal(got[3], _t(g).sum(dim=(1, 2))), "dbeta is exactly sum(g)"
    if relu:
        assert (got[0].numpy()[x <= 0] == 0).all()


@pytest.mark.parametrize("relu", [False, True])
def test_adain_unit_forward_matches_jax(relu):
    x, w = _rand((B, S, S, C), 18), _rand((3, 3, C, C), 19, 1.0 / 48)
    gamma, beta = _rand((B, C), 20, 0.5, 1.0), _rand((B, C), 21, 0.5)
    want, saved = jcv._adain_unit_fwd_impl(*(jnp.asarray(a) for a in (x, w, gamma, beta)), relu)
    unit = cv.relu_conv3x3_adain if relu else cv.conv3x3_adain
    np.testing.assert_allclose(unit(_t(x), _t(w), _t(gamma), _t(beta)).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    _, mine = cv._adain_unit_fwd_impl(_t(x), _t(w), _t(gamma), _t(beta), relu)
    for a, b in zip(mine, saved):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def _f64(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 1, s)).requires_grad_() for s in shapes]


@pytest.mark.parametrize("fn", ["conv3x3_same", "relu_conv3x3"])
def test_conv3x3_function_gradcheck(fn):
    x, w = _f64((1, 3, 3, 4), (3, 3, 4, 3))
    assert torch.autograd.gradcheck(getattr(cv, fn), (x, w))


@pytest.mark.parametrize("fn", ["conv3x3_adain", "relu_conv3x3_adain"])
def test_conv3x3_adain_function_gradcheck(fn):
    x, w, g, b = _f64((2, 3, 3, 4), (3, 3, 4, 3), (2, 3), (2, 3), seed=1)
    assert torch.autograd.gradcheck(getattr(cv, fn), (x, w, g, b))


def test_adain_pallas_function_gradcheck():
    x, g, b = _f64((2, 3, 3, 4), (2, 4), (2, 4), seed=2)
    assert torch.autograd.gradcheck(ap.adain_pallas, (x, g, b))


def test_functions_match_autograd_of_their_plain_composition():
    """The fused backwards against torch autograd through the stock ops, fp32."""
    x, w = _rand((B, S, S, C), 22), _rand((3, 3, C, C), 23, 1.0 / 48)
    gamma, beta, g = _rand((B, C), 24, 0.5, 1.0), _rand((B, C), 25, 0.5), _rand((B, S, S, C), 26)
    xt, wt, gt, bt = (_t(a).requires_grad_() for a in (x, w, gamma, beta))
    cv.relu_conv3x3_adain(xt, wt, gt, bt).backward(_t(g))
    fused = [t.grad.clone() for t in (xt, wt, gt, bt)]
    for t in (xt, wt, gt, bt):
        t.grad = None
    from msig_tpu_torch.ops.norm import adain_modulate
    adain_modulate(cv.conv3x3_nhwc(torch.relu(xt), wt), gt, bt).backward(_t(g))
    for name, a, t in zip(("dx", "dw", "dgamma", "dbeta"), fused, (xt, wt, gt, bt)):
        _grad_close(a.numpy(), t.grad.numpy(), name)


@pytest.mark.parametrize("x_shape,k_shape,ok", [
    ((2, 8, 8, 256), (3, 3, 256, 256), True), ((2, 64, 64, 256), (3, 3, 256, 256), True),
    ((2, 8, 8, 64), (3, 3, 64, 64), False), ((2, 12, 12, 256), (3, 3, 256, 256), False),
    ((2, 8, 16, 256), (3, 3, 256, 256), False), ((2, 8, 8, 256), (4, 4, 256, 256), False)])
def test_conv_supported_is_the_jax_domain_rule(x_shape, k_shape, ok):
    args = (x_shape, k_shape, 1, ((1, 1), (1, 1)), "zeros")
    assert cv.supported(*args) == jcv.supported(*args) == ok


@pytest.mark.parametrize("value,level", [("0", 0), ("1", 1), ("2", 2), ("3", None),
                                         ("yes", None), ("", None)])
def test_msig_conv_vjp_is_read_strictly(monkeypatch, value, level):
    monkeypatch.setenv("MSIG_CONV_VJP", value)
    if level is None:
        with pytest.raises(ValueError, match="MSIG_CONV_VJP"):
            conv_vjp_level()
    else:
        assert conv_vjp_level() == level


# ----------------------------------------------------------------- networks


@pytest.mark.parametrize("level,pallas", [("0", False), ("0", True), ("1", True), ("2", False)])
def test_generator_routes_match_jax(monkeypatch, level, pallas):
    """The generator's forward and input gradient at each MSIG_CONV_VJP level
    against the JAX generator at the same level, 32² and one resblock."""
    monkeypatch.setenv("MSIG_CONV_VJP", level)
    jgen = JGen(style_dim=16, n_residual_blocks=1, use_pallas=pallas)
    img, style = _rand((2, 32, 32, 3), 27), _rand((2, 16), 28)
    params = jgen.init(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(style))
    y_j, vjp = jax.vjp(lambda p, x: jgen.apply(p, x, jnp.asarray(style)), params,
                       jnp.asarray(img))
    gy = _rand(y_j.shape, 29)
    dp_j, dx_j = vjp(jnp.asarray(gy))
    gen = StyleCycleGANGenerator(style_dim=16, n_residual_blocks=1, use_pallas=pallas)
    gen.load_state_dict(fj.generator_state_dict(jax.device_get(params), 1))
    xt = _t(img).requires_grad_()
    y = gen(xt, _t(style))
    y.backward(_t(gy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), rtol=1e-3, atol=1e-4)
    _grad_close(xt.grad.numpy(), dx_j, "d image")
    w_grad = fj.generator_params({k: torch.zeros_like(p) if p.grad is None else p.grad
                                  for k, p in gen.named_parameters()}, 1)
    for name in ("conv1", "conv2"):
        _grad_close(w_grad["params"]["resblock0"][name]["kernel"],
                    dp_j["params"]["resblock0"][name]["kernel"], f"resblock0.{name}")


def test_discriminator_matches_jax():
    jd = JDisc(num_domains=3)
    img = _rand((2, 32, 32, 3), 30)
    idx = np.array([2, 1], np.int32)
    params = jd.init(jax.random.PRNGKey(1), jnp.asarray(img), jnp.asarray(idx))
    d = MultiDomainDiscriminator(num_domains=3)
    d.load_state_dict(fj.discriminator_state_dict(jax.device_get(params), 3))
    for dom in (jnp.asarray(idx), None):
        want = np.asarray(jd.apply(params, jnp.asarray(img), dom))
        got = d(_t(img), None if dom is None else torch.from_numpy(idx)).detach().numpy()
        assert got.shape == want.shape == ((2, 2, 2, 1))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    back = fj.discriminator_params(d.state_dict(), 3)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.device_get(params))):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_leaky_relu_matches_jax_including_its_gradient_at_zero():
    from msig_tpu.models.layers import leaky_relu as jleaky

    x = np.array([-2.0, -0.0, 0.0, 1.5], np.float32)
    np.testing.assert_array_equal(leaky_relu(_t(x)).numpy(), np.asarray(jleaky(jnp.asarray(x))))
    xt = _t(x).requires_grad_()
    leaky_relu(xt).sum().backward()
    want = jax.grad(lambda v: jleaky(v).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


# ------------------------------------------------------------- losses


@pytest.fixture(scope="module")
def vgg_pair():
    jp = jvgg.init_vgg_params()
    v = vgg.VGGPrefix()
    v.load_state_dict(fj.vgg_state_dict(jax.device_get(jp)))
    return jp, v


def test_vgg_features_match_jax(vgg_pair):
    jp, v = vgg_pair
    img = np.tanh(_rand((2, 32, 32, 3), 31))
    want = jvgg.vgg_features(jp, jnp.asarray(img))
    got = vgg.vgg_features(v, _t(img))
    assert [tuple(f.shape) for f in got] == [f.shape for f in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("fn", ["style_content_loss", "style_content_loss_pair",
                                "style_content_loss_pair2"])
def test_perceptual_losses_match_jax(vgg_pair, fn):
    jp, v = vgg_pair
    imgs = [np.tanh(_rand((2, 32, 32, 3), 40 + i)) for i in range(4)]
    want = getattr(jvgg, fn)(jp, *(jnp.asarray(a) for a in (imgs if fn != "style_content_loss"
                                                              else imgs[:3])))
    got = getattr(vgg, fn)(v, *(_t(a) for a in (imgs if fn != "style_content_loss" else imgs[:3])))
    np.testing.assert_allclose(np.asarray(jax.tree.leaves(got), np.float32),
                               np.asarray(jax.tree.leaves(want), np.float32), rtol=1e-3, atol=1e-6)


def test_gram_matches_jax():
    f = _rand((2, 8, 8, 64), 32)
    np.testing.assert_allclose(gram_matrix(_t(f)).numpy(), np.asarray(jgram(jnp.asarray(f))),
                               rtol=1e-3, atol=1e-4)


def test_criteria_match_jax():
    a, b = _rand((2, 4, 4, 1), 33), _rand((2, 4, 4, 1), 34)
    for got, want in ((criteria.lsgan_real(_t(a)), jcrit.lsgan_real(jnp.asarray(a))),
                      (criteria.lsgan_fake(_t(a)), jcrit.lsgan_fake(jnp.asarray(a))),
                      (criteria.l1_loss(_t(a), _t(b)), jcrit.l1_loss(jnp.asarray(a), jnp.asarray(b)))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_random_vgg_is_seeded_and_has_torch_default_bounds():
    a, b = vgg.init_random_vgg(1234, device="cpu"), vgg.init_random_vgg(1234, device="cpu")
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), k
    assert float(a.conv1.weight.abs().max()) <= 1.0 / np.sqrt(9 * 64)
    assert not any(p.requires_grad for p in a.parameters())


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("build", ["create_train_state", "Models.from_config", "get_vgg",
                                   "init_random_vgg"])
def test_train_constructors_default_to_the_card(monkeypatch, build):
    """With no device said, the train state lives on cfg.device ('cuda' by
    default), so on a machine without a card it raises instead of training on
    the CPU; the VGG constructors take the device as a required keyword."""
    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.train import Models, create_train_state

    _no_card(monkeypatch)
    cfg = TrainConfig(n_residual_blocks=1, style_dim=16)
    assert cfg.device == "cuda"
    call = {"create_train_state": lambda: create_train_state(cfg, 2),
            "Models.from_config": lambda: Models.from_config(cfg, 2),
            "get_vgg": lambda: vgg.get_vgg(None, device="cuda"),
            "init_random_vgg": lambda: vgg.init_random_vgg(1234, device="cuda")}[build]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        call()
    if "vgg" in build:
        with pytest.raises(TypeError, match="device"):
            getattr(vgg, build)(None) if build == "get_vgg" else vgg.init_random_vgg(1234)


# ------------------------------------------------------------- schedule


def test_schedules_match_jax():
    for epoch in range(0, 210, 7):
        assert schedule.cosine_lr(2e-4, epoch, 200) == jsched.cosine_lr(2e-4, epoch, 200)
        assert schedule.loss_weight_factor(epoch) == jsched.loss_weight_factor(epoch)
        w = {"gan": 1.0, "cycle": 10.0, "identity": 5.0, "content": 1.0, "style": 1.0}
        assert (schedule.weights_vector(schedule.current_loss_weights(w, epoch, 3, 50))
                == jsched.weights_vector(jsched.current_loss_weights(w, epoch, 3, 50)))
    assert schedule.WEIGHT_KEYS == jsched.WEIGHT_KEYS
