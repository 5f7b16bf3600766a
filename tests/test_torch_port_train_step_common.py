"""One train step of the port against ``msig_tpu.train.make_train_step``: the helpers
of ``tests/test_torch_port_train_step_l{0,1,2}.py`` (one file per ``MSIG_CONV_VJP``
level, so that the three JAX compilations run on different workers). No tests here.

Both packages start from the same parameters (the JAX package's init, carried
across with ``msig_tpu_torch.compat.from_jax``), the same uint8 batch and the
same random VGG (the JAX arrays), at 32², batch 2, one resblock, style_dim 16,
three domains (``tests/test_train_step.py:20-26``). The JAX step runs its
Pallas kernels in interpret mode.

Tolerances, and why:
  - metrics: rtol 1e-4; the pre-clip grad norms rtol 1e-3.
  - Adam moments: rtol 1e-3 (first moment) and 2e-3 (second), atol 1e-4 x the
    largest moment of the optimizer group (the gradient bar of the kernels).
  - updated parameters: Adam's first update is lr * g / (|g| + 1e-8), about
    lr * sign(g). Where the exact gradient is 0, float noise sets its sign:
    the conv biases in front of an instance norm at levels 0 and 1, and any
    element whose gradient is near zero. So every element is held to
    |delta| <= 2 * lr (what a flipped sign can move), and every element whose
    JAX first moment is at least 1e-3 x the largest of its optimizer group (ten
    times the moments' absolute bar, where the gradient's sign is settled) to
    |delta| <= 1e-7, i.e. 5e-4 of a step.
  - EMA: the same masks, with the step bound scaled by 1 - beta.
"""

from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp

BATCH, SIZE, SDIM, ND, N_RES = 2, 32, 16, 3, 1
G_LR, D_LR = 2e-4, 1e-4
TIGHT_FRACTION, TIGHT_ATOL = 1e-3, 1e-7


def run_both(level: str, use_pallas: bool, batched: bool = True):
    """Run one step in both packages at ``MSIG_CONV_VJP=level``; returns a dict.

    ``batched=False`` takes both steps' unbatched branch (each forward on its
    own, the path of a batch above 16): the JAX step by its ``batch_forwards``
    and ``vgg_pair`` switches, the port's by lowering its ``BATCH_FORWARDS_MAX``."""
    import torch

    from msig_tpu.config import TrainConfig as JConfig
    from msig_tpu.losses import init_vgg_params
    from msig_tpu.train import Models as JModels
    from msig_tpu.train import create_train_state as j_create
    from msig_tpu.train import current_loss_weights, make_optimizers, weights_vector
    from msig_tpu.train import make_train_step as j_make

    from msig_tpu_torch.compat import from_jax as fj
    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.losses import VGGPrefix
    from msig_tpu_torch.ops import adain_pallas as ap
    from msig_tpu_torch.ops import conv3x3_vjp as cv
    from msig_tpu_torch.train import create_train_state, make_train_step
    from msig_tpu_torch.train import step as port_step

    old = os.environ.get("MSIG_CONV_VJP")
    os.environ["MSIG_CONV_VJP"] = level
    try:
        jcfg = JConfig(image_size=SIZE, batch_size=BATCH, style_dim=SDIM,
                       n_residual_blocks=N_RES, use_pallas=use_pallas)
        jm = JModels.from_config(jcfg, num_domains=ND)
        js = j_create(jcfg, jm, jax.random.PRNGKey(0))
        tx_g, tx_d = make_optimizers(jcfg)
        vgg = init_vgg_params()
        rng = np.random.default_rng(0)
        src = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
        trg = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
        dom = np.array([1, 2], np.int32)
        w = weights_vector(current_loss_weights(jcfg.loss_weights, 0))
        jbatch = {"source": jnp.asarray(src), "target": jnp.asarray(trg),
                  "source_domain": jnp.zeros((BATCH,), jnp.int32), "target_domain": jnp.asarray(dom)}
        switches = {} if batched else {"batch_forwards": False, "vgg_pair": False}
        step = jax.jit(j_make(jm, tx_g, tx_d, jcfg.ema_beta, **switches))
        jnew, jmet = step(js, jbatch, vgg, jnp.float32(G_LR), jnp.float32(D_LR),
                          jnp.asarray(w, jnp.float32))
        jnew, jmet, js = jax.device_get((jnew, jmet, js))

        cfg = TrainConfig(image_size=SIZE, batch_size=BATCH, style_dim=SDIM,
                          n_residual_blocks=N_RES, use_pallas=use_pallas, device="cpu")
        st = create_train_state(cfg, ND)
        nets = st.models.nets
        for k in ("G_A2B", "G_B2A"):
            nets[k].load_state_dict(fj.generator_state_dict(js.gen_params[k], N_RES))
        for k in ("SE_A", "SE_B"):
            nets[k].load_state_dict(fj.style_encoder_state_dict(js.gen_params[k], ND, SDIM))
        for k in ("D_A", "D_B"):
            nets[k].load_state_dict(fj.discriminator_state_dict(js.disc_params[k], ND))
        for k, e in st.models.ema.items():
            e.load_state_dict(nets[k].state_dict())
        v = VGGPrefix()
        v.load_state_dict(fj.vgg_state_dict(jax.device_get(vgg)))
        batch = {"source": torch.from_numpy(src), "target": torch.from_numpy(trg),
                 "source_domain": torch.zeros(BATCH, dtype=torch.int32),
                 "target_domain": torch.from_numpy(dom)}
        # count the calls of each kernel wrapper during the port's step
        calls, wrapped = {}, [(cv, "conv3x3_bwd"), (cv, "conv3x3_adain_bwd"), (ap, "adain_fwd"),
                              (ap, "adain_bwd")]
        originals = [getattr(mod, name) for mod, name in wrapped]
        batch_max = port_step.BATCH_FORWARDS_MAX
        port_step.BATCH_FORWARDS_MAX = batch_max if batched else BATCH - 1
        for (mod, name), fn in zip(wrapped, originals):
            def spy(*a, _f=fn, _n=name, **k):
                calls[_n] = calls.get(_n, 0) + 1
                return _f(*a, **k)
            setattr(mod, name, spy)
        try:
            met = make_train_step(cfg.ema_beta)(st, batch, v, G_LR, D_LR, w)
        finally:
            port_step.BATCH_FORWARDS_MAX = batch_max
            for (mod, name), fn in zip(wrapped, originals):
                setattr(mod, name, fn)
    finally:
        if old is None:
            del os.environ["MSIG_CONV_VJP"]
        else:
            os.environ["MSIG_CONV_VJP"] = old
    return dict(jax_old=js, jax_new=jnew, jax_metrics={k: float(x) for k, x in jmet.items()},
                state=st, metrics={k: float(x) for k, x in met.items()}, calls=calls)


def to_tree(net_key: str, sd):
    """A port state_dict (or moments by parameter name) -> the flax tree's 'params'."""
    from msig_tpu_torch.compat import from_jax as fj

    if net_key.startswith("G_"):
        return fj.generator_params(sd, N_RES)["params"]
    if net_key.startswith("SE_"):
        return fj.style_encoder_params(sd, ND)["params"]
    return fj.discriminator_params(sd, ND)["params"]


def moments_by_name(state, keys, moments):
    """Adam moments (a list in the group's parameter order) -> {net: {name: tensor}}."""
    out, i = {}, 0
    for k in keys:
        out[k] = {}
        for name, _ in state.models.nets[k].named_parameters():
            out[k][name] = moments[i]
            i += 1
    assert i == len(moments)
    return out


def leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def group_max(trees) -> float:
    return max(float(np.abs(x).max()) for t in trees for _, x in leaves(t))


def check_params(got_tree, want_tree, mu_tree, step_bound, mask_at):
    """Leaf by leaf: |delta| <= step_bound everywhere, <= TIGHT_ATOL where |mu| >= mask_at."""
    got, want, mu = leaves(got_tree), leaves(want_tree), leaves(mu_tree)
    assert [k for k, _ in got] == [k for k, _ in want] == [k for k, _ in mu]
    for (name, g), (_, w), (_, m) in zip(got, want, mu):
        assert g.shape == w.shape, name
        d = np.abs(g - w)
        assert d.max() <= step_bound, f"{name}: max |delta| {d.max():.3e} > {step_bound:.3e}"
        sel = np.abs(m) >= mask_at
        if sel.any():
            assert d[sel].max() <= TIGHT_ATOL, \
                f"{name}: max |delta| {d[sel].max():.3e} where |mu| >= {mask_at:.2e}"


def check_moments(got_trees, want_trees, rtol):
    """rtol, and atol 1e-4 x the largest moment of the optimizer group."""
    atol = 1e-4 * group_max(want_trees)
    for got_t, want_t in zip(got_trees, want_trees):
        for (name, g), (_, w) in zip(leaves(got_t), leaves(want_t)):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


G_KEYS_J = ("G_A2B", "G_B2A", "SE_A", "SE_B")
D_KEYS_J = ("D_A", "D_B")
