"""One train step of the port against the JAX package's on the unbatched branch.

Above ``BATCH_FORWARDS_MAX`` (16) images the step runs each generator,
discriminator and VGG forward on its own instead of sharing launches. Both
steps are driven onto that branch at batch 2 (the JAX step with
``batch_forwards=False, vgg_pair=False``), at MSIG_CONV_VJP=0; 32², one
resblock, the tolerances and their reasons as in
``tests/test_torch_port_train_step_common.py``.
"""

import numpy as np
import pytest

import test_torch_port_train_step_common as tp


@pytest.fixture(scope="module")
def both():
    return tp.run_both("0", False, batched=False)


@pytest.mark.parametrize("key", ["D_loss", "G_loss", "gan", "cycle", "identity", "content", "style"])
def test_losses_match(both, key):
    np.testing.assert_allclose(both["metrics"][key], both["jax_metrics"][key], rtol=1e-4)


@pytest.mark.parametrize("key", ["g_grad_norm", "d_grad_norm"])
def test_pre_clip_grad_norms_match(both, key):
    np.testing.assert_allclose(both["metrics"][key], both["jax_metrics"][key], rtol=1e-3)


@pytest.mark.parametrize("net", ["G_A2B", "SE_A", "D_B"])
def test_updated_params_match(both, net):
    g = net in tp.G_KEYS_J
    group, keys, lr = ("gen_params", tp.G_KEYS_J, tp.G_LR) if g else ("disc_params", tp.D_KEYS_J,
                                                                       tp.D_LR)
    mu = (both["jax_new"].opt_g if g else both["jax_new"].opt_d)[1].mu
    got = tp.to_tree(net, both["state"].models.nets[net].state_dict())
    tp.check_params(got, getattr(both["jax_new"], group)[net]["params"], mu[net]["params"],
                    step_bound=2 * lr,
                    mask_at=tp.TIGHT_FRACTION * tp.group_max([mu[k]["params"] for k in keys]))


@pytest.mark.parametrize("group", ["g", "d"])
def test_first_moments_match(both, group):
    keys = tp.G_KEYS_J if group == "g" else tp.D_KEYS_J
    opt = getattr(both["state"], f"opt_{group}")
    jopt = getattr(both["jax_new"], f"opt_{group}")[1]
    by_name = tp.moments_by_name(both["state"], keys, opt.mu)
    tp.check_moments([tp.to_tree(k, by_name[k]) for k in keys],
                     [jopt.mu[k]["params"] for k in keys], 1e-3)
