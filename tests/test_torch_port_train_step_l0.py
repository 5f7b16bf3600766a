"""One train step of the port against the JAX package's at MSIG_CONV_VJP=0.

Stock autograd throughout: the trunk is the NCHW chain of the serving path.
Same parameters, batch and VGG on both sides, 32², batch 2, one resblock;
the tolerances and their reasons are in ``tests/test_torch_port_train_step_common.py``.
"""

import numpy as np
import pytest

import test_torch_port_train_step_common as tp

LEVEL, USE_PALLAS = "0", False


@pytest.fixture(scope="module")
def both():
    return tp.run_both(LEVEL, USE_PALLAS)


@pytest.mark.parametrize("key", ["D_loss", "G_loss", "gan", "cycle", "identity", "content", "style"])
def test_losses_match(both, key):
    np.testing.assert_allclose(both["metrics"][key], both["jax_metrics"][key], rtol=1e-4)


@pytest.mark.parametrize("key", ["g_grad_norm", "d_grad_norm"])
def test_pre_clip_grad_norms_match(both, key):
    np.testing.assert_allclose(both["metrics"][key], both["jax_metrics"][key], rtol=1e-3)


@pytest.mark.parametrize("net", ["G_A2B", "G_B2A", "SE_A", "SE_B", "D_A", "D_B"])
def test_updated_params_match(both, net):
    g = net in tp.G_KEYS_J
    group, keys, lr = ("gen_params", tp.G_KEYS_J, tp.G_LR) if g else ("disc_params", tp.D_KEYS_J,
                                                                       tp.D_LR)
    mu = (both["jax_new"].opt_g if g else both["jax_new"].opt_d)[1].mu
    got = tp.to_tree(net, both["state"].models.nets[net].state_dict())
    tp.check_params(got, getattr(both["jax_new"], group)[net]["params"], mu[net]["params"],
                    step_bound=2 * lr,
                    mask_at=tp.TIGHT_FRACTION * tp.group_max([mu[k]["params"] for k in keys]))


@pytest.mark.parametrize("net", ["G_A2B", "SE_B"])
def test_ema_params_match(both, net):
    mu = both["jax_new"].opt_g[1].mu
    got = tp.to_tree(net, both["state"].models.ema[net].state_dict())
    tp.check_params(got, both["jax_new"].ema_params[net]["params"], mu[net]["params"],
                    step_bound=2 * tp.G_LR * (1 - 0.995) + tp.TIGHT_ATOL,
                    mask_at=tp.TIGHT_FRACTION * tp.group_max([mu[k]["params"] for k in tp.G_KEYS_J]))


@pytest.mark.parametrize("group", ["g", "d"])
@pytest.mark.parametrize("moment,rtol", [("mu", 1e-3), ("nu", 2e-3)])
def test_adam_moments_match(both, group, moment, rtol):
    keys = tp.G_KEYS_J if group == "g" else tp.D_KEYS_J
    opt = getattr(both["state"], f"opt_{group}")
    jopt = getattr(both["jax_new"], f"opt_{group}")[1]
    assert opt.count == int(jopt.count) == 1
    by_name = tp.moments_by_name(both["state"], keys, getattr(opt, moment))
    tp.check_moments([tp.to_tree(k, by_name[k]) for k in keys],
                     [getattr(jopt, moment)[k]["params"] for k in keys], rtol)


def test_step_routes_each_trunk_site(both):
    """The port's step reached the kernel wrappers its level routes to, once per
    trunk site and generator launch: 2 sites x 1 resblock x 3 launches
    (2B, 2B, B); 48 per step at 8 resblocks."""
    assert both["calls"] == {}
