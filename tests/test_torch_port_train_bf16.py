"""The port's bf16 train step (``compute_dtype=torch.bfloat16``) against the JAX
package's bf16 step, at step 1.

Both start from the port's initial state (torch's default init from
``torch.Generator(0)``) and its seeded random VGG, at 64², 2 resblocks,
style_dim 16, 3 domains, batch 2. The JAX side is the golden file that
``tools/train_bf16_golden.py`` writes from ``msig_tpu.train.make_train_step``
(``compute_dtype=bfloat16``, ``MSIG_CONV_VJP=0``, on the CPU); the ``-m
slow`` test runs that JAX step live. A bf16 step parts from JAX's faster than
an fp32 one, so step 1 is held, not a trajectory.

Bars, and why (measured here: losses within 1.6e-3, grad norms within
1.2e-2, kernel leaves' first-moment norms within 5.6e-2):
  - losses rtol 1e-2; the pre-clip grad norms rtol 5e-2;
  - each leaf's norm of Adam's first moment (half the clipped gradient):
    within 0.15 of JAX's plus 5% of the group's largest leaf norm, the scale
    below which a leaf's gradient is bf16 rounding (the conv biases that an
    instance norm removes have an exact gradient of 0 and sit at 1e-3 of it);
  - the updated parameters at the golden's sampled positions: Adam's first
    update is about lr * sign(g), so every element within 2 * lr (what a
    flipped sign moves it), and within 1e-7 where JAX's first moment is at
    least 0.2 of its group's largest (where bf16 rounding cannot flip the
    sign); the EMA likewise, the step bound scaled by 1 - beta.

The fp32 training kernels of ``MSIG_CONV_VJP=1|2`` (rows 23-24) stay fp32
under bf16: their inputs are cast to fp32 at the autograd boundary and dx
comes back in bf16. ``test_kernel_routes_take_fp32_under_bf16`` holds both
routes to the same bars and checks what their wrappers receive.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from msig_tpu_torch.compat import from_jax as fj
from msig_tpu_torch.losses import init_random_vgg
from msig_tpu_torch.ops import adain_pallas as ap
from msig_tpu_torch.ops import conv3x3_vjp as cv
from msig_tpu_torch.train import create_train_state, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "train_bf16_golden", os.path.join(ROOT, "tools", "train_bf16_golden.py"))
tg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tg)

LOSS_RTOL, NORM_RTOL = 1e-2, 5e-2
MU_RTOL, MU_ATOL_OF_MAX = 0.15, 0.05
TIGHT_FRACTION, TIGHT_ATOL = 0.2, 1e-7
LOSS_KEYS = ("D_loss", "G_loss", "gan", "cycle", "identity", "content", "style")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file: beside the suite's other workers, a
    bf16 or fp32 step on all cores oversubscribes the CPU and runs many times
    slower."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def port_step1(level: str = "0", use_pallas: bool = False):
    """Step 1 of the port's bf16 step at ``MSIG_CONV_VJP=level``, as golden arrays."""
    cfg, state = tg.port_state()
    if use_pallas:
        cfg = dataclasses.replace(cfg, use_pallas=True)
        state = create_train_state(cfg, tg.ND)  # the same seed: the same parameters
    src, trg, sdom, tdom = tg.batch_arrays()
    batch = {"source": torch.from_numpy(src), "target": torch.from_numpy(trg),
             "source_domain": torch.from_numpy(sdom), "target_domain": torch.from_numpy(tdom)}
    vgg = init_random_vgg(tg.VGG_SEED, device="cpu")
    old = os.environ.get("MSIG_CONV_VJP")
    os.environ["MSIG_CONV_VJP"] = level
    try:
        step = make_train_step(cfg.ema_beta, torch.bfloat16)
        met = step(state, batch, vgg, tg.G_LR, tg.D_LR, list(tg.WEIGHTS))
    finally:
        if old is None:
            del os.environ["MSIG_CONV_VJP"]
        else:
            os.environ["MSIG_CONV_VJP"] = old
    metrics = {k: float(v) for k, v in met.items()}
    mu = {}
    for keys, moments in ((tg.G_KEYS, state.opt_g.mu), (tg.D_KEYS, state.opt_d.mu)):
        it = iter(moments)
        for k in keys:
            named = {n: next(it) for n, _ in state.models.nets[k].named_parameters()}
            mu[k] = _tree(k, named)
    ema = {k: _tree(k, state.models.ema[k].state_dict()) for k in tg.EMA_KEYS}
    return tg.golden_arrays(metrics, tg.port_trees(state), mu, ema)


def _tree(net: str, sd):
    if net.startswith("G_"):
        return fj.generator_params(sd, tg.N_RES)["params"]
    if net.startswith("SE_"):
        return fj.style_encoder_params(sd, tg.ND)["params"]
    return fj.discriminator_params(sd, tg.ND)["params"]


def check_step1(got: dict, want: dict) -> None:
    """Hold a port step-1 result against a JAX one (both as golden arrays) to the bars above."""
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[f"metric/{k}"], want[f"metric/{k}"], rtol=LOSS_RTOL,
                                   err_msg=k)
    for k in ("g_grad_norm", "d_grad_norm"):
        np.testing.assert_allclose(got[f"metric/{k}"], want[f"metric/{k}"], rtol=NORM_RTOL,
                                   err_msg=k)
    groups = ((tg.G_KEYS, tg.G_LR), (tg.D_KEYS, tg.D_LR))
    for keys, lr in groups:
        in_group = [k for k in want if k.count("/") > 1 and k.split("/")[1] in keys]
        norm_max = max(float(want[k]) for k in in_group if k.startswith("mu_norm/"))
        mu_max = max(float(np.abs(want[k]).max()) for k in in_group if k.startswith("mu/"))
        for k in in_group:
            kind, leaf = k.split("/", 1)
            if kind == "mu_norm":
                assert abs(got[k] - want[k]) <= MU_RTOL * want[k] + MU_ATOL_OF_MAX * norm_max, \
                    f"{leaf}: first-moment norm {got[k]:.4e} vs JAX {want[k]:.4e}"
            elif kind in ("new", "ema"):
                bound = 2 * lr * (1 - 0.995 if kind == "ema" else 1.0)
                d = np.abs(got[k] - want[k])
                assert d.max() <= bound + TIGHT_ATOL, f"{k}: max |delta| {d.max():.3e}"
                sel = np.abs(want[f"mu/{leaf}"]) >= TIGHT_FRACTION * mu_max
                if sel.any():
                    assert d[sel].max() <= TIGHT_ATOL, \
                        f"{k}: max |delta| {d[sel].max():.3e} where the gradient's sign is settled"


@pytest.fixture(scope="module")
def golden():
    g = dict(np.load(tg.GOLDEN))
    assert g["config"].tolist() == [tg.BATCH, tg.SIZE, tg.SDIM, tg.ND, tg.N_RES, tg.SEED,
                                    tg.VGG_SEED, tg.SAMPLES]
    return g


@pytest.fixture(scope="module")
def stock():
    return port_step1()


def test_bf16_step1_matches_jax_golden(stock, golden):
    assert set(stock) == set(golden)
    check_step1(stock, golden)


def test_bf16_step_parts_from_the_fp32_step(stock):
    """The bf16 step really runs in bf16: its losses are not the fp32 step's bits."""
    cfg, state = tg.port_state()
    src, trg, sdom, tdom = tg.batch_arrays()
    batch = {"source": torch.from_numpy(src), "target": torch.from_numpy(trg),
             "source_domain": torch.from_numpy(sdom), "target_domain": torch.from_numpy(tdom)}
    met = make_train_step(cfg.ema_beta)(state, batch, init_random_vgg(tg.VGG_SEED, device="cpu"),
                                        tg.G_LR, tg.D_LR, list(tg.WEIGHTS))
    fp32 = float(met["G_loss"])
    assert fp32 != stock["metric/G_loss"]
    np.testing.assert_allclose(stock["metric/G_loss"], fp32, rtol=LOSS_RTOL)


@pytest.mark.parametrize("level,use_pallas", [("1", True), ("2", False)])
def test_kernel_routes_take_fp32_under_bf16(golden, monkeypatch, level, use_pallas):
    """``MSIG_CONV_VJP=1`` (+ ``--pallas``) and ``=2`` under bf16: the conv backward
    wrappers get fp32 tensors (cast at the boundary), once per trunk site and
    generator launch (2 sites x 2 resblocks x 3 launches), and the step holds
    the JAX golden's bars."""
    calls = []
    name = "conv3x3_bwd" if level == "1" else "conv3x3_adain_bwd"
    fn = getattr(cv, name)

    def spy(*args, **kwargs):
        calls.append({a.dtype for a in args if isinstance(a, torch.Tensor)})
        return fn(*args, **kwargs)

    monkeypatch.setattr(cv, name, spy)
    pallas_calls = []
    if use_pallas:
        fwd = ap.adain_fwd
        monkeypatch.setattr(ap, "adain_fwd", lambda x, *a, **k: (pallas_calls.append(x.dtype),
                                                                 fwd(x, *a, **k))[1])
    check_step1(port_step1(level, use_pallas), golden)
    assert len(calls) == 2 * tg.N_RES * 3
    assert all(dtypes == {torch.float32} for dtypes in calls)
    if use_pallas:  # row 22 takes bf16 itself
        assert pallas_calls and set(pallas_calls) == {torch.bfloat16}


def test_train_cli_runs_bf16(tmp_path, monkeypatch):
    from PIL import Image

    from msig_tpu_torch.train import cli

    rng = np.random.default_rng(0)
    src, ref = tmp_path / "src", tmp_path / "ref"
    for d, n in ((src, 4), (ref / "DomA", 2), (ref / "DomB", 2)):
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(d / f"{i}.png")
    args = cli.build_arg_parser().parse_args([
        "--source_dir", str(src), "--target_dir", str(ref), "--save_dir_base", str(tmp_path / "out"),
        "--exp_name", "bf16", "--device", "cpu", "--allow_random_vgg", "--image_size", "32",
        "--batch_size", "2", "--epochs", "1", "--compute_dtype", "bfloat16"])
    monkeypatch.setenv("MSIG_SKIP_EPOCH_ART", "1")
    assert cli.main(cli.config_from_args(args)) == 0
    assert (tmp_path / "out" / "bf16" / "checkpoints" / "epoch_1" / "checkpoint.pth").exists()


@pytest.mark.slow
def test_bf16_step1_matches_live_jax(stock):
    """The live cross-check: the JAX bf16 step run here, not read from the golden."""
    check_step1(stock, tg.golden_arrays(*tg.jax_step1()))


def test_bf16_networks_keep_bf16():
    """Fed bf16, each network (and the VGG prefix) computes and returns bf16 on its
    fp32 parameters, as the JAX modules at ``dtype=bfloat16`` return bf16."""
    from msig_tpu_torch.losses import vgg_features
    from msig_tpu_torch.models import (MultiDomainDiscriminator, MultiDomainStyleEncoder,
                                       StyleCycleGANGenerator)

    x = torch.rand(2, 32, 32, 3, dtype=torch.bfloat16) * 2 - 1
    dom = torch.tensor([1, 2])
    with torch.no_grad():
        style = MultiDomainStyleEncoder(16, 3)(x, dom)
        outs = [style, StyleCycleGANGenerator(style_dim=16, n_residual_blocks=1)(x, style),
                MultiDomainDiscriminator(num_domains=3)(x, dom),
                *vgg_features(init_random_vgg(tg.VGG_SEED, device="cpu"), x)]
    assert [t.dtype for t in outs] == [torch.bfloat16] * len(outs)
