"""The port's train-step options against the JAX package's, on the CPU.

- one live step of both packages at ``MSIG_CONV_VJP=0`` with ``r1_gamma``,
  ``style_recon_weight`` and ``diversity_weight`` on (and ``target2`` in the
  batch), through ``tests/test_torch_port_train_step_common.py::run_both``
  (32², batch 2, one resblock, its bars: losses rtol 1e-4, grad norms 1e-3,
  parameters, EMA and Adam moments with the common file's masks);
- the same options at ``MSIG_CONV_VJP=1`` with ``use_pallas`` against the
  golden of ``tools/train_options_golden.py`` (the JAX step from the JAX
  initial state carried into the port, its Pallas kernels in interpret mode),
  to the same bars at the golden's sampled positions; ``-m slow`` runs that
  JAX step live;
- ``remat=True`` and ``remat="cycle"`` against no remat in the port, at levels
  0 and 1 (+ ``use_pallas``): losses equal to the bit, the gradients that clip
  and Adam take within rtol 1e-6, and the kernel wrappers' calls (the AdaIN
  forward again for every recomputed trunk site, the backwards as without
  remat);
- R1 under bf16: the discriminator runs in bf16 on the fp32 leaf's cast, the
  penalty is held to the fp32 one and to the JAX package's with a bf16
  discriminator, and its gradient reaches D's parameters.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_port_train_step_common as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "train_options_golden", os.path.join(ROOT, "tools", "train_options_golden.py"))
tg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tg)

OPTIONS = dict(tg.OPTIONS)
LOSS_KEYS = ["D_loss", "G_loss", "gan", "cycle", "identity", "content", "style", "style_recon",
             "diversity"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ live, level 0

@pytest.fixture(scope="module")
def both():
    return tp.run_both("0", False, options=OPTIONS)


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_option_losses_match_jax(both, key):
    np.testing.assert_allclose(both["metrics"][key], both["jax_metrics"][key], rtol=1e-4)


@pytest.mark.parametrize("key", ["g_grad_norm", "d_grad_norm"])
def test_option_grad_norms_match_jax(both, key):
    np.testing.assert_allclose(both["metrics"][key], both["jax_metrics"][key], rtol=1e-3)


@pytest.mark.parametrize("net", ["G_A2B", "G_B2A", "SE_A", "SE_B", "D_A", "D_B"])
def test_option_updated_params_match_jax(both, net):
    g = net in tp.G_KEYS_J
    group, keys, lr = ("gen_params", tp.G_KEYS_J, tp.G_LR) if g else ("disc_params", tp.D_KEYS_J,
                                                                       tp.D_LR)
    mu = (both["jax_new"].opt_g if g else both["jax_new"].opt_d)[1].mu
    got = tp.to_tree(net, both["state"].models.nets[net].state_dict())
    tp.check_params(got, getattr(both["jax_new"], group)[net]["params"], mu[net]["params"],
                    step_bound=2 * lr,
                    mask_at=tp.TIGHT_FRACTION * tp.group_max([mu[k]["params"] for k in keys]))


@pytest.mark.parametrize("group", ["g", "d"])
@pytest.mark.parametrize("moment,rtol", [("mu", 1e-3), ("nu", 2e-3)])
def test_option_adam_moments_match_jax(both, group, moment, rtol):
    keys = tp.G_KEYS_J if group == "g" else tp.D_KEYS_J
    opt = getattr(both["state"], f"opt_{group}")
    jopt = getattr(both["jax_new"], f"opt_{group}")[1]
    by_name = tp.moments_by_name(both["state"], keys, getattr(opt, moment))
    tp.check_moments([tp.to_tree(k, by_name[k]) for k in keys],
                     [getattr(jopt, moment)[k]["params"] for k in keys], rtol)


def test_option_terms_have_their_signs(both):
    """The two G terms are there, style reconstruction an L1 (positive) and
    diversity a negated L1."""
    m = both["metrics"]
    assert m["style_recon"] > 0 and m["diversity"] < 0


# ------------------------------------------------------------ golden, level 1

def _port_step1(options=OPTIONS, level=tg.LEVEL):
    from msig_tpu_torch.losses import init_random_vgg
    from msig_tpu_torch.train import make_train_step

    cfg, state = tg.port_state()
    batch = {k: torch.from_numpy(v) for k, v in tg.batch_arrays().items()}
    old = os.environ.get("MSIG_CONV_VJP")
    os.environ["MSIG_CONV_VJP"] = level
    try:
        met = make_train_step(cfg.ema_beta, **options)(
            state, batch, init_random_vgg(tg.VGG_SEED, device="cpu"), tg.G_LR, tg.D_LR,
            list(tg.WEIGHTS))
    finally:
        if old is None:
            del os.environ["MSIG_CONV_VJP"]
        else:
            os.environ["MSIG_CONV_VJP"] = old
    mu, nu = {}, {}
    for keys, opt in ((tg.G_KEYS, state.opt_g), (tg.D_KEYS, state.opt_d)):
        its = iter(opt.mu), iter(opt.nu)
        for k in keys:
            names = [n for n, _ in state.models.nets[k].named_parameters()]
            mu[k] = tg.tree_of(k, {n: next(its[0]) for n in names})
            nu[k] = tg.tree_of(k, {n: next(its[1]) for n in names})
    params = {k: tg.tree_of(k, state.models.nets[k].state_dict()) for k in tg.G_KEYS + tg.D_KEYS}
    ema = {k: tg.tree_of(k, state.models.ema[k].state_dict()) for k in tg.EMA_KEYS}
    return tg.golden_arrays({k: float(v) for k, v in met.items()}, params, mu, nu, ema)


def check_step1(got: dict, want: dict) -> None:
    """The run_both bars at the golden's sampled positions."""
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[f"metric/{k}"], want[f"metric/{k}"], rtol=1e-4, err_msg=k)
    for k in ("g_grad_norm", "d_grad_norm"):
        np.testing.assert_allclose(got[f"metric/{k}"], want[f"metric/{k}"], rtol=1e-3, err_msg=k)
    for group, keys, lr in (("g", tg.G_KEYS, tg.G_LR), ("d", tg.D_KEYS, tg.D_LR)):
        mu_max, nu_max = float(want[f"mu_max/{group}"]), float(want[f"nu_max/{group}"])
        for k in want:
            kind, _, rest = k.partition("/")
            if kind not in ("new", "ema", "mu", "nu") or rest.split("/")[0] not in keys:
                continue
            if kind in ("mu", "nu"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-3 if kind == "mu" else 2e-3,
                                           atol=1e-4 * (mu_max if kind == "mu" else nu_max),
                                           err_msg=k)
                continue
            bound = 2 * lr * (1 - 0.995 if kind == "ema" else 1.0)
            d = np.abs(got[k] - want[k])
            assert d.max() <= bound + tp.TIGHT_ATOL, f"{k}: max |delta| {d.max():.3e}"
            sel = np.abs(want[f"mu/{rest}"]) >= tp.TIGHT_FRACTION * mu_max
            if sel.any():
                assert d[sel].max() <= tp.TIGHT_ATOL, f"{k}: max |delta| {d[sel].max():.3e}"


@pytest.fixture(scope="module")
def golden():
    g = dict(np.load(tg.GOLDEN))
    assert g["config"].tolist() == [tg.BATCH, tg.SIZE, tg.SDIM, tg.ND, tg.N_RES, tg.SEED,
                                    tg.VGG_SEED, tg.SAMPLES, int(tg.LEVEL), int(tg.USE_PALLAS)]
    return g


@pytest.fixture(scope="module")
def level1():
    return _port_step1()


def test_options_level1_pallas_match_jax_golden(level1, golden):
    assert set(level1) == set(golden)
    check_step1(level1, golden)


@pytest.mark.slow
def test_options_level1_pallas_match_live_jax(level1):
    check_step1(level1, tg.golden_arrays(*tg.jax_step1()))


# ------------------------------------------------------------ remat

def _remat_step(level: str, remat, options=None):
    """Step 1 of the port at ``level`` (``use_pallas`` at 1): metrics, the G and D
    gradients clip and Adam take, and the kernel wrappers' calls."""
    from msig_tpu_torch.losses import init_random_vgg
    from msig_tpu_torch.ops import adain_pallas as ap
    from msig_tpu_torch.ops import conv3x3_vjp as cv
    from msig_tpu_torch.train import create_train_state, make_train_step
    from msig_tpu_torch.train import step as port_step
    from msig_tpu_torch.config import TrainConfig

    cfg = TrainConfig(image_size=tg.SIZE, batch_size=tg.BATCH, style_dim=tg.SDIM,
                      n_residual_blocks=tg.N_RES, use_pallas=level == "1", device="cpu")
    state = create_train_state(cfg, tg.ND)
    batch = {k: torch.from_numpy(v) for k, v in tg.batch_arrays().items()}
    grads, calls = [], {}
    real_adam = port_step.clip_adam_update_
    wrapped = [(cv, "conv3x3_bwd"), (ap, "adain_fwd"), (ap, "adain_bwd")]
    originals = [getattr(m, n) for m, n in wrapped]

    def adam_spy(params, g, *a, **k):
        grads.append([x.clone() if x is not None else torch.zeros_like(p)
                      for p, x in zip(params, g)])
        return real_adam(params, g, *a, **k)

    old = os.environ.get("MSIG_CONV_VJP")
    os.environ["MSIG_CONV_VJP"] = level
    port_step.clip_adam_update_ = adam_spy
    for (mod, name), fn in zip(wrapped, originals):
        def spy(*a, _f=fn, _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)
        setattr(mod, name, spy)
    try:
        met = make_train_step(cfg.ema_beta, remat=remat, **(options or {}))(
            state, batch, init_random_vgg(tg.VGG_SEED, device="cpu"), tg.G_LR, tg.D_LR,
            list(tg.WEIGHTS))
    finally:
        port_step.clip_adam_update_ = real_adam
        for (mod, name), fn in zip(wrapped, originals):
            setattr(mod, name, fn)
        if old is None:
            del os.environ["MSIG_CONV_VJP"]
        else:
            os.environ["MSIG_CONV_VJP"] = old
    return {k: float(v) for k, v in met.items()}, grads, calls


@pytest.fixture(scope="module")
def remat_runs():
    return {(level, remat): _remat_step(level, remat) for level in ("0", "1")
            for remat in (False, True, "cycle")}


@pytest.mark.parametrize("level", ["0", "1"])
@pytest.mark.parametrize("remat", [True, "cycle"])
def test_remat_losses_equal_to_the_bit(remat_runs, level, remat):
    base, _, _ = remat_runs[(level, False)]
    got, _, _ = remat_runs[(level, remat)]
    assert got == base


@pytest.mark.parametrize("level", ["0", "1"])
@pytest.mark.parametrize("remat", [True, "cycle"])
def test_remat_gradients_match(remat_runs, level, remat):
    _, base, _ = remat_runs[(level, False)]
    _, got, _ = remat_runs[(level, remat)]
    assert len(got) == len(base) == 2  # the G group, then the D group
    for gs, ws in zip(got, base):
        for g, w in zip(gs, ws):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("remat,want_fwd", [(False, 6), (True, 12), ("cycle", 10)])
def test_remat_recomputes_the_trunk_forwards(remat_runs, remat, want_fwd):
    """Level 1 + use_pallas, one resblock: 2 AdaIN sites a generator launch, 3
    launches; remat runs the forward of each rematerialised launch again in the
    backward (True: all three; "cycle": the 2B G_B2A launch and cyc_B), the
    backward kernels as often as without it. No wrapper runs at level 0."""
    assert remat_runs[("1", remat)][2] == {"adain_fwd": want_fwd, "adain_bwd": 6,
                                            "conv3x3_bwd": 6}
    assert remat_runs[("0", remat)][2] == {}


def test_diversity_under_remat_adds_one_launch():
    """Diversity's extra G_A2B launch is rematerialised with remat=True: 4
    launches x 2 sites forward, again in the backward, and 8 backwards."""
    met, _, calls = _remat_step("1", True, {"diversity_weight": 1.0})
    assert calls == {"adain_fwd": 16, "adain_bwd": 8, "conv3x3_bwd": 8}
    base, _, plain = _remat_step("1", False, {"diversity_weight": 1.0})
    assert plain == {"adain_fwd": 8, "adain_bwd": 8, "conv3x3_bwd": 8}
    assert met == base


def test_remat_rejects_other_values():
    from msig_tpu_torch.train import make_train_step

    with pytest.raises(ValueError, match="remat"):
        make_train_step(0.995, remat="all")


# ------------------------------------------------------------ R1 under bf16

def test_r1_runs_the_discriminator_in_bf16():
    """Fed bf16 images, the penalty runs D in bf16 (its first conv sees bf16) on
    an fp32 leaf and returns fp32. Bars: the fp32 penalty equals JAX's within
    1e-5; the bf16 one is within 2e-2 of the fp32 one, and within 1e-1 of
    JAX's bf16 one: the packages' bf16 backwards round differently (measured
    here: fp32 1.04479, port bf16 1.05151, JAX bf16 1.09795; the largest
    element of JAX's bf16 input gradient is 23% off the port's)."""
    from msig_tpu.extensions import r1_penalty as j_r1
    from msig_tpu.models import MultiDomainDiscriminator as JDisc

    from msig_tpu_torch.compat import from_jax as fj
    from msig_tpu_torch.extensions import r1_penalty
    from msig_tpu_torch.models import MultiDomainDiscriminator

    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    idx = np.array([1, 2], np.int32)
    params = JDisc(num_domains=tg.ND).init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(idx))
    disc = MultiDomainDiscriminator(num_domains=tg.ND)
    disc.load_state_dict(fj.discriminator_state_dict(jax.device_get(params), tg.ND))
    seen = []
    disc.shared_layers[0].register_forward_pre_hook(lambda m, a: seen.append(a[0].dtype))
    pens = {}
    for name, jdt, tdt in (("fp32", jnp.float32, torch.float32), ("bf16", jnp.bfloat16,
                                                                 torch.bfloat16)):
        seen.clear()
        got = r1_penalty(disc, torch.from_numpy(x).to(tdt), torch.from_numpy(idx))
        assert seen == [tdt] and got.dtype == torch.float32
        jd = JDisc(num_domains=tg.ND, dtype=jdt)
        want = float(j_r1(jd.apply, params, jnp.asarray(x, jdt), jnp.asarray(idx)))
        pens[name] = (got, want)
    np.testing.assert_allclose(float(pens["fp32"][0].detach()), pens["fp32"][1], rtol=1e-5)
    bf16 = float(pens["bf16"][0].detach())
    np.testing.assert_allclose(bf16, float(pens["fp32"][0].detach()), rtol=2e-2)
    np.testing.assert_allclose(bf16, pens["bf16"][1], rtol=1e-1)
    (g,) = torch.autograd.grad(pens["bf16"][0], [disc.shared_layers[0].weight])
    assert torch.isfinite(g).all() and bool(g.abs().sum() > 0)


# ------------------------------------------------------------ the second target

@pytest.mark.parametrize("epoch", [0, 2])
def test_train_loader_second_target_matches_jax(tmp_path, monkeypatch, epoch):
    """``TrainLoader(second_target=True)`` draws ``target2`` from each sample's target
    domain in the JAX loader's order (the files before the per-image seeds): the
    same batches, to the bit, on both PIL backends."""
    from PIL import Image

    from msig_tpu.data import dataset as jds
    from msig_tpu.data import native_loader as jnative
    from msig_tpu.data import pipeline as jpipe
    from msig_tpu_torch.data import dataset as ds
    from msig_tpu_torch.data import native_loader as native
    from msig_tpu_torch.data import pipeline as pipe

    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    rng = np.random.default_rng(1)
    for d, n in (("src/S", 5), ("ref/a", 3), ("ref/b", 4)):
        (tmp_path / d).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)).save(
                tmp_path / d / f"{i}.png")
    src, ref = str(tmp_path / "src" / "S"), str(tmp_path / "ref")
    mine = pipe.TrainLoader(ds.MultiDomainDataset.build(src, ref), 2, 32, seed=3,
                            second_target=True)
    theirs = jpipe.TrainLoader(jds.MultiDomainDataset.build(src, ref), 2, 32, seed=3,
                               second_target=True)
    got, want = list(mine.epoch(epoch)), list(theirs.epoch(epoch))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"source", "target", "target2", "source_domain",
                                    "target_domain"}
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    plain = next(iter(pipe.TrainLoader(ds.MultiDomainDataset.build(src, ref), 2, 32,
                                       seed=3).epoch(epoch)))
    assert "target2" not in plain
    # the extra draws come after the batch's samples: source, domains and targets are kept
    for k in ("source_domain", "target_domain"):
        np.testing.assert_array_equal(plain[k], got[0][k])
