"""Gradient histograms of the port (``msig_tpu_torch/train/watch.py``) against the
JAX package's (``msig_tpu/train/watch.py``), on the CPU.

- ``leaf_histogram`` gives exactly the counts and range of JAX's
  ``_leaf_histogram`` on the same float32 array: a hypothesis property over
  arrays with NaN and Inf, and the edge cases (a value at the top edge,
  all-equal, all-non-finite, bf16 input);
- the histograms of one port train step (``grad_hists=64``, 32², batch 2, one
  resblock) against JAX's ``gradient_histograms`` on the same gradient values
  carried into flax trees (``compat/from_jax.py``): every leaf that maps to
  one torch parameter has the same counts and range to the bit, and each
  stacked head (one flax leaf, one torch parameter a domain) the same count
  total; the counts of every histogram sum to its gradient's finite elements;
- the trainer's watch branch with a stub wandb run: histograms every
  ``watch_freq`` steps, in the same log call as that step's losses, and no
  watch step function without a run.
"""

import sys
import types

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

import jax
import jax.numpy as jnp

from msig_tpu.train import watch as jwatch

from msig_tpu_torch.compat import from_jax as fj
from msig_tpu_torch.train import watch

BINS = 64
_jax_leaf = jax.jit(jwatch._leaf_histogram, static_argnums=1)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _both(x: np.ndarray, bins: int = BINS):
    c, lo, hi = watch.leaf_histogram(torch.from_numpy(x), bins)
    jc, jlo, jhi = jax.device_get(_jax_leaf(jnp.asarray(x), bins))
    return (c.numpy(), float(lo), float(hi)), (np.asarray(jc), float(jlo), float(jhi))


def _bits(*v):
    return tuple(int(np.float32(f).view(np.uint32)) for f in v)


def _assert_same(x: np.ndarray, bins: int = BINS):
    (c, lo, hi), (jc, jlo, jhi) = _both(x, bins)
    assert c.dtype == np.int32
    np.testing.assert_array_equal(c, jc)
    assert _bits(lo, hi) == _bits(jlo, jhi)  # to the bit: a zero's sign too
    assert int(c.sum()) == int(np.isfinite(x).sum())


_values = st.one_of(st.floats(-1e3, 1e3, width=32), st.sampled_from([np.nan, np.inf, -np.inf]),
                    st.floats(-2.0**-20, 2.0**-20, width=32))


# Subnormal float32 values: XLA flushes them, PyTorch does not.
_SUB = 2.85903e-40


@settings(max_examples=60, deadline=None, derandomize=True)
@given(hnp.arrays(np.float32, st.sampled_from([(7,), (64,), (3, 5, 4)]), elements=_values),
       st.sampled_from([8, 64]))
@example(np.array([1.0] + [_SUB] * 6, np.float32), 8)
@example(np.array([0.0] + [_SUB] * 6, np.float32), 8)
def test_leaf_histogram_equals_jax(x, bins):
    _assert_same(x, bins)


@pytest.mark.parametrize("case", ["top_edge", "all_equal", "all_nan", "inf_and_nan_mixed",
                                  "single", "zeros", "two_values", "all_subnormal",
                                  "zeros_and_subnormals", "subnormal_differences",
                                  "signed_zeros"])
def test_leaf_histogram_edge_cases(case):
    x = {
        "all_subnormal": np.array([_SUB, -3e-41, 1e-39, _SUB], np.float32),
        "zeros_and_subnormals": np.array([-_SUB, 0.0, -0.0, _SUB, 0.0, 1.0], np.float32),
        # a normal range whose differences fall below the smallest normal (1.18e-38)
        "subnormal_differences": np.array([1.2e-38, 1.3e-38, 1.25e-38, 1.2e-38], np.float32),
        "signed_zeros": np.array([-1.0, 0.0, -0.0, 0.0], np.float32),
        "top_edge": np.array([0.0, 0.25, 0.5, 1.0, 1.0], np.float32),
        "all_equal": np.full((10,), 3.5, np.float32),
        "all_nan": np.array([np.nan, np.inf, -np.inf], np.float32),
        "inf_and_nan_mixed": np.array([np.nan, 1.0, np.inf, -2.0, -np.inf, 0.5], np.float32),
        "single": np.array([-7.25], np.float32),
        "zeros": np.zeros((4, 4), np.float32),
        "two_values": np.array([1e-8, 2e-8] * 5, np.float32),
    }[case]
    _assert_same(x)
    (c, lo, hi), _ = _both(x)
    if case == "top_edge":
        assert c[-1] == 2  # the values at hi land in the last bin
    if case == "all_equal":
        assert (lo, hi) == (3.0, 4.0) and c[BINS // 2] == 10
    if case == "all_nan":
        assert (lo, hi) == (-0.5, 0.5) and not c.any()
    if case == "all_subnormal":  # zeros to XLA: the all-equal range around 0
        assert (lo, hi) == (-0.5, 0.5) and c[BINS // 2] == 4
    if case == "zeros_and_subnormals":  # -0 is the min, as XLA's min picks it
        assert _bits(lo, hi) == _bits(-0.0, 1.0) and c[0] == 5 and c[-1] == 1
    if case == "subnormal_differences":  # hi - lo flushes to 0: every value in bin 0
        assert lo < hi and c[0] == 4
    if case == "signed_zeros":
        assert _bits(hi) == _bits(0.0)


def test_leaf_histogram_takes_bf16():
    """A bf16 gradient is binned in float32, as the JAX function casts it."""
    x = torch.randn(257, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    c, lo, hi = watch.leaf_histogram(x, BINS)
    jc, jlo, jhi = jax.device_get(_jax_leaf(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                                            BINS))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert (float(lo), float(hi)) == (float(jlo), float(jhi))


# ------------------------------------------------------- one step's gradients

SIZE, SDIM, ND, N_RES = 32, 16, 3, 1


def _to_tree(net: str, named):
    if net.startswith("G_"):
        return fj.generator_params(named, N_RES)
    if net.startswith("SE_"):
        return fj.style_encoder_params(named, ND)
    return fj.discriminator_params(named, ND)


@pytest.fixture(scope="module")
def step_grads():
    """One port step with ``grad_hists``: its histograms and the gradients they were
    computed from (caught on their way into ``gradient_histograms``)."""
    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.losses import init_random_vgg
    from msig_tpu_torch.train import create_train_state, make_train_step
    from msig_tpu_torch.train import step as port_step

    cfg = TrainConfig(image_size=SIZE, batch_size=2, style_dim=SDIM, n_residual_blocks=N_RES,
                      device="cpu")
    state = create_train_state(cfg, ND)
    rng = np.random.default_rng(0)
    batch = {"source": torch.from_numpy(rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)),
             "target": torch.from_numpy(rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)),
             "source_domain": torch.zeros(2, dtype=torch.int32),
             "target_domain": torch.tensor([1, 2], dtype=torch.int32)}
    seen = {}
    real = port_step.gradient_histograms

    def spy(g, d, names, bins):
        seen.update({k: [t.clone() for t in v] for k, v in {**g, **d}.items()})
        seen.setdefault("_names", {}).update(names)
        return real(g, d, names, bins)

    port_step.gradient_histograms = spy
    try:
        met = make_train_step(cfg.ema_beta, grad_hists=BINS)(
            state, batch, init_random_vgg(1234, device="cpu"), 2e-4, 1e-4, [1, 10, 5, 1, 1])
    finally:
        port_step.gradient_histograms = real
    names = seen.pop("_names")
    return met["_grad_hists"], seen, names, state


def test_step_histograms_cover_every_parameter(step_grads):
    hists, grads, names, state = step_grads
    want = {f"gradients/{k}.{n}" for k, net in state.models.nets.items()
            for n, _ in net.named_parameters()}
    assert set(hists) == want
    for k, gs in grads.items():
        for n, g in zip(names[k], gs):
            counts, lo, hi = hists[f"gradients/{k}.{n}"]
            assert counts.shape == (BINS,) and counts.dtype == torch.int32
            assert int(counts.sum()) == int(torch.isfinite(g).sum()) == g.numel()
            assert float(lo) <= float(g.min()) and float(hi) >= float(g.max())


def test_step_histograms_equal_jax_through_the_key_map(step_grads):
    hists, grads, names, _ = step_grads
    j_g, j_d, owners = {}, {}, {}
    for k, gs in grads.items():
        named = dict(zip(names[k], gs))
        tree = _to_tree(k, named)
        (j_g if k in ("G_A2B", "G_B2A", "SE_A", "SE_B") else j_d)[k] = tree
        # which torch parameters feed each flax leaf: carry their indices across
        ids = _to_tree(k, {n: torch.full_like(g, i) for i, (n, g) in enumerate(named.items())})
        for path, leaf in jax.tree_util.tree_flatten_with_path(ids)[0]:
            key = "gradients/" + k + "." + ".".join(str(p.key) for p in path)
            owners[key] = [f"gradients/{k}.{names[k][int(i)]}" for i in np.unique(leaf)]
    jh = jax.device_get(jwatch.gradient_histograms(j_g, j_d, bins=BINS))
    assert set(jh) == set(owners)
    assert sorted(o for v in owners.values() for o in v) == sorted(hists)
    stacked = 0
    for key, (jc, jlo, jhi) in jh.items():
        mine = [hists[o] for o in owners[key]]
        if len(mine) == 1:
            c, lo, hi = mine[0]
            np.testing.assert_array_equal(c.numpy(), np.asarray(jc), err_msg=key)
            assert (float(lo), float(hi)) == (float(jlo), float(jhi)), key
        else:  # a stacked head: one torch parameter a domain
            stacked += 1
            assert len(mine) == ND, key
            assert sum(int(c.sum()) for c, _, _ in mine) == int(np.asarray(jc).sum()), key
    assert stacked == 2 * 2 * 2  # SE and D heads, weight and bias, two networks each


# ------------------------------------------------------ the trainer's branch

class _StubRun:
    def __init__(self):
        self.logs = []

    def log(self, d):
        self.logs.append(d)


@pytest.fixture
def fake_wandb(monkeypatch):
    mod = types.ModuleType("wandb")

    class Histogram:
        def __init__(self, np_histogram):
            self.counts, self.edges = np_histogram

    mod.Histogram = Histogram
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("watch")
    rng = np.random.default_rng(0)
    for d, n in (("src/S", 6), ("ref/A", 2), ("ref/B", 2)):
        (root / d).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (36, 36, 3), dtype=np.uint8)).save(
                root / d / f"{i}.png")
    return root


def _trainer(tree, run, watch_freq):
    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.data import MultiDomainDataset
    from msig_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(source_dir=str(tree / "src" / "S"), target_dir=str(tree / "ref"),
                      save_dir_base=str(tree / "out"), exp_name="w", image_size=SIZE,
                      batch_size=2, style_dim=SDIM, n_residual_blocks=N_RES, epochs=1,
                      watch_freq=watch_freq, allow_random_vgg=True, device="cpu")
    return Trainer(cfg, MultiDomainDataset.build(cfg.source_dir, cfg.target_dir), wandb_run=run)


def test_trainer_watch_branch_logs_histograms_with_the_losses(tree, fake_wandb, monkeypatch):
    monkeypatch.setenv("MSIG_SKIP_EPOCH_ART", "1")
    run = _StubRun()
    trainer = _trainer(tree, run, watch_freq=2)
    trainer.train()
    steps, epoch_log = run.logs[:-1], run.logs[-1]
    assert len(steps) == 3  # 6 sources at batch 2
    n_params = sum(1 for net in trainer.state.models.nets.values() for _ in net.parameters())
    for i, logs in enumerate(steps):
        assert {"loss/D_loss", "loss/G_loss", "loss/g_grad_norm"} <= set(logs)
        hist_keys = [k for k in logs if k.startswith("gradients/")]
        assert len(hist_keys) == (n_params if i % 2 == 0 else 0), i
        for k in hist_keys:
            h = logs[k]
            assert isinstance(h, fake_wandb.Histogram) and len(h.edges) == 65
    sizes = {f"gradients/{k}.{n}": p.numel() for k, net in trainer.state.models.nets.items()
             for n, p in net.named_parameters()}
    assert all(int(steps[0][k].counts.sum()) == sizes[k] for k in sizes)
    assert {"epoch", "perf/step_time_ms", "avg_loss/G_loss", "lr/generator",
            "weight/cycle"} <= set(epoch_log)


def test_no_watch_step_without_a_run(tree):
    assert _trainer(tree, None, watch_freq=2).train_step_watch is None
    assert _trainer(tree, _StubRun(), watch_freq=0).train_step_watch is None
