"""Resume and profiling of the port's trainer and train CLI, on the CPU.

- two epochs straight equal, to the bit, one epoch, a resume from its
  checkpoint and one more epoch: parameters, EMA, both Adam moment sets and
  their step counts, the loss history (``Trainer.resume`` + ``train(1)``,
  what ``--resume`` runs; 32², batch 2, one resblock, style_dim 16);
- the JAX package's ``resume_for_training`` on the port's checkpoint gives the
  same parameters, EMA, loss history and start epoch (it re-initialises Adam;
  the port restores the moments, as the reference does);
- a ``num_domains`` mismatch and a missing directory start from scratch; an
  Orbax directory of the JAX package is refused with a message that names it;
- ``python -m msig_tpu_torch.train --resume`` prints the root ``main.py``'s
  lines and trains the next epoch; ``--profile_steps 2`` writes a trace and
  exits 0.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from msig_tpu_torch.compat import from_jax as fj
from msig_tpu_torch.config import TrainConfig
from msig_tpu_torch.data import MultiDomainDataset
from msig_tpu_torch.train import cli
from msig_tpu_torch.train.checkpoint import resume_for_training
from msig_tpu_torch.train.state import D_KEYS, G_KEYS, create_train_state
from msig_tpu_torch.train.trainer import Trainer

SIZE, SDIM, N_RES = 32, 16, 1


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: beside the suite's other workers, a step on all
    cores oversubscribes the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """3 sources and 2 target domains (3 domains in all): one step an epoch at batch 2."""
    root = tmp_path_factory.mktemp("resume")
    rng = np.random.default_rng(0)
    for d, n in (("src/Tomato_healthy", 3), ("ref/DiseaseA", 3), ("ref/DiseaseB", 2)):
        os.makedirs(root / d)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(
                root / d / f"img{i}.png")
    return root


def _cfg(tree, name: str, **kw) -> TrainConfig:
    return TrainConfig(source_dir=str(tree / "src" / "Tomato_healthy"),
                       target_dir=str(tree / "ref"), save_dir_base=str(tree / "results"),
                       exp_name=name, image_size=SIZE, batch_size=2, style_dim=SDIM,
                       n_residual_blocks=N_RES, allow_random_vgg=True, device="cpu",
                       checkpoint_every=1, **kw)


def _trainer(cfg) -> Trainer:
    return Trainer(cfg, MultiDomainDataset.build(cfg.source_dir, cfg.target_dir))


def _snapshot(trainer: Trainer) -> dict:
    st = trainer.state
    return {
        "nets": {k: {n: v.clone() for n, v in net.state_dict().items()}
                 for k, net in st.models.nets.items()},
        "ema": {k: {n: v.clone() for n, v in net.state_dict().items()}
                for k, net in st.models.ema.items()},
        "opt": {g: (o.count, [m.clone() for m in o.mu], [v.clone() for v in o.nu])
                for g, o in (("g", st.opt_g), ("d", st.opt_d))},
        "step": st.step,
        "history": {k: list(v) for k, v in trainer.loss_history.items()},
    }


@pytest.fixture(scope="module")
def runs(tree, monkeypatch_module):
    monkeypatch_module.setenv("MSIG_SKIP_EPOCH_ART", "1")
    straight = _trainer(_cfg(tree, "straight", epochs=2))
    straight.train()
    first = _trainer(_cfg(tree, "split", epochs=1))
    first.train()
    resumed = _trainer(_cfg(tree, "split", epochs=2))
    start = resumed.resume(str(tree / "results" / "split" / "checkpoints" / "epoch_1"))
    resumed.train(start_epoch=start)
    return dict(straight=_snapshot(straight), resumed=_snapshot(resumed), start=start,
                first=first)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_resume_starts_at_the_next_epoch(runs):
    assert runs["start"] == 1
    assert runs["resumed"]["step"] == runs["straight"]["step"] == 2


@pytest.mark.parametrize("part", ["nets", "ema"])
def test_resumed_networks_equal_straight_run(runs, part):
    got, want = runs["resumed"][part], runs["straight"][part]
    assert got.keys() == want.keys()
    for k in want:
        for name, w in want[k].items():
            assert torch.equal(got[k][name], w), f"{part} {k}.{name}"


@pytest.mark.parametrize("group", ["g", "d"])
def test_resumed_adam_equals_straight_run(runs, group):
    (gc, gmu, gnu), (wc, wmu, wnu) = runs["resumed"]["opt"][group], runs["straight"]["opt"][group]
    assert gc == wc == 2
    assert all(torch.equal(a, b) for a, b in zip(gmu, wmu))
    assert all(torch.equal(a, b) for a, b in zip(gnu, wnu))


def test_resumed_loss_history_equals_straight_run(runs):
    got, want = runs["resumed"]["history"], runs["straight"]["history"]
    assert all(len(v) == 2 for v in want.values())
    assert got == want


@pytest.fixture(scope="module")
def jax_resumed(tree, runs):
    from msig_tpu.config import TrainConfig as JConfig
    from msig_tpu.train import Models, create_train_state as j_create
    from msig_tpu.train.checkpoint import resume_for_training as j_resume

    jcfg = JConfig(image_size=SIZE, style_dim=SDIM, n_residual_blocks=N_RES, use_pallas=False)
    # shapes are all the template gives a resume from a .pth directory
    template = jax.eval_shape(lambda: j_create(jcfg, Models.from_config(jcfg, num_domains=3),
                                               jax.random.PRNGKey(0)))
    ckpt = str(tree / "results" / "split" / "checkpoints" / "epoch_1")
    return j_resume(ckpt, template, 3), runs["first"]


def test_jax_resumes_from_the_port_checkpoint(jax_resumed):
    (state, history, start), first = jax_resumed
    assert start == 1
    assert history == first.loss_history
    st = first.state.models
    for k in G_KEYS + D_KEYS:
        sd = st.nets[k].state_dict()
        want = (fj.generator_params(sd, N_RES) if k.startswith("G_")
                else fj.style_encoder_params(sd, 3) if k.startswith("SE_")
                else fj.discriminator_params(sd, 3))
        got = (state.gen_params if k in G_KEYS else state.disc_params)[k]
        for (p, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                  jax.tree_util.tree_flatten_with_path(jax.device_get(got))[0]):
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=f"{k} {p}")
    for k in G_KEYS:
        sd = st.ema[k].state_dict()
        want = (fj.generator_params(sd, N_RES) if k.startswith("G_")
                else fj.style_encoder_params(sd, 3))
        got = jax.device_get(state.ema_params[k])
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=f"ema {k}")


def test_num_domains_mismatch_starts_from_scratch(tree, runs, caplog):
    cfg = _cfg(tree, "mismatch")
    state = create_train_state(cfg, 4)
    before = [p.clone() for p in state.models.g_params()]
    got, history, start = resume_for_training(
        str(tree / "results" / "split" / "checkpoints" / "epoch_1"), state, 4)
    assert got is state and history == {} and start == 0
    assert all(torch.equal(a, b) for a, b in zip(before, state.models.g_params()))
    assert state.opt_g.count == 0
    assert "starting from scratch" in caplog.text


def test_missing_directory_starts_from_scratch(tree, caplog):
    state = create_train_state(_cfg(tree, "missing"), 3)
    _, history, start = resume_for_training(str(tree / "nowhere"), state, 3)
    assert history == {} and start == 0
    assert "Starting from scratch" in caplog.text


def test_orbax_directory_is_refused(tmp_path, tree):
    (tmp_path / "state").mkdir()
    (tmp_path / "meta.json").write_text(json.dumps({"num_domains": 3}))
    state = create_train_state(_cfg(tree, "orbax"), 3)
    with pytest.raises(ValueError, match="Orbax checkpoint of the JAX package"):
        resume_for_training(str(tmp_path), state, 3)


def _cli_cfg(tree, *extra, exp_name="c"):
    """The CLI's config for these flags, at this file's small width (the CLI has no
    width flags; ``cli.main`` takes the config)."""
    args = cli.build_arg_parser().parse_args([
        "--device", "cpu", "--source_dir", str(tree / "src" / "Tomato_healthy"),
        "--target_dir", str(tree / "ref"), "--save_dir_base", str(tree / "cli_results"),
        "--image_size", "32", "--batch_size", "2", "--exp_name", exp_name, "--allow_random_vgg",
        *extra])
    return dataclasses.replace(cli.config_from_args(args), style_dim=SDIM,
                               n_residual_blocks=N_RES)


def test_cli_resume_trains_the_next_epoch(tree, capsys, monkeypatch):
    monkeypatch.setenv("MSIG_SKIP_EPOCH_ART", "1")
    ckpt = tree / "cli_results" / "c" / "checkpoints"
    assert cli.main(_cli_cfg(tree, "--epochs", "1")) == 0
    capsys.readouterr()
    assert cli.main(_cli_cfg(tree, "--epochs", "2", "--resume", str(ckpt / "epoch_1"))) == 0
    out = capsys.readouterr().out
    assert f"Attempting to resume from checkpoint: {ckpt / 'epoch_1'}" in out
    assert "Resuming training from epoch 2" in out
    saved = torch.load(ckpt / "epoch_2" / "checkpoint.pth", map_location="cpu", weights_only=False)
    assert len(saved["loss_history"]["G_loss"]) == 2
    assert float(saved["g_optimizer"]["state"][0]["step"]) == 2.0


def test_cli_profile_steps_writes_a_trace(tree, capsys):
    # batch 1: three batches, the first untraced
    cfg = _cli_cfg(tree, "--epochs", "1", "--profile_steps", "2", "--batch_size", "1",
                   exp_name="p")
    assert cli.main(cfg) == 0
    trace_dir = tree / "cli_results" / "p" / "profile"
    assert f"Profiler trace written to {trace_dir}" in capsys.readouterr().out
    trace = json.loads((trace_dir / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)
    assert not (tree / "cli_results" / "p" / "checkpoints").exists()  # profiled, not trained


def test_resume_keeps_its_config_fields():
    """The CLI carries --resume and --profile_steps into the config."""
    args = cli.build_arg_parser().parse_args(["--resume", "d", "--profile_steps", "3"])
    cfg = cli.config_from_args(args)
    assert (cfg.resume, cfg.profile_steps) == ("d", 3)
