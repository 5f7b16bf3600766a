"""``python -m msig_tpu_torch.train`` on the CPU, and what it writes.

- one epoch at 32², batch 2, over a synthetic tree of 4 sources and 2 target
  domains, with ``--allow_random_vgg``: exit 0, and ``checkpoint.pth`` /
  ``ema_checkpoint.pth`` in the reference format (six state_dicts, Adam
  state_dicts with the moments, schedulers, loss history, num_domains);
- the JAX package's ``msig_tpu.compat.torch_import.load_torch_checkpoint_dir``
  reads that checkpoint, and its generator gives the port's generator output
  (fp32, rtol 1e-3 / atol 1e-4);
- ``python -m msig_tpu_torch.inference --device cpu`` serves from the same
  directory;
- exit 1 without a VGG choice or with a missing directory, as ``main.py``;
  ``--wandb`` without the wandb package fails at its import, as ``main.py``
  does (``tests/test_torch_port_wandb.py`` holds the run).
"""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from msig_tpu.compat.torch_import import load_torch_checkpoint_dir
from msig_tpu.models import StyleCycleGANGenerator as JGen

from msig_tpu_torch import inference as infer_cli
from msig_tpu_torch.models import MultiDomainStyleEncoder, StyleCycleGANGenerator
from msig_tpu_torch.train import cli
from msig_tpu_torch.train.state import D_KEYS, G_KEYS

N_RES, SDIM, ND = 8, 256, 3  # the CLI's defaults; 2 target domains + the source


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(0)
    for d, n in (("src/Tomato_healthy", 4), ("ref/DiseaseA", 3), ("ref/DiseaseB", 2)):
        os.makedirs(root / d)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(
                root / d / f"img{i}.jpg")
    return root


def _args(tree, *extra):
    return cli.build_arg_parser().parse_args([
        "--device", "cpu", "--source_dir", str(tree / "src" / "Tomato_healthy"),
        "--target_dir", str(tree / "ref"), "--save_dir_base", str(tree / "results"),
        "--image_size", "32", "--batch_size", "2", "--epochs", "1", "--exp_name", "t", *extra])


@pytest.fixture(scope="module")
def trained(tree):
    rc = cli.main(cli.config_from_args(_args(tree, "--allow_random_vgg", "--ema_snapshot_every",
                                             "1")))
    return rc, tree / "results" / "t"


def test_cli_trains_one_epoch(trained):
    rc, out = trained
    assert rc == 0
    ckpt = out / "checkpoints" / "epoch_1"
    assert (ckpt / "checkpoint.pth").exists() and (ckpt / "ema_checkpoint.pth").exists()
    assert len(list((out / "images").glob("epoch_001_batch_0000_*.png"))) == 1


def test_checkpoint_is_in_the_reference_format(trained):
    ckpt = torch.load(trained[1] / "checkpoints" / "epoch_1" / "checkpoint.pth",
                      map_location="cpu", weights_only=False)
    assert set(ckpt) == set(G_KEYS + D_KEYS) | {"g_optimizer", "d_optimizer", "g_scheduler",
                                                 "d_scheduler", "loss_history", "num_domains"}
    assert ckpt["num_domains"] == ND and len(ckpt["loss_history"]["G_loss"]) == 1
    gen = StyleCycleGANGenerator(style_dim=SDIM, n_residual_blocks=N_RES)
    gen.load_state_dict(ckpt["G_A2B"], strict=True)
    params = [p for k in G_KEYS for p in ckpt[k].values()]
    opt = torch.optim.Adam([torch.zeros_like(p, requires_grad=True) for p in params],
                           lr=2e-4, betas=(0.5, 0.999))
    opt.load_state_dict(ckpt["g_optimizer"])
    state = ckpt["g_optimizer"]["state"]
    assert len(state) == len(params) and float(state[0]["step"]) == 2.0  # two steps
    assert any(bool(s["exp_avg"].any()) for s in state.values())
    ema = torch.load(trained[1] / "checkpoints" / "epoch_1" / "ema_checkpoint.pth",
                     map_location="cpu", weights_only=True)
    assert set(ema) == {f"ema_{k}" for k in G_KEYS}


def test_jax_reads_the_checkpoint_and_its_generator_agrees(trained):
    ckpt_dir = str(trained[1] / "checkpoints" / "epoch_1")
    _, _, ema = load_torch_checkpoint_dir(ckpt_dir, ND, SDIM, N_RES)
    sd = torch.load(os.path.join(ckpt_dir, "ema_checkpoint.pth"), map_location="cpu",
                    weights_only=True)
    gen = StyleCycleGANGenerator(style_dim=SDIM, n_residual_blocks=N_RES)
    gen.load_state_dict(sd["ema_G_A2B"])
    se = MultiDomainStyleEncoder(style_dim=SDIM, num_domains=ND)
    se.load_state_dict(sd["ema_SE_B"])
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        style = se(torch.from_numpy(img), torch.tensor([1, 2]))
        got = gen(torch.from_numpy(img), style).numpy()
    want = JGen(style_dim=SDIM, n_residual_blocks=N_RES).apply(
        ema["G_A2B"], jnp.asarray(img), jnp.asarray(style.numpy()))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("which", ["checkpoint", "ema_snapshot"])
def test_port_inference_serves_what_training_wrote(trained, tree, tmp_path, which):
    ckpt = (trained[1] / "checkpoints" / "epoch_1" if which == "checkpoint"
            else trained[1] / "ema_snapshots" / "epoch_1")
    args = infer_cli.build_arg_parser().parse_args([
        "--input_dir", str(tree / "src" / "Tomato_healthy"), "--ref_domains_dir", str(tree / "ref"),
        "--checkpoint_dir", str(ckpt), "--output_dir", str(tmp_path), "--target_domain",
        "DiseaseB", "--style_mode", "average", "--image_size", "32", "--batch_size", "4",
        "--compute_dtype", "float32", "--device", "cpu"])
    assert infer_cli.main(infer_cli.config_from_args(args)) == 0
    assert len(os.listdir(tmp_path)) == 4


def test_no_vgg_choice_exits_1(tree, capsys):
    assert cli.main(cli.config_from_args(_args(tree))) == 1
    assert "--allow_random_vgg" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--source_dir", "--target_dir", "--vgg_weights"])
def test_missing_paths_exit_1(tree, flag):
    args = _args(tree, "--allow_random_vgg")
    setattr(args, flag[2:], str(tree / "nowhere"))
    assert cli.main(cli.config_from_args(args)) == 1


@pytest.mark.parametrize("extra", [["--wandb"]])
def test_flags_not_ported_yet_raise(tree, extra, monkeypatch):
    """Every flag of ``main.py`` is ported: ``--wandb`` (the last) imports the
    package after the CLI's checks and, without it, fails at that import as
    ``main.py`` does; ``tests/test_torch_port_wandb.py`` holds the run itself."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # the package is absent
    with pytest.raises(ImportError, match="wandb"):
        cli.main(cli.config_from_args(_args(tree, "--allow_random_vgg", *extra)))


def test_multihost_without_rendezvous_runs_one_process(tree, monkeypatch, capsys):
    """``--multihost`` with no launcher in the environment: one process, as the
    JAX CLI logs and runs single-host without a coordinator."""
    import torch.distributed as dist

    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    args = _args(tree, "--allow_random_vgg", "--multihost", "--epochs", "0",
                 "--exp_name", "multihost")
    assert cli.main(cli.config_from_args(args)) == 0
    assert "Data parallel: 1 device(s)" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_cuda_without_a_card_exits_1(tree):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = _args(tree, "--allow_random_vgg")
    args.device = "cuda"
    assert cli.main(cli.config_from_args(args)) == 1
