"""``--wandb`` in the port's train CLI against the JAX package's ``main.py`` and
trainer, on the CPU, with a stub ``wandb`` module (the port never imports the
real one here).

- ``wandb.init``: the port CLI's arguments equal ``main.py``'s on the same
  flags (project, name; every field of JAX's config with its value, the port's
  config adding ``device``), after the CLI's checks (a refused run starts none);
- ``finish()`` once on the train branch, on the ``--profile_steps`` branch and
  when training raises;
- the trainer's ``log()`` calls: in order, the same keys as the JAX trainer's
  (``tools/wandb_logs_golden.py``'s golden; ``-m slow`` runs it live), the
  gradient histograms on the same steps, one a torch parameter (JAX's one a
  flax leaf: each stacked head, one leaf, is one parameter a domain);
- with ``cfg.wandb`` and no run (a rank that holds none) the watch step runs on
  the same steps and nothing is logged;
- two gloo ranks of the CLI under a launcher's environment with a stub module
  first on ``PYTHONPATH``: one run (local rank 0), both ranks on the watch
  step at the same steps.
"""

from __future__ import annotations

import importlib.util
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "wandb_logs_golden", os.path.join(ROOT, "tools", "wandb_logs_golden.py"))
wg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(wg)
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
STACKED_HEADS = 8  # SE_A, SE_B, D_A, D_B heads, weight and bias: one flax leaf each


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class _Record:
    def __init__(self):
        self.init, self.logs, self.finish = [], [], 0


@pytest.fixture
def stub(monkeypatch):
    """A wandb module in sys.modules whose runs record their calls."""
    rec = _Record()
    mod = wg.stub_wandb_module()

    class Run:
        def log(self, d):
            rec.logs.append(dict(d))

        def finish(self):
            rec.finish += 1

    def init(**kwargs):
        rec.init.append(kwargs)
        return Run()

    mod.init = init
    monkeypatch.setitem(sys.modules, "wandb", mod)
    monkeypatch.setenv("MSIG_SKIP_EPOCH_ART", "1")
    return rec


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("wandb")
    wg.make_tree(str(root))
    return root


def _argv(tree, *extra):
    return ["--source_dir", str(tree / "src" / "S"), "--target_dir", str(tree / "ref"),
            "--save_dir_base", str(tree / "out"), "--exp_name", "w", "--allow_random_vgg",
            "--image_size", "32", "--batch_size", "2", "--wandb", *extra]


def _port_cli(argv) -> int:
    from msig_tpu_torch.train import cli

    return cli.main(cli.config_from_args(cli.build_arg_parser().parse_args(
        argv + ["--device", "cpu"])))


def test_init_arguments_equal_jax_main(tree, stub, monkeypatch):
    import main as jax_main
    from msig_tpu.train import trainer as jax_trainer

    argv = _argv(tree, "--epochs", "0", "--lr_g", "0.0003", "--watch_freq", "5")
    assert _port_cli(argv) == 0
    assert len(stub.init) == 1 and stub.finish == 1
    port = stub.init.pop()

    class NoTraining:  # the JAX CLI's trainer, which would compile the step
        def __init__(self, cfg, dataset, wandb_run=None):
            pass

        def train(self, start_epoch=0):
            pass

    monkeypatch.setattr(jax_trainer, "Trainer", NoTraining)
    assert jax_main.main(jax_main.config_from_args(jax_main.build_arg_parser().parse_args(
        argv))) == 0
    want = stub.init.pop()
    assert (port["project"], port["name"]) == (want["project"], want["name"]) == (
        "Multi-Domain Style-Injected CycleGAN", "w")
    assert set(want["config"]) <= set(port["config"])
    assert set(port["config"]) - set(want["config"]) == {"device"}
    for k, v in want["config"].items():
        assert port["config"][k] == v, k
    assert port["config"]["wandb"] is True and port["config"]["lr_g"] == 0.0003


def test_a_refused_run_starts_no_wandb_run(tree, stub):
    assert _port_cli(_argv(tree, "--vgg_weights", str(tree / "none.npz"))) == 1
    assert stub.init == [] and stub.finish == 0


@pytest.mark.parametrize("branch", ["profile_steps", "train_raises"])
def test_finish_runs_once(tree, stub, monkeypatch, branch):
    from msig_tpu_torch.train import trainer as tr

    if branch == "profile_steps":
        monkeypatch.setattr(tr.Trainer, "profile_steps", lambda self, n: str(tree / "p"))
        assert _port_cli(_argv(tree, "--profile_steps", "1")) == 0
    else:
        def fail(self, start_epoch=0):
            raise RuntimeError("boom")

        monkeypatch.setattr(tr.Trainer, "train", fail)
        assert _port_cli(_argv(tree, "--epochs", "1")) == 1
    assert len(stub.init) == 1 and stub.finish == 1


def _trainer(tree, run, wandb=True):
    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.data import MultiDomainDataset
    from msig_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(**dict(wg.config(str(tree)), wandb=wandb), allow_random_vgg=True,
                      device="cpu")
    return Trainer(cfg, MultiDomainDataset.build(cfg.source_dir, cfg.target_dir), wandb_run=run)


@pytest.fixture(scope="module")
def golden():
    with open(wg.GOLDEN) as f:
        return json.load(f)["logs"]


def _watched(logs):
    return [i for i, lg in enumerate(logs) if lg["histograms"]]


def test_trainer_logs_the_jax_trainers_keys(tree, stub, golden):
    run = wg.StubRun()
    trainer = _trainer(tree, run)
    trainer.train()
    got = wg.summary(run.logs)
    assert [lg["keys"] for lg in got] == [lg["keys"] for lg in golden]
    assert _watched(got) == _watched(golden) == [0, 3]
    params = [f"gradients/{k}.{n}" for k, net in trainer.state.models.nets.items()
              for n, _ in net.named_parameters()]
    nd = trainer.num_domains
    for i in _watched(got):
        assert sorted(k for k in run.logs[i] if k.startswith("gradients/")) == sorted(params)
        assert golden[i]["histograms"] - STACKED_HEADS + STACKED_HEADS * nd == len(params)
    assert trainer.watch_steps == [0, 2]


def test_watch_step_without_a_run_on_a_wandb_rank(tree, monkeypatch):
    """A rank of a --wandb run that holds no run steps the watch step on the same
    steps (the ranks run one program) and logs nothing."""
    monkeypatch.setenv("MSIG_SKIP_EPOCH_ART", "1")
    trainer = _trainer(tree, None)
    assert trainer.train_step_watch is not None
    trainer.train()
    assert trainer.watch_steps == [0, 2]
    assert _trainer(tree, None, wandb=False).train_step_watch is None


@pytest.mark.slow
def test_golden_is_the_jax_trainers_logs(tmp_path, golden):
    wg.make_tree(str(tmp_path))
    assert wg.jax_logs(str(tmp_path)) == golden


STUB = '''"""A stub of wandb: each init appends this process's rank to init.jsonl beside it."""
import json, os


class Histogram:
    def __init__(self, np_histogram=None, **kwargs):
        self.counts, self.edges = np_histogram


class _Run:
    def log(self, data):
        pass

    def finish(self):
        pass


def init(**kwargs):
    with open(os.path.join(os.path.dirname(__file__), "init.jsonl"), "a") as f:
        f.write(json.dumps({"rank": os.environ.get("RANK"), "name": kwargs["name"]}) + "\\n")
    return _Run()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_ranks_start_one_run_and_watch_on_the_same_steps(tree, tmp_path):
    stub_dir = tmp_path / "stub"
    stub_dir.mkdir()
    (stub_dir / "wandb.py").write_text(STUB)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   MSIG_SKIP_EPOCH_ART="1", PYTHONPATH=os.pathsep.join([str(stub_dir), ROOT]))
        argv = _argv(tree, "--epochs", "1", "--watch_freq", "1", "--save_dir_base",
                     str(tmp_path / "out"), "--device", "cpu")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "_torch_port_wandb_worker.py"),
             str(tmp_path), *argv], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-4000:]}"
        assert f"Process group: rank {rank} of 2 (data parallel)" in out
    inits = [json.loads(ln) for ln in (stub_dir / "init.jsonl").read_text().splitlines()]
    assert inits == [{"rank": "0", "name": "w"}]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert ranks[0] == {"watch_steps": [0, 1], "run": True}
    assert ranks[1] == {"watch_steps": [0, 1], "run": False}


def test_without_the_package_wandb_fails_at_the_import(tree, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError):
        _port_cli(_argv(tree, "--epochs", "0"))
