"""Data-parallel training of the port across processes on the CPU (gloo).

The counterpart of ``tests/test_multihost.py`` (two JAX processes, one global
mesh): two processes of ``tests/_torch_port_dp_worker.py`` each take half of a
global batch and run one step with the gradients and metrics averaged over
the group and the style loss's Grams formed over the global batch. Both
ranks report the same metrics (rtol 1e-5), keep equal parameters, and match
the one-process step on the whole batch: the metrics within JAX's multihost
bars (rtol 2e-3 / atol 1e-4, ``tests/test_multihost.py:99-109``); the step-1
gradients (Adam's first moments), leaf by leaf, within the train step's fp32
bars (rtol 1e-3, atol 1e-4 x the group's largest; ``chip_smoke.py``'s
``GRAD_RTOL``, ``GRAD_ATOL_REL``); the parameters within JAX's bars (rtol
1e-3 / atol 1e-5, ``tests/test_multichip.py``) wherever the gradient exceeds
its bar. Adam's first update is lr x g / (|g| + eps), about lr x sign(g): where
a gradient is within rounding of zero (the conv biases that an instance norm
cancels, for one), its sign, and so the parameter's move of up to 2 lr, is
rounding noise in either program. At a global batch of 32 the one-process
step runs its forwards unbatched (32 > ``BATCH_FORWARDS_MAX``) while each rank
(16) batches them. Then the train CLI under a launcher's environment, and the
CLI's own workers (``torch.multiprocessing``) on two devices.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import _torch_port_dp_worker as worker
from msig_tpu_torch.train import cli
from msig_tpu_torch.train.step import BATCH_FORWARDS_MAX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as each worker runs: the CPU convs' rounding depends
    on the thread count, and the step's gradients carry it (at 32² the GAN
    term's norm moves by 1e-5 between one and two threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(cmd, world: int, **popen):
    """``cmd`` as ``world`` ranks of one group on a free localhost port."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT)
        procs.append(subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True, **popen))
    outs = [p.communicate(timeout=600)[0] for p in procs]
    return [p.returncode for p in procs], outs


@pytest.mark.parametrize("global_batch", [4, 32])
def test_two_process_step_matches_one_process(tmp_path, global_batch):
    import json

    rcs, outs = _launch([sys.executable, os.path.join(ROOT, "tests", "_torch_port_dp_worker.py"),
                         str(tmp_path), str(global_batch)], 2)
    for rank, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {rank} failed:\n{out[-4000:]}"
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]
    assert all(r["replicated"] for r in ranks), "parameters differ between the ranks"
    assert all(r["device_data_refused"] for r in ranks), "--device_data ran in a group"
    m0, m1 = ranks[0]["metrics"], ranks[1]["metrics"]
    assert m0.keys() == m1.keys()
    for k in m0:
        np.testing.assert_allclose(m0[k], m1[k], rtol=1e-5, err_msg=f"{k} differs between ranks")

    # the one-process step on the whole batch, from the same parameters
    assert (global_batch > BATCH_FORWARDS_MAX) == (global_batch == 32)
    cfg, state, vgg, batch = worker.setup(global_batch)
    ref = worker.run_step(state, cfg, vgg, batch, distributed=False)
    assert ref.keys() == m0.keys()
    for k in ref:
        np.testing.assert_allclose(m0[k], ref[k], rtol=2e-3, atol=1e-4,
                                   err_msg=f"{k}: two processes != one process")
    got = np.load(tmp_path / "state.npz")
    want = worker.snapshot(state)
    assert set(got.files) == set(want)
    decided = 0
    for group in ("G_A2B", "G_B2A", "SE_A", "SE_B"), ("D_A", "D_B"):
        mus = {k: v for k, v in want.items() if k.startswith("mu:") and k[3:].split("/")[0] in group}
        atol = GRAD_ATOL_REL * max(np.abs(v).max() for v in mus.values())
        for k, mu in mus.items():
            bar = GRAD_RTOL * np.abs(mu) + atol
            assert (np.abs(got[k] - mu) <= bar).all(), f"{k}: step-1 gradient beyond its bar"
            name = "param:" + k[3:]
            sure = np.abs(mu) > bar  # the sign of the first update is the gradient's
            decided += int(sure.sum())
            np.testing.assert_allclose(got[name][sure], want[name][sure], rtol=1e-3, atol=1e-5,
                                       err_msg=name)
    # not vacuous: most elements have a gradient beyond its bar (68% at a batch of 4)
    assert decided > 0.5 * sum(v.size for k, v in want.items() if k.startswith("param:"))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_cli")
    rng = np.random.default_rng(0)
    for d, n in (("src/Tomato_healthy", 4), ("ref/DiseaseA", 3), ("ref/DiseaseB", 2)):
        os.makedirs(root / d)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(
                root / d / f"img{i}.jpg")
    return root


def _argv(tree, exp, *extra):
    return ["--device", "cpu", "--source_dir", str(tree / "src" / "Tomato_healthy"),
            "--target_dir", str(tree / "ref"), "--save_dir_base", str(tree / "results"),
            "--image_size", "32", "--batch_size", "2", "--epochs", "1", "--exp_name", exp,
            "--allow_random_vgg", *extra]


def test_cli_under_a_launcher(tree):
    """Two ranks as torchrun would start them: one group, rank 0 alone writes;
    a global batch the world size does not divide raises on every rank."""
    cmd = [sys.executable, "-m", "msig_tpu_torch.train"]
    rcs, outs = _launch(cmd + _argv(tree, "launched"), 2)
    for rank, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, out[-4000:]
        assert f"Process group: rank {rank} of 2 (data parallel)" in out
    ckpt = tree / "results" / "launched" / "checkpoints" / "epoch_1"
    assert sorted(os.listdir(ckpt)) == ["checkpoint.pth", "ema_checkpoint.pth"]

    rcs, outs = _launch(cmd + _argv(tree, "odd", "--batch_size", "3"), 2)
    for rc, out in zip(rcs, outs):
        assert rc != 0 and "does not split over 2" in out, out[-4000:]
    assert not (tree / "results" / "odd" / "checkpoints").exists()


def test_cli_starts_its_own_workers(tree, monkeypatch, capsys):
    """No launcher and two local devices: the CLI spawns two workers
    (``torch.multiprocessing``) that train as one gloo group."""
    from msig_tpu_torch.parallel import mesh

    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(mesh, "local_devices", lambda device: [torch.device("cpu")] * 2)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    args = cli.build_arg_parser().parse_args(_argv(tree, "spawned"))
    assert cli.main(cli.config_from_args(args)) == 0
    assert "Data parallel: 2 device(s)" in capsys.readouterr().out
    ckpt = tree / "results" / "spawned" / "checkpoints" / "epoch_1"
    assert sorted(os.listdir(ckpt)) == ["checkpoint.pth", "ema_checkpoint.pth"]
