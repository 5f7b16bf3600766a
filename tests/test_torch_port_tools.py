"""The port's tool modules on the CPU, and their independence from JAX.

``python -m msig_tpu_torch.tools.bench_v1_v2`` and ``python -m
msig_tpu_torch.tools.profile_fused_stages`` at batch 1 with ``--device cpu``,
where they run the kernels' plain versions: each prints every stage line of
the JAX tool it ports, launches no kernel and exits 0; ``--device cuda``
without a card exits non-zero. On the card ``chip_smoke.py`` runs both at
batch 8 and checks their launches.
"""

import pathlib
import subprocess
import sys

import pytest
import torch

from msig_tpu_torch.tools import bench_v1_v2, profile_fused_stages

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU_ONE = ["--batch", "1", "--device", "cpu", "--iters", "1", "--warmup", "0"]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "msig_tpu")


def test_bench_v1_v2_cpu_prints_every_site(capsys):
    result = bench_v1_v2.main(CPU_ONE)
    out = capsys.readouterr().out
    for label in ("relu site   v1:", "relu site   v2:", "res site    v1:", "res site    v2:",
                  "up0 site    v1:", "up0 site    v2:", "up1 site    v1:", "up1 site    v2:"):
        assert label in out
        assert result["sites"][label[:-1]]["launches"] == {}
        assert result["sites"][label[:-1]]["ms"] > 0
    assert result["calls"] == 1 and result["batch"] == 1


def test_profile_fused_stages_cpu_prints_every_stage(capsys):
    result = profile_fused_stages.main(CPU_ONE)
    out = capsys.readouterr().out
    stages = ["encoder (3 convs)", "fused trunk (16 sites)", "  conv1 site alone",
              "  conv2 site alone", "fused decoder (2 ups+final)", "  up0 kernel alone",
              "  up1 kernel alone", "full (one program)"]
    assert list(result["stages"]) == stages
    for name in stages + ["sum of stages"]:
        assert f"{name:30s}:" in out
    assert all(s["launches"] == {} for s in result["stages"].values())
    assert result["sum_ms"] > 0


@pytest.mark.parametrize("module", ["bench_v1_v2", "profile_fused_stages"])
def test_tools_without_card_exit_nonzero(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", f"msig_tpu_torch.tools.{module}", "--batch", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr


def test_tools_import_without_jax():
    code = (
        "import sys, importlib\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "for m in ('msig_tpu_torch.tools', 'msig_tpu_torch.tools.bench_v1_v2',\n"
        "          'msig_tpu_torch.tools.profile_fused_stages', 'msig_tpu_torch.ops.fused_conv_int8',\n"
        "          'msig_tpu_torch.ops.int8_epilogue'):\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
