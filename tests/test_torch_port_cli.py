"""Guards of the port: independence from JAX, device handling, and its CLI.

- every module of msig_tpu_torch imports with jax, flax, optax and msig_tpu
  blocked, and an AST scan finds no such import in it or in chip_smoke.py;
- ``python -m msig_tpu_torch.inference --device cuda`` without a card exits
  non-zero with a message, never falling back to the CPU;
- a CPU run on the demo checkpoint writes one image per readable input and
  skips a corrupt file, as the JAX CLI does.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from msig_tpu_torch import inference as cli
from msig_tpu_torch import resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "msig_tpu_torch"
DEMO = str(ROOT / "results" / "tomato_r3b" / "demo_checkpoint")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "msig_tpu")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import msig_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(msig_tpu_torch.__path__, 'msig_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_msig_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, f"{path}: imports {name}"


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_cli_cuda_without_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "msig_tpu_torch.inference", "--device", "cuda",
         "--input_dir", str(tmp_path), "--ref_domains_dir", str(tmp_path),
         "--checkpoint_dir", DEMO, "--output_dir", str(tmp_path / "out")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stdout + out.stderr
    assert not (tmp_path / "out").exists()


@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    (root / "in").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (72, 80, 3), dtype=np.uint8)).save(
            root / "in" / f"leaf{i}.jpg")
    (root / "in" / "broken.jpg").write_bytes(b"not an image at all")
    for d in range(9):  # the demo checkpoint has 10 domains: 9 targets + source
        (root / "ref" / f"dom{d}").mkdir(parents=True)
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
            root / "ref" / f"dom{d}" / "r0.png")
    return root


def _args(root, *extra):
    return cli.build_arg_parser().parse_args(
        ["--input_dir", str(root / "in"), "--ref_domains_dir", str(root / "ref"),
         "--checkpoint_dir", DEMO, "--target_domain", "dom2", "--image_size", "64",
         "--batch_size", "2", "--device", "cpu", *extra])


@pytest.mark.parametrize("extra", [("--quantize", "int8", "--style_mode", "average"),
                                   ("--style_mode", "noise", "--compute_dtype", "float32")])
def test_cli_cpu_demo_skips_corrupt_input(cli_dirs, tmp_path, extra, caplog):
    out = tmp_path / "out"
    args = _args(cli_dirs, "--output_dir", str(out), *extra)
    assert cli.main(cli.config_from_args(args)) == 0
    assert sorted(os.listdir(out)) == ["leaf0.jpg", "leaf1.jpg", "leaf2.jpg"]
    assert "broken.jpg" in caplog.text
    with Image.open(out / "leaf0.jpg") as im:
        assert im.size == (64, 64)


def test_cli_multi_domain_writes_per_domain_dirs(cli_dirs, tmp_path):
    out = tmp_path / "out"
    args = _args(cli_dirs, "--output_dir", str(out), "--quantize", "int8",
                 "--style_mode", "specific")
    args.target_domain = "dom0,dom5"
    assert cli.main(cli.config_from_args(args)) == 0
    assert sorted(os.listdir(out)) == ["dom0", "dom5"]
    assert len(os.listdir(out / "dom5")) == 3


@pytest.mark.parametrize("extra,msg", [
    (("--target_domain", "nope"), "not found"),
    (("--target_domain", " , "), "names no domain"),
    (("--style_mode", "latent"), "--style_mode latent requires --mapping_params"),
])
def test_cli_refusals_exit_1(cli_dirs, tmp_path, extra, msg, capsys):
    args = _args(cli_dirs, "--output_dir", str(tmp_path / "o"), *extra)
    assert cli.main(cli.config_from_args(args)) == 1
    assert msg in capsys.readouterr().out


def test_cli_serves_with_data_parallel_on_cpu(cli_dirs, tmp_path):
    """``--data_parallel --device cpu``: one CPU device, so the single-device
    engine serves, as the JAX CLI does on one chip."""
    out = tmp_path / "out"
    args = _args(cli_dirs, "--output_dir", str(out), "--quantize", "int8", "--data_parallel")
    assert cli.main(cli.config_from_args(args)) == 0
    assert sorted(os.listdir(out)) == ["leaf0.jpg", "leaf1.jpg", "leaf2.jpg"]


def test_cli_empty_input_exit_1(cli_dirs, tmp_path):
    (tmp_path / "empty").mkdir()
    args = _args(cli_dirs, "--output_dir", str(tmp_path / "o"))
    args.input_dir = str(tmp_path / "empty")
    assert cli.main(cli.config_from_args(args)) == 1


def test_cli_flags_match_reference_cli():
    """Every flag of the root inference.py exists here, with the same default."""
    import inference as jax_cli

    ours = {tuple(a.option_strings): a.default for a in cli.build_arg_parser()._actions}
    for a in jax_cli.build_arg_parser()._actions:
        key = tuple(a.option_strings)
        assert key in ours, key
        assert ours[key] == a.default, key
    assert ours[("--device",)] == "cuda"
