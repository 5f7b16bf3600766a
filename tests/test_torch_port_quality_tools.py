"""The port's quality tools (``python -m msig_tpu_torch.tools.<name>``) against
the JAX package's root tools, on the CPU.

The inputs are ``tools/quality_tools_golden.py``'s: a seeded tree (two
sources, two target domains of three references) and two seeded EMA
snapshots (one resblock, style_dim 16); the JAX side is that script's golden
(its ``-m slow`` test runs the root tools live, about 40 s of compilation).

- ``export_demo_checkpoint``: on a ``checkpoint.pth`` directory and on a demo
  directory, the npz's keys, shapes and fp16 bits and ``meta.json`` equal the
  root tool's (run live: no compilation); an Orbax directory is refused naming
  ``tools/export_torch_checkpoint.py``;
- ``eval_quality``: the generated images (bf16, as both tools run) within 3
  uint8 steps of JAX's, under 2% more than 1 apart (bf16 rounds its products
  and statistics in another order than XLA); the float32 engine's images of
  the same translation (``FP32_SIZE``) within the float path's bars (fp32 rtol
  1e-3 / atol 1e-4 is at most one uint8 step after the truncation); the
  colour-Fréchet and hist-TV of the same directories equal JAX's
  ``pixel_stats`` within 1e-6; the proxy-FID equal to the port's
  ``fid_between_dirs`` on the same directories; the root tool's keys;
- ``eval_trajectory_fast`` / ``eval_trajectory_batch``: ``trajectory.csv``'s
  header, rows (epoch, domain) and source baselines equal JAX's, the
  generated columns within the bf16 images' reach (rtol 5e-2); the plot, or a
  line that says why it is skipped;
- ``eval_quality_trajectory``: ``eval_quality`` in a process of its own per
  checkpoint not yet scored, a failure retried once;
- ``ops/conv3x3_vjp.py::supported`` equals JAX's over the 256²- and
  512²-input trunks and past the 24 MB slab limit;
- each tool exits 1 with ``--device cuda`` and no card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "quality_tools_golden", os.path.join(ROOT, "tools", "quality_tools_golden.py"))
tg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tg)

TOOLS = ("export_demo_checkpoint", "eval_quality", "eval_trajectory_fast",
         "eval_trajectory_batch", "eval_quality_trajectory")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tool(name):
    return importlib.import_module(f"msig_tpu_torch.tools.{name}")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("quality")
    tg.make_inputs(str(root))
    return root


@pytest.fixture(scope="module")
def golden():
    with np.load(tg.GOLDEN) as z:
        return {k: (str(z[k]) if z[k].dtype.kind == "U" else z[k]) for k in z.files}


def _common(root):
    return ["--source_dir", str(root / "src" / "S"), "--ref_dir", str(root / "ref"),
            *tg.EVAL_ARGS, "--device", "cpu"]


# ------------------------------------------------------------------ export

@pytest.fixture(scope="module")
def checkpoint(inputs):
    """A reference-format checkpoint.pth directory of a seeded train state."""
    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.train.checkpoint import save_checkpoint
    from msig_tpu_torch.train.state import create_train_state

    cfg = TrainConfig(style_dim=tg.SDIM, n_residual_blocks=tg.N_RES, device="cpu")
    path = inputs / "ckpt"
    save_checkpoint(str(path), create_train_state(cfg, tg.ND), {"G_loss": [1.0]}, cfg.lr_g,
                    cfg.lr_d, 10)
    return path


@pytest.mark.parametrize("source", ["checkpoint.pth", "demo"])
def test_export_matches_jax(inputs, checkpoint, tmp_path, source):
    src = str(checkpoint) if source == "checkpoint.pth" else str(inputs / "snaps" / "epoch_2")
    flags = ["--checkpoint", src, "--num_domains", str(tg.ND), "--style_dim", str(tg.SDIM),
             "--n_residual_blocks", str(tg.N_RES)]
    meta = _tool("export_demo_checkpoint").main(flags + ["--out", str(tmp_path / "port"),
                                                         "--device", "cpu"])
    tg._run(tg._root_tool("export_demo_checkpoint"), flags + ["--out", str(tmp_path / "jax")])
    got, want = (np.load(tmp_path / d / "ema_g_se_fp16.npz") for d in ("port", "jax"))
    assert set(got.files) == set(want.files) and len(got.files) > 20
    for k in want.files:
        assert got[k].dtype == want[k].dtype == np.float16 and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].view(np.uint16), want[k].view(np.uint16), err_msg=k)
    metas = [json.loads((tmp_path / d / "meta.json").read_text()) for d in ("port", "jax")]
    assert metas[0] == metas[1] == meta
    assert meta["ema"] is True and meta["num_domains"] == tg.ND


def test_export_refuses_an_orbax_directory(tmp_path):
    (tmp_path / "state").mkdir()
    (tmp_path / "meta.json").write_text("{}")
    with pytest.raises(ValueError, match="tools/export_torch_checkpoint.py"):
        _tool("export_demo_checkpoint").main(["--checkpoint", str(tmp_path), "--out",
                                              str(tmp_path / "out"), "--device", "cpu"])


@pytest.mark.parametrize("name", TOOLS)
def test_tools_without_a_card_exit_1(name, inputs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = {"export_demo_checkpoint": ["--checkpoint", str(inputs / "snaps" / "epoch_1"),
                                       "--out", str(tmp_path)],
            "eval_quality": ["--checkpoint", str(inputs / "snaps" / "epoch_1")]}.get(name, [])
    with pytest.raises(SystemExit) as e:
        _tool(name).main(argv + ["--device", "cuda"])
    assert "torch.cuda.is_available() is False" in str(e.value.code)
    assert not os.listdir(tmp_path)


# ------------------------------------------------------------- eval_quality

@pytest.fixture(scope="module")
def port_quality(inputs):
    out = inputs / "port_quality"
    report = _tool("eval_quality").main(["--checkpoint", str(inputs / "snaps" / "epoch_2"),
                                         "--out", str(out), "--domains", "0", "--samples", "2",
                                         *_common(inputs)])
    return out, report


def test_eval_quality_writes_the_root_tools_files(port_quality, golden):
    out, report = port_quality
    want = json.loads(golden["quality_json"])
    assert json.loads((out / "quality.json").read_text()) == report
    assert list(report) == list(want) == list(tg.DOMAINS)
    for name in tg.DOMAINS:
        assert list(report[name]) == list(want[name])
        assert sorted(os.listdir(out / "generated" / name)) == ["0.png", "1.png"]
        assert (out / f"samples_{name}.jpg").exists()


@pytest.mark.parametrize("name", tg.DOMAINS)
def test_eval_quality_images_near_jax(port_quality, golden, name):
    """bf16 in both tools: within 3 uint8 steps, under 2% more than 1 apart."""
    out, _ = port_quality
    got = tg.load_u8_dir(str(out / "generated" / name))[:1].astype(int)
    diff = np.abs(got - golden[f"generated_{name}"].astype(int))
    assert got.shape == (1, 256, 256, 3)
    assert diff.max() <= 3 and (diff > 1).mean() < 0.02, (diff.max(), (diff > 1).mean())


def test_translation_in_float32_within_the_float_bars(inputs, golden):
    """The tools' translation (engine, average style, truncating uint8) with a
    float32 engine: at most one uint8 step from JAX's float32 engine (the float
    path's bars, rtol 1e-3 / atol 1e-4, are 0.13 of a step), on under 1%."""
    from msig_tpu_torch.config import InferenceConfig
    from msig_tpu_torch.data import list_image_files, load_inference_image
    from msig_tpu_torch.infer.loading import load_inference_params
    from msig_tpu_torch.tools import _quality as q

    size = tg.FP32_SIZE
    cfg = InferenceConfig(image_size=size, batch_size=tg.N_SRC, compute_dtype="float32",
                          device="cpu")
    gen, se, meta, _ = load_inference_params(str(inputs / "snaps" / "epoch_2"), cfg, tg.ND)
    eng = q.build_engine(cfg, tg.ND, gen, se, meta)
    load = lambda d: np.stack([load_inference_image(p, size)  # noqa: E731
                               for p in list_image_files(str(inputs / d))])
    bank = eng.encode_styles(load("ref/A"), 1)
    (got, _), = q.translate(eng, load("src/S"), ["0", "1"], bank, tg.N_SRC)
    diff = np.abs(got.astype(int) - golden["fp32_A"].astype(int))
    assert got.shape == golden["fp32_A"].shape
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (diff.max(), (diff > 0).mean())


def test_eval_quality_metrics_on_the_same_directories(port_quality, inputs):
    """Colour-Fréchet and hist-TV equal JAX's pixel_stats within 1e-6 on the
    same directories; the proxy-FID is the port's fid_between_dirs."""
    from msig_tpu.eval.pixel_stats import pixel_metrics_between_dirs as jax_pixel

    from msig_tpu_torch.eval.fid import fid_between_dirs
    from msig_tpu_torch.eval.pixel_stats import pixel_metrics_between_dirs

    out, report = port_quality
    src = str(inputs / "src" / "S")
    for name in tg.DOMAINS:
        ref = str(inputs / "ref" / name)
        for kind, d in (("generated", str(out / "generated" / name)), ("source", src)):
            cf, tv = pixel_metrics_between_dirs(d, ref, 256)
            jcf, jtv = jax_pixel(d, ref, 256)
            assert abs(cf - jcf) <= 1e-6 and abs(tv - jtv) <= 1e-6, (name, kind)
            row = report[name]
            assert row[f"color_frechet_{kind}_vs_ref"] == round(cf, 6)
            assert row[f"hist_tv_{kind}_vs_ref"] == round(tv, 4)
            fid = fid_between_dirs(d, ref, image_size=256, device="cpu")
            assert row[f"proxy_fid_{kind}_vs_ref"] == round(fid, 6)


# ----------------------------------------------------------- trajectories

def _csv(text):
    lines = text.strip().splitlines()
    return lines[0], [ln.split(",") for ln in lines[1:]]


@pytest.fixture(scope="module")
def port_runs(inputs):
    runs = {}
    for tool in ("eval_trajectory_fast", "eval_trajectory_batch"):
        out = inputs / f"port_{tool}"
        rows = _tool(tool).main(["--snap_root", str(inputs / "snaps"), "--out", str(out),
                                 *_common(inputs)])
        runs[tool] = (out, rows)
    return runs


@pytest.mark.parametrize("tool", ["eval_trajectory_fast", "eval_trajectory_batch"])
def test_trajectory_csv_matches_jax(port_runs, golden, tool):
    out, rows = port_runs[tool]
    head, got = _csv((out / "trajectory.csv").read_text())
    jhead, want = _csv(golden[f"{tool}_csv"])
    assert head == jhead
    assert [r[:2] for r in got] == [r[:2] for r in want] == [
        [str(e), d] for e in (1, 2) for d in tg.DOMAINS]
    cols = head.split(",")
    for g, w in zip(got, want):
        for i, col in enumerate(cols[2:], 2):
            if col.endswith("_src") and not col.startswith("proxy_fid"):
                assert g[i] == w[i], (g, w, col)  # the same images, numpy on both sides
            elif not col.startswith("proxy_fid"):  # generated: the bf16 images differ
                np.testing.assert_allclose(float(g[i]), float(w[i]), rtol=5e-2, err_msg=col)
    assert sorted(rows) == [1, 2]
    for e in (1, 2):
        assert json.loads((out / f"epoch_{e}" / "quality.json").read_text()) == rows[e]
    assert (out / "trajectory.png").exists()
    if tool == "eval_trajectory_fast":  # strips of the last snapshot only
        assert sorted(f for f in os.listdir(out / "epoch_2") if f.endswith(".jpg")) == [
            f"samples_{d}.jpg" for d in tg.DOMAINS]
        assert not any(f.endswith(".jpg") for f in os.listdir(out / "epoch_1"))
    else:
        assert sorted(os.listdir(out / "epoch_1" / "generated")) == list(tg.DOMAINS)


def test_trajectory_reads_back_scored_epochs_and_skips_the_plot(port_runs, tmp_path,
                                                                 monkeypatch, capsys):
    """An epoch whose quality.json exists is not recomputed; MSIG_SKIP_EPOCH_ART=1
    (as where matplotlib is missing) skips trajectory.png and says so."""
    from msig_tpu_torch.tools import _quality as q

    src, rows = port_runs["eval_trajectory_fast"]
    for e in (1, 2):
        (tmp_path / f"epoch_{e}").mkdir()
        shutil.copy(src / f"epoch_{e}" / "quality.json", tmp_path / f"epoch_{e}")
    monkeypatch.setenv("MSIG_SKIP_EPOCH_ART", "1")
    monkeypatch.setattr(q, "build_engine", lambda *a: pytest.fail("recomputed a scored epoch"))
    got = _tool("eval_trajectory_fast").main(["--snap_root", str(src.parent / "snaps"),
                                              "--out", str(tmp_path), "--device", "cpu",
                                              "--source_dir", str(src.parent / "src" / "S"),
                                              "--ref_dir", str(src.parent / "ref")])
    assert got == rows
    assert (tmp_path / "trajectory.csv").read_text() == (src / "trajectory.csv").read_text()
    assert not (tmp_path / "trajectory.png").exists()
    said = capsys.readouterr().out
    assert "epoch 1: cached" in said and "trajectory.png skipped: MSIG_SKIP_EPOCH_ART=1" in said


def _quality_trajectory(inputs, port_runs, out, call=None, monkeypatch=None):
    """eval_quality_trajectory over the two snapshots with epoch 1 already scored
    (read back) and epoch 2 scored by its ``eval_quality`` command, run by
    ``call`` (default: a process of its own)."""
    (out / "epoch_1").mkdir(parents=True)
    shutil.copy(port_runs["eval_trajectory_batch"][0] / "epoch_1" / "quality.json",
                out / "epoch_1")
    argv = ["--ckpt_root", str(inputs / "snaps"), "--extra_root", str(out / "none"),
            "--out", str(out), "--n_images", str(tg.N_SRC), "--source_dir",
            str(inputs / "src" / "S"), "--ref_dir", str(inputs / "ref"), "--device", "cpu"]
    mod = _tool("eval_quality_trajectory")
    if call is not None:
        monkeypatch.setattr(mod.subprocess, "call", call)
    rows = mod.main(argv)
    assert sorted(rows) == [1, 2]
    assert sorted(os.listdir(out / "epoch_2")) == ["generated", "quality.json"]
    from msig_tpu_torch.tools._quality import CSV_HEADER

    head, got = _csv((out / "trajectory.csv").read_text())
    assert head == CSV_HEADER.strip()
    assert [r[:2] for r in got] == [[str(e), d] for e in (1, 2) for d in tg.DOMAINS]
    batch = json.loads((port_runs["eval_trajectory_batch"][0] / "epoch_2" /
                        "quality.json").read_text())
    assert rows[2].keys() == batch.keys()
    for d in rows[2]:  # the same translation and metrics as the batch runner's
        for k, v in rows[2][d].items():
            np.testing.assert_allclose(v, batch[d][k], rtol=1e-3, atol=1e-4, err_msg=f"{d} {k}")


def test_quality_trajectory_scores_each_checkpoint_not_yet_scored(inputs, port_runs, tmp_path,
                                                                  monkeypatch):
    """The command it runs for epoch 2 (only) is ``python -m
    msig_tpu_torch.tools.eval_quality`` with the root tool's flags and
    ``--device``; here run in this process with ``--batch_size 2`` added (the
    runner passes none, as the root runner: the default 32 pads the two
    sources to 32); ``-m slow`` spawns it as it is."""
    ran = []

    def call(cmd, timeout=None, env=None):
        assert cmd[:3] == [sys.executable, "-m", "msig_tpu_torch.tools.eval_quality"]
        assert env["PYTHONPATH"].split(os.pathsep)[0] == ROOT  # the package's directory
        ran.append(cmd)
        _tool("eval_quality").main(cmd[3:] + ["--batch_size", "2"])
        return 0

    _quality_trajectory(inputs, port_runs, tmp_path / "traj", call, monkeypatch)
    assert len(ran) == 1 and ran[0][ran[0].index("--checkpoint") + 1].endswith("epoch_2")
    assert ran[0][-8:] == ["--n_images", str(tg.N_SRC), "--domains", "0", "--samples", "0",
                           "--device", "cpu"]


@pytest.mark.slow
def test_quality_trajectory_spawns_eval_quality(inputs, port_runs, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    _quality_trajectory(inputs, port_runs, tmp_path / "traj")


def test_quality_trajectory_retries_a_failed_run_once(inputs, tmp_path, monkeypatch):
    mod = _tool("eval_quality_trajectory")
    calls = []
    monkeypatch.setattr(mod.subprocess, "call", lambda cmd, **kw: calls.append(cmd) or 1)
    with pytest.raises(SystemExit, match="no successful evaluations"):
        mod.main(["--ckpt_root", str(inputs / "snaps"), "--extra_root", str(tmp_path / "x"),
                  "--out", str(tmp_path / "out"), "--device", "cpu"])
    assert len(calls) == 4  # two checkpoints, each tried twice
    assert calls[0][1:3] == ["-m", "msig_tpu_torch.tools.eval_quality"]
    assert calls[0][-2:] == ["--device", "cpu"]


@pytest.mark.slow
def test_golden_is_the_root_tools_output(tmp_path, golden):
    """Live: the root tools on the same inputs give the golden."""
    tg.make_inputs(str(tmp_path))
    live = tg.jax_outputs(str(tmp_path))
    assert sorted(live) == sorted(golden)
    for k, v in live.items():
        if isinstance(v, str):
            assert v == golden[k], k
        else:
            np.testing.assert_array_equal(v, golden[k], err_msg=k)


# ------------------------------------------------------------------ routes

@pytest.mark.parametrize("x_shape", [(4, 64, 64, 256), (8, 64, 64, 256), (4, 128, 128, 256),
                                     (8, 128, 128, 256), (2, 144, 144, 256), (1, 152, 152, 256),
                                     (1, 128, 128, 384), (1, 96, 96, 128), (4, 100, 100, 256),
                                     (1, 128, 120, 256)])
def test_supported_equals_jax(x_shape):
    """The route of a trunk conv in both packages: the 256² and 512² inputs'
    trunks, the largest square map under the 24 MB slab (144) and the next (152)."""
    from msig_tpu.ops import conv3x3_vjp as jcv

    from msig_tpu_torch.ops import conv3x3_vjp as cv

    c = x_shape[-1]
    args = (x_shape, (3, 3, c, c), 1, ((1, 1), (1, 1)), "zeros")
    assert cv.supported(*args) == jcv.supported(*args)
    if x_shape[1:3] in ((64, 64), (128, 128)) and c == 256:
        assert cv.supported(*args)
    if x_shape[1] == 152:
        assert not cv.supported(*args)
