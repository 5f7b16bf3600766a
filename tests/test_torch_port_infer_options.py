"""``--save_grid`` and the decode cache of ``python -m msig_tpu_torch.inference``,
on the demo checkpoint at 64² on the CPU.

- ``--save_grid``: ``style_modes_grid.png`` is written in each domain's output
  directory; its tiles (the input, then one a style mode) against the root
  ``inference.py``'s: the input tile equal, the ``average`` and ``specific``
  tiles within the float path's bars (fp32 rtol 1e-3, atol 1e-4), both CLIs
  decoding with one core. The random modes draw from ``torch.Generator`` here
  and ``jax.random`` there, so only their shape is held;
- two target domains with the decode cache (each input decoded once) and
  with ``MSIG_DECODE_CACHE_MB=0`` (decoded once a domain) give byte-equal
  files;
- a ``MSIG_DECODE_CACHE_MB`` that is not a whole number raises.
"""

import os
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

from msig_tpu.data import native_loader as jax_native_loader
from msig_tpu_torch import inference as cli
from msig_tpu_torch.data import native_loader
from msig_tpu_torch.infer import engine as engine_mod

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEMO = str(ROOT / "results" / "tomato_r3b" / "demo_checkpoint")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer_opts")
    rng = np.random.default_rng(0)
    (root / "in").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (72, 80, 3), dtype=np.uint8)).save(
            root / "in" / f"leaf{i}.jpg")
    for d in range(9):  # the demo checkpoint has 10 domains
        (root / "ref" / f"dom{d}").mkdir(parents=True)
        for j in range(2):
            Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
                root / "ref" / f"dom{d}" / f"r{j}.png")
    return root


def _argv(root, out, *extra):
    return ["--input_dir", str(root / "in"), "--ref_domains_dir", str(root / "ref"),
            "--checkpoint_dir", DEMO, "--output_dir", str(out), "--target_domain", "dom2",
            "--image_size", "64", "--compute_dtype", "float32", "--style_mode", "average",
            *extra]


class _Grids:
    """Wraps a package's ``save_sample_grid``: keeps each call's tiles and path."""

    def __init__(self, real):
        self.real, self.calls = real, []

    def __call__(self, tiles, path, **kw):
        self.calls.append((np.asarray(tiles, np.float32), path, kw))
        return self.real(tiles, path, **kw)


def _same_decoder(mp):
    """Both CLIs decode the inputs with one core: the port's native library where
    it builds, else PIL on both sides. The JAX binding's own state is set once a
    process (``msig_tpu/data/native_loader.py:51-60``) and, beside other workers
    racing on its ``make`` into ``native/``, can fall back to PIL where the port
    took its native core; the JPEG inputs then differ by one level on a fifth
    of their pixels."""
    path = native_loader.library_path() if native_loader.available() else None
    mp.setattr(jax_native_loader, "_lib", None)
    mp.setattr(jax_native_loader, "_load_failed", path is None)
    mp.setattr(jax_native_loader, "_find_or_build", lambda: str(path))


@pytest.fixture(scope="module")
def grids(dirs, tmp_path_factory):
    import inference as jax_cli
    import msig_tpu.utils
    import msig_tpu_torch.utils

    out = tmp_path_factory.mktemp("grid_out")
    mp = pytest.MonkeyPatch()
    port, jax_side = (_Grids(msig_tpu_torch.utils.save_sample_grid),
                      _Grids(msig_tpu.utils.save_sample_grid))
    mp.setattr(msig_tpu_torch.utils, "save_sample_grid", port)
    mp.setattr(msig_tpu.utils, "save_sample_grid", jax_side)
    _same_decoder(mp)
    try:
        args = cli.build_arg_parser().parse_args(
            _argv(dirs, out / "port", "--save_grid", "--batch_size", "1", "--device", "cpu"))
        assert cli.main(cli.config_from_args(args)) == 0
        jargs = jax_cli.build_arg_parser().parse_args(
            _argv(dirs, out / "jax", "--save_grid", "--batch_size", "1"))
        assert jax_cli.main(jax_cli.config_from_args(jargs)) == 0
    finally:
        mp.undo()
    return out, port.calls, jax_side.calls


def test_save_grid_writes_the_png(grids):
    out, port, _ = grids
    assert len(port) == 1
    tiles, path, kw = port[0]
    assert path == str(out / "port" / "style_modes_grid.png")
    assert kw == {"nrow": 3, "domain_names": ["input", "average", "random", "interpolate",
                                              "noise", "specific"]}
    with Image.open(path) as im:
        assert im.size == (3 * 64 + 4 * 2, 2 * 64 + 3 * 2)
    assert sorted(os.listdir(out / "port")) == ["leaf0.jpg", "leaf1.jpg", "leaf2.jpg",
                                                 "style_modes_grid.png"]


def test_save_grid_tiles_match_jax(grids):
    _, port, jax_side = grids
    (got, _, kw), (want, _, jkw) = port[0], jax_side[0]
    assert kw == jkw and got.shape == want.shape == (6, 64, 64, 3)
    np.testing.assert_array_equal(got[0], want[0])  # the input
    for i in (1, 5):  # average, specific
        np.testing.assert_allclose(got[i], want[i], rtol=1e-3, atol=1e-4,
                                   err_msg=kw["domain_names"][i])
    assert np.isfinite(got).all() and np.abs(got).max() <= 1.0


def test_save_grid_over_two_domains(dirs, tmp_path):
    args = cli.build_arg_parser().parse_args(
        _argv(dirs, tmp_path, "--save_grid", "--batch_size", "2", "--device", "cpu",
              "--quantize", "int8"))
    args.target_domain = "dom0,dom5"
    assert cli.main(cli.config_from_args(args)) == 0
    for d in ("dom0", "dom5"):
        assert (tmp_path / d / "style_modes_grid.png").exists()
        assert len(list((tmp_path / d).glob("leaf*.jpg"))) == 3


def _serve_two_domains(dirs, out, monkeypatch, cache_mb=None):
    decoded = []
    real = engine_mod.load_inference_image

    def counting(path, size, *a, **k):
        decoded.append(os.path.basename(path))
        return real(path, size, *a, **k)

    monkeypatch.setattr(engine_mod, "load_inference_image", counting)
    if cache_mb is None:
        monkeypatch.delenv("MSIG_DECODE_CACHE_MB", raising=False)
    else:
        monkeypatch.setenv("MSIG_DECODE_CACHE_MB", cache_mb)
    args = cli.build_arg_parser().parse_args(
        _argv(dirs, out, "--batch_size", "2", "--device", "cpu", "--quantize", "int8",
              "--style_mode", "specific"))
    args.target_domain = "dom0,dom5"
    rc = cli.main(cli.config_from_args(args))
    monkeypatch.undo()
    return rc, [n for n in decoded if n.startswith("leaf")]


def test_decode_cache_gives_the_same_bytes(dirs, tmp_path, monkeypatch):
    rc, with_cache = _serve_two_domains(dirs, tmp_path / "cached", monkeypatch)
    assert rc == 0 and sorted(with_cache) == ["leaf0.jpg", "leaf1.jpg", "leaf2.jpg"]
    rc, without = _serve_two_domains(dirs, tmp_path / "plain", monkeypatch, cache_mb="0")
    assert rc == 0 and len(without) == 6  # every input decoded once a domain
    for d in ("dom0", "dom5"):
        names = sorted(os.listdir(tmp_path / "cached" / d))
        assert names == sorted(os.listdir(tmp_path / "plain" / d)) and len(names) == 3
        for n in names:
            assert (tmp_path / "cached" / d / n).read_bytes() == \
                (tmp_path / "plain" / d / n).read_bytes(), f"{d}/{n}"


@pytest.mark.parametrize("value", ["lots", "-1", "1.5", ""])
def test_junk_decode_cache_setting_raises(dirs, tmp_path, monkeypatch, value):
    monkeypatch.setenv("MSIG_DECODE_CACHE_MB", value)
    args = cli.build_arg_parser().parse_args(
        _argv(dirs, tmp_path, "--batch_size", "2", "--device", "cpu"))
    args.target_domain = "dom0,dom5"
    with pytest.raises(ValueError, match="MSIG_DECODE_CACHE_MB"):
        cli.main(cli.config_from_args(args))
