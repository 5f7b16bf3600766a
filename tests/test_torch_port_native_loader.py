"""The port's native loader binding against the JAX package's, and against PIL.

``msig_tpu_torch/data/native_loader.py`` builds ``native/msig_loader.cpp``
into ``build/msig_loader/``. The JAX binding is pointed at that library
(its ``_find_or_build`` patched), so that this file never runs the JAX
package's ``make`` into ``native/`` beside ``tests/test_native_loader.py``'s.
Outputs must be equal to the bit, and whole ``TrainLoader`` epochs equal to
JAX's for a seed on both backends. The PIL bars are those of
``tests/test_native_loader.py``: mean |difference| under 2 (PNG) or 3 (JPEG)
uint8 steps.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
from PIL import Image

from msig_tpu.data import dataset as jds
from msig_tpu.data import native_loader as jnl
from msig_tpu.data import pipeline as jpipe

from msig_tpu_torch.data import dataset as ds
from msig_tpu_torch.data import native_loader as nl
from msig_tpu_torch.data import pipeline as pipe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    smooth = rng.integers(0, 255, (5, 6, 3), dtype=np.uint8)
    arr = np.asarray(Image.fromarray(smooth).resize((96, 80), Image.BILINEAR), dtype=np.uint8)
    jpg, png = root / "a.jpg", root / "b.png"
    Image.fromarray(arr).save(jpg, quality=95)
    Image.fromarray(arr).save(png)
    return str(jpg), str(png), arr


@pytest.fixture(scope="module")
def built():
    assert nl.available(), "the native loader builds here (g++, libjpeg and libpng are present)"
    return nl.library_path()


@pytest.fixture
def jax_native(built, monkeypatch):
    """The JAX binding, loading the library the port built."""
    monkeypatch.setattr(jnl, "_lib", None)
    monkeypatch.setattr(jnl, "_load_failed", False)
    monkeypatch.setattr(jnl, "_find_or_build", lambda: str(built))
    assert jnl.available()
    return jnl


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_tree")
    rng = np.random.default_rng(1)
    sizes = [(40, 56), (64, 48), (50, 50), (33, 90), (72, 40)]
    for d, n in (("src/Tomato_healthy", 5), ("ref/b_spot", 3), ("ref/a_mold", 4)):
        os.makedirs(root / d, exist_ok=True)
        for i in range(n):
            h, w = sizes[(i + len(d)) % len(sizes)]
            smooth = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3), dtype=np.uint8)
            img = Image.fromarray(smooth).resize((w, h), Image.BILINEAR)
            img.save(root / d / f"img{i}.{('jpg', 'png')[i % 2]}", quality=90)
    return str(root / "src" / "Tomato_healthy"), str(root / "ref")


def test_builds_only_under_build(built):
    assert built.parent == nl.BUILD_DIR == __import__("pathlib").Path(ROOT) / "build" / "msig_loader"
    assert built.name.startswith("libmsig_loader-") and built.exists()


@pytest.mark.parametrize("which", [0, 1])
def test_image_size_equals_jax(images, jax_native, which):
    assert nl.image_size(images[which]) == jax_native.image_size(images[which]) == (96, 80)


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("size,crop,rot", [(64, None, 0), (32, (10, 20, 40, 50), 1),
                                           (48, (0, 0, 80, 80), 2), (40, (3, 5, 17, 21), 3)])
def test_decode_resize_equals_jax_to_the_bit(images, jax_native, which, size, crop, rot):
    got = nl.decode_resize(images[which], size, crop, rot)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, jax_native.decode_resize(images[which], size, crop, rot))


def test_load_batch_equals_jax(images, jax_native):
    jpg, png, _ = images
    crops, rots = [(0, 0, 80, 96), (10, 20, 40, 50), (5, 5, 60, 60)], [0, 1, 3]
    got = nl.load_batch([jpg, png, jpg], 32, crops, rots, n_threads=2)
    np.testing.assert_array_equal(got, jax_native.load_batch([jpg, png, jpg], 32, crops, rots,
                                                             n_threads=2))


@pytest.mark.parametrize("backend", ["pil", "native"])
@pytest.mark.parametrize("epoch", [0, 2])
def test_train_loader_equals_jax_on_each_backend(tree, jax_native, monkeypatch, backend, epoch):
    if backend == "pil":
        monkeypatch.setattr(jnl, "available", lambda: False)
    mine = pipe.TrainLoader(ds.MultiDomainDataset.build(*tree), 2, 32, seed=3, backend=backend)
    theirs = jpipe.TrainLoader(jds.MultiDomainDataset.build(*tree), 2, 32, seed=3)
    got, want = list(mine.epoch(epoch)), list(theirs.epoch(epoch))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_inference_image_equals_jax(images, jax_native):
    np.testing.assert_array_equal(pipe.load_inference_image(images[0], 40, backend="native"),
                                  jpipe.load_inference_image(images[0], 40, backend="auto"))


def _pil(path, size, box=None):
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB").resize((size, size), Image.BILINEAR, box=box),
                          dtype=np.uint8)


def _mean_diff(a, b) -> float:
    return float(np.abs(a.astype(int) - b.astype(int)).mean())


@pytest.mark.parametrize("case", ["png_whole", "jpeg_whole", "png_box"])
def test_decode_close_to_pil(images, built, case):
    jpg, png, _ = images
    if case == "png_whole":
        assert _mean_diff(nl.decode_resize(png, 80, (0, 0, 80, 80)), _pil(png, 80, (0, 0, 80, 80))) < 2.0
    elif case == "jpeg_whole":
        assert _mean_diff(nl.decode_resize(jpg, 64), _pil(jpg, 64)) < 3.0
    else:  # crop (top 10, left 20, h 40, w 50)
        assert _mean_diff(nl.decode_resize(png, 32, (10, 20, 40, 50)),
                          _pil(png, 32, (20, 10, 70, 50))) < 2.0


def test_rotation_matches_rot90(images, built):
    base = nl.decode_resize(images[1], 48)
    for k in range(4):
        np.testing.assert_array_equal(nl.decode_resize(images[1], 48, rot_k=k), np.rot90(base, k))


def test_load_batch_and_its_failure(images, built, tmp_path):
    jpg, png, _ = images
    out = nl.load_batch([jpg, png, jpg], 32, n_threads=2)
    assert out.shape == (3, 32, 32, 3)
    np.testing.assert_array_equal(out[1], nl.decode_resize(png, 32))
    with pytest.raises(IOError):
        nl.load_batch([jpg, str(tmp_path / "missing.jpg")], 16)


@pytest.mark.parametrize("which", ["train", "inference"])
def test_backends_agree_within_pil_bars(images, built, which):
    jpg = images[0]
    if which == "train":
        a = pipe.load_train_image(jpg, 32, np.random.default_rng(7), backend="native")
        b = pipe.load_train_image(jpg, 32, np.random.default_rng(7), backend="pil")
    else:
        a = pipe.load_inference_image(jpg, 40, backend="native")
        b = pipe.load_inference_image(jpg, 40, backend="pil")
    assert _mean_diff(a, b) < 3.0


def test_unknown_backend_raises(images):
    with pytest.raises(ValueError, match="backend"):
        pipe.load_inference_image(images[0], 32, backend="turbo")


def test_without_a_toolchain_auto_falls_back_to_pil(images, monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(nl, "_load_failed", False)
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nl.shutil, "which", lambda name: None)
    with caplog.at_level(logging.WARNING, logger=nl.__name__):
        assert not nl.available() and not nl.available()
    assert sum("native loader unavailable" in r.getMessage() for r in caplog.records) == 1
    np.testing.assert_array_equal(pipe.load_inference_image(images[0], 40),
                                  pipe.load_inference_image(images[0], 40, backend="pil"))
    with pytest.raises(RuntimeError, match="unavailable"):
        pipe.load_inference_image(images[0], 40, backend="native")


_BUILD = ("import sys; from msig_tpu_torch.data import native_loader as n; "
          "p, b = n.build_library(sys.argv[1]); print(int(b), p)")


def test_concurrent_first_use_builds_once(tmp_path):
    """Four processes and four threads call ``build_library`` on an empty directory
    at once: one of them compiles, the others wait on the lock and load its file."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path / "p")], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    built = [o.split() for o, _ in outs]
    assert sorted(int(b) for b, _ in built) == [0, 0, 0, 1]
    assert len({p for _, p in built}) == 1
    assert sorted(os.listdir(tmp_path / "p")) == sorted([os.path.basename(built[0][1]),
                                                         os.path.basename(built[0][1])[:-3] + ".lock"])

    results = []
    threads = [threading.Thread(target=lambda: results.append(nl.build_library(tmp_path / "t")))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert sorted(b for _, b in results) == [False, False, False, True]


def test_a_library_that_does_not_load_here_is_rebuilt(images, monkeypatch, tmp_path):
    """A file at the library's path built elsewhere (here: not a library at all)
    is rebuilt once, and the binding loads the new one."""
    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(nl, "_load_failed", False)
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "build")
    stale = nl.library_path(tmp_path / "build")
    stale.parent.mkdir(parents=True)
    stale.write_bytes(b"built on another machine")
    assert nl.available()
    assert stale.read_bytes()[:4] == b"\x7fELF"
    assert nl.image_size(images[1]) == (96, 80)
