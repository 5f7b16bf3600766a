"""The port's training data pipeline against the JAX package's, on the CPU.

Dataset discovery, sampling draws, the RandomResizedCrop parameters, the
decoded + augmented images and whole ``TrainLoader`` epochs must be
bit-identical for the same seed. Both sides are forced onto their PIL
backends (``native_loader.available`` patched to False in each); the native
backends are held together in ``tests/test_torch_port_native_loader.py``.
"""

import os

import numpy as np
import pytest
from PIL import Image

from msig_tpu.data import dataset as jds
from msig_tpu.data import native_loader
from msig_tpu.data import pipeline as jpipe

from msig_tpu_torch.data import dataset as ds
from msig_tpu_torch.data import native_loader as port_native_loader
from msig_tpu_torch.data import pipeline as pipe


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    rng = np.random.default_rng(0)
    sizes = [(40, 56), (64, 48), (50, 50), (33, 90), (72, 40)]
    for d, n in (("src/Tomato_healthy", 5), ("ref/b_spot", 3), ("ref/a_mold", 4), ("ref/empty", 0)):
        os.makedirs(root / d, exist_ok=True)
        for i in range(n):
            h, w = sizes[(i + len(d)) % len(sizes)]
            ext = ("jpg", "png", "JPG")[i % 3]
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                root / d / f"img{i}.{ext}")
    return str(root / "src" / "Tomato_healthy"), str(root / "ref")


@pytest.fixture
def pil_only(monkeypatch):
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(port_native_loader, "available", lambda: False)


def test_discovery_matches_jax(tree):
    src, ref = tree
    assert ds.discover_target_domains(ref) == jds.discover_target_domains(ref)
    assert ds.list_image_files(src) == jds.list_image_files(src)
    mine, theirs = ds.MultiDomainDataset.build(src, ref), jds.MultiDomainDataset.build(src, ref)
    assert (mine.domains, mine.domain_to_idx, len(mine)) == \
        (theirs.domains, theirs.domain_to_idx, len(theirs)) == \
        (["source", "a_mold", "b_spot"], {"source": 0, "a_mold": 1, "b_spot": 2}, 5)


def test_no_target_domain_raises(tree, tmp_path):
    with pytest.raises(ValueError, match="No target domains"):
        ds.MultiDomainDataset.build(tree[0], str(tmp_path))


def test_sample_paths_draw_as_jax(tree):
    mine, theirs = ds.MultiDomainDataset.build(*tree), jds.MultiDomainDataset.build(*tree)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(20):
        assert mine.sample_paths(i, r1) == theirs.sample_paths(i, r2)


@pytest.mark.parametrize("h,w", [(256, 256), (40, 300), (300, 40), (33, 90)])
def test_random_resized_crop_params_match_jax(h, w):
    r1, r2 = np.random.default_rng(h * w), np.random.default_rng(h * w)
    for _ in range(50):
        assert pipe.random_resized_crop_params(r1, h, w) == jpipe.random_resized_crop_params(r2, h, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_load_train_image_bit_identical(tree, pil_only, seed):
    path = ds.list_image_files(tree[0])[seed]
    got = pipe.load_train_image(path, 32, np.random.default_rng(seed))
    want = jpipe.load_train_image(path, 32, np.random.default_rng(seed))
    assert got.dtype == np.uint8 and got.shape == (32, 32, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("epoch", [0, 3])
def test_train_loader_batches_bit_identical(tree, pil_only, epoch):
    mine = pipe.TrainLoader(ds.MultiDomainDataset.build(*tree), 2, 32, seed=7)
    theirs = jpipe.TrainLoader(jds.MultiDomainDataset.build(*tree), 2, 32, seed=7)
    assert mine.steps_per_epoch() == theirs.steps_per_epoch() == 2  # drop_last: 5 // 2
    got, want = list(mine.epoch(epoch)), list(theirs.epoch(epoch))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_train_loader_fails_loudly_on_an_unreadable_image(tree, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.jpg").write_bytes(b"not an image")
    loader = pipe.TrainLoader(ds.MultiDomainDataset.build(str(src), tree[1]), 1, 32)
    with pytest.raises(Exception):
        list(loader.epoch(0))
