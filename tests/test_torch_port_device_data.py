"""The port's device-resident dataset against the JAX package's, on the CPU.

``make_augment_fn`` on the cases of ``tests/test_device_data.py`` and on
seeded RandomResizedCrop draws: at most 1 uint8 step from JAX's (both sample
bilinearly at PIL's half-pixel centres in float32; XLA may contract a product
and a sum into one rounding where PyTorch rounds twice), and PIL's bars of
that file. ``DeviceData.epoch``: the same draws as JAX's for a seed and an
epoch, so the same domains and, image by image, the same crops (within 1
step). The JAX binding of the native loader is pointed at the library the
port builds, so that this file runs no ``make`` into ``native/``.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from msig_tpu.data import MultiDomainDataset as JDataset
from msig_tpu.data import native_loader as jnl
from msig_tpu.data.device_data import DeviceData as JDeviceData
from msig_tpu.data.device_data import make_augment_fn as j_augment_fn

from msig_tpu_torch.data import DeviceData, MultiDomainDataset, make_augment_fn
from msig_tpu_torch.data import native_loader as nl
from msig_tpu_torch.data.pipeline import random_resized_crop_params


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file: beside the suite's other workers, a
    bf16 or fp32 step on all cores oversubscribes the CPU and runs many times
    slower."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_native(monkeypatch):
    path = nl.library_path() if nl.available() else None
    monkeypatch.setattr(jnl, "_lib", None)
    monkeypatch.setattr(jnl, "_load_failed", path is None)
    monkeypatch.setattr(jnl, "_find_or_build", lambda: str(path))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddata")
    src, ref = root / "src", root / "ref"
    rng = np.random.default_rng(0)
    src.mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(src / f"s{i}.png")
    for d in ("DomA", "DomB"):
        (ref / d).mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                ref / d / f"r{i}.png")
    return str(src), str(ref)


def _both(bank: np.ndarray, idx, crops, rots):
    size = bank.shape[1]
    got = make_augment_fn(size)(torch.from_numpy(bank), torch.as_tensor(idx),
                                torch.as_tensor(np.asarray(crops, np.float32)), torch.as_tensor(rots))
    want = j_augment_fn(size)(jnp.asarray(bank), jnp.asarray(idx),
                              jnp.asarray(np.asarray(crops, np.float32)), jnp.asarray(rots))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("crop,k", [((0, 0, 32, 32), 0), ((3, 5, 17, 21), 1),
                                    ((10, 2, 9, 14), 3)])
def test_augment_matches_jax_and_pil(crop, k):
    rng = np.random.default_rng(7)
    size = 32
    base = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
    got, want = _both(base[None], [0], [crop], [k])
    assert got.dtype == np.uint8 and got.shape == (1, size, size, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    top, left, h, w = crop
    ref = np.asarray(Image.fromarray(base).resize((size, size), Image.BILINEAR,
                                                  box=(left, top, left + w, top + h)), np.uint8)
    diff = np.abs(got[0].astype(np.int32) - np.rot90(ref, k).astype(np.int32))
    assert np.median(diff) <= 1
    assert (diff > 2).mean() < 0.02, (diff.max(), (diff > 2).mean())


def test_augment_matches_jax_on_seeded_draws():
    rng = np.random.default_rng(11)
    size, n = 64, 16
    bank = rng.integers(0, 256, (4, size, size, 3), dtype=np.uint8)
    crops = [random_resized_crop_params(rng, size, size) for _ in range(n)]
    idx, rots = rng.integers(0, 4, n), rng.integers(0, 4, n)
    got, want = _both(bank, idx, crops, rots)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1, d.max()


@pytest.mark.parametrize("second_target", [False, True])
@pytest.mark.parametrize("epoch", [0, 1])
def test_epoch_draws_equal_jax(tree, jax_native, epoch, second_target):
    mine = DeviceData(MultiDomainDataset.build(*tree), 32, second_target=second_target,
                      device="cpu")
    theirs = JDeviceData(JDataset.build(*tree), 32, second_target=second_target)
    np.testing.assert_array_equal(mine.bank_src.numpy(), np.asarray(theirs.bank_src))
    np.testing.assert_array_equal(mine.bank_trg.numpy(), np.asarray(theirs.bank_trg))
    got = list(mine.epoch(epoch, batch_size=2, seed=5))
    want = list(theirs.epoch(epoch, batch_size=2, seed=5))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("source_domain", "target_domain"):
            assert g[k].dtype == torch.int32
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
        for k in {"source", "target", "target2"} & set(g):
            assert g[k].dtype == torch.uint8 and tuple(g[k].shape) == (2, 32, 32, 3)
            assert np.abs(g[k].numpy().astype(int) - np.asarray(w[k]).astype(int)).max() <= 1, k


def test_epochs_are_seeded(tree, jax_native):
    dd = DeviceData(MultiDomainDataset.build(*tree), 32, device="cpu")
    a, b, c = (list(dd.epoch(e, batch_size=2))[0]["source"] for e in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_base_size_deviation(tmp_path, jax_native):
    """Images off ``image_size`` are resized to the base size when the bank is built."""
    src, ref = tmp_path / "src", tmp_path / "ref" / "D"
    src.mkdir()
    ref.mkdir(parents=True)
    rng = np.random.default_rng(2)
    for d, shape in ((src, (40, 50, 3)), (ref, (24, 30, 3))):
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(d / "a.png")
    dd = DeviceData(MultiDomainDataset.build(str(src), str(tmp_path / "ref")), 32, device="cpu")
    assert tuple(dd.bank_src.shape) == tuple(dd.bank_trg.shape) == (1, 32, 32, 3)


def test_train_cli_runs_device_data(tree, tmp_path, monkeypatch, jax_native):
    from msig_tpu_torch.train import cli, trainer

    calls = []
    epoch = DeviceData.epoch
    monkeypatch.setattr(DeviceData, "epoch", lambda self, *a, **k: (calls.append(a),
                                                                    epoch(self, *a, **k))[1])
    monkeypatch.setattr(trainer.TrainLoader, "epoch", lambda *a, **k: pytest.fail("host loader"))
    monkeypatch.setenv("MSIG_SKIP_EPOCH_ART", "1")
    args = cli.build_arg_parser().parse_args([
        "--source_dir", tree[0], "--target_dir", tree[1], "--save_dir_base", str(tmp_path),
        "--exp_name", "dd", "--device", "cpu", "--allow_random_vgg", "--image_size", "32",
        "--batch_size", "2", "--epochs", "1", "--device_data"])
    assert cli.main(cli.config_from_args(args)) == 0
    assert calls == [(0, 2)]
    assert os.path.exists(tmp_path / "dd" / "checkpoints" / "epoch_1" / "checkpoint.pth")
