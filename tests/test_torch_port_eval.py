"""The port's eval (``msig_tpu_torch/eval``) against the JAX package's
(``msig_tpu/eval``), on the CPU.

  - pixel statistics, the Fréchet distance and the feature statistics: numpy
    copies, equal to JAX's exactly;
  - the VGG-prefix features and the directory FID on shared weights (JAX's
    ``init_vgg_params()`` written to the ``conv{i}_kernel`` npz that both
    packages read): the fp32 bars, FID within rtol 1e-3;
  - InceptionV3 pool3 on a seeded random state_dict in torchvision's layout
    (per-tensor seeds from ``zlib.crc32`` of the key, stable across
    processes), with the train-time ``AuxLogits`` head and a
    ``num_batches_tracked`` counter in the npz for the loaders to drop: the
    fp32 bars (rtol 1e-3, atol 1e-4) against JAX's forward, end to end from
    uint8 images at 256² (enlarged to 299) and 512² (shrunk to 299).
"""

import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from msig_tpu.eval import fid as jfid
from msig_tpu.eval import inception as jinc
from msig_tpu.eval import pixel_stats as jpix
from msig_tpu.losses import init_vgg_params
from msig_tpu_torch.compat import from_jax as fj
from msig_tpu_torch.eval import fid as tfid
from msig_tpu_torch.eval import inception as tinc
from msig_tpu_torch.eval import pixel_stats as tpix
from msig_tpu_torch.losses import load_vgg_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-3, 1e-4  # fp32 modules (tests/test_torch_import.py:144)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_images(d, seed, n, lo=0, hi=256, shape=(40, 48, 3)):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(lo, hi, shape, dtype=np.uint8)).save(d / f"img{i}.png")
    return str(d)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    return (_write_images(root / "a", 0, 6, 0, 160), _write_images(root / "b", 1, 6, 90, 256))


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    """JAX's seeded random VGG prefix as the ``conv{i}_kernel`` / ``conv{i}_bias`` npz."""
    params = init_vgg_params()
    path = tmp_path_factory.mktemp("vgg") / "vgg.npz"
    np.savez(path, **{f"{name}_{leaf}": np.asarray(v) for name, p in params.items()
                      for leaf, v in p.items()})
    return str(path)


def make_inception_npz(path):
    """A seeded random InceptionV3 in torchvision's state_dict layout, as
    ``tools/convert_inception_weights.py`` writes it (``.`` -> ``__``)."""
    out = {}
    for k, v in tinc.InceptionV3Pool3().state_dict().items():
        rng = np.random.default_rng(zlib.crc32(k.encode()))
        shape = tuple(v.shape)
        if k.endswith("conv.weight"):
            a = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("running_var"):
            a = 1.0 + 0.1 * np.abs(rng.standard_normal(shape))
        elif k.endswith("bn.weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        out[k.replace(".", "__")] = a.astype(np.float32)
    out["AuxLogits__conv0__conv__weight"] = np.zeros((128, 768, 1, 1), np.float32)
    out["Mixed_5b__branch1x1__bn__num_batches_tracked"] = np.zeros((), np.int64)
    np.savez(path, **out)
    return str(path)


@pytest.fixture(scope="module")
def inception_npz(tmp_path_factory):
    return make_inception_npz(tmp_path_factory.mktemp("inception") / "inception_rand.npz")


# ---------------------------------------------------------------- pixel stats

def test_pixel_stats_equal_jax(dirs):
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8) for _ in range(5)]
    other = [np.clip(i.astype(np.int32) + 40, 0, 255).astype(np.uint8) for i in imgs]
    floats = [i.astype(np.float32) / 127.5 - 1.0 for i in imgs]
    for img in imgs[:2] + floats[:2]:
        np.testing.assert_array_equal(tpix.color_texture_descriptor(img),
                                      jpix.color_texture_descriptor(img))
    assert tpix.color_frechet(imgs, other) == jpix.color_frechet(imgs, other)
    assert tpix.hist_tv(imgs, other) == jpix.hist_tv(imgs, other)
    assert tpix.hist_tv(floats, other, bins=4) == jpix.hist_tv(floats, other, bins=4)
    assert (tpix.pixel_metrics_between_dirs(*dirs, image_size=32)
            == jpix.pixel_metrics_between_dirs(*dirs, image_size=32))
    with pytest.raises(ValueError, match="at least 2"):
        tpix.color_frechet(imgs[:1], other)


def test_frechet_and_statistics_equal_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((40, 6))
    b = rng.standard_normal((30, 6)) * 1.5 + 0.3
    for x in (a, b):
        for got, want in zip(tfid.activation_statistics(x), jfid.activation_statistics(x)):
            np.testing.assert_array_equal(got, want)
    ma, sa = tfid.activation_statistics(a)
    mb, sb = tfid.activation_statistics(b)
    assert tfid.frechet_distance(ma, sa, mb, sb) == jfid.frechet_distance(ma, sa, mb, sb)
    # a singular product: the eps-offset retry of both
    s = np.zeros((6, 6))
    assert tfid.frechet_distance(ma, s, mb, s) == jfid.frechet_distance(ma, s, mb, s)
    fn = lambda x: x.reshape(len(x), -1)[:, :5].astype(np.float64)  # noqa: E731
    imgs = rng.integers(0, 256, (9, 4, 4, 3), dtype=np.uint8)
    assert (tfid.compute_fid(iter([imgs[:5], imgs[5:]]), iter([imgs[::-1]]), fn)
            == jfid.compute_fid(iter([imgs[:5], imgs[5:]]), iter([imgs[::-1]]), fn))
    with pytest.raises(ValueError, match="at least 2"):
        tfid.compute_fid(iter([imgs[:1]]), iter([imgs]), fn)


# ------------------------------------------------------------------- VGG FID

def test_vgg_feature_fn_matches_jax(vgg_npz):
    imgs = np.random.default_rng(5).integers(0, 256, (3, 48, 48, 3), dtype=np.uint8)
    got = tfid.vgg_feature_fn(load_vgg_params(vgg_npz, device="cpu"))(imgs)
    want = jfid.vgg_feature_fn(init_vgg_params())(imgs)
    assert got.shape == (3, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fid_between_dirs_matches_jax(dirs, vgg_npz):
    got = tfid.fid_between_dirs(*dirs, image_size=32, batch_size=4, vgg_weights_path=vgg_npz,
                                device="cpu")
    want = jfid.fid_between_dirs(*dirs, image_size=32, batch_size=4, vgg_weights_path=vgg_npz)
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)
    same = tfid.fid_between_dirs(dirs[0], dirs[0], image_size=32, vgg_weights_path=vgg_npz,
                                 device="cpu")
    assert abs(same) < 1e-3


def test_proxy_fid_warns_and_is_self_consistent(dirs, caplog):
    """No weights: the port's own seeded random VGG (not JAX's numbers), labelled a proxy."""
    a = tfid.fid_between_dirs(*dirs, image_size=32, device="cpu")
    assert "PROXY" in caplog.text
    assert a == tfid.fid_between_dirs(*dirs, image_size=32, device="cpu") and a > 0


# ---------------------------------------------------------------- Inception

def test_inception_loaders_agree(inception_npz):
    """The port's loader: every pool3 tensor, no AuxLogits, no counter; equal to
    JAX's loader carried over by ``compat.from_jax.inception_params``."""
    sd = tinc.load_inception_params(inception_npz)
    assert not any(k.startswith("AuxLogits") or k.endswith("num_batches_tracked") for k in sd)
    assert set(sd) == set(tinc.InceptionV3Pool3().state_dict())
    carried = fj.inception_params(jinc.load_inception_params(inception_npz))
    assert set(carried) == set(sd)
    for k in sd:
        torch.testing.assert_close(carried[k], sd[k], rtol=0, atol=0)
    assert sd["Conv2d_1a_3x3.conv.weight"].shape == (32, 3, 3, 3)  # OIHW


def test_inception_pool3_matches_jax(inception_npz):
    """The same tensors in both packages (no npz on the port's side), NHWC [0, 1] at 299²."""
    params = jinc.load_inception_params(inception_npz)
    model = tinc.InceptionV3Pool3()
    model.load_state_dict(fj.inception_params(params), strict=True)
    x01 = np.random.default_rng(6).random((2, 299, 299, 3), dtype=np.float32)
    got = tinc.inception_pool3(model, torch.from_numpy(x01)).numpy()
    want = np.asarray(jinc.inception_pool3(jax.tree.map(jnp.asarray, params), jnp.asarray(x01)))
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("side", [256, 512])
def test_inception_feature_fn_matches_jax(inception_npz, side):
    """uint8 -> /255 -> 299² -> pool3, enlarged from 256² and shrunk from 512²."""
    imgs = np.random.default_rng(side).integers(0, 256, (2, side, side, 3), dtype=np.uint8)
    got = tinc.inception_feature_fn(inception_npz, "cpu")(imgs)
    want = jinc.inception_feature_fn(inception_npz)(imgs)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("side", [256, 512])
def test_resize_matches_jax_with_antialias(side):
    """``F.interpolate(..., antialias=True)`` is ``jax.image.resize``'s bilinear
    both ways (plain bilinear when enlarging, widened triangle when shrinking);
    ``antialias=False`` matches only when enlarging."""
    x = np.random.default_rng(7).random((1, side, side, 3), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3), "bilinear"))
    got = tinc.resize_299(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    plain = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=299,
                                            mode="bilinear", align_corners=False)
    plain_err = np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max()
    assert (plain_err < 1e-5) == (side < 299)


@pytest.mark.slow
def test_fid_between_dirs_with_inception_matches_jax(tmp_path, inception_npz):
    """~30 s: each package's sqrtm of a 2048x2048 product takes ~12 s on the CPU
    (the features and the Fréchet distance are held to JAX's above)."""
    # three images a directory, one batch each: JAX compiles its extractor once
    small = (_write_images(tmp_path / "a", 8, 3, 0, 160), _write_images(tmp_path / "b", 9, 3))
    got = tfid.fid_between_dirs(*small, image_size=32, batch_size=4,
                                inception_weights_path=inception_npz, device="cpu")
    want = jfid.fid_between_dirs(*small, image_size=32, batch_size=4,
                                 inception_weights_path=inception_npz)
    np.testing.assert_allclose(got, want, rtol=1e-3)


# -------------------------------------------------------------- the tool

def test_evaluate_fid_tool_prints_one_json_line(dirs, vgg_npz, capsys):
    from msig_tpu_torch.tools import evaluate_fid

    out = evaluate_fid.main(["--dir_a", dirs[0], "--dir_b", dirs[1], "--image_size", "32",
                             "--vgg_weights", vgg_npz, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert out["metric"] == "fid_vgg_prefix" and set(out) == {"metric", "value", "dir_a", "dir_b"}
    want = jfid.fid_between_dirs(*dirs, image_size=32, vgg_weights_path=vgg_npz)
    assert out["value"] == pytest.approx(round(want, 4), rel=1e-3)


def test_new_modules_import_no_jax():
    """parallel, eval and the FID tool, in a process where jax, flax, optax,
    orbax and msig_tpu cannot be imported."""
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'msig_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import msig_tpu_torch.parallel, msig_tpu_torch.eval, msig_tpu_torch.tools.evaluate_fid\n"
            "import msig_tpu_torch.train.cli, msig_tpu_torch.inference\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
