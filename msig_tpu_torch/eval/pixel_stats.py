"""Weights-free quality metrics: pixel/color statistics, no extractor.

Copy of ``msig_tpu/eval/pixel_stats.py`` (numpy only) on the port's own data
loaders; it gives the JAX package's numbers exactly.

The canonical FID needs pretrained InceptionV3 weights that cannot enter
the repository, and the bundled fallback (msig_tpu_torch/eval/fid.py)
scores with a seeded random VGG — self-consistent but untrusted features.
These two metrics need NO learned features at all, so they provide an
independent check on the proxy-FID trend:

  * ``color_frechet``: Fréchet distance between per-image color/texture
    descriptor distributions. Descriptor (12-dim): RGB means (3), RGB
    covariance upper-triangle (6), and luma gradient energy stats (3).
    Captures the global palette + local contrast shifts that distinguish
    the diseased-leaf domains (spots, mosaics, blights) from healthy.
  * ``hist_tv``: total-variation distance between the pooled 8x8x8 RGB
    histograms of two image sets (0 = identical palette distribution,
    1 = disjoint).

Both follow the same contract as fid_between_dirs: lower = closer to the
reference domain. A working translation should move BOTH metrics of the
generated set below the untranslated-source baseline.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np


def _to_uint8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    # [-1,1] float convention of the data pipeline
    return np.clip(np.round((img.astype(np.float32) + 1.0) * 127.5), 0, 255).astype(np.uint8)


def color_texture_descriptor(img: np.ndarray) -> np.ndarray:
    """One image (uint8 or [-1,1] float, HWC) -> 12-dim descriptor."""
    x = _to_uint8(img).astype(np.float32) / 255.0
    flat = x.reshape(-1, 3)
    mu = flat.mean(axis=0)
    cov = np.cov(flat, rowvar=False)
    iu = np.triu_indices(3)
    luma = x @ np.array([0.299, 0.587, 0.114], np.float32)
    gx = np.abs(np.diff(luma, axis=1))
    gy = np.abs(np.diff(luma, axis=0))
    gmag = np.concatenate([gx.ravel(), gy.ravel()])
    tex = np.array([gx.mean(), gy.mean(), gmag.std()], np.float32)
    return np.concatenate([mu, cov[iu], tex]).astype(np.float64)


def color_frechet(images_a: Iterable[np.ndarray],
                  images_b: Iterable[np.ndarray]) -> float:
    """Fréchet distance between descriptor distributions of two sets."""
    from msig_tpu_torch.eval.fid import activation_statistics, frechet_distance

    da = np.stack([color_texture_descriptor(i) for i in images_a])
    db = np.stack([color_texture_descriptor(i) for i in images_b])
    if len(da) < 2 or len(db) < 2:
        raise ValueError("need at least 2 images per side")
    mu1, s1 = activation_statistics(da)
    mu2, s2 = activation_statistics(db)
    return frechet_distance(mu1, s1, mu2, s2)


def _pooled_hist(images: Iterable[np.ndarray], bins: int = 8) -> np.ndarray:
    h = np.zeros((bins,) * 3, np.float64)
    n = 0
    for img in images:
        q = (_to_uint8(img).astype(np.int32) * bins) >> 8  # 0..bins-1
        flat = q.reshape(-1, 3)
        idx = (flat[:, 0] * bins + flat[:, 1]) * bins + flat[:, 2]
        h += np.bincount(idx, minlength=bins ** 3).reshape(h.shape)
        n += flat.shape[0]
    return h / max(n, 1)


def hist_tv(images_a: Iterable[np.ndarray],
            images_b: Iterable[np.ndarray], bins: int = 8) -> float:
    """Total-variation distance between pooled RGB histograms (0..1)."""
    ha = _pooled_hist(images_a, bins)
    hb = _pooled_hist(images_b, bins)
    return float(0.5 * np.abs(ha - hb).sum())


def _load_dir(d: str, image_size: int) -> list:
    from msig_tpu_torch.data import list_image_files, load_inference_image

    return [load_inference_image(p, image_size) for p in list_image_files(d)]


def pixel_metrics_between_dirs(dir_a: str, dir_b: str,
                               image_size: int = 256) -> Tuple[float, float]:
    """(color_frechet, hist_tv) between two image directories."""
    a = _load_dir(dir_a, image_size)
    b = _load_dir(dir_b, image_size)
    return color_frechet(a, b), hist_tv(a, b)
