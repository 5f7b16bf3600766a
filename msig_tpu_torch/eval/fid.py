"""FID evaluation: Fréchet distance between feature distributions.

Counterpart of ``msig_tpu/eval/fid.py``. The canonical FID uses pool3
features of an ImageNet InceptionV3; those pretrained weights are not in the
repository, so the metric takes a pluggable feature extractor:

  - ``inception``: InceptionV3 pool3 features loaded from an .npz produced
    by ``tools/convert_inception_weights.py`` (``eval/inception.py``);
  - ``vgg``: the VGG19-prefix extractor of the perceptual loss
    (``losses/vgg.py``), canonical only when its pretrained .npz is given.
    Without one it is a *proxy* FID on the port's seeded random VGG
    (``torch.Generator(1234)``): self-consistent across runs of the port, but
    its numbers are not the JAX package's proxy (whose random VGG is drawn
    with ``jax.random``).

The Fréchet distance and the statistics are numpy/scipy copies of the JAX
package's: ``d^2 = |mu1 - mu2|^2 + tr(C1 + C2 - 2 sqrt(C1 C2))``. Feature
extraction runs on the extractor's device (``cuda`` unless asked for ``cpu``).
"""

from __future__ import annotations

import logging
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from msig_tpu_torch.losses.vgg import VGGPrefix, vgg_features
from msig_tpu_torch.train.step import prepare_images

logger = logging.getLogger(__name__)


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray
) -> float:
    """Fréchet distance between two Gaussians (numerically-stabilized)."""
    import scipy.linalg

    def _sqrtm(a):
        out = scipy.linalg.sqrtm(a)
        return out[0] if isinstance(out, tuple) else out  # scipy <1.17 returned (X, errest)

    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        eps = 1e-6
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def activation_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of an [N, D] feature matrix."""
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def vgg_feature_fn(vgg: VGGPrefix) -> Callable[[np.ndarray], np.ndarray]:
    """Batch uint8 [N,H,W,3] -> pooled VGG-prefix features [N, 256] (float32),
    computed on the VGG's device."""
    device = next(vgg.parameters()).device

    @torch.inference_mode()
    def extract(imgs: np.ndarray) -> np.ndarray:
        x = prepare_images(torch.from_numpy(np.ascontiguousarray(imgs)).to(device))
        feats = vgg_features(vgg, x, upto=5)
        return feats[-1].mean(dim=(1, 2)).cpu().numpy()  # global-average relu3_1 -> [N, 256]

    return extract


def compute_fid(
    batches_a: Iterator[np.ndarray],
    batches_b: Iterator[np.ndarray],
    feature_fn: Callable[[np.ndarray], np.ndarray],
) -> float:
    """FID between two image streams (uint8 NHWC batches)."""
    feats_a = np.concatenate([feature_fn(b) for b in batches_a], axis=0)
    feats_b = np.concatenate([feature_fn(b) for b in batches_b], axis=0)
    if len(feats_a) < 2 or len(feats_b) < 2:
        raise ValueError("need at least 2 images per side for covariance")
    mu1, s1 = activation_statistics(feats_a)
    mu2, s2 = activation_statistics(feats_b)
    return frechet_distance(mu1, s1, mu2, s2)


def fid_between_dirs(
    dir_a: str,
    dir_b: str,
    image_size: int = 256,
    batch_size: int = 32,
    vgg_weights_path: Optional[str] = None,
    inception_weights_path: Optional[str] = None,
    device: str = "cuda",
) -> float:
    """Directory-level FID, the extractor on ``device``.

    Extractor priority: ``inception_weights_path`` (canonical InceptionV3
    pool3, ``eval/inception.py``) > ``vgg_weights_path`` (VGG-prefix)
    > random-VGG proxy (loudly labeled).
    """
    from msig_tpu_torch.data import list_image_files, load_inference_image
    from msig_tpu_torch.losses import get_vgg

    def batches(d):
        files = list_image_files(d)
        for i in range(0, len(files), batch_size):
            yield np.stack(
                [load_inference_image(p, image_size) for p in files[i : i + batch_size]]
            )

    if inception_weights_path:
        from msig_tpu_torch.eval.inception import inception_feature_fn

        fn = inception_feature_fn(inception_weights_path, device)
    else:
        fn = vgg_feature_fn(get_vgg(vgg_weights_path, device=device))
        if not vgg_weights_path:
            logger.warning(
                "FID computed with the randomly-initialized VGG fallback — a PROXY "
                "metric (self-consistent, not comparable to published FID numbers)."
            )
    return compute_fid(batches(dir_a), batches(dir_b), fn)
