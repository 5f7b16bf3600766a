"""Device-resident dataset: decode once, keep it on the device, augment there.

Counterpart of ``msig_tpu/data/device_data.py`` (``--device_data``): the
decoded dataset is uploaded once, and per step the host sends only indices,
crop rectangles and rotation choices, a few hundred bytes, instead of a batch
of images.

Augmentation has the host pipeline's distribution (``data/pipeline.py``): the
torchvision RandomResizedCrop parameters are drawn on the host by
:func:`random_resized_crop_params`, then a uniform k*90 rotation, with the same
numpy RNG calls in the same order as the JAX module, so a seed and an epoch
give the same draws in both packages. The crop-resize runs on the device as
separable bilinear sampling at PIL's half-pixel centres. Crops are never larger
than the base image, so the resize is always an upscale, where PIL BILINEAR is
plain bilinear: device and PIL outputs agree to rounding.

Deviation (the JAX module's, kept): images whose size is not
(image_size, image_size) are first resized to that base size when the bank is
built, so crops are taken from the resized base rather than the original.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from msig_tpu_torch import resolve_device
from msig_tpu_torch.data.dataset import MultiDomainDataset
from msig_tpu_torch.data.pipeline import load_inference_image, random_resized_crop_params


def _bilinear_rows(img: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                   size: int) -> torch.Tensor:
    """Sample ``size`` rows (axis 1) of float [B, S, W, 3] at the half-pixel
    centres of each sample's crop [start, start + len) -> [B, size, W, 3]."""
    pos = torch.arange(size, dtype=torch.float32, device=img.device)[None, :]
    coords = starts[:, None] + (pos + 0.5) * lens[:, None] / size - 0.5  # [B, size]
    c0 = torch.clamp(torch.floor(coords), 0, size - 1)
    frac = torch.clamp(coords - c0, 0.0, 1.0)
    i0 = c0.to(torch.long)
    i1 = torch.clamp(i0 + 1, max=size - 1)
    rows = torch.arange(img.shape[0], device=img.device)[:, None]
    w = frac[:, :, None, None]
    return img[rows, i0] * (1.0 - w) + img[rows, i1] * w


def make_augment_fn(size: int):
    """fn(bank_u8 [N, S, S, 3], idx [B], crops [B, 4] float32 (top, left, h, w),
    rotk [B]) -> uint8 [B, S, S, 3]: gather, RandomResizedCrop's bilinear
    resize, then a k*90 rotation (``np.rot90``'s direction), all on the bank's
    device."""

    def augment(bank: torch.Tensor, idx: torch.Tensor, crops: torch.Tensor,
                rotk: torch.Tensor) -> torch.Tensor:
        img = bank[idx].to(torch.float32)
        img = _bilinear_rows(img, crops[:, 0], crops[:, 2], size)
        img = _bilinear_rows(img.transpose(1, 2), crops[:, 1], crops[:, 3], size).transpose(1, 2)
        img = torch.clamp(torch.round(img), 0, 255).to(torch.uint8)
        turns = torch.stack([torch.rot90(img, k, dims=(1, 2)) for k in range(4)])
        return turns[rotk.to(torch.long), torch.arange(img.shape[0], device=img.device)]

    return augment


class DeviceData:
    """The decoded dataset on ``device`` and its per-step augmentation there.

    ``second_target`` also draws a second image of each sample's target domain
    (the ``target2`` key, for the diversity loss)."""

    def __init__(self, dataset: MultiDomainDataset, image_size: int,
                 second_target: bool = False, device: str = "cuda"):
        self.device = dev = resolve_device(device)
        self.size = image_size
        self.dataset = dataset
        self.second_target = second_target
        src = np.stack([load_inference_image(p, image_size) for p in dataset.source_files])
        trg_imgs = []
        self.domain_slices: Dict[int, Tuple[int, int]] = {}
        names = sorted(dataset.target_files_by_domain)
        for name in names:
            files = dataset.target_files_by_domain[name]
            start = len(trg_imgs)
            trg_imgs.extend(load_inference_image(p, image_size) for p in files)
            self.domain_slices[dataset.domain_to_idx[name]] = (start, len(files))
        self.bank_src = torch.from_numpy(src).to(dev)
        self.bank_trg = torch.from_numpy(np.stack(trg_imgs)).to(dev)
        self._augment = make_augment_fn(image_size)
        self.domains = [dataset.domain_to_idx[n] for n in names]

    def __len__(self) -> int:
        return len(self.dataset)

    def _crops_rots(self, rng: np.random.Generator, n: int):
        crops = np.empty((n, 4), np.float32)
        rots = np.empty((n,), np.int32)
        for j in range(n):
            crops[j] = random_resized_crop_params(rng, self.size, self.size)
            rots[j] = rng.integers(4)
        return crops, rots

    def _images(self, bank: torch.Tensor, idx: np.ndarray, rng: np.random.Generator):
        crops, rots = self._crops_rots(rng, len(idx))
        dev = self.device
        return self._augment(bank, torch.from_numpy(np.asarray(idx, np.int64)).to(dev),
                             torch.from_numpy(crops).to(dev), torch.from_numpy(rots).to(dev))

    def _target_indices(self, dom: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        out = np.empty((len(dom),), np.int64)
        for j, d in enumerate(dom):
            start, count = self.domain_slices[int(d)]
            out[j] = start + int(rng.integers(count))
        return out

    def batch(self, indices: np.ndarray, rng: np.random.Generator) -> Dict[str, torch.Tensor]:
        """A batch on the device for the train step: the source image by its
        (shuffled) index, the target domain uniform over the domains, the
        target image uniform within it, drawn as ``TrainLoader`` draws them
        (reference dataset.py:66-88)."""
        n = len(indices)
        src_idx = np.asarray(indices) % len(self.dataset.source_files)
        dom = np.asarray([self.domains[int(rng.integers(len(self.domains)))] for _ in range(n)],
                         np.int32)
        trg_idx = self._target_indices(dom, rng)
        batch = {"source": self._images(self.bank_src, src_idx, rng)}
        batch["target"] = self._images(self.bank_trg, trg_idx, rng)
        batch["source_domain"] = torch.zeros((n,), dtype=torch.int32, device=self.device)
        batch["target_domain"] = torch.from_numpy(dom).to(self.device)
        if self.second_target:
            batch["target2"] = self._images(self.bank_trg, self._target_indices(dom, rng), rng)
        return batch

    def epoch(self, epoch_idx: int, batch_size: int, seed: int = 0):
        """Yield the batches of one epoch (shuffled, drop_last)."""
        rng = np.random.default_rng((seed, epoch_idx))
        indices = rng.permutation(len(self.dataset))
        for s in range(len(self.dataset) // batch_size):
            yield self.batch(indices[s * batch_size:(s + 1) * batch_size], rng)
