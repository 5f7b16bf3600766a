"""Host-side input pipeline: decode + augment in threads, prefetch.

Copies of ``msig_tpu/data/pipeline.py`` with the PIL backend only (the native
loader is Queue 1 item 9 of ROADMAP.md): the same numpy RNG draws in the same
order, so for a seed and an epoch the batches are bit-identical to those of
the JAX package's ``TrainLoader`` on PIL.

Augmentation (torchvision semantics, reference dataset.py:16-22):
  - RandomResizedCrop: 10 attempts of area in scale=(0.08, 1.0) x log-uniform
    aspect in (3/4, 4/3), else torchvision's centre-crop fallback; bilinear
    resize to (size, size);
  - a random k*90-degree rotation (lossless rot90 on square crops).
Batches are uint8 NHWC; the [-1, 1] normalisation runs in the train step.
"""

from __future__ import annotations

import math
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
from PIL import Image

from msig_tpu_torch.data.dataset import MultiDomainDataset


def random_resized_crop_params(
    rng: np.random.Generator,
    height: int,
    width: int,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Tuple[int, int, int, int]:
    """(top, left, crop_h, crop_w) with torchvision RandomResizedCrop semantics."""
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return top, left, h, w
    # Fallback: centre crop at the nearest valid aspect ratio
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    top = (height - h) // 2
    left = (width - w) // 2
    return top, left, h, w


def load_train_image(path: str, size: int, rng: np.random.Generator) -> np.ndarray:
    """Decode + RandomResizedCrop(size) + k*90 rotation -> uint8 [size, size, 3].

    Draws from ``rng`` in the JAX package's order: crop parameters, then k."""
    with Image.open(path) as img:
        img = img.convert("RGB")
        top, left, h, w = random_resized_crop_params(rng, img.height, img.width)
        k = int(rng.integers(4))
        img = img.resize((size, size), Image.BILINEAR, box=(left, top, left + w, top + h))
        arr = np.asarray(img, dtype=np.uint8)
    if k:
        arr = np.ascontiguousarray(np.rot90(arr, k))
    return arr


def load_inference_image(path: str, size: int) -> np.ndarray:
    """Decode + Resize((size, size)) bilinear -> uint8 [size, size, 3]."""
    with Image.open(path) as img:
        img = img.convert("RGB").resize((size, size), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)


class TrainLoader:
    """Epoch iterator of uint8 batches with prefetch in a background thread.

    Shuffled indices, ``drop_last`` (reference trainer.py:287-290), a uniform
    target domain per sample; ``device_put`` (optional) moves each batch, e.g.
    to the card, in the producer thread."""

    def __init__(self, dataset: MultiDomainDataset, batch_size: int, image_size: int,
                 seed: int = 0, num_threads: int = 4, prefetch: int = 2,
                 device_put: Optional[Callable[[Dict[str, np.ndarray]], Dict]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.image_size = image_size
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.device_put = device_put

    def steps_per_epoch(self) -> int:
        return len(self.dataset) // self.batch_size

    def _make_batch(self, indices, rng: np.random.Generator, pool) -> Dict[str, np.ndarray]:
        picks = [self.dataset.sample_paths(i, rng) for i in indices]
        # independent child RNGs so threads do not share generator state (three
        # per sample, as the JAX loader draws, whose third feeds its second target)
        seeds = rng.integers(0, 2**63 - 1, size=3 * len(picks))

        def load(args):
            j, (src, trg, _) = args
            return (load_train_image(src, self.image_size, np.random.default_rng(seeds[3 * j])),
                    load_train_image(trg, self.image_size, np.random.default_rng(seeds[3 * j + 1])))

        results = list(pool.map(load, enumerate(picks)))
        return {
            "source": np.stack([r[0] for r in results]),
            "target": np.stack([r[1] for r in results]),
            "source_domain": np.zeros(len(picks), np.int32),
            "target_domain": np.asarray([p[2] for p in picks], np.int32),
        }

    def epoch(self, epoch_idx: int) -> Iterator[Dict]:
        """Yield the batches of one epoch, prefetching in a background thread."""
        rng = np.random.default_rng((self.seed, epoch_idx))
        indices = rng.permutation(len(self.dataset))
        steps = self.steps_per_epoch()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            # A bounded put that observes `stop`, so that a consumer leaving
            # mid-epoch does not leave this thread blocked forever.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for s in range(steps):
                        if stop.is_set():
                            return
                        batch = self._make_batch(
                            indices[s * self.batch_size:(s + 1) * self.batch_size], rng, pool)
                        if self.device_put is not None:
                            batch = self.device_put(batch)
                        if not _put(batch):
                            return
                _put(None)
            except BaseException as e:  # propagate instead of hanging the consumer
                _put(e)

        t = threading.Thread(target=producer, daemon=True, name="msig-torch-train-prefetch")
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch  # an unreadable training image fails the run loudly
                yield batch
        finally:
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
