"""Batched inference engine (reference-guided synthesis), on one device or data parallel.

Counterpart of ``msig_tpu/infer/engine.py``:

  - preloads the style bank with batched style-encoder forwards over all
    reference images of a domain;
  - runs generation in fixed-size batches, padding the last partial batch
    and dropping the padding on the way out;
  - decodes input images in a thread pool on a producer thread, so decode
    overlaps device compute;
  - float path (the CLI default) or the int8 serving path
    (``infer/quantized.py``, whose kernel sites run CUDA kernels on ``cuda``);
  - ``use_pallas`` (``--pallas``), as ``msig_tpu/infer/engine.py:82-88`` reads
    it: the float generator's AdaIN goes to the fused kernel
    (``ops/adain_pallas.py``). The int8 path needs no switch for it: its chain
    is already the kernel chain that JAX's ``force_fused`` (:196-200) selects;
  - ``style_mode='latent'`` (extension): styles from a ``MappingNetwork`` on
    z drawn from the engine's ``torch.Generator`` (``infer/styles.py``);
  - ``iter_input_batches(host_tee=list)`` keeps each decoded host batch, and
    :meth:`InferenceEngine.iter_host_batches` replays them, so that serving
    several target domains decodes the inputs once.
  - ``data_parallel`` (``--data_parallel``): the batch splits over the most
    devices that divide it (``parallel/mesh.py::data_mesh_for_batch``; by
    default every visible card, or the ``devices`` given to ``build``), each
    holding its own copy of the generator, the style encoder and the int8
    weights. A padded batch and its styles split into contiguous shards in
    order; every shard's call is enqueued before any result is read back, and
    the host concatenates the results in order. This is JAX's split
    (``msig_tpu/infer/engine.py:200-260``: replicated parameters, the batch on
    the mesh's axis, the int8 body per shard with no collectives), run from one
    process. Each shard forms its own style affines, as JAX's ``shard_map``
    body does: with dense styles a shard's last bits may differ from a whole
    batch's (``ROADMAP.md`` Queue 3, "the served image depends on the batch's
    size").
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from msig_tpu_torch import resolve_device
from msig_tpu_torch.config import InferenceConfig
from msig_tpu_torch.data import list_image_files, load_inference_image
from msig_tpu_torch.infer.quantized import (
    quantize_generator_params,
    quantized_generator_apply,
    to_out_dtype,
)
from msig_tpu_torch.infer.styles import latent_styles, sample_styles
from msig_tpu_torch.models import MultiDomainStyleEncoder, StyleCycleGANGenerator
from msig_tpu_torch.parallel.mesh import data_mesh_for_batch, local_devices

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def prepare_images(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [B,H,W,3] -> [-1,1] float; float inputs pass through (cast only).

    Copy of ``msig_tpu/train/step.py::prepare_images``."""
    if x.dtype == torch.uint8:
        return x.to(dtype) / 127.5 - 1.0
    return x.to(dtype)


@dataclasses.dataclass
class Replica:
    """One data-parallel shard's device and its own copy of the networks."""

    generator: StyleCycleGANGenerator
    style_encoder: MultiDomainStyleEncoder
    q: Optional[Dict[str, torch.Tensor]]
    device: torch.device


def _on(device: torch.device):
    """Make ``device`` current for the kernels' C entries, which launch on it."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


@dataclasses.dataclass
class InferenceEngine:
    generator: StyleCycleGANGenerator
    style_encoder: MultiDomainStyleEncoder
    image_size: int
    batch_size: int
    device: torch.device
    compute_dtype: torch.dtype = torch.bfloat16
    # int8 generator weights (quantize_generator_params); None = float path.
    q: Optional[Dict[str, torch.Tensor]] = None
    # Yield uint8 images from translate_batches; False yields [-1,1] float32.
    out_uint8: bool = False
    # Data-parallel shards in batch order (the first holds the fields above);
    # None = one device.
    replicas: Optional[List[Replica]] = None

    @staticmethod
    def build(cfg: InferenceConfig, num_domains: int, gen_sd: Mapping[str, torch.Tensor],
              se_sd: Mapping[str, torch.Tensor], n_residual_blocks: Optional[int] = None,
              style_dim: Optional[int] = None,
              devices: Optional[Sequence[Union[str, torch.device]]] = None,
              ) -> "InferenceEngine":
        """``devices``: the data-parallel candidates under ``cfg.data_parallel``
        (default every visible device of ``cfg.device``'s type)."""
        mesh = None
        if cfg.data_parallel:
            mesh = data_mesh_for_batch(
                cfg.batch_size, devices if devices is not None else local_devices(cfg.device))
        shard_devices = [resolve_device(str(d)) for d in mesh] if mesh else [
            resolve_device(cfg.device)]
        logger.info("serving on %d device(s): %s", len(shard_devices),
                    ", ".join(map(str, shard_devices)))
        dtype = _DTYPES[cfg.compute_dtype]
        n_res = n_residual_blocks or cfg.n_residual_blocks
        sdim = style_dim or cfg.style_dim
        gen = StyleCycleGANGenerator(style_dim=sdim, n_residual_blocks=n_res,
                                     use_pallas=cfg.use_pallas)
        gen.load_state_dict(gen_sd, strict=True)
        se = MultiDomainStyleEncoder(style_dim=sdim, num_domains=num_domains)
        se.load_state_dict(se_sd, strict=True)
        q = None
        if cfg.quantize == "int8":
            q = quantize_generator_params(gen_sd, n_res)
        elif cfg.quantize is not None:
            raise ValueError(f"unknown quantize mode {cfg.quantize!r}")

        def replica(d: torch.device) -> Replica:
            return Replica(
                copy.deepcopy(gen).to(device=d, dtype=dtype).eval().requires_grad_(False),
                copy.deepcopy(se).to(device=d, dtype=dtype).eval().requires_grad_(False),
                None if q is None else {k: v.to(d, copy=True) for k, v in q.items()}, d)

        replicas = [replica(d) for d in shard_devices]
        first = replicas[0]
        return InferenceEngine(
            generator=first.generator,
            style_encoder=first.style_encoder,
            image_size=cfg.image_size,
            batch_size=cfg.batch_size,
            device=first.device,
            compute_dtype=dtype,
            q=first.q,
            replicas=replicas if len(replicas) > 1 else None,
        )

    def _map_shards(self, fn: Callable[..., torch.Tensor], *xs: torch.Tensor) -> torch.Tensor:
        """``fn(replica, *parts)`` on each shard's contiguous part of every
        tensor of ``xs``, all enqueued before the first result is read back;
        the results concatenated in order on the host."""
        k = len(self.replicas)
        outs = []
        for r, parts in zip(self.replicas, zip(*(torch.tensor_split(x, k) for x in xs))):
            with _on(r.device):
                outs.append(fn(r, *(p.to(r.device, non_blocking=True) for p in parts)))
        return torch.cat([o.cpu() for o in outs])

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def encode_styles(self, images_u8: np.ndarray, domain_idx: int) -> torch.Tensor:
        """Batched style extraction: uint8 [N,H,W,3] -> style bank [N,S] (fp32)."""
        n = images_u8.shape[0]
        b = min(self.batch_size, n)
        bank = []
        for i in range(0, n, b):
            chunk = images_u8[i:i + b]
            pad = b - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)], 0)
            idx = torch.full((b,), domain_idx, dtype=torch.long)
            if self.replicas is None:
                x = prepare_images(torch.from_numpy(chunk).to(self.device), self.compute_dtype)
                out = self.style_encoder(x, idx.to(self.device))
            else:
                out = self._map_shards(
                    lambda r, c, i: r.style_encoder(prepare_images(c, self.compute_dtype), i),
                    torch.from_numpy(chunk), idx)
            bank.append(out.to(self.device, torch.float32)[:b - pad])
        return torch.cat(bank, 0)

    def preload_style_bank(self, ref_domain_dir: str, domain_idx: int,
                           max_styles: Optional[int] = None, seed: int = 0) -> torch.Tensor:
        """Load + encode every reference image of a domain (reference inference.py:80-129)."""
        files = list_image_files(ref_domain_dir)
        if not files:
            raise ValueError(f"No images found in {ref_domain_dir}")
        if max_styles and len(files) > max_styles:
            rng = np.random.default_rng(seed)
            # Sorted indices keep directory order: bank[0] stays the first
            # reference image for style_mode='specific'.
            chosen = np.sort(rng.choice(len(files), max_styles, replace=False))
            files = [files[i] for i in chosen]
        logger.info("Loading %d style vectors from %s", len(files), ref_domain_dir)

        def safe_load(p):
            try:
                return load_inference_image(p, self.image_size)
            except Exception as e:  # skip unreadable refs (reference inference.py:121-123)
                logger.warning("Failed to process style image %s: %s", p, e)
                return None

        with ThreadPoolExecutor(4) as pool:
            imgs = [a for a in pool.map(safe_load, files) if a is not None]
        if not imgs:
            raise ValueError(f"No valid style vectors could be extracted from {ref_domain_dir}")
        return self.encode_styles(np.stack(imgs), domain_idx)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def generate(self, imgs_u8: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
        """One batch: uint8 NHWC + styles [B,S] (on any device) -> uint8 or [-1,1]
        float32, on the engine's device, or on the host when data parallel."""
        if self.replicas is None:
            return self._generate(self.generator, self.q, imgs_u8.to(self.device),
                                  styles.to(self.device))
        return self._map_shards(lambda r, x, s: self._generate(r.generator, r.q, x, s),
                                imgs_u8, styles)

    def _generate(self, generator, q, imgs_u8: torch.Tensor, styles: torch.Tensor):
        out_dtype = torch.uint8 if self.out_uint8 else torch.float32
        if q is not None:
            return quantized_generator_apply(q, imgs_u8, styles.to(torch.float32),
                                             n_res=generator.n_residual_blocks,
                                             out_dtype=out_dtype)
        out = generator(prepare_images(imgs_u8, self.compute_dtype), styles.to(self.compute_dtype))
        return to_out_dtype(out.to(torch.float32), out_dtype)

    def translate_batches(
        self,
        batches: Iterator[Tuple[np.ndarray, List[str]]],
        style_bank: Optional[torch.Tensor],
        style_mode: str,
        noise_level: float = 0.1,
        seed: int = 0,
        mapping: Optional[Tuple[torch.nn.Module, int]] = None,
    ) -> Iterator[Tuple[np.ndarray, List[str]]]:
        """uint8 host batches + names -> translated host images + names.

        ``style_mode='latent'`` takes ``mapping=(MappingNetwork, domain_idx)``
        instead of a bank."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if style_mode == "latent":
            if mapping is None:
                raise ValueError("style_mode='latent' requires a mapping network")
            mapper, domain_idx = mapping

            def draw_styles():
                return latent_styles(mapper, domain_idx, gen, self.batch_size)
        else:
            def draw_styles():
                return sample_styles(style_bank, style_mode, gen, self.batch_size, noise_level)

        for imgs, names in batches:
            n = imgs.shape[0]
            pad = self.batch_size - n
            if pad:
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)], 0)
            styles = draw_styles()
            out = self.generate(torch.from_numpy(imgs), styles)
            yield out[:n].cpu().numpy(), names

    def iter_input_batches(
        self, input_dir: str, prefetch: int = 2,
        host_tee: Optional[List[Tuple[np.ndarray, List[str]]]] = None,
    ) -> Iterator[Tuple[np.ndarray, List[str]]]:
        """Decode input images in a thread pool, yielding fixed-size host batches.

        A producer thread decodes ``prefetch`` batches ahead. Unreadable files
        are skipped with a warning (reference inference.py:302-305). Closing the
        generator early stops the producer. ``host_tee``: a list the producer
        appends each decoded batch ``(uint8 array, names)`` to, for
        :meth:`iter_host_batches` to replay."""
        files = list_image_files(input_dir)
        if not files:
            return

        def safe_load(p):
            try:
                return load_inference_image(p, self.image_size)
            except Exception as e:  # per-image skip
                logger.warning("Error processing %s: %s", os.path.basename(p), e)
                return None

        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        end = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(4) as pool:
                    for i in range(0, len(files), self.batch_size):
                        if stop.is_set():
                            return
                        chunk = files[i:i + self.batch_size]
                        kept = [(a, os.path.basename(p))
                                for a, p in zip(pool.map(safe_load, chunk), chunk)
                                if a is not None]
                        if not kept:
                            continue
                        item = (np.stack([a for a, _ in kept]), [n for _, n in kept])
                        if host_tee is not None:
                            host_tee.append(item)
                        if not put(item):
                            return
            except Exception as e:  # surfaced to the consumer below
                put(e)
            finally:
                put(end)

        t = threading.Thread(target=producer, daemon=True, name="msig-torch-infer-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while True:  # unblock a producer stuck on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=30)

    @staticmethod
    def iter_host_batches(
        cached: List[Tuple[np.ndarray, List[str]]],
    ) -> Iterator[Tuple[np.ndarray, List[str]]]:
        """Replay a ``host_tee`` decode cache: the same host batches, in order.

        ``translate_batches`` pads a partial batch into a new array and writes
        into no batch it takes, so every pass replays the same images."""
        yield from cached
