"""Batched inference engine (reference-guided synthesis) on one device.

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

Data-parallel serving is not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

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

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def prepare_images(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [B,H,W,3] -> [-1,1] float; float inputs pass through (cast only).

    Copy of ``msig_tpu/train/step.py::prepare_images``."""
    if x.dtype == torch.uint8:
        return x.to(dtype) / 127.5 - 1.0
    return x.to(dtype)


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

    @staticmethod
    def build(cfg: InferenceConfig, num_domains: int, gen_sd: Mapping[str, torch.Tensor],
              se_sd: Mapping[str, torch.Tensor], n_residual_blocks: Optional[int] = None,
              style_dim: Optional[int] = None) -> "InferenceEngine":
        if cfg.data_parallel:
            raise NotImplementedError(
                "data_parallel serving is not ported to msig_tpu_torch yet "
                "(ROADMAP.md, Queue 1 item 10: data parallelism)")
        device = resolve_device(cfg.device)
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
            q = {k: v.to(device) for k, v in quantize_generator_params(gen_sd, n_res).items()}
        elif cfg.quantize is not None:
            raise ValueError(f"unknown quantize mode {cfg.quantize!r}")
        return InferenceEngine(
            generator=gen.to(device=device, dtype=dtype).eval().requires_grad_(False),
            style_encoder=se.to(device=device, dtype=dtype).eval().requires_grad_(False),
            image_size=cfg.image_size,
            batch_size=cfg.batch_size,
            device=device,
            compute_dtype=dtype,
            q=q,
        )

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
            x = prepare_images(torch.from_numpy(chunk).to(self.device), self.compute_dtype)
            idx = torch.full((b,), domain_idx, dtype=torch.long, device=self.device)
            bank.append(self.style_encoder(x, idx).to(torch.float32)[:b - pad])
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
        """One batch on the device: uint8 NHWC + styles [B,S] -> uint8 or [-1,1] float32."""
        out_dtype = torch.uint8 if self.out_uint8 else torch.float32
        if self.q is not None:
            return quantized_generator_apply(self.q, imgs_u8, styles.to(torch.float32),
                                             n_res=self.generator.n_residual_blocks,
                                             out_dtype=out_dtype)
        out = self.generator(prepare_images(imgs_u8, self.compute_dtype),
                             styles.to(self.compute_dtype))
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
            out = self.generate(torch.from_numpy(imgs).to(self.device), styles)
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
