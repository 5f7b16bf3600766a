"""Inference CLI of the port: ``python -m msig_tpu_torch.inference``.

The flags, exit codes and output naming of the root ``inference.py``, plus
``--device {cuda,cpu}`` (default ``cuda``; a missing card is an error, never a
silent fall back to the CPU):

    python -m msig_tpu_torch.inference --input_dir IN --ref_domains_dir REF \\
        --checkpoint_dir CKPT --output_dir OUT --target_domain NAME[,NAME...|all] \\
        [--style_mode average|random|interpolate|noise|specific|latent] \\
        [--mapping_params FILE --latent_dim 16] [--save_grid] \\
        [--quantize int8] [--batch_size B] [--device cuda|cpu]

Exit code 0 iff at least one image was processed; unreadable inputs are
skipped with a warning. ``--pallas/--no_pallas`` are accepted and do nothing:
on ``cuda`` the int8 trunk always runs the CUDA kernels.

  - ``--style_mode latent`` (extension): styles from a mapping network, read
    from ``--mapping_params`` (the flax msgpack bytes the root CLI reads, via
    ``compat/flax_bytes.py``), on z ~ N(0, I) of ``--latent_dim`` drawn from a
    ``torch.Generator(--seed)``: not ``jax.random``'s numbers;
  - ``--save_grid``: ``style_modes_grid.png`` in each domain's output
    directory, the first input and its translation in each style mode
    (not in ``latent`` mode, which has no bank);
  - several target domains decode the inputs once and replay them from the
    host (the decode cache) while they fit under ``MSIG_DECODE_CACHE_MB``
    (default 2048; a whole number, 0 turns the cache off; anything else raises).
  - ``--data_parallel``: each batch splits over the most visible cards that
    divide ``--batch_size`` (every card holding its own copy of the networks;
    ``infer/engine.py``); on one card, or with ``--device cpu``, it serves on
    one device, as the JAX CLI does on one chip.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import msig_tpu_torch.config as default_config
from msig_tpu_torch.config import InferenceConfig


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Multi-domain inference with style sampling")
    parser.add_argument("--input_dir", type=str, default=default_config.INFERENCE_INPUT_DIR,
                        help="Directory containing source images")
    parser.add_argument("--ref_domains_dir", type=str,
                        default=default_config.INFERENCE_TARGET_DOMAINS_DIR,
                        help="Directory containing all reference domain folders")
    parser.add_argument("--checkpoint_dir", type=str,
                        default=default_config.INFERENCE_CHECKPOINT_DIR,
                        help="Directory containing model checkpoint")
    parser.add_argument("--output_dir", type=str, default=default_config.INFERENCE_OUTPUT_DIR,
                        help="Directory to save output images")
    parser.add_argument("--target_domain", type=str,
                        default=default_config.INFERENCE_TARGET_DOMAIN,
                        help="Target domain folder to translate to; also accepts a "
                             "comma-separated list or 'all' (multi-domain outputs go to "
                             "output_dir/<domain>/)")
    parser.add_argument("--gpu", type=int, default=default_config.GPU,
                        help="Accepted for reference CLI parity; use --device")
    parser.add_argument("--image_size", type=int, default=default_config.IMAGE_SIZE)
    parser.add_argument("--style_dim", type=int, default=default_config.STYLE_DIM,
                        help="Dimension of style code")
    parser.add_argument("--style_mode", type=str, default=default_config.INFERENCE_STYLE_MODE,
                        choices=["average", "random", "interpolate", "noise", "specific",
                                 "latent"],
                        help="Style sampling mode ('latent': a mapping network on random z)")
    parser.add_argument("--mapping_params", type=str, default=None,
                        help="Mapping network params (flax msgpack bytes) for style_mode=latent")
    parser.add_argument("--latent_dim", type=int, default=16,
                        help="Latent size of the mapping network")
    parser.add_argument("--noise_level", type=float,
                        default=default_config.INFERENCE_NOISE_LEVEL,
                        help="Noise level for noise mode")
    parser.add_argument("--max_styles", type=int, default=None,
                        help="Maximum number of style vectors to load (None for all)")
    parser.add_argument("--save_grid", action="store_true",
                        help="Save a comparison grid of the style modes for the first input")
    parser.add_argument("--batch_size", type=int, default=default_config.INFERENCE_BATCH_SIZE,
                        help="Generation batch size")
    parser.add_argument("--compute_dtype", type=str, default=default_config.COMPUTE_DTYPE_INFER,
                        choices=["float32", "bfloat16"])
    parser.add_argument("--quantize", type=str, default=None, choices=["int8"],
                        help="int8 generator for serving")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pallas", dest="pallas", action="store_true", default=None,
                        help="Route the float generator's AdaIN to the fused CUDA kernel "
                             "(ops/adain_pallas.py) and run the int8 generator on its kernel trunk")
    parser.add_argument("--no_pallas", dest="pallas", action="store_false")
    parser.add_argument("--data_parallel", action="store_true",
                        help="Split each batch over the visible cards (the most that divide "
                             "--batch_size)")
    parser.add_argument("--device", type=str, default=default_config.DEVICE,
                        choices=["cuda", "cpu"],
                        help="Device to run on (default cuda; no fallback to cpu)")
    return parser


def config_from_args(args) -> InferenceConfig:
    return InferenceConfig(
        input_dir=args.input_dir,
        ref_domains_dir=args.ref_domains_dir,
        checkpoint_dir=args.checkpoint_dir,
        output_dir=args.output_dir,
        target_domain=args.target_domain,
        gpu=args.gpu,
        image_size=args.image_size,
        style_dim=args.style_dim,
        style_mode=args.style_mode,
        noise_level=args.noise_level,
        max_styles=args.max_styles,
        save_grid=args.save_grid,
        batch_size=args.batch_size,
        compute_dtype=args.compute_dtype,
        seed=args.seed,
        use_pallas=(default_config.USE_PALLAS_ADAIN if args.pallas is None else args.pallas),
        mapping_params=args.mapping_params,
        latent_dim=args.latent_dim,
        quantize=args.quantize,
        data_parallel=args.data_parallel,
        device=args.device,
    )


def decode_cache_mb() -> int:
    """``MSIG_DECODE_CACHE_MB`` (default 2048), read strictly: a whole number of MB
    (0 turns the cache off), anything else raises. The JAX CLI warns and takes
    2048 instead."""
    v = os.environ.get("MSIG_DECODE_CACHE_MB", "2048")
    if not v.isdigit():
        raise ValueError(f"MSIG_DECODE_CACHE_MB={v!r} is not a whole number of MB: unset it or "
                         "set it to one (0 turns the decode cache off)")
    return int(v)


def load_mapping_network(cfg: InferenceConfig, style_dim: int, num_domains: int, device):
    """The ``MappingNetwork`` of ``--mapping_params`` (flax bytes), on ``device``."""
    from msig_tpu_torch.compat import flax_bytes
    from msig_tpu_torch.compat import from_jax as fj
    from msig_tpu_torch.extensions import MappingNetwork

    net = MappingNetwork(latent_dim=cfg.latent_dim, style_dim=style_dim, num_domains=num_domains)
    with open(cfg.mapping_params, "rb") as f:
        tree = flax_bytes.from_bytes(fj.mapping_params(net.state_dict()), f.read())
    net.load_state_dict(fj.mapping_state_dict(tree), strict=True)
    return net.to(device).eval().requires_grad_(False)


def main(cfg: InferenceConfig) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    is_redirected = not os.isatty(1)  # quiet when stdout is redirected

    def say(msg):
        if not is_redirected:
            print(msg)

    import torch

    from msig_tpu_torch import resolve_device

    try:
        device = resolve_device(cfg.device)
    except (RuntimeError, ValueError) as e:
        print(f"Failed: {e}")
        return 1
    # --compute_dtype float32 means fp32 on the card too: by default cuDNN
    # would run fp32 convolutions in TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if cfg.style_mode == "latent" and not cfg.mapping_params:
        print("Failed: --style_mode latent requires --mapping_params")
        return 1

    say(f"Starting inference with target domain: {cfg.target_domain}")
    say(f"Input directory: {cfg.input_dir}")
    say(f"Reference domains directory: {cfg.ref_domains_dir}")
    say(f"Checkpoint directory: {cfg.checkpoint_dir}")
    say(f"Output directory: {cfg.output_dir}")

    import numpy as np

    from msig_tpu_torch.data import discover_inference_domains, list_image_files
    from msig_tpu_torch.infer.engine import InferenceEngine
    from msig_tpu_torch.infer.loading import load_inference_params
    from msig_tpu_torch.infer.styles import STYLE_MODES
    from msig_tpu_torch.utils import save_sample_grid
    from PIL import Image

    # Source is domain 0, targets from 1 (must match training).
    try:
        domain_dirs = discover_inference_domains(cfg.ref_domains_dir)
    except ValueError as e:
        print(f"Failed to discover domains: {e}")
        return 1
    if not domain_dirs:
        raise ValueError(f"No domains found in {cfg.ref_domains_dir}")
    num_domains = len(domain_dirs) + 1
    say(f"Found {len(domain_dirs)} target domains: {domain_dirs}")

    if cfg.target_domain == "all":
        targets = list(domain_dirs)
    else:
        targets = [d.strip() for d in cfg.target_domain.split(",") if d.strip()]
    if not targets:
        print(f"Failed: --target_domain {cfg.target_domain!r} names no domain. "
              f"Available: {domain_dirs}")
        return 1
    for t in targets:
        if t not in domain_dirs:
            print(f"Failed: target domain '{t}' not found. Available: {domain_dirs}")
            return 1

    try:
        gen_sd, se_sd, meta, used_ema = load_inference_params(cfg.checkpoint_dir, cfg,
                                                              num_domains)
        say(f"Model loaded successfully ({'EMA' if used_ema else 'raw'} weights)")
    except Exception as e:
        print(f"Failed to load model: {e}")
        import traceback

        traceback.print_exc()
        return 1

    # The float-output engine draws the --save_grid tiles; `serving` gives uint8.
    engine = InferenceEngine.build(cfg, num_domains, gen_sd, se_sd,
                                   n_residual_blocks=meta.get("n_residual_blocks"),
                                   style_dim=meta.get("style_dim"))
    serving = dataclasses.replace(engine, out_uint8=True)
    mapper = None
    if cfg.style_mode == "latent":
        mapper = load_mapping_network(cfg, int(meta.get("style_dim") or cfg.style_dim),
                                      num_domains, device)
        say("Mapping network loaded (latent-guided synthesis)")
    os.makedirs(cfg.output_dir, exist_ok=True)
    processed, failed = 0, 0

    def save_grid(bank, out_dir: str) -> None:
        """The first input and its translation in each style mode, one grid."""
        grid_it = engine.iter_input_batches(cfg.input_dir)
        first = next(grid_it, None)
        grid_it.close()  # one batch is enough: stop the producer
        if first is None:
            return
        imgs, names = first
        one = np.asarray(imgs[0:1])
        tiles, labels = [one[0].astype(np.float32) / 127.5 - 1.0], ["input"]
        for mode in STYLE_MODES:
            out, _ = next(engine.translate_batches(iter([(one.copy(), names[:1])]), bank, mode,
                                                   cfg.noise_level, cfg.seed))
            tiles.append(out[0])
            labels.append(mode)
        grid_path = os.path.join(out_dir, "style_modes_grid.png")
        save_sample_grid(np.stack(tiles), grid_path, nrow=3, domain_names=labels)
        say(f"Saved style-mode comparison grid to {grid_path}")

    def run_domain(domain: str, out_dir: str) -> int:
        nonlocal processed, failed
        t_idx = domain_dirs.index(domain) + 1
        bank, mapping = None, None
        if mapper is not None:
            mapping = (mapper, t_idx)
        else:
            try:
                bank = engine.preload_style_bank(os.path.join(cfg.ref_domains_dir, domain),
                                                 t_idx, max_styles=cfg.max_styles, seed=cfg.seed)
                say(f"[{domain}] Style vectors loaded successfully ({bank.shape[0]})")
            except Exception as e:
                print(f"Failed to load style vectors: {e}")
                import traceback

                traceback.print_exc()
                return 1
        os.makedirs(out_dir, exist_ok=True)
        if cfg.save_grid and bank is not None:
            save_grid(bank, out_dir)

        # Several domains: decode the inputs once and replay them for the others.
        if decode_cache is not None and decode_cache["ready"]:
            batches = serving.iter_host_batches(decode_cache["batches"])
        elif decode_cache is not None:
            decode_cache["batches"] = []
            batches = serving.iter_input_batches(cfg.input_dir,
                                                 host_tee=decode_cache["batches"])
        else:
            batches = serving.iter_input_batches(cfg.input_dir)
        say(f"[{domain}] Processing images with style mode: {cfg.style_mode}")

        def _save(img, name):
            try:
                Image.fromarray(img).save(os.path.join(out_dir, name))
                return True
            except Exception as e:
                print(f"Error processing {name}: {e}")
                return False

        pending: deque = deque()

        def _drain(limit):
            nonlocal processed, failed
            while len(pending) > limit:
                if pending.popleft().result():
                    processed += 1
                else:
                    failed += 1

        with ThreadPoolExecutor(4) as pool:
            for out, names in serving.translate_batches(batches, bank, cfg.style_mode,
                                                        cfg.noise_level, cfg.seed,
                                                        mapping=mapping):
                for img, name in zip(out, names):
                    pending.append(pool.submit(_save, img, name))
                _drain(4 * serving.batch_size)
            _drain(0)
        if decode_cache is not None:
            decode_cache["ready"] = True  # the first pass decoded the whole set
        return 0

    multi = len(targets) > 1
    decode_cache = None
    if multi:
        est_bytes = len(list_image_files(cfg.input_dir)) * cfg.image_size ** 2 * 3
        cap = decode_cache_mb() << 20
        if est_bytes <= cap:
            decode_cache = {"ready": False, "batches": []}
        else:
            say(f"Decode cache disabled ({est_bytes >> 20} MB uint8 exceeds "
                f"MSIG_DECODE_CACHE_MB={cap >> 20}); re-decoding per domain")
    for t in targets:
        rc = run_domain(t, os.path.join(cfg.output_dir, t) if multi else cfg.output_dir)
        if rc:
            return rc

    if processed == 0:
        if failed:
            print(f"WARNING: all {failed} images failed (decode or save errors above)")
        else:
            print(f"WARNING: No images found in {cfg.input_dir}")
        return 1

    say("\nInference complete!")
    say(f"Successfully processed: {processed} images"
        + (f" across {len(targets)} domains" if multi else ""))
    say(f"Failed: {failed} images")
    say(f"Results saved to: {cfg.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main(config_from_args(build_arg_parser().parse_args())))
