"""What the port's quality tools share: ``eval_quality``, ``eval_trajectory_fast``,
``eval_trajectory_batch`` and ``eval_quality_trajectory``.

The root tools (``tools/eval_quality.py`` and the three trajectory runners)
repeat these pieces inline; here they are written once, with the root tools'
rules:

  - images at 256² (``load_inference_image``), translated by the float engine
    (``InferenceConfig``'s defaults: bf16 compute) in style mode ``average``;
  - float output to uint8 by ``np.clip((out + 1) * 127.5, 0, 255).astype(np.uint8)``,
    which truncates (``tools/eval_quality.py:100``);
  - a domain's row of ``quality.json``: proxy-FID, colour-Fréchet and hist-TV
    of the generated and of the untranslated sources against the domain's
    references, rounded to 6, 6 and 4 digits;
  - ``trajectory.csv`` (one row an epoch and domain) and ``trajectory.png``
    (proxy-FID and colour-Fréchet against the epoch, each domain and their
    mean beside the untranslated baseline). The card's machine has no
    matplotlib: without it, or with ``MSIG_SKIP_EPOCH_ART=1`` (which skips the
    train CLI's epoch art), the plot is skipped with a line that says so.

The proxy-FID scores with the port's seeded random VGG (``eval/fid.py``), not
the JAX package's ``jax.random`` one: each package's numbers are
self-consistent, and given the same VGG weights they agree.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

IMAGE_SIZE = 256
SOURCE_DIR, REF_DIR = "data/src/Tomato_healthy", "data/ref"  # the reference's data layout
STYLE_MODE = "average"
CSV_HEADER = ("epoch,domain,proxy_fid_gen,proxy_fid_src,color_frechet_gen,color_frechet_src,"
              "hist_tv_gen,hist_tv_src\n")
CSV_KEYS = ("proxy_fid_generated_vs_ref", "proxy_fid_source_vs_ref",
            "color_frechet_generated_vs_ref", "color_frechet_source_vs_ref",
            "hist_tv_generated_vs_ref", "hist_tv_source_vs_ref")


def device_or_exit(device: str) -> None:
    """Exit 1 with a message where ``device`` is not there (no fall back to the
    CPU); fp32 on the card means fp32 (cuDNN would run the VGG in TF32)."""
    import torch

    from msig_tpu_torch import resolve_device

    try:
        resolve_device(device)
    except (RuntimeError, ValueError) as e:
        sys.exit(f"ERROR: {e}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def to_uint8(out: np.ndarray) -> np.ndarray:
    return np.clip((np.asarray(out, np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def list_domains(ref_dir: str) -> List[str]:
    return sorted(d for d in os.listdir(ref_dir) if os.path.isdir(os.path.join(ref_dir, d)))


def load_images(files: Sequence[str]) -> np.ndarray:
    from msig_tpu_torch.data import load_inference_image

    return np.stack([load_inference_image(p, IMAGE_SIZE) for p in files])


def inference_config(batch_size: int, device: str, checkpoint_dir: Optional[str] = None):
    from msig_tpu_torch.config import InferenceConfig

    extra = {} if checkpoint_dir is None else {"checkpoint_dir": checkpoint_dir}
    return InferenceConfig(image_size=IMAGE_SIZE, batch_size=batch_size, device=device, **extra)


def build_engine(cfg, num_domains: int, gen_sd, se_sd, meta: Mapping):
    from msig_tpu_torch.infer.engine import InferenceEngine

    return InferenceEngine.build(cfg, num_domains, gen_sd, se_sd,
                                 n_residual_blocks=int(meta.get("n_residual_blocks", 8)),
                                 style_dim=int(meta.get("style_dim", 256)))


def translate(eng, src_imgs: np.ndarray, names: Sequence[str], bank,
              batch_size: int) -> Iterator[Tuple[np.ndarray, List[str]]]:
    """uint8 translations of ``src_imgs`` in batches of ``batch_size`` with the
    bank's average style, and their names."""
    def batches():
        for i in range(0, len(src_imgs), batch_size):
            yield src_imgs[i: i + batch_size], list(names[i: i + batch_size])

    for out, chunk_names in eng.translate_batches(batches(), bank, STYLE_MODE):
        yield to_uint8(out), chunk_names


def quality_row(fid_gen: float, fid_src: float, cf_gen: float, cf_src: float,
                tv_gen: float, tv_src: float) -> Dict[str, float]:
    return {
        "proxy_fid_generated_vs_ref": round(float(fid_gen), 6),
        "proxy_fid_source_vs_ref": round(float(fid_src), 6),
        "color_frechet_generated_vs_ref": round(float(cf_gen), 6),
        "color_frechet_source_vs_ref": round(float(cf_src), 6),
        "hist_tv_generated_vs_ref": round(float(tv_gen), 4),
        "hist_tv_source_vs_ref": round(float(tv_src), 4),
    }


def save_strip(src: Sequence[np.ndarray], gen: Sequence[np.ndarray], path: str) -> None:
    """Rows of source | generated, as JPEG quality 92."""
    from PIL import Image

    strip = [np.concatenate([s, g], axis=1) for s, g in zip(src, gen)]
    Image.fromarray(np.concatenate(strip, axis=0)).save(path, quality=92)


def snapshots(snap_root: str) -> List[Tuple[int, str]]:
    """(epoch, directory) of every ``epoch_N`` holding an EMA snapshot, by epoch."""
    snaps = []
    for d in os.listdir(snap_root):
        m = re.fullmatch(r"epoch_(\d+)", d)
        if m and os.path.exists(os.path.join(snap_root, d, "ema_g_se_fp16.npz")):
            snaps.append((int(m.group(1)), os.path.join(snap_root, d)))
    return sorted(snaps)


def snapshot_engines(snaps: Sequence[Tuple[int, str]], cfg, num_domains: int, out: str,
                     rows: Dict[int, dict]) -> Iterator[Tuple[int, int, str, object]]:
    """(index, epoch, report dir, engine) of every snapshot whose
    ``<out>/epoch_N/quality.json`` is not there yet, one engine for all (built
    on the first, its weights swapped for each later one); the reports that are
    there go into ``rows`` instead."""
    from msig_tpu_torch.infer.loading import load_inference_params

    eng = None
    for k, (epoch, snap) in enumerate(snaps):
        dst = os.path.join(out, f"epoch_{epoch}")
        qj = os.path.join(dst, "quality.json")
        if os.path.exists(qj):
            with open(qj) as f:
                rows[epoch] = json.load(f)
            print(f"epoch {epoch}: cached", flush=True)
            continue
        gen_sd, se_sd, meta, _ = load_inference_params(snap, cfg, num_domains)
        if eng is None:
            eng = build_engine(cfg, num_domains, gen_sd, se_sd, meta)
        else:  # the same structure: swap the weights, as the JAX runners swap their trees
            eng.generator.load_state_dict(gen_sd, strict=True)
            eng.style_encoder.load_state_dict(se_sd, strict=True)
        os.makedirs(dst, exist_ok=True)
        yield k, epoch, dst, eng


def save_report(dst: str, epoch: int, report: Dict[str, dict], rows: Dict[int, dict]) -> None:
    """An epoch's ``quality.json``, into ``rows`` too."""
    with open(os.path.join(dst, "quality.json"), "w") as f:
        json.dump(report, f, indent=2)
    rows[epoch] = report
    mean_fid = np.mean([r["proxy_fid_generated_vs_ref"] for r in report.values()])
    print(f"epoch {epoch}: done (mean proxy-FID {mean_fid:.6f})", flush=True)


def _art() -> Optional[str]:
    """Why the plot is skipped, or None."""
    if os.environ.get("MSIG_SKIP_EPOCH_ART", "0") == "1":
        return "MSIG_SKIP_EPOCH_ART=1"
    if importlib.util.find_spec("matplotlib") is None:
        return "matplotlib is not installed"
    return None


def write_trajectory(out: str, rows: Mapping[int, Mapping[str, Mapping[str, float]]]
                     ) -> Tuple[str, Optional[str]]:
    """``trajectory.csv`` (a row an epoch and domain, by epoch, then domain) and
    ``trajectory.png`` under ``out`` from {epoch: quality.json's report};
    returns their paths (the plot's None where it is skipped)."""
    epochs = sorted(rows)
    csv_path = os.path.join(out, "trajectory.csv")
    with open(csv_path, "w") as f:
        f.write(CSV_HEADER)
        for e in epochs:
            for d in sorted(rows[e]):
                f.write(f"{e},{d}," + ",".join(str(rows[e][d][k]) for k in CSV_KEYS) + "\n")
    why = _art()
    if why is not None:
        print(f"trajectory.png skipped: {why} (trajectory.csv holds the numbers)", flush=True)
        return csv_path, None

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    doms = sorted(rows[epochs[0]])

    def mean(key):
        return [np.mean([rows[e][d][key] for d in doms if d in rows[e]]) for e in epochs]

    fig, axes = plt.subplots(1, 2, figsize=(13, 5))
    for d in doms:
        # x and y filtered together: a domain missing from an epoch drops that epoch's x too
        xs = [e for e in epochs if d in rows[e]]
        axes[0].plot(xs, [rows[e][d]["proxy_fid_generated_vs_ref"] for e in xs], alpha=0.4, lw=1)
        axes[1].plot(xs, [rows[e][d]["color_frechet_generated_vs_ref"] for e in xs], alpha=0.4,
                     lw=1)
    axes[0].plot(epochs, mean("proxy_fid_generated_vs_ref"), "k-", lw=2.5,
                 label="generated (mean)")
    axes[0].plot(epochs, mean("proxy_fid_source_vs_ref"), "k--", lw=1.5,
                 label="untranslated baseline")
    axes[0].set_title("proxy-FID (random-VGG features) vs epoch")
    axes[1].plot(epochs, mean("color_frechet_generated_vs_ref"), "k-", lw=2.5,
                 label="generated (mean)")
    axes[1].plot(epochs, mean("color_frechet_source_vs_ref"), "k--", lw=1.5,
                 label="untranslated baseline")
    axes[1].set_title("color-Frechet (weights-free) vs epoch")
    for ax in axes:
        ax.set_xlabel("epoch")
        ax.legend()
        ax.grid(alpha=0.3)
    fig.tight_layout()
    plot_path = os.path.join(out, "trajectory.png")
    fig.savefig(plot_path, dpi=110)
    plt.close(fig)
    return csv_path, plot_path


def report_written(paths: Tuple[str, Optional[str]], n_epochs: int) -> None:
    csv_path, plot_path = paths
    also = f" and {plot_path}" if plot_path else ""
    print(f"wrote {csv_path}{also} over {n_epochs} epochs", flush=True)
