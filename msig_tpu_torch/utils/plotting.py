"""Loss / weight-history plots (matplotlib, headless, imported at first use).

Copy of ``msig_tpu/utils/plotting.py`` (reference trainer.py:209-217,
utils.py:136-155). matplotlib is not among the port's requirements: where it
is missing, a plot raises ImportError saying so; ``MSIG_SKIP_EPOCH_ART=1``
makes the trainer skip the plots (and the sample grids).
"""

from __future__ import annotations

import os
from typing import Dict, Sequence


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "the loss plots need matplotlib, which is not installed; set "
            "MSIG_SKIP_EPOCH_ART=1 to train without the per-epoch plots and sample grids") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_losses(loss_history: Dict[str, Sequence[float]], save_path: str) -> None:
    if not loss_history or not any(
        v for k, v in loss_history.items() if k in ("G_loss", "D_loss")
    ):
        return
    plt = _plt()
    plt.figure(figsize=(12, 8))
    n = len(loss_history.get("G_loss", []))
    epochs = range(1, n + 1)
    for loss_type, values in loss_history.items():
        if values:
            plt.plot(epochs, values, label=loss_type)
    plt.legend()
    plt.xlabel("Epochs")
    plt.ylabel("Loss")
    plt.title("Training Losses Over Epochs")
    plt.grid(True, linestyle="--", alpha=0.6)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=300)
    plt.close()


def plot_weight_history(weight_history: Dict[str, Sequence[float]], save_path: str) -> None:
    if not any(weight_history.values()):
        return
    plt = _plt()
    plt.figure(figsize=(15, 8))
    for k, v in weight_history.items():
        if v:
            plt.plot(v, label=k, linewidth=2)
    plt.title("Loss Weight Evolution Over Training")
    plt.xlabel("Epochs")
    plt.ylabel("Weight Value")
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.6)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close()
