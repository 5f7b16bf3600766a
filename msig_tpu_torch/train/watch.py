"""Per-tensor gradient histograms, binned on the device (``wandb.watch``'s gradients).

Counterpart of ``msig_tpu/train/watch.py``. The reference calls
``wandb.watch(models=(G_A2B, G_B2A, SE_A, SE_B, D_A, D_B), log_freq=50)``
(reference trainer.py:294), which logs a histogram of every parameter's
gradient every 50 steps. Here each gradient tensor reduces on its own device
to ``bins`` int32 counts and its (lo, hi) range, so a watch step moves a few
KB to the host, not the gradients; ``wandb.Histogram(np_histogram=...)``
takes the counts as they are.

The keys are ``gradients/<net>.<parameter name>``, the name that
``wandb.watch`` gives a parameter of the reference's torch modules
(``gradients/G_A2B.decoder.0.conv1.weight``). The JAX package keys flax paths
instead; ``compat/from_jax.py`` maps one onto the other.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

DEFAULT_BINS = 64  # wandb.Histogram's own default bin count

Hist = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


_TINY = float(torch.finfo(torch.float32).tiny)  # the smallest normal float32


def _ftz(t: torch.Tensor) -> torch.Tensor:
    """t with each subnormal value replaced by a zero of its sign, as XLA's
    flush-to-zero gives it (``t * 0`` keeps the sign); inf and NaN pass."""
    return torch.where(t.abs() < _TINY, t * 0, t)


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """float32 <-> int32 keys in the floats' order with -0 below +0, so that a
    min or max over the keys picks the zero that XLA's does (-0 for the min,
    +0 for the max, wherever it stands); the map is its own inverse."""
    if t.dtype == torch.float32:
        b = t.view(torch.int32)
        return b ^ ((b >> 31) & 0x7FFFFFFF)
    return (t ^ ((t >> 31) & 0x7FFFFFFF)).view(torch.float32)


def leaf_histogram(g: torch.Tensor, bins: int = DEFAULT_BINS) -> Hist:
    """(counts [bins] int32, lo, hi) of one tensor, on its device, as the JAX
    package's ``_leaf_histogram`` computes them (``watch.py:27-56``):

      - ``bins`` equal bins over the tensor's own finite [min, max], a value
        equal to ``hi`` in the last bin (``np.histogram``'s rule);
      - NaN and Inf left out of both the range and the counts;
      - an all-equal tensor gets the range value +- 0.5;
      - a tensor with no finite value gets zero counts over [-0.5, 0.5].

    Every operation is the JAX function's in float32, the bin width's
    division included (a tensor over a tensor: PyTorch turns a number over a
    tensor into a product with the reciprocal, one ulp away). XLA runs with
    subnormals flushed, on the CPU and the TPU: a subnormal operand reads as a
    zero of its sign and a subnormal result becomes one. PyTorch flushes
    neither, so the input and every difference or product that can fall
    below the smallest normal go through ``_ftz``; where none does, the
    values keep their bits."""
    x = _ftz(g.detach().to(torch.float32).reshape(-1))
    finite = torch.isfinite(x)
    any_finite = finite.any()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=x.device)
    lo = torch.where(any_finite, _ordered(_ordered(torch.where(finite, x, inf)).min()), zero)
    hi = torch.where(any_finite, _ordered(_ordered(torch.where(finite, x, -inf)).max()), zero)
    degenerate = hi <= lo
    lo_ = torch.where(degenerate, lo - 0.5, lo)
    hi_ = torch.where(degenerate, hi + 0.5, hi)
    scale = torch.full((), float(bins), dtype=torch.float32, device=x.device) / _ftz(hi_ - lo_)
    xf = torch.where(finite, x, lo_)
    idx = _ftz(_ftz(xf - lo_) * scale).to(torch.int32).clamp(0, bins - 1)
    counts = torch.zeros((bins,), dtype=torch.int32, device=x.device).index_add_(
        0, idx, finite.to(torch.int32))
    return counts, lo_, hi_


def gradient_histograms(g_grads: Mapping[str, Sequence[torch.Tensor]],
                        d_grads: Mapping[str, Sequence[torch.Tensor]],
                        names: Mapping[str, Sequence[str]],
                        bins: int = DEFAULT_BINS) -> Dict[str, Hist]:
    """The histograms of both groups' gradients, on the device.

    ``g_grads`` and ``d_grads`` map a network's key (``G_A2B`` ...) to its
    gradients in ``named_parameters`` order, ``names`` the key to those
    parameter names."""
    out: Dict[str, Hist] = {}
    for grads in (g_grads, d_grads):
        for net, gs in grads.items():
            for name, g in zip(names[net], gs):
                out[f"gradients/{net}.{name}"] = leaf_histogram(g, bins)
    return out


def to_host(hists: Mapping[str, Hist]) -> Dict[str, Tuple[np.ndarray, float, float]]:
    """One device -> host copy of every histogram: {name: (counts, lo, hi)}."""
    if not hists:
        return {}
    names = list(hists)
    counts = torch.stack([hists[n][0] for n in names]).cpu().numpy()
    ranges = torch.stack([torch.stack(hists[n][1:]) for n in names]).cpu().numpy()
    return {n: (counts[i], float(ranges[i, 0]), float(ranges[i, 1]))
            for i, n in enumerate(names)}


def to_wandb(host_hists: Mapping[str, Tuple[np.ndarray, float, float]]):
    """{name: (counts, lo, hi)} on the host -> {name: wandb.Histogram}.

    ``wandb`` is imported here, only when this is called, so the module works
    without it."""
    import wandb  # noqa: deferred, only reached when a wandb run is given

    out = {}
    for name, (counts, lo, hi) in host_hists.items():
        edges = np.linspace(float(lo), float(hi), len(counts) + 1)
        out[name] = wandb.Histogram(np_histogram=(np.asarray(counts), edges))
    return out
