"""Style-sampling modes on a ``torch.Generator``.

Counterpart of ``msig_tpu/infer/styles.py`` (reference inference.py:132-169),
same semantics, one call per batch:

  - ``average``:     mean of all bank vectors;
  - ``random``:      uniform pick per output image;
  - ``interpolate``: two distinct uniform picks + alpha ~ U(0,1) per image
                     (vector 0 when the bank has fewer than 2 styles);
  - ``noise``:       uniform pick + N(0, noise_level^2) perturbation;
  - ``specific``:    always the first vector.

Torch cannot draw ``jax.random``'s numbers, so the random modes also take the
draws themselves (``draws``): ``index`` [batch] in [0, n), ``second`` [batch]
in [0, n-1) (mapped past ``index`` to make the pair distinct), ``alpha``
[batch, 1] and ``normal`` [batch, S] standard normal. Tests hand the same
draws to both packages. ``latent`` needs the mapping network, not ported yet.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

STYLE_MODES = ("average", "random", "interpolate", "noise", "specific")


def sample_styles(style_bank: torch.Tensor, mode: str, generator: Optional[torch.Generator],
                  batch: int, noise_level: float = 0.1,
                  draws: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
    """Draw ``batch`` style codes [batch, S] from the bank [N, S] under ``mode``."""
    n, s = style_bank.shape
    dev = style_bank.device

    def draw(name, make):
        return draws[name].to(dev) if draws is not None else make()

    def randint(high):
        return torch.randint(0, high, (batch,), generator=generator, device=dev)

    if mode == "average":
        # sum times 1/n, as XLA lowers the JAX package's mean
        return (style_bank.sum(dim=0) * (1.0 / n)).expand(batch, s)
    if mode == "specific":
        return style_bank[0].expand(batch, s)
    if mode == "random":
        return style_bank[draw("index", lambda: randint(n))]
    if mode == "interpolate":
        if n < 2:
            return style_bank[0].expand(batch, s)
        i = draw("index", lambda: randint(n))
        j = draw("second", lambda: randint(n - 1))
        j = torch.where(j >= i, j + 1, j)
        alpha = draw("alpha", lambda: torch.rand((batch, 1), generator=generator, device=dev))
        return alpha * style_bank[i] + (1.0 - alpha) * style_bank[j]
    if mode == "noise":
        idx = draw("index", lambda: randint(n))
        z = draw("normal", lambda: torch.randn((batch, s), generator=generator, device=dev))
        return style_bank[idx] + z * noise_level
    raise ValueError(f"Unknown style mode: {mode}")
