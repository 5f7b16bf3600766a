"""R1 gradient penalty (extension: the reference trains with plain LSGAN only).

Counterpart of ``msig_tpu/extensions/r1.py``. The train step adds
``gamma / 2 * (R1(D_A, real_A) + R1(D_B, real_B))`` to the discriminator's
loss when ``r1_gamma > 0``; at 0 (the default) the loss is the reference's.
"""

from __future__ import annotations

import torch
from torch import nn


def r1_penalty(disc: nn.Module, real: torch.Tensor, domain_idx: torch.Tensor) -> torch.Tensor:
    """E_b[sum |grad_x D(x)|^2] on real images (the caller scales it by gamma / 2).

    The gradient is taken with respect to an fp32 copy of ``real``, and the
    discriminator runs on that copy cast back to ``real``'s dtype: the JAX
    function differentiates with respect to fp32 images that its bf16
    discriminator casts on entry, so under a bf16 step D runs in bf16 here too.
    ``create_graph`` keeps the penalty differentiable in D's parameters."""
    x = real.detach().to(torch.float32).requires_grad_(True)
    score = disc(x.to(real.dtype), domain_idx).to(torch.float32).sum()
    (grad,) = torch.autograd.grad(score, x, create_graph=True)
    return grad.square().sum(dim=(1, 2, 3)).mean()
