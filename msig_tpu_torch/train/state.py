"""Train state: the six networks, the four EMA copies and the two optimizers.

Counterpart of ``msig_tpu/train/state.py`` (reference trainer.py:25-72). The
networks are ``nn.Module``s; the optimizers keep optax's semantics
(``state.py:74-79``), written as plain functions over the parameter lists of
the G group (G_A2B, G_B2A, SE_A, SE_B, in that order, as the reference's
optimizer takes them) and the D group (D_A, D_B):

  - ``clip_by_global_norm(1.0)``: the gradients are scaled by ``max / norm``
    only when ``norm >= max`` (``torch.nn.utils.clip_grad_norm_`` scales by
    ``max / (norm + 1e-6)`` whenever ``norm > max``, so it is not used);
  - ``scale_by_adam(b1=0.5, b2=0.999, eps=1e-8, eps_root=0)``;
  - ``p <- p + (-lr) * u``, the learning rate given per call.

Parameters, moments and EMA copies are updated in place. Initialisation is
torch's default (U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every weight and bias)
drawn from one ``torch.Generator(seed)`` in the order G_A2B, G_B2A, SE_A,
SE_B, D_A, D_B, so a seed gives the same networks on every device; its numbers
are not those of the JAX package's ``jax.random`` init. The networks live on
``cfg.device`` (``cuda`` unless the config says ``cpu``; a missing card raises).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from msig_tpu_torch import resolve_device
from msig_tpu_torch.config import TrainConfig
from msig_tpu_torch.models import (
    MultiDomainDiscriminator,
    MultiDomainStyleEncoder,
    StyleCycleGANGenerator,
)

G_KEYS = ("G_A2B", "G_B2A", "SE_A", "SE_B")
D_KEYS = ("D_A", "D_B")


@torch.no_grad()
def torch_default_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Redraw every conv / linear weight and bias of ``module`` from
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch's default, with ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
            bound = 1.0 / math.sqrt(fan_in)
            for t in (m.weight, m.bias):
                if t is not None:
                    t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=generator))


@dataclasses.dataclass
class Models:
    """The six live networks and the EMA copies of the G group."""

    nets: Dict[str, nn.Module]
    ema: Dict[str, nn.Module]
    num_domains: int

    @staticmethod
    def from_config(cfg: TrainConfig, num_domains: int) -> "Models":
        device = resolve_device(cfg.device)
        gen = torch.Generator().manual_seed(cfg.seed)
        nets: Dict[str, nn.Module] = {}
        for key in G_KEYS + D_KEYS:
            if key.startswith("G_"):
                net = StyleCycleGANGenerator(style_dim=cfg.style_dim,
                                             n_residual_blocks=cfg.n_residual_blocks,
                                             use_pallas=cfg.use_pallas)
            elif key.startswith("SE_"):
                net = MultiDomainStyleEncoder(style_dim=cfg.style_dim, num_domains=num_domains)
            else:
                net = MultiDomainDiscriminator(num_domains=num_domains)
            torch_default_init_(net, gen)
            nets[key] = net.to(device)
        ema = {k: copy.deepcopy(nets[k]).requires_grad_(False) for k in G_KEYS}
        return Models(nets, ema, num_domains)

    def params(self, keys: Sequence[str]) -> List[nn.Parameter]:
        return [p for k in keys for p in self.nets[k].parameters()]

    def g_params(self) -> List[nn.Parameter]:
        return self.params(G_KEYS)

    def d_params(self) -> List[nn.Parameter]:
        return self.params(D_KEYS)


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the step count and the two moments per parameter."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]

    @staticmethod
    def init(params: Sequence[torch.Tensor]) -> "AdamState":
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])


@dataclasses.dataclass
class TrainState:
    models: Models
    opt_g: AdamState
    opt_d: AdamState
    step: int = 0


def create_train_state(cfg: TrainConfig, num_domains: int) -> TrainState:
    models = Models.from_config(cfg, num_domains)
    return TrainState(models, AdamState.init(models.g_params()), AdamState.init(models.d_params()))


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares of every element."""
    return torch.sqrt(sum(g.square().sum() for g in grads))


@torch.no_grad()
def clip_adam_update_(params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]],
                      state: AdamState, lr: float, max_norm: float = 1.0, b1: float = 0.5,
                      b2: float = 0.999, eps: float = 1e-8) -> torch.Tensor:
    """``clip_by_global_norm(max_norm)`` then ``scale_by_adam(b1, b2, eps)``, then
    ``p + (-lr) * u``, in place; optax's formulas in its order. A gradient of
    None (a parameter the loss does not use) counts as zeros. Returns the
    pre-clip global norm."""
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    norm = global_norm(grads)
    keep = norm < max_norm  # no host sync: both branches are formed, as jax.lax.select does
    grads = [torch.where(keep, g, (g / norm) * max_norm) for g in grads]
    state.count += 1
    dev = norm.device
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=dev) ** state.count
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=dev) ** state.count
    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        m.copy_((1 - b1) * g + b1 * m)
        v.copy_((1 - b2) * (g * g) + b2 * v)
        u = (m / bc1) / (torch.sqrt(v / bc2 + 0.0) + eps)
        p.add_(u * (-lr))
    return norm


@torch.no_grad()
def ema_update_(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor], beta: float) -> None:
    """``e <- e * beta + (1 - beta) * p`` (reference utils.py:80-91)."""
    for e, p in zip(ema, params):
        e.copy_(e * beta + (1.0 - beta) * p)
