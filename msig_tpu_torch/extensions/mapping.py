"""Mapping network: latent z -> the style code of a domain (extension).

Counterpart of ``msig_tpu/extensions/mapping.py``. Not in the reference, whose
style codes come only from the image encoder: a shared MLP on z
(``fc0..fc{num_layers-1}``, each followed by ReLU), then one dense layer of
every domain's head at once (``heads``, ``num_domains * style_dim`` outputs),
of which each sample takes its domain's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from msig_tpu_torch.models.layers import TorchDense


class MappingNetwork(nn.Module):
    def __init__(self, latent_dim: int = 16, style_dim: int = 256, num_domains: int = 2,
                 hidden_dim: int = 512, num_layers: int = 4):
        super().__init__()
        self.latent_dim, self.style_dim, self.num_domains = latent_dim, style_dim, num_domains
        self.num_layers = num_layers
        dims = [latent_dim] + [hidden_dim] * num_layers
        for i in range(num_layers):
            self.add_module(f"fc{i}", TorchDense(dims[i], dims[i + 1]))
        self.heads = TorchDense(hidden_dim, num_domains * style_dim)

    def forward(self, z: torch.Tensor, domain_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z [B, latent_dim] -> styles [B, style_dim]; ``domain_idx`` None takes head 0."""
        h = z
        for i in range(self.num_layers):
            h = torch.relu(getattr(self, f"fc{i}")(h))
        all_styles = self.heads(h).reshape(-1, self.num_domains, self.style_dim)
        if domain_idx is None:
            return all_styles[:, 0]
        rows = torch.arange(all_styles.shape[0], device=all_styles.device)
        return all_styles[rows, domain_idx.reshape(-1).to(torch.long)]
