"""msig_tpu_torch — the PyTorch / CUDA (H100) port of msig_tpu.

A package beside ``msig_tpu`` with the same layout; it imports torch, never
JAX and nothing of ``msig_tpu``. Plain tensor code is PyTorch; the TPU's
Pallas kernels become CUDA kernels under ``csrc/`` (see ``ops/``). Entry
points run on ``cuda`` unless the caller asks for ``cpu``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
