"""Whether a train step gives the same bits twice: what step 1 leaves behind,
kept by kind and compared to the bit.

  - :func:`record_grads`: within a ``with`` block, every gradient list that the
    train step hands to clip + Adam (the G group's, then the D group's) is kept,
    cloned, as it arrives (the averaged gradients in a data-parallel step);
  - :func:`snapshot`: the state's parameters, those gradients, both Adam
    moments and the EMA copies, each with its name, cloned;
  - :func:`differences`: two snapshots compared element by element on their
    bit patterns (so -0 differs from +0, and a NaN equals itself).

The JAX step is a pure function, so two runs of it from one state agree to the
bit; ``chip_smoke.py``, ``tools/train_step_determinism_torch.py`` and the
tests hold the port's step to the same.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

from msig_tpu_torch.train.state import D_KEYS, G_KEYS, TrainState

Snapshot = Dict[str, List[Tuple[str, torch.Tensor]]]
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@contextlib.contextmanager
def record_grads() -> Iterator[List[torch.Tensor]]:
    """Keep a clone of each gradient that clip + Adam receive (None as zeros)."""
    from msig_tpu_torch.train import step as step_mod

    real, kept = step_mod.clip_adam_update_, []

    def keep(params, grads, *args, **kwargs):
        kept.extend(torch.zeros_like(p) if g is None else g.detach().clone()
                    for p, g in zip(params, grads))
        return real(params, grads, *args, **kwargs)

    step_mod.clip_adam_update_ = keep
    try:
        yield kept
    finally:
        step_mod.clip_adam_update_ = real


def snapshot(state: TrainState, grads: Sequence[torch.Tensor] = ()) -> Snapshot:
    """The state's tensors by kind, cloned, each named ``net.parameter`` in the
    optimizers' order (the G group, then the D group); ``gradients`` only when
    ``grads`` is given."""
    models = state.models
    names = [f"{k}.{n}" for k in G_KEYS + D_KEYS for n, _ in models.nets[k].named_parameters()]

    def kind(tensors):
        return [(n, t.detach().clone()) for n, t in zip(names, tensors)]

    out = {"parameters": kind(p for k in G_KEYS + D_KEYS for p in models.nets[k].parameters()),
           "first moments": kind(state.opt_g.mu + state.opt_d.mu),
           "second moments": kind(state.opt_g.nu + state.opt_d.nu),
           "EMA": [(f"ema.{k}.{n}", t.detach().clone()) for k in G_KEYS
                   for n, t in models.ema[k].named_parameters()]}
    if grads:
        if len(grads) != len(names):
            raise ValueError(f"{len(grads)} gradients for {len(names)} parameters")
        out["gradients"] = kind(grads)
    return out


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shape, dtype and bit pattern."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    bits = _BITS[a.element_size()]
    return torch.equal(a.contiguous().view(bits), b.contiguous().view(bits))


def differences(a: Snapshot, b: Snapshot) -> Tuple[int, Dict[str, List[str]]]:
    """(tensors compared, {kind: names of the tensors whose bits differ})."""
    if a.keys() != b.keys():
        raise ValueError(f"snapshots of different kinds: {sorted(a)} vs {sorted(b)}")
    compared, differ = 0, {}
    for kind, items in a.items():
        other = dict(b[kind])
        differ[kind] = [n for n, t in items if not bits_equal(t, other[n])]
        compared += len(items)
    return compared, differ
