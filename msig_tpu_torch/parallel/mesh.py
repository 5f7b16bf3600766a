"""Data parallelism of the port on ``torch.distributed``.

Counterpart of ``msig_tpu/parallel/mesh.py``. The JAX package drives a 1-D
``Mesh(('data',))`` from one process under GSPMD: the batch is split on the
leading axis, the state replicated, and XLA inserts the gradient all-reduce.
The port uses PyTorch's idioms for the same two jobs:

  - serving: one process holds a copy of the networks on each device of a
    list and runs each device's contiguous share of the batch there
    (``infer/engine.py``); :func:`data_mesh_for_batch` picks the list;
  - training: one process per device in a ``torch.distributed`` process group
    (:func:`initialize_multihost`). Every rank builds the same global batch
    and keeps its rows (:func:`shard_batch`); parameters and buffers start from
    rank 0's (:func:`replicate`); the step averages each phase's gradients and
    the metrics over the ranks (:func:`all_reduce_mean_`) and forms the
    batch-coupled Grams of the style loss over the global batch
    (:func:`gather_rows`).

``jit_train_step`` has no counterpart: its job (the state replicated, the
batch split, the gradient all-reduce) is the trainer's and the step's
(``train/trainer.py``, ``train/step.py``).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Dict, List, Mapping, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

logger = logging.getLogger(__name__)

DATA_AXIS = "data"

# The environment a launcher (torchrun, or the train CLI's own workers) sets for
# each rank; the rendezvous is ``env://`` on MASTER_ADDR:MASTER_PORT.
RENDEZVOUS_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
# How long a rank waits for the others before the group's start fails.
INIT_TIMEOUT = datetime.timedelta(seconds=300)

Devices = Sequence[Union[str, torch.device]]


def local_devices(device: str = "cuda") -> List[torch.device]:
    """Every visible CUDA device for ``"cuda"``; the one CPU device for ``"cpu"``."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(devices: Optional[Devices] = None) -> List[torch.device]:
    """The data-parallel device list: ``devices`` (default every visible CUDA device)."""
    if devices is None:
        return local_devices("cuda")
    return [torch.device(d) for d in devices]


def data_mesh_for_batch(batch_size: int,
                        devices: Optional[Devices] = None) -> Optional[List[torch.device]]:
    """The most devices of ``devices`` (default every visible CUDA device) that
    evenly divide ``batch_size``, the first ones; None if that is one device."""
    devs = make_mesh(devices)
    k = len(devs)
    while k > 1 and batch_size % k != 0:
        k -= 1
    if 1 < k < len(devs):
        logger.warning(
            "batch_size=%d is not divisible by %d devices; using %d devices "
            "(the rest stay idle). Pick a batch size divisible by the device "
            "count to use the whole slice.", batch_size, len(devs), k)
    return devs[:k] if k > 1 else None


def rendezvous_configured() -> bool:
    """Whether a launcher set this process's rank and the group's rendezvous."""
    return any(os.environ.get(k) for k in RENDEZVOUS_ENV)


def initialize_multihost(device: str = "cuda") -> bool:
    """Join the process group a launcher configured (``env://``): NCCL for
    ``cuda``, gloo for ``cpu``; on ``cuda`` this rank takes card ``LOCAL_RANK``.

    Without a rendezvous in the environment it logs and returns False (a
    single-process run). With one, a failure to start the group raises. Returns
    True when a group is initialised, also one started before this call."""
    if dist.is_initialized():
        return True
    if not rendezvous_configured():
        logger.info("torch.distributed not initialized (single-process run): none of %s is set",
                    ", ".join(RENDEZVOUS_ENV))
        return False
    missing = [k for k in RENDEZVOUS_ENV if not os.environ.get(k)]
    if missing:
        raise RuntimeError(f"incomplete rendezvous: {', '.join(missing)} not set")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://",
                            timeout=INIT_TIMEOUT)
    logger.info("process group up: rank %d of %d (%s)", dist.get_rank(),
                dist.get_world_size(), dist.get_backend())
    return True


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> tuple:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if _grouped():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rank() -> int:
    """This process's rank on its host (the launcher's ``LOCAL_RANK``); 0 without a group."""
    return int(os.environ.get("LOCAL_RANK", "0")) if _grouped() else 0


def batch_rows(n: int, rank: int, world_size: int) -> slice:
    """Rank ``rank``'s contiguous share of ``n`` rows; ``world_size`` must divide ``n``."""
    if n % world_size:
        raise ValueError(f"a global batch of {n} rows does not split over {world_size} ranks")
    per = n // world_size
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch: Mapping[str, object], rank: Optional[int] = None,
                world_size: Optional[int] = None) -> Dict[str, object]:
    """This rank's rows of every array of a global host batch (default: the
    default group's rank and size)."""
    if rank is None or world_size is None:
        rank, world_size = world()
    return {k: v[batch_rows(v.shape[0], rank, world_size)] for k, v in batch.items()}


def _tensors(x: Union[nn.Module, Sequence[torch.Tensor]]) -> List[torch.Tensor]:
    if isinstance(x, nn.Module):
        return [*x.parameters(), *x.buffers()]
    return list(x)


@torch.no_grad()
def replicate(x: Union[nn.Module, Sequence[torch.Tensor]]) -> None:
    """Give every rank rank 0's values of a module's parameters and buffers (or
    of a list of tensors), in place. No-op without a process group."""
    if not _grouped():
        return
    for t in _tensors(x):
        dist.broadcast(t.data, 0)


@torch.no_grad()
def replicated(x: Union[nn.Module, Sequence[torch.Tensor]]) -> bool:
    """Whether every rank holds the same bits as rank 0 in each tensor of ``x``."""
    if not _grouped():
        return True
    ts = _tensors(x)
    same = torch.ones((), dtype=torch.float32, device=ts[0].device if ts else "cpu")
    for t in ts:
        ref = t.detach().clone()
        dist.broadcast(ref, 0)
        same = same * torch.equal(ref, t.detach())
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same)


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place, with one
    all-reduce of one flat fp32 bucket (also in a group of one rank). No-op
    without a process group."""
    if not _grouped() or not tensors:
        return
    n = world()[1]
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat)
    flat /= n
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0; the backward needs no collective: every rank
    forms the same loss from the same gathered rows, so the sum over ranks of
    their gradients for this rank's rows (an all-gather's backward) is the
    world size times this rank's own."""

    @staticmethod
    def forward(ctx, x):
        rank, n = world()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = batch_rows(x.shape[0] * n, rank, n)
        ctx.world = n
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows] * ctx.world


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in rank order (differentiable);
    ``x`` itself without a process group. Each rank's gradient for its own rows
    is scaled so that :func:`all_reduce_mean_` of the parameter gradients gives
    the gradient of a loss of the gathered rows."""
    if not _grouped():
        return x
    return _GatherRows.apply(x)
