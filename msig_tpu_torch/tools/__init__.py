"""Measurement tools of the port, each ``python -m msig_tpu_torch.tools.<name>``.

``bench_v1_v2`` and ``profile_fused_stages`` port the JAX package's
``tools/bench_v1_v2.py`` and ``tools/profile_fused_stages.py``. Both run on
``cuda`` unless ``--device cpu`` is given (then they run the kernels' plain
versions and time the host), and both expose ``main(argv)``, which returns
what they printed as a dictionary.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Sequence, Tuple

import torch


def time_ms(fn: Callable, device: torch.device, iters: int, warmup: int) -> Tuple[float, object]:
    """Mean ms per call of ``fn`` over ``iters`` calls after ``warmup`` calls, and
    the last call's result. On ``cuda`` by CUDA events around the timed calls;
    on ``cpu`` by the host clock."""
    out = None
    for _ in range(warmup):
        out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return 1e3 * (time.perf_counter() - t0) / iters, out


def counted(fn: Callable, mods: Sequence) -> Tuple[object, Dict[str, int]]:
    """Run ``fn``; return its result and the launches it added to the counters
    of the kernel modules ``mods``, by kernel."""
    before = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    out = fn()
    after = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    return out, {k: n - before[k] for k, n in after.items() if n != before[k]}
