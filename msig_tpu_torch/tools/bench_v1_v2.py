"""v1 against v2 fused int8 sites: time per call of each, on one device.

    python -m msig_tpu_torch.tools.bench_v1_v2 [--batch 128] [--device cuda]

Port of the JAX package's ``tools/bench_v1_v2.py``: the resblock relu and
residual sites, and the decoder's up0 and up1 ConvT sites, each in its v1 form
(``ops/fused_conv_int8.py``: rows 19, 20, 21 of PERF.md's kernel table) and
its v2 form (``ops/fused_conv_int8_v2.py``: rows 1, 2 and, for the ConvT
sites, the 9-tap K-concat site of row 6), on the same seeded inputs at the
256² input's shapes: [B, 64, 64, 256] for the trunk sites, up0 [B, 64, 64,
256] -> [B, 128, 128, 128], up1 [B, 128, 128, 128] -> [B, 256, 256, 64].
Every kernel reads K-major weights; the tool makes each copy once
(``pack_weights_kmajor``, ``pack_convt_kcat_kmajor``) and passes it as
``w_kmajor``, as the served path passes its own. One pass calls each of the
eight once. On ``cuda`` the times are CUDA events
around ``--iters`` passes after ``--warmup``; ``--device cpu`` runs the plain
versions and times the host. There is no fallback from ``cuda``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from msig_tpu_torch import resolve_device
from msig_tpu_torch.ops import fused_conv_int8 as v1
from msig_tpu_torch.ops import fused_conv_int8_v2 as v2
from msig_tpu_torch.tools import counted, time_ms

KERNEL_MODS = (v1, v2)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=128, help="batch B (the JAX tool's B)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    return p


def _sites(b: int, dev: torch.device) -> Dict[str, object]:
    """site label -> call, on the JAX tool's seeded inputs (``bench_v1_v2.py:52-88``)."""
    rng = np.random.default_rng(0)
    c = 256

    def t(a):
        return torch.from_numpy(a).to(dev)

    x = t(rng.integers(-127, 128, (b, 64, 64, c), dtype=np.int8))
    w = rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8)
    gamma = t(rng.normal(1.0, 0.5, (b, c)).astype(np.float32))
    beta = t(rng.normal(0.0, 0.5, (b, c)).astype(np.float32))
    wp = v1.pack_weights(torch.from_numpy(w)).to(dev)
    hs = t(rng.random((b, 1)).astype(np.float32) + 0.5)
    wu0 = rng.integers(-16, 17, (4, 4, 256, 128), dtype=np.int8)
    wu0p = v1.pack_convt_weights(torch.from_numpy(wu0), 256, 128).to(dev)
    xb = t(rng.integers(-127, 128, (b, 128, 128, 128), dtype=np.int8))
    wu1 = rng.integers(-16, 17, (4, 4, 128, 64), dtype=np.int8)
    wu1p = v1.pack_convt_weights(torch.from_numpy(wu1), 128, 64).to(dev)
    wk = {"w_kmajor": v1.pack_weights_kmajor(wp)}
    wu0k = {"w_kmajor": v1.pack_convt_kcat_kmajor(wu0p)}
    wu1k = {"w_kmajor": v1.pack_convt_kcat_kmajor(wu1p)}
    return {
        "relu site   v1": lambda: v1.conv3x3_adain_relu_requant(x, wp, gamma, beta, **wk),
        "relu site   v2": lambda: v2.conv3x3_adain_relu_requant(x, wp, gamma, beta, **wk),
        "res site    v1": lambda: v1.conv3x3_adain_residual_requant(x, x, hs, wp, gamma, beta,
                                                                    **wk),
        "res site    v2": lambda: v2.conv3x3_adain_residual_requant(x, x, hs, wp, gamma, beta,
                                                                    **wk),
        "up0 site    v1": lambda: v1.convt4x4s2_in_relu_requant(x, wu0p, **wu0k),
        "up0 site    v2": lambda: v2.convt4x4s2_in_relu_requant(x, wu0p, **wu0k),
        "up1 site    v1": lambda: v1.convt4x4s2_in_relu_requant(xb, wu1p, **wu1k),
        "up1 site    v2": lambda: v2.convt4x4s2_in_relu_requant(xb, wu1p, **wu1k),
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Times per site; returns {"device", "batch", "calls" (warmup + iters: the
    calls of each site), "sites": {label: {"ms", "launches" (over all its
    calls, by kernel)}}}."""
    args = build_arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (plain versions)"
    print(f"bench_v1_v2: batch {args.batch} on {kind}; ms per call, mean of {args.iters} "
          f"calls after {args.warmup} ({'CUDA events' if dev.type == 'cuda' else 'host clock'})",
          flush=True)
    result: Dict[str, object] = dict(device=kind, batch=args.batch,
                                     calls=args.warmup + args.iters, sites={})
    with torch.inference_mode():
        for label, fn in _sites(args.batch, dev).items():
            (ms, _), launches = counted(lambda: time_ms(fn, dev, args.iters, args.warmup),
                                        KERNEL_MODS)
            result["sites"][label] = dict(ms=ms, launches=launches)
            print(f"{label}: {ms:7.2f} ms", flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
