"""Per-stage timing of the int8 generator on its fused sites, at 256².

    python -m msig_tpu_torch.tools.profile_fused_stages [--batch 128] [--device cuda]

Port of the JAX package's ``tools/profile_fused_stages.py``, on a seeded random
generator at full width (style_dim 256, 8 resblocks; torch's own init under
seed ``SEED``: the JAX tool's flax init cannot be reproduced without JAX, so
these are timings, not a parity check) quantized by
``infer.quantized.quantize_generator_params``. Stages, as the JAX tool runs
them:

* ``encoder (3 convs)``: the unfused int8 encoder (``_xla_encoder``);
* ``fused trunk (16 sites)``: ``_fused_trunk``, the 8 resblocks' conv1 and
  conv2 kernel sites;
* ``  conv1 site alone`` and ``  conv2 site alone``: the v1 sites
  (``ops/fused_conv_int8.py``) on resblock 0's weights and AdaIN affines,
  conv1 on the requantized encoder output, conv2 on conv1's output with that
  map as the residual (the JAX tool passes adain1's affine to both; here
  conv2 takes adain2's);
* ``fused decoder (2 ups+final)``: ``_fused_decoder`` with bf16 output (the
  phase-split up0 and up1 sites and the unfused final conv);
* ``  up0 kernel alone`` and ``  up1 kernel alone``: the v1 ConvT site on the
  9-tap K-concat packing of dec_up0, then of dec_up1 on up0's output;
* ``full (one program)``: encoder, fused trunk and fused decoder in turn.

The v1 sites get their kernels' K-major weights as ``w_kmajor``, made once:
the quantization's ``res0_conv{1,2}_pk`` and ``pack_convt_kcat_kmajor`` of
the K-concat packings.

Each stage is called ``--warmup`` + ``--iters`` times; on ``cuda`` its time is
CUDA events around the last ``--iters``; ``--device cpu`` runs the kernels'
plain versions and times the host. There is no fallback from ``cuda``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from msig_tpu_torch import resolve_device
from msig_tpu_torch.infer import quantized as tq
from msig_tpu_torch.models import StyleCycleGANGenerator
from msig_tpu_torch.ops import fused_conv_int8 as v1
from msig_tpu_torch.ops import fused_conv_int8_v2 as fc
from msig_tpu_torch.ops import fused_dec_int8 as fd
from msig_tpu_torch.ops import fused_enc_int8 as fe
from msig_tpu_torch.ops import fused_trunk_v3 as f3
from msig_tpu_torch.ops import int8_epilogue as ep
from msig_tpu_torch.ops import int8_epilogue_chunked as ec
from msig_tpu_torch.tools import counted, time_ms

STYLE_DIM, N_RES, SIDE = 256, 8, 256
SEED = 0  # of the generator's init
KERNEL_MODS = (v1, fc, fd, fe, f3, ec, ep)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=128, help="batch B (the JAX tool's B)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    return p


def quantized_params(device: torch.device):
    """int8 weights of a seeded random generator at full width, on ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        gen = StyleCycleGANGenerator(style_dim=STYLE_DIM, n_residual_blocks=N_RES)
    q = tq.quantize_generator_params(gen.state_dict(), N_RES)
    return {k: v.to(device) for k, v in q.items()}


def _convt_kcat(q, name: str) -> torch.Tensor:
    """The v1 operand of a ConvT: ``q[name]`` (int8 OIHW of the forward conv)
    packed [9*Cin, 4*Cout] (``profile_fused_stages.py:201-202``)."""
    w_hwio = q[name].permute(2, 3, 1, 0)
    return v1.pack_convt_weights(w_hwio, *w_hwio.shape[2:])


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Times per stage; returns {"device", "batch", "calls" (warmup + iters: the
    calls of each stage), "stages": {name: {"ms", "launches" (over all its
    calls, by kernel)}}, "sum_ms"}."""
    args = build_arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    b = args.batch
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (plain versions)"
    q = quantized_params(dev)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 256, (b, SIDE, SIDE, 3), dtype=np.uint8)).to(dev)
    style = torch.from_numpy(rng.normal(0, 1, (b, STYLE_DIM)).astype(np.float32)).to(dev)
    gammas, betas = tq._style_affines(q, style, N_RES)
    up0_p, up1_p = _convt_kcat(q, "dec_up0"), _convt_kcat(q, "dec_up1")
    # the kernels' K-major copies, made once as the served path's are
    up0_k = {"w_kmajor": v1.pack_convt_kcat_kmajor(up0_p)}
    up1_k = {"w_kmajor": v1.pack_convt_kcat_kmajor(up1_p)}
    print(f"profile_fused_stages: int8 generator (style_dim {STYLE_DIM}, {N_RES} resblocks, "
          f"seed {SEED}), batch {b} at {SIDE}² on {kind}; ms per call, mean of "
          f"{args.iters} calls after {args.warmup} "
          f"({'CUDA events' if dev.type == 'cuda' else 'host clock'})", flush=True)

    # Each stage's inputs are the outputs of a stage before it.
    held: Dict[str, object] = {}

    def conv1():
        hq0, inv_s = tq._requant_with_inv_scale(held["h0"])
        held["hq0"], held["hs0"] = hq0, inv_s.reshape(b, 1).to(torch.float32)
        return v1.conv3x3_adain_relu_requant(hq0, q["res0_conv1_p"], gammas[0], betas[0],
                                             w_kmajor=q.get("res0_conv1_pk"))

    def full():
        h = tq._xla_encoder(q, img)
        return tq._fused_decoder(q, tq._fused_trunk(q, h, style, N_RES), torch.bfloat16)

    stages = [
        ("encoder (3 convs)", "h0", lambda: tq._xla_encoder(q, img)),
        ("fused trunk (16 sites)", "hq", lambda: tq._fused_trunk(q, held["h0"], style, N_RES)),
        ("  conv1 site alone", "y1", conv1),
        ("  conv2 site alone", None, lambda: v1.conv3x3_adain_residual_requant(
            held["y1"], held["hq0"], held["hs0"], q["res0_conv2_p"], gammas[1], betas[1],
            w_kmajor=q.get("res0_conv2_pk"))),
        ("fused decoder (2 ups+final)", None,
         lambda: tq._fused_decoder(q, held["hq"], torch.bfloat16)),
        ("  up0 kernel alone", "y0",
         lambda: v1.convt4x4s2_in_relu_requant(held["hq"], up0_p, **up0_k)[0]),
        ("  up1 kernel alone", None,
         lambda: v1.convt4x4s2_in_relu_requant(held["y0"], up1_p, **up1_k)),
        ("full (one program)", None, full),
    ]
    result: Dict[str, object] = dict(device=kind, batch=b, calls=args.warmup + args.iters,
                                     stages={})
    total = 0.0
    with torch.inference_mode():
        for name, keep, fn in stages:
            (ms, out), launches = counted(lambda: time_ms(fn, dev, args.iters, args.warmup),
                                          KERNEL_MODS)
            if keep:
                held[keep] = out
            if not name.startswith(("  ", "full")):
                total += ms
            result["stages"][name] = dict(ms=ms, launches=launches)
            print(f"{name:30s}: {ms:7.2f} ms  ({1000 * ms / b:7.1f} us/img)", flush=True)
    result["sum_ms"] = total
    print(f"{'sum of stages':30s}: {total:7.2f} ms -> {b / total * 1000:.0f} img/s", flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
