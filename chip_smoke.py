#!/usr/bin/env python3
"""Smoke run of msig_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. build: compiles the thirteen CUDA sources of the serving and training paths
   from ``msig_tpu_torch/csrc`` (one nvcc per source, all at once) and prints
   the card's name and power limit as nvidia-smi reports them;
2. kernels: each of the fifteen kernel sites against its plain PyTorch version
   on the card, with seeded random inputs, batch 8. At the shapes of a 256²
   input: enc0 uint8 [8, 256, 256, 3] -> [8, 256, 256, 64], enc1 ->
   [8, 128, 128, 128], enc2 -> [8, 64, 64, 256], the four trunk sites (conv1,
   and conv2 with its int8, bf16 and two-plane residual carries) at
   [8, 64, 64, 256], up0 -> [8, 128, 128, 128], up1 -> [8, 256, 256, 64],
   final7 -> [8, 256, 256, 3], and the three sites of the opt-in compositions:
   ``fused_trunk_blocks`` (all 8 resblocks in one launch) at [8, 64, 64, 256],
   ``enc1_in_relu_requant_im2col`` at enc1's shapes (and equal to enc1's
   kernel to the bit), ``adain_relu_requant_chunked`` at [8, 4096, 256] int32.
   At the shapes of a 512² input: the staged
   sites enc0_hbm [8, 512, 512, 3] and up1_s2d16_hbm [8, 256, 256, 128] ->
   [8, 512, 512, 64], each staged as int32 and as fp16 (held against the
   plain version that narrows the same way), and every other site at its map
   of four times the pixels. Bars: int8 outputs at most 1 step apart on under
   1% of the elements, scales within rtol 1e-5, the bf16 carry at most 1 ulp
   on under 1%, uint8 at most 1 apart on under 1e-3; times by CUDA events;
3. end to end, ``msig_tpu_torch.inference.main`` on ``cuda`` with
   ``--quantize int8``, the committed demo checkpoint (10 domains, 8
   resblocks, style_dim 256), batch 8, over 20 seeded inputs, the launch
   counts set to 0 before each run and read after it:
   at 256² with ``MSIG_TRUNK_HIFI`` 0, 1 and 2: one output per input, each
   encoder and decoder site launched once per batch, conv1 and the mode's
   conv2 site 8 times, no other site at all, and the int8 output's PSNR
   against the port's fp32 float path on the same inputs and style at least
   30 dB; the generators' steady-state time per batch in each mode and the
   int8 generator's stages;
   at 256² with ``MSIG_TRUNK_V3=1`` (``256/v3``: one ``fused_trunk_blocks``
   launch per batch in place of the 16 trunk calls) and with
   ``MSIG_ENC1_IM2COL=1`` (``256/enc1_im2col``: the dense enc1 in place of
   enc1, the served images equal to ``256/hifi0``'s), each at least 30 dB
   from the fp32 path; ``quantized_generator_apply(..., fused_trunk=False,
   fused_epilogue=True)`` (``256/unfused+epilogue``: 8 launches of
   ``adain_relu_requant_chunked`` per batch and no other kernel site), its
   PSNR printed; time per batch of each and of the trunk alone under v3;
   at 512²: enc0_hbm, enc1, enc2, 8 + 8 trunk calls, up0, up1_s2d16_hbm and
   final7 per batch; the all-kernel uint8 output and the port's
   ``pallas=("trunk",)`` float output against each other and against the fp32
   path (the all-kernel chain no more than 0.5 dB farther from fp32 than the
   unfused one), and against each other at least 35 dB on seeded random
   weights with 2 resblocks and a noise image (the configuration in which the
   JAX package's tests hold that bar); time per batch and per stage, with
   both stagings;
4. train kernels: the four training kernels (the fused AdaIN forward and
   backward, ``conv3x3_bwd`` and ``conv3x3_adain_bwd``, each with and without
   the relu input) against their plain versions at the trunk shapes of a 256²
   train step, [8, 64, 64, 256] and [4, 64, 64, 256], fp32 with TF32 off.
   Bars: every output within rtol 1e-4 and atol 1e-5 x max|plain|; dgamma and
   dbeta within rtol 1e-5 and atol 1e-6 x max|plain|; dx exactly 0 under the
   relu mask; a second call gives bit-identical dW. Times by CUDA events, and
   for ``conv3x3_bwd`` cuDNN's ``convolution_backward`` (dx and dW) beside it;
5. train: ``make_train_step`` at full width (256², batch 4, 8 resblocks,
   style_dim 256, 10 domains, a seeded random VGG) from the same parameters
   and batch in three configurations: stock autograd (``MSIG_CONV_VJP=0``),
   ``MSIG_CONV_VJP=1`` with ``use_pallas`` and ``MSIG_CONV_VJP=2``. Step 1's
   losses agree within rtol 1e-4 and its pre-clip grad norms within 1e-3
   across the three; each configuration launches each of its kernels 48 times
   a step and no other kernel; 5 more steps stay finite; ms per step, median of
   5 after a warm-up step, by CUDA events, with cuDNN held to its
   deterministic algorithms as the Trainer holds it. Then ``python -m
   msig_tpu_torch.train --device cuda --allow_random_vgg --epochs 1`` on a
   synthetic tree of 8 sources and 9 target domains, and
   ``python -m msig_tpu_torch.inference --quantize int8`` on the checkpoint it
   wrote (``MSIG_SKIP_EPOCH_ART=1`` where matplotlib is missing);
6. a ``{"kernels": [...]}`` line of the nineteen kernels, then the card line,
   then the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero without the last line. It
also exits non-zero when no CUDA device is visible, and outside a checkout of
the repository (the port is imported from beside this file).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEMO = os.path.join(ROOT, "results", "tomato_r3b", "demo_checkpoint")

# NVIDIA H100 SXM data sheet, dense: int8 tensor cores, fp32 outside them, HBM3.
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

B, SIDE, C = 8, 64, 256            # trunk shape of the main path: 256² input, batch 8
TRAIN_B, N_DOMAINS = 4, 10         # train step: batch 4 (the default), 10 domains, full width
TRAIN_SIZE = 256
TRAIN_CONFIGS = (("stock", "0", False), ("level1+pallas", "1", True), ("level2", "2", False))
TRAIN_STEPS = 5                    # timed steps per configuration, after step 1 and a warm-up
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4  # step-1 gradients: rtol, atol x max|reference| of the group
FT, FV = "msig_tpu/ops/adain_pallas.py", "msig_tpu/ops/conv3x3_vjp.py"
# training kernel -> (TPU kernel it replaces, CUDA source, the train configuration that runs it)
TRAIN_KERNELS = {
    "adain_pallas_fwd": (f"{FT}:93", "adain_pallas.cu", "level1+pallas"),
    "adain_pallas_bwd": (f"{FT}:111", "adain_pallas.cu", "level1+pallas"),
    "conv3x3_bwd": (f"{FV}:145", "conv3x3_bwd.cu", "level1+pallas"),
    "conv3x3_adain_bwd": (f"{FV}:303", "conv3x3_adain_bwd.cu", "level2"),
}
N_RES = 8                          # resblocks of the demo checkpoint
N_INPUTS, TARGET = 20, "dom3"     # 3 batches of 8, the last one padded
FE, FC, FD = "msig_tpu/ops/fused_enc_int8.py", "msig_tpu/ops/fused_conv_int8_v2.py", \
    "msig_tpu/ops/fused_dec_int8.py"
# kernel site -> (TPU kernel it replaces, CUDA source, the path whose launches the JSON line reports)
SITES = {
    "enc0_in_relu_requant": (f"{FE}:606", "enc0_in_relu_requant.cu", "256/hifi0"),
    "enc0_hbm": (f"{FE}:520", "enc0_in_relu_requant.cu", "512"),
    "enc1_in_relu_requant": (f"{FE}:623", "conv4x4s2_in_relu_requant.cu", "256/hifi0"),
    "enc2_in_relu_requant": (f"{FE}:643", "conv4x4s2_in_relu_requant.cu", "256/hifi0"),
    "conv3x3_adain_relu_requant": (f"{FC}:351", "conv3x3_adain_relu_requant.cu", "256/hifi0"),
    "conv3x3_adain_residual_requant": (f"{FC}:386", "conv3x3_adain_residual_requant.cu",
                                       "256/hifi0"),
    "conv3x3_adain_residual_hifi": (f"{FC}:423", "conv3x3_adain_residual_hifi.cu", "256/hifi1"),
    "conv3x3_adain_residual_hifi2": (f"{FC}:464", "conv3x3_adain_residual_hifi2.cu", "256/hifi2"),
    "convt4x4s2_in_relu_requant_ps": (f"{FC}:653", "convt4x4s2_in_relu_requant.cu", "256/hifi0"),
    "up1_s2d16": (f"{FD}:237", "convt4x4s2_in_relu_requant.cu", "256/hifi0"),
    "up1_s2d16_hbm": (f"{FD}:384", "convt4x4s2_in_relu_requant.cu", "512"),
    "final7_tanh_u8": (f"{FD}:612", "final7_tanh_u8.cu", "256/hifi0"),
    "fused_trunk_blocks": ("msig_tpu/ops/fused_trunk_v3.py:175", "fused_trunk_blocks.cu",
                           "256/v3"),
    "enc1_in_relu_requant_im2col": (f"{FE}:631", "conv4x4s2_in_relu_requant.cu",
                                    "256/enc1_im2col"),
    "adain_relu_requant_chunked": ("msig_tpu/ops/int8_epilogue_chunked.py:97",
                                   "adain_relu_requant_chunked.cu", "256/unfused+epilogue"),
}
_COMMON = {"enc1_in_relu_requant": 1, "enc2_in_relu_requant": 1,
           "conv3x3_adain_relu_requant": N_RES, "convt4x4s2_in_relu_requant_ps": 1,
           "final7_tanh_u8": 1}
_AT_256 = {**_COMMON, "enc0_in_relu_requant": 1, "up1_s2d16": 1}
# path -> launches per batch of every site it runs; every other site must count 0
PATHS = {
    "256/hifi0": {**_AT_256, "conv3x3_adain_residual_requant": N_RES},
    "256/hifi1": {**_AT_256, "conv3x3_adain_residual_hifi": N_RES},
    "256/hifi2": {**_AT_256, "conv3x3_adain_residual_hifi2": N_RES},
    "512": {**_COMMON, "enc0_hbm": 1, "up1_s2d16_hbm": 1, "conv3x3_adain_residual_requant": N_RES},
    "256/v3": {"enc0_in_relu_requant": 1, "enc1_in_relu_requant": 1, "enc2_in_relu_requant": 1,
               "fused_trunk_blocks": 1, "convt4x4s2_in_relu_requant_ps": 1, "up1_s2d16": 1,
               "final7_tanh_u8": 1},
    "256/enc1_im2col": {**_AT_256, "enc1_in_relu_requant": 0, "enc1_in_relu_requant_im2col": 1,
                        "conv3x3_adain_residual_requant": N_RES},
    "256/unfused+epilogue": {"adain_relu_requant_chunked": N_RES},
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Median of ``reps`` per-call times by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(kind: str, b: int, side: int, cin: int) -> tuple:
    """(bound_ms, bound_by) for one call of a site of ``kind`` on a [b, side, side, cin] input.

    Bytes: each input read once, each output written once. Operations: the
    int8 multiply-adds of the conv (2 ops each) at the int8 tensor rate, plus
    the fp32 work per output element at the fp32 rate: statistics (3), and
    affine + ReLU + clip + round (5) at the relu, ConvT and encoder sites; at
    the conv2 sites hn (4; 6 with two planes) + max|hn| (2) + scale, clip,
    round (4), + the bf16 rounding (1) or the second plane (5); at final7,
    dequant, bias, tanh (counted as 20), scale, round, clip (26). The whole
    trunk (``trunk_v3``): N_RES blocks of a relu and a residual site, its int8
    map and scale read and written once, all 2*N_RES weights and affines read
    once. The chunked epilogue (``epilogue``, side = S rows): int32 in, int8
    out, statistics and affine + ReLU + requant (8 per element)."""
    px = b * side * side
    if kind == "trunk_v3":
        out = px * cin
        int8_ops = N_RES * 2 * (2 * out * 9 * cin)
        nbytes = (2 * out + 2 * N_RES * (9 * cin * cin + 2 * b * cin * 4) + 2 * b * 4)
        fp_ops = N_RES * (8 + 13) * out
        t_ops = int8_ops / PEAK_INT8_OPS + fp_ops / PEAK_FP32_FLOPS
        t_bytes = nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    if kind == "epilogue":
        out = b * side * cin
        nbytes, fp_ops = 5 * out + 2 * b * cin * 4, 8 * out
        t_ops, t_bytes = fp_ops / PEAK_FP32_FLOPS, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    if kind in ("relu", "residual", "hifi", "hifi2"):
        out = px * cin
        int8_ops = 2 * out * 9 * cin
        # bytes per element in and out, fp32 operations per element
        per_elem, fp = {"relu": (2, 8), "residual": (3, 13), "hifi": (6, 14),
                        "hifi2": (5, 20)}[kind]
        nbytes, fp_ops = per_elem * out + 9 * cin * cin + 2 * b * cin * 4 + 2 * b * 4, fp * out
    elif kind == "convt":
        cout = cin // 2
        out = 4 * px * cout
        int8_ops = 2 * out * 4 * cin
        nbytes, fp_ops = px * cin + 16 * cin * cout + out + b * 4, 8 * out
    elif kind == "enc0":
        out = px * 64
        int8_ops = 2 * out * 147
        nbytes, fp_ops = px * 3 + 160 * 64 + out, 8 * out
    elif kind == "conv4x4s2":
        cout = 2 * cin
        out = px // 4 * cout
        int8_ops = 2 * out * 16 * cin
        nbytes, fp_ops = px * cin + 16 * cin * cout + out + b * 4, 8 * out
    else:
        out = px * 3
        int8_ops = 2 * out * 49 * 64
        nbytes, fp_ops = px * 64 + 3 * 64 * 49 + 2 * 3 * 4 + b * 4 + out, 26 * out
    t_ops = int8_ops / PEAK_INT8_OPS + fp_ops / PEAK_FP32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bf16_ulps(torch, a, b):
    """Distance of two bf16 tensors in units of the last place (+0 and -0 coincide)."""
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits >= 0, bits, -(bits & 0x7FFF))
    return (ordered(a) - ordered(b)).abs()


def compare(torch, name: str, got, want) -> tuple:
    """Hold a site's outputs against its plain version's; returns (max int step, report)."""
    got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple)
                                                               else (want,))
    check(len(got) == len(want), f"{name} returns {len(got)} outputs, plain {len(want)}")
    max_step, report = 0, []
    for k, (g, w) in enumerate(zip(got, want)):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name} output {k} {g.dtype} {tuple(g.shape)} vs {w.dtype} {tuple(w.shape)}")
        if g.dtype == torch.float32:
            check(torch.allclose(g, w, rtol=1e-5, atol=0), f"{name} scale rtol 1e-5")
            report.append(f"scale rel err {float(((g - w).abs() / w.abs()).max()):.1e}")
            continue
        if g.dtype == torch.bfloat16:
            diff, unit, limit = bf16_ulps(torch, g, w), "ulp", 0.01
        else:
            diff = (g.to(torch.int32) - w.to(torch.int32)).abs()
            unit, limit = "step", (1e-3 if g.dtype == torch.uint8 else 0.01)
            max_step = max(max_step, int(diff.max()))
        worst, frac = int(diff.max()), float((diff > 0).float().mean())
        check(worst <= 1, f"{name} output {k} max {unit} {worst} <= 1")
        check(frac < limit, f"{name} output {k} differing share {frac} < {limit}")
        report.append(f"{str(g.dtype)[6:]} {tuple(g.shape)} max {unit} {worst}, "
                      f"differing {frac:.2e}")
    return max_step, "; ".join(report)


def kernel_cases(torch, fc, fd, fe, f3, ec, dev):
    """(site, label, kind, (b, side, cin), make) per case; ``make()`` builds the
    inputs on the card and returns (kernel call, plain call). The first case
    of a site is the one the JSON line reports."""
    def t(a):
        return torch.from_numpy(a).to(dev)

    def trunk(kind, side):
        def make():
            rng = np.random.default_rng(side)
            shape = (B, side, side, C)
            x = t(rng.integers(-127, 128, shape, dtype=np.int8))
            w = fc.pack_weights(torch.from_numpy(
                rng.integers(-32, 33, (3, 3, C, C), dtype=np.int8))).to(dev)
            gamma = t(rng.normal(1.0, 0.5, (B, C)).astype(np.float32))
            beta = t(rng.normal(0.0, 0.5, (B, C)).astype(np.float32))
            h = t(rng.normal(0, 1.5, shape).astype(np.float32))
            hs = h.abs().amax(dim=(1, 2, 3)).reshape(B, 1) / 127.0
            ht = h / hs.reshape(B, 1, 1, 1)
            hq = torch.clamp(torch.round(ht), -127, 127)
            h2 = torch.clamp(torch.round((ht - hq) * 254.0), -127, 127).to(torch.int8)
            hq = hq.to(torch.int8)
            tail = (w, gamma, beta)
            args = {"relu": (x, *tail), "residual": (x, hq, hs, *tail),
                    "hifi": (x, h.to(torch.bfloat16), *tail),
                    "hifi2": (x, hq, h2, hs, *tail)}[kind]
            fn = {"relu": "conv3x3_adain_relu_requant", "residual": "conv3x3_adain_residual_requant",
                  "hifi": "conv3x3_adain_residual_hifi", "hifi2": "conv3x3_adain_residual_hifi2"}[kind]
            return (lambda: getattr(fc, fn)(*args)), (lambda: getattr(fc, fn + "_plain")(*args))
        return make

    def convt(fn, plain, side, cin, **kw):
        def make():
            rng = np.random.default_rng(side + cin)
            lo = -127 if cin == C else 0      # up1 reads ReLU outputs
            x = t(rng.integers(lo, 128, (B, side, side, cin), dtype=np.int8))
            w = fc.pack_convt_weights_ps(torch.from_numpy(
                rng.integers(-127, 128, (4, 4, cin, cin // 2), dtype=np.int8)), cin, cin // 2).to(dev)
            return (lambda: fn(x, w, **kw)), (lambda: plain(x, w, **kw))
        return make

    def enc0(fn, plain, side, **kw):
        def make():
            rng = np.random.default_rng(side)
            img = t(rng.integers(0, 256, (B, side, side, 3), dtype=np.uint8))
            w = fe.pack_enc0(torch.from_numpy(
                rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8))).to(dev)
            return (lambda: fn(img, w, **kw)), (lambda: plain(img, w, **kw))
        return make

    def conv4x4s2(fn, plain, side, cin):
        def make():
            rng = np.random.default_rng(side + cin)
            x = t(rng.integers(0, 128, (B, side, side, cin), dtype=np.int8))
            w = fe.pack_conv4x4(torch.from_numpy(
                rng.integers(-127, 128, (4, 4, cin, 2 * cin), dtype=np.int8))).to(dev)
            return (lambda: fn(x, w)), (lambda: plain(x, w))
        return make

    def final7(side):
        def make():
            # The scales put y * wscale * inv_s around +-1.5, across the tanh.
            rng = np.random.default_rng(side)
            args = (t(rng.integers(0, 128, (B, side, side, 64), dtype=np.int8)),
                    t(rng.integers(-127, 128, (3, 64, 7, 7), dtype=np.int8)),
                    t(rng.uniform(1e-4, 2e-4, 3).astype(np.float32)),
                    t(rng.uniform(-0.3, 0.3, 3).astype(np.float32)),
                    t(rng.uniform(0.02, 0.05, (B, 1)).astype(np.float32)))
            return (lambda: fd.final7_tanh_u8(*args)), (lambda: fd.final7_tanh_u8_plain(*args))
        return make

    def trunk_v3():
        def make():
            rng = np.random.default_rng(SIDE + 1)
            x = t(rng.integers(-127, 128, (B, SIDE, SIDE, C), dtype=np.int8))
            w = torch.cat([fc.pack_weights(torch.from_numpy(
                rng.integers(-32, 33, (3, 3, C, C), dtype=np.int8))) for _ in range(2 * N_RES)])
            args = (x, t(rng.uniform(0.5, 2.0, (B, 1)).astype(np.float32)), w.to(dev),
                    t(rng.normal(1.0, 0.5, (B, 2 * N_RES, C)).astype(np.float32)),
                    t(rng.normal(0.0, 0.5, (B, 2 * N_RES, C)).astype(np.float32)), N_RES)
            first = f3.fused_trunk_blocks(*args)
            again = f3.fused_trunk_blocks(*args)
            check(all(torch.equal(a, b) for a, b in zip(first, again)),
                  "fused_trunk_blocks: a second call gives the same bits")
            print(f"[kernel] fused_trunk_blocks: two calls bit-identical; cooperative grid of "
                  f"{f3.LAST_GRID[f3.SITE]} CTAs", flush=True)
            return (lambda: f3.fused_trunk_blocks(*args)), (lambda: f3.fused_trunk_blocks_plain(*args))
        return make

    def enc1_im2col(side):
        def make():
            rng = np.random.default_rng(side + 64)
            x = t(rng.integers(0, 128, (B, side, side, 64), dtype=np.int8))
            w = torch.from_numpy(rng.integers(-127, 128, (4, 4, 64, 128), dtype=np.int8))
            w4, w1 = fe.pack_enc1_im2col(w).to(dev), fe.pack_conv4x4(w).to(dev)
            check(torch.equal(fe.enc1_in_relu_requant_im2col(x, w4),
                              fe.enc1_in_relu_requant(x, w1)),
                  "enc1_in_relu_requant_im2col equals enc1_in_relu_requant to the bit")
            print("[kernel] enc1_in_relu_requant_im2col: equal to enc1_in_relu_requant's kernel "
                  "to the bit", flush=True)
            return (lambda: fe.enc1_in_relu_requant_im2col(x, w4)), \
                (lambda: fe.enc1_in_relu_requant_im2col_plain(x, w4))
        return make

    def epilogue():
        def make():
            # int32 of the size of a trunk conv's outputs (|y| < 2^20)
            rng = np.random.default_rng(7)
            args = (t(rng.integers(-2 ** 20, 2 ** 20, (B, SIDE * SIDE, C), dtype=np.int32)),
                    t(rng.normal(1.0, 0.5, (B, C)).astype(np.float32)),
                    t(rng.normal(0.0, 0.5, (B, C)).astype(np.float32)))
            return (lambda: ec.adain_relu_requant_chunked(*args)), \
                (lambda: ec.adain_relu_requant_chunked_plain(*args))
        return make

    cases = []
    for grid, label in ((SIDE, "256² input"), (2 * SIDE, "512² input")):
        if grid == SIDE:
            cases += [("enc0_in_relu_requant", label, "enc0", (B, 4 * grid, 3),
                       enc0(fe.enc0_in_relu_requant, fe.enc0_in_relu_requant_plain, 4 * grid))]
        else:
            cases += [("enc0_hbm", f"{label}, staged {stage}", "enc0", (B, 4 * grid, 3),
                       enc0(fe.enc0_hbm, fe.enc0_hbm_plain, 4 * grid, stage=stage))
                      for stage in fc.STAGES]
        cases += [
            ("enc1_in_relu_requant", label, "conv4x4s2", (B, 4 * grid, C // 4),
             conv4x4s2(fe.enc1_in_relu_requant, fe.enc1_in_relu_requant_plain, 4 * grid, C // 4)),
            ("enc2_in_relu_requant", label, "conv4x4s2", (B, 2 * grid, C // 2),
             conv4x4s2(fe.enc2_in_relu_requant, fe.enc2_in_relu_requant_plain, 2 * grid, C // 2)),
            ("conv3x3_adain_relu_requant", label, "relu", (B, grid, C), trunk("relu", grid)),
            ("conv3x3_adain_residual_requant", label, "residual", (B, grid, C),
             trunk("residual", grid)),
            ("conv3x3_adain_residual_hifi", label, "hifi", (B, grid, C), trunk("hifi", grid)),
            ("conv3x3_adain_residual_hifi2", label, "hifi2", (B, grid, C), trunk("hifi2", grid)),
            ("convt4x4s2_in_relu_requant_ps", label, "convt", (B, grid, C),
             convt(fc.convt4x4s2_in_relu_requant_ps, fc.convt4x4s2_in_relu_requant_ps_plain,
                   grid, C)),
        ]
        if grid == SIDE:
            cases += [("up1_s2d16", label, "convt", (B, 2 * grid, C // 2),
                       convt(fd.up1_s2d16, fd.up1_s2d16_plain, 2 * grid, C // 2))]
        else:
            cases += [("up1_s2d16_hbm", f"{label}, staged {stage}", "convt", (B, 2 * grid, C // 2),
                       convt(fd.up1_s2d16_hbm, fd.up1_s2d16_hbm_plain, 2 * grid, C // 2,
                             stage=stage))
                      for stage in fc.STAGES]
        cases += [("final7_tanh_u8", label, "final7", (B, 4 * grid, 64), final7(4 * grid))]
    label = "256² input"
    cases += [("fused_trunk_blocks", f"{label}, {N_RES} resblocks", "trunk_v3", (B, SIDE, C),
               trunk_v3()),
              ("enc1_in_relu_requant_im2col", label, "conv4x4s2", (B, 4 * SIDE, C // 4),
               enc1_im2col(4 * SIDE)),
              ("adain_relu_requant_chunked", f"{label}, int32 [{B}, {SIDE * SIDE}, {C}]",
               "epilogue", (B, SIDE * SIDE, C), epilogue())]
    return cases


def kernel_phase(torch, fc, fd, fe, f3, ec, dev) -> dict:
    results = {}
    for name, label, kind, dims, make in kernel_cases(torch, fc, fd, fe, f3, ec, dev):
        kernel, plain = make()
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        max_step, report = compare(torch, name, got, want)
        del got, want
        large = kind == "trunk_v3" or (kind != "epilogue"
                                       and dims[1] * dims[1] * dims[2] > 256 * 256 * 64)
        reps = 10 if large else 30
        ms = cuda_ms(torch, kernel, reps=reps)
        plain_ms = cuda_ms(torch, plain, reps=2 if large else 3, warmup=1)
        bound_ms, bound_by = bound(kind, *dims)
        row = dict(case=label, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        if name in results:  # a further shape or staging of a site already reported
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], max_step)
            results[name]["also"].append(row)
        else:
            results[name] = dict(row, max_abs_err=max_step, also=[])
        shape = [dims[0], dims[1], dims[2]] if kind == "epilogue" else \
            [dims[0], dims[1], dims[1], dims[2]]
        print(f"[kernel] {name} ({label}) in {shape}: "
              f"{report}; {ms:.4f} ms (median of {reps}, CUDA events), plain {plain_ms:.2f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        del kernel, plain
        torch.cuda.empty_cache()
    check(set(results) == set(SITES), f"kernel cases cover {sorted(results)}")
    return results


def write_inputs(work: str) -> tuple:
    from PIL import Image

    rng = np.random.default_rng(1)

    def image():  # smooth seeded content: 16x16 noise, bilinear to 256x256
        small = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
        return Image.fromarray(small).resize((256, 256), Image.BILINEAR)

    inp, ref = os.path.join(work, "in"), os.path.join(work, "ref")
    os.makedirs(inp)
    for i in range(N_INPUTS):
        image().save(os.path.join(inp, f"leaf{i:02d}.png"))
    for d in range(9):  # the demo checkpoint has 10 domains: 9 targets + the source
        os.makedirs(os.path.join(ref, f"dom{d}"))
        for i in range(3):
            image().save(os.path.join(ref, f"dom{d}", f"r{i}.png"))
    return inp, ref


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


class env:
    """Environment settings for the length of a ``with`` block."""

    def __init__(self, **values):
        self.values, self.saved = values, {}

    def __enter__(self):
        for k, v in self.values.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def reset_counts(mods) -> None:
    for mod in mods:
        mod.reset_launch_counts()


def read_counts(mods) -> dict:
    return {k: v for mod in mods for k, v in mod.LAUNCHES.items()}


def e2e_phase(torch, mods, work: str) -> dict:
    from PIL import Image

    from msig_tpu_torch import inference as cli
    from msig_tpu_torch.config import InferenceConfig
    from msig_tpu_torch.infer import quantized as tq
    from msig_tpu_torch.infer.engine import InferenceEngine
    from msig_tpu_torch.infer.loading import load_inference_params

    inp, ref = write_inputs(work)
    n_batches = -(-N_INPUTS // B)
    gen_sd, se_sd, meta, _ = load_inference_params(
        DEMO, InferenceConfig(image_size=256, batch_size=B, device="cuda"), 10)
    n_res = meta["n_residual_blocks"]
    check(n_res == N_RES, f"demo checkpoint has {n_res} resblocks, want {N_RES}")
    path_launches = {}

    def check_launches(path: str, launches: dict) -> None:
        check(set(launches) == set(SITES), f"launch counters {sorted(launches)}")
        for name, n in launches.items():
            per_batch = PATHS[path].get(name, 0)
            check(n == per_batch * n_batches,
                  f"[{path}] {name} launched {n} times, want {per_batch} x {n_batches} batches")
        path_launches[path] = launches

    def serve(path: str, size: int, hifi: str, **settings) -> dict:
        """The CLI on the 20 inputs; returns {file name: uint8 image}."""
        out = os.path.join(work, "out_" + path.replace("/", "_"))
        args = cli.build_arg_parser().parse_args([
            "--input_dir", inp, "--ref_domains_dir", ref, "--checkpoint_dir", DEMO,
            "--output_dir", out, "--target_domain", TARGET, "--style_mode", "average",
            "--quantize", "int8", "--image_size", str(size), "--batch_size", str(B),
            "--compute_dtype", "float32", "--device", "cuda"])
        with env(MSIG_TRUNK_HIFI=hifi, **settings):
            reset_counts(mods)
            t0 = time.perf_counter()
            rc = cli.main(cli.config_from_args(args))
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches = read_counts(mods)
        check(rc == 0, f"[{path}] inference main exit code {rc} == 0")
        names = sorted(os.listdir(out))
        check(len(names) == N_INPUTS, f"[{path}] {len(names)} outputs for {N_INPUTS} inputs")
        check_launches(path, launches)
        print(f"[e2e {path}] inference main: rc 0, {len(names)} images of {size}² in {cli_s:.2f} s "
              f"(load + style bank + build + generate + save: {N_INPUTS / cli_s:.2f} images/s), "
              f"launches {({k: v for k, v in launches.items() if v})}", flush=True)
        images = {}
        for name in names:
            with Image.open(os.path.join(out, name)) as im:
                images[name] = np.asarray(im)
                check(images[name].shape == (size, size, 3), f"{name} is {images[name].shape}")
        return images

    def engine(size: int, quantize, out_uint8: bool = True):
        eng = InferenceEngine.build(
            InferenceConfig(image_size=size, batch_size=B, device="cuda",
                            compute_dtype="float32", quantize=quantize),
            10, gen_sd, se_sd, n_res, meta["style_dim"])
        eng.out_uint8 = out_uint8
        return eng

    def reference(eng, bank) -> dict:
        """An engine's outputs on the 20 inputs, as uint8, by file name."""
        images = {}
        for imgs, names in eng.translate_batches(eng.iter_input_batches(inp), bank, "average"):
            if imgs.dtype != np.uint8:
                imgs = np.clip(np.round((imgs + 1.0) * 127.5), 0, 255).astype(np.uint8)
            images.update(zip(names, imgs))
        return images

    def total_psnr(a: dict, b: dict) -> tuple:
        check(sorted(a) == sorted(b), "the same file names on both sides")
        per_image = [psnr(a[k], b[k]) for k in sorted(a)]
        return psnr(np.stack([a[k] for k in sorted(a)]), np.stack([b[k] for k in sorted(a)])), \
            min(per_image), max(per_image)

    def stage_times(q, imgs, styles, label: str) -> None:
        with torch.inference_mode():
            hq_in, hs_in = tq._fused_encoder(q, imgs)
            hq = tq._fused_trunk_rows(q, hq_in, hs_in, styles, n_res)
            stages = {
                "encoder, served (3 CUDA kernel sites)": lambda: tq._fused_encoder(q, imgs),
                "encoder, unfused (3 convs: int8 library products + bf16 IN/requant)":
                    lambda: tq._xla_encoder(q, imgs),
                f"trunk ({2 * n_res} CUDA kernel calls)": lambda: tq._fused_trunk_rows(
                    q, hq_in, hs_in, styles, n_res),
                "decoder, served (3 CUDA kernel sites)": lambda: tq._fused_decoder(
                    q, hq, torch.uint8),
                "decoder, unfused (2 ConvT + final conv: int8 library products + bf16 IN/requant)":
                    lambda: tq._xla_decoder(q, hq, torch.uint8),
            }
            for stage, fn in stages.items():
                print(f"[e2e {label}] int8 stage {stage}: "
                      f"{cuda_ms(torch, fn, reps=3, warmup=1):.2f} ms per batch of {B} "
                      f"(median of 3, CUDA events)", flush=True)

    def random_weights_512() -> float:
        """All-kernel uint8 vs pallas=("trunk",) float at 512² on a seeded random
        generator with 2 resblocks and one noise image; PSNR in dB."""
        from msig_tpu_torch.models import StyleCycleGANGenerator

        torch.manual_seed(0)
        gen = StyleCycleGANGenerator(style_dim=meta["style_dim"], n_residual_blocks=2)
        q = {k: v.cuda() for k, v in tq.quantize_generator_params(gen.state_dict(), 2).items()}
        r = np.random.default_rng(3)
        img = torch.from_numpy(r.integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)).cuda()
        style = torch.from_numpy(r.normal(size=(1, meta["style_dim"])).astype(np.float32)).cuda()
        with torch.inference_mode():
            got = tq.quantized_generator_apply(q, img, style, n_res=2, out_dtype=torch.uint8)
            want = tq.to_out_dtype(tq.quantized_generator_apply(
                q, img, style, n_res=2, out_dtype=torch.float32), torch.uint8)
        return psnr(got.cpu().numpy(), want.cpu().numpy())

    result = dict(psnr={}, ms={})
    rng = np.random.default_rng(2)

    # ---- 256²: the three trunk modes against the fp32 float path.
    fl, q8 = engine(256, None), engine(256, "int8")
    bank = fl.preload_style_bank(os.path.join(ref, TARGET), int(TARGET[3:]) + 1)
    want = reference(fl, bank)
    imgs = torch.from_numpy(rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8)).cuda()
    styles = bank.mean(dim=0, keepdim=True).expand(B, -1).contiguous()
    ms = cuda_ms(torch, lambda: fl.generate(imgs, styles), reps=5, warmup=2)
    print(f"[e2e 256] float32 generator, batch {B}: {ms:.2f} ms per batch, "
          f"{B / (ms / 1e3):.1f} images/s (median of 5, CUDA events)", flush=True)
    for hifi in ("0", "1", "2"):
        path = f"256/hifi{hifi}"
        served = serve(path, 256, hifi)
        if hifi == "0":
            served_256 = served
        total, lo, hi = total_psnr(served, want)
        check(total >= 30.0, f"[{path}] int8 vs fp32 PSNR {total:.2f} dB >= 30")
        with env(MSIG_TRUNK_HIFI=hifi):
            ms = cuda_ms(torch, lambda: q8.generate(imgs, styles), reps=10, warmup=2)
        result["psnr"][path], result["ms"][path] = total, ms
        print(f"[e2e {path}] int8 output vs fp32 float path: PSNR {total:.2f} dB over "
              f"{N_INPUTS} images (per image min {lo:.2f}, max {hi:.2f}); int8 generator, batch "
              f"{B}: {ms:.2f} ms per batch, {B / (ms / 1e3):.1f} images/s (median of 10, CUDA "
              f"events)", flush=True)
    stage_times(q8.q, imgs, styles, "256/hifi0")

    # ---- 256²: the three opt-in compositions of the JAX package.
    for path, setting in (("256/v3", "MSIG_TRUNK_V3"), ("256/enc1_im2col", "MSIG_ENC1_IM2COL")):
        served = serve(path, 256, "0", **{setting: "1"})
        total, lo, hi = total_psnr(served, want)
        check(total >= 30.0, f"[{path}] int8 vs fp32 PSNR {total:.2f} dB >= 30")
        same = total_psnr(served, served_256)[0]
        if path == "256/enc1_im2col":
            check(same == float("inf"), f"[{path}] served images equal 256/hifi0's ({same:.2f} dB)")
        with env(**{setting: "1"}):
            q_opt = engine(256, "int8")  # quantized under the setting: its weights are built
            ms = cuda_ms(torch, lambda: q_opt.generate(imgs, styles), reps=10, warmup=2)
        result["psnr"][path], result["ms"][path] = total, ms
        print(f"[e2e {path}] int8 output vs fp32 float path: PSNR {total:.2f} dB over "
              f"{N_INPUTS} images (per image min {lo:.2f}, max {hi:.2f}); vs 256/hifi0's output "
              f"{same:.2f} dB; int8 generator, batch {B}: {ms:.2f} ms per batch, "
              f"{B / (ms / 1e3):.1f} images/s (median of 10, CUDA events)", flush=True)
        if path == "256/v3":
            with torch.inference_mode(), env(MSIG_TRUNK_V3="1"):
                hq_in, hs_in = tq._fused_encoder(q_opt.q, imgs)
                trunk = {label: cuda_ms(torch, lambda qq=qq: tq._fused_trunk_rows(
                    qq, hq_in, hs_in, styles, n_res), reps=10, warmup=2)
                    for label, qq in (("v3, 1 launch", q_opt.q), ("chain, 16 calls", q8.q))}
            result["ms"]["256/v3 trunk"] = trunk["v3, 1 launch"]
            result["ms"]["256/hifi0 trunk"] = trunk["chain, 16 calls"]
            print(f"[e2e 256/v3] int8 stage trunk, batch {B}: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in trunk.items()) + " (median of 10, CUDA events; "
                f"one cooperative grid of {mods[3].LAST_GRID['fused_trunk_blocks']} CTAs)",
                flush=True)
        del q_opt
    path, unfused = "256/unfused+epilogue", {}
    for fused_epilogue in (True, False):
        reset_counts(mods)
        images = {}
        for batch, names in q8.iter_input_batches(inp):
            x = torch.from_numpy(batch).cuda()
            with torch.inference_mode():
                y = tq.quantized_generator_apply(
                    q8.q, x, bank.mean(dim=0, keepdim=True).expand(len(names), -1).contiguous(),
                    n_res=n_res, out_dtype=torch.uint8, fused_trunk=False,
                    fused_epilogue=fused_epilogue)
            images.update(zip(names, y.cpu().numpy()))
        if fused_epilogue:
            check_launches(path, read_counts(mods))
        else:
            ran = {k: v for k, v in read_counts(mods).items() if v}
            check(not ran, f"[256/unfused] no kernel site: {ran}")
        with torch.inference_mode():
            ms = cuda_ms(torch, lambda: tq.quantized_generator_apply(
                q8.q, imgs, styles, n_res=n_res, out_dtype=torch.uint8, fused_trunk=False,
                fused_epilogue=fused_epilogue), reps=5, warmup=1)
        unfused[fused_epilogue] = images
        label = path if fused_epilogue else "256/unfused"
        result["psnr"][label], lo, hi = total_psnr(images, want)
        result["ms"][label] = ms
        print(f"[e2e {label}] quantized_generator_apply(fused_trunk=False, fused_epilogue="
              f"{fused_epilogue}): int8 vs fp32 float path PSNR {result['psnr'][label]:.2f} dB "
              f"(per image min {lo:.2f}, max {hi:.2f}); {ms:.2f} ms per batch of {B} (median of "
              f"5, CUDA events)", flush=True)
    result["psnr"]["256/unfused+epilogue vs 256/unfused"] = total_psnr(unfused[True],
                                                                       unfused[False])[0]
    print(f"[e2e 256/unfused+epilogue] vs 256/unfused: PSNR "
          f"{result['psnr']['256/unfused+epilogue vs 256/unfused']:.2f} dB", flush=True)

    trunk_only = {}  # at 256² the entry point takes the all-kernel chain: name the stages
    for batch, names in q8.iter_input_batches(inp):
        x = torch.from_numpy(batch).cuda()
        with torch.inference_mode():
            y = tq.quantized_generator_apply_staged(
                q8.q, x, bank.mean(dim=0, keepdim=True).expand(len(names), -1).contiguous(),
                n_res=n_res, out_dtype=torch.uint8, pallas=("trunk",))
        trunk_only.update(zip(names, y.cpu().numpy()))
    total, lo, hi = total_psnr(served_256, trunk_only)
    unfused = total_psnr(trunk_only, want)[0]
    result["psnr"]["256 vs trunk-only"], result["psnr"]["256 trunk-only"] = total, unfused
    print(f"[e2e 256] demo checkpoint, all-kernel uint8 output vs pallas=('trunk',): PSNR "
          f"{total:.2f} dB (per image min {lo:.2f}, max {hi:.2f}); pallas=('trunk',) vs fp32: "
          f"{unfused:.2f} dB", flush=True)
    del fl, q8, want

    # ---- 512²: the all-kernel chain with the staged sites, against pallas=("trunk",).
    served = serve("512", 512, "0")
    fl, q8, q8_float = engine(512, None), engine(512, "int8"), engine(512, "int8", False)
    bank = fl.preload_style_bank(os.path.join(ref, TARGET), int(TARGET[3:]) + 1)
    reset_counts(mods)
    trunk_only = reference(q8_float, bank)
    ran = {k: v for k, v in read_counts(mods).items() if v}
    check(ran == {"conv3x3_adain_relu_requant": N_RES * n_batches,
                  "conv3x3_adain_residual_requant": N_RES * n_batches},
          f"float output at 512² runs pallas=('trunk',): launches {ran}")
    # Two int8 chains that part at the encoder, each about 30 dB from the fp32
    # path on this checkpoint, are about as far from each other: what the
    # all-kernel chain must show here is that it is no farther from the fp32
    # path than the unfused chain around the same trunk. The 35 dB of the JAX
    # package's own test is held in that test's configuration, below.
    want = reference(fl, bank)
    result["psnr"]["512 vs trunk-only"], lo, hi = total_psnr(served, trunk_only)
    print(f"[e2e 512] demo checkpoint, all-kernel uint8 output vs pallas=('trunk',) float "
          f"output: PSNR {result['psnr']['512 vs trunk-only']:.2f} dB (per image min {lo:.2f}, "
          f"max {hi:.2f})", flush=True)
    total, lo, hi = total_psnr(served, want)
    unfused = total_psnr(trunk_only, want)[0]
    result["psnr"]["512"], result["psnr"]["512 trunk-only"] = total, unfused
    print(f"[e2e 512] int8 output vs fp32 float path: PSNR {total:.2f} dB (per image min "
          f"{lo:.2f}, max {hi:.2f}; no bar: the checkpoint was trained at 256²); "
          f"pallas=('trunk',) float output vs fp32: {unfused:.2f} dB", flush=True)
    check(total >= unfused - 0.5, f"[512] all-kernel chain {total:.2f} dB from fp32, "
                                  f"pallas=('trunk',) {unfused:.2f} dB: no more than 0.5 dB worse")
    total = random_weights_512()
    check(total >= 35.0, f"[512] all-kernel uint8 vs pallas=('trunk',) float, random weights, "
                         f"2 resblocks: PSNR {total:.2f} dB >= 35")
    result["psnr"]["512 vs trunk-only, random weights"] = total
    print(f"[e2e 512] seeded random weights, 2 resblocks, one noise image (the configuration of "
          f"the JAX package's test_full_uint8_decoder_512_end_to_end): all-kernel uint8 vs "
          f"pallas=('trunk',) float PSNR {total:.2f} dB", flush=True)
    for hifi, site in (("1", "conv3x3_adain_residual_hifi"), ("2", "conv3x3_adain_residual_hifi2")):
        reset_counts(mods)
        with env(MSIG_TRUNK_HIFI=hifi):
            total, lo, hi = total_psnr(reference(q8, bank), want)
        ran = {k: v for k, v in read_counts(mods).items() if v}
        expect = {**PATHS["512"], site: N_RES}
        del expect["conv3x3_adain_residual_requant"]
        check(ran == {k: v * n_batches for k, v in expect.items()},
              f"[512/hifi{hifi}] launches {ran}")
        result["psnr"][f"512/hifi{hifi}"] = total
        print(f"[e2e 512/hifi{hifi}] int8 output vs fp32 float path: PSNR {total:.2f} dB (per "
              f"image min {lo:.2f}, max {hi:.2f}); {site} launched {ran[site]} times", flush=True)
    imgs = torch.from_numpy(rng.integers(0, 256, (B, 512, 512, 3), dtype=np.uint8)).cuda()
    styles = bank.mean(dim=0, keepdim=True).expand(B, -1).contiguous()
    ms = cuda_ms(torch, lambda: fl.generate(imgs, styles), reps=3, warmup=1)
    print(f"[e2e 512] float32 generator, batch {B}: {ms:.2f} ms per batch, "
          f"{B / (ms / 1e3):.1f} images/s (median of 3, CUDA events)", flush=True)
    outs = {}
    for fp16 in ("0", "1"):
        with env(MSIG_STAGE_FP16=fp16):
            ms = cuda_ms(torch, lambda: q8.generate(imgs, styles), reps=5, warmup=2)
            outs[fp16] = q8.generate(imgs, styles).cpu().numpy()
        result["ms"][f"512/stage_fp16={fp16}"] = ms
        print(f"[e2e 512] int8 generator, MSIG_STAGE_FP16={fp16}, batch {B}: {ms:.2f} ms per "
              f"batch, {B / (ms / 1e3):.1f} images/s (median of 5, CUDA events)", flush=True)
    print(f"[e2e 512] fp16 staging vs int32 staging, one batch of noise images: PSNR "
          f"{psnr(outs['0'], outs['1']):.2f} dB", flush=True)
    with env(MSIG_STAGE_FP16="1"):
        staged_fp16 = reference(q8, bank)
    result["psnr"]["512/stage_fp16=1"] = total_psnr(staged_fp16, want)[0]
    print(f"[e2e 512] MSIG_STAGE_FP16=1 on the {N_INPUTS} inputs: PSNR vs fp32 float path "
          f"{result['psnr']['512/stage_fp16=1']:.2f} dB (int32 staging "
          f"{result['psnr']['512']:.2f}), vs the int32-staged output "
          f"{total_psnr(staged_fp16, served)[0]:.2f} dB", flush=True)
    stage_times(q8.q, imgs, styles, "512")
    result["launches"] = {name: path_launches[path][name] for name, (_, _, path) in SITES.items()}
    return result


def train_bound(name: str, b: int) -> tuple:
    """(bound_ms, bound_by) of one call of a training kernel on the [b, 64, 64, 256] trunk.

    Bytes: each fp32 input read once, each output written once. Operations:
    the conv backward's two products, dx and dW, 2 * 2 * (B*H*W) * C * 9*Co
    FMA-counted flops at the fp32 rate (TF32 is off), and per element of the
    map about 8 flops for an instance-norm pass (statistics, normalisation,
    modulation; the backward's two sums and its dx)."""
    px, vec = b * SIDE * SIDE, 4 * b * C
    elems = px * C
    if name == "adain_pallas_fwd":
        nbytes, flops = 2 * 4 * elems + 4 * vec, 8 * elems       # x -> y; gamma, beta, mean, rstd
    elif name == "adain_pallas_bwd":
        nbytes, flops = 3 * 4 * elems + 5 * vec, 8 * elems       # x, dy -> dx
    else:
        conv = 2 * 2 * px * C * 9 * C
        w = 2 * 4 * 9 * C * C                                     # W read, dW written
        if name == "conv3x3_bwd":
            nbytes, flops = 3 * 4 * elems + w, conv               # x, dy -> dx
        else:
            nbytes, flops = 4 * 4 * elems + w + 5 * vec, conv + 8 * elems  # x, y, g -> dx
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def close(torch, name: str, got, want, rtol: float = 1e-4, atol_rel: float = 1e-5) -> float:
    """Hold a float output against the plain version's; returns the max abs error."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    err = float((got - want).abs().max())
    atol = atol_rel * float(want.abs().max())
    check(bool(torch.allclose(got, want, rtol=rtol, atol=atol)),
          f"{name}: max abs err {err:.3e} beyond rtol {rtol} / atol {atol:.3e}")
    return err


def train_kernel_phase(torch, ap, cv, dev) -> dict:
    """The four training kernels against their plain versions at both train shapes."""
    results = {}

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    for b in (2 * TRAIN_B, TRAIN_B):
        shape = (b, SIDE, SIDE, C)
        rng = np.random.default_rng(b)
        x = t(rng.normal(0, 1, shape))
        w = t(rng.uniform(-1, 1, (3, 3, C, C)) / np.sqrt(9 * C))
        gamma, beta = t(rng.normal(1.0, 0.5, (b, C))), t(rng.normal(0.0, 0.5, (b, C)))
        g = t(rng.normal(0, 1, shape))
        x3, g3 = x.reshape(b, SIDE * SIDE, C), g.reshape(b, SIDE * SIDE, C)
        y, mean, rstd = ap.adain_fwd_plain(x3, gamma, beta)
        nchw = lambda v: v.permute(0, 3, 1, 2)  # noqa: E731  (channels_last views for cuDNN)
        library = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            nchw(g), nchw(x), w.permute(3, 2, 0, 1).contiguous(), None, [1, 1], [1, 1], [1, 1],
            False, [0, 0], 1, [True, True, False])
        cases = [("adain_pallas_fwd", "", lambda: ap.adain_fwd(x3, gamma, beta),
                  lambda: ap.adain_fwd_plain(x3, gamma, beta), None)]
        cases.append(("adain_pallas_bwd", "", lambda: ap.adain_bwd(x3, gamma, mean, rstd, g3),
                      lambda: ap.adain_bwd_plain(x3, gamma, mean, rstd, g3), None))
        for relu in (False, True):
            tag = ", relu input" if relu else ""
            cases.append(("conv3x3_bwd", tag,
                          lambda relu=relu: cv.conv3x3_bwd(x, w, g, relu_input=relu),
                          lambda relu=relu: cv.conv3x3_bwd_plain(x, w, g, relu_input=relu),
                          library))
            _, (yy, mu, r) = cv._adain_unit_fwd_impl(x, w, gamma, beta, relu)
            cases.append(("conv3x3_adain_bwd", tag,
                          lambda relu=relu, yy=yy, mu=mu, r=r: cv.conv3x3_adain_bwd(
                              x, w, yy, mu, r, gamma, g, relu_input=relu),
                          lambda relu=relu, yy=yy, mu=mu, r=r: cv.conv3x3_adain_bwd_plain(
                              x, w, yy, mu, r, gamma, g, relu_input=relu),
                          None))
        for name, tag, kernel, plain, lib in cases:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            errs = []
            for k, (gt, wt) in enumerate(zip(got, want)):
                stat = (name.endswith("_bwd") and gt.dim() == 2 and name != "conv3x3_bwd"
                        and k >= 1)  # dgamma, dbeta: sums over a whole image
                errs.append(close(torch, f"{name} output {k}", gt, wt,
                                  *((1e-5, 1e-6) if stat else ())))
            report = f"max abs err {max(errs):.3e}"
            if name.startswith("conv3x3"):
                if tag:
                    check(bool((got[0][x <= 0] == 0).all()), f"{name}: dx is 0 where x <= 0")
                    report += ", dx exactly 0 under the relu mask"
                again = kernel()
                check(torch.equal(again[1], got[1]), f"{name}: a second call gives the same dW")
                report += ", dW bit-identical over two calls"
            del got, want
            ms = cuda_ms(torch, kernel, reps=20 if name.startswith("conv") else 50)
            plain_ms = cuda_ms(torch, plain, reps=3, warmup=1)
            library_ms = cuda_ms(torch, lib, reps=20) if lib is not None else None
            bound_ms, bound_by = train_bound(name, b)
            row = dict(case=f"[{b}, {SIDE}, {SIDE}, {C}]{tag}", ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
            if name in results:
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], max(errs))
                results[name]["also"].append(row)
            else:
                results[name] = dict(row, max_abs_err=max(errs), also=[])
            lib_txt = f", cuDNN convolution_backward {library_ms:.4f} ms" if lib is not None else ""
            print(f"[train kernel] {name} ({row['case']}): {report}; {ms:.4f} ms (median of "
                  f"{20 if name.startswith('conv') else 50}, CUDA events), plain {plain_ms:.3f} ms"
                  f"{lib_txt}, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        del x, w, g, y
        torch.cuda.empty_cache()
    check(set(results) == set(TRAIN_KERNELS), f"train kernel cases cover {sorted(results)}")
    return results


def step1_grads(state, cfg, g_norm: float) -> list:
    """The G group's pre-clip step-1 gradients, leaf by leaf, from Adam's first
    moment after step 1: mu = (1 - b1) * g * min(1, max_norm / norm)."""
    scale = max(g_norm / cfg.grad_clip_norm, 1.0) / (1.0 - cfg.adam_b1)
    return [m * scale for m in state.opt_g.mu]


class plain_backwards:
    """The backward kernels' wrappers swapped for their plain versions for the
    length of a ``with`` block; the forward (stock convs, the AdaIN forward
    kernel) stays as it is, so a step computes the same forward to the bit."""

    def __init__(self, ap, cv):
        self.names = [(cv, "conv3x3_bwd"), (cv, "conv3x3_adain_bwd"), (ap, "adain_bwd")]

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.names]
        for m, n in self.names:
            setattr(m, n, getattr(m, n + "_plain"))

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.names, self.saved):
            setattr(m, n, fn)


def compare_grads(label: str, names, got, want) -> None:
    """Hold a configuration's step-1 gradients against those of the same step with
    the backward kernels' plain versions, leaf by leaf:
    |got - want| <= GRAD_RTOL * |want| + GRAD_ATOL_REL * max|want over the group|."""
    atol = GRAD_ATOL_REL * max(float(w.abs().max()) for w in want)
    worst, bad = (0.0, ""), []
    for name, g, w in zip(names, got, want):
        ratio = float(((g - w).abs() / (GRAD_RTOL * w.abs() + atol)).max())
        worst = max(worst, (ratio, name))
        if ratio > 1.0:
            bad.append(f"{name} ({ratio:.2f})")
    zero = [n for n, g in zip(names, got) if ".conv" in n and n.endswith(".bias")
            and n.split(".")[1] == "decoder" and not bool(g.any())]
    print(f"[train {label}] step-1 gradients vs the same step with the plain backwards, "
          f"{len(names)} leaves of the G group: rtol {GRAD_RTOL} / atol {GRAD_ATOL_REL} x "
          f"max|plain| = {atol:.3e}; worst leaf "
          f"{worst[1]} at {worst[0]:.3f} of its bar; {len(bad)} beyond; resblock conv biases "
          f"with an exactly zero gradient: {len(zero)}", flush=True)
    check(not bad, f"[train {label}] step-1 gradients within their bars (beyond: {bad[:8]})")
    if label == "level2":  # the unit skips the bias, which instance norm removes
        check(len(zero) == 4 * N_RES,
              f"[train level2] all {4 * N_RES} resblock conv biases have a zero gradient")


def train_phase(torch, ap, cv, int8_mods, dev, kernels: dict) -> dict:
    """The train step at full width in the three configurations, from the same
    parameters and batch. Step 1's losses and grad norms are held against the
    stock step's, and the step-1 gradients of each kernel configuration, leaf by
    leaf, against a rerun of its step 1 with the backward kernels' plain versions.
    (Not against the stock step's: at random init the generators' tanh saturates,
    and its backward, 1 - y^2, turns last-bit differences of the forward into
    relative differences of the gradients of up to 3e-3 of a leaf's norm, as
    the CPU, where no kernel runs, shows at 32². For the same reason cuDNN is
    held to its deterministic algorithms, as the Trainer holds it: with its
    default choice the decoders' ConvTranspose2d, and so two runs of the same
    step, differ in the last bit of the forward.)
    Returns {config: launches of step 1} and the step times."""
    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.losses import init_random_vgg
    from msig_tpu_torch.train import create_train_state, make_train_step
    from msig_tpu_torch.train.state import G_KEYS

    rng = np.random.default_rng(4)
    shape = (TRAIN_B, TRAIN_SIZE, TRAIN_SIZE, 3)
    batch = {"source": torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev),
             "target": torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev),
             "source_domain": torch.zeros(TRAIN_B, dtype=torch.int32, device=dev),
             "target_domain": torch.from_numpy(rng.integers(1, N_DOMAINS, TRAIN_B,
                                                            dtype=np.int32)).to(dev)}
    vgg = init_random_vgg(1234, device=dev)
    weights = [1.0, 10.0, 5.0, 1.0, 1.0]  # the default loss weights, gan..style, at full warmup
    first, launches, step_ms = {}, {}, {}
    torch.backends.cudnn.deterministic = True
    for label, level, pallas in TRAIN_CONFIGS:
        cfg = TrainConfig(image_size=TRAIN_SIZE, batch_size=TRAIN_B, n_residual_blocks=N_RES,
                          style_dim=256, use_pallas=pallas, device=dev.type)
        with env(MSIG_CONV_VJP=level):
            state = create_train_state(cfg, N_DOMAINS)  # the same seed: the same parameters
            step = make_train_step(cfg.ema_beta)
            for mod in (ap, cv) + int8_mods:
                mod.reset_launch_counts()
            metrics = step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
            torch.cuda.synchronize()
            counts = {**ap.LAUNCHES, **cv.LAUNCHES}
            int8 = sum(v for m in int8_mods for v in m.LAUNCHES.values())
            copies = {**ap.COPIES, **cv.COPIES}
            first[label] = {k: float(v) for k, v in metrics.items()}
            grads = step1_grads(state, cfg, first[label]["g_grad_norm"])
            want = {k: (2 * N_RES * 3 if TRAIN_KERNELS[k][2] == label else 0) for k in counts}
            check(counts == want and int8 == 0,
                  f"[train {label}] launches per step {counts} (int8 {int8}), want {want}")
            launches[label] = counts
            step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)  # warm-up
            events, finite = [], []
            for _ in range(TRAIN_STEPS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                m = step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
                end.record()
                events.append((start, end))
                finite.append(torch.stack(list(m.values())))
            torch.cuda.synchronize()
            check(bool(torch.isfinite(torch.stack(finite)).all()),
                  f"[train {label}] {TRAIN_STEPS} more steps stay finite")
            step_ms[label] = float(np.median([a.elapsed_time(b) for a, b in events]))
            mem = torch.cuda.max_memory_allocated() / 2**30
            if label != "stock":  # step 1 again, from the same parameters, plain backwards
                names = [f"{k}.{n}" for k in G_KEYS for n, _ in state.models.nets[k].named_parameters()]
                del state
                state = create_train_state(cfg, N_DOMAINS)
                for mod in (ap, cv):
                    mod.reset_launch_counts()
                with plain_backwards(ap, cv):
                    m = step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
                bwd = {k: v for k, v in {**ap.LAUNCHES, **cv.LAUNCHES}.items() if k != ap.FWD}
                check(not any(bwd.values()), f"[train {label}] no backward kernel in the plain rerun {bwd}")
                losses = [k for k in m if not k.endswith("grad_norm")]
                check(all(float(m[k]) == first[label][k] for k in losses),
                      f"[train {label}] the plain rerun's step-1 losses equal the kernel run's to the "
                      f"bit: {[(k, float(m[k]), first[label][k]) for k in losses]}")
                compare_grads(label, names, grads, step1_grads(state, cfg, float(m["g_grad_norm"])))
            del grads
        share = ""
        for k, n in counts.items():
            if n:
                also = {r["case"]: r["ms"] for r in [kernels[k]] + kernels[k]["also"]}
                t8, t4 = (also[f"[{bb}, {SIDE}, {SIDE}, {C}]"] for bb in (2 * TRAIN_B, TRAIN_B))
                est = 2 * N_RES * (2 * t8 + t4)  # the 2B, 2B and B generator launches
                share += f"; {k} x{n}: ~{est:.1f} ms ({100 * est / step_ms[label]:.0f}%)"
        print(f"[train {label}] {TRAIN_SIZE}², batch {TRAIN_B}, {N_RES} resblocks, {N_DOMAINS} domains: "
              f"step 1 losses {json.dumps({k: round(v, 6) for k, v in first[label].items()})}; "
              f"{step_ms[label]:.2f} ms per step (median of {TRAIN_STEPS} after a warm-up step, "
              f"CUDA events); launches per step {({k: v for k, v in counts.items() if v})}, "
              f"layout copies {({k: v for k, v in copies.items() if v})}{share}; peak memory "
              f"{mem:.1f} GiB", flush=True)
        del state, step
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    base = first["stock"]
    for label, m in first.items():
        for k, v in m.items():
            rtol = 1e-3 if k.endswith("grad_norm") else 1e-4
            check(abs(v - base[k]) <= rtol * abs(base[k]),
                  f"[train {label}] step 1 {k} {v} vs stock {base[k]} (rtol {rtol})")
    print(f"[train] step 1 agrees across {', '.join(first)}: losses within rtol 1e-4, grad norms "
          f"within 1e-3 (largest relative difference "
          f"{max(abs(m[k] - base[k]) / abs(base[k]) for m in first.values() for k in m):.2e})",
          flush=True)
    return dict(launches=launches, step_ms=step_ms)


def train_cli_phase(torch, work: str, device: str = "cuda", extra=()) -> None:
    """``python -m msig_tpu_torch.train`` on a synthetic tree, then serving its checkpoint."""
    import importlib.util

    from PIL import Image

    from msig_tpu_torch import inference as infer_cli
    from msig_tpu_torch.train import cli

    rng = np.random.default_rng(5)
    src, ref = os.path.join(work, "train_src"), os.path.join(work, "train_ref")
    os.makedirs(src)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (300, 280, 3), dtype=np.uint8)).save(
            os.path.join(src, f"s{i}.png"))
    for d in range(N_DOMAINS - 1):
        os.makedirs(os.path.join(ref, f"dom{d}"))
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (280, 300, 3), dtype=np.uint8)).save(
                os.path.join(ref, f"dom{d}", f"r{i}.png"))
    art = importlib.util.find_spec("matplotlib") is not None
    if not art:
        print("[train cli] matplotlib is not installed here: MSIG_SKIP_EPOCH_ART=1 (no sample "
              "grids, no loss plots)", flush=True)
    out = os.path.join(work, "train_results")
    args = cli.build_arg_parser().parse_args([
        "--source_dir", src, "--target_dir", ref, "--save_dir_base", out, "--exp_name", "smoke",
        "--device", device, "--allow_random_vgg", "--epochs", "1", *extra])
    with env(MSIG_SKIP_EPOCH_ART="0" if art else "1"):
        t0 = time.perf_counter()
        rc = cli.main(cli.config_from_args(args))
        train_s = time.perf_counter() - t0
    ckpt = os.path.join(out, "smoke", "checkpoints", "epoch_1")
    check(rc == 0, f"python -m msig_tpu_torch.train exit code {rc} == 0")
    check(all(os.path.exists(os.path.join(ckpt, f)) for f in ("checkpoint.pth",
                                                              "ema_checkpoint.pth")),
          "the train CLI wrote checkpoint.pth and ema_checkpoint.pth")
    served = os.path.join(work, "train_served")
    args = infer_cli.build_arg_parser().parse_args([
        "--input_dir", src, "--ref_domains_dir", ref, "--checkpoint_dir", ckpt, "--output_dir",
        served, "--target_domain", "dom2", "--style_mode", "average", "--quantize", "int8",
        "--batch_size", "8", "--compute_dtype", "float32", "--device", device, *extra])
    rc = infer_cli.main(infer_cli.config_from_args(args))
    check(rc == 0 and len(os.listdir(served)) == 8,
          f"the inference CLI on the trained checkpoint: exit {rc}, {len(os.listdir(served))} images")
    print(f"[train cli] python -m msig_tpu_torch.train --device cuda --allow_random_vgg --epochs 1: "
          f"rc 0 in {train_s:.1f} s (8 sources, {N_DOMAINS - 1} target domains, 256², batch "
          f"{TRAIN_B}: 2 steps + checkpoint); python -m msig_tpu_torch.inference --quantize int8 "
          f"on its checkpoint: rc 0, 8 images", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from msig_tpu_torch.ops import _build
    from msig_tpu_torch.ops import adain_pallas as ap
    from msig_tpu_torch.ops import conv3x3_vjp as cv
    from msig_tpu_torch.ops import fused_conv_int8_v2 as fc
    from msig_tpu_torch.ops import fused_dec_int8 as fd
    from msig_tpu_torch.ops import fused_enc_int8 as fe
    from msig_tpu_torch.ops import fused_trunk_v3 as f3
    from msig_tpu_torch.ops import int8_epilogue_chunked as ec

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = t0 = time.perf_counter()
    sources = fe.SOURCES + fc.SOURCES + fd.SOURCES + f3.SOURCES + ec.SOURCES + (ap.SOURCE,) + \
        cv.SOURCES
    logs = _build.build(sources)
    print(f"[build] {len(logs)} of {len(sources)} kernel sources compiled in "
          f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a)", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    card = card_line()
    print(f"[card] {card}", flush=True)

    dev = torch.device("cuda")
    int8_mods = (fc, fd, fe, f3, ec)
    kernels = kernel_phase(torch, fc, fd, fe, f3, ec, dev)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=str(_build.BUILD_DIR))
    try:
        e2e = e2e_phase(torch, int8_mods, work)
        train_kernels = train_kernel_phase(torch, ap, cv, dev)
        train = train_phase(torch, ap, cv, int8_mods, dev, train_kernels)
        train_cli_phase(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[time] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s", flush=True)

    # library_ms is null: no single PyTorch call computes conv + IN (+ AdaIN)
    # + requant, or conv7 + dequant + tanh + uint8, int8 ConvT is no cuDNN op,
    # and none runs IN + AdaIN + ReLU + requant from int32 or a whole trunk.
    # launches: from the run of the path that SITES names for the row.
    rows = [dict(name=name, route="cuda", source=f"msig_tpu_torch/csrc/{SITES[name][1]}",
                 replaces=SITES[name][0], launches=e2e["launches"][name],
                 max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
                 bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None,
                 path=SITES[name][2], also=k["also"])
            for name, k in kernels.items()]
    # the training rows: launches from step 1 of the configuration that runs them.
    rows += [dict(name=name, route="cuda", source=f"msig_tpu_torch/csrc/{TRAIN_KERNELS[name][1]}",
                  replaces=TRAIN_KERNELS[name][0],
                  launches=train["launches"][TRAIN_KERNELS[name][2]][name],
                  max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
                  bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=k["library_ms"],
                  path=f"train/{TRAIN_KERNELS[name][2]}", also=k["also"])
             for name, k in train_kernels.items()]
    check(len(rows) == len(SITES) + len(TRAIN_KERNELS), f"{len(rows)} kernel rows")
    for row in rows:
        check(row["launches"] > 0, f"{row['name']} was launched on its path {row['path']}")
    print(json.dumps({"kernels": rows}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
