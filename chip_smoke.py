#!/usr/bin/env python3
"""Smoke run of msig_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. build: compiles the fourteen CUDA sources of the serving, tool and training
   paths from ``msig_tpu_torch/csrc`` (one nvcc per source, all at once),
   prints ptxas's registers and spills per kernel (named for the wgmma
   kernels: rows 1-4's pass A, the ConvT site's pass S and pass Q), and the
   card's name and power limit as nvidia-smi reports them;
2. kernels: each of the twenty-one kernel sites against its plain PyTorch version
   on the card, with seeded random inputs, batch 8. At the shapes of a 256²
   input: enc0 uint8 [8, 256, 256, 3] -> [8, 256, 256, 64], enc1 ->
   [8, 128, 128, 128], enc2 -> [8, 64, 64, 256], the four trunk sites (conv1,
   and conv2 with its int8, bf16 and two-plane residual carries) at
   [8, 64, 64, 256], up0 -> [8, 128, 128, 128], up1 -> [8, 256, 256, 64],
   final7 -> [8, 256, 256, 3], and the three sites of the opt-in compositions:
   ``fused_trunk_blocks`` (all 8 resblocks in one launch) at [8, 64, 64, 256],
   ``enc1_in_relu_requant_im2col`` at enc1's shapes with four distinct phase
   blocks (and with four equal ones equal to enc1's kernel to the bit),
   ``adain_relu_requant_chunked`` at [8, 4096, 256] int32;
   the v1 sites of ``fused_conv_int8`` (conv1 and conv2 at [8, 64, 64, 256],
   the ConvT on the 9-tap K-concat operand at up0's and up1's shapes), the
   9-tap ConvT site of ``fused_conv_int8_v2`` at the same two (and equal to
   ``convt4x4s2_in_relu_requant_ps``'s kernel to the bit), and the whole-slab
   epilogues ``adain_relu_requant`` and ``adain_residual_requant`` (bf16
   residual) at [8, 4096, 256] int32.
   At the shapes of a 512² input: the staged
   sites enc0_hbm [8, 512, 512, 3] and up1_s2d16_hbm [8, 256, 256, 128] ->
   [8, 512, 512, 64], each staged as int32 and as fp16 (held against the
   plain version that narrows the same way), and every other site at its map
   of four times the pixels. Bars: int8 outputs at most 1 step apart on under
   1% of the elements, scales within rtol 1e-5, the bf16 carry at most 1 ulp
   on under 1%, uint8 at most 1 apart on under 1e-3; the wgmma rows (conv1,
   the three conv2 sites, the v1 conv1 and conv2 sites, the ConvT site's rows
   5, 12 and 13, the v1 and 9-tap ConvT sites), the encoder's two-pass rows
   7-11, row 18 and rows 16-17 (``EXACT``) equal to their plain versions to
   the bit,
   conv1, the conv2 sites, the ConvT rows and enc1, enc2 timed with the
   K-major weight copy given, as the served trunk, decoder and encoder call
   them (rows 6 and 19-21 also with the copy made by the wrapper); times by
   CUDA events
   (the three epilogue rows also as three medians with L2 warm and three
   with L2 flushed before each call). Then conv1 and the three conv2 sites at
   ``WGMMA_SHAPES`` (down to [1, 16, 16, 128], up to [8, 128, 128, 256], a
   384² input's [1, 96, 96, 256], and [1, 16, 16, 384]) with and without the
   K-major copy, twice,
   and the v1 conv2 site at [1, 64, 64, 128] and [8, 64, 64, 256]: equal to
   the plain versions to the bit, one launch per call; then rows 5, 12 and 13
   at ``CONVT_SHAPES`` ([8, 64, 64, 256] -> 128, [8, 128, 128, 128] -> 64,
   [2, 256, 256, 128] -> 64 in both stagings, [1, 16, 16, 64] -> 64,
   [1, 96, 96, 256] -> 128) with and without the K-major copy: equal to the
   plain versions to the bit, one launch per call, and the passes' rings and
   shared memory as built; then rows 21 and 6 at ``V1_CONVT_SHAPES`` (up0's
   and up1's shapes, [1, 16, 16, 64] -> 64, [2, 16, 16, 256] -> 128) and row
   19 at ``V1_CONV1_SHAPES`` ([1, 64, 64, 128], [8, 64, 64, 256]) with and
   without the K-major copy, twice: equal to the plain versions to the bit,
   one launch per call, row 6 equal to row 5's kernel; on one-sign channels
   rows 21 and 6, and rows 19 and 1, apart by more than the int8 bar; then
   rows 8-9 at ``ENC_SHAPES`` (enc1's and
   enc2's shapes of a 256² and a 512² input, and [2, 32, 32, 64] -> 64) with
   and without the K-major copy and rows 7 and 10 at ``ENC0_SHAPES`` (256²,
   512² in both stagings, [1, 64, 128, 3]): equal to the plain versions to
   the bit, one launch per call; row 11 (enc1's four-phase form on the same
   two passes) at ``ENC1_I2C_SHAPES`` with four distinct phase blocks and
   the K-major copy given and made (equal to its plain version to the bit)
   and with four equal blocks (equal to row 8 to the bit); row 18 (one cooperative launch) at [8, 4096, 256] with
   |x| < 2^20 and over the whole int32 range: equal to its plain version to
   the bit, two calls alike, its grid and items; rows 16-17 (one cooperative
   launch each) likewise, the residual in bf16 and in fp32, h and int8 to the
   bit; row 14 (``final7_tanh_u8``, mma.sync with
   kx folded into N, packed weights ``fd.pack_final7_weights`` given) equal
   to its plain version to the bit at both inputs' maps; row 15
   (``fused_trunk_blocks``: the whole trunk in one cooperative launch on the
   wgmma main loop, timed with its K-major stack ``f3.stack_kmajor``) equal to
   its plain version to the bit at the main path's shape and at
   ``TRUNK_V3_SHAPES`` ([2, 16, 16, 128] with 1 block, [2, 16, 16, 256] with
   3), with the stack given and made by the wrapper, over two calls;
3. end to end, ``msig_tpu_torch.inference.main`` on ``cuda`` with
   ``--quantize int8``, the committed demo checkpoint (10 domains, 8
   resblocks, style_dim 256), batch 8, over 20 seeded inputs, the launch
   counts set to 0 before each run and read after it:
   each path's served images also as a sha256 (pixels by file name), so that
   runs of two trees can be held equal byte for byte;
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
   PSNR and a sha256 of its images printed, and of ``256/unfused``'s; time per batch of each and of the trunk alone under v3;
   at 256² the fp32 float path with ``--pallas`` (``256/float+pallas``):
   ``adain_pallas_fwd`` 16 times per generator call and no other kernel, at
   least 40 dB from the float path without it; its time per batch;
   at 512²: enc0_hbm, enc1, enc2, 8 + 8 trunk calls, up0, up1_s2d16_hbm and
   final7 per batch; the all-kernel uint8 output and the port's
   ``pallas=("trunk",)`` float output against each other and against the fp32
   path (the all-kernel chain no more than 0.5 dB farther from fp32 than the
   unfused one), and against each other at least 35 dB on seeded random
   weights with 2 resblocks and a noise image (the configuration in which the
   JAX package's tests hold that bar); time per batch and per stage, with
   both stagings, and per batch in ``MSIG_TRUNK_HIFI`` 1 and 2;
   at 224² (``224/int8``): no kernel site at all (the unfused int8 chain, as
   the JAX package takes it away from 256² and 512²), 20 images served;
4. tools/v1_v2: ``python -m msig_tpu_torch.tools.bench_v1_v2`` and
   ``...profile_fused_stages`` at batch 8 (their ``main``), once with one call
   of each site or stage and once timed, the launch counts set to 0 before
   each tool and read after it: per pass one launch each of the v1 conv1 and
   conv2 sites, two each of the v1 and 9-tap ConvT sites (and one each of v2's
   conv1 and conv2) in the bench; in the profile, per stage, the sites it
   names and no other;
5. train kernels: the four training kernels (the fused AdaIN forward and
   backward, ``conv3x3_bwd`` and ``conv3x3_adain_bwd``, each with and without
   the relu input) against their plain versions at the trunk shapes of a 256²
   train step, [8, 64, 64, 256] and [4, 64, 64, 256], fp32 with TF32 off, and
   the two conv kernels at [1, 24, 24, 256] (a 96² trunk: 576 pixels, no
   multiple of the 128-pixel tile). Bars: every output within rtol 1e-4 and
   atol 1e-5 x max|plain|; dgamma and dbeta within rtol 1e-5 and atol 1e-6 x
   max|plain|; dx exactly 0 under the relu mask; a second call gives
   bit-identical dW, and every output of the AdaIN kernels (row 22: one
   thread-block cluster a sample and 32 channels, partials summed in rank
   order). Row 22 also at [8|4, 4096, 256] and [1, 16384, 256] in fp32 and
   bf16 (the TPU kernel's largest fp32 slab): within the bars (bf16 y and
   dx 2e-2, one bf16 rounding), bit-identical over two calls, each with its
   plan (cluster size, CTAs, shared memory) and the card's
   cudaOccupancyMaxActiveClusters. The conv core's tiles, ring and CTAs per
   SM (occupancy API). Times by CUDA events; for ``conv3x3_bwd`` cuDNN's
   ``convolution_backward`` (dx and dW) beside it under its default and its
   deterministic algorithms; after phase 6, the device time of each kernel of
   a conv call (``torch.profiler``): row 24's IN backward, the conv core, the
   reductions; and of conv1 and the three conv2 sites at [8, 64, 64, 256] and
   [8, 128, 128, 256]: the wgmma pass A, the epilogue kernels, the memset,
   with pass A's int8 rate and share of 1,979 TOP/s, beside the call's time by
   CUDA events, and the memory the call allocates at its peak;
   the same for rows 5 and 12 at their main-path shapes and row 13 at a 512²
   input's in both stagings: the memset, pass S and pass Q, each pass's int8
   rate; for rows 21 and 6 at up0's and up1's shapes and row 19 at
   [8, 64, 64, 256] (the fill or memset, the passes; their times by events
   with the copy given and made); and for rows 7-9 at theirs and row 10 in both stagings; row 14 at a
   256² and a 512² input's maps with its packed weights: its kernel's device
   time and the mma.sync rate against 1,979 TOP/s (as issued, kx folded into
   N = 24, and as the conv's own operations); row 15 at the main path's shape:
   its cooperative kernel's device time beside PyTorch's own kernels of the
   call, the cooperative grid and the 16 convs' int8 rate; row 11 at enc1's
   main-path shape (memset, pass S, pass Q); row 18 at [8, 4096, 256]: its
   device time by kernel, its kernel launches per call on the card (one),
   and its time by CUDA events with L2 warm and flushed; the same for rows
   16-17 (bf16 residual), with their cooperative grid and items a sample;
   then a ``torch.profiler`` trace of 5 steady 256² batches of the int8
   engine in mode 0: the device's busy and idle share and the trunk's share
   of the busy time;
6. train: ``make_train_step`` at full width (256², batch 4, 8 resblocks,
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
7. a ``{"kernels": [...]}`` line of the twenty-five kernels (the two
   whole-slab epilogues with 0 launches: no path of the JAX package runs
   them), then the card line,
   then the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero without the last line. It
also exits non-zero when no CUDA device is visible, and outside a checkout of
the repository (the port is imported from beside this file).
"""

from __future__ import annotations

import hashlib
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

# NVIDIA H100 SXM data sheet, dense: int8 and TF32 tensor cores, fp32 outside them, HBM3.
PEAK_INT8_OPS = 1979e12
PEAK_TF32_FLOPS = 495e12
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
F1, FI = "msig_tpu/ops/fused_conv_int8.py", "msig_tpu/ops/int8_epilogue.py"
TOOLS_PATH = "tools/v1_v2"
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
    # the v1 sites and the 9-tap ConvT site, which the JAX package runs from its tools
    "conv3x3_adain_relu_requant_v1": (f"{F1}:420", "conv3x3_adain_relu_requant.cu", TOOLS_PATH),
    "conv3x3_adain_residual_requant_v1": (f"{F1}:369", "conv3x3_adain_residual_requant.cu",
                                          TOOLS_PATH),
    "convt4x4s2_in_relu_requant_v1": (f"{F1}:267", "convt4x4s2_in_relu_requant.cu", TOOLS_PATH),
    "convt4x4s2_in_relu_requant": (f"{FC}:512", "convt4x4s2_in_relu_requant.cu", TOOLS_PATH),
    # the whole-slab epilogues: nothing in the JAX package calls them but their tests
    "adain_relu_requant": (f"{FI}:93", "int8_epilogue.cu", None),
    "adain_residual_requant": (f"{FI}:106", "int8_epilogue.cu", None),
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
    "224/int8": {},  # away from 256² and 512² the unfused chain throughout: no kernel site
}
# The tools/v1_v2 path: launches of one call of each site or stage, by kernel.
_RELU1, _RES1, _UP1 = ("conv3x3_adain_relu_requant_v1", "conv3x3_adain_residual_requant_v1",
                       "convt4x4s2_in_relu_requant_v1")
BENCH_SITES = {
    "relu site   v1": {_RELU1: 1}, "relu site   v2": {"conv3x3_adain_relu_requant": 1},
    "res site    v1": {_RES1: 1}, "res site    v2": {"conv3x3_adain_residual_requant": 1},
    "up0 site    v1": {_UP1: 1}, "up0 site    v2": {"convt4x4s2_in_relu_requant": 1},
    "up1 site    v1": {_UP1: 1}, "up1 site    v2": {"convt4x4s2_in_relu_requant": 1},
}
_TRUNK = {"conv3x3_adain_relu_requant": N_RES, "conv3x3_adain_residual_requant": N_RES}
# Rows 1-4 and 20 (the trunk's 3x3) and rows 5, 12 and 13 (the ConvT site's
# two passes) run the conv on wgmma (csrc/conv_i8_wgmma.cuh): exact integer
# sums and the plain versions' epilogue operations, so they are held equal to
# their plain versions to the bit, at the kernel rows' shapes and at
# WGMMA_SHAPES (b, side, c): small maps, both channel tiles, a 512² input's
# trunk and a 384² input's (W = 96: tiles end inside image rows), and C = 384
# (three channel tiles of 128; row 4's epilogue then takes each group's
# channels at every step); and at
# CONVT_SHAPES (b, side, cin, cout, stages): up0's and up1's main-path shapes,
# a 512² input's up1 in both stagings, Cin 64 (two taps a 128-byte K block)
# and a 384² input's up0 (W = 96).
EXACT = ("conv3x3_adain_relu_requant", "conv3x3_adain_residual_requant",
         "conv3x3_adain_residual_hifi", "conv3x3_adain_residual_hifi2",
         "conv3x3_adain_relu_requant_v1", "conv3x3_adain_residual_requant_v1",
         "convt4x4s2_in_relu_requant_v1", "convt4x4s2_in_relu_requant",
         "convt4x4s2_in_relu_requant_ps", "up1_s2d16",
         "up1_s2d16_hbm", "enc0_in_relu_requant", "enc0_hbm", "enc1_in_relu_requant",
         "enc2_in_relu_requant", "final7_tanh_u8", "fused_trunk_blocks",
         "enc1_in_relu_requant_im2col", "adain_relu_requant_chunked", "adain_relu_requant",
         "adain_residual_requant")
WGMMA_SHAPES = ((1, 16, 128), (2, 16, 256), (8, 64, 256), (8, 128, 256), (1, 96, 256),
                (1, 16, 384))
CONVT_SHAPES = ((8, 64, 256, 128, ("int32",)), (8, 128, 128, 64, ("int32",)),
                (2, 256, 128, 64, ("int32", "fp16")), (1, 16, 64, 64, ("int32",)),
                (1, 96, 256, 128, ("int32",)))
# Rows 6 and 21 (the 9-tap ConvT entry on row 5's two wgmma passes, row 21 in
# their true-extremes mode) and row 19 (row 1's wgmma pass A in that mode,
# then the unfolded epilogue) are held equal to their plain versions to the
# bit at V1_CONVT_SHAPES (b, side, cin, cout): up0's and up1's main-path
# shapes, Cin 64 (two taps a 128-byte K block) and a small map at BN = 128;
# and row 19 at V1_CONV1_SHAPES (b, c) of the 64x64 map it takes.
V1_CONVT_SHAPES = ((8, 64, 256, 128), (8, 128, 128, 64), (1, 16, 64, 64), (2, 16, 256, 128))
V1_CONV1_SHAPES = ((1, 128), (8, 256))
# Rows 7-10 (the encoder's two entries, each run as two passes with no
# accumulator in device memory) are held equal to their plain versions to the
# bit at ENC_SHAPES: the 4x4/s2 site at (b, side, cin, cout), enc1's and
# enc2's shapes of a 256² and a 512² input and Cout 64 (BN = 64); enc0 at
# (b, h, w, stagings), a 256² and a 512² input and a map that is not square.
ENC_SHAPES = ((8, 256, 64, 128), (8, 128, 128, 256), (8, 512, 64, 128), (8, 256, 128, 256),
              (2, 32, 64, 64))
ENC0_SHAPES = ((8, 256, 256, ("int32",)), (8, 512, 512, ("int32", "fp16")),
               (1, 64, 128, ("int32", "fp16")))
# Row 11 (enc1's four-phase form on the same two passes) at ENC1_I2C_SHAPES
# (b, h, w): a 256² and a 512² input's enc1, a grid of 8 x 48 (tiles end
# inside grid rows) and the smallest square map (two tiles a phase).
ENC1_I2C_SHAPES = ((8, 256, 256), (8, 512, 512), (2, 32, 192), (1, 64, 64))
# Row 15 (the whole trunk in one cooperative launch on the wgmma main loop,
# exact statistics) is held equal to its plain version to the bit at the
# main path's (b, side, c, n_blocks) in the kernel phase, and at
# TRUNK_V3_SHAPES: both channel tiles (BN = 128 at C = 128), 1 and 3 blocks,
# 4 tiles a conv over the card's CTAs, most of which get none.
TRUNK_V3_SHAPES = ((2, 16, 128, 1), (2, 16, 256, 3))
# Device time of a trunk site's call by kernel (torch.profiler names).
TRUNK_GROUPS = (("pass A (wgmma)", "conv3x3_i8_wgmma_kernel"),
                ("relu epilogue", "relu_requant_kernel"), ("max|hn|", "residual_amax_kernel"),
                ("residual requant", "residual_requant_kernel"),
                ("carry + max|hn|", "hifi_carry_kernel"), ("int8 copy", "hifi_requant_kernel"),
                ("max|hn|", "hifi2_amax_kernel"), ("two planes", "hifi2_requant_kernel"),
                ("memset", "Memset"))
# ... and of a ConvT site's call: the statistics' memset, pass S, pass Q.
CONVT_GROUPS = (("pass S (wgmma)", "convt_i8_wgmma_stats_kernel"),
                ("pass Q (wgmma)", "convt_i8_wgmma_requant_kernel"), ("memset", "Memset"))
# ... and of rows 6, 19 and 21's calls: the statistics block's fill (the
# true-extremes mode) or memset, the passes.
V1_GROUPS = (("fill", "stats_fill_kernel"),
             ("pass S (wgmma, true extremes)", "convt_i8_wgmma_true_stats_kernel"),
             ("pass Q (wgmma, true extremes)", "convt_i8_wgmma_true_requant_kernel"),
             ("pass S (wgmma)", "convt_i8_wgmma_stats_kernel"),
             ("pass Q (wgmma)", "convt_i8_wgmma_requant_kernel"),
             ("pass A (wgmma, true extremes)", "conv3x3_i8_wgmma_true_kernel"),
             ("epilogue", "true_relu_requant_kernel"), ("memset", "Memset"))
# ... and of an encoder site's call: the memset, pass S, pass Q.
ENC_GROUPS = (("pass S (wgmma)", "conv4x4s2_i8_wgmma_stats_kernel"),
              ("pass Q (wgmma)", "conv4x4s2_i8_wgmma_requant_kernel"),
              ("pass S (wgmma)", "enc1_phase_i8_wgmma_stats_kernel"),
              ("pass Q (wgmma)", "enc1_phase_i8_wgmma_requant_kernel"),
              ("pass S (wgmma)", "enc0_i8_stats_kernel"),
              ("pass Q (wgmma)", "enc0_i8_requant_kernel"), ("memset", "Memset"))
# ... and of row 15's call: the cooperative kernel, and PyTorch's own (the
# statistics blocks' fill, the affines' site-major copies).
TRUNK_V3_GROUPS = (("cooperative kernel (wgmma)", "fused_trunk_kernel"),)
# ... and of row 14's call: its one kernel (the mma.sync conv and the epilogue).
FINAL7_GROUPS = (("mma.sync conv + epilogue", "final7_mma_kernel"),)
# ... and of row 18's call: its one cooperative kernel.
CHUNKED_GROUPS = (("cooperative kernel", "chunked_epilogue_kernel"),)
SLAB_GROUPS = (("cooperative kernel", "slab_epilogue_kernel"),)
TRAIN_GROUPS = (("IN backward", "in_bwd_kernel"), ("conv core", "conv3x3_bwd_kernel"),
                ("reductions", "reduce_kernel"))
PROFILE_STAGES = {
    "encoder (3 convs)": {},
    "fused trunk (16 sites)": _TRUNK,
    "  conv1 site alone": {_RELU1: 1},
    "  conv2 site alone": {_RES1: 1},
    "fused decoder (2 ups+final)": {"convt4x4s2_in_relu_requant_ps": 2},
    "  up0 kernel alone": {_UP1: 1},
    "  up1 kernel alone": {_UP1: 1},
    "full (one program)": {**_TRUNK, "convt4x4s2_in_relu_requant_ps": 2},
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 3, flush=None) -> float:
    """Median of ``reps`` per-call times by CUDA events, after ``warmup`` calls.
    With ``flush`` (a tensor larger than the L2 cache), it is zeroed before
    each timed call, outside the events, so every call starts with a cold L2."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        if flush is not None:
            flush.zero_()
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
    once. The epilogues on int32 (``epilogue``, side = S rows): int32 in, int8
    out, statistics and affine + ReLU + requant (8 per element); with a bf16
    residual (``epilogue_residual``) also the residual in and h out. The
    K-concat ConvT sites count as ``convt``: the same MACs and outputs."""
    px = b * side * side
    if kind == "trunk_v3":
        out = px * cin
        int8_ops = N_RES * 2 * (2 * out * 9 * cin)
        nbytes = (2 * out + 2 * N_RES * (9 * cin * cin + 2 * b * cin * 4) + 2 * b * 4)
        fp_ops = N_RES * (8 + 13) * out
        t_ops = int8_ops / PEAK_INT8_OPS + fp_ops / PEAK_FP32_FLOPS
        t_bytes = nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    if kind in ("epilogue", "epilogue_residual"):
        out = b * side * cin
        per_elem = 5 if kind == "epilogue" else 9  # int32 in, int8 out (+ bf16 residual, bf16 h)
        nbytes, fp_ops = per_elem * out + 2 * b * cin * 4, 8 * out
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


def kernel_cases(torch, fc, fd, fe, f3, ec, v1, ep, dev):
    """(site, label, kind, (b, side, cin), make) per case; ``make()`` builds the
    inputs on the card and returns (kernel call, plain call). The first case
    of a site is the one the JSON line reports."""
    def t(a):
        return torch.from_numpy(a).to(dev)

    def trunk(kind, side, mod=fc):
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
            # rows 1-4 as the served trunk calls them, with the K-major copy;
            # the v1 sites (rows 19-20) also with the copy made by the wrapper
            kw = {"w_kmajor": fc.pack_weights_kmajor(w)}
            calls = ((lambda: getattr(mod, fn)(*args, **kw)),
                     (lambda: getattr(mod, fn + "_plain")(*args)))
            return calls + ((lambda: getattr(mod, fn)(*args)),) if mod is v1 else calls
        return make

    def convt(fn, plain, side, cin, pack=fc.pack_convt_weights_ps, **kw):
        def make():
            rng = np.random.default_rng(side + cin)
            lo = -127 if cin == C else 0      # up1 reads ReLU outputs
            x = t(rng.integers(lo, 128, (B, side, side, cin), dtype=np.int8))
            w = torch.from_numpy(rng.integers(-127, 128, (4, 4, cin, cin // 2), dtype=np.int8))
            wp = pack(w, cin, cin // 2).to(dev)
            # rows 5, 12, 13 as the served decoder calls them, with the K-major
            # copy; rows 6 and 21 with theirs, and also with it made by the wrapper
            kcat = fn in (fc.convt4x4s2_in_relu_requant, v1.convt4x4s2_in_relu_requant)
            kk = {"w_kmajor": (fc.pack_convt_kcat_kmajor if kcat
                               else fc.pack_convt_weights_ps_kmajor)(wp)}
            if fn is fc.convt4x4s2_in_relu_requant:  # row 6 is row 5's function
                row5 = fc.convt4x4s2_in_relu_requant_ps(x, fc.pack_convt_weights_ps(
                    w, cin, cin // 2).to(dev))
                check(all(torch.equal(a, b) for a, b in zip(fn(x, wp), row5)),
                      f"convt4x4s2_in_relu_requant equals row 5's kernel to the bit at {side}")
                print(f"[kernel] convt4x4s2_in_relu_requant: equal to "
                      f"convt4x4s2_in_relu_requant_ps's kernel to the bit at [{B}, {side}, "
                      f"{side}, {cin}]", flush=True)
            calls = (lambda: fn(x, wp, **kw, **kk)), (lambda: plain(x, wp, **kw))
            return calls + ((lambda: fn(x, wp, **kw)),) if kcat else calls
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
            # rows 8-9 as the served encoder calls them, with the K-major copy
            wk = fe.pack_conv4x4_kmajor(w)
            return (lambda: fn(x, w, w_kmajor=wk)), (lambda: plain(x, w))
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
            # row 14 as the served decoder calls it, with the packed weights
            pk = fd.pack_final7_weights(args[1])
            return (lambda: fd.final7_tanh_u8(*args, w_packed=pk)), \
                (lambda: fd.final7_tanh_u8_plain(*args))
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
            # row 15 as the served trunk calls it, with the K-major stack
            wk = f3.stack_kmajor(args[2])
            first = f3.fused_trunk_blocks(*args, w_packed=wk)
            again = f3.fused_trunk_blocks(*args)
            check(all(torch.equal(a, b) for a, b in zip(first, again)),
                  "fused_trunk_blocks: a second call, without the K-major stack, gives the same "
                  "bits")
            print(f"[kernel] fused_trunk_blocks: two calls bit-identical (K-major stack given and "
                  f"made by the wrapper); cooperative grid of {f3.LAST_GRID[f3.SITE]} CTAs",
                  flush=True)
            return (lambda: f3.fused_trunk_blocks(*args, w_packed=wk)), \
                (lambda: f3.fused_trunk_blocks_plain(*args))
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
            print("[kernel] enc1_in_relu_requant_im2col: with four equal phase blocks equal to "
                  "enc1_in_relu_requant's kernel to the bit", flush=True)
            # timed with four distinct phase blocks and the K-major copy, as served
            wq = torch.cat([fe.pack_conv4x4(torch.from_numpy(rng.integers(
                -127, 128, (4, 4, 64, 128), dtype=np.int8))) for _ in range(4)]).to(dev)
            wk = fe.pack_enc1_im2col_kmajor(wq)
            return (lambda: fe.enc1_in_relu_requant_im2col(x, wq, w_kmajor=wk)), \
                (lambda: fe.enc1_in_relu_requant_im2col_plain(x, wq))
        return make

    def slab(residual: bool):
        def make():
            args = slab_inputs(torch, dev, 2 ** 20, 8, torch.bfloat16 if residual else None)
            if not residual:
                return (lambda: ep.adain_relu_requant(*args)), \
                    (lambda: ep.adain_relu_requant_plain(*args))
            return (lambda: ep.adain_residual_requant(*args)), \
                (lambda: ep.adain_residual_requant_plain(*args))
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
              ("enc1_in_relu_requant_im2col", f"{label}, four distinct phase blocks", "conv4x4s2",
               (B, 4 * SIDE, C // 4), enc1_im2col(4 * SIDE)),
              ("adain_relu_requant_chunked", f"{label}, int32 [{B}, {SIDE * SIDE}, {C}]",
               "epilogue", (B, SIDE * SIDE, C), epilogue())]
    cases += [("conv3x3_adain_relu_requant_v1", label, "relu", (B, SIDE, C),
               trunk("relu", SIDE, v1)),
              ("conv3x3_adain_residual_requant_v1", label, "residual", (B, SIDE, C),
               trunk("residual", SIDE, v1))]
    for fn, plain, name in ((v1.convt4x4s2_in_relu_requant, v1.convt4x4s2_in_relu_requant_plain,
                             "convt4x4s2_in_relu_requant_v1"),
                            (fc.convt4x4s2_in_relu_requant, fc.convt4x4s2_in_relu_requant_plain,
                             "convt4x4s2_in_relu_requant")):
        cases += [(name, f"{label}, up0", "convt", (B, SIDE, C),
                   convt(fn, plain, SIDE, C, fc.pack_convt_weights)),
                  (name, f"{label}, up1", "convt", (B, 2 * SIDE, C // 2),
                   convt(fn, plain, 2 * SIDE, C // 2, fc.pack_convt_weights))]
    cases += [("adain_relu_requant", f"{label}, int32 [{B}, {SIDE * SIDE}, {C}]", "epilogue",
               (B, SIDE * SIDE, C), slab(False)),
              ("adain_residual_requant", f"{label}, int32 [{B}, {SIDE * SIDE}, {C}], bf16 residual",
               "epilogue_residual", (B, SIDE * SIDE, C), slab(True))]
    return cases


def kernel_phase(torch, fc, fd, fe, f3, ec, v1, ep, dev) -> dict:
    results = {}
    # 256 MiB, past the H100's 50 MB L2: the epilogue rows are also timed cold.
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    for name, label, kind, dims, make in kernel_cases(torch, fc, fd, fe, f3, ec, v1, ep, dev):
        kernel, plain, *made = make()
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        max_step, report = compare(torch, name, got, want)
        if name in EXACT:
            pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
            check(all(torch.equal(g, w) for g, w in pairs),
                  f"{name} ({label}) equal to its plain version to the bit")
            report += "; equal to the bit"
        del got, want
        large = kind == "trunk_v3" or (not kind.startswith("epilogue")
                                       and dims[1] * dims[1] * dims[2] > 256 * 256 * 64)
        reps = 10 if large else 30
        ms = cuda_ms(torch, kernel, reps=reps)
        plain_ms = cuda_ms(torch, plain, reps=2 if large else 3, warmup=1)
        bound_ms, bound_by = bound(kind, *dims)
        row = dict(case=label, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        if made:  # the K-major copy made by the wrapper on every call
            row["ms_copy_made"] = cuda_ms(torch, made[0], reps=reps)
            report += f"; copy made by the wrapper {row['ms_copy_made']:.4f} ms"
        if name in results:  # a further shape or staging of a site already reported
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], max_step)
            results[name]["also"].append(row)
        else:
            results[name] = dict(row, max_abs_err=max_step, also=[])
        shape = [dims[0], dims[1], dims[2]] if kind.startswith("epilogue") else \
            [dims[0], dims[1], dims[1], dims[2]]
        print(f"[kernel] {name} ({label}) in {shape}: "
              f"{report}; {ms:.4f} ms (median of {reps}, CUDA events), plain {plain_ms:.2f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        if kind.startswith("epilogue"):
            # Rows 16-18 read x several times over their launches, largely from
            # L2: their spread, three medians each with L2 warm and flushed.
            warm = [cuda_ms(torch, kernel, reps=30, warmup=1) for _ in range(3)]
            cold = [cuda_ms(torch, kernel, reps=30, warmup=1, flush=flush) for _ in range(3)]
            print(f"[kernel] {name} spread: warm-L2 medians "
                  f"{', '.join(f'{v:.4f}' for v in warm)} ms; L2 flushed before each call "
                  f"{', '.join(f'{v:.4f}' for v in cold)} ms", flush=True)
        del kernel, plain, made
        torch.cuda.empty_cache()
    del flush
    check(set(results) == set(SITES), f"kernel cases cover {sorted(results)}")
    return results


def wgmma_phase(torch, fc, v1, dev) -> None:
    """Rows 1-4 at WGMMA_SHAPES, with and without the K-major copy and twice,
    and row 20 (which makes the copy itself) at the 64x64 maps it takes: every
    output equal to the plain version's to the bit, one launch per call."""
    cfg = fc.wgmma_config()
    print(f"[kernel] wgmma pass A of rows 1-4: {cfg['tile_m']} pixels x 256 (C % 256 == 0) or "
          f"128 channels a tile, {cfg['tile_k_bytes']} bytes of K a stage through a "
          f"{cfg['stages']}-stage ring; {cfg['threads']} threads (producer {cfg['producer_regs']}, "
          f"consumers {cfg['consumer_regs']} registers after setmaxnreg); dynamic shared memory "
          f"{cfg['smem_bytes_n256']} B (BN = 256), {cfg['smem_bytes_n128']} B (BN = 128)",
          flush=True)

    def inputs(b, side, c, seed):
        rng = np.random.default_rng(seed)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        x = t(rng.integers(-127, 128, (b, side, side, c), dtype=np.int8))
        hq = t(rng.integers(-127, 128, (b, side, side, c), dtype=np.int8))
        hs = t(rng.uniform(0.01, 0.05, (b, 1)).astype(np.float32))
        w = fc.pack_weights(torch.from_numpy(rng.integers(-32, 33, (3, 3, c, c),
                                                          dtype=np.int8))).to(dev)
        gamma = t(rng.normal(1.0, 0.5, (b, c)).astype(np.float32))
        beta = t(rng.normal(0.0, 0.5, (b, c)).astype(np.float32))
        return x, hq, hs, w, gamma, beta

    def equal(name, got, want, what):
        got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple)
                                                                   else (want,))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{name} {what} equal to its plain version to the bit")

    names = (fc.RELU_SITE, fc.RESIDUAL_SITE, fc.HIFI_SITE, fc.HIFI2_SITE)
    for b, side, c in WGMMA_SHAPES:
        x, hq, hs, w, gamma, beta = inputs(b, side, c, side + c)
        # the hi-fi carries: a bf16 map, and a second int8 plane beside hq
        rng = np.random.default_rng(side + c + 1)
        hb = torch.from_numpy(rng.normal(0, 1.5, tuple(x.shape)).astype(np.float32)).to(
            dev).to(torch.bfloat16)
        h2 = torch.from_numpy(rng.integers(-127, 128, tuple(x.shape), dtype=np.int8)).to(dev)
        tail = (w, gamma, beta)
        args = {fc.RELU_SITE: (x, *tail), fc.RESIDUAL_SITE: (x, hq, hs, *tail),
                fc.HIFI_SITE: (x, hb, *tail), fc.HIFI2_SITE: (x, hq, h2, hs, *tail)}
        wk = fc.pack_weights_kmajor(w)
        want = {n: getattr(fc, n + "_plain")(*args[n]) for n in names}
        for kw in ({"w_kmajor": wk}, {}, {"w_kmajor": wk}):
            before = dict(fc.LAUNCHES)
            got = {n: getattr(fc, n)(*args[n], **kw) for n in names}
            torch.cuda.synchronize()
            check(fc.LAUNCHES == {**before, **{n: before[n] + 1 for n in names}},
                  f"rows 1-4 at {(b, side, side, c)}: one launch each per call")
            what = f"at {[b, side, side, c]} ({'K-major copy given' if kw else 'copy made'})"
            for n in names:
                equal(n, got[n], want[n], what)
        print(f"[kernel] rows 1-4 at {[b, side, side, c]}: equal to their plain versions to the "
              f"bit, with the K-major copy given and made by the wrapper, over two calls",
              flush=True)
        del x, hq, hb, h2, w, args, want, got
    for b, c in ((1, 128), (B, C)):
        x, hq, hs, w, gamma, beta = inputs(b, 64, c, 9 + c)
        equal("conv3x3_adain_residual_requant_v1",
              v1.conv3x3_adain_residual_requant(x, hq, hs, w, gamma, beta),
              v1.conv3x3_adain_residual_requant_plain(x, hq, hs, w, gamma, beta),
              f"at {[b, 64, 64, c]}")
        print(f"[kernel] row 20 at {[b, 64, 64, c]}: equal to its plain version to the bit",
              flush=True)
    torch.cuda.empty_cache()


def trunk_v3_phase(torch, fc, f3, dev) -> None:
    """Row 15 at TRUNK_V3_SHAPES with and without the K-major stack, twice:
    equal to the plain version to the bit, one launch per call."""
    for b, side, c, n in TRUNK_V3_SHAPES:
        rng = np.random.default_rng(side + c + n)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        w = torch.cat([fc.pack_weights(torch.from_numpy(
            rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8))) for _ in range(2 * n)])
        args = (t(rng.integers(-127, 128, (b, side, side, c), dtype=np.int8)),
                t(rng.uniform(0.5, 2.0, (b, 1)).astype(np.float32)), w.to(dev),
                t(rng.normal(1.0, 0.5, (b, 2 * n, c)).astype(np.float32)),
                t(rng.normal(0.0, 0.5, (b, 2 * n, c)).astype(np.float32)), n)
        want = f3.fused_trunk_blocks_plain(*args)
        wk = f3.stack_kmajor(args[2])
        for kw in ({"w_packed": wk}, {}, {"w_packed": wk}):
            before = f3.LAUNCHES[f3.SITE]
            got = f3.fused_trunk_blocks(*args, **kw)
            torch.cuda.synchronize()
            check(f3.LAUNCHES[f3.SITE] == before + 1,
                  f"fused_trunk_blocks at {(b, side, side, c, n)}: one launch per call")
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"fused_trunk_blocks at {[b, side, side, c]}, {n} blocks "
                  f"({'K-major stack given' if kw else 'stack made'}) equal to its plain version "
                  f"to the bit")
        print(f"[kernel] fused_trunk_blocks at {[b, side, side, c]}, {n} blocks: equal to its "
              f"plain version to the bit, with the K-major stack given and made by the wrapper, "
              f"over two calls; cooperative grid of {f3.LAST_GRID[f3.SITE]} CTAs", flush=True)
    torch.cuda.empty_cache()


def convt_phase(torch, fc, fd, dev) -> None:
    """Rows 5, 12 and 13 (one entry, the ConvT site's two wgmma passes) at
    CONVT_SHAPES, with the K-major copy given and made by the wrapper: every
    output equal to the plain version's to the bit, one launch per call; and
    the two passes' configuration as built."""
    cfg = fc.convt_wgmma_config()
    print("[kernel] wgmma passes of rows 5, 12, 13: tiles of " f"{cfg['tile_m']} pixels; " + "; ".join(
        f"{p} at BN = {bn}: {cfg[f'k_bytes_{p}_n{bn}']} bytes of K a stage, "
        f"{cfg[f'stages_{p}_n{bn}']} stages, {cfg[f'smem_bytes_{p}_n{bn}']} B of shared memory"
        for bn in (128, 64) for p in ("stats", "requant")), flush=True)
    sites = ((fc.convt4x4s2_in_relu_requant_ps, fc.LAUNCHES, fc.CONVT_SITE),
             (fd.up1_s2d16, fd.LAUNCHES, fd.UP1_SITE))
    for b, side, cin, cout, stages in CONVT_SHAPES:
        rng = np.random.default_rng(side + cin + cout)
        x = torch.from_numpy(rng.integers(-127 if cin == C else 0, 128, (b, side, side, cin),
                                          dtype=np.int8)).to(dev)
        w = fc.pack_convt_weights_ps(torch.from_numpy(
            rng.integers(-127, 128, (4, 4, cin, cout), dtype=np.int8)), cin, cout).to(dev)
        wk = fc.pack_convt_weights_ps_kmajor(w)
        for stage in stages:
            want = fd.up1_s2d16_hbm_plain(x, w, stage=stage)
            calls = [(lambda kw, stage=stage: fd.up1_s2d16_hbm(x, w, stage=stage, **kw),
                      fd.LAUNCHES, fd.UP1_HBM_SITE)]
            if stage == "int32":  # the other two sites read the accumulator as int32
                calls += [(lambda kw, fn=fn: fn(x, w, **kw), counts, name)
                          for fn, counts, name in sites]
            for call, counts, name in calls:
                for kw in ({"w_kmajor": wk}, {}):
                    before = counts[name]
                    got = call(kw)
                    torch.cuda.synchronize()
                    check(counts[name] == before + 1, f"{name} at {[b, side, side, cin]}: one launch")
                    check(all(torch.equal(g, v) for g, v in zip(got, want)),
                          f"{name} at {[b, side, side, cin]} -> {cout}, {stage} "
                          f"({'K-major copy given' if kw else 'copy made'}) equal to its plain "
                          f"version to the bit")
        print(f"[kernel] rows 5, 12, 13 at {[b, side, side, cin]} -> {cout} "
              f"({', '.join(stages)}): equal to their plain versions to the bit, with the "
              f"K-major copy given and made by the wrapper", flush=True)
        del x, w, wk, want
        torch.cuda.empty_cache()


def int8_apart(torch, a, b) -> bool:
    """The negation of the kernel phase's int8 bar: the two maps part by more
    than 1 step, or on 1% of the elements or more."""
    diff = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return int(diff.max()) > 1 or float((diff > 0).float().mean()) >= 0.01


def v1_phase(torch, fc, v1, dev) -> None:
    """Rows 6 and 21 at V1_CONVT_SHAPES and row 19 at V1_CONV1_SHAPES, with the
    K-major copy given and made by the wrapper, over two calls: every output
    equal to the plain version's to the bit, one launch per call, row 6 equal
    to row 5's kernel. On one-sign channels (all conv outputs of one sign)
    rows 21 and 6 part by more than the kernel phase's bar, and so do rows
    19 and 1, each equal to its own plain version."""
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    sites = ((v1.convt4x4s2_in_relu_requant, v1.convt4x4s2_in_relu_requant_plain, v1.LAUNCHES,
              v1.CONVT_SITE),
             (fc.convt4x4s2_in_relu_requant, fc.convt4x4s2_in_relu_requant_plain, fc.LAUNCHES,
              fc.KCAT_SITE))

    def convt_calls(b, side, cin, cout, x, w, what):
        kcat = fc.pack_convt_weights(w, cin, cout).to(dev)
        wk = fc.pack_convt_kcat_kmajor(kcat)
        row5 = fc.convt4x4s2_in_relu_requant_ps(x, fc.pack_convt_weights_ps(w, cin, cout).to(dev))
        out = []
        for fn, plain, counts, name in sites:
            want = plain(x, kcat)
            for kw in ({"w_kmajor": wk}, {}, {"w_kmajor": wk}):
                before = counts[name]
                got = fn(x, kcat, **kw)
                torch.cuda.synchronize()
                check(counts[name] == before + 1, f"{name} at {[b, side, side, cin]}: one launch")
                check(all(torch.equal(g, v) for g, v in zip(got, want)),
                      f"{name} at {[b, side, side, cin]} -> {cout}{what} "
                      f"({'K-major copy given' if kw else 'copy made'}) equal to its plain "
                      f"version to the bit")
                if fn is fc.convt4x4s2_in_relu_requant:
                    check(all(torch.equal(g, v) for g, v in zip(got, row5)),
                          f"row 6 at {[b, side, side, cin]}{what} equal to row 5's kernel")
            out.append(got[0])
        return out

    for b, side, cin, cout in V1_CONVT_SHAPES:
        rng = np.random.default_rng(side + cin + cout + 1)
        x = t(rng.integers(-127 if cin == C else 0, 128, (b, side, side, cin), dtype=np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (4, 4, cin, cout), dtype=np.int8))
        convt_calls(b, side, cin, cout, x, w, "")
        print(f"[kernel] rows 21 and 6 at {[b, side, side, cin]} -> {cout}: equal to their plain "
              f"versions to the bit, with the K-major copy given and made by the wrapper, over "
              f"two calls; row 6 equal to row 5's kernel", flush=True)
        del x, w
    # one-sign channels: x >= 0, channels 0-3's weights <= 0
    rng = np.random.default_rng(16)
    x = t(rng.integers(0, 128, (2, 16, 16, 64), dtype=np.int8))
    w = rng.integers(-127, 128, (4, 4, 64, 64), dtype=np.int8)
    w[..., :4] = -np.abs(w[..., :4])
    got21, got6 = convt_calls(2, 16, 64, 64, x, torch.from_numpy(w), ", one-sign channels")
    check(int8_apart(torch, got21, got6), "rows 21 and 6 part on one-sign channels")
    print("[kernel] rows 21 and 6 at [2, 16, 16, 64] -> 64 with one-sign channels: each equal to "
          "its plain version to the bit, the two apart by more than the int8 bar", flush=True)

    def conv1_inputs(b, c, seed, one_sign=False):
        rng = np.random.default_rng(seed)
        x = rng.integers(-127, 128, (b, 64, 64, c), dtype=np.int8)
        w = rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8)
        gamma = rng.normal(1.0, 0.5, (b, c)).astype(np.float32)
        beta = rng.normal(0.0, 0.5, (b, c)).astype(np.float32)
        if one_sign:  # channels 0-3 all positive, gamma < 0: amax at their minimum
            x = np.abs(x.astype(np.int16)).astype(np.int8)
            w[..., :4] = np.abs(w[..., :4]) + 1
            gamma[:, :4], beta[:, :4] = -1.5, 3.0
        wp = fc.pack_weights(torch.from_numpy(w)).to(dev)
        return t(x), wp, t(gamma), t(beta)

    for b, c in V1_CONV1_SHAPES + ((2, 128),):
        one_sign = (b, c) not in V1_CONV1_SHAPES
        x, wp, gamma, beta = conv1_inputs(b, c, 19 + b + c, one_sign)
        wk = fc.pack_weights_kmajor(wp)
        want = v1.conv3x3_adain_relu_requant_plain(x, wp, gamma, beta)
        for kw in ({"w_kmajor": wk}, {}, {"w_kmajor": wk}):
            before = v1.LAUNCHES[v1.RELU_SITE]
            got = v1.conv3x3_adain_relu_requant(x, wp, gamma, beta, **kw)
            torch.cuda.synchronize()
            check(v1.LAUNCHES[v1.RELU_SITE] == before + 1, f"row 19 at {[b, 64, 64, c]}: one launch")
            check(torch.equal(got, want), f"row 19 at {[b, 64, 64, c]} "
                  f"({'K-major copy given' if kw else 'copy made'}) equal to its plain version "
                  f"to the bit")
        if one_sign:
            row1 = fc.conv3x3_adain_relu_requant(x, wp, gamma, beta, w_kmajor=wk)
            check(torch.equal(row1, fc.conv3x3_adain_relu_requant_plain(x, wp, gamma, beta)),
                  "row 1 on one-sign channels equal to its plain version")
            check(int8_apart(torch, got, row1), "rows 19 and 1 part on one-sign channels")
            print(f"[kernel] rows 19 and 1 at {[b, 64, 64, c]} with one-sign channels: each "
                  f"equal to its plain version to the bit, the two apart by more than the int8 "
                  f"bar", flush=True)
        else:
            print(f"[kernel] row 19 at {[b, 64, 64, c]}: equal to its plain version to the bit, "
                  f"with the K-major copy given and made by the wrapper, over two calls",
                  flush=True)
        del x, wp, wk, want, got
    torch.cuda.empty_cache()


def enc_phase(torch, fe, dev) -> None:
    """Rows 7-10 (the encoder's two entries) at ENC_SHAPES and ENC0_SHAPES, the
    4x4/s2 site with the K-major copy given and made by the wrapper: every
    output equal to the plain version's to the bit, one launch per call; and
    the 4x4/s2 site's passes as built."""
    cfg = fe.conv4x4s2_wgmma_config()
    print("[kernel] wgmma passes of rows 8-9: tiles of " f"{cfg['tile_m']} pixels; " + "; ".join(
        f"{p} at BN = {bn}: {cfg[f'k_bytes_{p}_n{bn}']} bytes of K a stage, "
        f"{cfg[f'stages_{p}_n{bn}']} stages, {cfg[f'smem_bytes_{p}_n{bn}']} B of shared memory"
        for bn in (256, 128, 64) for p in ("stats", "requant")), flush=True)
    for b, side, cin, cout in ENC_SHAPES:
        rng = np.random.default_rng(side + cin + cout)
        x = torch.from_numpy(rng.integers(0, 128, (b, side, side, cin), dtype=np.int8)).to(dev)
        w = fe.pack_conv4x4(torch.from_numpy(
            rng.integers(-127, 128, (4, 4, cin, cout), dtype=np.int8))).to(dev)
        wk = fe.pack_conv4x4_kmajor(w)
        want = fe.enc2_in_relu_requant_plain(x, w)
        for fn, name in ((fe.enc1_in_relu_requant, fe.ENC1_SITE),
                         (fe.enc2_in_relu_requant, fe.ENC2_SITE)):
            for kw in ({"w_kmajor": wk}, {}):
                before = fe.LAUNCHES[name]
                got = fn(x, w, **kw)
                torch.cuda.synchronize()
                check(fe.LAUNCHES[name] == before + 1, f"{name} at {[b, side, side, cin]}: one launch")
                got = got if isinstance(got, tuple) else (got, want[1])
                check(all(torch.equal(g, v) for g, v in zip(got, want)),
                      f"{name} at {[b, side, side, cin]} -> {cout} "
                      f"({'K-major copy given' if kw else 'copy made'}) equal to its plain version "
                      f"to the bit")
        print(f"[kernel] rows 8-9 at {[b, side, side, cin]} -> {cout}: equal to their plain "
              f"versions to the bit (int8 map and inverse scale), with the K-major copy given and "
              f"made by the wrapper", flush=True)
        del x, w, wk, want, got
        torch.cuda.empty_cache()
    for b, h, w_, stages in ENC0_SHAPES:
        rng = np.random.default_rng(h + w_)
        img = torch.from_numpy(rng.integers(0, 256, (b, h, w_, 3), dtype=np.uint8)).to(dev)
        w = fe.pack_enc0(torch.from_numpy(
            rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8))).to(dev)
        for stage in stages:
            want = fe.enc0_hbm_plain(img, w, stage=stage)
            calls = [(lambda stage=stage: fe.enc0_hbm(img, w, stage=stage), fe.ENC0_HBM_SITE)]
            if stage == "int32":
                calls.append((lambda: fe.enc0_in_relu_requant(img, w), fe.ENC0_SITE))
            for call, name in calls:
                before = fe.LAUNCHES[name]
                got = call()
                torch.cuda.synchronize()
                check(fe.LAUNCHES[name] == before + 1, f"{name} at {[b, h, w_, 3]}: one launch")
                check(torch.equal(got, want), f"{name} at {[b, h, w_, 3]}, {stage} equal to its "
                                              f"plain version to the bit")
        print(f"[kernel] rows 7 and 10 at {[b, h, w_, 3]} ({', '.join(stages)}): equal to their "
              f"plain versions to the bit", flush=True)
        del img, w, want, got
        torch.cuda.empty_cache()
    for b, h, w_ in ENC1_I2C_SHAPES:
        rng = np.random.default_rng(h + w_ + 1)
        x = torch.from_numpy(rng.integers(0, 128, (b, h, w_, 64), dtype=np.int8)).to(dev)
        kernels = [torch.from_numpy(rng.integers(-127, 128, (4, 4, 64, 128), dtype=np.int8))
                   for _ in range(4)]
        wq = torch.cat([fe.pack_conv4x4(k) for k in kernels]).to(dev)  # four distinct blocks
        wk = fe.pack_enc1_im2col_kmajor(wq)
        want = fe.enc1_in_relu_requant_im2col_plain(x, wq)
        for kw in ({"w_kmajor": wk}, {}):
            before = fe.LAUNCHES[fe.ENC1_I2C_SITE]
            got = fe.enc1_in_relu_requant_im2col(x, wq, **kw)
            torch.cuda.synchronize()
            check(fe.LAUNCHES[fe.ENC1_I2C_SITE] == before + 1,
                  f"enc1_in_relu_requant_im2col at {[b, h, w_, 64]}: one launch")
            check(torch.equal(got, want),
                  f"enc1_in_relu_requant_im2col at {[b, h, w_, 64]}, four distinct phase blocks "
                  f"({'K-major copy given' if kw else 'copy made'}) equal to its plain version to "
                  f"the bit")
        w4, w1 = fe.pack_enc1_im2col(kernels[0]).to(dev), fe.pack_conv4x4(kernels[0]).to(dev)
        check(torch.equal(fe.enc1_in_relu_requant_im2col(x, w4, w_kmajor=fe.pack_enc1_im2col_kmajor(
            w4)), fe.enc1_in_relu_requant(x, w1, w_kmajor=fe.pack_conv4x4_kmajor(w1))),
              f"enc1_in_relu_requant_im2col at {[b, h, w_, 64]}, four equal blocks, equal to "
              f"enc1_in_relu_requant to the bit")
        print(f"[kernel] row 11 at {[b, h, w_, 64]}: with four distinct phase blocks equal to its "
              f"plain version to the bit (K-major copy given and made by the wrapper), with four "
              f"equal blocks equal to row 8 to the bit", flush=True)
        del x, wq, wk, want, got, w4, w1
        torch.cuda.empty_cache()


def device_launches(torch, fn, calls: int = 10) -> float:
    """Kernel launches on the card per call of ``fn`` (``torch.profiler``, over
    ``calls`` calls after one; memsets count), or nan where the trace holds no
    device events in each of three tries (a trace that lost its events)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if n:
            return n / calls
    return float("nan")


def epilogue_phase(torch, ec, dev) -> None:
    """Row 18 at the main path's [8, 4096, 256] with |x| < 2^20 and over the
    whole int32 range: equal to its plain version to the bit, two calls alike,
    one launch a call (the count; the card's trace in ``epilogue_split_phase``),
    its cooperative grid and the items a sample is cut into."""
    for lim in (2 ** 20, 2 ** 31 - 1):
        rng = np.random.default_rng(lim % 1000)
        x = torch.from_numpy(rng.integers(-lim, lim, (B, SIDE * SIDE, C), dtype=np.int64).astype(
            np.int32)).to(dev)
        g = torch.from_numpy(rng.normal(1.0, 0.5, (B, C)).astype(np.float32)).to(dev)
        be = torch.from_numpy(rng.normal(0.0, 0.5, (B, C)).astype(np.float32)).to(dev)
        want = ec.adain_relu_requant_chunked_plain(x, g, be)
        before = ec.LAUNCHES[ec.SITE]
        first, again = ec.adain_relu_requant_chunked(x, g, be), ec.adain_relu_requant_chunked(x, g, be)
        torch.cuda.synchronize()
        check(ec.LAUNCHES[ec.SITE] == before + 2, "adain_relu_requant_chunked: one launch a call")
        check(torch.equal(first, want) and torch.equal(again, first),
              f"adain_relu_requant_chunked at |x| < {lim + 1}: equal to its plain version to the "
              f"bit, two calls alike")
        grid = ec.cooperative_grid()
        print(f"[kernel] row 18 at {[B, SIDE * SIDE, C]}, |x| < {lim + 1}: equal to its plain "
              f"version to the bit, two calls alike; cooperative grid of {grid} CTAs, "
              f"{ec.parts(grid, B)} items a sample", flush=True)
        del x, g, be, want, first, again
        torch.cuda.empty_cache()


def slab_inputs(torch, dev, lim: int, seed: int, res_dtype=None) -> tuple:
    """Rows 16-17's inputs at the main path's [8, 4096, 256]: int32 x in
    (-lim, lim), gamma, beta, and a residual of ``res_dtype`` where given."""
    rng = np.random.default_rng(seed)
    shape = (B, SIDE * SIDE, C)
    args = (torch.from_numpy(rng.integers(-lim, lim, shape, dtype=np.int64).astype(np.int32)),
            torch.from_numpy(rng.normal(1.0, 0.5, (B, C)).astype(np.float32)),
            torch.from_numpy(rng.normal(0.0, 0.5, (B, C)).astype(np.float32)))
    if res_dtype is not None:
        args += (torch.from_numpy(rng.normal(0, 1.5, shape).astype(np.float32)).to(res_dtype),)
    return tuple(a.to(dev) for a in args)


def slab_phase(torch, ep, dev) -> None:
    """Rows 16-17 at the main path's [8, 4096, 256] with |x| < 2^20 and over
    the whole int32 range, the residual in bf16 and in fp32: equal to their
    plain versions to the bit (int8 and h), two calls alike, one launch a call
    (the count; the card's trace in ``slab_split_phase``), the cooperative grid
    and the items (128-row chunks) a sample."""
    for lim in (2 ** 20, 2 ** 31 - 1):
        for res_dtype in (None,) + ep.RESIDUAL_DTYPES:
            args = slab_inputs(torch, dev, lim, lim % 1000 + 3, res_dtype)
            if res_dtype is None:
                name, kernel, plain = "adain_relu_requant", ep.adain_relu_requant, \
                    ep.adain_relu_requant_plain
            else:
                name, kernel, plain = "adain_residual_requant", ep.adain_residual_requant, \
                    ep.adain_residual_requant_plain
            want = plain(*args)
            before = ep.LAUNCHES[name]
            first, again = kernel(*args), kernel(*args)
            torch.cuda.synchronize()
            check(ep.LAUNCHES[name] == before + 2, f"{name}: one launch a call")
            pairs = zip(first, want, again) if isinstance(first, tuple) else ((first, want, again),)
            check(all(torch.equal(f, w) and torch.equal(a, f) for f, w, a in pairs),
                  f"{name} ({res_dtype}) at |x| < {lim + 1}: equal to its plain version to the "
                  f"bit, two calls alike")
            grid = ep.cooperative_grid(res_dtype)
            print(f"[kernel] {name}{'' if res_dtype is None else f' ({str(res_dtype)[6:]} residual)'}"
                  f" at {[B, SIDE * SIDE, C]}, |x| < {lim + 1}: equal to its plain version to the "
                  f"bit, two calls alike; cooperative grid of {grid} CTAs, "
                  f"{-(-SIDE * SIDE // ep.ROWS)} items (128-row chunks) a sample", flush=True)
            del args, want, first, again
            torch.cuda.empty_cache()


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


def e2e_phase(torch, mods, ap, work: str) -> dict:
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
        digest = hashlib.sha256()
        for name in names:
            digest.update(name.encode())
            digest.update(images[name].tobytes())
        result["sha256"][path] = digest.hexdigest()
        print(f"[e2e {path}] served images sha256 {digest.hexdigest()} ({len(names)} images, "
              f"pixels by file name)", flush=True)
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

    result = dict(psnr={}, ms={}, sha256={})
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

    # ---- 256²: the float path with --pallas, its AdaIN on the fused kernel.
    out = os.path.join(work, "out_256_float_pallas")
    args = cli.build_arg_parser().parse_args([
        "--input_dir", inp, "--ref_domains_dir", ref, "--checkpoint_dir", DEMO,
        "--output_dir", out, "--target_domain", TARGET, "--style_mode", "average",
        "--image_size", "256", "--batch_size", str(B), "--compute_dtype", "float32",
        "--device", "cuda", "--pallas"])
    reset_counts(mods + (ap,))
    rc = cli.main(cli.config_from_args(args))
    torch.cuda.synchronize()
    ran = {k: v for k, v in read_counts(mods + (ap,)).items() if v}
    check(rc == 0, f"[256/float+pallas] inference main exit code {rc} == 0")
    check(ran == {ap.FWD: 2 * N_RES * n_batches},
          f"[256/float+pallas] launches {ran}: want {ap.FWD} x {2 * N_RES} per generator call")
    images = {}
    for name in sorted(os.listdir(out)):
        with Image.open(os.path.join(out, name)) as im:
            images[name] = np.asarray(im)
    total, lo, hi = total_psnr(images, want)
    check(total >= 40.0, f"[256/float+pallas] vs the fp32 float path: PSNR {total:.2f} dB >= 40")
    fl_pallas = InferenceEngine.build(
        InferenceConfig(image_size=256, batch_size=B, device="cuda", compute_dtype="float32",
                        use_pallas=True), 10, gen_sd, se_sd, n_res, meta["style_dim"])
    reset_counts((ap,))
    fl_pallas.generate(imgs, styles)
    torch.cuda.synchronize()
    check(ap.LAUNCHES[ap.FWD] == 2 * N_RES, f"[256/float+pallas] {ap.FWD} launched "
                                            f"{ap.LAUNCHES[ap.FWD]} times in one generator call")
    ms = cuda_ms(torch, lambda: fl_pallas.generate(imgs, styles), reps=5, warmup=2)
    result["psnr"]["256/float+pallas"], result["ms"]["256/float+pallas"] = total, ms
    print(f"[e2e 256/float+pallas] inference main --pallas (fp32): rc 0, {len(images)} images, "
          f"{ap.FWD} {ran[ap.FWD]} launches ({2 * N_RES} per generator call); vs the fp32 float "
          f"path: PSNR {total:.2f} dB (per image min {lo:.2f}, max {hi:.2f}); float32 generator "
          f"with use_pallas, batch {B}: {ms:.2f} ms per batch (median of 5, CUDA events)",
          flush=True)
    del fl_pallas

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
        digest = hashlib.sha256()
        for name in sorted(images):
            digest.update(name.encode())
            digest.update(images[name].tobytes())
        result["sha256"][label] = digest.hexdigest()
        print(f"[e2e {label}] quantized_generator_apply(fused_trunk=False, fused_epilogue="
              f"{fused_epilogue}): int8 vs fp32 float path PSNR {result['psnr'][label]:.2f} dB "
              f"(per image min {lo:.2f}, max {hi:.2f}); {ms:.2f} ms per batch of {B} (median of "
              f"5, CUDA events); images sha256 {digest.hexdigest()} (pixels by file name)",
              flush=True)
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

    # ---- 224²: away from 256² and 512² the unfused chain throughout, no kernel site.
    served = serve("224/int8", 224, "0")
    levels = len(np.unique(np.stack(list(served.values()))))
    check(levels > 50, f"[224/int8] the served images hold {levels} distinct values")
    print(f"[e2e 224/int8] {len(served)} images of 224², {levels} distinct values, no kernel site "
          f"launched (the unfused int8 chain, as the JAX package takes it away from 256² and 512²)",
          flush=True)

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
    for hifi in ("1", "2"):
        with env(MSIG_TRUNK_HIFI=hifi):
            ms = cuda_ms(torch, lambda: q8.generate(imgs, styles), reps=5, warmup=2)
        result["ms"][f"512/hifi{hifi}"] = ms
        print(f"[e2e 512/hifi{hifi}] int8 generator, batch {B}: {ms:.2f} ms per batch, "
              f"{B / (ms / 1e3):.1f} images/s (median of 5, CUDA events)", flush=True)
    with env(MSIG_STAGE_FP16="1"):
        staged_fp16 = reference(q8, bank)
    result["psnr"]["512/stage_fp16=1"] = total_psnr(staged_fp16, want)[0]
    print(f"[e2e 512] MSIG_STAGE_FP16=1 on the {N_INPUTS} inputs: PSNR vs fp32 float path "
          f"{result['psnr']['512/stage_fp16=1']:.2f} dB (int32 staging "
          f"{result['psnr']['512']:.2f}), vs the int32-staged output "
          f"{total_psnr(staged_fp16, served)[0]:.2f} dB", flush=True)
    stage_times(q8.q, imgs, styles, "512")
    result["launches"] = {name: path_launches[path][name] for name, (_, _, path) in SITES.items()
                          if path in PATHS}
    return result


def tools_phase(torch, mods) -> dict:
    """The tools/v1_v2 path: ``python -m msig_tpu_torch.tools.bench_v1_v2`` and
    ``...profile_fused_stages`` at batch 8 on the card, once with one call of
    each site or stage (the launch counts set to 0 before each tool and read
    after it; returned as the path's launches) and once timed (3 warm-up and
    10 timed calls; counted too). Each tool's launches, per site or stage and
    in all, must be those the stages name, and no other kernel's."""
    from msig_tpu_torch.tools import bench_v1_v2, profile_fused_stages

    def total(per_call: dict, calls: int) -> dict:
        out = {}
        for d in per_call.values():
            for k, v in d.items():
                out[k] = out.get(k, 0) + v * calls
        return {k: v for k, v in out.items() if v}

    launches = {}
    for tool, expect, key in ((bench_v1_v2, BENCH_SITES, "sites"),
                              (profile_fused_stages, PROFILE_STAGES, "stages")):
        name = tool.__name__.rsplit(".", 1)[1]
        for one_pass in (True, False):
            argv = ["--batch", str(B), "--device", "cuda"] + (
                ["--warmup", "0", "--iters", "1"] if one_pass else [])
            with env(MSIG_TRUNK_HIFI="0", MSIG_TRUNK_V3="0", MSIG_ENC1_IM2COL="0"):
                reset_counts(mods)
                t0 = time.perf_counter()
                r = tool.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                ran = {k: v for k, v in read_counts(mods).items() if v}
            calls = r["calls"]
            check(list(r[key]) == list(expect), f"[{TOOLS_PATH}] {name} {key} {list(r[key])}")
            for stage, per_call in expect.items():
                want = {k: v * calls for k, v in per_call.items()}
                check(r[key][stage]["launches"] == want,
                      f"[{TOOLS_PATH}] {name} {stage!r}: launches {r[key][stage]['launches']}, "
                      f"want {want}")
            check(ran == total(expect, calls),
                  f"[{TOOLS_PATH}] {name}: launches {ran}, want {total(expect, calls)}")
            if one_pass:
                for k, v in ran.items():
                    launches[k] = launches.get(k, 0) + v
            print(f"[{TOOLS_PATH}] python -m msig_tpu_torch.tools.{name} {' '.join(argv)}: "
                  f"{wall:.1f} s, {calls} call(s) of each {key[:-1]}, launches {ran}", flush=True)
    return launches


def train_bound(name: str, b: int) -> tuple:
    """(bound_ms, bound_by, fp32_fma_ms) of one call of a training kernel on
    the [b, 64, 64, 256] trunk.

    Bytes: each fp32 input read once, each output written once. Operations:
    per element of the map about 8 flops for an instance-norm pass
    (statistics, normalisation, modulation; the backward's two sums and its
    dx) at the fp32 rate, and the conv backward's two products, dx and dW,
    2 * 2 * (B*H*W) * C * 9*Co flops, as three TF32 tensor-core passes: at
    fp32 accuracy (3xTF32, the conv kernels' route; one pass misses the bars)
    the least time is 3x the products at the dense TF32 rate. fp32_fma_ms:
    the same work with the products at the fp32 FMA rate of the CUDA cores
    (TF32 off; the first version's route), None for the AdaIN rows."""
    px, vec = b * SIDE * SIDE, 4 * b * C
    elems = px * C
    t_fma = None
    if name == "adain_pallas_fwd":
        nbytes, t_ops = 2 * 4 * elems + 4 * vec, 8 * elems / PEAK_FP32_FLOPS  # x -> y
    elif name == "adain_pallas_bwd":
        nbytes, t_ops = 3 * 4 * elems + 5 * vec, 8 * elems / PEAK_FP32_FLOPS  # x, dy -> dx
    else:
        conv = 2 * 2 * px * C * 9 * C
        w = 2 * 4 * 9 * C * C                                     # W read, dW written
        if name == "conv3x3_bwd":
            nbytes, fp = 3 * 4 * elems + w, 0                     # x, dy -> dx
        else:
            nbytes, fp = 4 * 4 * elems + w + 5 * vec, 8 * elems   # x, y, g -> dx
        t_ops = 3 * conv / PEAK_TF32_FLOPS + fp / PEAK_FP32_FLOPS
        t_fma = max((conv + fp) / PEAK_FP32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), t_fma


def kernel_split(torch, fn, calls: int = 10, groups=TRAIN_GROUPS) -> dict:
    """Device ms per call of each kernel that ``fn`` launches, by
    ``torch.profiler`` over ``calls`` calls after one, grouped by the first
    (label, name part) of ``groups`` whose part the kernel's name holds, else
    as PyTorch's own kernels (for the conv backwards, ``TRAIN_GROUPS``: row
    24's IN backward, the conv core, the in-order reductions, and the taps'
    transposed copy); {} if the trace holds no device events, or holds a
    kernel's launches in a number that is no multiple of ``calls`` (a trace
    that lost events, which would read as a rate past the card's peak) in
    each of three tries."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out, count = {}, {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = next((g for g, k in groups if k in e.name), "PyTorch kernels")
                out[key] = out.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
                count[e.name] = count.get(e.name, 0) + 1
        if out and all(n % calls == 0 for n in count.values()):
            return out
    return {}


def close(torch, name: str, got, want, rtol: float = 1e-4, atol_rel: float = 1e-5) -> tuple:
    """Hold a float output against the plain version's; returns the max abs
    error and the worst share of the bar, max |got - want| / (atol + rtol |want|)."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    err = float((got - want).abs().max())
    atol = atol_rel * float(want.abs().max())
    check(bool(torch.allclose(got, want, rtol=rtol, atol=atol)),
          f"{name}: max abs err {err:.3e} beyond rtol {rtol} / atol {atol:.3e}")
    return err, float(((got - want).abs() / (atol + rtol * want.abs())).max())


def hold_train_kernel(torch, name: str, kernel, plain, x, relu: bool) -> tuple:
    """One call of a training kernel against its plain version: every output
    within its bar, dx exactly 0 under the relu mask, dW the same bits on a
    second call. Returns (max abs error, report)."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    errs, shares = [], []
    for k, (gt, wt) in enumerate(zip(got, want)):
        stat = (name.endswith("_bwd") and gt.dim() == 2 and name != "conv3x3_bwd"
                and k >= 1)  # dgamma, dbeta: sums over a whole image
        err, share = close(torch, f"{name} output {k}", gt, wt, *((1e-5, 1e-6) if stat else ()))
        errs.append(err)
        shares.append(share)
    report = (f"max abs err {max(errs):.3e}, worst share of the bar "
              f"{', '.join(f'{v:.3f}' for v in shares)} (outputs in order)")
    if name.startswith("conv3x3"):
        if relu:
            check(bool((got[0][x <= 0] == 0).all()), f"{name}: dx is 0 where x <= 0")
            report += ", dx exactly 0 under the relu mask"
        again = kernel()
        check(torch.equal(again[1], got[1]), f"{name}: a second call gives the same dW")
        report += ", dW bit-identical over two calls"
    else:  # row 22: fixed summation order across the cluster
        again = kernel()
        check(all(torch.equal(a, g) for a, g in zip(again, got)),
              f"{name}: a second call gives the same bits")
        report += ", every output bit-identical over two calls"
    return max(errs), report


def adain_plan_line(torch, ap, b: int, s: int, c: int, dtype, backward: bool) -> str:
    """Row 22's launch at [b, s, c]: ``ap.plan`` and the card's
    cudaOccupancyMaxActiveClusters for it."""
    p = ap.plan(s, c)
    n = ap.max_active_clusters(p, s, c, dtype, backward)
    return (f"cluster of {p.cluster} CTAs x {p.rows} pixel rows, streamed (later passes from "
            f"L2), {b * p.ctas_per_sample} CTAs, {ap.STATIC_SMEM} B of shared memory a CTA, "
            f"cudaOccupancyMaxActiveClusters {n}")


def adain_cluster_phase(torch, ap, dev) -> None:
    """Row 22 (forward and backward, one cluster per sample and 32 channels)
    at the train step's trunk, [8|4, 4096, 256], and at the TPU kernel's
    largest fp32 slab, [1, 16384, 256], in fp32 and
    bf16: each output within its bar of the plain version (fp32 rtol 1e-4 /
    atol 1e-5 x max, dgamma and dbeta 1e-5 / 1e-6; bf16 y and dx 2e-2, one
    bf16 rounding), bit-identical over two calls, one launch a call; the plan
    of each."""
    for b, s in ((2 * TRAIN_B, SIDE * SIDE), (TRAIN_B, SIDE * SIDE), (1, 16384)):
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.default_rng(s + b)
            t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
            x = t(rng.normal(0.3, 2.0, (b, s, C))).to(dtype)
            dy = t(rng.normal(0, 1, (b, s, C))).to(dtype)
            gamma, beta = t(rng.normal(1.0, 0.5, (b, C))), t(rng.normal(0.0, 0.5, (b, C)))
            _, mean, rstd = ap.adain_fwd_plain(x, gamma, beta)
            for name, kernel, plain, backward in (
                    ("adain_pallas_fwd", lambda: ap.adain_fwd(x, gamma, beta),
                     lambda: ap.adain_fwd_plain(x, gamma, beta), False),
                    ("adain_pallas_bwd", lambda: ap.adain_bwd(x, gamma, mean, rstd, dy),
                     lambda: ap.adain_bwd_plain(x, gamma, mean, rstd, dy), True)):
                before = ap.LAUNCHES[name]
                got, again = kernel(), kernel()
                want = plain()
                torch.cuda.synchronize()
                check(ap.LAUNCHES[name] == before + 2, f"{name}: one launch a call")
                check(all(torch.equal(a, g) for a, g in zip(again, got)),
                      f"{name} at {[b, s, C]} {dtype}: a second call gives the same bits")
                errs = []
                for k, (g, w) in enumerate(zip(got, want)):
                    if g.dim() == 3:  # y, dx: one bf16 rounding in bf16
                        bar = (2e-2, 2e-2) if dtype == torch.bfloat16 else (1e-4, 1e-5)
                    else:  # mean, rstd; dgamma, dbeta: sums over a whole image
                        bar = (1e-5, 1e-6) if backward else (1e-4, 1e-5)
                    errs.append(close(torch, f"{name} output {k}", g.float(), w.float(), *bar)[0])
                print(f"[train kernel] {name} at {[b, s, C]} {str(dtype)[6:]}: "
                      f"{adain_plan_line(torch, ap, b, s, C, dtype, backward)}; max abs err "
                      f"{max(errs):.3e} within the bars, every output bit-identical over two "
                      f"calls", flush=True)
            del x, dy
            torch.cuda.empty_cache()


def train_kernel_phase(torch, ap, cv, dev) -> tuple:
    """The four training kernels against their plain versions at both train
    shapes, and the two conv kernels at a ragged pixel count. Returns the
    rows and, for ``split_phase``, (row, label, call) of each conv case
    without the relu input."""
    results, to_split = {}, []

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    def unit(b, side, seed):
        rng = np.random.default_rng(seed)
        x = t(rng.normal(0, 1, (b, side, side, C)))
        w = t(rng.uniform(-1, 1, (3, 3, C, C)) / np.sqrt(9 * C))
        gamma, beta = t(rng.normal(1.0, 0.5, (b, C))), t(rng.normal(0.0, 0.5, (b, C)))
        return x, w, gamma, beta, t(rng.normal(0, 1, (b, side, side, C)))

    def conv_cases(x, w, gamma, beta, g):
        cases = []
        for relu in (False, True):
            cases.append(("conv3x3_bwd", relu,
                          lambda relu=relu: cv.conv3x3_bwd(x, w, g, relu_input=relu),
                          lambda relu=relu: cv.conv3x3_bwd_plain(x, w, g, relu_input=relu)))
            _, (yy, mu, r) = cv._adain_unit_fwd_impl(x, w, gamma, beta, relu)
            cases.append(("conv3x3_adain_bwd", relu,
                          lambda relu=relu, yy=yy, mu=mu, r=r: cv.conv3x3_adain_bwd(
                              x, w, yy, mu, r, gamma, g, relu_input=relu),
                          lambda relu=relu, yy=yy, mu=mu, r=r: cv.conv3x3_adain_bwd_plain(
                              x, w, yy, mu, r, gamma, g, relu_input=relu)))
        return cases

    def cudnn_ms(lib, deterministic: bool) -> float:
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = deterministic
        try:
            return cuda_ms(torch, lib, reps=20)
        finally:
            torch.backends.cudnn.deterministic = prev

    cfg = cv.kernel_config()
    check(cfg["max_k"] == cv._MAX_K and cfg["ctas_per_sm"] >= 1 and cfg["ctas_per_sm_relu"] >= 1,
          f"conv core configuration {cfg} (max_k {cv._MAX_K} in ops/conv3x3_vjp.py)")
    print(f"[train kernel] conv core: CTA tile {cfg['tile_m']} x {cfg['tile_n']}, "
          f"{cfg['threads']} threads, K {cfg['tile_k']} a stage through a {cfg['stages']}-stage "
          f"cp.async ring, {cfg['smem_bytes']} bytes of shared memory, at most {cfg['max_k']} of "
          f"K a tile; {cfg['ctas_per_sm']} CTAs per SM resident ({cfg['ctas_per_sm_relu']} with "
          f"the relu input; occupancy API)", flush=True)
    for b in (2 * TRAIN_B, TRAIN_B):
        x, w, gamma, beta, g = unit(b, SIDE, b)
        x3, g3 = x.reshape(b, SIDE * SIDE, C), g.reshape(b, SIDE * SIDE, C)
        y, mean, rstd = ap.adain_fwd_plain(x3, gamma, beta)
        nchw = lambda v: v.permute(0, 3, 1, 2)  # noqa: E731  (channels_last views for cuDNN)
        library = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            nchw(g), nchw(x), w.permute(3, 2, 0, 1).contiguous(), None, [1, 1], [1, 1], [1, 1],
            False, [0, 0], 1, [True, True, False])
        lib_ms = {False: cudnn_ms(library, False), True: cudnn_ms(library, True)}
        cases = [("adain_pallas_fwd", False, lambda: ap.adain_fwd(x3, gamma, beta),
                  lambda: ap.adain_fwd_plain(x3, gamma, beta))]
        cases.append(("adain_pallas_bwd", False, lambda: ap.adain_bwd(x3, gamma, mean, rstd, g3),
                      lambda: ap.adain_bwd_plain(x3, gamma, mean, rstd, g3)))
        cases += conv_cases(x, w, gamma, beta, g)
        for name, relu, kernel, plain in cases:
            err, report = hold_train_kernel(torch, name, kernel, plain, x, relu)
            tag = ", relu input" if relu else ""
            ms = cuda_ms(torch, kernel, reps=20 if name.startswith("conv") else 50)
            plain_ms = cuda_ms(torch, plain, reps=3, warmup=1)
            bound_ms, bound_by, fma_ms = train_bound(name, b)
            row = dict(case=f"[{b}, {SIDE}, {SIDE}, {C}]{tag}", ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, bound_fp32_fma_ms=fma_ms,
                       library_ms=lib_ms[False] if name == "conv3x3_bwd" else None,
                       library_deterministic_ms=lib_ms[True] if name == "conv3x3_bwd" else None)
            extra = ""
            if name == "conv3x3_bwd":
                faster = ms < min(lib_ms.values())
                extra += (f", cuDNN convolution_backward {lib_ms[False]:.4f} ms (default "
                          f"algorithms) / {lib_ms[True]:.4f} ms (deterministic): the kernel is "
                          f"{'faster than' if faster else 'NOT faster than'} both")
            if fma_ms is not None:
                extra += f"; the same work at the fp32 FMA rate {fma_ms:.4f} ms"
            if name in results:
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
                results[name]["also"].append(row)
            else:
                results[name] = row = dict(row, max_abs_err=err, also=[])
            if name.startswith("conv") and not relu:
                to_split.append((row, f"{name} ({row['case']})", kernel))
            print(f"[train kernel] {name} ({row['case']}): {report}; {ms:.4f} ms (median of "
                  f"{20 if name.startswith('conv') else 50}, CUDA events), plain {plain_ms:.3f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}){extra}", flush=True)
        del x, w, g, y
        torch.cuda.empty_cache()
    # a 96² trunk: 576 pixels, which the 128-pixel tiles cover with a ragged edge
    x, w, gamma, beta, g = unit(1, 24, 24)
    for name, relu, kernel, plain in conv_cases(x, w, gamma, beta, g):
        err, report = hold_train_kernel(torch, name, kernel, plain, x, relu)
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        print(f"[train kernel] {name} ([1, 24, 24, {C}]{', relu input' if relu else ''}; 576 "
              f"pixels, a ragged edge): {report}", flush=True)
    check(set(results) == set(TRAIN_KERNELS), f"train kernel cases cover {sorted(results)}")
    return results, to_split


def trunk_split_phase(torch, fc, kernels: dict) -> None:
    """Rows 1-4 at the trunk shapes of a 256² and a 512² input: the time per
    call by CUDA events (median of 30) and by ``torch.profiler`` device time per
    kernel (``kernel_split`` with ``TRUNK_GROUPS``), pass A's int8 rate and its
    share of the card's 1,979 TOP/s, which of the two the row's time follows,
    and the device memory a call allocates at its peak beyond its inputs. The
    parts go into the row as ``parts_ms``. Run last, as ``split_phase``."""
    for grid in (SIDE, 2 * SIDE):
        rng = np.random.default_rng(grid)
        t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
        x = t(rng.integers(-127, 128, (B, grid, grid, C), dtype=np.int8))
        hq = t(rng.integers(-127, 128, (B, grid, grid, C), dtype=np.int8))
        hs = t(rng.uniform(0.01, 0.05, (B, 1)).astype(np.float32))
        hb = t(rng.normal(0, 1.5, (B, grid, grid, C)).astype(np.float32)).to(torch.bfloat16)
        h2 = t(rng.integers(-127, 128, (B, grid, grid, C), dtype=np.int8))
        w = fc.pack_weights(torch.from_numpy(rng.integers(-32, 33, (3, 3, C, C), dtype=np.int8)))
        w, wk = w.cuda(), fc.pack_weights_kmajor(w).cuda()
        gamma = t(rng.normal(1.0, 0.5, (B, C)).astype(np.float32))
        beta = t(rng.normal(0.0, 0.5, (B, C)).astype(np.float32))
        ops = 2 * B * grid * grid * C * 9 * C
        for name, call in (
                ("conv3x3_adain_relu_requant",
                 lambda: fc.conv3x3_adain_relu_requant(x, w, gamma, beta, w_kmajor=wk)),
                ("conv3x3_adain_residual_requant",
                 lambda: fc.conv3x3_adain_residual_requant(x, hq, hs, w, gamma, beta,
                                                           w_kmajor=wk)),
                ("conv3x3_adain_residual_hifi",
                 lambda: fc.conv3x3_adain_residual_hifi(x, hb, w, gamma, beta, w_kmajor=wk)),
                ("conv3x3_adain_residual_hifi2",
                 lambda: fc.conv3x3_adain_residual_hifi2(x, hq, h2, hs, w, gamma, beta,
                                                         w_kmajor=wk))):
            ms = cuda_ms(torch, call, reps=30)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            call()
            torch.cuda.synchronize()
            peak_mb = (torch.cuda.max_memory_allocated() - held) / 1e6
            parts = kernel_split(torch, call, groups=TRUNK_GROUPS)
            device = sum(parts.values())
            row = kernels[name] if grid == SIDE else next(
                r for r in kernels[name]["also"] if r["case"] == "512² input")
            row["parts_ms"] = parts
            a = parts.get("pass A (wgmma)")
            rate = (f"pass A {ops / (a * 1e-3) / 1e12:.1f} TOP/s, "
                    f"{ops / (a * 1e-3) / PEAK_INT8_OPS:.1%} of 1,979" if a else
                    "pass A not measured (the trace holds no device events)")
            follows = ("not measured" if not device else
                       "the device (events within 10% of the kernels' sum)" if ms <= 1.1 * device
                       else "the host (events exceed the kernels' sum by more than 10%)")
            print(f"[kernel] {name} ({[B, grid, grid, C]}, K-major copy given): {ms:.4f} ms per "
                  f"call by CUDA events (median of 30), {device:.4f} ms of device time by "
                  f"torch.profiler: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
                  + f"; {rate}; the row's time follows {follows}; {peak_mb:.1f} MB allocated "
                  f"at the call's peak (outputs and scratch)", flush=True)
        del x, hq, hb, h2, w, wk
        torch.cuda.empty_cache()


def convt_split_phase(torch, fc, fd, kernels: dict) -> None:
    """Rows 5 and 12 at their main-path shapes, and row 13 at a 512² input's
    in both stagings, with the K-major copy given: the time per call by CUDA
    events (median of 30) and by ``torch.profiler`` device time per kernel
    (``kernel_split`` with ``CONVT_GROUPS``: memset, pass S, pass Q), each
    pass's int8 rate (the conv's operations, once per pass) and its share of
    the card's 1,979 TOP/s. The parts go into the row as ``parts_ms``. Run
    last, as ``split_phase``."""
    for name, side, cin, stage, case in (
            ("convt4x4s2_in_relu_requant_ps", SIDE, C, "int32", "256² input"),
            ("up1_s2d16", 2 * SIDE, C // 2, "int32", "256² input"),
            ("up1_s2d16_hbm", 4 * SIDE, C // 2, "int32", "512² input, staged int32"),
            ("up1_s2d16_hbm", 4 * SIDE, C // 2, "fp16", "512² input, staged fp16")):
        rng = np.random.default_rng(side + cin)
        x = torch.from_numpy(rng.integers(-127 if cin == C else 0, 128, (B, side, side, cin),
                                          dtype=np.int8)).cuda()
        w = fc.pack_convt_weights_ps(torch.from_numpy(
            rng.integers(-127, 128, (4, 4, cin, cin // 2), dtype=np.int8)), cin, cin // 2).cuda()
        wk = fc.pack_convt_weights_ps_kmajor(w)
        call = {"convt4x4s2_in_relu_requant_ps":
                lambda: fc.convt4x4s2_in_relu_requant_ps(x, w, w_kmajor=wk),
                "up1_s2d16": lambda: fd.up1_s2d16(x, w, w_kmajor=wk),
                "up1_s2d16_hbm": lambda: fd.up1_s2d16_hbm(x, w, stage=stage, w_kmajor=wk)}[name]
        ops = 2 * B * 4 * side * side * (cin // 2) * 4 * cin
        ms = cuda_ms(torch, call, reps=30)
        parts = kernel_split(torch, call, groups=CONVT_GROUPS)
        device = sum(parts.values())
        row = next(r for r in [kernels[name], *kernels[name]["also"]] if r["case"] == case)
        row["parts_ms"] = parts
        rates = ", ".join(
            f"{k} {ops / (v * 1e-3) / 1e12:.1f} TOP/s ({ops / (v * 1e-3) / PEAK_INT8_OPS:.1%})"
            for k, v in parts.items() if k.startswith("pass")) or \
            "not measured (the trace holds no device events)"
        print(f"[kernel] {name} ({[B, side, side, cin]} -> {cin // 2}, {stage}, K-major copy "
              f"given): {ms:.4f} ms per call by CUDA events (median of 30), {device:.4f} ms of "
              f"device time by torch.profiler: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
              + f"; {rates} of 1,979", flush=True)
        del x, w, wk
        torch.cuda.empty_cache()


def v1_split_phase(torch, fc, v1, kernels: dict) -> None:
    """Rows 21 and 6 at up0's and up1's main-path shapes and row 19 at
    [8, 64, 64, 256], with the K-major copy given: the time per call by CUDA
    events (median of 30; and with the copy made by the wrapper), and by
    ``torch.profiler`` device time per kernel (``kernel_split`` with
    ``V1_GROUPS``: the fill or memset and the passes), each pass's int8 rate
    (the conv's operations, once per pass) and its share of the card's
    1,979 TOP/s. The parts go into the row as ``parts_ms``. Run last, as
    ``split_phase``."""
    cases = [(name, side, cin) for name in ("convt4x4s2_in_relu_requant_v1",
                                           "convt4x4s2_in_relu_requant")
             for side, cin in ((SIDE, C), (2 * SIDE, C // 2))]
    for name, side, cin in cases + [("conv3x3_adain_relu_requant_v1", SIDE, C)]:
        rng = np.random.default_rng(side + cin)
        t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
        if name.startswith("convt"):
            cout = cin // 2
            x = t(rng.integers(-127 if cin == C else 0, 128, (B, side, side, cin), dtype=np.int8))
            wp = fc.pack_convt_weights(torch.from_numpy(
                rng.integers(-127, 128, (4, 4, cin, cout), dtype=np.int8)), cin, cout).cuda()
            wk = fc.pack_convt_kcat_kmajor(wp)
            fn = v1.convt4x4s2_in_relu_requant if name.endswith("_v1") else \
                fc.convt4x4s2_in_relu_requant
            call, made = (lambda: fn(x, wp, w_kmajor=wk)), (lambda: fn(x, wp))
            ops = 2 * B * 4 * side * side * cout * 4 * cin
            case = f"256² input, {'up0' if side == SIDE else 'up1'}"
            shape = f"{[B, side, side, cin]} -> {cout}"
        else:
            x = t(rng.integers(-127, 128, (B, side, side, C), dtype=np.int8))
            wp = fc.pack_weights(torch.from_numpy(
                rng.integers(-32, 33, (3, 3, C, C), dtype=np.int8))).cuda()
            wk = fc.pack_weights_kmajor(wp)
            gamma = t(rng.normal(1.0, 0.5, (B, C)).astype(np.float32))
            beta = t(rng.normal(0.0, 0.5, (B, C)).astype(np.float32))
            call = lambda: v1.conv3x3_adain_relu_requant(x, wp, gamma, beta, w_kmajor=wk)  # noqa: E731
            made = lambda: v1.conv3x3_adain_relu_requant(x, wp, gamma, beta)  # noqa: E731
            ops = 2 * B * side * side * C * 9 * C
            case, shape = "256² input", f"{[B, side, side, C]}"
        ms, made_ms = cuda_ms(torch, call, reps=30), cuda_ms(torch, made, reps=30)
        parts = kernel_split(torch, call, groups=V1_GROUPS)
        device = sum(parts.values())
        row = next(r for r in [kernels[name], *kernels[name]["also"]] if r["case"] == case)
        row["parts_ms"] = parts
        rates = ", ".join(
            f"{k} {ops / (v * 1e-3) / 1e12:.1f} TOP/s ({ops / (v * 1e-3) / PEAK_INT8_OPS:.1%})"
            for k, v in parts.items() if k.startswith("pass")) or \
            "not measured (the trace holds no device events)"
        print(f"[kernel] {name} ({shape}, K-major copy given): {ms:.4f} ms per call by CUDA "
              f"events (median of 30; {made_ms:.4f} with the copy made by the wrapper), "
              f"{device:.4f} ms of device time by torch.profiler: "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + f"; {rates} of 1,979",
              flush=True)
        del x, wp, wk
        torch.cuda.empty_cache()


def enc_split_phase(torch, fe, kernels: dict) -> None:
    """Rows 7-9 and 11 at their main-path shapes and row 10 at a 512² input's
    in both stagings, the 4x4/s2 sites with the K-major copy given (row 11
    with four distinct phase blocks): the time per call by
    CUDA events (median of 30) and by ``torch.profiler`` device time per
    kernel (``kernel_split`` with ``ENC_GROUPS``: memset, pass S, pass Q), each
    pass's int8 rate (the conv's operations, once per pass) and its share of
    the card's 1,979 TOP/s. The parts go into the row as ``parts_ms``. Run
    last, as ``split_phase``."""
    for name, side, cin, stage, case in (
            ("enc0_in_relu_requant", 4 * SIDE, 3, "int32", "256² input"),
            ("enc1_in_relu_requant", 4 * SIDE, C // 4, "int32", "256² input"),
            ("enc2_in_relu_requant", 2 * SIDE, C // 2, "int32", "256² input"),
            ("enc1_in_relu_requant_im2col", 4 * SIDE, C // 4, "int32",
             "256² input, four distinct phase blocks"),
            ("enc0_hbm", 8 * SIDE, 3, "int32", "512² input, staged int32"),
            ("enc0_hbm", 8 * SIDE, 3, "fp16", "512² input, staged fp16")):
        rng = np.random.default_rng(side + cin)
        if cin == 3:
            x = torch.from_numpy(rng.integers(0, 256, (B, side, side, 3), dtype=np.uint8)).cuda()
            w = fe.pack_enc0(torch.from_numpy(
                rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8))).cuda()
            call = ((lambda: fe.enc0_in_relu_requant(x, w)) if name == "enc0_in_relu_requant"
                    else (lambda: fe.enc0_hbm(x, w, stage=stage)))
            ops, shape = 2 * B * side * side * 64 * 147, f"{[B, side, side, 3]} -> 64, {stage}"
        else:
            x = torch.from_numpy(rng.integers(0, 128, (B, side, side, cin), dtype=np.int8)).cuda()
            w = fe.pack_conv4x4(torch.from_numpy(
                rng.integers(-127, 128, (4, 4, cin, 2 * cin), dtype=np.int8))).cuda()
            if name == "enc1_in_relu_requant_im2col":  # four distinct phase blocks
                w = torch.cat([w] + [fe.pack_conv4x4(torch.from_numpy(rng.integers(
                    -127, 128, (4, 4, cin, 2 * cin), dtype=np.int8))).cuda() for _ in range(3)])
                wk = fe.pack_enc1_im2col_kmajor(w)
            else:
                wk = fe.pack_conv4x4_kmajor(w)
            call = (lambda fn=getattr(fe, name): fn(x, w, w_kmajor=wk))
            ops = 2 * B * (side // 2) ** 2 * 2 * cin * 16 * cin
            shape = f"{[B, side, side, cin]} -> {2 * cin}, K-major copy given"
        ms = cuda_ms(torch, call, reps=30)
        parts = kernel_split(torch, call, groups=ENC_GROUPS)
        device = sum(parts.values())
        row = next(r for r in [kernels[name], *kernels[name]["also"]] if r["case"] == case)
        row["parts_ms"] = parts
        rates = ", ".join(
            f"{k} {ops / (v * 1e-3) / 1e12:.1f} TOP/s ({ops / (v * 1e-3) / PEAK_INT8_OPS:.1%})"
            for k, v in parts.items() if k.startswith("pass")) or \
            "not measured (the trace holds no device events)"
        print(f"[kernel] {name} ({shape}): {ms:.4f} ms per call by CUDA events (median of 30), "
              f"{device:.4f} ms of device time by torch.profiler: "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + f"; {rates} of 1,979",
              flush=True)
        del x, w
        torch.cuda.empty_cache()


def epilogue_split_phase(torch, ec, kernels: dict) -> None:
    """Row 18 at [8, 4096, 256] (the kernel phase's inputs): its device time by
    ``torch.profiler`` (``kernel_split`` with ``CHUNKED_GROUPS``), its kernel
    launches per call on the card, and its time per call by CUDA events with
    L2 warm and flushed before each call (three medians of 30 each). The parts
    go into the row as ``parts_ms``. Run last, as ``split_phase``."""
    rng = np.random.default_rng(7)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    args = (t(rng.integers(-2 ** 20, 2 ** 20, (B, SIDE * SIDE, C), dtype=np.int32)),
            t(rng.normal(1.0, 0.5, (B, C)).astype(np.float32)),
            t(rng.normal(0.0, 0.5, (B, C)).astype(np.float32)))
    call = lambda: ec.adain_relu_requant_chunked(*args)  # noqa: E731
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    warm = [cuda_ms(torch, call, reps=30, warmup=1) for _ in range(3)]
    cold = [cuda_ms(torch, call, reps=30, warmup=1, flush=flush) for _ in range(3)]
    parts = kernel_split(torch, call, groups=CHUNKED_GROUPS)
    kernels["adain_relu_requant_chunked"]["parts_ms"] = parts
    n = device_launches(torch, call)
    check(n == 1, f"adain_relu_requant_chunked: {n} kernel launches a call on the card")
    print(f"[kernel] adain_relu_requant_chunked ({[B, SIDE * SIDE, C]}): by CUDA events "
          f"{', '.join(f'{v:.4f}' for v in warm)} ms with L2 warm, "
          f"{', '.join(f'{v:.4f}' for v in cold)} ms with L2 flushed before each call (medians of "
          f"30); {sum(parts.values()):.4f} ms of device time by torch.profiler: "
          + (", ".join(f"{k} {v:.4f}" for k, v in parts.items()) or "not measured (the trace "
             "holds no device events)") + f"; {n:g} kernel launch(es) a call; cooperative grid of "
          f"{ec.cooperative_grid()} CTAs", flush=True)
    del args, flush
    torch.cuda.empty_cache()


def slab_split_phase(torch, ep, kernels: dict) -> None:
    """Rows 16-17 at [8, 4096, 256] (|x| < 2^20, the residual in bf16 as in the
    kernel phase): each one's device time by ``torch.profiler`` (``kernel_split``
    with ``SLAB_GROUPS``), its kernel launches per call on the card (checked to
    be 1), its time per call by CUDA events with L2 warm and flushed before each
    call (three medians of 30 each), its cooperative grid and its items a
    sample. The parts go into the rows as ``parts_ms``; the time of each phase
    comes from ``tools/slab_rows_torch.py --parts variants``. Run last, as
    ``split_phase``."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for name, res_dtype, kernel in (("adain_relu_requant", None, ep.adain_relu_requant),
                                    ("adain_residual_requant", torch.bfloat16,
                                     ep.adain_residual_requant)):
        args = slab_inputs(torch, "cuda", 2 ** 20, 8, res_dtype)
        call = lambda: kernel(*args)  # noqa: E731
        warm = [cuda_ms(torch, call, reps=30, warmup=1) for _ in range(3)]
        cold = [cuda_ms(torch, call, reps=30, warmup=1, flush=flush) for _ in range(3)]
        parts = kernel_split(torch, call, groups=SLAB_GROUPS)
        n = device_launches(torch, call)
        check(n == 1, f"{name}: {n} kernel launches a call on the card")
        kernels[name]["parts_ms"] = parts
        print(f"[kernel] {name} ({[B, SIDE * SIDE, C]}"
              f"{'' if res_dtype is None else ', bf16 residual'}): by CUDA events "
              f"{', '.join(f'{v:.4f}' for v in warm)} ms with L2 warm, "
              f"{', '.join(f'{v:.4f}' for v in cold)} ms with L2 flushed before each call "
              f"(medians of 30); {sum(parts.values()):.4f} ms of device time by torch.profiler: "
              + (", ".join(f"{k} {v:.4f}" for k, v in parts.items()) or "not measured (the trace "
                 "holds no device events)") + f"; {n:g} kernel launch(es) a call; "
              f"cooperative grid of {ep.cooperative_grid(res_dtype)} CTAs, "
              f"{-(-SIDE * SIDE // ep.ROWS)} items a sample", flush=True)
        del args
    del flush
    torch.cuda.empty_cache()


def trunk_v3_split_phase(torch, fc, f3, kernels: dict) -> None:
    """Row 15 at the main path's shape with the K-major stack given: the time
    per call by CUDA events (median of 10), the device time by
    ``torch.profiler`` (``kernel_split`` with ``TRUNK_V3_GROUPS``), the
    cooperative grid, and the int8 rate of the 16 convs against the card's
    1,979 TOP/s. The parts go into the row as ``parts_ms``. Run last, as
    ``split_phase``."""
    rng = np.random.default_rng(SIDE + 1)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    w = torch.cat([fc.pack_weights(torch.from_numpy(
        rng.integers(-32, 33, (3, 3, C, C), dtype=np.int8))) for _ in range(2 * N_RES)]).cuda()
    args = (t(rng.integers(-127, 128, (B, SIDE, SIDE, C), dtype=np.int8)),
            t(rng.uniform(0.5, 2.0, (B, 1)).astype(np.float32)), w,
            t(rng.normal(1.0, 0.5, (B, 2 * N_RES, C)).astype(np.float32)),
            t(rng.normal(0.0, 0.5, (B, 2 * N_RES, C)).astype(np.float32)), N_RES)
    wk = f3.stack_kmajor(w)
    call = lambda: f3.fused_trunk_blocks(*args, w_packed=wk)  # noqa: E731
    ms = cuda_ms(torch, call, reps=10)
    parts = kernel_split(torch, call, calls=5, groups=TRUNK_V3_GROUPS)
    device = sum(parts.values())
    kernels["fused_trunk_blocks"]["parts_ms"] = parts
    ops = 2 * N_RES * 2 * B * SIDE * SIDE * C * 9 * C
    k = parts.get("cooperative kernel (wgmma)")
    rate = (f"the 16 convs at {ops / (k * 1e-3) / 1e12:.1f} TOP/s, "
            f"{ops / (k * 1e-3) / PEAK_INT8_OPS:.1%} of 1,979" if k else
            "not measured (the trace holds no device events)")
    print(f"[kernel] fused_trunk_blocks ({[B, SIDE, SIDE, C]}, {N_RES} blocks, K-major stack "
          f"given): {ms:.4f} ms per call by CUDA events (median of 10), {device:.4f} ms of device "
          f"time by torch.profiler: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
          + f"; cooperative grid of {f3.LAST_GRID[f3.SITE]} CTAs; {rate}", flush=True)
    del args, w, wk
    torch.cuda.empty_cache()


def final7_split_phase(torch, fd, kernels: dict) -> None:
    """Row 14 at a 256² and a 512² input's maps, with the packed weights
    given: the time per call by CUDA events (median of 30) and by
    ``torch.profiler`` device time, and the mma.sync rate against the card's
    1,979 TOP/s, counted both as the tensor work issued (kx folded into N =
    24 columns, 21 of them used) and as the conv's own operations. The parts
    go into the row as ``parts_ms``. Run last, as ``split_phase``."""
    for side, case in ((4 * SIDE, "256² input"), (8 * SIDE, "512² input")):
        rng = np.random.default_rng(side)
        args = (torch.from_numpy(rng.integers(0, 128, (B, side, side, 64), dtype=np.int8)).cuda(),
                torch.from_numpy(rng.integers(-127, 128, (3, 64, 7, 7), dtype=np.int8)).cuda(),
                torch.from_numpy(rng.uniform(1e-4, 2e-4, 3).astype(np.float32)).cuda(),
                torch.from_numpy(rng.uniform(-0.3, 0.3, 3).astype(np.float32)).cuda(),
                torch.from_numpy(rng.uniform(0.02, 0.05, (B, 1)).astype(np.float32)).cuda())
        pk = fd.pack_final7_weights(args[1])
        call = lambda: fd.final7_tanh_u8(*args, w_packed=pk)  # noqa: E731
        ms = cuda_ms(torch, call, reps=30)
        parts = kernel_split(torch, call, groups=FINAL7_GROUPS)
        device = sum(parts.values())
        row = next(r for r in [kernels["final7_tanh_u8"], *kernels["final7_tanh_u8"]["also"]]
                   if r["case"] == case)
        row["parts_ms"] = parts
        # issued: 2,016 m16n8k32 products (8,192 operations each) a tile of
        # 32 x 16 outputs, kx folded into N = 24 over 48 halo columns
        issued, own = B * side * side * 2016 * 8192 // 512, 2 * B * side * side * 3 * 49 * 64
        rates = (f"mma.sync {issued / (device * 1e-3) / 1e12:.1f} TOP/s issued (kx folded into "
                 f"N = 24), {issued / (device * 1e-3) / PEAK_INT8_OPS:.1%} of 1,979; the conv's "
                 f"own {own / (device * 1e-3) / 1e12:.1f} TOP/s" if device else
                 "not measured (the trace holds no device events)")
        print(f"[kernel] final7_tanh_u8 ({[B, side, side, 64]} -> 3, packed weights given): "
              f"{ms:.4f} ms per call by CUDA events (median of 30), {device:.4f} ms of device "
              f"time by torch.profiler: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
              + f"; {rates}", flush=True)
        del args, pk
        torch.cuda.empty_cache()


def serve_profile_phase(torch) -> None:
    """``torch.profiler`` over 5 steady batches of the int8 engine at 256² in
    ``MSIG_TRUNK_HIFI=0`` (demo checkpoint, batch 8, seeded images and styles,
    each batch copied to the host as the engine's batches are): the device's
    busy and idle share of the span from the first batch's start to the last
    device event, and the trunk's share of the busy time. The trunk's kernels
    are told by adjacency in stream order: the wgmma pass A and the memset
    before it, the relu epilogue after it, and the residual epilogues. Run
    last, as ``split_phase``."""
    from msig_tpu_torch.config import InferenceConfig
    from msig_tpu_torch.infer.engine import InferenceEngine
    from msig_tpu_torch.infer.loading import load_inference_params

    cfg = InferenceConfig(image_size=256, batch_size=B, device="cuda", compute_dtype="float32",
                          quantize="int8")
    gen_sd, se_sd, meta, _ = load_inference_params(DEMO, cfg, 10)
    eng = InferenceEngine.build(cfg, 10, gen_sd, se_sd, meta["n_residual_blocks"],
                                meta["style_dim"])
    eng.out_uint8 = True  # as the CLI serves: the all-kernel chain, uint8 out
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8)).cuda()
    styles = torch.from_numpy(rng.normal(size=(B, meta["style_dim"])).astype(np.float32)).cuda()
    act = torch.profiler.ProfilerActivity
    with env(MSIG_TRUNK_HIFI="0"):
        for _ in range(3):
            eng.generate(imgs, styles).cpu()
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            for _ in range(5):
                with torch.profiler.record_function("serve batch"):
                    eng.generate(imgs, styles).cpu()
    events = prof.events()
    dev = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA), key=lambda v: v[0])
    batches = [e for e in events if e.name == "serve batch"]
    if not dev or not batches:
        print("[profile 256/hifi0] not measured (the trace holds no device events)", flush=True)
        return
    t0, t1 = min(e.time_range.start for e in batches), max(max(e.time_range.end for e in batches),
                                                           dev[-1][1])
    busy, end = 0.0, t0
    for start, stop, _ in dev:  # the union of the device intervals
        start, stop = max(start, end), min(stop, t1)
        if stop > start:
            busy, end = busy + stop - start, stop
    wg = ["conv3x3_i8_wgmma_kernel" in n for _, _, n in dev]
    trunk = sum(stop - start for i, (start, stop, n) in enumerate(dev)
                if wg[i] or "residual_amax_kernel" in n or "residual_requant_kernel" in n
                or ("relu_requant_kernel" in n and i > 0 and wg[i - 1])
                or ("Memset" in n and i + 1 < len(dev) and wg[i + 1]))
    n_wg = sum(wg)
    check(n_wg == 5 * 2 * N_RES, f"[profile 256/hifi0] {n_wg} wgmma launches in 5 batches")
    span = t1 - t0
    print(f"[profile 256/hifi0] 5 steady batches of {B} (torch.profiler): span {span / 1e3:.3f} ms "
          f"({span / 5e3:.3f} per batch), device busy {busy / 1e3:.3f} ms ({busy / span:.1%}), "
          f"idle {1 - busy / span:.1%}; trunk kernels {trunk / 5e3:.3f} ms per batch, "
          f"{trunk / busy:.1%} of the busy time ({n_wg} wgmma launches)", flush=True)


def split_phase(torch, to_split) -> None:
    """Each conv case's device time per call by kernel (``kernel_split``),
    into its row as ``parts_ms``. Run last, so that the profiler cannot touch
    the timed phases (the train step is bound by host dispatch)."""
    for row, label, call in to_split:
        row["parts_ms"] = parts = kernel_split(torch, call)
        print(f"[train kernel] {label}: device ms per call by kernel (torch.profiler): " + (
            ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
            or "not measured (the trace holds no device events)"), flush=True)


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
    from msig_tpu_torch.ops import fused_conv_int8 as v1
    from msig_tpu_torch.ops import fused_conv_int8_v2 as fc
    from msig_tpu_torch.ops import fused_dec_int8 as fd
    from msig_tpu_torch.ops import fused_enc_int8 as fe
    from msig_tpu_torch.ops import fused_trunk_v3 as f3
    from msig_tpu_torch.ops import int8_epilogue as ep
    from msig_tpu_torch.ops import int8_epilogue_chunked as ec

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = t0 = time.perf_counter()
    sources = tuple(dict.fromkeys(fe.SOURCES + fc.SOURCES + fd.SOURCES + f3.SOURCES + ec.SOURCES
                                  + v1.SOURCES + ep.SOURCES + (ap.SOURCE,) + cv.SOURCES))
    logs = _build.build(sources)
    print(f"[build] {len(logs)} of {len(sources)} kernel sources compiled in "
          f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a)", flush=True)
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            if "registers" in line or "spill" in line:
                # the wgmma pass A of rows 1-4: registers, barriers, spills by kernel
                tag = f" ({entry})" if "wgmma" in entry else ""
                print(f"[build] {name}{tag}: {line.strip()}")
    card = card_line()
    print(f"[card] {card}", flush=True)

    dev = torch.device("cuda")
    int8_mods = (fc, fd, fe, f3, ec, v1, ep)
    kernels = kernel_phase(torch, fc, fd, fe, f3, ec, v1, ep, dev)
    wgmma_phase(torch, fc, v1, dev)
    trunk_v3_phase(torch, fc, f3, dev)
    convt_phase(torch, fc, fd, dev)
    v1_phase(torch, fc, v1, dev)
    enc_phase(torch, fe, dev)
    epilogue_phase(torch, ec, dev)
    slab_phase(torch, ep, dev)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=str(_build.BUILD_DIR))
    try:
        e2e = e2e_phase(torch, int8_mods, ap, work)
        tool_launches = tools_phase(torch, int8_mods)
        train_kernels, to_split = train_kernel_phase(torch, ap, cv, dev)
        adain_cluster_phase(torch, ap, dev)
        train = train_phase(torch, ap, cv, int8_mods, dev, train_kernels)
        train_cli_phase(torch, work)
        split_phase(torch, to_split)
        trunk_split_phase(torch, fc, kernels)
        trunk_v3_split_phase(torch, fc, f3, kernels)
        convt_split_phase(torch, fc, fd, kernels)
        v1_split_phase(torch, fc, v1, kernels)
        enc_split_phase(torch, fe, kernels)
        epilogue_split_phase(torch, ec, kernels)
        slab_split_phase(torch, ep, kernels)
        final7_split_phase(torch, fd, kernels)
        serve_profile_phase(torch)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[time] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s", flush=True)

    # library_ms is null: no single PyTorch call computes conv + IN (+ AdaIN)
    # + requant, or conv7 + dequant + tanh + uint8, int8 ConvT is no cuDNN op,
    # and none runs IN + AdaIN + ReLU + requant from int32 or a whole trunk.
    # launches: from the run of the path that SITES names for the row (0 for
    # the two whole-slab epilogues, which no path of the JAX package runs).
    launches = {**{name: 0 for name in SITES}, **e2e["launches"],
                **{k: v for k, v in tool_launches.items() if SITES[k][2] == TOOLS_PATH}}
    rows = [dict(name=name, route="cuda", source=f"msig_tpu_torch/csrc/{SITES[name][1]}",
                 replaces=SITES[name][0], launches=launches[name],
                 max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
                 bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None,
                 path=SITES[name][2], also=k["also"],
                 **{key: k[key] for key in ("parts_ms", "ms_copy_made") if key in k})
            for name, k in kernels.items()]
    # the training rows: launches from step 1 of the configuration that runs them;
    # the first case's bound_fp32_fma_ms, library_deterministic_ms and parts_ms beside.
    rows += [dict(k, name=name, route="cuda",
                  source=f"msig_tpu_torch/csrc/{TRAIN_KERNELS[name][1]}",
                  replaces=TRAIN_KERNELS[name][0],
                  launches=train["launches"][TRAIN_KERNELS[name][2]][name],
                  path=f"train/{TRAIN_KERNELS[name][2]}")
             for name, k in train_kernels.items()]
    check(len(rows) == len(SITES) + len(TRAIN_KERNELS), f"{len(rows)} kernel rows")
    for row in rows:
        if row["path"] is not None:
            check(row["launches"] > 0, f"{row['name']} was launched on its path {row['path']}")
    print(json.dumps({"kernels": rows}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
