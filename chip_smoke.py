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
   train step, [8, 64, 64, 256] and [4, 64, 64, 256], and of a 512² one,
   [8, 128, 128, 256] and [4, 128, 128, 256], fp32 with TF32 off, and
   the two conv kernels at [1, 24, 24, 256] (a 96² trunk: 576 pixels, no
   multiple of the 128-pixel tile). Bars: every output within rtol 1e-4 and
   atol 1e-5 x max|plain|; dgamma and dbeta within rtol 1e-5 and atol 1e-6 x
   max|plain|; dx exactly 0 under the relu mask; a second call gives
   bit-identical dW, and every output of the AdaIN kernels (row 22: one
   thread-block cluster a sample and 32 channels, partials summed in rank
   order). The conv kernels' bf16 entries (bf16 operands, fp32
   accumulation: the configuration of the JAX package's bf16 train step) at
   the same five shapes on the same inputs rounded to bf16, and at the bench
   train mode's kernel batches [64|32, 64, 64, 256] (the step's 2B and B at
   batch 32), against the plain versions on those: fewer than 0.5% of each output's elements differ (dW,
   dgamma and dbeta rounded to bf16), each by at most 2 bf16 steps or 1e-3 x
   max|plain|, dx bf16 and exactly 0 under the relu mask, every output the
   same bits over two calls; timed beside cuDNN's bf16
   ``convolution_backward`` and their bound at the dense bf16 rate, with the
   share of the bound. Row 22
   also at [8|4, 4096, 256], [8|4, 16384, 256] and
   [1, 16384, 256] in fp32 and bf16 (the TPU kernel's largest fp32 slab):
   within the bars (bf16 y and
   dx 2e-2, one bf16 rounding), bit-identical over two calls, each with its
   plan (cluster size, CTAs, shared memory) and the card's
   cudaOccupancyMaxActiveClusters. The conv cores' tiles, ring and CTAs per
   SM (occupancy API), fp32 and bf16 (the bf16 core's registers after
   setmaxnreg and as compiled, and its chunks of dW's K). Times by CUDA events; for ``conv3x3_bwd`` cuDNN's
   ``convolution_backward`` (dx and dW) beside it under its default and its
   deterministic algorithms; after phase 6, the device time of each kernel of
   a conv call (``torch.profiler``): row 24's IN backward, the conv core, the
   reductions; and of conv1 and the three conv2 sites at [8, 64, 64, 256] and
   [8, 128, 128, 256]: the wgmma pass A, the epilogue kernels, the memset,
   with pass A's int8 rate and share of 1,979 TOP/s, beside the call's time by
   CUDA events, and the memory the call allocates at its peak;
   the same for rows 19 and 20 at [8, 64, 64, 256] (row 20: pass A, max|hn|,
   requant, memset); the same for rows 5 and 12 at their main-path shapes and row 13 at a 512²
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
   deterministic algorithms as the Trainer holds it. Then ``[train 512]``
   (``train512_phase``): the same three configurations and bars at the JAX
   package's 512² configuration (batch 4, trunk maps of 128x128), and
   ``level1+pallas`` with ``remat=True`` and ``"cycle"`` (step 1's losses equal
   to the bit to the no-remat step's), each with launches, ms per step and
   peak memory. Then ``python -m msig_tpu_torch.train --device cuda
   --allow_random_vgg --epochs 2 --ema_snapshot_every 1 --wandb --watch_freq 1``
   on a synthetic tree of 8 sources and 9 target domains against a STUB wandb
   module first on the import path (the card's machine has no wandb): one
   init with the JAX CLI's arguments, each step's log with its losses and the
   watch step's histograms, one finish; ``python -m msig_tpu_torch.inference
   --quantize int8`` on the checkpoint it wrote (``MSIG_SKIP_EPOCH_ART=1``
   where matplotlib is missing); ``[quality]``: ``export_demo_checkpoint`` of
   that checkpoint, ``eval_quality`` of the export over the tree's sources and
   two target domains, ``eval_trajectory_fast`` over the run's two EMA
   snapshots;
   Then the bf16 train step (``compute_dtype=bfloat16``) at the same
   full width from the same parameters and batch, as ``stock``,
   ``level1+pallas`` and ``level2`` (the conv backwards' bf16 entries, their
   wrappers given bf16 x, w and cotangent at every call): step 1 finite and
   each kernel route within 1e-2 of stock's, each route's kernels 48
   launches a step and no other, ms per step; then ``[train options]``
   (``train_options_phase``) at the same width, ``level1+pallas``: step 1
   with ``remat=True`` and ``"cycle"`` equal to the bit to step 1 without
   (grad norms within rtol 1e-6), each mode's peak memory, ms per step and
   launches; a step each of ``r1_gamma``, ``style_recon_weight``,
   ``diversity_weight`` (also with ``remat=True``) and ``grad_hists=64``,
   finite, with its launches; a step of ``r1_gamma=1`` in the bf16 step; the train CLI for one epoch and ``--resume``
   for a second, and ``--profile_steps 2``; latent int8 serving (a seeded
   mapping network as flax bytes, 22 kernel-site launches a batch); and
   ``--save_grid`` over two domains with the decode cache and without it,
   byte-equal; then ``DeviceData``
   (``--device_data``) on the card against the CPU: the same draws, images
   within 1 uint8 step;
7. bench: the served int8 chain at the bench's batches (``BENCH_BATCHES``:
   128 and 256 at 256², 32 at 512²) on the bench's seeded weights, the first
   8 samples of each call equal to the bit to a batch-8 call's (one-hot
   styles, whose affines are exact at any batch; dense styles reported
   beside), each site launched once a call; ``bench.run_inference_worker``
   in this process at 256², batches 8 and 128, the launch counts set to 0
   before and read after (each int8 call runs 256/hifi0's 22 sites, the bf16
   configs none); then ``python -m msig_tpu_torch.bench`` in its five modes
   at short settings (``BENCH_RUNS``) and its train mode again under
   ``MSIG_CONV_VJP=1`` and ``=2`` (``BENCH_TRAIN_ROUTES``), the seven
   processes at once: exit 0 and one JSON line each with the JAX bench's
   metric name and unit;
8. parallel (after every ``torch.profiler`` session): the demo checkpoint's
   int8 engine at 256², mode 0, batch 8 with ``data_parallel`` over
   ``PAR_DEVICES`` (two shards of 4 on the one card, each with its own copy of
   the networks): 44 kernel-site launches a batch, the batch equal to the
   single-device engine's to the bit on one-hot styles, dense styles
   reported; the full-width train step at level 1 + ``--pallas``, global
   batch 4, as two gloo ranks on the one card (spawned processes; NCCL
   refuses two ranks on one GPU): rows 22-23 launched 48 times on each rank,
   the ranks' parameters equal, step 1's metrics and gradients held against
   the one-process step; a one-rank NCCL group's step: metrics equal to the
   bit, gradients within the bars beside a rerun of the no-group step;
9. eval: InceptionV3 pool3 on a seeded random torchvision-layout npz, from
   uint8 256² images, on the card within rtol 1e-3 / atol 1e-4 of the CPU;
   ms per 32-image 299² batch; ``python -m msig_tpu_torch.tools.evaluate_fid``
   over two synthetic directories: exit 0, one JSON line;
10. a ``{"kernels": [...]}`` line of the twenty-five kernels (the two
   whole-slab epilogues with 0 launches: no path of the JAX package runs
   them; rows 23-24 with their bf16 entries under ``"bf16"``, launches from
   the bf16 step), then the card line,
   then the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero without the last line. It
also exits non-zero when no CUDA device is visible, and outside a checkout of
the repository (the port is imported from beside this file).
"""

from __future__ import annotations

import dataclasses
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

# NVIDIA H100 SXM data sheet, dense: int8, bf16 and TF32 tensor cores, fp32 outside them, HBM3.
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

B, SIDE, C = 8, 64, 256            # trunk shape of the main path: 256² input, batch 8
TRAIN_B, N_DOMAINS = 4, 10         # train step: batch 4 (the default), 10 domains, full width
BENCH_KERNEL_BATCHES = (64, 32)     # the bench train mode's conv backwards (2B and B at batch 32)
TRAIN_SIZE = 256
TRAIN_CONFIGS = (("stock", "0", False), ("level1+pallas", "1", True), ("level2", "2", False))
TRAIN_STEPS = 5                    # timed steps per configuration, after step 1 and a warm-up
# [train 512]: the JAX package's 512² configuration, whose trunk (128x128 maps)
# the training kernels take; the three configurations at TRAIN_512_B, and
# level1+pallas under remat at TRAIN_512_REMAT_B
TRAIN_512, TRAIN_512_B, TRAIN_512_REMAT_B, TRAIN_512_STEPS = 512, 4, 4, 3
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
# (input side, batches held against a batch-8 call, path of their launches): bench.py's defaults
BENCH_BATCHES = ((256, (128, 256), "256/hifi0"), (512, (32,), "512"))
BENCH_WORKER = ((B, 128), 256)  # the in-process worker's batches and side
# bench mode -> (arguments of the smoke run, metric, unit)
BENCH_RUNS = {
    "inference": (["--batches", "8,128", "--iters", "5"],
                  "img_per_s_256px_ref_guided_inference", "img/s/chip"),
    "latency": (["--batches", "1,8", "--iters", "5"], "latency_ms_per_img_256px_int8_b1", "ms"),
    "train": (["--train_batch", "4", "--iters", "2"], "train_step_ms_b4_256", "ms"),
    "data": ([], "input_pipeline_img_per_s_256", "img/s/host"),
    "e2e": (["--batches", "32"], "e2e_img_per_s_256_incl_decode", "img/s"),
}
# the train mode again on each kernel route of the trunk (MSIG_CONV_VJP), beside the five
BENCH_TRAIN_ROUTES = ("1", "2")
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
                ("conv core", "conv3x3_bwd_bf16_kernel"), ("reductions", "reduce_kernel"),
                ("counter memset", "Memset"))
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
    device events, or a count that is no multiple of ``calls`` (a trace that
    lost events), in each of three tries."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if n and n % calls == 0:
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


def train_bound(name: str, b: int, side: int = SIDE, bf16: bool = False) -> tuple:
    """(bound_ms, bound_by, fp32_fma_ms) of one call of a training kernel on
    the [b, side, side, 256] trunk (64: a 256² input's, 128: a 512² input's).

    Bytes: each fp32 input read once, each output written once. Operations:
    per element of the map about 8 flops for an instance-norm pass
    (statistics, normalisation, modulation; the backward's two sums and its
    dx) at the fp32 rate, and the conv backward's two products, dx and dW,
    2 * 2 * (B*H*W) * C * 9*Co flops, as three TF32 tensor-core passes: at
    fp32 accuracy (3xTF32, the conv kernels' route; one pass misses the bars)
    the least time is 3x the products at the dense TF32 rate. fp32_fma_ms:
    the same work with the products at the fp32 FMA rate of the CUDA cores
    (TF32 off; the first version's route), None for the AdaIN rows.
    ``bf16``: the conv kernels' bf16 entries: the maps and W read, and dx
    written, in 2 bytes (dW, mu, r, gamma, dgamma, dbeta in 4), the products
    once at the dense bf16 rate; fp32_fma_ms None."""
    px, vec = b * side * side, 4 * b * C
    elems = px * C
    t_fma = None
    if bf16:
        conv, w = 2 * 2 * px * C * 9 * C, (2 + 4) * 9 * C * C  # W read in bf16, dW written in fp32
        if name == "conv3x3_bwd":
            nbytes, fp = 3 * 2 * elems + w, 0                     # x, dy -> dx
        else:
            nbytes, fp = 4 * 2 * elems + w + 5 * vec, 8 * elems   # x, y, g -> dx
        t_ops, t_bytes = conv / PEAK_BF16_FLOPS + fp / PEAK_FP32_FLOPS, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), None
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
    24's IN backward, the conv core, the in-order reductions, the bf16 core's
    counter memset, and the fp32 core's transposed taps among PyTorch's
    kernels); {} if the trace holds no device events, or holds a
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


BF16_SHARE, BF16_STEPS, BF16_ATOL_OF_MAX = 5e-3, 2, 1e-3  # the bar of the bf16 entries


def bf16_bar(torch, name: str, got, want) -> tuple:
    """Hold an output of a bf16 entry against the plain version's, both rounded
    to bf16 (dW, dgamma and dbeta are fp32): fewer than 0.5% of the elements
    differ, each by at most 2 bf16 steps or 1e-3 x max|plain| (the two sum in
    other orders in fp32, so a sum near a rounding boundary of bf16 may round
    the other way). Returns (max abs error, share of elements that differ)."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    g16, w16 = got.to(torch.bfloat16), want.to(torch.bfloat16)
    steps = bf16_ulps(torch, g16, w16)
    share = float((steps > 0).double().mean())
    diff = (g16.float() - w16.float()).abs()
    far = int(((steps > BF16_STEPS) & (diff > BF16_ATOL_OF_MAX * float(w16.float().abs().max())))
              .sum())
    check(share < BF16_SHARE and far == 0,
          f"{name}: {share:.2e} of the elements differ (bar {BF16_SHARE}), {far} beyond "
          f"{BF16_STEPS} bf16 steps and {BF16_ATOL_OF_MAX} x max|plain|")
    return float((got.float() - want.float()).abs().max()), share


def hold_bf16_kernel(torch, name: str, kernel, plain, x, relu: bool) -> tuple:
    """One call of a conv kernel's bf16 entry against its plain version on the
    same bf16 inputs: every output within ``bf16_bar``, dx in bf16 and exactly 0
    under the relu mask, every output the same bits on a second call. Returns
    (max abs error, report)."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    check(got[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in got[1:]),
          f"{name} bf16: outputs {[t.dtype for t in got]}")
    errs, shares = zip(*(bf16_bar(torch, f"{name} bf16 output {k}", g, w)
                         for k, (g, w) in enumerate(zip(got, want))))
    report = (f"max abs err {max(errs):.3e}, share of elements differing (bf16) "
              f"{', '.join(f'{v:.2e}' for v in shares)} (outputs in order)")
    if relu:
        check(bool((got[0][x <= 0] == 0).all()), f"{name} bf16: dx is 0 where x <= 0")
        report += ", dx exactly 0 under the relu mask"
    again = kernel()
    check(all(torch.equal(a, g) for a, g in zip(again, got)),
          f"{name} bf16: a second call gives the same bits")
    return max(errs), report + ", every output bit-identical over two calls"


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
    at the train step's trunk, [8|4, 4096, 256], at a 512² train step's,
    [8|4, 16384, 256], and at the TPU kernel's largest fp32 slab,
    [1, 16384, 256], in fp32 and bf16: each output within its bar of the plain version (fp32 rtol 1e-4 /
    atol 1e-5 x max, dgamma and dbeta 1e-5 / 1e-6; bf16 y and dx 2e-2, one
    bf16 rounding), bit-identical over two calls, one launch a call; the plan
    of each."""
    for b, s in ((2 * TRAIN_B, SIDE * SIDE), (TRAIN_B, SIDE * SIDE), (2 * TRAIN_B, 16384),
                 (TRAIN_B, 16384), (1, 16384)):
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
    batches, [8|4, side, side, 256], at the trunk of a 256² input (side 64) and
    of a 512² input (side 128, ``TRAIN_512``), and the two conv kernels at a
    ragged pixel count. Returns the rows and, for ``split_phase``, (row,
    label, call) of each conv case without the relu input."""
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

    cfg = cv.kernel_config(torch.float32)
    check(cfg["max_k"] == cv._MAX_K and cfg["ctas_per_sm"] >= 1 and cfg["ctas_per_sm_relu"] >= 1,
          f"conv core (3xTF32) configuration {cfg} (max_k {cv._MAX_K} in ops/conv3x3_vjp.py)")
    print(f"[train kernel] conv core (3xTF32): CTA tile {cfg['tile_m']} x {cfg['tile_n']}, "
          f"{cfg['threads']} threads, K {cfg['tile_k']} a stage through a {cfg['stages']}-stage "
          f"cp.async ring, {cfg['smem_bytes']} bytes of shared memory, at most {cfg['max_k']} "
          f"of K a tile; {cfg['ctas_per_sm']} CTAs per SM resident ({cfg['ctas_per_sm_relu']} "
          f"with the relu input; occupancy API)", flush=True)
    cfg = cv.kernel_config(torch.bfloat16)
    budget = 128 * cfg["producer_regs"] + 256 * cfg["consumer_regs"]
    check(cfg["ctas_per_sm"] >= 1 and cfg["kernel_regs"] * cfg["threads"] >= budget
          and (cfg["tile_m"], cfg["tile_n"], cfg["tile_k"]) == (cv._BF16_TILE, 256, cv._BF16_BK)
          and cfg["least_kernel_regs"] * cfg["threads"] >= budget
          and (cfg["max_chunks"], cfg["max_chunk_pixels"])
          == (cv._BF16_MAX_CHUNKS, cv._BF16_MAX_CHUNK_PX),
          f"bf16 conv core configuration {cfg} (ops/conv3x3_vjp.py: tile {cv._BF16_TILE}, "
          f"chunks {cv._BF16_MAX_CHUNKS} / {cv._BF16_MAX_CHUNK_PX})")
    print(f"[train kernel] bf16 conv core (wgmma): tile {cfg['tile_m']} x {cfg['tile_n']}, "
          f"{cfg['threads']} threads (a producer warpgroup at {cfg['producer_regs']} registers, "
          f"two consumer warpgroups at {cfg['consumer_regs']}; {cfg['kernel_regs']} as compiled, "
          f"at least {cfg['least_kernel_regs']} in its four kernels), K {cfg['tile_k']} a stage "
          f"through a {cfg['stages']}-stage ring filled by TMA (cp.async where a 128-pixel tile "
          f"is not whole rows; {cfg['stages_n128']} stages at a tile of 128 columns), "
          f"{cfg['smem_bytes']} bytes of shared memory, {cfg['ctas_per_sm']} CTA per SM "
          f"(occupancy API), a persistent grid; dW's K in a chunk per 9*Co / 2 pixels, at "
          f"most {cfg['max_chunks']} unless a chunk would pass {cfg['max_chunk_pixels']} "
          f"pixels", flush=True)

    def bf16_cases(b, side, x, w, gamma, beta, g):
        """The conv kernels' bf16 entries on the same inputs rounded to bf16, each
        against its plain version, timed, beside cuDNN's bf16 convolution_backward."""
        x, w, g = x.bfloat16(), w.bfloat16(), g.bfloat16()
        nchw = lambda v: v.permute(0, 3, 1, 2)  # noqa: E731
        library = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            nchw(g), nchw(x), w.permute(3, 2, 0, 1).contiguous(), None, [1, 1], [1, 1], [1, 1],
            False, [0, 0], 1, [True, True, False])
        lib = {} if side == 24 else {False: cudnn_ms(library, False), True: cudnn_ms(library, True)}
        for name, relu, kernel, plain in conv_cases(x, w, gamma, beta, g):
            err, report = hold_bf16_kernel(torch, name, kernel, plain, x, relu)
            tag = ", relu input" if relu else ""
            if side == 24:
                results[name]["bf16"]["max_abs_err"] = max(results[name]["bf16"]["max_abs_err"],
                                                           err)
                print(f"[train kernel] {name} bf16 ([1, 24, 24, {C}]{tag}; 576 pixels, a ragged "
                      f"edge): {report}", flush=True)
                continue
            ms = cuda_ms(torch, kernel, reps=20)
            plain_ms = cuda_ms(torch, plain, reps=3, warmup=1)
            bound_ms, bound_by, _ = train_bound(name, b, side, bf16=True)
            row = dict(case=f"[{b}, {side}, {side}, {C}]{tag}", ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib[False] if name == "conv3x3_bwd" else None,
                       library_deterministic_ms=lib[True] if name == "conv3x3_bwd" else None)
            sub = results[name].get("bf16")
            if sub is None:
                results[name]["bf16"] = dict(row, max_abs_err=err, also=[])
            else:
                sub["max_abs_err"] = max(sub["max_abs_err"], err)
                sub["also"].append(row)
            if not relu and side == SIDE:
                to_split.append((results[name]["bf16"] if sub is None else row,
                                 f"{name} bf16 ({row['case']})", kernel))
            faster = ms < min(lib.values())
            print(f"[train kernel] {name} bf16 ({row['case']}): {report}; {ms:.4f} ms (median "
                  f"of 20, CUDA events), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}; bf16 at 989 TFLOP/s; {bound_ms / ms:.1%} of it), cuDNN bf16 "
                  f"convolution_backward "
                  f"{lib[False]:.4f} ms (default algorithms) / {lib[True]:.4f} ms "
                  f"(deterministic): the kernel is {'faster than' if faster else 'NOT faster than'}"
                  f" both", flush=True)

    for side, b in ((side, b) for side in (SIDE, 2 * SIDE) for b in (2 * TRAIN_B, TRAIN_B)):
        x, w, gamma, beta, g = unit(b, side, b if side == SIDE else b + side)
        x3, g3 = x.reshape(b, side * side, C), g.reshape(b, side * side, C)
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
            bound_ms, bound_by, fma_ms = train_bound(name, b, side)
            row = dict(case=f"[{b}, {side}, {side}, {C}]{tag}", ms=ms, plain_ms=plain_ms,
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
            if name.startswith("conv") and not relu and side == SIDE:
                to_split.append((row, f"{name} ({row['case']})", kernel))
            print(f"[train kernel] {name} ({row['case']}): {report}; {ms:.4f} ms (median of "
                  f"{20 if name.startswith('conv') else 50}, CUDA events), plain {plain_ms:.3f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}){extra}", flush=True)
        bf16_cases(b, side, x, w, gamma, beta, g)
        del x, w, g, y
        torch.cuda.empty_cache()
    # the bench train mode's kernel batches (its step's 2B and B at batch 32): bf16 entries only
    for b in BENCH_KERNEL_BATCHES:
        x, w, gamma, beta, g = unit(b, SIDE, b)
        bf16_cases(b, SIDE, x, w, gamma, beta, g)
        del x, w, g
        torch.cuda.empty_cache()
    # a 96² trunk: 576 pixels, which the 128-pixel tiles cover with a ragged edge
    x, w, gamma, beta, g = unit(1, 24, 24)
    for name, relu, kernel, plain in conv_cases(x, w, gamma, beta, g):
        err, report = hold_train_kernel(torch, name, kernel, plain, x, relu)
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        print(f"[train kernel] {name} ([1, 24, 24, {C}]{', relu input' if relu else ''}; 576 "
              f"pixels, a ragged edge): {report}", flush=True)
    bf16_cases(1, 24, x, w, gamma, beta, g)
    check(set(results) == set(TRAIN_KERNELS), f"train kernel cases cover {sorted(results)}")
    check(all("bf16" in results[n] for n in cv.KERNELS), "both conv kernels' bf16 entries held")
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
    """Rows 21 and 6 at up0's and up1's main-path shapes and rows 19 and 20 at
    [8, 64, 64, 256], with the K-major copy given: the time per call by CUDA
    events (median of 30; and with the copy made by the wrapper), and by
    ``torch.profiler`` device time per kernel (``kernel_split`` with
    ``V1_GROUPS``, row 20 ``TRUNK_GROUPS``: the fill or memset, the passes, the
    epilogue kernels), each pass's int8 rate
    (the conv's operations, once per pass) and its share of the card's
    1,979 TOP/s. The parts go into the row as ``parts_ms``. Run last, as
    ``split_phase``."""
    cases = [(name, side, cin) for name in ("convt4x4s2_in_relu_requant_v1",
                                           "convt4x4s2_in_relu_requant")
             for side, cin in ((SIDE, C), (2 * SIDE, C // 2))]
    for name, side, cin in cases + [("conv3x3_adain_relu_requant_v1", SIDE, C),
                                    ("conv3x3_adain_residual_requant_v1", SIDE, C)]:
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
            if name.startswith("conv3x3_adain_relu"):
                call = lambda: v1.conv3x3_adain_relu_requant(x, wp, gamma, beta, w_kmajor=wk)  # noqa: E731
                made = lambda: v1.conv3x3_adain_relu_requant(x, wp, gamma, beta)  # noqa: E731
            else:  # row 20, on row 2's entry: the residual in int8 with its scale
                hq = t(rng.integers(-127, 128, (B, side, side, C), dtype=np.int8))
                hs = t(rng.uniform(0.01, 0.05, (B, 1)).astype(np.float32))
                call = lambda: v1.conv3x3_adain_residual_requant(  # noqa: E731
                    x, hq, hs, wp, gamma, beta, w_kmajor=wk)
                made = lambda: v1.conv3x3_adain_residual_requant(x, hq, hs, wp, gamma, beta)  # noqa: E731
            ops = 2 * B * side * side * C * 9 * C
            case, shape = "256² input", f"{[B, side, side, C]}"
        ms, made_ms = cuda_ms(torch, call, reps=30), cuda_ms(torch, made, reps=30)
        groups = TRUNK_GROUPS if name == "conv3x3_adain_residual_requant_v1" else V1_GROUPS
        parts = kernel_split(torch, call, groups=groups)
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


def compare_grads(label: str, names, got, want, tag: str = "train") -> None:
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
    print(f"[{tag} {label}] step-1 gradients vs the same step with the plain backwards, "
          f"{len(names)} leaves of the G group: rtol {GRAD_RTOL} / atol {GRAD_ATOL_REL} x "
          f"max|plain| = {atol:.3e}; worst leaf "
          f"{worst[1]} at {worst[0]:.3f} of its bar; {len(bad)} beyond; resblock conv biases "
          f"with an exactly zero gradient: {len(zero)}", flush=True)
    check(not bad, f"[{tag} {label}] step-1 gradients within their bars (beyond: {bad[:8]})")
    if label == "level2":  # the unit skips the bias, which instance norm removes
        check(len(zero) == 4 * N_RES,
              f"[{tag} level2] all {4 * N_RES} resblock conv biases have a zero gradient")


def train_inputs(torch, dev, size: int = TRAIN_SIZE, batch_size: int = TRAIN_B) -> tuple:
    """The train phases' seeded batch, random VGG and loss weights (the defaults,
    gan..style, at full warmup)."""
    from msig_tpu_torch.losses import init_random_vgg

    rng = np.random.default_rng(4)
    shape = (batch_size, size, size, 3)
    batch = {"source": torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev),
             "target": torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev),
             "source_domain": torch.zeros(batch_size, dtype=torch.int32, device=dev),
             "target_domain": torch.from_numpy(rng.integers(1, N_DOMAINS, batch_size,
                                                            dtype=np.int32)).to(dev)}
    return batch, init_random_vgg(1234, device=dev), [1.0, 10.0, 5.0, 1.0, 1.0]


def train_phase(torch, ap, cv, int8_mods, dev, kernels: dict, size: int = TRAIN_SIZE,
                batch_size: int = TRAIN_B, tag: str = "train", steps: int = TRAIN_STEPS,
                warmup: bool = True) -> dict:
    """The train step at full width in the three configurations, from the same
    parameters and batch (``size``² inputs, ``batch_size``; ``tag`` labels the lines;
    the timed steps follow step 1 and, with ``warmup``, one more untimed step). Step 1's losses and grad norms are held against the
    stock step's, and the step-1 gradients of each kernel configuration, leaf by
    leaf, against a rerun of its step 1 with the backward kernels' plain versions.
    (Not against the stock step's: at random init the generators' tanh saturates,
    and its backward, 1 - y^2, turns last-bit differences of the forward into
    relative differences of the gradients of up to 3e-3 of a leaf's norm, as
    the CPU, where no kernel runs, shows at 32². For the same reason cuDNN is
    held to its deterministic algorithms, as the Trainer holds it: with its
    default choice the decoders' ConvTranspose2d, and so two runs of the same
    step, differ in the last bit of the forward.)
    Returns {config: launches of step 1}, the step times, the peak memory (GiB,
    before the plain rerun) and step 1's metrics."""
    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.train import create_train_state, make_train_step
    from msig_tpu_torch.train.state import G_KEYS

    batch, vgg, weights = train_inputs(torch, dev, size, batch_size)
    first, launches, step_ms, peak = {}, {}, {}, {}
    torch.backends.cudnn.deterministic = True
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for label, level, pallas in TRAIN_CONFIGS:
        cfg = TrainConfig(image_size=size, batch_size=batch_size, n_residual_blocks=N_RES,
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
                  f"[{tag} {label}] launches per step {counts} (int8 {int8}), want {want}")
            launches[label] = counts
            if warmup:
                step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
            events, finite = [], []
            for _ in range(steps):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                m = step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
                end.record()
                events.append((start, end))
                finite.append(torch.stack(list(m.values())))
            torch.cuda.synchronize()
            check(bool(torch.isfinite(torch.stack(finite)).all()),
                  f"[{tag} {label}] {steps} more steps stay finite")
            step_ms[label] = float(np.median([a.elapsed_time(b) for a, b in events]))
            peak[label] = mem = torch.cuda.max_memory_allocated() / 2**30
            if label != "stock":  # step 1 again, from the same parameters, plain backwards
                names = [f"{k}.{n}" for k in G_KEYS for n, _ in state.models.nets[k].named_parameters()]
                del state
                state = create_train_state(cfg, N_DOMAINS)
                for mod in (ap, cv):
                    mod.reset_launch_counts()
                with plain_backwards(ap, cv):
                    m = step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
                bwd = {k: v for k, v in {**ap.LAUNCHES, **cv.LAUNCHES}.items() if k != ap.FWD}
                check(not any(bwd.values()), f"[{tag} {label}] no backward kernel in the plain rerun {bwd}")
                losses = [k for k in m if not k.endswith("grad_norm")]
                check(all(float(m[k]) == first[label][k] for k in losses),
                      f"[{tag} {label}] the plain rerun's step-1 losses equal the kernel run's to the "
                      f"bit: {[(k, float(m[k]), first[label][k]) for k in losses]}")
                compare_grads(label, names, grads, step1_grads(state, cfg, float(m["g_grad_norm"])),
                              tag)
            del grads
        share = ""
        side = size // 4
        for k, n in counts.items():
            also = {r["case"]: r["ms"] for r in [kernels[k]] + kernels[k]["also"]}
            cases = [f"[{bb}, {side}, {side}, {C}]" for bb in (2 * batch_size, batch_size)]
            if n and all(c in also for c in cases):
                t2, t1 = (also[c] for c in cases)
                est = 2 * N_RES * (2 * t2 + t1)  # the 2B, 2B and B generator launches
                share += f"; {k} x{n}: ~{est:.1f} ms ({100 * est / step_ms[label]:.0f}%)"
        print(f"[{tag} {label}] {size}², batch {batch_size}, {N_RES} resblocks, {N_DOMAINS} "
              f"domains: step 1 losses {json.dumps({k: round(v, 6) for k, v in first[label].items()})}; "
              f"{step_ms[label]:.2f} ms per step (median of {steps} after step 1"
              f"{' and a warm-up step' if warmup else ''}, CUDA events); launches per step {({k: v for k, v in counts.items() if v})}, "
              f"layout copies {({k: v for k, v in copies.items() if v})}{share}; peak memory "
              f"{mem:.3f} GiB (max_memory_allocated)", flush=True)
        del state, step
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    base = first["stock"]
    for label, m in first.items():
        for k, v in m.items():
            rtol = 1e-3 if k.endswith("grad_norm") else 1e-4
            check(abs(v - base[k]) <= rtol * abs(base[k]),
                  f"[{tag} {label}] step 1 {k} {v} vs stock {base[k]} (rtol {rtol})")
    print(f"[{tag}] step 1 agrees across {', '.join(first)}: losses within rtol 1e-4, grad norms "
          f"within 1e-3 (largest relative difference "
          f"{max(abs(m[k] - base[k]) / abs(base[k]) for m in first.values() for k in m):.2e})",
          flush=True)
    return dict(launches=launches, step_ms=step_ms, peak=peak, first=first)


def train512_phase(torch, ap, cv, int8_mods, dev, kernels: dict) -> dict:
    """``[train 512]``: the step at the JAX package's 512² configuration
    (``TrainConfig(image_size=512, batch_size=4)``, 8 resblocks, 10 domains,
    fp32 with TF32 off, the 256² phases' seeded inputs at 512²), whose trunk
    maps of 128x128 route to rows 22-24: ``train_phase``'s three configurations
    and bars (step 1 across them; each kernel configuration's step-1 gradients
    against its plain-backward rerun), then ``level1+pallas`` with
    ``remat=True`` and ``"cycle"``, step 1's losses equal to the bit to the
    no-remat step's (at the same batch). For each: launches a step per
    kernel, ms per step (median of ``TRAIN_512_STEPS`` after step 1, which
    warms every kernel and library up; CUDA events) and peak
    ``max_memory_allocated``."""
    from msig_tpu_torch.config import TrainConfig

    t0 = time.perf_counter()
    out = train_phase(torch, ap, cv, int8_mods, dev, kernels, size=TRAIN_512,
                      batch_size=TRAIN_512_B, tag="train 512", steps=TRAIN_512_STEPS,
                      warmup=False)
    cfg = TrainConfig(image_size=TRAIN_512, batch_size=TRAIN_512_REMAT_B, n_residual_blocks=N_RES,
                      style_dim=256, use_pallas=True, device=dev.type)
    inputs = train_inputs(torch, dev, TRAIN_512, TRAIN_512_REMAT_B)
    per_launch = 2 * N_RES
    remat = {}
    with env(MSIG_CONV_VJP="1"):
        modes = (True, "cycle") if TRAIN_512_REMAT_B == TRAIN_512_B else (False, True, "cycle")
        for mode in modes:
            remat[mode] = option_step(torch, ap, cv, int8_mods, cfg, inputs, {"remat": mode},
                                      TRAIN_512_STEPS, tag="train 512", warmup=False)
    if False not in remat:  # the no-remat step is train_phase's level1+pallas, at this batch
        remat[False] = (out["first"]["level1+pallas"], None, None, None,
                        out["peak"]["level1+pallas"], out["step_ms"]["level1+pallas"])
    base = remat[False][0]
    for mode, recomputed in ((True, 3), ("cycle", 2)):
        first, counts, _, _, peak, ms = remat[mode]
        losses = [k for k in base if not k.endswith("grad_norm")]
        check(all(first[k] == base[k] for k in losses),
              f"[train 512 remat={mode!r}] step-1 losses equal to the bit: "
              f"{[(k, first[k], base[k]) for k in losses if first[k] != base[k]]}")
        for k in ("g_grad_norm", "d_grad_norm"):
            check(abs(first[k] - base[k]) <= 1e-6 * abs(base[k]),
                  f"[train 512 remat={mode!r}] {k} {first[k]} vs {base[k]} (rtol 1e-6)")
        top = (3 + recomputed) * per_launch
        check(3 * per_launch <= counts["fwd"] <= top and counts["bwd"] == 3 * per_launch
              and counts["conv_bwd"] == 3 * per_launch,
              f"[train 512 remat={mode!r}] launches {counts}: forwards in "
              f"[{3 * per_launch}, {top}], backwards {3 * per_launch}")
        print(f"[train 512] level1+pallas remat={mode!r}, {TRAIN_512}², batch "
              f"{TRAIN_512_REMAT_B}: step 1 losses equal to the bit to remat=False's, g_grad_norm "
              f"{first['g_grad_norm']!r} ({base['g_grad_norm']!r} without); launches a step "
              f"adain_pallas_fwd {counts['fwd']}, adain_pallas_bwd {counts['bwd']}, conv3x3_bwd "
              f"{counts['conv_bwd']}; {ms:.2f} ms per step (median of {TRAIN_512_STEPS} after "
              f"step 1, CUDA events); peak memory {peak:.3f} GiB (max_memory_allocated)",
              flush=True)
    print(f"[train 512] peak memory (GiB) by remat: "
          + ", ".join(f"{m!r} {r[4]:.3f}" for m, r in remat.items())
          + "; ms per step: " + ", ".join(f"{m!r} {r[5]:.2f}" for m, r in remat.items())
          + f"; phase {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return out


# [train cli]: a stand-in for the wandb package, which the card's machine lacks
WANDB_STUB = '''"""A STUB of the wandb package (chip_smoke.py's [train cli]): it records
init's arguments, each log() call's keys (a histogram as its count total) and
finish() calls, and sends nothing anywhere."""
RECORD = {"init": [], "logs": [], "finish": 0}


class Histogram:
    def __init__(self, np_histogram=None, **kwargs):
        self.counts, self.edges = np_histogram


class Run:
    def log(self, data):
        RECORD["logs"].append({k: int(v.counts.sum()) if isinstance(v, Histogram) else v
                               for k, v in data.items()})

    def finish(self):
        RECORD["finish"] += 1


def init(**kwargs):
    RECORD["init"].append(kwargs)
    return Run()
'''
CLI_EPOCHS = 2  # [train cli]: epochs, each with its EMA snapshot (for [quality])


def train_cli_phase(torch, work: str, device: str = "cuda", extra=()) -> str:
    """``python -m msig_tpu_torch.train`` on a synthetic tree with ``--wandb
    --watch_freq 1`` against a STUB wandb module (``WANDB_STUB``, first on
    the import path; the card's machine has no wandb), ``CLI_EPOCHS`` epochs
    with an EMA snapshot each; the stub's record: one ``init`` with the JAX
    CLI's arguments, each step's losses with the watch step's histograms from
    the card, each epoch's averages, one ``finish``. Then serving the
    checkpoint. Returns the run's directory."""
    import importlib.util

    from PIL import Image

    from msig_tpu_torch import inference as infer_cli
    from msig_tpu_torch.config import TrainConfig
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
    stub_dir = os.path.join(work, "wandb_stub")
    os.makedirs(stub_dir)
    with open(os.path.join(stub_dir, "wandb.py"), "w") as f:
        f.write(WANDB_STUB)
    out = os.path.join(work, "train_results")
    args = cli.build_arg_parser().parse_args([
        "--source_dir", src, "--target_dir", ref, "--save_dir_base", out, "--exp_name", "smoke",
        "--device", device, "--allow_random_vgg", "--epochs", str(CLI_EPOCHS),
        "--ema_snapshot_every", "1", "--wandb", "--watch_freq", "1", *extra])
    cfg = cli.config_from_args(args)
    sys.path.insert(0, stub_dir)
    saved = sys.modules.pop("wandb", None)
    try:
        with env(MSIG_SKIP_EPOCH_ART="0" if art else "1"):
            t0 = time.perf_counter()
            rc = cli.main(cfg)
            train_s = time.perf_counter() - t0
        stub = sys.modules["wandb"]
        check(os.path.dirname(stub.__file__) == stub_dir, f"the stub wandb ran: {stub.__file__}")
        record = stub.RECORD
    finally:
        sys.path.remove(stub_dir)
        sys.modules.pop("wandb", None)
        if saved is not None:
            sys.modules["wandb"] = saved
    run_dir = os.path.join(out, "smoke")
    ckpt = os.path.join(run_dir, "checkpoints", f"epoch_{CLI_EPOCHS}")
    check(rc == 0, f"python -m msig_tpu_torch.train exit code {rc} == 0")
    check(all(os.path.exists(os.path.join(ckpt, f)) for f in ("checkpoint.pth",
                                                              "ema_checkpoint.pth")),
          "the train CLI wrote checkpoint.pth and ema_checkpoint.pth")
    # the stub's record: main.py:203-209's init, the trainer's logs, one finish
    init = record["init"]
    check(len(init) == 1 and init[0]["project"] == cli.WANDB_PROJECT
          and init[0]["name"] == "smoke"
          and set(init[0]["config"]) == {f.name for f in dataclasses.fields(TrainConfig)},
          f"[train cli] one wandb.init with main.py's arguments: {init}")
    steps = 8 // TRAIN_B
    step_logs = [lg for lg in record["logs"] if "epoch" not in lg]
    epoch_logs = [lg for lg in record["logs"] if "epoch" in lg]
    hists = [{k: v for k, v in lg.items() if k.startswith("gradients/")} for lg in step_logs]
    check(len(step_logs) == CLI_EPOCHS * steps and len(epoch_logs) == CLI_EPOCHS
          and record["finish"] == 1,
          f"[train cli] {len(step_logs)} step logs, {len(epoch_logs)} epoch logs, "
          f"{record['finish']} finish")
    check(all(h and all(v > 0 for v in h.values()) for h in hists)
          and all({"loss/D_loss", "loss/G_loss"} <= set(lg) for lg in step_logs),
          "[train cli] every step's log() holds its losses and the watch step's histograms")
    served = os.path.join(work, "train_served")
    args = infer_cli.build_arg_parser().parse_args([
        "--input_dir", src, "--ref_domains_dir", ref, "--checkpoint_dir", ckpt, "--output_dir",
        served, "--target_domain", "dom2", "--style_mode", "average", "--quantize", "int8",
        "--batch_size", "8", "--compute_dtype", "float32", "--device", device, *extra])
    rc = infer_cli.main(infer_cli.config_from_args(args))
    check(rc == 0 and len(os.listdir(served)) == 8,
          f"the inference CLI on the trained checkpoint: exit {rc}, {len(os.listdir(served))} images")
    print(f"[train cli] python -m msig_tpu_torch.train --device cuda --allow_random_vgg --epochs "
          f"{CLI_EPOCHS} --ema_snapshot_every 1 --wandb --watch_freq 1, wandb a STUB module "
          f"(records its calls, sends nothing): rc 0 in {train_s:.1f} s (8 sources, "
          f"{N_DOMAINS - 1} target domains, 256², batch {TRAIN_B}: {CLI_EPOCHS * steps} steps + "
          f"checkpoint and snapshots); the stub saw one init (project {init[0]['project']!r}, name "
          f"'smoke', {len(init[0]['config'])} config fields), {len(step_logs)} step logs each "
          f"with {len(hists[0])} gradient histograms from the card ({sum(hists[0].values())} "
          f"gradient elements), {len(epoch_logs)} epoch logs, {record['finish']} finish; python -m "
          f"msig_tpu_torch.inference --quantize int8 on its checkpoint: rc 0, 8 images",
          flush=True)
    return run_dir


def quality_phase(torch, work: str, run_dir: str, device: str = "cuda") -> None:
    """``[quality]``: the quality tools on the card, in this process, on what
    ``[train cli]`` trained: ``export_demo_checkpoint`` of its final checkpoint
    (then served by ``eval_quality``), ``eval_quality`` over the synthetic
    tree's sources and its first two target domains, and
    ``eval_trajectory_fast`` over its two EMA snapshots (every domain)."""
    import contextlib
    import io

    from msig_tpu_torch.tools import eval_quality, eval_trajectory_fast, export_demo_checkpoint

    t0 = time.perf_counter()
    src, ref = os.path.join(work, "train_src"), os.path.join(work, "train_ref")
    demo = os.path.join(work, "demo_export")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        meta = export_demo_checkpoint.main([
            "--checkpoint", os.path.join(run_dir, "checkpoints", f"epoch_{CLI_EPOCHS}"),
            "--out", demo, "--num_domains", str(N_DOMAINS), "--device", device])
    with np.load(os.path.join(demo, "ema_g_se_fp16.npz")) as z:
        n_arrays = len(z.files)
        fp16 = all(z[k].dtype == np.float16 for k in z.files)
    check(meta["ema"] and meta["num_domains"] == N_DOMAINS and fp16,
          f"[quality] export_demo_checkpoint: meta {meta}, fp16 arrays {fp16}")
    qdir = os.path.join(work, "quality")
    with contextlib.redirect_stdout(text):
        report = eval_quality.main([
            "--checkpoint", demo, "--source_dir", src, "--ref_dir", ref, "--out", qdir,
            "--n_images", "8", "--domains", "2", "--batch_size", "4", "--samples", "2",
            "--device", device])
    with open(os.path.join(qdir, "quality.json")) as f:
        saved = json.load(f)
    keys = {"proxy_fid_generated_vs_ref", "proxy_fid_source_vs_ref",
            "color_frechet_generated_vs_ref", "color_frechet_source_vs_ref",
            "hist_tv_generated_vs_ref", "hist_tv_source_vs_ref"}
    check(saved == report and sorted(report) == ["dom0", "dom1"]
          and all(set(r) == keys and all(np.isfinite(list(r.values()))) for r in report.values())
          and all(len(os.listdir(os.path.join(qdir, "generated", d))) == 8 for d in report)
          and all(os.path.exists(os.path.join(qdir, f"samples_{d}.jpg")) for d in report),
          f"[quality] eval_quality: {report}")
    tdir = os.path.join(work, "trajectory")
    with contextlib.redirect_stdout(text):
        rows = eval_trajectory_fast.main([
            "--snap_root", os.path.join(run_dir, "ema_snapshots"), "--out", tdir,
            "--source_dir", src, "--ref_dir", ref, "--n_images", "8", "--batch_size", "4",
            "--samples", "1", "--device", device])
    with open(os.path.join(tdir, "trajectory.csv")) as f:
        csv = f.read().splitlines()
    check(sorted(rows) == list(range(1, CLI_EPOCHS + 1))
          and len(csv) == 1 + CLI_EPOCHS * (N_DOMAINS - 1),
          f"[quality] eval_trajectory_fast: epochs {sorted(rows)}, {len(csv)} CSV lines")
    said = [ln for ln in text.getvalue().splitlines() if "trajectory.png" in ln or "wrote" in ln]
    print(f"[quality] export_demo_checkpoint of the train CLI's epoch_{CLI_EPOCHS}: {n_arrays} fp16 "
          f"arrays, meta {json.dumps(meta)}; eval_quality on the export (8 sources, dom0 and dom1, "
          f"proxy-FID on the port's seeded random VGG): {json.dumps(report)}; "
          f"eval_trajectory_fast over {len(rows)} EMA snapshots x {N_DOMAINS - 1} domains: "
          f"{len(csv) - 1} CSV rows, mean proxy-FID gen by epoch "
          + ", ".join(f"{e} {np.mean([r['proxy_fid_generated_vs_ref'] for r in rows[e].values()]):.6f}"
                      for e in sorted(rows))
          + f"; {'; '.join(said)}; phase {time.perf_counter() - t0:.1f} s", flush=True)


class wrapper_types:
    """Records the types of the tensors each conv backward wrapper receives, for
    the length of a ``with`` block (the autograd functions call the module's
    wrappers)."""

    def __init__(self, cv):
        self.cv, self.seen = cv, {name: [] for name in cv.KERNELS}

    def __enter__(self):
        self.saved = {name: getattr(self.cv, name) for name in self.cv.KERNELS}
        for name, fn in self.saved.items():
            def spy(*args, _fn=fn, _seen=self.seen[name], **kwargs):
                _seen.append(tuple(str(a.dtype)[6:] for a in args if hasattr(a, "dtype")))
                return _fn(*args, **kwargs)
            setattr(self.cv, name, spy)
        return self.seen

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cv, name, fn)


# what each wrapper receives in the bf16 step: x, w, dy | x, w, y, mu, r, gamma, g
BF16_WRAPPER_TYPES = {"conv3x3_bwd": ("bfloat16",) * 3,
                      "conv3x3_adain_bwd": ("bfloat16",) * 3 + ("float32",) * 3 + ("bfloat16",)}


def train_bf16_phase(torch, ap, cv, int8_mods, dev) -> dict:
    """The bf16 train step (``compute_dtype=bfloat16``) at full width in the three
    configurations of ``TRAIN_CONFIGS``, from the same parameters and batch as
    the fp32 train phase: ``stock``, ``level1+pallas`` (``conv3x3_bwd``'s and
    ``adain_pallas``'s bf16 entries) and ``level2`` (``conv3x3_adain_bwd``'s):
    step 1's metrics finite, each kernel configuration's within 1e-2 of stock's
    (the routes round bf16 at other places); each kernel of the route launched
    48 times a step and no other, the conv backward wrappers given bf16 x, w
    and cotangent (mu, r and gamma fp32) at every call; ms per step (median of
    3 after a warm-up step, CUDA events). Returns {config: launches of step 1}."""
    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.train import create_train_state, make_train_step

    batch, vgg, weights = train_inputs(torch, dev)
    first, step_ms, launches = {}, {}, {}
    for label, level, pallas in TRAIN_CONFIGS:
        cfg = TrainConfig(image_size=TRAIN_SIZE, batch_size=TRAIN_B, n_residual_blocks=N_RES,
                          style_dim=256, use_pallas=pallas, compute_dtype="bfloat16",
                          device=dev.type)
        torch.cuda.reset_peak_memory_stats()
        with env(MSIG_CONV_VJP=level):
            state = create_train_state(cfg, N_DOMAINS)
            step = make_train_step(cfg.ema_beta, torch.bfloat16)
            reset_counts((ap, cv) + int8_mods)
            with wrapper_types(cv) as seen:
                metrics = step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
                torch.cuda.synchronize()
            counts = {**ap.LAUNCHES, **cv.LAUNCHES}
            int8 = sum(v for m in int8_mods for v in m.LAUNCHES.values())
            first[label] = {k: float(v) for k, v in metrics.items()}
            check(all(np.isfinite(v) for v in first[label].values()),
                  f"[train bf16 {label}] step 1 metrics finite: {first[label]}")
            want = {k: (2 * N_RES * 3 if TRAIN_KERNELS[k][2] == label else 0) for k in counts}
            check(counts == want and int8 == 0,
                  f"[train bf16 {label}] launches per step {counts} (int8 {int8}), want {want}")
            for name, calls in seen.items():
                check(len(calls) == counts[name]
                      and all(t == BF16_WRAPPER_TYPES[name] for t in calls),
                      f"[train bf16 {label}] {name} received {sorted(set(calls))} in "
                      f"{len(calls)} calls, want {BF16_WRAPPER_TYPES[name]} x {counts[name]}")
            launches[label] = counts
            step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)  # warm-up
            events = []
            for _ in range(3):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                m = step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            check(bool(torch.isfinite(torch.stack(list(m.values()))).all()),
                  f"[train bf16 {label}] 3 more steps stay finite")
            step_ms[label] = float(np.median([a.elapsed_time(b) for a, b in events]))
        received = "; ".join(f"{k} received {BF16_WRAPPER_TYPES[k]} at each of its {len(v)} calls"
                             for k, v in seen.items() if v)
        print(f"[train bf16 {label}] {TRAIN_SIZE}², batch {TRAIN_B}, {N_RES} resblocks, "
              f"compute_dtype bfloat16: step 1 "
              f"{json.dumps({k: round(v, 6) for k, v in first[label].items()})}; "
              f"{step_ms[label]:.2f} ms per step (median of 3 after a warm-up step, CUDA events); "
              f"launches per step {({k: v for k, v in counts.items() if v})}"
              f"{'; ' + received if received else ''}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
        del state, step
        torch.cuda.empty_cache()
    base = first["stock"]
    worst = {label: max(abs(m[k] - base[k]) / abs(base[k]) for k in base)
             for label, m in first.items() if label != "stock"}
    for label, v in worst.items():
        check(v <= 1e-2, f"[train bf16] {label}'s step 1 within 1e-2 of stock's ({v:.2e})")
    print(f"[train bf16] step 1 within 1e-2 of stock's: "
          f"{', '.join(f'{k} {v:.2e}' for k, v in worst.items())} (largest relative difference; "
          f"the routes round bf16 at other places); ms per step "
          f"{', '.join(f'{k} {v:.2f}' for k, v in step_ms.items())}", flush=True)
    return launches


TRAIN_OPTION_STEPS = 3  # timed steps per remat mode, after step 1 and a warm-up


def option_step(torch, ap, cv, int8_mods, cfg, inputs, options: dict, steps: int = 0,
                dtype=None, tag: str = "train options", warmup: bool = True) -> tuple:
    """Step 1 of ``make_train_step(**options)`` from a new train state of ``cfg``
    (the train phase's parameters) on ``inputs`` (batch, VGG, weights), and
    ``steps`` timed steps after it (and, with ``warmup``, one more untimed
    step): step 1's metrics, its launches of the
    AdaIN and conv backward kernels (no other kernel may launch), the
    histograms, the parameters' sizes, the peak memory (GiB) and ms per step
    (median, CUDA events)."""
    from msig_tpu_torch.train import create_train_state, make_train_step

    batch, vgg, weights = inputs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, N_DOMAINS)
    step = make_train_step(cfg.ema_beta, dtype or torch.float32, **options)
    reset_counts((ap, cv) + int8_mods)
    metrics = step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
    torch.cuda.synchronize()
    counts = {"fwd": ap.LAUNCHES[ap.FWD], "bwd": ap.LAUNCHES[ap.BWD],
              "conv_bwd": cv.LAUNCHES["conv3x3_bwd"]}
    others = {k: v for k, v in read_counts((cv,) + int8_mods).items()
              if v and k != "conv3x3_bwd"}
    check(not others, f"[{tag} {options}] no other kernel launched: {others}")
    hists = metrics.pop("_grad_hists", None)
    first = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in first.values()), f"[{tag} {options}] step 1 finite: {first}")
    ms = None
    if steps:
        if warmup:
            step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
        events = []
        for _ in range(steps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            m = step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(v)) for k, v in m.items() if k != "_grad_hists"),
              f"[{tag} {options}] the timed steps stay finite")
        ms = float(np.median([a.elapsed_time(b) for a, b in events]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    sizes = {f"gradients/{k}.{n}": p.numel() for k, net in state.models.nets.items()
             for n, p in net.named_parameters()}
    del state, step
    return first, counts, hists, sizes, peak, ms


def train_options_phase(torch, ap, cv, int8_mods, dev, work: str) -> None:
    """``[train options]``: the options of both entry points that the port took
    last, at the train phase's full width (256², batch 4, 8 resblocks,
    style_dim 256, 10 domains), ``level1+pallas``, from its parameters and batch:

    - remat: step 1 with ``remat=True`` and ``"cycle"`` against step 1 without:
      losses equal to the bit, pre-clip grad norms within rtol 1e-6; each
      mode's peak ``torch.cuda.max_memory_allocated``, ms per step (median of
      ``TRAIN_OPTION_STEPS`` after a warm-up, CUDA events) and launches;
    - one step each of ``r1_gamma=1``, ``style_recon_weight=1``,
      ``diversity_weight=1`` (alone and with ``remat=True``) and
      ``grad_hists=64``: finite metrics, and each kernel's launches against
      ``48 * launches / 3`` (diversity adds a generator launch; remat
      re-runs the AdaIN forwards of the launches it recomputes, at most once
      each: non-reentrant checkpointing may stop a recomputation once the
      tensors it needs are back); the histograms' counts sum to each
      gradient's element count, every gradient finite; ``r1_gamma=1`` in the
      bf16 step (``compute_dtype=bfloat16``) beside the bf16 step without it:
      finite, the D loss moved, the same launches;
    - ``python -m msig_tpu_torch.train --device cuda`` for 1 epoch, then
      ``--resume`` for the second (the step count and loss history carried),
      and ``--profile_steps 2`` at ``MSIG_CONV_VJP=1 --pallas`` in a process
      of its own (a trace with the port's kernels);
    - ``python -m msig_tpu_torch.inference --quantize int8 --style_mode latent``
      on the demo checkpoint with a seeded mapping network written as flax
      bytes (``compat/flax_bytes``): one image an input, the served chain's 22
      kernel-site launches a batch;
    - ``--save_grid`` over two target domains (a grid in each), served with
      the decode cache and with ``MSIG_DECODE_CACHE_MB=0``: byte-equal files."""
    import contextlib
    import io

    from msig_tpu_torch import inference as infer_cli
    from msig_tpu_torch.compat import flax_bytes
    from msig_tpu_torch.compat import from_jax as fj
    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.extensions import MappingNetwork
    from msig_tpu_torch.train import cli
    from msig_tpu_torch.train.state import torch_default_init_

    t_phase = time.perf_counter()
    batch, vgg, weights = train_inputs(torch, dev)
    batch = dict(batch, target2=torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, tuple(batch["target"].shape), dtype=np.uint8)).to(dev))
    cfg = TrainConfig(image_size=TRAIN_SIZE, batch_size=TRAIN_B, n_residual_blocks=N_RES,
                      style_dim=256, use_pallas=True, device=dev.type)
    torch.backends.cudnn.deterministic = True
    per_launch = 2 * N_RES  # AdaIN sites (and 3x3 conv backwards) a generator launch

    def run(options, steps=0):
        return option_step(torch, ap, cv, int8_mods, cfg, (batch, vgg, weights), options, steps)

    with env(MSIG_CONV_VJP="1"):
        remat = {}
        for mode in (False, True, "cycle"):
            remat[mode] = run({"remat": mode}, steps=TRAIN_OPTION_STEPS)
        base, base_counts = remat[False][0], remat[False][1]
        check(base_counts == {"fwd": 3 * per_launch, "bwd": 3 * per_launch,
                              "conv_bwd": 3 * per_launch},
              f"[train options] launches without remat {base_counts}")
        for mode, recomputed in ((True, 3), ("cycle", 2)):
            first, counts = remat[mode][0], remat[mode][1]
            losses = [k for k in base if not k.endswith("grad_norm")]
            check(all(first[k] == base[k] for k in losses),
                  f"[train options remat={mode!r}] step-1 losses equal to the bit: "
                  f"{[(k, first[k], base[k]) for k in losses if first[k] != base[k]]}")
            for k in ("g_grad_norm", "d_grad_norm"):
                check(abs(first[k] - base[k]) <= 1e-6 * abs(base[k]),
                      f"[train options remat={mode!r}] {k} {first[k]} vs {base[k]} (rtol 1e-6)")
            top = (3 + recomputed) * per_launch
            check(3 * per_launch <= counts["fwd"] <= top and counts["bwd"] == 3 * per_launch
                  and counts["conv_bwd"] == 3 * per_launch,
                  f"[train options remat={mode!r}] launches {counts}: forwards in "
                  f"[{3 * per_launch}, {top}], backwards {3 * per_launch}")
        for mode, (first, counts, _, _, peak, ms) in remat.items():
            gap = ""
            if mode:
                top = (3 + (3 if mode is True else 2)) * per_launch
                gap = (f" (upper bound {top}: {top - counts['fwd']} recomputed forwards not run)"
                       if counts["fwd"] != top else f" (= the upper bound {top})")
            print(f"[train options] remat={mode!r}: step 1 losses "
                  f"{'equal to the bit' if mode else 'the reference'}, g_grad_norm "
                  f"{first['g_grad_norm']!r}, d_grad_norm {first['d_grad_norm']!r}; launches "
                  f"adain_pallas_fwd {counts['fwd']}{gap}, adain_pallas_bwd {counts['bwd']}, "
                  f"conv3x3_bwd {counts['conv_bwd']}; peak memory {peak:.3f} GiB "
                  f"(max_memory_allocated); {ms:.2f} ms per step (median of "
                  f"{TRAIN_OPTION_STEPS} after a warm-up, CUDA events)", flush=True)

        cases = (("r1_gamma=1", {"r1_gamma": 1.0}, 3, 0),
                 ("style_recon_weight=1", {"style_recon_weight": 1.0}, 3, 0),
                 ("diversity_weight=1", {"diversity_weight": 1.0}, 4, 0),
                 ("diversity_weight=1 remat=True", {"diversity_weight": 1.0, "remat": True}, 4, 4),
                 ("grad_hists=64", {"grad_hists": 64}, 3, 0))
        for label, options, launches, recomputed in cases:
            first, counts, hists, sizes, peak, _ = run(options)
            want = launches * per_launch
            ok = (want <= counts["fwd"] <= (launches + recomputed) * per_launch
                  and counts["bwd"] == counts["conv_bwd"] == want)
            check(ok, f"[train options {label}] launches {counts}, want forwards "
                      f"{want}..{(launches + recomputed) * per_launch}, backwards {want}")
            extra = ""
            if "r1_gamma" in options:
                check(first["D_loss"] != base["D_loss"], "[train options r1] the D loss moved")
                extra = f"; D_loss {first['D_loss']!r} (without R1 {base['D_loss']!r})"
            for key in ("style_recon", "diversity"):
                if key in first:
                    extra += f"; {key} {first[key]!r}"
            if hists is not None:
                check(set(hists) == set(sizes), f"[train options] {len(hists)} histograms for "
                                                f"{len(sizes)} parameters")
                sums = {k: int(h[0].sum()) for k, h in hists.items()}
                check(all(sums[k] == sizes[k] for k in sizes),
                      "[train options grad_hists] every histogram's counts sum to its gradient's "
                      "element count (every gradient finite)")
                extra += (f"; {len(hists)} histograms of 64 bins, counts summing to "
                          f"{sum(sums.values())} gradient elements")
            print(f"[train options] {label}: step 1 finite, G_loss {first['G_loss']!r}; launches "
                  f"adain_pallas_fwd {counts['fwd']}, adain_pallas_bwd {counts['bwd']}, "
                  f"conv3x3_bwd {counts['conv_bwd']}; peak memory {peak:.3f} GiB{extra}",
                  flush=True)

        # R1 in the bf16 step (compute_dtype=bfloat16, the penalty's gradient on an fp32 leaf)
        cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
        got = {}
        for label, options in (("bf16", {}), ("bf16 r1_gamma=1", {"r1_gamma": 1.0})):
            got[label] = option_step(torch, ap, cv, int8_mods, cfg16, (batch, vgg, weights),
                                     options, dtype=torch.bfloat16)
            counts = got[label][1]
            check(counts == base_counts, f"[train options {label}] launches {counts}, want "
                                         f"{base_counts}")
        (b16, _, _, _, _, _), (r1, counts, _, _, peak, _) = got["bf16"], got["bf16 r1_gamma=1"]
        check(r1["D_loss"] != b16["D_loss"], "[train options bf16 r1] the D loss moved")
        print(f"[train options] r1_gamma=1 in the bf16 step (compute_dtype bfloat16): step 1 "
              f"finite, D_loss {r1['D_loss']!r} (without R1 {b16['D_loss']!r}), d_grad_norm "
              f"{r1['d_grad_norm']!r} ({b16['d_grad_norm']!r}); launches adain_pallas_fwd "
              f"{counts['fwd']}, adain_pallas_bwd {counts['bwd']}, conv3x3_bwd "
              f"{counts['conv_bwd']}; peak memory {peak:.3f} GiB", flush=True)
    torch.cuda.empty_cache()

    # the train CLI: one epoch, --resume for the second, --profile_steps
    src, ref = os.path.join(work, "train_src"), os.path.join(work, "train_ref")
    out = os.path.join(work, "opt_results")

    def train(*extra, name="resume", **settings):
        args = cli.build_arg_parser().parse_args([
            "--source_dir", src, "--target_dir", ref, "--save_dir_base", out, "--exp_name", name,
            "--device", "cuda", "--allow_random_vgg", *extra])
        text = io.StringIO()
        with env(MSIG_SKIP_EPOCH_ART="1", **settings), contextlib.redirect_stdout(text):
            rc = cli.main(cli.config_from_args(args))
        check(rc == 0, f"[train options] train CLI {' '.join(extra)}: exit {rc}\n{text.getvalue()}")
        return text.getvalue()

    t0 = time.perf_counter()
    train("--epochs", "1")
    ckpt = os.path.join(out, "resume", "checkpoints")
    said = train("--epochs", "2", "--resume", os.path.join(ckpt, "epoch_1"))
    check("Resuming training from epoch 2" in said, f"[train options] resume said: {said!r}")
    saved = torch.load(os.path.join(ckpt, "epoch_2", "checkpoint.pth"), map_location="cpu",
                       weights_only=False)
    steps = float(saved["g_optimizer"]["state"][0]["step"])
    check(len(saved["loss_history"]["G_loss"]) == 2 and steps == 4.0,
          f"[train options] the resumed run's history {saved['loss_history']['G_loss']}, "
          f"Adam steps {steps}")
    resume_s = time.perf_counter() - t0
    # a process of its own: after a torch.profiler session with CUDA activity in
    # this process, the later phases' traces lost their device events on the card
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "msig_tpu_torch.train", "--source_dir", src, "--target_dir", ref,
         "--save_dir_base", out, "--exp_name", "profile", "--device", "cuda",
         "--allow_random_vgg", "--epochs", "1", "--profile_steps", "2", "--batch_size", "2",
         "--pallas"], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, MSIG_CONV_VJP="1", MSIG_SKIP_EPOCH_ART="1"))
    trace = os.path.join(out, "profile", "profile", "trace.json")
    check(run.returncode == 0 and f"Profiler trace written to {os.path.dirname(trace)}"
          in run.stdout and os.path.exists(trace),
          f"[train options] --profile_steps: exit {run.returncode}\n{run.stdout[-2000:]}"
          f"\n{run.stderr[-2000:]}")
    with open(trace) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    port = sorted(n for n in names if "msig_" in n)
    check(bool(port), "[train options] the profile trace holds the port's kernels")
    print(f"[train options] train CLI: 1 epoch then --resume for epoch 2 (8 sources, batch "
          f"{TRAIN_B}: 4 Adam steps, 2 epochs of history) in {resume_s:.1f} s; --profile_steps 2 "
          f"(MSIG_CONV_VJP=1 --pallas, batch 2, its own process) wrote {os.path.getsize(trace)} "
          f"bytes in {time.perf_counter() - t0:.1f} s, {len(port)} kernels of the port among its "
          "events", flush=True)

    # latent int8 serving on the demo checkpoint
    inp, ref_dir = os.path.join(work, "in"), os.path.join(work, "ref")
    net = MappingNetwork(latent_dim=16, style_dim=256, num_domains=N_DOMAINS)
    torch_default_init_(net, torch.Generator().manual_seed(11))
    mapping = os.path.join(work, "mapping.msgpack")
    with open(mapping, "wb") as f:
        f.write(flax_bytes.to_bytes(fj.mapping_params(net.state_dict())))
    n_batches = -(-N_INPUTS // B)

    def serve(out_dir, *extra, **settings):
        args = infer_cli.build_arg_parser().parse_args([
            "--input_dir", inp, "--ref_domains_dir", ref_dir, "--checkpoint_dir", DEMO,
            "--output_dir", out_dir, "--quantize", "int8", "--image_size", "256",
            "--batch_size", str(B), "--compute_dtype", "float32", "--device", "cuda", *extra])
        with env(**settings):
            reset_counts(int8_mods)
            t0 = time.perf_counter()
            rc = infer_cli.main(infer_cli.config_from_args(args))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        check(rc == 0, f"[train options] inference {' '.join(extra)}: exit {rc}")
        return read_counts(int8_mods), secs

    latent_out = os.path.join(work, "out_latent")
    launches, secs = serve(latent_out, "--target_domain", TARGET, "--style_mode", "latent",
                           "--mapping_params", mapping, "--latent_dim", "16")
    names = sorted(os.listdir(latent_out))
    check(len(names) == N_INPUTS, f"[train options latent] {len(names)} images for {N_INPUTS}")
    for name, n in launches.items():
        want = PATHS["256/hifi0"].get(name, 0) * n_batches
        check(n == want, f"[train options latent] {name} launched {n} times, want {want}")
    per_batch = sum(launches.values()) // n_batches
    check(per_batch == 22, f"[train options latent] {per_batch} kernel-site launches a batch")
    print(f"[train options] latent int8 serving (--style_mode latent, a seeded mapping network "
          f"written as flax bytes, latent_dim 16): rc 0, {len(names)} images of 256² in "
          f"{secs:.2f} s, {per_batch} kernel-site launches a batch over {n_batches} batches",
          flush=True)

    # --save_grid over two domains, with the decode cache and without
    files = {}
    for label, mb in (("cache", "2048"), ("no cache", "0")):
        out_dir = os.path.join(work, "out_grid_" + label.replace(" ", "_"))
        _, secs = serve(out_dir, "--target_domain", "dom1,dom6", "--style_mode", "average",
                        "--save_grid", MSIG_DECODE_CACHE_MB=mb)
        files[label] = {}
        for d in ("dom1", "dom6"):
            check(os.path.exists(os.path.join(out_dir, d, "style_modes_grid.png")),
                  f"[train options grid] {label}: {d}/style_modes_grid.png")
            for n in sorted(os.listdir(os.path.join(out_dir, d))):
                if n != "style_modes_grid.png":
                    with open(os.path.join(out_dir, d, n), "rb") as f:
                        files[label][f"{d}/{n}"] = f.read()
        print(f"[train options] --save_grid over dom1,dom6 ({label}, MSIG_DECODE_CACHE_MB={mb}): "
              f"{len(files[label])} images and a grid a domain in {secs:.2f} s", flush=True)
    check(len(files["cache"]) == 2 * N_INPUTS and files["cache"] == files["no cache"],
          "[train options] the decode cache's files equal those decoded per domain, byte for byte")
    print(f"[train options] decode cache: {len(files['cache'])} files byte-equal with and "
          f"without it; phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def device_data_phase(torch, work: str) -> None:
    """``DeviceData`` (``--device_data``) on the card against the same dataset on
    the CPU: the bank uploaded alike, an epoch's draws (domains) equal and its
    augmented images within 1 uint8 step; one batch's time by CUDA events."""
    from PIL import Image

    from msig_tpu_torch.data import DeviceData, MultiDomainDataset

    rng = np.random.default_rng(6)
    src, ref = os.path.join(work, "dd_src"), os.path.join(work, "dd_ref")
    os.makedirs(src)
    for i in range(8):  # two of them off the base size: resized when the bank is built
        side = 256 if i % 4 else 300
        Image.fromarray(rng.integers(0, 256, (side, side, 3), dtype=np.uint8)).save(
            os.path.join(src, f"s{i}.png"))
    for d in range(2):
        os.makedirs(os.path.join(ref, f"dom{d}"))
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)).save(
                os.path.join(ref, f"dom{d}", f"r{i}.png"))
    ds = MultiDomainDataset.build(src, ref)
    card, host = DeviceData(ds, 256, device="cuda"), DeviceData(ds, 256, device="cpu")
    check(torch.equal(card.bank_src.cpu(), host.bank_src)
          and torch.equal(card.bank_trg.cpu(), host.bank_trg), "[device data] banks equal")
    worst, differing, n = 0, 0, 0
    for g, h in zip(card.epoch(0, 4, seed=1), host.epoch(0, 4, seed=1)):
        check(g["source"].device.type == "cuda", "[device data] batches on the card")
        check(torch.equal(g["target_domain"].cpu(), h["target_domain"]), "[device data] domains")
        for k in ("source", "target"):
            d = (g[k].cpu().to(torch.int32) - h[k].to(torch.int32)).abs()
            worst, differing, n = max(worst, int(d.max())), differing + int((d > 0).sum()), n + d.numel()
    check(worst <= 1, f"[device data] card vs CPU max step {worst} <= 1")
    idx = np.arange(4)
    ms = cuda_ms(torch, lambda: card.batch(idx, np.random.default_rng(0)), reps=5)
    print(f"[device data] DeviceData(256², 8 sources, 2 domains) on the card vs the CPU: epoch 0 "
          f"at batch 4, draws equal, images max step {worst}, {differing} of {n} elements "
          f"differing; one batch {ms:.3f} ms (CUDA events, median of 5, host draws included)",
          flush=True)


def bench_batches_phase(torch, mods) -> None:
    """The served int8 chain at the bench's batches: at 256², batches 128 and 256,
    and at 512², batch 32 (bench.py's defaults), on the bench's seeded weights:
    the first 8 samples equal to the bit to a batch-8 call on the same images and
    styles, each kernel site launched as on its path once a call; time per call
    by CUDA events. The styles are one-hot rows scaled by a normal draw, so that
    the style affines (``tq._style_affines``, one batched fp32 product) are exact
    whatever the batch: with dense styles the library's product rounds its last
    bit by the batch's size (the CPU shows it from batch 2), which the kernel
    sites then carry; the same comparison with dense styles is reported beside
    it, the pixels it moves counted, not checked."""
    from msig_tpu_torch import bench
    from msig_tpu_torch.infer import quantized as tq

    gen = bench._seeded_generator(torch)
    q = {k: v.to("cuda") for k, v in tq.quantize_generator_params(gen.state_dict(), N_RES).items()}
    rng = np.random.default_rng(9)
    with env(MSIG_TRUNK_HIFI="0", MSIG_TRUNK_V3="0", MSIG_ENC1_IM2COL="0"), torch.inference_mode():
        for size, batches, path in BENCH_BATCHES:
            n = max(batches)
            imgs = torch.from_numpy(rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)).cuda()
            one_hot = torch.zeros((n, 256))
            one_hot[torch.arange(n), torch.from_numpy(rng.integers(0, 256, n))] = \
                torch.from_numpy(rng.normal(0, 2, n).astype(np.float32))
            dense = torch.from_numpy(rng.normal(0, 1, (n, 256)).astype(np.float32)).cuda()
            one_hot = one_hot.cuda()

            def call(styles, bs):
                return tq.quantized_generator_apply(q, imgs[:bs], styles[:bs], n_res=N_RES,
                                                    out_dtype=torch.uint8)
            ref, ref_dense = call(one_hot, B), call(dense, B)
            for bs in batches:
                reset_counts(mods)
                out = call(one_hot, bs)
                torch.cuda.synchronize()
                launches = {k: v for k, v in read_counts(mods).items() if v}
                check(launches == PATHS[path],
                      f"[bench batches {size}²/{bs}] launches {launches}, want {PATHS[path]}")
                check(out.shape == (bs, size, size, 3) and out.dtype == torch.uint8,
                      f"[bench batches {size}²/{bs}] output {tuple(out.shape)} {out.dtype}")
                diff = int((out[:B].to(torch.int32) - ref.to(torch.int32)).abs().max())
                check(diff == 0, f"[bench batches {size}²/{bs}] the first {B} samples equal a "
                                 f"batch-{B} call's to the bit (max diff {diff})")
                del out
                d = (call(dense, bs)[:B].to(torch.int32) - ref_dense.to(torch.int32)).abs()
                affine = tq._style_affines(q, dense[:bs], N_RES)[0][:, :B]
                same_affine = torch.equal(affine, tq._style_affines(q, dense[:B], N_RES)[0])
                ms = cuda_ms(torch, lambda: call(one_hot, bs), reps=3, warmup=1)
                print(f"[bench batches {size}²/{bs}] int8 chain, uint8 out, one-hot styles: first "
                      f"{B} samples equal to a batch-{B} call's to the bit; launches per call "
                      f"{launches}; {ms:.2f} ms per call ({1000 * bs / ms:.0f} images/s, CUDA "
                      f"events, median of 3). Dense styles: affines "
                      f"{'equal' if same_affine else 'not equal'} to the batch-{B} product's, "
                      f"{int((d > 0).sum())} of {d.numel()} pixels differ, max {int(d.max())}",
                      flush=True)
            del imgs, one_hot, dense, ref, ref_dense
            torch.cuda.empty_cache()


def bench_phase(torch, mods, ap, card: str) -> None:
    """The bench entry point. In this process, its inference worker
    (``bench.run_inference_worker``) at 256², batches 8 and 128, the launch
    counts set to 0 before and read after: every int8 call launches each site
    of ``256/hifi0`` once, the bf16 configs no kernel. Then ``python -m
    msig_tpu_torch.bench`` in all five modes at short settings (``BENCH_RUNS``),
    the five processes at once (a check of the entry point's contract, whose
    numbers share the card: the bench is measured alone, not here): exit 0 and
    exactly one JSON line each, with its metric name and unit."""
    import contextlib
    import io

    from msig_tpu_torch import bench

    lines = io.StringIO()
    with env(MSIG_TRUNK_HIFI="0", MSIG_TRUNK_V3="0", MSIG_ENC1_IM2COL="0"):
        reset_counts(mods + (ap,))
        with contextlib.redirect_stdout(lines):
            bench.run_inference_worker(BENCH_WORKER[0], iters=3, warmup=1,
                                       image_size=BENCH_WORKER[1], device="cuda")
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_counts(mods + (ap,)).items() if v}
    recs = [json.loads(ln) for ln in lines.getvalue().splitlines() if ln.strip()]
    rates = {r["config"]: r.get("rate") for r in recs if "config" in r}
    n_int8 = len(BENCH_WORKER[0])
    check(recs[-1] == {"done": True} and all(rates.values()) and len(rates) == 2 * n_int8,
          f"[bench worker] every config measured: {recs}")
    calls = n_int8 * (1 + 3)  # each int8 config: one warm-up and three timed calls
    want = {k: v * calls for k, v in PATHS["256/hifi0"].items()}
    check(launches == want, f"[bench worker] launches {launches}, want {want}")
    print(f"[bench worker] bench.run_inference_worker({BENCH_WORKER[0]}, iters=3) at "
          f"{BENCH_WORKER[1]}²: {rates} "
          f"(img/s); launches {launches}: each int8 call ran the 22 sites of 256/hifi0, the bf16 "
          f"configs no kernel", flush=True)

    environ = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    runs = {mode: (mode, {}) for mode in BENCH_RUNS}
    runs.update({f"train MSIG_CONV_VJP={v}": ("train", {"MSIG_CONV_VJP": v})
                 for v in BENCH_TRAIN_ROUTES})
    procs = {label: subprocess.Popen(
        [sys.executable, "-m", "msig_tpu_torch.bench", "--mode", mode, *BENCH_RUNS[mode][0]],
        cwd=ROOT, env=dict(environ, **extra), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for label, (mode, extra) in runs.items()}
    t0 = time.perf_counter()
    try:
        outs = {label: p.communicate(timeout=600) for label, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for label, (mode, extra) in runs.items():
        args, metric, unit = BENCH_RUNS[mode]
        out, err = outs[label]
        rc = procs[label].returncode
        detail = [ln.strip() for ln in err.splitlines() if ln.startswith("  ")]
        check(rc == 0, f"[bench {label}] exit code {rc}: {err[-1500:]}")
        stdout = [ln for ln in out.splitlines() if ln.strip()]
        check(len(stdout) == 1, f"[bench {label}] {len(stdout)} stdout lines: {stdout}")
        rec = json.loads(stdout[0])
        check(rec["metric"] == metric and rec["unit"] == unit and rec["vs_baseline"] is None
              and rec["value"] > 0, f"[bench {label}] {rec}")
        setting = "".join(f"{k}={v} " for k, v in extra.items())
        print(f"[bench {label}] {setting}python -m msig_tpu_torch.bench --mode {mode} "
              f"{' '.join(args)} ({len(runs)} runs at once on {card}): {stdout[0]}; "
              f"{' | '.join(detail)}", flush=True)
    print(f"[bench] five modes and the train mode on {len(BENCH_TRAIN_ROUTES)} kernel routes in "
          f"{wall:.1f} s", flush=True)


PAR_DEVICES = ("cuda:0", "cuda:0")  # [parallel]: two data-parallel shards on the one card
PAR_LOSS_RTOL, PAR_NORM_RTOL = 1e-4, 1e-3  # step-1 losses, grad norms (the train phase's bars)
EVAL_B, EVAL_SIDE = 32, 299                # [eval]: the timed Inception batch


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parallel_step(torch, dev, distributed: bool, split: bool = False):
    """Step 1 of the full-width train step at level 1 + ``--pallas`` (rows 22-23)
    from the seeded parameters and batch of ``train_inputs``; ``split``: this
    rank's rows of that global batch. Returns (metrics, state, launches of the
    training kernels)."""
    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.ops import adain_pallas as ap
    from msig_tpu_torch.ops import conv3x3_vjp as cv
    from msig_tpu_torch.parallel import shard_batch
    from msig_tpu_torch.train import create_train_state, make_train_step

    batch, vgg, weights = train_inputs(torch, dev)
    if split:
        batch = shard_batch(batch)
    cfg = TrainConfig(image_size=TRAIN_SIZE, batch_size=TRAIN_B, n_residual_blocks=N_RES,
                      style_dim=256, use_pallas=True, device=dev.type)
    with env(MSIG_CONV_VJP="1"):
        state = create_train_state(cfg, N_DOMAINS)
        step = make_train_step(cfg.ema_beta, distributed=distributed)
        ap.reset_launch_counts()
        cv.reset_launch_counts()
        metrics = step(state, batch, vgg, cfg.lr_g, cfg.lr_d, weights)
        torch.cuda.synchronize()
    launches = {k: v for k, v in {**ap.LAUNCHES, **cv.LAUNCHES}.items() if v}
    return {k: float(v) for k, v in metrics.items()}, state, launches


def _first_moments(state) -> list:
    """Adam's first moments after step 1, G group then D group, on the host:
    (1 - b1) times the clipped step-1 gradients."""
    return [m.cpu() for m in state.opt_g.mu + state.opt_d.mu]


def parallel_rank(rank: int, port: int, out: str) -> None:
    """One of the two ranks of ``[parallel]``'s train step: a gloo group on the one
    card (NCCL refuses two ranks on one GPU), this rank's half of the batch."""
    import torch
    import torch.distributed as dist

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from msig_tpu_torch.parallel import replicated

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        metrics, state, launches = parallel_step(torch, torch.device("cuda"), True, split=True)
        same = all(replicated(net) for net in state.models.nets.values())
        torch.save({"metrics": metrics, "launches": launches, "replicated": same,
                    "mu": _first_moments(state) if rank == 0 else None},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def parallel_phase(torch, mods, work: str) -> None:
    """Data parallelism on the one card.

    Serving: the demo checkpoint's int8 engine at 256², mode 0, batch 8, with
    ``--data_parallel`` over ``PAR_DEVICES`` (two shards of 4, each with its own
    copy of the networks and the int8 weights): each shard runs the 22 kernel
    sites, 44 a batch; the served batch equals the single-device engine's to
    the bit on one-hot styles (exact style affines), dense styles reported
    beside (each shard forms its own affines, as JAX's ``shard_map`` body
    does). Training: the full-width step at level 1 + ``--pallas``, global
    batch 4, as two ranks over gloo on the one card (two spawned processes):
    rows 22-23 launched on each rank, the ranks' parameters equal, the metrics
    and the step-1 gradients (Adam's first moments) held against the
    one-process step (losses rtol 1e-4, grad norms 1e-3, gradients within
    ``GRAD_RTOL`` / ``GRAD_ATOL_REL``); then a one-rank NCCL group's step
    (every collective on NCCL): its metrics equal to the no-group step's to the
    bit, its step-1 gradients within the bars, reported beside a rerun of the
    no-group step (whose gradients are not bitwise reproducible either)."""
    import dataclasses

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from msig_tpu_torch.config import InferenceConfig
    from msig_tpu_torch.infer.engine import InferenceEngine
    from msig_tpu_torch.infer.loading import load_inference_params

    t0 = time.perf_counter()
    cfg = InferenceConfig(image_size=256, batch_size=B, quantize="int8", device="cuda")
    gen_sd, se_sd, meta, _ = load_inference_params(DEMO, cfg, 10)
    args = (10, gen_sd, se_sd, meta["n_residual_blocks"], meta["style_dim"])
    single = InferenceEngine.build(cfg, *args)
    dp = InferenceEngine.build(dataclasses.replace(cfg, data_parallel=True), *args,
                               devices=PAR_DEVICES)
    check(dp.replicas is not None and len(dp.replicas) == 2, "[parallel] two shards")
    single.out_uint8 = dp.out_uint8 = True
    rng = np.random.default_rng(12)
    imgs = torch.from_numpy(rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8)).cuda()
    one_hot = torch.zeros((B, 256))
    one_hot[torch.arange(B), torch.from_numpy(rng.integers(0, 256, B))] = \
        torch.from_numpy(rng.normal(0, 2, B).astype(np.float32))
    one_hot = one_hot.cuda()
    dense = torch.from_numpy(rng.normal(0, 1, (B, 256)).astype(np.float32)).cuda()
    want_launches = {k: 2 * v for k, v in PATHS["256/hifi0"].items()}
    with env(MSIG_TRUNK_HIFI="0", MSIG_TRUNK_V3="0", MSIG_ENC1_IM2COL="0"):
        ref, ref_dense = single.generate(imgs, one_hot).cpu(), single.generate(imgs, dense).cpu()
        reset_counts(mods)
        out = dp.generate(imgs, one_hot)
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_counts(mods).items() if v}
        check(launches == want_launches and sum(launches.values()) == 44,
              f"[parallel] launches of a two-shard batch {launches}, want {want_launches}")
        check(out.shape == (B, 256, 256, 3) and out.dtype == torch.uint8,
              f"[parallel] output {tuple(out.shape)} {out.dtype}")
        diff = int((out.to(torch.int32) - ref.to(torch.int32)).abs().max())
        check(diff == 0, f"[parallel] two shards equal the single-device batch to the bit on "
                         f"one-hot styles (max diff {diff})")
        d = (dp.generate(imgs, dense).to(torch.int32) - ref_dense.to(torch.int32)).abs()
        ms_dp = cuda_ms(torch, lambda: dp.generate(imgs, one_hot), reps=10)
        ms_one = cuda_ms(torch, lambda: single.generate(imgs, one_hot).cpu(), reps=10)
    print(f"[parallel] --data_parallel int8 at 256², mode 0, batch {B} over {PAR_DEVICES}: "
          f"launches per batch {sum(launches.values())} ({launches['final7_tanh_u8']} per site "
          f"of the decoder, {launches['conv3x3_adain_relu_requant']} conv1); equal to the "
          f"single-device batch to the bit on one-hot styles; dense styles: "
          f"{int((d > 0).sum())} of {d.numel()} pixels differ, max {int(d.max())}; "
          f"{ms_dp:.2f} ms a batch with the host's concatenation (single device "
          f"{ms_one:.2f} with its copy to the host; CUDA events, median of 10; one card: no "
          f"speed-up to show)", flush=True)
    del single, dp, imgs, out
    torch.cuda.empty_cache()

    # two ranks over gloo on the one card
    out_dir = os.path.join(work, "parallel")
    os.makedirs(out_dir)
    t1 = time.perf_counter()
    mp.start_processes(parallel_rank, args=(_free_port(), out_dir), nprocs=2,
                       start_method="spawn")
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    t_ranks = time.perf_counter() - t1
    dev = torch.device("cuda")
    torch.backends.cudnn.deterministic = True
    ref_metrics, ref_state, ref_launches = parallel_step(torch, dev, False)
    want = {"adain_pallas_fwd": 6 * N_RES, "adain_pallas_bwd": 6 * N_RES,
            "conv3x3_bwd": 6 * N_RES}
    check(ref_launches == want, f"[parallel] one-process launches {ref_launches}")
    for r, rk in enumerate(ranks):
        check(rk["launches"] == want, f"[parallel] rank {r} launches {rk['launches']}, want {want}")
        check(rk["replicated"], f"[parallel] rank {r}'s parameters equal rank 0's")
        for k, v in ref_metrics.items():
            rtol = PAR_NORM_RTOL if k.endswith("grad_norm") else PAR_LOSS_RTOL
            check(abs(rk["metrics"][k] - v) <= rtol * abs(v),
                  f"[parallel] rank {r} {k} {rk['metrics'][k]} vs one process {v} (rtol {rtol})")
    ref_mu = _first_moments(ref_state)
    n_g = len(ref_state.opt_g.mu)
    worst = 0.0
    for lo, hi in ((0, n_g), (n_g, len(ref_mu))):
        atol = GRAD_ATOL_REL * max(float(m.abs().max()) for m in ref_mu[lo:hi])
        for g, w in zip(ranks[0]["mu"][lo:hi], ref_mu[lo:hi]):
            worst = max(worst, float(((g - w).abs() / (GRAD_RTOL * w.abs() + atol)).max()))
    check(worst <= 1.0, f"[parallel] two-rank step-1 gradients within their bars ({worst:.3f})")
    print(f"[parallel] train step at {TRAIN_SIZE}², level1+pallas, global batch {TRAIN_B} as 2 "
          f"gloo ranks on the one card: launches per rank {ranks[0]['launches']}; parameters "
          f"equal across ranks; metrics vs one process: "
          + ", ".join(f"{k} {ranks[0]['metrics'][k]:.6g}/{v:.6g}" for k, v in ref_metrics.items())
          + f"; step-1 gradients at {worst:.3f} of their bars (rtol {GRAD_RTOL} / atol "
          f"{GRAD_ATOL_REL} x max of the group); the ranks took {t_ranks:.1f} s "
          "(spawn, start, step 1)", flush=True)

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        nccl_metrics, nccl_state, _ = parallel_step(torch, dev, True)
    finally:
        dist.destroy_process_group()
    apart = {k: (v, ref_metrics[k]) for k, v in nccl_metrics.items() if v != ref_metrics[k]}
    check(not apart, f"[parallel] a one-rank NCCL group's step-1 metrics equal the no-group "
                     f"step's to the bit (apart: {apart})")
    nccl_mu = _first_moments(nccl_state)
    del nccl_state
    rerun_metrics, rerun_state, _ = parallel_step(torch, dev, False)
    rerun_mu = _first_moments(rerun_state)
    del rerun_state

    def spread(mus) -> tuple:
        """(leaves apart from the first no-group step's, max |diff|, worst share of the bar)"""
        n, top, worst = 0, 0.0, 0.0
        for lo, hi in ((0, n_g), (n_g, len(ref_mu))):
            atol = GRAD_ATOL_REL * max(float(m.abs().max()) for m in ref_mu[lo:hi])
            for g, w in zip(mus[lo:hi], ref_mu[lo:hi]):
                n += not torch.equal(g, w)
                top = max(top, float((g - w).abs().max()))
                worst = max(worst, float(((g - w).abs() / (GRAD_RTOL * w.abs() + atol)).max()))
        return n, top, worst

    nccl, rerun = spread(nccl_mu), spread(rerun_mu)
    check(rerun_metrics == ref_metrics and nccl[2] <= 1.0,
          f"[parallel] one-rank NCCL step-1 gradients within their bars ({nccl}, rerun {rerun})")
    print(f"[parallel] one-rank NCCL group (every collective of the step on NCCL): step 1's "
          f"metrics equal the no-group step's to the bit; first moments: {nccl[0]} of "
          f"{len(ref_mu)} leaves apart, max |diff| {nccl[1]:.3g}, {nccl[2]:.3f} of their bars; "
          f"a rerun of the no-group step itself: metrics equal to the bit, {rerun[0]} leaves "
          f"apart, max |diff| {rerun[1]:.3g}, {rerun[2]:.3f} of the bars (the fp32 step's "
          f"backward is not bitwise reproducible on the card); phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del ref_state
    torch.cuda.empty_cache()


def inception_npz(path: str) -> str:
    """A seeded random InceptionV3 in torchvision's state_dict layout, written as
    ``tools/convert_inception_weights.py`` writes it (``.`` -> ``__``), with the
    train-time ``AuxLogits`` head and a ``num_batches_tracked`` counter for the
    loader to drop; per-tensor seeds from ``zlib.crc32`` of the key."""
    import zlib

    from msig_tpu_torch.eval.inception import InceptionV3Pool3

    out = {}
    for k, v in InceptionV3Pool3().state_dict().items():
        rng = np.random.default_rng(zlib.crc32(k.encode()))
        shape = tuple(v.shape)
        if k.endswith("conv.weight"):
            a = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("running_var"):
            a = 1.0 + 0.1 * np.abs(rng.standard_normal(shape))
        elif k.endswith("bn.weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        out[k.replace(".", "__")] = a.astype(np.float32)
    out["AuxLogits__conv0__conv__weight"] = np.zeros((128, 768, 1, 1), np.float32)
    out["Mixed_5b__branch1x1__bn__num_batches_tracked"] = np.zeros((), np.int64)
    np.savez(path, **out)
    return path


def eval_phase(torch, card: str, work: str) -> None:
    """Eval on the card: InceptionV3 pool3 (stock PyTorch, cuDNN, TF32 off) of a
    seeded random torchvision-layout npz, end to end from uint8 256² images
    (resized to 299), within the fp32 bars (rtol 1e-3, atol 1e-4) of the CPU
    forward; ms per 32-image 299² batch (the network alone, and with the resize
    from 256²; CUDA events, median of 10); then ``python -m
    msig_tpu_torch.tools.evaluate_fid`` over two directories of synthetic
    images (the proxy FID on the port's seeded random VGG): exit 0, one JSON line."""
    from PIL import Image

    from msig_tpu_torch.eval import inception as inc

    t0 = time.perf_counter()
    npz = inception_npz(os.path.join(work, "inception_rand.npz"))
    rng = np.random.default_rng(13)
    imgs = rng.integers(0, 256, (4, 256, 256, 3), dtype=np.uint8)
    got = inc.inception_feature_fn(npz, "cuda")(imgs)
    want = inc.inception_feature_fn(npz, "cpu")(imgs)
    err = float(np.abs(got - want).max())
    check(got.shape == (4, 2048) and np.allclose(got, want, rtol=1e-3, atol=1e-4),
          f"[eval] pool3 on the card within rtol 1e-3 / atol 1e-4 of the CPU (max |diff| {err:.3g})")
    model = inc.load_inception(npz, "cuda")
    x = torch.rand((EVAL_B, 3, EVAL_SIDE, EVAL_SIDE), device="cuda")
    x256 = torch.rand((EVAL_B, 3, 256, 256), device="cuda")
    with torch.inference_mode():
        ms = cuda_ms(torch, lambda: model(x), reps=10)
        ms_resize = cuda_ms(torch, lambda: model(inc.resize_299(x256)), reps=10)
    del model, x, x256
    torch.cuda.empty_cache()
    dirs = []
    for name, lo in (("a", 0), ("b", 80)):
        d = os.path.join(work, "fid", name)
        os.makedirs(d)
        for i in range(8):
            Image.fromarray(rng.integers(lo, lo + 176, (256, 256, 3), dtype=np.uint8)).save(
                os.path.join(d, f"img{i}.png"))
        dirs.append(d)
    r = subprocess.run([sys.executable, "-m", "msig_tpu_torch.tools.evaluate_fid", "--dir_a",
                        dirs[0], "--dir_b", dirs[1], "--device", "cuda"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    lines = r.stdout.strip().splitlines()
    check(r.returncode == 0 and len(lines) == 1,
          f"[eval] evaluate_fid exit {r.returncode}, stdout {r.stdout[-500:]!r}, "
          f"stderr {r.stderr[-2000:]}")
    line = json.loads(lines[0])
    check(set(line) == {"metric", "value", "dir_a", "dir_b"} and np.isfinite(line["value"]),
          f"[eval] evaluate_fid's JSON line {line}")
    print(f"[eval] InceptionV3 pool3 (seeded random torchvision-layout npz) on the card: 4 "
          f"uint8 256² images within rtol 1e-3 / atol 1e-4 of the CPU (max |diff| {err:.3g}); "
          f"{ms:.2f} ms per {EVAL_B}-image {EVAL_SIDE}² batch ({1000 * EVAL_B / ms:.0f} images/s), "
          f"{ms_resize:.2f} with the resize from 256² (CUDA events, median of 10; {card}); "
          f"evaluate_fid: {lines[0]}; phase {time.perf_counter() - t0:.1f} s", flush=True)


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
        train512_phase(torch, ap, cv, int8_mods, dev, train_kernels)
        run_dir = train_cli_phase(torch, work)
        quality_phase(torch, work, run_dir)
        bf16_launches = train_bf16_phase(torch, ap, cv, int8_mods, dev)
        train_options_phase(torch, ap, cv, int8_mods, dev, work)
        device_data_phase(torch, work)
        bench_batches_phase(torch, int8_mods)
        bench_phase(torch, int8_mods, ap, card)
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
        # last: NCCL and the spawned ranks come after every torch.profiler session
        parallel_phase(torch, int8_mods, work)
        eval_phase(torch, card, work)
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
    # Rows 23-24 carry their bf16 entries as "bf16": the same keys, the
    # launches from step 1 of the bf16 step in the configuration that runs them.
    rows += [dict(k, name=name, route="cuda",
                  source=f"msig_tpu_torch/csrc/{TRAIN_KERNELS[name][1]}",
                  replaces=TRAIN_KERNELS[name][0],
                  launches=train["launches"][TRAIN_KERNELS[name][2]][name],
                  path=f"train/{TRAIN_KERNELS[name][2]}",
                  **({"bf16": dict(k["bf16"], name=f"{name} (bf16 entry)", route="cuda",
                                   source=f"msig_tpu_torch/csrc/{TRAIN_KERNELS[name][1]}",
                                   replaces=TRAIN_KERNELS[name][0],
                                   launches=bf16_launches[TRAIN_KERNELS[name][2]][name],
                                   path=f"train bf16/{TRAIN_KERNELS[name][2]}")}
                     if "bf16" in k else {}))
             for name, k in train_kernels.items()]
    check(len(rows) == len(SITES) + len(TRAIN_KERNELS), f"{len(rows)} kernel rows")
    for row in rows + [r["bf16"] for r in rows if "bf16" in r]:
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
