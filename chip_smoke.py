#!/usr/bin/env python3
"""Smoke run of msig_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. build: compiles the six CUDA sources of the serving path from
   ``msig_tpu_torch/csrc`` (one nvcc per source, all at once) and prints the
   card's name and power limit as nvidia-smi reports them;
2. kernels: each of the eight kernel sites against its plain PyTorch version
   on the card, at the main path's shapes (batch 8): enc0 uint8
   [8, 256, 256, 3] -> [8, 256, 256, 64], enc1 [8, 256, 256, 64] ->
   [8, 128, 128, 128], enc2 [8, 128, 128, 128] -> [8, 64, 64, 256], the two
   trunk sites at [8, 64, 64, 256], up0 [8, 64, 64, 256] ->
   [8, 128, 128, 128], up1 [8, 128, 128, 128] -> [8, 256, 256, 64], final7
   [8, 256, 256, 64] -> [8, 256, 256, 3], with seeded random inputs: int8
   outputs at most 1 step apart on under 1% of the elements, scales within
   rtol 1e-5, uint8 at most 1 apart on under 1e-3; times by CUDA events;
3. end to end: ``msig_tpu_torch.inference.main`` on ``cuda`` with
   ``--quantize int8``, the committed demo checkpoint (10 domains, 8
   resblocks, style_dim 256) at 256², batch 8, over 20 seeded inputs: one
   output per input, each encoder and decoder site launched once per batch
   and each trunk site 8 times, and the int8 output's PSNR against the
   port's fp32 float path on the same inputs and style at least 30 dB; then
   the generators' steady-state time per batch and the int8 generator's
   stages, the kernel encoder and the unfused encoder on the same images, the
   kernel decoder and the unfused decoder on the same trunk output;
4. a ``{"kernels": [...]}`` line, then the card line, then the last line
   ``{"ok": true, "device": {...}}``.

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
N_RES = 8                          # resblocks of the demo checkpoint
N_INPUTS, TARGET = 20, "dom3"     # 3 batches of 8, the last one padded
# kernel site -> (TPU kernel it replaces, CUDA source, launches per batch on the main path)
SITES = {
    "enc0_in_relu_requant": ("msig_tpu/ops/fused_enc_int8.py:606", "enc0_in_relu_requant.cu", 1),
    "enc1_in_relu_requant": ("msig_tpu/ops/fused_enc_int8.py:623",
                             "conv4x4s2_in_relu_requant.cu", 1),
    "enc2_in_relu_requant": ("msig_tpu/ops/fused_enc_int8.py:643",
                             "conv4x4s2_in_relu_requant.cu", 1),
    "conv3x3_adain_relu_requant": ("msig_tpu/ops/fused_conv_int8_v2.py:351",
                                   "conv3x3_adain_relu_requant.cu", N_RES),
    "conv3x3_adain_residual_requant": ("msig_tpu/ops/fused_conv_int8_v2.py:386",
                                       "conv3x3_adain_residual_requant.cu", N_RES),
    "convt4x4s2_in_relu_requant_ps": ("msig_tpu/ops/fused_conv_int8_v2.py:653",
                                      "convt4x4s2_in_relu_requant.cu", 1),
    "up1_s2d16": ("msig_tpu/ops/fused_dec_int8.py:237", "convt4x4s2_in_relu_requant.cu", 1),
    "final7_tanh_u8": ("msig_tpu/ops/fused_dec_int8.py:612", "final7_tanh_u8.cu", 1),
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


def bound(site: str) -> tuple:
    """(bound_ms, bound_by) for one site call at its main-path shape, batch B.

    Bytes: each input read once, each output written once. Operations: the
    int8 multiply-adds of the conv (2 ops each) at the int8 tensor rate, plus
    the fp32 work per output element at the fp32 rate: statistics (3), and
    affine + ReLU + clip + round (5) at the relu, ConvT and encoder sites, or hn (4) +
    max|hn| (2) + scale, clip, round (4) at the residual site; at final7,
    dequant, bias, tanh (counted as 20), scale, round, clip (26)."""
    if site in ("conv3x3_adain_relu_requant", "conv3x3_adain_residual_requant"):
        out = B * SIDE * SIDE * C
        int8_ops = 2 * out * 9 * C
        if site == "conv3x3_adain_relu_requant":
            nbytes, fp_ops = 2 * out + 9 * C * C + 2 * B * C * 4, 8 * out
        else:
            nbytes, fp_ops = 3 * out + 9 * C * C + 2 * B * C * 4 + 2 * B * 4, 13 * out
    elif site in ("convt4x4s2_in_relu_requant_ps", "up1_s2d16"):
        side, cin = (SIDE, C) if site == "convt4x4s2_in_relu_requant_ps" else (2 * SIDE, C // 2)
        cout = cin // 2
        x_elems, out = B * side * side * cin, B * 4 * side * side * cout
        int8_ops = 2 * out * 4 * cin
        nbytes, fp_ops = x_elems + 16 * cin * cout + out + B * 4, 8 * out
    elif site == "enc0_in_relu_requant":
        px = B * 4 * SIDE * 4 * SIDE
        out = px * 64
        int8_ops = 2 * out * 147
        nbytes, fp_ops = px * 3 + 160 * 64 + out, 8 * out
    elif site in ("enc1_in_relu_requant", "enc2_in_relu_requant"):
        side, cin = (4 * SIDE, C // 4) if site == "enc1_in_relu_requant" else (2 * SIDE, C // 2)
        cout = 2 * cin
        x_elems, out = B * side * side * cin, B * (side // 2) * (side // 2) * cout
        int8_ops = 2 * out * 16 * cin
        nbytes, fp_ops = x_elems + 16 * cin * cout + out + B * 4, 8 * out
    else:
        x_elems, out = B * 4 * SIDE * 4 * SIDE * 64, B * 4 * SIDE * 4 * SIDE * 3
        int8_ops = 2 * out * 49 * 64
        nbytes, fp_ops = x_elems + 3 * 64 * 49 + 2 * 3 * 4 + B * 4 + out, 26 * out
    t_ops = int8_ops / PEAK_INT8_OPS + fp_ops / PEAK_FP32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(torch, fc, fd, fe, dev) -> dict:
    rng = np.random.default_rng(0)
    shape = (B, SIDE, SIDE, C)
    x = rng.integers(-127, 128, shape, dtype=np.int8)
    w = rng.integers(-32, 33, (3, 3, C, C), dtype=np.int8)
    gamma = rng.normal(1.0, 0.5, (B, C)).astype(np.float32)
    beta = rng.normal(0.0, 0.5, (B, C)).astype(np.float32)
    h = rng.normal(0, 1.5, shape).astype(np.float32)
    hs = (np.abs(h).max(axis=(1, 2, 3)) / 127.0).astype(np.float32).reshape(B, 1)
    hq = np.clip(np.round(h / hs.reshape(B, 1, 1, 1)), -127, 127).astype(np.int8)
    # up1, final7, enc1 and enc2 read ReLU outputs (0..127): x1 feeds up1 and
    # enc2, x2 final7 and enc1. final7's scales put y * wscale * inv_s around
    # +-1.5, across the tanh.
    x1 = rng.integers(0, 128, (B, 2 * SIDE, 2 * SIDE, C // 2), dtype=np.int8)
    x2 = rng.integers(0, 128, (B, 4 * SIDE, 4 * SIDE, 64), dtype=np.int8)
    t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        x=x, hq=hq, hs=hs, gamma=gamma, beta=beta, x1=x1, x2=x2,
        img=rng.integers(0, 256, (B, 4 * SIDE, 4 * SIDE, 3), dtype=np.uint8),
        w7=rng.integers(-127, 128, (3, 64, 7, 7), dtype=np.int8),
        ws7=rng.uniform(1e-4, 2e-4, 3).astype(np.float32),
        b7=rng.uniform(-0.3, 0.3, 3).astype(np.float32),
        is7=rng.uniform(0.02, 0.05, (B, 1)).astype(np.float32)).items()}
    t["w"] = fc.pack_weights(torch.from_numpy(w)).to(dev)
    for name, cin in (("w0", C), ("w1", C // 2)):
        wt = rng.integers(-127, 128, (4, 4, cin, cin // 2), dtype=np.int8)
        t[name] = fc.pack_convt_weights_ps(torch.from_numpy(wt), cin, cin // 2).to(dev)

    t["we0"] = fe.pack_enc0(torch.from_numpy(
        rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8))).to(dev)
    for name, cin in (("we1", C // 4), ("we2", C // 2)):
        wt = rng.integers(-127, 128, (4, 4, cin, 2 * cin), dtype=np.int8)
        t[name] = fe.pack_conv4x4(torch.from_numpy(wt)).to(dev)

    final7_args = (t["x2"], t["w7"], t["ws7"], t["b7"], t["is7"])
    calls = {
        "enc0_in_relu_requant": (lambda: fe.enc0_in_relu_requant(t["img"], t["we0"]),
                                 lambda: fe.enc0_in_relu_requant_plain(t["img"], t["we0"])),
        "enc1_in_relu_requant": (lambda: fe.enc1_in_relu_requant(t["x2"], t["we1"]),
                                 lambda: fe.enc1_in_relu_requant_plain(t["x2"], t["we1"])),
        "enc2_in_relu_requant": (lambda: fe.enc2_in_relu_requant(t["x1"], t["we2"]),
                                 lambda: fe.enc2_in_relu_requant_plain(t["x1"], t["we2"])),
        "conv3x3_adain_relu_requant": (
            lambda: fc.conv3x3_adain_relu_requant(t["x"], t["w"], t["gamma"], t["beta"]),
            lambda: fc.conv3x3_adain_relu_requant_plain(t["x"], t["w"], t["gamma"], t["beta"])),
        "conv3x3_adain_residual_requant": (
            lambda: fc.conv3x3_adain_residual_requant(t["x"], t["hq"], t["hs"], t["w"],
                                                      t["gamma"], t["beta"]),
            lambda: fc.conv3x3_adain_residual_requant_plain(t["x"], t["hq"], t["hs"], t["w"],
                                                            t["gamma"], t["beta"])),
        "convt4x4s2_in_relu_requant_ps": (
            lambda: fc.convt4x4s2_in_relu_requant_ps(t["x"], t["w0"]),
            lambda: fc.convt4x4s2_in_relu_requant_ps_plain(t["x"], t["w0"])),
        "up1_s2d16": (lambda: fd.up1_s2d16(t["x1"], t["w1"]),
                      lambda: fd.up1_s2d16_plain(t["x1"], t["w1"])),
        "final7_tanh_u8": (lambda: fd.final7_tanh_u8(*final7_args),
                           lambda: fd.final7_tanh_u8_plain(*final7_args)),
    }
    results = {}
    for name, (kernel, plain) in calls.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        scale_err = None
        if isinstance(got, tuple):
            (got, got_s), (want, want_s) = got, want
            check(torch.allclose(got_s, want_s, rtol=1e-5, atol=0), f"{name} scale rtol 1e-5")
            scale_err = float(((got_s - want_s).abs() / want_s.abs()).max())
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{name} output {got.dtype} {tuple(got.shape)}")
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        max_err, frac = int(diff.max()), float((diff > 0).float().mean())
        limit = 1e-3 if got.dtype == torch.uint8 else 0.01
        check(max_err <= 1, f"{name} max step {max_err} <= 1")
        check(frac < limit, f"{name} differing share {frac} < {limit}")
        ms = cuda_ms(torch, kernel, reps=30)
        plain_ms = cuda_ms(torch, plain, reps=3, warmup=1)
        bound_ms, bound_by = bound(name)
        results[name] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
        print(f"[kernel] {name} {tuple(got.shape)} {got.dtype}: max step {max_err}, "
              f"differing {frac:.2e}, scale rel err {scale_err}, {ms:.4f} ms (median of 30, "
              f"CUDA events), plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by})",
              flush=True)
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


def e2e_phase(torch, fc, fd, fe, work: str) -> dict:
    from PIL import Image

    from msig_tpu_torch import inference as cli
    from msig_tpu_torch.config import InferenceConfig
    from msig_tpu_torch.infer.engine import InferenceEngine
    from msig_tpu_torch.infer.loading import load_inference_params

    inp, ref = write_inputs(work)
    out = os.path.join(work, "out")
    args = cli.build_arg_parser().parse_args([
        "--input_dir", inp, "--ref_domains_dir", ref, "--checkpoint_dir", DEMO,
        "--output_dir", out, "--target_domain", TARGET, "--style_mode", "average",
        "--quantize", "int8", "--image_size", "256", "--batch_size", str(B),
        "--compute_dtype", "float32", "--device", "cuda"])
    for mod in (fc, fd, fe):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(cli.config_from_args(args))
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {**fe.LAUNCHES, **fc.LAUNCHES, **fd.LAUNCHES}
    check(rc == 0, f"inference main exit code {rc} == 0")
    names = sorted(os.listdir(out))
    check(len(names) == N_INPUTS, f"{len(names)} outputs for {N_INPUTS} inputs")
    n_batches = -(-N_INPUTS // B)
    check(set(launches) == set(SITES), f"launch counters {sorted(launches)}")
    for name, n in launches.items():
        per_batch = SITES[name][2]
        check(n == per_batch * n_batches,
              f"{name} launched {n} times, want {per_batch} x {n_batches} batches")
    print(f"[e2e] inference main: rc 0, {len(names)} images in {cli_s:.2f} s "
          f"(load + style bank + build + generate + save: {N_INPUTS / cli_s:.2f} images/s), "
          f"launches {launches}", flush=True)

    # Reference: the port's fp32 float path on the same inputs and style bank.
    cfg = InferenceConfig(image_size=256, batch_size=B, device="cuda", compute_dtype="float32")
    gen_sd, se_sd, meta, _ = load_inference_params(DEMO, cfg, 10)
    engines = {}
    for mode in ("float32", "int8"):
        engines[mode] = InferenceEngine.build(
            InferenceConfig(image_size=256, batch_size=B, device="cuda", compute_dtype="float32",
                            quantize="int8" if mode == "int8" else None),
            10, gen_sd, se_sd, meta["n_residual_blocks"], meta["style_dim"])
        engines[mode].out_uint8 = True
    fl = engines["float32"]
    bank = fl.preload_style_bank(os.path.join(ref, TARGET), int(TARGET[3:]) + 1)
    pairs = []
    for imgs, batch_names in fl.translate_batches(fl.iter_input_batches(inp), bank, "average"):
        for img, name in zip(imgs, batch_names):
            with Image.open(os.path.join(out, name)) as im:
                pairs.append((np.asarray(im), img))
    per_image = [psnr(a, b) for a, b in pairs]
    total = psnr(np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs]))
    check(total >= 30.0, f"int8 vs fp32 PSNR {total:.2f} dB >= 30")
    print(f"[e2e] int8 output vs fp32 float path: PSNR {total:.2f} dB over {len(pairs)} images "
          f"(per image min {min(per_image):.2f}, max {max(per_image):.2f})", flush=True)

    # Steady state: one batch of 8 on the device through each generator.
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8)).cuda()
    styles = bank.mean(dim=0, keepdim=True).expand(B, -1).contiguous()
    rates = {}
    for mode, eng in engines.items():
        ms = cuda_ms(torch, lambda: eng.generate(imgs, styles), reps=10, warmup=2)
        rates[mode] = B / (ms / 1e3)
        print(f"[e2e] {mode} generator, batch {B} at 256²: {ms:.2f} ms per batch, "
              f"{rates[mode]:.1f} images/s (median of 10, CUDA events)", flush=True)

    # Where the int8 generator's time goes, stage by stage.
    from msig_tpu_torch.infer import quantized as tq

    q, n_res = engines["int8"].q, meta["n_residual_blocks"]
    check(n_res == N_RES, f"demo checkpoint has {n_res} resblocks, want {N_RES}")
    with torch.inference_mode():
        hq_in, hs_in = tq._fused_encoder(q, imgs)
        hq = tq._fused_trunk_rows(q, hq_in, hs_in, styles, n_res)
        stages = {
            "encoder, served (3 CUDA kernel sites: enc0, enc1, enc2)": lambda: tq._fused_encoder(
                q, imgs),
            "encoder, unfused (3 convs: int8 library products + bf16 IN/requant)":
                lambda: tq._xla_encoder(q, imgs),
            f"trunk ({2 * n_res} CUDA kernel calls)": lambda: tq._fused_trunk_rows(
                q, hq_in, hs_in, styles, n_res),
            "decoder, served (3 CUDA kernel sites: up0, up1, final7)": lambda: tq._fused_decoder(
                q, hq, torch.uint8),
            "decoder, unfused (2 ConvT + final conv: int8 library products + bf16 IN/requant)":
                lambda: tq._xla_decoder(q, hq, torch.uint8),
        }
        for stage, fn in stages.items():
            print(f"[e2e] int8 stage {stage}: {cuda_ms(torch, fn, reps=5, warmup=1):.2f} ms "
                  f"per batch of {B} (median of 5, CUDA events)", flush=True)
    return dict(launches=launches, psnr=total, cli_s=cli_s, rates=rates)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from msig_tpu_torch.ops import _build
    from msig_tpu_torch.ops import fused_conv_int8_v2 as fc
    from msig_tpu_torch.ops import fused_dec_int8 as fd
    from msig_tpu_torch.ops import fused_enc_int8 as fe

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = t0 = time.perf_counter()
    sources = fe.SOURCES + fc.SOURCES + fd.SOURCES
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
    kernels = kernel_phase(torch, fc, fd, fe, dev)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=str(_build.BUILD_DIR))
    try:
        e2e = e2e_phase(torch, fc, fd, fe, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[time] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s", flush=True)

    # library_ms is null: no single PyTorch call computes conv + IN (+ AdaIN)
    # + requant, or conv7 + dequant + tanh + uint8, and int8 ConvT is no cuDNN op.
    rows = [dict(name=name, route="cuda", source=f"msig_tpu_torch/csrc/{SITES[name][1]}",
                 replaces=SITES[name][0], launches=e2e["launches"][name],
                 max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
                 bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None)
            for name, k in kernels.items()]
    print(json.dumps({"kernels": rows}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
