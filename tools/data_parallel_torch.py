#!/usr/bin/env python3
"""Data parallelism of the PyTorch port over every visible card.

    python3 tools/data_parallel_torch.py [--batches 8 32] [--out_dir DIR]

Needs at least two CUDA devices (run it on a host with several cards); with
fewer it exits 1. On the committed demo checkpoint (10 domains, 8 resblocks,
style_dim 256) at 256², mode 0:

  1. serving: the int8 engine with ``data_parallel`` (the most visible cards
     that divide the batch, each with its own copy of the networks and int8
     weights) against the single-device engine on card 0, at each batch of
     ``--batches``: the kernel sites launched per batch (22 a shard), the
     served batch equal to the single-device one's to the bit on one-hot
     styles (dense styles: the pixels that differ, reported), and ms per
     batch of each (CUDA events on card 0 around the call, which ends on the
     host's concatenation; median of 10 after 3);
  2. ``python -m msig_tpu_torch.inference --data_parallel --quantize int8``
     over 20 seeded inputs: exit 0, one output per input;
  3. ``python -m msig_tpu_torch.train`` for one epoch on a synthetic tree (8
     sources, 9 target domains, 256², batch 4) with its defaults, which start
     one NCCL worker per card itself, and with ``--no_data_parallel``: both
     exit 0, the data-parallel run says how many devices it took, and the
     epoch's loss averages of the two runs agree within JAX's multihost bars
     (rtol 2e-3, atol 1e-4).

Prints one line per part, the card's name and power limit, and a last JSON
line of the results (also written to ``--out_dir`` when given).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "results", "tomato_r3b", "demo_checkpoint")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def serving(torch, batches) -> list:
    from msig_tpu_torch.config import InferenceConfig
    from msig_tpu_torch.infer.engine import InferenceEngine
    from msig_tpu_torch.infer.loading import load_inference_params
    from msig_tpu_torch.ops import (fused_conv_int8_v2, fused_dec_int8, fused_enc_int8,
                                    fused_trunk_v3, int8_epilogue_chunked)

    mods = (fused_conv_int8_v2, fused_dec_int8, fused_enc_int8, fused_trunk_v3,
            int8_epilogue_chunked)
    os.environ.update(MSIG_TRUNK_HIFI="0", MSIG_TRUNK_V3="0", MSIG_ENC1_IM2COL="0")
    results = []
    for bs in batches:
        cfg = InferenceConfig(image_size=256, batch_size=bs, quantize="int8", device="cuda")
        gen_sd, se_sd, meta, _ = load_inference_params(DEMO, cfg, 10)
        args = (10, gen_sd, se_sd, meta["n_residual_blocks"], meta["style_dim"])
        single = InferenceEngine.build(cfg, *args)
        dp = InferenceEngine.build(dataclasses.replace(cfg, data_parallel=True), *args)
        check(dp.replicas is not None, f"batch {bs}: more than one shard")
        single.out_uint8 = dp.out_uint8 = True
        rng = np.random.default_rng(bs)
        imgs = torch.from_numpy(rng.integers(0, 256, (bs, 256, 256, 3), dtype=np.uint8)).cuda()
        one_hot = torch.zeros((bs, 256))
        one_hot[torch.arange(bs), torch.from_numpy(rng.integers(0, 256, bs))] = \
            torch.from_numpy(rng.normal(0, 2, bs).astype(np.float32))
        dense = torch.from_numpy(rng.normal(0, 1, (bs, 256)).astype(np.float32))
        ref = single.generate(imgs, one_hot).cpu()
        for m in mods:
            m.reset_launch_counts()
        out = dp.generate(imgs, one_hot)
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        launches = sum(v for m in mods for v in m.LAUNCHES.values())
        shards = len(dp.replicas)
        check(launches == 22 * shards, f"batch {bs}: {launches} launches, want {22 * shards}")
        check(torch.equal(out, ref), f"batch {bs}: {shards} shards equal one device to the bit")
        d = (dp.generate(imgs, dense).to(torch.int32)
             - single.generate(imgs, dense).cpu().to(torch.int32)).abs()
        ms_dp = median_ms(torch, lambda: dp.generate(imgs, one_hot))
        ms_one = median_ms(torch, lambda: single.generate(imgs, one_hot).cpu())
        row = {"batch": bs, "shards": shards, "devices": [str(r.device) for r in dp.replicas],
               "launches": launches, "one_hot_equal": True,
               "dense_pixels_apart": int((d > 0).sum()), "dense_max_diff": int(d.max()),
               "ms_data_parallel": ms_dp, "ms_single": ms_one,
               **breakdown(torch, dp, imgs, one_hot)}
        print(f"[serving] batch {bs}: host ms to enqueue every shard {row['enqueue_ms']}, to "
              f"wait for each and copy it to the host {row['to_host_ms']}, to concatenate "
              f"{row['cat_ms']} (medians of 10); each shard alone on its card "
              f"(inputs there): {row['shard_alone_ms']} ms; host time by op in one call "
              f"(torch.profiler, self CPU ms, top 6): {row['top_host_ops']}", flush=True)
        print(f"[serving] batch {bs} over {shards} cards: {launches} kernel-site launches, equal "
              f"to one card's to the bit on one-hot styles; dense styles {row['dense_pixels_apart']}"
              f" pixels apart (max {row['dense_max_diff']}); {ms_dp:.2f} ms a batch "
              f"({1000 * bs / ms_dp:.0f} images/s) against {ms_one:.2f} on one card "
              f"({1000 * bs / ms_one:.0f} images/s), both with the copy to the host", flush=True)
        results.append(row)
        del single, dp
        torch.cuda.empty_cache()
    return results


def breakdown(torch, dp, imgs, styles) -> dict:
    """Where a data-parallel call's time goes: the host's time to enqueue every
    shard, to wait for each and copy it to the host, to concatenate; each shard
    alone on its card, its inputs already there (CUDA events on that card); the
    host ops of one call."""
    from torch.profiler import ProfilerActivity, profile

    k = len(dp.replicas)
    parts = list(zip(torch.tensor_split(imgs, k), torch.tensor_split(styles.cuda(), k)))
    enq, to_host, cat = [], [], []
    for _ in range(13):
        t0 = time.perf_counter()
        outs = []
        for r, (x, s) in zip(dp.replicas, parts):
            with torch.cuda.device(r.device):
                outs.append(dp._generate(r.generator, r.q, x.to(r.device), s.to(r.device)))
        t1 = time.perf_counter()
        host = [o.cpu() for o in outs]
        t2 = time.perf_counter()
        torch.cat(host)
        t3 = time.perf_counter()
        enq.append(1e3 * (t1 - t0))
        to_host.append(1e3 * (t2 - t1))
        cat.append(1e3 * (t3 - t2))
    alone = []
    for r, (x, s) in zip(dp.replicas, parts):
        xr, sr = x.to(r.device), s.to(r.device)
        with torch.cuda.device(r.device):
            alone.append(round(median_ms(torch, lambda: dp._generate(r.generator, r.q, xr, sr)),
                               3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dp.generate(imgs, styles)
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:6]
    return {"enqueue_ms": round(float(np.median(enq[3:])), 3),
            "to_host_ms": round(float(np.median(to_host[3:])), 3),
            "cat_ms": round(float(np.median(cat[3:])), 3), "shard_alone_ms": alone,
            "top_host_ops": [(e.key, round(e.self_cpu_time_total / 1e3, 3), e.count)
                             for e in top]}


def write_tree(work: str) -> tuple:
    from PIL import Image

    rng = np.random.default_rng(5)
    inp, src, ref = (os.path.join(work, n) for n in ("in", "src", "ref"))
    for d in (inp, src):
        os.makedirs(d)
    for i in range(20):
        Image.fromarray(rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)).save(
            os.path.join(inp, f"leaf{i:02d}.png"))
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (300, 280, 3), dtype=np.uint8)).save(
            os.path.join(src, f"s{i}.png"))
    for d in range(9):
        os.makedirs(os.path.join(ref, f"dom{d}"))
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (280, 300, 3), dtype=np.uint8)).save(
                os.path.join(ref, f"dom{d}", f"r{i}.png"))
    return inp, src, ref


def run(cmd, env=None) -> tuple:
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900,
                       env=dict(os.environ, **(env or {})))
    return r, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--out_dir", type=str, default=None)
    args = ap.parse_args(argv)
    import torch

    if torch.cuda.device_count() < 2:
        print("data_parallel_torch: needs at least two CUDA devices", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from msig_tpu_torch.ops import _build, adain_pallas, conv3x3_vjp, fused_conv_int8, \
        fused_conv_int8_v2, fused_dec_int8, fused_enc_int8, fused_trunk_v3, int8_epilogue, \
        int8_epilogue_chunked

    # every kernel source at once (one nvcc each), not one by one at first use
    t0 = time.perf_counter()
    _build.build(dict.fromkeys(
        fused_enc_int8.SOURCES + fused_conv_int8_v2.SOURCES + fused_dec_int8.SOURCES
        + fused_trunk_v3.SOURCES + int8_epilogue_chunked.SOURCES + fused_conv_int8.SOURCES
        + int8_epilogue.SOURCES + (adain_pallas.SOURCE,) + conv3x3_vjp.SOURCES))
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    card = card_line()
    n = torch.cuda.device_count()
    print(f"[card] {card} x {n}; torch {torch.__version__}", flush=True)
    result = {"cards": n, "card": card, "serving": serving(torch, args.batches)}
    work = tempfile.mkdtemp(prefix="dp_", dir=os.path.join(ROOT, "build"))
    inp, src, ref = write_tree(work)

    r, s = run([sys.executable, "-m", "msig_tpu_torch.inference", "--input_dir", inp,
                "--ref_domains_dir", ref, "--checkpoint_dir", DEMO, "--output_dir",
                os.path.join(work, "served"), "--target_domain", "dom3", "--style_mode",
                "average", "--quantize", "int8", "--batch_size", "8", "--data_parallel"])
    served = len(os.listdir(os.path.join(work, "served"))) if r.returncode == 0 else 0
    check(r.returncode == 0 and served == 20,
          f"inference --data_parallel: exit {r.returncode}, {served} images\n{r.stderr[-3000:]}")
    print(f"[inference cli] --data_parallel --quantize int8, batch 8, 20 inputs: exit 0, "
          f"20 images in {s:.1f} s", flush=True)
    result["inference_cli_s"] = s

    history = {}
    for label, extra in (("data_parallel", []), ("one_process", ["--no_data_parallel"])):
        out = os.path.join(work, f"train_{label}")
        r, s = run([sys.executable, "-m", "msig_tpu_torch.train", "--source_dir", src,
                    "--target_dir", ref, "--save_dir_base", out, "--exp_name", "dp",
                    "--device", "cuda", "--allow_random_vgg", "--epochs", "1", *extra],
                   env={"MSIG_SKIP_EPOCH_ART": "1"})
        ckpt = os.path.join(out, "dp", "checkpoints", "epoch_1", "checkpoint.pth")
        check(r.returncode == 0 and os.path.exists(ckpt),
              f"train {label}: exit {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
        taken = [ln for ln in r.stdout.splitlines() if ln.startswith("Data parallel")]
        history[label] = torch.load(ckpt, map_location="cpu", weights_only=False)["loss_history"]
        print(f"[train cli] {label}: exit 0 in {s:.1f} s; {taken}", flush=True)
        result[f"train_{label}_s"] = s
        result[f"train_{label}_taken"] = taken
    check(result["train_data_parallel_taken"] == [f"Data parallel: {n} device(s)"],
          f"the train CLI took {result['train_data_parallel_taken']}")
    worst = {}
    for k, v in history["one_process"].items():
        a, b = np.asarray(history["data_parallel"][k]), np.asarray(v)
        worst[k] = float(np.max(np.abs(a - b) / (1e-4 + 2e-3 * np.abs(b))))
    check(max(worst.values()) <= 1.0, f"loss histories within rtol 2e-3 / atol 1e-4: {worst}")
    print(f"[train cli] epoch-1 loss averages, {n} NCCL workers against one process: worst "
          f"{max(worst.values()):.3f} of the bars (rtol 2e-3, atol 1e-4); {card}", flush=True)
    result["loss_history_worst_share_of_bar"] = worst
    line = json.dumps(result)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "data_parallel.json"), "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
