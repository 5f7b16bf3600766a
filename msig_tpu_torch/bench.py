"""Benchmark entry point of the port: ``python -m msig_tpu_torch.bench``.

A port of the root ``bench.py``: the same modes and flags, plus ``--device``
(``cuda`` by default; ``cpu`` runs the kernels' plain versions, for tests).
Every mode prints ONE JSON line ``{"metric", "value", "unit", "vs_baseline"}``
on stdout, with the JAX bench's metric names and units; human-readable detail
goes to stderr.

    python -m msig_tpu_torch.bench                  # img_per_s_256px_ref_guided_inference
    python -m msig_tpu_torch.bench --mode latency   # latency_ms_per_img_256px_int8_b1
    python -m msig_tpu_torch.bench --mode train     # train_step_ms_b32_256 (bf16 step)
    python -m msig_tpu_torch.bench --mode data      # input_pipeline_img_per_s_256
    python -m msig_tpu_torch.bench --mode e2e       # e2e_img_per_s_256_incl_decode

``vs_baseline`` is null in every mode: the JAX bench's 2,000 img/s baseline is
a target set for a TPU, and the port states no TPU number.

Modes:
  - ``inference`` (the headline): reference-guided generator throughput on
    the device, images/s, swept over the int8 serving chain
    (``quantized_generator_apply(..., out_dtype=torch.uint8)``, the config
    swept first) and the float generator in bf16 (``MSIG_BENCH_PALLAS=1``
    routes its AdaINs to the fused kernel), at batches 128 and 256 at 256²
    and 16 and 32 at 512² unless ``--batches`` says otherwise. Styles are
    sampled ``"random"`` from a 10 x 256 bank inside the timed loop with an
    explicit ``torch.Generator``; the weights come from ``torch.Generator(0)``
    (torch's default init; style_dim 256, 8 resblocks, 10 domains); the input
    batch is seeded uint8 noise on the device. The headline is the best
    config's rate.
  - ``latency``: the int8 chain alone at small batches (1, 4, 16 unless
    ``--batches``), 100 iterations unless ``--iters``; the headline is ms per
    image at the smallest batch, ``ms_per_batch`` the curve.
  - ``train``: the fused train step in bf16 (``compute_dtype=bfloat16``) at
    ``--train_batch`` (32) and ``--image_size`` (256), 10 domains, a seeded
    random VGG, cuDNN held to its deterministic algorithms and TF32 off, as
    the Trainer runs it; ms per step. ``MSIG_CONV_VJP`` routes the trunk as in
    training.
  - ``data``: the host pipeline's ``TrainLoader`` on ``backend="auto"`` (the
    native loader where it builds, else PIL; stderr says which) over 40
    synthetic 512² JPEGs, 256 decodes at batch 16 and four threads; images/s
    of this host, at ``--image_size``.
  - ``e2e``: JPEG files -> ``InferenceEngine.iter_input_batches`` ->
    ``translate_batches`` (the int8 engine, uint8 out) -> host arrays, images/s,
    at ``--image_size``: four batches of the first ``--batches`` size (128, so
    512 images, by default), timed on a second pass after a warm one. The
    inputs are synthetic 256² JPEGs: the reference data set the JAX bench
    copies when present is not on the card's machine.

Timing: wall clock over ``--iters`` batches or steps, bracketed by
``torch.cuda.synchronize()``, so that the host's dispatch is inside the
figure, as the JAX bench's scalar fetch puts it; beside it on stderr the
same span by CUDA events, per batch.

Supervisor (``inference`` and ``latency``): as the JAX bench, the measuring
runs in a worker subprocess that prints one JSON line per (mode, batch)
config; the supervisor first probes the device in a subprocess
(``import torch``, and for ``cuda`` ``torch.cuda.device_count() > 0``; one
retry), then enforces a per-config and a total deadline, kills a stalled
worker and reports the best so far (exit 0), also on SIGTERM; with nothing
measured it prints a diagnostic and exits 1 ("backend unreachable" when the
probe fails), never a traceback. Settings: ``MSIG_BENCH_PROBE_TIMEOUT``,
``MSIG_BENCH_DEADLINE``, ``MSIG_BENCH_CONFIG_DEADLINE``,
``MSIG_BENCH_NEXT_DEADLINE`` (seconds), ``MSIG_BENCH_FAKE_STALL``
(``init`` or ``after_first``: the worker sleeps, to test the deadlines) and
``MSIG_BENCH_PALLAS``.

Not ported: the JAX bench's ``BATCH_FORWARDS``, ``VGG_PAIR`` and
``GRAM_BF16`` settings. They choose the shape of the XLA program of the JAX
step; the port's step runs eagerly, shares the forwards' launches by batch
(at most 16) as the JAX step's default does, and runs the Grams in fp32.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE_TIMEOUT = float(os.environ.get("MSIG_BENCH_PROBE_TIMEOUT", "120"))
TOTAL_DEADLINE = float(os.environ.get("MSIG_BENCH_DEADLINE", "1500"))
FIRST_CONFIG_DEADLINE = float(os.environ.get("MSIG_BENCH_CONFIG_DEADLINE", "900"))
NEXT_CONFIG_DEADLINE = float(os.environ.get("MSIG_BENCH_NEXT_DEADLINE", "600"))

STYLE_DIM, N_RES, N_DOMAINS = 256, 8, 10


class Timer:
    """Wall clock between two device syncs, and the same span by CUDA events."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.cuda = dev.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)
            self.start = self.torch.cuda.Event(enable_timing=True)
            self.end = self.torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            self.torch.cuda.synchronize(self.dev)
        self.seconds = time.perf_counter() - self.t0
        self.event_ms = self.start.elapsed_time(self.end) if self.cuda else None

    def detail(self, n: int) -> str:
        ev = f"{self.event_ms / n:.3f} ms" if self.event_ms is not None else "n/a (cpu)"
        return f"{1000 * self.seconds / n:.3f} ms wall, CUDA events {ev}"


def _seeded_generator(torch):
    from msig_tpu_torch.models import StyleCycleGANGenerator
    from msig_tpu_torch.train.state import torch_default_init_

    gen = StyleCycleGANGenerator(style_dim=STYLE_DIM, n_residual_blocks=N_RES,
                                 use_pallas=os.environ.get("MSIG_BENCH_PALLAS") == "1")
    torch_default_init_(gen, torch.Generator().manual_seed(0))
    return gen


def inference_configs(batch_sizes):
    """(mode, batch) sweep order: the int8 serving chain first."""
    return [(mode, bs) for mode in ("int8", "bf16") for bs in batch_sizes]


def run_inference_worker(batch_sizes, iters=20, warmup=3, image_size=256,
                         modes=("int8", "bf16"), device="cuda"):
    """Measure each (mode, batch) config; print one JSON line per result."""
    fake_stall = os.environ.get("MSIG_BENCH_FAKE_STALL", "")
    if fake_stall == "init":
        time.sleep(10_000)

    import torch

    from msig_tpu_torch import resolve_device
    from msig_tpu_torch.infer.quantized import (quantize_generator_params,
                                                quantized_generator_apply)
    from msig_tpu_torch.infer.styles import sample_styles
    from msig_tpu_torch.train.step import prepare_images

    dev = resolve_device(device)
    gen = _seeded_generator(torch)
    q = {k: v.to(dev) for k, v in quantize_generator_params(gen.state_dict(), N_RES).items()}
    gen = gen.to(device=dev, dtype=torch.bfloat16).eval().requires_grad_(False)
    bank = torch.randn((N_DOMAINS, STYLE_DIM), generator=torch.Generator().manual_seed(1)).to(dev)

    n_ok = 0
    for mode, bs in [(m, b) for m, b in inference_configs(batch_sizes) if m in modes]:
        if mode == "bf16":
            def step(imgs_u8, sampler, bs=bs):
                styles = sample_styles(bank, "random", sampler, bs)
                return gen(prepare_images(imgs_u8, torch.bfloat16), styles.to(torch.bfloat16))
        else:
            def step(imgs_u8, sampler, bs=bs):
                styles = sample_styles(bank, "random", sampler, bs)
                # uint8 output = the served image; engages the final conv7 + tanh
                # + uint8 kernel of the decoder (ops/fused_dec_int8.py)
                return quantized_generator_apply(q, imgs_u8, styles, n_res=N_RES,
                                                 out_dtype=torch.uint8)
        rng = np.random.default_rng(0)
        imgs = torch.from_numpy(
            rng.integers(0, 256, (bs, image_size, image_size, 3), dtype=np.uint8)).to(dev)
        sampler = torch.Generator(device=dev).manual_seed(2)
        try:
            with torch.inference_mode():
                for _ in range(warmup):
                    out = step(imgs, sampler)
                with Timer(torch, dev) as t:
                    for _ in range(iters):
                        out = step(imgs, sampler)
            del out
        except Exception as e:  # one config failing must not end the sweep
            print(f"  {mode} batch {bs}: FAILED ({type(e).__name__}: {str(e)[:300]})",
                  file=sys.stderr)
            # a failed config emits a line too: the supervisor's per-config
            # timer counts attempts, and "all failed" is not "stalled"
            print(json.dumps({"config": f"{mode}@{bs}", "failed": True}), flush=True)
            continue
        finally:
            del imgs
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        rate = bs * iters / t.seconds
        print(f"  {mode} batch {bs}: {rate:.1f} img/s ({t.detail(iters)} per batch)",
              file=sys.stderr)
        print(json.dumps({"config": f"{mode}@{bs}", "rate": rate}), flush=True)
        n_ok += 1
        if fake_stall == "after_first" and n_ok == 1:
            time.sleep(10_000)
    print(json.dumps({"done": True}), flush=True)


def _probe_backend(device: str) -> bool:
    """Pre-flight in a subprocess (one retry): can a fresh process import torch
    and, for ``cuda``, see a card?"""
    code = ("import torch; "
            f"raise SystemExit(3 if {device == 'cuda'} and torch.cuda.device_count() == 0 else 0)")
    for attempt in (1, 2):
        try:
            r = subprocess.run([sys.executable, "-c", code], timeout=PROBE_TIMEOUT,
                               capture_output=True, text=True)
            if r.returncode == 0:
                return True
            why = ("no CUDA device (torch.cuda.device_count() == 0)" if r.returncode == 3
                   else r.stderr.strip()[-300:])
            print(f"bench: probe attempt {attempt} rc={r.returncode}: {why}", file=sys.stderr)
        except subprocess.TimeoutExpired:
            print(f"bench: probe attempt {attempt} timed out after {PROBE_TIMEOUT:.2f}s",
                  file=sys.stderr)
    return False


def _reader_thread(stream, q):
    for line in stream:
        q.put(line)
    q.put(None)


def _wait_or_kill(proc, timeout=30):
    """Reap the worker; SIGKILL it if its teardown hangs (every measurement is in hand)."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        print("bench: worker hung in teardown; killing it", file=sys.stderr)
        try:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=10)
        except (OSError, subprocess.TimeoutExpired):
            pass


def _emit_headline(best, best_cfg, measured, args, size_tag, rows=None):
    if args.mode == "latency":
        # headline: ms per image at the smallest measured batch (the reference's
        # interactive use is batch 1); every batch's ms per batch in ms_per_batch
        by_bs = {int(cfg.split("@")[1]): rate for cfg, rate in (rows or {}).items() if rate}
        if not by_bs:
            print("bench: latency mode measured nothing", file=sys.stderr)
            sys.exit(1)
        bs0 = min(by_bs)
        ms_batch = {b: round(1000.0 * b / r, 3) for b, r in sorted(by_bs.items())}
        print(f"  latency rows (ms/batch): {ms_batch}", file=sys.stderr)
        print(json.dumps({
            "metric": f"latency_ms_per_img_{size_tag}px_int8_b{bs0}",
            "value": round(1000.0 / by_bs[bs0], 3),
            "unit": "ms",
            "vs_baseline": None,
            "ms_per_batch": ms_batch,
        }), flush=True)
        return
    print(f"  best: {best_cfg} ({measured} configs measured)", file=sys.stderr)
    print(json.dumps({
        "metric": f"img_per_s_{size_tag}px_ref_guided_inference",
        "value": round(best, 1),
        "unit": "img/s/chip",
        "vs_baseline": None,
    }), flush=True)


def supervise_inference(args, size_tag):
    """Spawn the measuring worker; enforce deadlines; print the headline."""
    t_start = time.monotonic()
    state = {"best": 0.0, "cfg": "", "measured": 0, "proc": None, "rows": {}}

    def on_term(signum, frame):
        # an external timeout beat the deadlines: kill the worker, report best-so-far
        p = state["proc"]
        if p is not None:
            try:
                p.send_signal(signal.SIGKILL)
            except OSError:
                pass
        if state["measured"] > 0:
            print(f"bench: external signal {signum}; reporting best-so-far", file=sys.stderr)
            _emit_headline(state["best"], state["cfg"], state["measured"], args, size_tag,
                           rows=state["rows"])
            sys.exit(0)
        print(f"bench: external signal {signum} before any measurement", file=sys.stderr)
        sys.exit(1)

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)

    if not _probe_backend(args.device):
        print(f"bench: backend unreachable (pre-flight probe of --device {args.device} failed "
              "twice) — no measurement possible", file=sys.stderr)
        sys.exit(1)

    cmd = [sys.executable, "-u", "-m", "msig_tpu_torch.bench", "--worker", "--mode", args.mode,
           "--iters", str(args.iters), "--image_size", str(args.image_size),
           "--device", args.device]
    if args.batches:
        cmd += ["--batches", args.batches]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=sys.stderr, text=True,
                            bufsize=1, env=env)
    state["proc"] = proc
    q = queue.Queue()
    threading.Thread(target=_reader_thread, args=(proc.stdout, q), daemon=True).start()

    best, best_cfg, measured, attempted = 0.0, "", 0, 0
    worker_done, stalled_msg, eof_rc = False, None, None
    config_deadline = FIRST_CONFIG_DEADLINE
    while True:
        remaining_total = TOTAL_DEADLINE - (time.monotonic() - t_start)
        wait = min(config_deadline, remaining_total)
        if wait <= 0:
            stalled_msg = "total deadline" if remaining_total <= 0 else "per-config deadline"
            break
        try:
            line = q.get(timeout=wait)
        except queue.Empty:
            stalled_msg = f"no result within {wait:.0f}s (per-config deadline)"
            break
        if line is None:  # worker stdout closed
            _wait_or_kill(proc)
            if not worker_done:
                eof_rc = proc.returncode  # a crash, not a stall
            break
        try:
            rec = json.loads(line.strip() or "null")
        except json.JSONDecodeError:
            continue
        if not isinstance(rec, dict):
            continue
        if rec.get("done"):
            worker_done = True
            _wait_or_kill(proc)
            break
        attempted += 1
        config_deadline = NEXT_CONFIG_DEADLINE
        if rec.get("failed"):
            continue
        measured += 1
        if rec.get("rate", 0) > best:
            best, best_cfg = rec["rate"], rec.get("config", "")
        state["rows"][rec.get("config", "")] = rec.get("rate", 0)
        state.update(best=best, cfg=best_cfg, measured=measured)

    if stalled_msg:
        print(f"bench: worker stalled ({stalled_msg}); killing pid {proc.pid} and reporting "
              "best-so-far", file=sys.stderr)
        try:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            pass

    if measured == 0:
        if worker_done and attempted > 0:
            print("bench: every (mode, batch) config failed — no measurement (see FAILED lines "
                  "above; this is NOT a backend stall)", file=sys.stderr)
        elif eof_rc is not None:
            print(f"bench: worker exited rc={eof_rc} before any measurement (worker crash — see "
                  "stderr above; this is NOT a backend stall)", file=sys.stderr)
        else:
            print("bench: no config completed before the deadline — backend stalled "
                  "mid-measurement", file=sys.stderr)
        sys.exit(1)
    _emit_headline(best, best_cfg, measured, args, size_tag, rows=state["rows"])


def bench_train(torch, dev, batch=32, iters=10, warmup=2, image_size=256) -> float:
    """ms per bf16 train step (wall clock between syncs)."""
    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.losses import init_random_vgg
    from msig_tpu_torch.train import (create_train_state, current_loss_weights,
                                      make_train_step, weights_vector)

    torch.backends.cudnn.deterministic = True  # as the Trainer runs the step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig(image_size=image_size, batch_size=batch, compute_dtype="bfloat16",
                      device=dev.type)
    state = create_train_state(cfg, N_DOMAINS)
    vgg = init_random_vgg(1234, device=dev.type)
    step = make_train_step(cfg.ema_beta, torch.bfloat16, grad_clip_norm=cfg.grad_clip_norm,
                           adam_b1=cfg.adam_b1, adam_b2=cfg.adam_b2)
    rng = np.random.default_rng(0)
    shape = (batch, image_size, image_size, 3)
    data = {"source": torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev),
            "target": torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev),
            "source_domain": torch.zeros(batch, dtype=torch.int32, device=dev),
            "target_domain": torch.ones(batch, dtype=torch.int32, device=dev)}
    w = weights_vector(current_loss_weights(cfg.loss_weights, 0))
    for _ in range(warmup):
        step(state, data, vgg, 2e-4, 1e-4, w)
    with Timer(torch, dev) as t:
        for _ in range(iters):
            metrics = step(state, data, vgg, 2e-4, 1e-4, w)
    loss = float(metrics["G_loss"])
    print(f"  train step, batch {batch}, {image_size}², bf16: {t.detail(iters)} per step; "
          f"last G_loss {loss:.4f}", file=sys.stderr)
    if not np.isfinite(loss):
        raise RuntimeError(f"the bf16 train step's G_loss is {loss}")
    return 1000 * t.seconds / iters


def _write_jpegs(folder: str, n: int, side: int, rng) -> None:
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (side, side, 3), dtype=np.uint8)).save(
            os.path.join(folder, f"{i}.jpg"), quality=90)


def bench_data(n_images=256, image_size=256, threads=4) -> float:
    """Host input-pipeline images/s: decode + crop + rotate (source and target)."""
    from msig_tpu_torch.data import MultiDomainDataset, TrainLoader, native_loader

    tmp = tempfile.mkdtemp(prefix="msig_torch_bench_data_")
    try:
        rng = np.random.default_rng(0)
        _write_jpegs(f"{tmp}/src", 32, 512, rng)
        _write_jpegs(f"{tmp}/ref/D", 8, 512, rng)
        ds = MultiDomainDataset.build(f"{tmp}/src", f"{tmp}/ref")
        loader = TrainLoader(ds, batch_size=16, image_size=image_size, num_threads=threads,
                             backend="auto")
        next(iter(loader.epoch(0)))  # warm
        t0 = time.perf_counter()
        count, epoch = 0, 1
        while count < n_images:
            for b in loader.epoch(epoch):
                count += 2 * b["source"].shape[0]  # source + target decodes
                if count >= n_images:
                    break
            epoch += 1
        dt = time.perf_counter() - t0
        print(f"  native_loader={'yes' if native_loader.available() else 'no (PIL)'}; "
              f"{count} decodes in {dt:.3f} s, {threads} threads", file=sys.stderr)
        return count / dt
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_e2e(torch, dev, batch=128, image_size=256):
    """JPEG files -> the int8 engine -> host arrays: (images/s, images)."""
    from msig_tpu_torch.config import InferenceConfig
    from msig_tpu_torch.infer.engine import InferenceEngine
    from msig_tpu_torch.models import MultiDomainStyleEncoder
    from msig_tpu_torch.train.state import torch_default_init_

    tmp = tempfile.mkdtemp(prefix="msig_torch_bench_e2e_")
    try:
        _write_jpegs(tmp, 4 * batch, 256, np.random.default_rng(0))
        gen = _seeded_generator(torch)
        se = MultiDomainStyleEncoder(style_dim=STYLE_DIM, num_domains=N_DOMAINS)
        torch_default_init_(se, torch.Generator().manual_seed(1))
        cfg = InferenceConfig(image_size=image_size, batch_size=batch, quantize="int8",
                              n_residual_blocks=N_RES, device=dev.type)
        eng = InferenceEngine.build(cfg, N_DOMAINS, gen.state_dict(), se.state_dict())
        eng.out_uint8 = True
        bank = torch.from_numpy(
            np.random.default_rng(0).normal(0, 1, (N_DOMAINS, STYLE_DIM)).astype(np.float32)).to(dev)

        def run_once() -> int:
            count, touch = 0, 0
            for out, names in eng.translate_batches(eng.iter_input_batches(tmp), bank, "random",
                                                    seed=0):
                count += len(names)
                touch += int(out[0, 0, 0, 0])  # the images are on the host
            return count

        run_once()  # warm-up: kernels loaded, page cache warm
        t0 = time.perf_counter()
        count = run_once()
        dt = time.perf_counter() - t0
        print(f"  e2e: {count} images in {dt:.3f} s, batch {batch}, {image_size}²",
              file=sys.stderr)
        return count / dt, count
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Benchmark of msig_tpu_torch: one JSON line.")
    ap.add_argument("--mode", choices=["inference", "latency", "train", "data", "e2e"],
                    default="inference")
    ap.add_argument("--iters", type=int, default=40,
                    help="timed iterations (inference, latency and train modes; data and e2e "
                         "measure a fixed workload)")
    ap.add_argument("--image_size", type=int, default=256,
                    help="map size (512: smaller batches are the default)")
    ap.add_argument("--train_batch", type=int, default=32)
    ap.add_argument("--batches", type=str, default="",
                    help="comma list of inference batch sizes to sweep (default: 128,256 at "
                         "<=256², 16,32 at 512²); e2e takes the first as its batch (default 128)")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) or cpu; a missing card is an error")
    ap.add_argument("--worker", action="store_true",
                    help="internal: run the measuring worker in this process (no supervisor)")
    return ap


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    size_tag = str(args.image_size)
    batches = tuple(int(b) for b in args.batches.split(",")) if args.batches else ()

    if args.mode in ("inference", "latency") and not args.worker:
        # deadlines and best-so-far live outside the process that drives the device
        supervise_inference(args, size_tag)
        return 0

    import torch

    from msig_tpu_torch import resolve_device

    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1

    if args.mode == "e2e":
        rate, _ = bench_e2e(torch, dev, batch=batches[0] if batches else 128,
                            image_size=args.image_size)
        metric, value, unit = f"e2e_img_per_s_{size_tag}_incl_decode", round(rate, 1), "img/s"
    elif args.mode == "data":
        rate = bench_data(image_size=args.image_size)
        metric, value, unit = f"input_pipeline_img_per_s_{size_tag}", round(rate, 1), "img/s/host"
    elif args.mode == "train":
        ms = bench_train(torch, dev, batch=args.train_batch, iters=args.iters,
                         image_size=args.image_size)
        metric, value, unit = f"train_step_ms_b{args.train_batch}_{size_tag}", round(ms, 2), "ms"
    elif args.mode == "latency":  # the worker of the latency mode: the int8 chain only
        run_inference_worker(batches or (1, 4, 16), iters=args.iters if args.iters != 40 else 100,
                             image_size=args.image_size, modes=("int8",), device=args.device)
        return 0
    else:
        run_inference_worker(batches or ((128, 256) if args.image_size <= 256 else (16, 32)),
                             iters=args.iters, image_size=args.image_size, device=args.device)
        return 0
    print(json.dumps({"metric": metric, "value": value, "unit": unit, "vs_baseline": None}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
