#!/usr/bin/env python3
"""Which ops make the port's train step differ from run to run on the card, and
what a step costs.

    python3 tools/train_step_determinism_torch.py [--parts ops bits time pad]
        [--cases stock level1+pallas ... level1+pallas/512] [--steps 10]
        [--deterministic_algorithms] [--out report.json]
        [--device cpu --image_size 32 --n_res 2]   # a dry run of the code paths

The cases: the three configurations of ``chip_smoke.py`` (``stock``:
``MSIG_CONV_VJP=0``; ``level1+pallas``: ``=1`` with ``use_pallas``;
``level2``: ``=2``), each in fp32 (TF32 off) and in ``compute_dtype=bfloat16``
(``.../bf16``), at 256², batch 4, 8 resblocks, style_dim 256, 10 domains, a
seeded random VGG; and ``level1+pallas/512`` (fp32, 512², batch 4). cuDNN is
held to its deterministic algorithms, as the Trainer holds it.

1. ``ops``: in a child process whose environment sets
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before CUDA starts, step 1 of each case
   under ``torch.use_deterministic_algorithms(True)``: the op at which PyTorch
   raises (no deterministic form), with the port's file and line of the
   forward call that made it (autograd's anomaly mode keeps that trace); then
   step 1 again with ``warn_only=True``, every such op it warns of, each with
   the port's call sites of the backward nodes of its name found in the step's
   graphs (the G and D losses' ``grad_fn`` graphs, walked before their
   backward).
2. ``bits``: step 1 twice from one state and batch; every parameter, every
   gradient that clip + Adam receive, both Adam moments and the EMA copies
   compared to the bit (``msig_tpu_torch/train/reproduce.py``); with hooks on
   every module of the six networks and the VGG, the outputs of the forward in
   call order and the gradients of each module's inputs and outputs in the
   backward's order, and the first of each that differs: a module whose
   output gradient was equal and whose input gradient differs is the source.
   ``--deterministic_algorithms`` runs it under
   ``torch.use_deterministic_algorithms(True)``, where ops that have a
   deterministic alternative take it.
3. ``time``: ms per step of each case as the Trainer runs it (median of
   ``--steps`` after step 1 and a warm-up step, CUDA events). Copied into
   another checkout (with ``msig_tpu_torch/train/reproduce.py`` for ``bits``),
   it measures that tree's port.
4. ``pad`` (not by default): the backward of ``reflect_pad2d`` against
   ``F.pad(mode="reflect")``'s at the 7x7 convs' inputs, CUDA events.

Needs a card unless ``--device cpu``; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"stock": ("0", False), "level1+pallas": ("1", True), "level2": ("2", False)}
CASES = ("stock", "level1+pallas", "level2", "stock/bf16", "level1+pallas/bf16", "level2/bf16",
         "level1+pallas/512")
PORT = os.sep + "msig_tpu_torch" + os.sep


def case_config(name: str, args):
    """(TrainConfig, MSIG_CONV_VJP, compute dtype) of a case."""
    import torch

    from msig_tpu_torch.config import TrainConfig

    label, _, tag = name.partition("/")
    level, pallas = CONFIGS[label]
    size = args.image_size or (512 if tag == "512" else 256)
    cfg = TrainConfig(image_size=size, batch_size=4, n_residual_blocks=args.n_res, style_dim=256,
                      use_pallas=pallas, device=args.device)
    return cfg, level, torch.bfloat16 if tag == "bf16" else torch.float32


def inputs(torch, size: int, dev):
    """``chip_smoke.py``'s seeded batch, random VGG and loss weights."""
    import numpy as np

    from msig_tpu_torch.losses import init_random_vgg

    rng = np.random.default_rng(4)
    shape = (4, size, size, 3)
    batch = {"source": torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev),
             "target": torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev),
             "source_domain": torch.zeros(4, dtype=torch.int32, device=dev),
             "target_domain": torch.from_numpy(rng.integers(1, 10, 4, dtype=np.int32)).to(dev)}
    return batch, init_random_vgg(1234, device=dev), [1.0, 10.0, 5.0, 1.0, 1.0]


class Case:
    """A case's config, inputs and a fresh seeded state and step on demand."""

    def __init__(self, name: str, args):
        import torch

        self.name = name
        self.cfg, self.level, self.dtype = case_config(name, args)
        self.dev = torch.device(args.device)
        self.batch, self.vgg, self.weights = inputs(torch, self.cfg.image_size, self.dev)

    def fresh(self):
        from msig_tpu_torch.train import create_train_state, make_train_step

        os.environ["MSIG_CONV_VJP"] = self.level
        return create_train_state(self.cfg, 10), make_train_step(self.cfg.ema_beta, self.dtype)

    def run(self, state, step):
        import torch

        os.environ["MSIG_CONV_VJP"] = self.level
        m = step(state, self.batch, self.vgg, self.cfg.lr_g, self.cfg.lr_d, self.weights)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        return m


def port_site(frames) -> str:
    """The innermost frame of the port in a formatted stack, as ``file:line``."""
    for frame in reversed(frames):
        m = re.search(r'File "([^"]+)", line (\d+)', frame)
        if m and PORT in m.group(1):
            return f"{os.path.relpath(m.group(1), ROOT)}:{m.group(2)}"
    return "not in the port"


def _norm(name: str) -> str:
    """An op or node name reduced for matching: lower case, no underscores, no
    ``out``/``cuda`` suffixes, no trailing digits."""
    name = re.sub(r"(_out|_cuda|_cpu)+$", "", name.lower())
    return re.sub(r"\d+$", "", name.replace("_", ""))


def graph_sites(torch, roots) -> dict:
    """{backward node name: sorted port call sites} over the graphs of ``roots``
    (the forward's trace needs anomaly mode)."""
    seen, stack, sites = set(), [r.grad_fn for r in roots if r.grad_fn is not None], {}
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        sites.setdefault(fn.name(), set()).add(port_site(fn.metadata.get("traceback_", [])))
        stack.extend(f for f, _ in fn.next_functions)
    return {k: sorted(v) for k, v in sites.items()}


def ops_child(args) -> int:
    """The ``ops`` part in this process (the parent set ``CUBLAS_WORKSPACE_CONFIG``)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    real_grad = torch.autograd.grad
    for name in args.cases:
        case = Case(name, args)
        row = {"case": name}
        # strict: the first op without a deterministic form raises
        state, step = case.fresh()
        torch.use_deterministic_algorithms(True)
        with warnings.catch_warnings(record=True) as caught, \
                torch.autograd.detect_anomaly(check_nan=False):
            warnings.simplefilter("always")
            try:
                case.run(state, step)
                row["raises"] = None
            except RuntimeError as e:
                msg = str(e).splitlines()[0]
                trace = next((str(w.message) for w in caught
                              if "Traceback of forward call" in str(w.message)), "")
                node = re.search(r"Error detected in (\w+)", trace)
                frames = (trace.splitlines(keepends=True) if node else   # a backward op
                          traceback.format_tb(e.__traceback__))          # a forward op
                row["raises"] = {"message": msg[:300], "node": node and node.group(1),
                                 "site": port_site(frames)}
        del state, step
        # warn_only: every such op, and the graph's nodes of its name
        state, step = case.fresh()
        graphs = {}

        def walking_grad(outputs, inputs_, *a, **k):
            outs = [outputs] if isinstance(outputs, torch.Tensor) else list(outputs)
            for node, where in graph_sites(torch, outs).items():
                graphs.setdefault(node, set()).update(where)
            return real_grad(outputs, inputs_, *a, **k)

        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.autograd.grad = walking_grad
        try:
            with warnings.catch_warnings(record=True) as caught, \
                    torch.autograd.detect_anomaly(check_nan=False):
                warnings.simplefilter("always")
                case.run(state, step)
        finally:
            torch.autograd.grad = real_grad
            torch.use_deterministic_algorithms(False)
        alerts = {}
        for w in caught:
            text = str(w.message)
            if "does not have a deterministic implementation" in text:
                op = text.split(" does not have")[0].strip()
                where = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                alerts.setdefault(op, set()).add(where if PORT in w.filename else "backward")
        row["ops"] = [{"op": op, "warned_at": sorted(at),
                       "nodes": {n: sorted(s) for n, s in graphs.items()
                                 if _norm(n) and (_norm(n) in _norm(op) or _norm(op) in _norm(n))}}
                      for op, at in sorted(alerts.items())]
        row["graph_nodes"] = len(graphs)
        row["graph"] = {n: sorted(w) for n, w in sorted(graphs.items())}
        print("OPS " + json.dumps(row), flush=True)
        del state, step
        if case.dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


def fingerprint(torch, obj):
    """Sum of the bit patterns of every floating tensor in ``obj`` (an int64 on its device)."""
    if isinstance(obj, torch.Tensor):
        if not obj.is_floating_point():
            return obj.detach().to(torch.int64).sum()
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[obj.element_size()]
        return obj.detach().contiguous().view(bits).to(torch.int64).sum()
    if isinstance(obj, (tuple, list)):
        parts = [p for p in (fingerprint(torch, o) for o in obj) if p is not None]
        return torch.stack(parts).sum() if parts else None
    return None


def traced_step1(torch, case):
    """Step 1 from a fresh state with every module hooked. Returns (snapshot,
    forward [(module, output fp)], backward [(module input|output, gradient fp)])."""
    from msig_tpu_torch.train import reproduce

    state, step = case.fresh()
    fwd, bwd, handles = [], [], []

    def grad_hooks(tensors, label):
        for t in tensors if isinstance(tensors, (tuple, list)) else (tensors,):
            if isinstance(t, torch.Tensor) and t.requires_grad:
                t.register_hook(lambda g, n=label: bwd.append((n, fingerprint(torch, g))))

    def after(label):
        def hook(mod, args, out):
            fwd.append((label, fingerprint(torch, out)))
            grad_hooks(out, label + " output")
        return hook

    mods = [(f"{k}.", net) for k, net in state.models.nets.items()] + [("vgg.", case.vgg)]
    for prefix, net in mods:
        for name, mod in net.named_modules():
            label = f"{prefix}{name or '(root)'} ({type(mod).__name__})"
            handles.append(mod.register_forward_pre_hook(
                lambda m, i, n=label: grad_hooks(i, n + " input")))
            handles.append(mod.register_forward_hook(after(label)))
    try:
        with reproduce.record_grads() as grads:
            case.run(state, step)
        snap = reproduce.snapshot(state, grads)
    finally:
        for h in handles:
            h.remove()
    del state, step
    return (snap, [(n, None if f is None else int(f)) for n, f in fwd],
            [(n, int(f)) for n, f in bwd])


def first_apart(a, b) -> dict:
    """Where two (name, fingerprint) sequences first part."""
    if [n for n, _ in a] != [n for n, _ in b]:
        return {"order": "the two runs record different sequences"}
    apart = [k for k, (x, y) in enumerate(zip(a, b)) if x[1] != y[1]]
    return {"entries": len(a), "apart": len(apart),
            "first": None if not apart else f"{a[apart[0]][0]}, entry {apart[0]}"}


def bits_part(torch, args, report) -> bool:
    from msig_tpu_torch.train import reproduce

    torch.use_deterministic_algorithms(args.deterministic_algorithms)
    clean = True
    for name in args.cases:
        case = Case(name, args)
        (sa, fa, ba), (sb, fb, bb) = traced_step1(torch, case), traced_step1(torch, case)
        compared, differ = reproduce.differences(sa, sb)
        del sa, sb
        row = {"compared": compared, "differ": {k: len(v) for k, v in differ.items()},
               "first_differing": {k: v[0] for k, v in differ.items() if v},
               "forward": first_apart(fa, fb), "backward": first_apart(ba, bb)}
        # the source: the first module whose input gradient differs while its output's did not
        out_equal = {n[:-len(" output")] for (n, x), (_, y) in zip(ba, bb)
                     if n.endswith(" output") and x == y}
        row["source"] = next((n for (n, x), (_, y) in zip(ba, bb) if x != y and n.endswith(" input")
                              and n[:-len(" input")] in out_equal), None)
        report["bits"][name] = row
        same = not any(differ.values())
        clean &= same
        print(f"[bits {name}] step 1 twice from one state and batch: {compared} tensors compared "
              f"(parameters, gradients, both Adam moments, EMA), "
              + ("all equal to the bit" if same else
                 f"differing {row['differ']}, first {row['first_differing']}")
              + f"; forward module outputs {row['forward']}; backward gradients "
              f"{row['backward']}; source {row['source']}", flush=True)
        if case.dev.type == "cuda":
            torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    return clean


def time_part(torch, args, report) -> None:
    import numpy as np

    for name in args.cases:
        case = Case(name, args)
        state, step = case.fresh()
        case.run(state, step)  # step 1
        case.run(state, step)  # warm-up
        times = []
        for _ in range(args.steps):
            if case.dev.type == "cuda":
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                case.run(state, step)
                e.record()
                torch.cuda.synchronize()
                times.append(s.elapsed_time(e))
            else:
                import time

                t0 = time.perf_counter()
                case.run(state, step)
                times.append(1e3 * (time.perf_counter() - t0))
        ms = float(np.median(times))
        report["step_ms"][name] = ms
        print(f"[time {name}] {ms:.2f} ms per step (median of {args.steps} after step 1 and a "
              f"warm-up step; {'CUDA events' if case.dev.type == 'cuda' else 'host clock'}; "
              f"range {min(times):.2f}-{max(times):.2f})", flush=True)
        del state, step
        if case.dev.type == "cuda":
            torch.cuda.empty_cache()


def pad_part(torch, args, report) -> None:
    """``reflect_pad2d``'s backward against ``F.pad(mode="reflect")``'s at the
    generator's two 7x7 convs' inputs (a 256² step's 2B and B launches)."""
    import torch.nn.functional as F

    from msig_tpu_torch.models.layers import reflect_pad2d

    def ms(fn, reps=20):
        fn()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    for b, c, dtype in ((8, 3, torch.float32), (8, 64, torch.float32), (4, 64, torch.float32),
                        (8, 64, torch.bfloat16)):
        x = torch.randn(b, 256, 256, c, device="cuda", dtype=dtype).permute(0, 3, 1, 2)
        x.requires_grad_(True)
        g = torch.randn(b, c, 262, 262, device="cuda", dtype=dtype)
        y_pad = F.pad(x, (3, 3, 3, 3), mode="reflect")
        y_fold = reflect_pad2d(x, 3, 3)
        t = {"F.pad": ms(lambda: torch.autograd.grad(y_pad, x, g, retain_graph=True)),
             "reflect_pad2d": ms(lambda: torch.autograd.grad(y_fold, x, g, retain_graph=True))}
        key = f"[{b}, {c}, 256, 256] {str(dtype)[6:]}"
        report["pad_backward_ms"][key] = t
        print(f"[pad {key}] backward ms per call (CUDA events, mean of 20 after one): "
              f"F.pad(mode='reflect') {t['F.pad']:.4f}, reflect_pad2d {t['reflect_pad2d']:.4f}",
              flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parts", nargs="+", choices=("ops", "bits", "time", "pad"),
                   default=["ops", "bits", "time"])
    p.add_argument("--deterministic_algorithms", action="store_true",
                   help="run the bits part under torch.use_deterministic_algorithms(True)")
    p.add_argument("--cases", nargs="+", choices=CASES, default=list(CASES))
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--image_size", type=int, default=0, help="every case at this size (dry runs)")
    p.add_argument("--n_res", type=int, default=8)
    p.add_argument("--out", default=None, help="also write the report as JSON here")
    p.add_argument("--ops_child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    if args.ops_child:
        return ops_child(args)
    if args.deterministic_algorithms:  # cuBLAS reads it when CUDA starts
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("train_step_determinism_torch: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # as the Trainer runs the step
    card = "cpu"
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}; the port at {ROOT}", flush=True)
    report = {"card": card, "ops": {}, "bits": {}, "step_ms": {}, "pad_backward_ms": {}}
    ok = True
    if "ops" in args.parts:
        argv = [sys.executable, os.path.abspath(__file__), "--ops_child", "--cases", *args.cases,
                "--device", args.device, "--n_res", str(args.n_res),
                "--image_size", str(args.image_size)]
        run = subprocess.run(argv, capture_output=True, text=True,
                             env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
        for line in run.stdout.splitlines():
            if line.startswith("OPS "):
                row = json.loads(line[4:])
                report["ops"][row.pop("case")] = row
        if run.returncode != 0 or len(report["ops"]) != len(args.cases):
            print(f"[ops] the child exited {run.returncode}\n{run.stdout[-3000:]}\n"
                  f"{run.stderr[-3000:]}", flush=True)
            ok = False
        for name, row in report["ops"].items():
            ok &= row["raises"] is None and not row["ops"]
            print(f"[ops {name}] step 1 under torch.use_deterministic_algorithms(True) "
                  f"(CUBLAS_WORKSPACE_CONFIG=:4096:8, {row['graph_nodes']} backward node types "
                  f"in the step's graphs): "
                  + ("no op raises" if row["raises"] is None else f"raises {row['raises']}")
                  + "; with warn_only: "
                  + (json.dumps(row["ops"]) if row["ops"] else "no op without a deterministic form"),
                  flush=True)
    if "bits" in args.parts:
        ok &= bits_part(torch, args, report)
    if "time" in args.parts:
        time_part(torch, args, report)
    if "pad" in args.parts:
        pad_part(torch, args, report)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"[card] {card}")
    print(json.dumps({"deterministic": ok}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
