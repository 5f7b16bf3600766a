"""``python -m msig_tpu_torch.bench``: the one-line JSON contract of each mode
and the supervisor's stall-proofing, on the CPU (``--device cpu``, 64²).

Mirrors ``tests/test_bench.py`` (the JAX bench): each mode's metric name and
unit, the stall and best-so-far cases through ``MSIG_BENCH_FAKE_STALL``, an
external SIGTERM, the fast probe failure and the sweep order; plus the port's
``--device cuda`` without a card, which exits 1 with a diagnostic and no
traceback. The tests marked slow are those ``tests/test_bench.py`` marks slow.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST_ARGS = ["--device", "cpu", "--image_size", "64", "--batches", "2", "--iters", "1"]


def bench_env(extra_env) -> dict:
    """The bench's environment: the repository importable, and two intra-op
    threads (beside the suite's other workers, torch on all cores
    oversubscribes the CPU and runs many times slower)."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.update(extra_env)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return env


def run_bench(extra_env, args=FAST_ARGS, timeout=600):
    env = bench_env(extra_env)
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "msig_tpu_torch.bench", *args], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    return r, time.monotonic() - t0


def headline(stdout):
    lines = [ln for ln in stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, f"want exactly one stdout line: {stdout!r}"
    rec = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(rec)
    assert rec["vs_baseline"] is None and rec["value"] > 0
    return rec


@pytest.mark.parametrize("mode,metric,unit", [
    ("train", "train_step_ms_b1_64", "ms"),
    ("data", "input_pipeline_img_per_s_64", "img/s/host"),
    ("e2e", "e2e_img_per_s_64_incl_decode", "img/s"),
])
def test_mode_emits_one_json_line(mode, metric, unit):
    r, _ = run_bench({}, args=["--mode", mode, "--train_batch", "1", *FAST_ARGS])
    assert r.returncode == 0, r.stderr[-2000:]
    rec = headline(r.stdout)
    assert (rec["metric"], rec["unit"]) == (metric, unit)
    if mode == "data":
        assert "native_loader=" in r.stderr  # the backend it measured


@pytest.mark.slow
def test_normal_run_emits_headline():
    r, _ = run_bench({})
    assert r.returncode == 0, r.stderr[-2000:]
    rec = headline(r.stdout)
    assert (rec["metric"], rec["unit"]) == ("img_per_s_64px_ref_guided_inference", "img/s/chip")
    assert "int8 batch 2" in r.stderr and "bf16 batch 2" in r.stderr


@pytest.mark.slow
def test_latency_mode_emits_ms_headline_and_curve():
    r, _ = run_bench({}, args=["--mode", "latency", *FAST_ARGS[:4], "--batches", "1,2",
                               "--iters", "1"])
    assert r.returncode == 0, r.stderr[-1500:]
    rec = headline(r.stdout)
    assert rec["metric"] == "latency_ms_per_img_64px_int8_b1" and rec["unit"] == "ms"
    assert {str(k) for k in rec["ms_per_batch"]} == {"1", "2"}
    assert "bf16 batch" not in r.stderr  # the int8 chain only


@pytest.mark.slow
def test_stall_after_first_config_still_reports_best_so_far():
    r, dt = run_bench({"MSIG_BENCH_FAKE_STALL": "after_first", "MSIG_BENCH_NEXT_DEADLINE": "10"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert headline(r.stdout)["metric"] == "img_per_s_64px_ref_guided_inference"
    assert "stalled" in r.stderr
    assert dt < 400


@pytest.mark.slow
def test_stall_before_any_config_exits_nonzero_with_diagnostic():
    r, _ = run_bench({"MSIG_BENCH_FAKE_STALL": "init", "MSIG_BENCH_CONFIG_DEADLINE": "8",
                      "MSIG_BENCH_DEADLINE": "20"})
    assert r.returncode == 1
    assert "no config completed" in r.stderr or "stalled" in r.stderr
    assert not r.stdout.strip()


def test_unreachable_backend_fails_probe_fast():
    r, dt = run_bench({"MSIG_BENCH_PROBE_TIMEOUT": "0.05"})
    assert r.returncode == 1
    assert "backend unreachable" in r.stderr
    assert not r.stdout.strip()
    assert dt < 60


@pytest.mark.parametrize("mode", ["inference", "train"])
def test_cuda_without_a_card_exits_1_without_traceback(mode):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r, _ = run_bench({}, args=["--mode", mode, "--image_size", "64", "--iters", "1"])
    assert r.returncode == 1
    assert not r.stdout.strip()
    assert "Traceback" not in r.stderr
    assert ("backend unreachable" if mode == "inference" else "torch.cuda.is_available()") \
        in r.stderr


@pytest.mark.slow
def test_external_sigterm_still_reports_best_so_far():
    env = bench_env({"MSIG_BENCH_FAKE_STALL": "after_first", "MSIG_BENCH_NEXT_DEADLINE": "3000",
                     "MSIG_BENCH_DEADLINE": "3000"})
    proc = subprocess.Popen([sys.executable, "-m", "msig_tpu_torch.bench", *FAST_ARGS], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    t = threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True)
    t.start()
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline and not any("img/s" in ln for ln in lines):
        time.sleep(0.5)
    time.sleep(2)  # the result line crosses the pipe to the supervisor
    proc.terminate()
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, f"rc={proc.returncode} stderr={lines[-5:]}"
    assert headline(out)["value"] > 0


def test_worker_config_order_puts_int8_first():
    from msig_tpu_torch import bench

    assert bench.inference_configs((128, 256)) == [("int8", 128), ("int8", 256), ("bf16", 128),
                                                   ("bf16", 256)]


def test_bench_imports_no_jax():
    """The entry point and everything it imports, in a process where jax,
    flax, optax, orbax and msig_tpu cannot be imported."""
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'msig_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import msig_tpu_torch.bench, msig_tpu_torch.data, msig_tpu_torch.data.device_data\n"
            "import msig_tpu_torch.train.trainer, msig_tpu_torch.infer.engine\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
