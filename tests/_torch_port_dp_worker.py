"""Worker process of tests/test_torch_port_multiprocess.py (not collected by pytest).

    RANK=r WORLD_SIZE=k MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/_torch_port_dp_worker.py OUT_DIR GLOBAL_BATCH

One rank of a data-parallel train step of the port on the CPU: it joins the
gloo group its environment describes (``initialize_multihost``), builds the
seeded state and global batch that :func:`setup` gives every process (the
parent's one-process step too), keeps its rows (``shard_batch``) and runs one
step with ``distributed=True``. It writes ``OUT_DIR/rank<r>.json`` (the
metrics, whether its networks equal rank 0's after the step, whether a
``--device_data`` Trainer refuses the group) and, on rank 0,
``OUT_DIR/state.npz`` (every network parameter and its Adam first moment
after the step).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from msig_tpu_torch.config import TrainConfig  # noqa: E402
from msig_tpu_torch.losses import init_random_vgg  # noqa: E402
from msig_tpu_torch.train import create_train_state  # noqa: E402

N_DOMAINS = 3
WEIGHTS = [1.0, 10.0, 5.0, 1.0, 1.0]  # gan, cycle, identity, content, style


def setup(global_batch: int):
    """(cfg, state, vgg, host batch) of the seeded step at 32², 1 resblock, style_dim 16."""
    cfg = TrainConfig(image_size=32, batch_size=global_batch, style_dim=16, n_residual_blocks=1,
                      use_pallas=False, device="cpu")
    state = create_train_state(cfg, N_DOMAINS)
    rng = np.random.default_rng(0)
    shape = (global_batch, 32, 32, 3)
    batch = {"source": rng.integers(0, 256, shape, dtype=np.uint8),
             "target": rng.integers(0, 256, shape, dtype=np.uint8),
             "source_domain": np.zeros((global_batch,), np.int32),
             "target_domain": rng.integers(1, N_DOMAINS, (global_batch,), dtype=np.int32)}
    return cfg, state, init_random_vgg(device="cpu"), batch


def run_step(state, cfg, vgg, batch, distributed: bool):
    from msig_tpu_torch.train import make_train_step

    step = make_train_step(cfg.ema_beta, distributed=distributed)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = step(state, tensors, vgg, cfg.lr_g, cfg.lr_d, WEIGHTS)
    return {k: float(v) for k, v in metrics.items()}


def snapshot(state) -> dict:
    """Every network parameter (``param:<net>/<name>``) and its Adam first moment
    (``mu:<net>/<name>``: after step 1, (1 - b1) times the clipped gradient)."""
    from msig_tpu_torch.train.state import D_KEYS, G_KEYS

    out = {}
    for keys, opt in ((G_KEYS, state.opt_g), (D_KEYS, state.opt_d)):
        names = [f"{k}/{n}" for k in keys for n, _ in state.models.nets[k].named_parameters()]
        params = [p for k in keys for p in state.models.nets[k].parameters()]
        for name, p, mu in zip(names, params, opt.mu):
            out[f"param:{name}"] = p.detach().numpy().copy()
            out[f"mu:{name}"] = mu.numpy().copy()
    return out


def main():
    from msig_tpu_torch.parallel import initialize_multihost, replicated, shard_batch, world
    from msig_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    out_dir, global_batch = sys.argv[1], int(sys.argv[2])
    assert initialize_multihost("cpu"), "no rendezvous in the environment"
    rank, n = world()
    cfg, state, vgg, batch = setup(global_batch)
    metrics = run_step(state, cfg, vgg, shard_batch(batch), distributed=True)
    same = all(replicated(m) for m in state.models.nets.values())
    try:
        Trainer(dataclasses.replace(cfg, device_data=True), dataset=None)
        refused = False
    except ValueError:
        refused = True
    if rank == 0:
        np.savez(os.path.join(out_dir, "state.npz"), **snapshot(state))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": n, "metrics": metrics, "replicated": same,
                   "device_data_refused": refused}, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
