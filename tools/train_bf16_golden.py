#!/usr/bin/env python3
"""Golden step 1 of the JAX package's bf16 train step, for the port's parity test.

    JAX_PLATFORMS=cpu python tools/train_bf16_golden.py

Builds the port's train state (``msig_tpu_torch.train.create_train_state``:
torch's default init drawn from ``torch.Generator(0)``) and its seeded random
VGG (``init_random_vgg(1234)``) at 64², 2 resblocks, style_dim 16, 3 domains;
carries them into the JAX package's layout; runs the JAX package's fused step
once with ``compute_dtype=bfloat16`` (``MSIG_CONV_VJP=0``, on the CPU) on a
seeded uint8 batch of 2; and writes ``tests/golden/torch_port_train_bf16.npz``:
the step's metrics, every leaf's norm of Adam's first moment, and at
``SAMPLES`` seeded positions of each leaf the updated parameter, the first
moment and (G_A2B, SE_B) the EMA copy. ``tests/test_torch_port_train_bf16.py``
holds the port's bf16 step against it; its ``-m slow`` test runs
:func:`jax_step1` live. A live JAX step costs about a minute to compile here,
the golden none.
"""

from __future__ import annotations

import os
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_train_bf16.npz")
BATCH, SIZE, SDIM, ND, N_RES = 2, 64, 16, 3, 2
G_LR, D_LR = 2e-4, 1e-4
WEIGHTS = (1.0, 10.0, 5.0, 1.0, 1.0)  # gan, cycle, identity, content, style
SEED, VGG_SEED = 0, 1234
SAMPLES = 128
G_KEYS, D_KEYS, EMA_KEYS = ("G_A2B", "G_B2A", "SE_A", "SE_B"), ("D_A", "D_B"), ("G_A2B", "SE_B")


def batch_arrays():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    trg = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    return src, trg, np.zeros(BATCH, np.int32), np.array([1, 2], np.int32)


def sample_index(name: str, size: int) -> np.ndarray:
    """The positions of a leaf (by its flattened tree path) that the golden keeps."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return np.sort(rng.choice(size, min(SAMPLES, size), replace=False))


def flat_leaves(tree, prefix: str = ""):
    """{path: array} of a nested dict of arrays, paths joined by '/', sorted."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def port_trees(state):
    """The port's train state -> {net: flax 'params' tree} of numpy arrays."""
    from msig_tpu_torch.compat import from_jax as fj

    nets, out = state.models.nets, {}
    for k in G_KEYS + D_KEYS:
        sd = nets[k].state_dict()
        if k.startswith("G_"):
            out[k] = fj.generator_params(sd, N_RES)["params"]
        elif k.startswith("SE_"):
            out[k] = fj.style_encoder_params(sd, ND)["params"]
        else:
            out[k] = fj.discriminator_params(sd, ND)["params"]
    return out


def port_state():
    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.train import create_train_state

    cfg = TrainConfig(image_size=SIZE, batch_size=BATCH, style_dim=SDIM, n_residual_blocks=N_RES,
                      compute_dtype="bfloat16", seed=SEED, device="cpu")
    return cfg, create_train_state(cfg, ND)


def jax_step1(level: str = "0", use_pallas: bool = False):
    """The JAX bf16 step 1 from the port's initial state at ``MSIG_CONV_VJP=level``
    (``use_pallas``: the AdaIN kernel too; the Pallas kernels run in interpret
    mode on the CPU): (metrics, {net: new params}, {net: Adam mu}, {net: EMA}),
    numpy leaves in flax layout."""
    import jax
    import jax.numpy as jnp

    from msig_tpu.config import TrainConfig as JConfig
    from msig_tpu.train import Models, TrainState, make_optimizers, make_train_step
    from msig_tpu_torch.losses import init_random_vgg

    _, state = port_state()
    trees = port_trees(state)
    vgg = init_random_vgg(VGG_SEED, device="cpu")
    jvgg = {f"conv{i}": {"kernel": jnp.asarray(getattr(vgg, f"conv{i}").weight.numpy()
                                               .transpose(2, 3, 1, 0)),
                         "bias": jnp.asarray(getattr(vgg, f"conv{i}").bias.numpy())}
            for i in range(5)}
    jcfg = JConfig(image_size=SIZE, batch_size=BATCH, style_dim=SDIM, n_residual_blocks=N_RES,
                   compute_dtype="bfloat16", use_pallas=use_pallas)
    models = Models.from_config(jcfg, num_domains=ND, dtype=jnp.bfloat16)
    tx_g, tx_d = make_optimizers(jcfg)
    gen = {k: {"params": jax.tree.map(jnp.asarray, trees[k])} for k in G_KEYS}
    disc = {k: {"params": jax.tree.map(jnp.asarray, trees[k])} for k in D_KEYS}
    js = TrainState(gen_params=gen, disc_params=disc, ema_params=jax.tree.map(jnp.copy, gen),
                    opt_g=tx_g.init(gen), opt_d=tx_d.init(disc), step=jnp.zeros((), jnp.int32))
    src, trg, sdom, tdom = batch_arrays()
    jbatch = {"source": jnp.asarray(src), "target": jnp.asarray(trg),
              "source_domain": jnp.asarray(sdom), "target_domain": jnp.asarray(tdom)}
    old = os.environ.get("MSIG_CONV_VJP")
    os.environ["MSIG_CONV_VJP"] = level
    try:
        step = jax.jit(make_train_step(models, tx_g, tx_d, jcfg.ema_beta, jnp.bfloat16))
        new, met = step(js, jbatch, jvgg, jnp.float32(G_LR), jnp.float32(D_LR),
                        jnp.asarray(WEIGHTS, jnp.float32))
        new, met = jax.device_get((new, met))
    finally:
        if old is None:
            del os.environ["MSIG_CONV_VJP"]
        else:
            os.environ["MSIG_CONV_VJP"] = old
    params = {**{k: new.gen_params[k]["params"] for k in G_KEYS},
              **{k: new.disc_params[k]["params"] for k in D_KEYS}}
    mu = {**{k: new.opt_g[1].mu[k]["params"] for k in G_KEYS},
          **{k: new.opt_d[1].mu[k]["params"] for k in D_KEYS}}
    ema = {k: new.ema_params[k]["params"] for k in EMA_KEYS}
    return {k: float(v) for k, v in met.items()}, params, mu, ema


def golden_arrays(metrics, params, mu, ema) -> dict:
    """What the golden file keeps of a step-1 result."""
    out = {"config": np.array([BATCH, SIZE, SDIM, ND, N_RES, SEED, VGG_SEED, SAMPLES])}
    out.update({f"metric/{k}": np.float64(v) for k, v in metrics.items()})
    for net in G_KEYS + D_KEYS:
        p, m = flat_leaves(params[net]), flat_leaves(mu[net])
        e = flat_leaves(ema[net]) if net in EMA_KEYS else {}
        for name, arr in p.items():
            key = f"{net}/{name}"
            idx = sample_index(key, arr.size)
            out[f"idx/{key}"] = idx.astype(np.int32)
            out[f"new/{key}"] = arr.reshape(-1)[idx]
            out[f"mu/{key}"] = m[name].reshape(-1)[idx]
            out[f"mu_norm/{key}"] = np.float64(np.linalg.norm(m[name].astype(np.float64)))
            if e:
                out[f"ema/{key}"] = e[name].reshape(-1)[idx]
    return out


def main() -> int:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    arrays = golden_arrays(*jax_step1())
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: {len(arrays)} arrays, {os.path.getsize(GOLDEN)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
