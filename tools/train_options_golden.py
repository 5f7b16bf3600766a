#!/usr/bin/env python3
"""Golden step 1 of the JAX package's train step with its extension losses on,
at ``MSIG_CONV_VJP=1`` with ``use_pallas``, for the port's parity test.

    JAX_PLATFORMS=cpu python tools/train_options_golden.py

Builds the JAX package's train state (``create_train_state`` with
``PRNGKey(0)``, as ``tests/test_torch_port_train_step_common.py`` does: at
torch's default init the generators' tanh saturates, and its backward turns
last-bit differences of the forward into relative differences of up to 3e-3
of a gradient leaf's norm, beyond the fp32 moment bars) at 32², one resblock,
style_dim 16, 3 domains, and the port's seeded random VGG
(``init_random_vgg(1234)``) carried into the JAX layout; runs the JAX fp32 step
once with ``r1_gamma``, ``style_recon_weight`` and ``diversity_weight`` at
``OPTIONS`` (its Pallas kernels in interpret mode) on a seeded uint8 batch of 2
with a second target image; and writes
``tests/golden/torch_port_train_options.npz``: the step's metrics, each
group's largest |Adam first moment|, and at ``SAMPLES`` seeded positions of
each leaf the updated parameter, both Adam moments and (G_A2B, SE_B) the EMA
copy. ``tests/test_torch_port_train_options.py`` holds the port's step against
it; its ``-m slow`` test runs :func:`jax_step1` live (about a minute of
compilation here, the golden none).
"""

from __future__ import annotations

import os
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_train_options.npz")
BATCH, SIZE, SDIM, ND, N_RES = 2, 32, 16, 3, 1
G_LR, D_LR = 2e-4, 1e-4
WEIGHTS = (1.0, 10.0, 5.0, 1.0, 1.0)  # gan, cycle, identity, content, style
OPTIONS = {"r1_gamma": 1.0, "style_recon_weight": 1.0, "diversity_weight": 1.0}
LEVEL, USE_PALLAS = "1", True
SEED, VGG_SEED = 0, 1234
SAMPLES = 96
G_KEYS, D_KEYS, EMA_KEYS = ("G_A2B", "G_B2A", "SE_A", "SE_B"), ("D_A", "D_B"), ("G_A2B", "SE_B")


def batch_arrays():
    rng = np.random.default_rng(0)
    shape = (BATCH, SIZE, SIZE, 3)
    src, trg, trg2 = (rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(3))
    return {"source": src, "target": trg, "target2": trg2,
            "source_domain": np.zeros(BATCH, np.int32), "target_domain": np.array([1, 2], np.int32)}


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


def tree_of(net: str, sd):
    """A port state_dict (or tensors by parameter name) -> the flax 'params' tree."""
    from msig_tpu_torch.compat import from_jax as fj

    if net.startswith("G_"):
        return fj.generator_params(sd, N_RES)["params"]
    if net.startswith("SE_"):
        return fj.style_encoder_params(sd, ND)["params"]
    return fj.discriminator_params(sd, ND)["params"]


def jax_state():
    """The JAX package's initial train state at this file's configuration."""
    import jax

    from msig_tpu.config import TrainConfig as JConfig
    from msig_tpu.train import Models, create_train_state, make_optimizers

    jcfg = JConfig(image_size=SIZE, batch_size=BATCH, style_dim=SDIM, n_residual_blocks=N_RES,
                   use_pallas=USE_PALLAS)
    models = Models.from_config(jcfg, num_domains=ND)
    return jcfg, models, create_train_state(jcfg, models, jax.random.PRNGKey(SEED)), \
        make_optimizers(jcfg)


def port_state():
    """The port's train state with the JAX initial parameters (EMA = parameters)."""
    import jax

    from msig_tpu_torch.compat import from_jax as fj
    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.train import create_train_state

    _, _, js, _ = jax_state()
    js = jax.device_get(js)
    cfg = TrainConfig(image_size=SIZE, batch_size=BATCH, style_dim=SDIM, n_residual_blocks=N_RES,
                      use_pallas=USE_PALLAS, seed=SEED, device="cpu")
    state = create_train_state(cfg, ND)
    nets = state.models.nets
    for k in ("G_A2B", "G_B2A"):
        nets[k].load_state_dict(fj.generator_state_dict(js.gen_params[k], N_RES))
    for k in ("SE_A", "SE_B"):
        nets[k].load_state_dict(fj.style_encoder_state_dict(js.gen_params[k], ND, SDIM))
    for k in D_KEYS:
        nets[k].load_state_dict(fj.discriminator_state_dict(js.disc_params[k], ND))
    for k, e in state.models.ema.items():
        e.load_state_dict(nets[k].state_dict())
    return cfg, state


def jax_step1():
    """The JAX step 1 from its initial state: (metrics, {net: new params},
    {net: Adam mu}, {net: Adam nu}, {net: EMA}), numpy leaves in flax layout."""
    import jax
    import jax.numpy as jnp

    from msig_tpu.train import make_train_step
    from msig_tpu_torch.losses import init_random_vgg

    jcfg, models, js, (tx_g, tx_d) = jax_state()
    vgg = init_random_vgg(VGG_SEED, device="cpu")
    jvgg = {f"conv{i}": {"kernel": jnp.asarray(getattr(vgg, f"conv{i}").weight.numpy()
                                               .transpose(2, 3, 1, 0)),
                         "bias": jnp.asarray(getattr(vgg, f"conv{i}").bias.numpy())}
            for i in range(5)}
    jbatch = {k: jnp.asarray(v) for k, v in batch_arrays().items()}
    old = os.environ.get("MSIG_CONV_VJP")
    os.environ["MSIG_CONV_VJP"] = LEVEL
    try:
        step = jax.jit(make_train_step(models, tx_g, tx_d, jcfg.ema_beta, **OPTIONS))
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
    nu = {**{k: new.opt_g[1].nu[k]["params"] for k in G_KEYS},
          **{k: new.opt_d[1].nu[k]["params"] for k in D_KEYS}}
    ema = {k: new.ema_params[k]["params"] for k in EMA_KEYS}
    return {k: float(v) for k, v in met.items()}, params, mu, nu, ema


def golden_arrays(metrics, params, mu, nu, ema) -> dict:
    """What the golden file keeps of a step-1 result."""
    out = {"config": np.array([BATCH, SIZE, SDIM, ND, N_RES, SEED, VGG_SEED, SAMPLES, int(LEVEL),
                               int(USE_PALLAS)])}
    out.update({f"metric/{k}": np.float64(v) for k, v in metrics.items()})
    for group, keys in (("g", G_KEYS), ("d", D_KEYS)):
        for kind, moments in (("mu", mu), ("nu", nu)):
            out[f"{kind}_max/{group}"] = np.float64(max(
                float(np.abs(a).max()) for k in keys for a in flat_leaves(moments[k]).values()))
    for net in G_KEYS + D_KEYS:
        p, m, v = flat_leaves(params[net]), flat_leaves(mu[net]), flat_leaves(nu[net])
        e = flat_leaves(ema[net]) if net in EMA_KEYS else {}
        for name, arr in p.items():
            key = f"{net}/{name}"
            idx = sample_index(key, arr.size)
            out[f"idx/{key}"] = idx.astype(np.int32)
            out[f"new/{key}"] = arr.reshape(-1)[idx]
            out[f"mu/{key}"] = m[name].reshape(-1)[idx]
            out[f"nu/{key}"] = v[name].reshape(-1)[idx]
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
