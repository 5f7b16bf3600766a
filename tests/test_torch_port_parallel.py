"""The port's data parallelism in one process: ``parallel/mesh.py`` and
``--data_parallel`` serving, against the JAX package's (8 virtual CPU devices,
``tests/conftest.py``).

  - ``data_mesh_for_batch`` on ``[cpu] * 8`` takes JAX's device counts and
    warnings (``tests/test_multichip.py:13-35``);
  - the fp32 engine on 8 CPU shards equals the single-device engine (rtol
    1e-5) and JAX's data-parallel engine on its 8 devices (the fp32 bars);
  - the int8 engine on 8 shards equals the single-device engine to the bit
    on one-hot styles (exact style affines; with dense styles each shard's
    affine product may round its last bit otherwise, ROADMAP Queue 3);
  - a partial batch of 5 gives 5 outputs;
  - ``initialize_multihost``: a no-op without a rendezvous, an error with a bad one;
  - the helpers without a process group.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from msig_tpu.config import InferenceConfig as JInferenceConfig
from msig_tpu.infer import InferenceEngine as JInferenceEngine
from msig_tpu.models import MultiDomainStyleEncoder as JStyleEncoder
from msig_tpu.models import StyleCycleGANGenerator as JGenerator
from msig_tpu.parallel.mesh import data_mesh_for_batch as jax_mesh_for_batch
from msig_tpu_torch.compat.from_jax import generator_state_dict, style_encoder_state_dict
from msig_tpu_torch.config import InferenceConfig
from msig_tpu_torch.infer.engine import InferenceEngine
from msig_tpu_torch.parallel import mesh

CPU8 = [torch.device("cpu")] * 8
SDIM, N_RES, N_DOMAINS = 16, 1, 2
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- mesh

@pytest.mark.parametrize("batch", list(range(1, 17)))
def test_data_mesh_for_batch_matches_jax(batch, caplog):
    with caplog.at_level(logging.WARNING):
        jm = jax_mesh_for_batch(batch)
    jax_warned = "not divisible" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        tm = mesh.data_mesh_for_batch(batch, CPU8)
    assert (None if jm is None else jm.devices.size) == (None if tm is None else len(tm))
    assert ("not divisible" in caplog.text) == jax_warned
    if tm is not None:
        assert tm == CPU8[:len(tm)]


def test_mesh_defaults_and_local_devices():
    assert mesh.local_devices("cpu") == [torch.device("cpu")]
    assert mesh.make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert mesh.data_mesh_for_batch(8, ["cpu"]) is None
    assert mesh.DATA_AXIS == "data"


def test_helpers_without_a_process_group():
    assert not dist.is_initialized() and mesh.world() == (0, 1)
    batch = {"a": np.arange(8), "b": np.arange(16).reshape(8, 2)}
    assert mesh.shard_batch(batch)["a"].tolist() == list(range(8))
    assert mesh.shard_batch(batch, 1, 4)["b"].tolist() == [[4, 5], [6, 7]]
    with pytest.raises(ValueError, match="does not split over 3"):
        mesh.shard_batch(batch, 0, 3)
    t = [torch.ones(3), torch.full((2, 2), 5.0)]
    mesh.all_reduce_mean_(t)
    mesh.replicate(torch.nn.Linear(2, 2))
    assert mesh.replicated(t) and t[1].eq(5.0).all()
    x = torch.randn(2, 3, requires_grad=True)
    assert mesh.gather_rows(x) is x


def test_initialize_multihost_without_rendezvous_is_a_no_op(monkeypatch, caplog):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    with caplog.at_level(logging.INFO):
        assert mesh.initialize_multihost("cpu") is False
    assert "single-process run" in caplog.text and not dist.is_initialized()


@pytest.mark.parametrize("env,error", [
    ({"RANK": "0"}, RuntimeError),                         # half a rendezvous
    ({"MASTER_ADDR": "localhost", "MASTER_PORT": "not-a-port", "RANK": "0",
      "WORLD_SIZE": "1"}, ValueError),                     # a port that is none
])
def test_initialize_multihost_with_a_bad_rendezvous_raises(monkeypatch, env, error):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(error):
        mesh.initialize_multihost("cpu")
    assert not dist.is_initialized()


def test_kernel_entries_keep_their_state_per_device():
    """A kernel attribute (the dynamic shared memory past 48 KB) or a cached
    occupancy holds for one device: a C entry that keeps such state across calls
    keeps it per device (``[kMaxDevices]``), never in one flag for the process,
    which data parallelism over several cards breaks on the second card."""
    import pathlib
    import re

    csrc = pathlib.Path(mesh.__file__).resolve().parents[1] / "csrc"
    scalar_state = re.compile(r"^\s+static\s+(?:const\s+)?[A-Za-z_][\w:]*\s+\w+\s*(?:=|;)",
                              re.M)
    found = {p.name: scalar_state.findall(p.read_text()) for p in sorted(csrc.glob("*.cu*"))}
    assert not {k: v for k, v in found.items() if v}
    per_device = [p.name for p in csrc.glob("*.cu*") if "[kMaxDevices]" in p.read_text()]
    assert "final7_tanh_u8.cu" in per_device


# ---------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def weights():
    """JAX's seeded generator and style encoder (``tests/test_multichip.py``'s),
    and the same tensors as the port's state_dicts."""
    rng = jax.random.PRNGKey(0)
    img = jnp.zeros((1, 32, 32, 3), jnp.float32)
    gp = JGenerator(style_dim=SDIM, n_residual_blocks=N_RES, use_pallas=False).init(
        rng, img, jnp.zeros((1, SDIM), jnp.float32))
    sp = JStyleEncoder(style_dim=SDIM, num_domains=N_DOMAINS).init(
        rng, img, jnp.zeros((1,), jnp.int32))
    return (gp, sp, generator_state_dict(gp, N_RES),
            style_encoder_state_dict(sp, N_DOMAINS, SDIM))


def _port_engine(weights, data_parallel, quantize=None):
    cfg = InferenceConfig(image_size=32, style_dim=SDIM, n_residual_blocks=N_RES, batch_size=8,
                          compute_dtype="float32", quantize=quantize,
                          data_parallel=data_parallel, device="cpu")
    return InferenceEngine.build(cfg, N_DOMAINS, weights[2], weights[3], devices=CPU8)


def _run(eng, imgs, bank, mode="average"):
    out, names = next(eng.translate_batches(
        iter([(imgs, [f"i{k}" for k in range(imgs.shape[0])])]), bank, mode, seed=3))
    assert names == [f"i{k}" for k in range(imgs.shape[0])]
    return out


def test_engine_splits_over_the_mesh(weights):
    dp = _port_engine(weights, True, "int8")
    assert len(dp.replicas) == 8 and dp.replicas[0].generator is dp.generator
    # each shard its own copy of the networks and of the int8 weights
    assert len({id(r.generator) for r in dp.replicas}) == 8
    k = "res0_conv1_p"
    assert len({r.q[k].data_ptr() for r in dp.replicas}) == 8
    assert all(torch.equal(r.q[k], dp.q[k]) for r in dp.replicas)


def test_fp32_data_parallel_matches_single_and_jax(weights):
    imgs = np.random.default_rng(1).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    bank = np.random.default_rng(7).standard_normal((4, SDIM)).astype(np.float32)
    single = _run(_port_engine(weights, False), imgs.copy(), torch.from_numpy(bank))
    dp = _run(_port_engine(weights, True), imgs.copy(), torch.from_numpy(bank))
    np.testing.assert_allclose(dp, single, rtol=1e-5, atol=1e-5)

    gp, sp = weights[:2]
    jcfg = JInferenceConfig(image_size=32, style_dim=SDIM, n_residual_blocks=N_RES, batch_size=8,
                            compute_dtype="float32", use_pallas=False, data_parallel=True)
    jeng = JInferenceEngine.build(jcfg, N_DOMAINS, gp, sp)
    assert jeng.mesh is not None and jeng.mesh.devices.size == 8
    jout = _run(jeng, imgs.copy(), jnp.asarray(bank))
    np.testing.assert_allclose(dp, np.asarray(jout), rtol=1e-3, atol=1e-4)


def _one_hot_bank(n=6, seed=11):
    """Rows with one nonzero entry: each style affine is one product and a bias
    add, exact whatever the batch the product runs in."""
    rng = np.random.default_rng(seed)
    bank = np.zeros((n, SDIM), np.float32)
    bank[np.arange(n), rng.integers(0, SDIM, n)] = rng.normal(0, 2, n)
    return torch.from_numpy(bank)


def test_int8_data_parallel_equals_single_on_one_hot_styles(weights):
    imgs = np.random.default_rng(2).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    single, dp = _port_engine(weights, False, "int8"), _port_engine(weights, True, "int8")
    for e in (single, dp):
        e.out_uint8 = True
    bank = _one_hot_bank()
    a = _run(single, imgs.copy(), bank, "random")
    b = _run(dp, imgs.copy(), bank, "random")
    assert a.dtype == np.uint8 and a.shape == (8, 32, 32, 3)
    np.testing.assert_array_equal(b, a)


def test_partial_batch_on_mesh(weights):
    """5 images with batch 8 on the mesh: padded, split, 5 outputs."""
    dp = _port_engine(weights, True)
    imgs = np.random.default_rng(3).integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    bank = torch.from_numpy(np.random.default_rng(7).standard_normal((4, SDIM)).astype(np.float32))
    out = _run(dp, imgs, bank)
    assert out.shape == (5, 32, 32, 3)
    single = _run(_port_engine(weights, False), imgs, bank)
    np.testing.assert_allclose(out, single, rtol=1e-5, atol=1e-5)


def test_style_bank_on_the_mesh(weights):
    """The style encoder runs sharded too; the bank lands on the engine's device."""
    refs = np.random.default_rng(4).integers(0, 256, (11, 32, 32, 3), dtype=np.uint8)
    single = _port_engine(weights, False).encode_styles(refs, 1)
    dp = _port_engine(weights, True).encode_styles(refs, 1)
    assert dp.shape == (11, SDIM) and dp.device == torch.device("cpu")
    torch.testing.assert_close(dp, single, rtol=1e-5, atol=1e-5)
