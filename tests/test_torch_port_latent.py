"""Latent-guided serving of the port against the JAX package, on the CPU.

- ``compat/flax_bytes.to_bytes`` writes the bytes of
  ``flax.serialization.to_bytes`` for a ``MappingNetwork`` tree, and
  ``from_bytes`` reads flax's bytes to equal arrays (and refuses a file that
  lacks a key of the target, as flax does);
- ``extensions.MappingNetwork`` against the JAX module on the same parameters
  and z: rtol 1e-5 / atol 1e-6, per-sample domains and ``domain_idx=None``;
- the engine's latent styles (``infer/styles.latent_styles``) on handed-in z
  equal the JAX mapping's; drawn z come from the engine's ``torch.Generator``;
- ``python -m msig_tpu_torch.inference --style_mode latent`` on the demo
  checkpoint at 64² (float and int8): one image an input, and the float
  images are the generator's on the mapping network's styles of z drawn
  from ``torch.Generator(seed)``;
- each new module of this slice imports with JAX, flax, msgpack and the JAX
  package blocked.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from flax import serialization

from msig_tpu.extensions import MappingNetwork as JMapping

from msig_tpu_torch import inference as cli
from msig_tpu_torch.compat import flax_bytes
from msig_tpu_torch.compat import from_jax as fj
from msig_tpu_torch.extensions import MappingNetwork
from msig_tpu_torch.infer.styles import latent_styles

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEMO = str(ROOT / "results" / "tomato_r3b" / "demo_checkpoint")
LATENT, SDIM, ND = 16, 32, 3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: beside the suite's other workers, the generator on
    all cores oversubscribes the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _host(tree):
    """A flax tree -> the same nested dicts of numpy arrays, in the same order."""
    return {k: _host(v) for k, v in tree.items()} if isinstance(tree, dict) else np.asarray(tree)


@pytest.fixture(scope="module")
def jax_mapping():
    mod = JMapping(latent_dim=LATENT, style_dim=SDIM, num_domains=ND)
    params = mod.init(jax.random.PRNGKey(3), jnp.zeros((1, LATENT)), jnp.zeros((1,), jnp.int32))
    return mod, params


@pytest.fixture(scope="module")
def port_mapping(jax_mapping):
    net = MappingNetwork(latent_dim=LATENT, style_dim=SDIM, num_domains=ND)
    net.load_state_dict(fj.mapping_state_dict(_host(jax_mapping[1])), strict=True)
    return net.eval()


def test_to_bytes_is_flax_bytes(jax_mapping, port_mapping):
    want = serialization.to_bytes(jax_mapping[1])
    assert flax_bytes.to_bytes(_host(jax_mapping[1])) == want
    # the port's own network, through the reverse map, writes the same file
    assert flax_bytes.to_bytes(fj.mapping_params(port_mapping.state_dict())) == want


def test_from_bytes_reads_flax_bytes(jax_mapping):
    data = serialization.to_bytes(jax_mapping[1])
    template = fj.mapping_params(MappingNetwork(LATENT, SDIM, ND).state_dict())
    got = flax_bytes.from_bytes(template, data)
    want = _host(jax_mapping[1])
    for (pg, g), (pw, w) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree_util.tree_flatten_with_path(want)[0]):
        assert pg == pw and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # and flax reads what the port writes
    back = serialization.from_bytes(jax_mapping[1], flax_bytes.to_bytes(got))
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_from_bytes_refuses_a_missing_key(jax_mapping):
    tree = _host(jax_mapping[1])
    del tree["params"]["heads"]
    template = fj.mapping_params(MappingNetwork(LATENT, SDIM, ND).state_dict())
    with pytest.raises(ValueError, match="heads"):
        flax_bytes.from_bytes(template, flax_bytes.to_bytes(tree))


@pytest.mark.parametrize("domains", [[0, 1, 2, 1], None])
def test_mapping_network_matches_jax(jax_mapping, port_mapping, domains):
    mod, params = jax_mapping
    z = np.random.default_rng(0).standard_normal((4, LATENT)).astype(np.float32)
    idx = None if domains is None else np.asarray(domains, np.int32)
    want = mod.apply(params, jnp.asarray(z), None if idx is None else jnp.asarray(idx))
    with torch.no_grad():
        got = port_mapping(torch.from_numpy(z), None if idx is None else torch.from_numpy(idx))
    assert got.shape == (4, SDIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_latent_styles_on_handed_in_z(jax_mapping, port_mapping):
    mod, params = jax_mapping
    z = np.random.default_rng(1).standard_normal((5, LATENT)).astype(np.float32)
    want = mod.apply(params, jnp.asarray(z), jnp.full((5,), 2, jnp.int32))
    with torch.no_grad():
        got = latent_styles(port_mapping, 2, None, 5, z=torch.from_numpy(z))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with torch.no_grad():  # drawn: the generator's normal draws, the same for a seed
        a = latent_styles(port_mapping, 2, torch.Generator().manual_seed(7), 5)
        z7 = torch.randn((5, LATENT), generator=torch.Generator().manual_seed(7))
        assert torch.equal(a, latent_styles(port_mapping, 2, None, 5, z=z7))


# --------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def latent_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("latent")
    rng = np.random.default_rng(0)
    (root / "in").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (72, 80, 3), dtype=np.uint8)).save(
            root / "in" / f"leaf{i}.png")
    for d in range(9):  # the demo checkpoint has 10 domains
        (root / "ref" / f"dom{d}").mkdir(parents=True)
    # a seeded mapping network at the demo's style_dim, written as flax bytes
    net = MappingNetwork(latent_dim=LATENT, style_dim=256, num_domains=10)
    from msig_tpu_torch.train.state import torch_default_init_

    torch_default_init_(net, torch.Generator().manual_seed(11))
    (root / "mapping.msgpack").write_bytes(flax_bytes.to_bytes(fj.mapping_params(net.state_dict())))
    return root, net


def _args(root, out, *extra):
    return cli.build_arg_parser().parse_args(
        ["--input_dir", str(root / "in"), "--ref_domains_dir", str(root / "ref"),
         "--checkpoint_dir", DEMO, "--output_dir", str(out), "--target_domain", "dom4",
         "--image_size", "64", "--batch_size", "2", "--device", "cpu", "--style_mode", "latent",
         "--mapping_params", str(root / "mapping.msgpack"), "--latent_dim", str(LATENT),
         "--seed", "5", *extra])


@pytest.mark.parametrize("extra", [("--compute_dtype", "float32"), ("--quantize", "int8")])
def test_cli_latent_serves_the_mapping_styles(latent_dirs, tmp_path, extra):
    """Empty reference folders: latent mode needs no bank. The float path's
    images are the engine's on the styles of z from torch.Generator(--seed)
    through the network (the int8 path serves from the same styles)."""
    from msig_tpu_torch.config import InferenceConfig
    from msig_tpu_torch.infer.engine import InferenceEngine
    from msig_tpu_torch.infer.loading import load_inference_params

    root, net = latent_dirs
    args = _args(root, tmp_path / "out", *extra)
    assert cli.main(cli.config_from_args(args)) == 0
    names = sorted(os.listdir(tmp_path / "out"))
    assert names == ["leaf0.png", "leaf1.png", "leaf2.png"]
    if "--quantize" in extra:
        return

    cfg = cli.config_from_args(args)
    assert isinstance(cfg, InferenceConfig)
    gen_sd, se_sd, meta, _ = load_inference_params(DEMO, cfg, 10)
    engine = InferenceEngine.build(cfg, 10, gen_sd, se_sd,
                                   n_residual_blocks=meta.get("n_residual_blocks"),
                                   style_dim=meta.get("style_dim"))
    engine.out_uint8 = True
    gen = torch.Generator().manual_seed(5)
    from msig_tpu_torch.data import load_inference_image

    imgs = np.stack([load_inference_image(str(root / "in" / n), 64) for n in names])
    with torch.no_grad():
        s1 = latent_styles(net, 5, gen, 2)  # dom4 is domain 5
        s2 = latent_styles(net, 5, gen, 2)
    want = [engine.generate(torch.from_numpy(imgs[:2]), s1).numpy(),
            engine.generate(torch.from_numpy(np.concatenate([imgs[2:], imgs[2:]])), s2).numpy()[:1]]
    for i, n in enumerate(names):
        with Image.open(tmp_path / "out" / n) as im:
            np.testing.assert_array_equal(np.asarray(im), np.concatenate(want)[i], err_msg=n)


def test_new_modules_import_without_jax():
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
            "'msgpack', 'msig_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import msig_tpu_torch.extensions, msig_tpu_torch.extensions.mapping\n"
            "import msig_tpu_torch.extensions.r1, msig_tpu_torch.compat.flax_bytes\n"
            "import msig_tpu_torch.train.watch, msig_tpu_torch.train.checkpoint\n"
            "import msig_tpu_torch.train.trainer, msig_tpu_torch.train.cli\n"
            "import msig_tpu_torch.inference, msig_tpu_torch.infer.engine\n"
            "from msig_tpu_torch.compat import flax_bytes\n"
            "import numpy as np\n"
            "t = {'params': {'a': np.arange(3, dtype=np.float32)}}\n"
            "assert (flax_bytes.from_bytes(t, flax_bytes.to_bytes(t))['params']['a'] == "
            "t['params']['a']).all()\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
