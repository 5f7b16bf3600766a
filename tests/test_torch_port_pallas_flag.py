"""``--pallas`` in the port's serving CLI, against the JAX CLI's.

In the JAX package the flag routes the float generator's AdaIN to
``adain_pallas`` (``msig_tpu/infer/engine.py:82-88``) and forces the int8
path onto its kernel trunk (``:196-200``), the port's int8 chain with or
without the flag. Both CLIs parse it on the demo
checkpoint at 64² on the CPU; their engines' float outputs agree to the
float path's bars (fp32 rtol 1e-3, atol 1e-4; the JAX kernel in interpret
mode, the port's on its plain version), and the port's generator goes through
its ``adain_pallas`` wrapper, twice per resblock.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import inference as jax_cli
from msig_tpu.infer.engine import InferenceEngine as JEngine
from msig_tpu.infer.loading import load_inference_params as jax_load
from msig_tpu_torch import inference as cli
from msig_tpu_torch.infer import quantized as qmod
from msig_tpu_torch.infer.engine import InferenceEngine
from msig_tpu_torch.infer.loading import load_inference_params
from msig_tpu_torch.ops import adain_pallas as ap

DEMO = "results/tomato_r3b/demo_checkpoint"
ARGS = ["--input_dir", "in", "--ref_domains_dir", "ref", "--checkpoint_dir", DEMO,
        "--output_dir", "out", "--image_size", "64", "--batch_size", "2",
        "--compute_dtype", "float32", "--pallas"]


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_cli.config_from_args(jax_cli.build_arg_parser().parse_args(ARGS))
    tcfg = cli.config_from_args(cli.build_arg_parser().parse_args(ARGS + ["--device", "cpu"]))
    assert jcfg.use_pallas is True and tcfg.use_pallas is True
    gp, sp, meta, _ = jax_load(DEMO, jcfg, 10)
    jeng = JEngine.build(jcfg, 10, gp, sp, n_residual_blocks=meta.get("n_residual_blocks"),
                         style_dim=meta.get("style_dim"))
    gen, se, tmeta, _ = load_inference_params(DEMO, tcfg, 10)
    teng = InferenceEngine.build(tcfg, 10, gen, se, tmeta["n_residual_blocks"],
                                 tmeta["style_dim"])
    return jeng, teng


def test_pallas_flag_routes_the_float_generator_and_matches_jax(engines):
    jeng, teng = engines
    assert jeng.generator.use_pallas and teng.generator.use_pallas
    n_res = teng.generator.n_residual_blocks
    rng = np.random.default_rng(12)
    imgs = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    styles = rng.normal(0, 1, (2, 256)).astype(np.float32)
    want = np.asarray(jeng._generate_fn()(jeng.gen_params, imgs, styles))
    with mock.patch.object(ap, "adain_fwd_plain", wraps=ap.adain_fwd_plain) as fwd:
        got = teng.generate(torch.from_numpy(imgs), torch.from_numpy(styles))
    assert fwd.call_count == 2 * n_res
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


def test_pallas_flag_asks_the_int8_path_for_its_kernel_trunk():
    """JAX's ``force_fused`` (``fused_trunk=True``) is already the port's int8
    chain: with and without the flag the chain is chosen by size as
    ``msig_tpu/infer/quantized.py:347-400`` chooses it, which at 64² is the
    unfused one (one ``_xla_trunk`` call, no conv1 site call), and gives the
    same bits."""
    imgs = torch.from_numpy(np.random.default_rng(13).integers(0, 256, (2, 64, 64, 3),
                                                                dtype=np.uint8))
    styles = torch.from_numpy(np.random.default_rng(14).normal(0, 1, (2, 256)).astype(np.float32))
    outs = []
    for args in (ARGS, [a for a in ARGS if a != "--pallas"]):
        cfg = cli.config_from_args(cli.build_arg_parser().parse_args(
            args + ["--device", "cpu", "--quantize", "int8"]))
        assert cfg.use_pallas is ("--pallas" in args)
        gen, se, meta, _ = load_inference_params(DEMO, cfg, 10)
        eng = InferenceEngine.build(cfg, 10, gen, se, meta["n_residual_blocks"],
                                    meta["style_dim"])
        assert eng.q is not None
        with mock.patch.object(qmod.fc, "conv3x3_adain_relu_requant",
                               wraps=qmod.fc.conv3x3_adain_relu_requant) as conv1, \
                mock.patch.object(qmod, "_xla_trunk", wraps=qmod._xla_trunk) as trunk:
            outs.append(eng.generate(imgs, styles))
        assert conv1.call_count == 0 and trunk.call_count == 1
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
