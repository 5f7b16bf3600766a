"""The train step's run-to-run bits, on the CPU at a small size (32², batch 2, 2
resblocks, style_dim 16, 3 domains, the four-network widths of the demo
checkpoint).

- ``reflect_pad2d`` (``msig_tpu_torch/models/layers.py``), which the
  generator's two reflect-padded 7x7 convs pad with: its forward equals
  ``F.pad(mode="reflect")`` to the bit; its backward equals JAX's VJP of
  ``jnp.pad(mode="reflect")`` (``msig_tpu/models/layers.py:93-94``) within
  fp32 rounding, from seeded numpy inputs, alone and through each package's
  ``TorchConv(pad_mode="reflect")``;
- the step's graphs (the G and D losses' ``grad_fn`` graphs, walked before
  their backward) in each configuration (``MSIG_CONV_VJP`` 0, 1 with
  ``use_pallas``, 2) hold no backward node whose CUDA form has
  no deterministic algorithm (``NO_DETERMINISTIC_FORM``: PyTorch's list of
  backwards that ``torch.use_deterministic_algorithms(True)`` refuses on the
  card; the step had ``ReflectionPad2DBackward0``, which adds the border with
  atomics there), and hold the reflect pads' own nodes, one a 7x7 conv of a
  generator launch: a regression shows here without a card;
- two runs of step 1 from one state (level 1 + ``use_pallas``) give equal bits
  in every parameter, gradient, Adam moment and EMA copy
  (``msig_tpu_torch/train/reproduce.py``); the card's tests and
  ``chip_smoke.py`` hold every configuration, fp32 and bf16.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from msig_tpu.models.layers import TorchConv as JConv

from msig_tpu_torch.config import TrainConfig
from msig_tpu_torch.losses import init_random_vgg
from msig_tpu_torch.models.layers import TorchConv, reflect_pad2d
from msig_tpu_torch.train import create_train_state, make_train_step, reproduce

SIZE, BATCH, N_RES, SDIM, ND = 32, 2, 2, 16, 3
CONFIGS = {"stock": ("0", False), "level1+pallas": ("1", True), "level2": ("2", False)}
NO_DETERMINISTIC_FORM = {
    "ReflectionPad2DBackward0", "ReplicationPad2DBackward0", "UpsampleBilinear2DBackward0",
    "UpsampleBicubic2DBackward0", "AdaptiveAvgPool2DBackward0", "AdaptiveMaxPool2DBackward0",
    "AvgPool3DBackward0", "MaxPool3DWithIndicesBackward0", "GridSampler2DBackward0"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("shape,pads,dtype", [
    ((2, 3, 32, 32), (3, 3), torch.float32),     # enc0's input
    ((2, 64, 32, 32), (3, 3), torch.bfloat16),   # the final conv's input in a bf16 step
    ((1, 2, 7, 5), (3, 2), torch.float32),       # the two strips overlap
    ((2, 4, 9, 13), (1, 4), torch.float64)])
def test_reflect_pad_forward_equals_f_pad(shape, pads, dtype):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape)).to(dtype)
    x = x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)  # NCHW view of NHWC
    got = reflect_pad2d(x, *pads)
    want = F.pad(x, (pads[1], pads[1], pads[0], pads[0]), mode="reflect")
    assert reproduce.bits_equal(got, want)


def _jax_pad_vjp(x, cot, pads):
    widths = ((0, 0), (pads[0],) * 2, (pads[1],) * 2, (0, 0))
    _, vjp = jax.vjp(lambda a: jnp.pad(a, widths, mode="reflect"), jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("shape,pads", [((2, 32, 32, 3), (3, 3)), ((2, 32, 32, 64), (3, 3)),
                                        ((1, 7, 5, 2), (3, 2))])
def test_reflect_pad_backward_equals_jax_vjp(shape, pads):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    cot = rng.normal(size=(shape[0], shape[1] + 2 * pads[0], shape[2] + 2 * pads[1],
                           shape[3])).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = reflect_pad2d(xt.permute(0, 3, 1, 2), *pads).permute(0, 2, 3, 1)
    got, = torch.autograd.grad(y, xt, torch.from_numpy(cot))
    want = _jax_pad_vjp(x, cot, pads)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_reflect_conv_vjp_equals_jax():
    """The generator's final conv (64 -> 3, 7x7, reflect 3): dx, dW and db against
    ``jax.vjp`` of the JAX package's ``TorchConv``, at the float path's bars."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, SIZE, SIZE, 64)).astype(np.float32)
    cot = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    conv = TorchConv(64, 3, 7, padding=3, pad_mode="reflect")
    kernel = conv.weight.detach().numpy().transpose(2, 3, 1, 0)  # OIHW -> HWIO
    bias = conv.bias.detach().numpy()
    jconv = JConv(features=3, kernel_size=7, padding=3, pad_mode="reflect")
    _, vjp = jax.vjp(lambda a, k, b: jconv.apply({"params": {"kernel": k, "bias": b}}, a),
                     jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    want = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = conv(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = torch.autograd.grad(y, (xt, conv.weight, conv.bias), torch.from_numpy(cot))
    got = [got[0].numpy(), got[1].numpy().transpose(2, 3, 1, 0), got[2].numpy()]
    for name, g, w in zip(("dx", "dW", "db"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * np.abs(w).max(), err_msg=name)


def _step1(config, monkeypatch, walk: bool):
    """Step 1 from the seeded state; (snapshot, {node name: count} of the step's graphs)."""
    level, pallas = CONFIGS[config]
    monkeypatch.setenv("MSIG_CONV_VJP", level)
    cfg = TrainConfig(image_size=SIZE, batch_size=BATCH, n_residual_blocks=N_RES, style_dim=SDIM,
                      use_pallas=pallas, device="cpu")
    rng = np.random.default_rng(4)
    batch = {"source": torch.from_numpy(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), np.uint8)),
             "target": torch.from_numpy(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), np.uint8)),
             "source_domain": torch.zeros(BATCH, dtype=torch.int32),
             "target_domain": torch.from_numpy(rng.integers(1, ND, BATCH).astype(np.int32))}
    state = create_train_state(cfg, ND)
    step = make_train_step(cfg.ema_beta)
    nodes, real = {}, torch.autograd.grad

    def walking(outputs, inputs, *a, **k):
        seen, stack = set(), [outputs.grad_fn]
        while stack:
            fn = stack.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            nodes[fn.name()] = nodes.get(fn.name(), 0) + 1
            stack.extend(f for f, _ in fn.next_functions)
        return real(outputs, inputs, *a, **k)

    if walk:
        monkeypatch.setattr(torch.autograd, "grad", walking)
    with reproduce.record_grads() as grads:
        step(state, batch, init_random_vgg(1234, device="cpu"), cfg.lr_g, cfg.lr_d, [1.0, 10.0, 5.0, 1.0, 1.0])
    monkeypatch.setattr(torch.autograd, "grad", real)
    return reproduce.snapshot(state, grads), nodes


@pytest.fixture(scope="module")
def first_runs():
    """Step 1 of each configuration, its graphs walked: {config: (snapshot, nodes)}."""
    mp = pytest.MonkeyPatch()
    try:
        yield {config: _step1(config, mp, True) for config in CONFIGS}
    finally:
        mp.undo()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_step_graph_holds_no_backward_without_a_deterministic_form(first_runs, config):
    nodes = first_runs[config][1]
    assert not NO_DETERMINISTIC_FORM & set(nodes), config
    # each generator launch pads twice (enc0, the final conv), three launches in the G
    # loss's graph (2B, 2B, B), the first on real images, whose enc0 pad needs no node;
    # the D loss's graph has none (the fakes are detached)
    assert nodes.get("_ReflectPad2dBackward") == 5, (config, nodes.get("_ReflectPad2dBackward"))


def test_two_runs_of_step1_equal_to_the_bit(first_runs):
    mp = pytest.MonkeyPatch()
    try:
        again, _ = _step1("level1+pallas", mp, False)
    finally:
        mp.undo()
    compared, differ = reproduce.differences(first_runs["level1+pallas"][0], again)
    # 112 parameters (G 28 + 28, SE 14 + 14, D 14 + 14) x parameters, gradients, two
    # moments, and the G group's 84 EMA copies
    assert compared == 4 * 112 + 84
    assert not any(differ.values()), {k: v[:4] for k, v in differ.items() if v}
