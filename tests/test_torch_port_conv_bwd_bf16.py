"""Rows 23-24 in bf16: the port's fused conv backwards against the JAX package's.

The JAX package's bf16 train step runs ``conv3x3_vjp.conv3x3_bwd`` (row 23)
and ``conv3x3_adain_bwd`` (row 24) on bf16 operands with fp32 accumulation:
x and the taps in bf16, the unit's dy rounded to bf16 before the conv
backward (its padded slab is in x's type), dx in bf16, dW in fp32 cast to
w's type. Here the same numpy-seeded bf16 inputs at [2, 16, 16, 128], Co 128
and 256, go through ``jax.vjp`` of JAX's ``conv3x3_same``, ``relu_conv3x3``,
``conv3x3_adain`` and ``relu_conv3x3_adain`` (Pallas in interpret mode, as
``tests/test_conv_vjp.py`` runs them) and through the port's autograd
functions on the CPU, whose wrappers run the kernels' plain versions.

The units' backward reads what their forward saved: the conv output y (bf16)
and its statistics mu and r. The forward is the stock bf16 conv of each
framework, which rounds about 0.02% of y the other way (the two sum in other
orders) and so moves a channel's mu by up to 1.5e-5; through the rounding of
dy that moves 1.4-2% of dx by a bf16 step or more. So the unit cases hand the
port's autograd function JAX's saved (y, mu, r), and hold its backward
alone; ``tests/test_torch_port_train_ops.py`` holds the forward against
JAX's.

Bar, the one for bf16 sites: fewer than 0.5% of the elements of dx, dW,
dgamma and dbeta differ from JAX's bf16 values, and each of those by at most
2 bf16 steps or 1e-3 x max|JAX|. The two sum in other orders in fp32, so a
sum near a rounding boundary of bf16 may round the other way: measured here,
at most 0.02% of an output differ. Each case also checks that the wrapper
receives bf16 tensors: the kernels' bf16 entries are what the card runs (the
card tests of ``tests/test_torch_port_train_cuda.py`` hold those entries
against these plain versions, and check that a mixed-dtype call raises).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msig_tpu.ops import conv3x3_vjp as jcv
from msig_tpu_torch.ops import conv3x3_vjp as cv

B, SIDE, C = 2, 16, 128
MAX_SHARE, MAX_STEPS, ATOL_OF_MAX = 0.005, 2, 1e-3
FUNCTIONS = ("conv3x3_same", "relu_conv3x3", "conv3x3_adain", "relu_conv3x3_adain")


def _inputs(co: int, seed: int):
    """x and the cotangent g ~ N(0, 1), w ~ U(+-1/sqrt(9 C)), gamma ~ N(1, 0.5),
    beta ~ N(0, 0.5), all rounded to bf16 (as float32 numpy arrays)."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa: E731
    x = bf(rng.normal(0, 1, (B, SIDE, SIDE, C)))
    w = bf(rng.uniform(-1, 1, (3, 3, C, co)) / np.sqrt(9 * C))
    gamma, beta = bf(rng.normal(1.0, 0.5, (B, co))), bf(rng.normal(0.0, 0.5, (B, co)))
    g = bf(rng.normal(0, 1, (B, SIDE, SIDE, co)))
    return x, w, gamma, beta, g


def _torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def bf16_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance of two bf16 tensors in bf16 steps (units of the last place; +0 and -0 coincide)."""
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits >= 0, bits, -(bits & 0x7FFF))
    return (ordered(a) - ordered(b)).abs()


def hold_bf16(got: torch.Tensor, want: torch.Tensor, name: str) -> float:
    """The bf16 bar; returns the share of elements that differ."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape, name
    steps = bf16_steps(got, want)
    share = float((steps > 0).double().mean())
    far = (steps > MAX_STEPS) & ((got.float() - want.float()).abs()
                                 > ATOL_OF_MAX * float(want.float().abs().max()))
    assert share < MAX_SHARE, f"{name}: {100 * share:.3f}% of the elements differ from JAX's"
    assert not bool(far.any()), (f"{name}: {int(far.sum())} elements beyond {MAX_STEPS} bf16 "
                                 f"steps and 1e-3 x max|JAX| (worst {int(steps.max())} steps)")
    return share


@pytest.mark.parametrize("co", [128, 256])
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_bf16_backward_matches_jax(monkeypatch, fn, co):
    x, w, gamma, beta, g = _inputs(co, seed=co + FUNCTIONS.index(fn))
    unit = fn.endswith("_adain")
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in ((x, w, gamma, beta) if unit else (x, w))]
    _, vjp = jax.vjp(getattr(jcv, fn), *jargs)
    want = [_torch(v).to(torch.bfloat16) for v in vjp(jnp.asarray(g, jnp.bfloat16))]
    if unit:  # the forward saves JAX's y, mu and r (see the module's docstring)
        _, saved = jcv._adain_unit_fwd_impl(*jargs, fn.startswith("relu"))
        port_fwd = cv._adain_unit_fwd_impl
        monkeypatch.setattr(cv, "_adain_unit_fwd_impl", lambda *a: (
            port_fwd(*a)[0], (_torch(saved[0]).to(torch.bfloat16), *map(_torch, saved[1:]))))

    wrapper = cv.ADAIN_BWD if unit else cv.BWD
    received, real = [], getattr(cv, wrapper)

    def spy(*args, **kwargs):
        received.append([a.dtype for a in args if isinstance(a, torch.Tensor)])
        return real(*args, **kwargs)

    monkeypatch.setattr(cv, wrapper, spy)
    targs = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
             for a in ((x, w, gamma, beta) if unit else (x, w))]
    z = getattr(cv, fn)(*targs)
    assert z.dtype == torch.bfloat16
    z.backward(torch.from_numpy(g).to(torch.bfloat16))
    names = ("dx", "dW", "dgamma", "dbeta")
    shares = {name: hold_bf16(t.grad, ref, f"{fn} Co {co} {name}")
              for name, t, ref in zip(names, targs, want)}
    print(f"{fn} Co {co}: share differing from JAX's {shares}")
    # x, w and dy (or x, w, y and g) in bf16; mu, r and gamma in fp32, as JAX casts them
    want_types = ([torch.bfloat16] * 3 + [torch.float32] * 3 + [torch.bfloat16] if unit
                  else [torch.bfloat16] * 3)
    assert received == [want_types]


def test_the_bar_sees_level_two_cast_up_to_fp32():
    """What the bar guards against: the unit's backward on its inputs cast up to
    fp32, so that dy is not rounded to bf16 where JAX rounds it, moves far
    more than 0.5% of dx (from JAX's saved tensors, as above)."""
    x, w, gamma, beta, g = _inputs(256, seed=256 + 3)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (x, w, gamma, beta)]
    _, vjp = jax.vjp(jcv.relu_conv3x3_adain, *jargs)
    want = _torch(vjp(jnp.asarray(g, jnp.bfloat16))[0]).to(torch.bfloat16)
    _, (y, mu, r) = jcv._adain_unit_fwd_impl(*jargs, True)
    dx = cv.conv3x3_adain_bwd_plain(_torch(x), _torch(w), _torch(y), _torch(mu), _torch(r),
                                    _torch(gamma), _torch(g), relu_input=True)[0]
    with pytest.raises(AssertionError, match="differ from JAX's"):
        hold_bf16(dx.to(torch.bfloat16), want, "dx cast up")
