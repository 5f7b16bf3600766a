"""The training kernels of msig_tpu_torch against their plain PyTorch versions, on the card.

Rows 22-24 of the kernel table in PERF.md: the fused AdaIN forward and
backward (``ops/adain_pallas.py``), the 3x3 conv backward (``conv3x3_bwd``)
and the conv + IN + AdaIN unit backward (``conv3x3_adain_bwd``), at the trunk
shapes of a 256² train step ([8, 64, 64, 256] and [4, 64, 64, 256]), a small
one, and two whose B*H*W is no multiple of the kernels' 128-pixel tile
([1, 24, 24, 256], the trunk of a 96² input, and [3, 8, 8, 256]). Needs an
NVIDIA GPU and nvcc; skipped without a card. Imports neither JAX nor msig_tpu:

    python -m pytest --noconftest tests/test_torch_port_train_cuda.py

Bars, fp32 with TF32 off: every output within rtol 1e-4 and atol 1e-5 x
max|plain| (the two sum in other orders); dx exactly 0 under the relu mask;
dgamma and dbeta within rtol 1e-5 and atol 1e-6 x max|plain|; dW bit-identical
over two calls (its reduction is deterministic). The conv kernels compute in
3xTF32 on the tensor cores: a case with x x 1e3 and dy x 1e-3 holds them where
the small halves of the split carry the digits that one TF32 pass would lose.
"""

import numpy as np
import pytest
import torch

from msig_tpu_torch.ops import adain_pallas as ap
from msig_tpu_torch.ops import conv3x3_vjp as cv

SHAPES = [(2, 8, 256), (4, 64, 256), (8, 64, 256), (1, 24, 256), (3, 8, 256)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, name, rtol=1e-4, atol_rel=1e-5):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    scale = float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    print(f"{name}: max abs err {err:.3e}, max|plain| {scale:.3e}")
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol_rel * scale, msg=name)


def _unit_inputs(b, side, c, dev, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    x = t(rng.normal(0, 1, (b, side, side, c)))
    w = t(rng.uniform(-1, 1, (3, 3, c, c)) / np.sqrt(9 * c))
    gamma = t(rng.normal(1.0, 0.5, (b, c)))
    g = t(rng.normal(0, 1, (b, side, side, c)))
    return x, w, gamma, g


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,c", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adain_kernels_match_plain(cuda_device, b, side, c, dtype):
    rng = np.random.default_rng(side + b)
    x = torch.from_numpy(rng.normal(0.3, 2.0, (b, side * side, c)).astype(np.float32))
    x = x.to(cuda_device, dtype)
    gamma, beta = (torch.from_numpy(rng.normal(m, 0.5, (b, c)).astype(np.float32)).to(cuda_device)
                   for m in (1.0, 0.0))
    dy = torch.from_numpy(rng.normal(0, 1, (b, side * side, c)).astype(np.float32))
    dy = dy.to(cuda_device, dtype)
    before = dict(ap.LAUNCHES)
    got = ap.adain_fwd(x, gamma, beta)
    want = ap.adain_fwd_plain(x, gamma, beta)
    tol = {} if dtype == torch.float32 else dict(rtol=2e-2, atol_rel=2e-2)  # one bf16 rounding
    for name, g_, w_ in zip(("y", "mean", "rstd"), got, want):
        _close(g_, w_, f"fwd {name}", **(tol if name == "y" else {}))
    gb = ap.adain_bwd(x, gamma, want[1], want[2], dy)
    wb = ap.adain_bwd_plain(x, gamma, want[1], want[2], dy)
    _close(gb[0], wb[0], "bwd dx", **tol)
    _close(gb[1], wb[1], "bwd dgamma", rtol=1e-5, atol_rel=1e-6)
    _close(gb[2], wb[2], "bwd dbeta", rtol=1e-5, atol_rel=1e-6)
    assert ap.LAUNCHES[ap.FWD] == before[ap.FWD] + 1
    assert ap.LAUNCHES[ap.BWD] == before[ap.BWD] + 1


# Row 22 on a thread-block cluster a (sample, 32 channels) (csrc/in_norm.cuh,
# ap.plan): the train step's trunk [8|4, 4096, 256] (R = 8), the TPU kernel's
# largest fp32 slab S = 16,384, a last CTA with a row fewer (S = 999) and a
# cluster of one (S = 40). The partials meet in rank order: a second call
# gives the same bits.
@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c", [(8, 4096, 256), (4, 4096, 256), (1, 16384, 256),
                                   (2, 16384, 128), (2, 999, 256), (1, 40, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adain_cluster_kernels_match_plain_and_repeat_their_bits(cuda_device, b, s, c, dtype):
    rng = np.random.default_rng(s + c + b)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)  # noqa: E731
    x, dy = t(rng.normal(0.3, 2.0, (b, s, c))).to(dtype), t(rng.normal(0, 1, (b, s, c))).to(dtype)
    gamma, beta = t(rng.normal(1.0, 0.5, (b, c))), t(rng.normal(0.0, 0.5, (b, c)))
    for backward in (False, True):
        p = ap.plan(s, c)
        assert ap.max_active_clusters(p, s, c, dtype, backward) > 0
        print(f"[{b}, {s}, {c}] {dtype} {'bwd' if backward else 'fwd'}: {p}")
    tol = {} if dtype == torch.float32 else dict(rtol=2e-2, atol_rel=2e-2)  # one bf16 rounding
    got, again = ap.adain_fwd(x, gamma, beta), ap.adain_fwd(x, gamma, beta)
    want = ap.adain_fwd_plain(x, gamma, beta)
    for name, g_, a_, w_ in zip(("y", "mean", "rstd"), got, again, want):
        _close(g_, w_, f"fwd {name}", **(tol if name == "y" else {}))
        assert torch.equal(g_, a_), f"fwd {name}: a second call gives the same bits"
    got = ap.adain_bwd(x, gamma, want[1], want[2], dy)
    again = ap.adain_bwd(x, gamma, want[1], want[2], dy)
    wb = ap.adain_bwd_plain(x, gamma, want[1], want[2], dy)
    _close(got[0], wb[0], "bwd dx", **tol)
    _close(got[1], wb[1], "bwd dgamma", rtol=1e-5, atol_rel=1e-6)
    _close(got[2], wb[2], "bwd dbeta", rtol=1e-5, atol_rel=1e-6)
    assert all(torch.equal(g_, a_) for g_, a_ in zip(got, again)), "bwd: the same bits twice"


@pytest.mark.cuda
def test_conv3x3_adain_bwd_runs_row_22s_backward(cuda_device):
    """Row 24's IN part is row 22's backward on the saved conv output: the
    same launch, so its dgamma and dbeta equal adain_bwd's to the bit."""
    x, w, gamma, g = _unit_inputs(4, 64, 256, cuda_device, seed=11)
    _, (y, mu, r) = cv._adain_unit_fwd_impl(x, w, gamma, torch.zeros_like(gamma), False)
    _, _, dgamma, dbeta = cv.conv3x3_adain_bwd(x, w, y, mu, r, gamma, g)
    _, dg, db = ap.adain_bwd(y.reshape(4, 4096, 256), gamma, mu, r, g.reshape(4, 4096, 256))
    assert torch.equal(dgamma, dg) and torch.equal(dbeta, db)


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,c", SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_bwd_matches_plain(cuda_device, b, side, c, relu):
    x, w, _, dy = _unit_inputs(b, side, c, cuda_device, seed=side + b)
    before = cv.LAUNCHES[cv.BWD]
    dx, dw = cv.conv3x3_bwd(x, w, dy, relu_input=relu)
    assert cv.LAUNCHES[cv.BWD] == before + 1
    dx_p, dw_p = cv.conv3x3_bwd_plain(x, w, dy, relu_input=relu)
    _close(dx, dx_p, "dx")
    _close(dw, dw_p, "dw")
    if relu:
        assert bool((dx[x <= 0] == 0).all()), "dx must be exactly 0 where x <= 0"
    dx2, dw2 = cv.conv3x3_bwd(x, w, dy, relu_input=relu)
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2), "two calls must give the same bits"


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_bwd_matches_plain_at_large_and_small_magnitudes(cuda_device, relu):
    x, w, _, dy = _unit_inputs(3, 24, 256, cuda_device, seed=11)
    x, dy = x * 1e3, dy * 1e-3
    dx, dw = cv.conv3x3_bwd(x, w, dy, relu_input=relu)
    dx_p, dw_p = cv.conv3x3_bwd_plain(x, w, dy, relu_input=relu)
    _close(dx, dx_p, "dx")
    _close(dw, dw_p, "dw")
    if relu:
        assert bool((dx[x <= 0] == 0).all()), "dx must be exactly 0 where x <= 0"


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
def test_conv_kernels_split_a_k_longer_than_a_tile_takes(cuda_device, relu):
    """Co = 384: dx's K = 9 * 384 = 3456 runs as two parts added in order."""
    rng = np.random.default_rng(21)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)  # noqa: E731
    b, side, c, co = 3, 8, 128, 384
    x = t(rng.normal(0, 1, (b, side, side, c)))
    w = t(rng.uniform(-1, 1, (3, 3, c, co)) / np.sqrt(9 * c))
    g = t(rng.normal(0, 1, (b, side, side, co)))
    gamma, beta = t(rng.normal(1.0, 0.5, (b, co))), t(np.zeros((b, co)))
    dx, dw = cv.conv3x3_bwd(x, w, g, relu_input=relu)
    dx_p, dw_p = cv.conv3x3_bwd_plain(x, w, g, relu_input=relu)
    _close(dx, dx_p, "dx")
    _close(dw, dw_p, "dw")
    if relu:
        assert bool((dx[x <= 0] == 0).all()), "dx must be exactly 0 where x <= 0"
    assert all(torch.equal(a, b_) for a, b_ in zip((dx, dw), cv.conv3x3_bwd(x, w, g, relu)))
    _, (y, mu, r) = cv._adain_unit_fwd_impl(x, w, gamma, beta, relu)
    got = cv.conv3x3_adain_bwd(x, w, y, mu, r, gamma, g, relu_input=relu)
    want = cv.conv3x3_adain_bwd_plain(x, w, y, mu, r, gamma, g, relu_input=relu)
    for name, a, b_ in zip(("dx", "dw"), got, want):
        _close(a, b_, name)
    _close(got[2], want[2], "dgamma", rtol=1e-5, atol_rel=1e-6)
    _close(got[3], want[3], "dbeta", rtol=1e-5, atol_rel=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,c", SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_adain_bwd_matches_plain(cuda_device, b, side, c, relu):
    x, w, gamma, g = _unit_inputs(b, side, c, cuda_device, seed=3 * side + b)
    beta = torch.zeros_like(gamma)
    _, (y, mu, r) = cv._adain_unit_fwd_impl(x, w, gamma, beta, relu)
    before = cv.LAUNCHES[cv.ADAIN_BWD]
    got = cv.conv3x3_adain_bwd(x, w, y, mu, r, gamma, g, relu_input=relu)
    assert cv.LAUNCHES[cv.ADAIN_BWD] == before + 1
    want = cv.conv3x3_adain_bwd_plain(x, w, y, mu, r, gamma, g, relu_input=relu)
    _close(got[0], want[0], "dx")
    _close(got[1], want[1], "dw")
    _close(got[2], want[2], "dgamma", rtol=1e-5, atol_rel=1e-6)
    _close(got[3], want[3], "dbeta", rtol=1e-5, atol_rel=1e-6)
    if relu:
        assert bool((got[0][x <= 0] == 0).all())
    again = cv.conv3x3_adain_bwd(x, w, y, mu, r, gamma, g, relu_input=relu)
    assert torch.equal(got[1], again[1]), "dW must be bit-identical over two calls"


def _bf16_steps(a, b):
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits >= 0, bits, -(bits & 0x7FFF))
    return (ordered(a) - ordered(b)).abs()


def _bf16_bar(got, want, name):
    """The bar of the bf16 entries (rounded to bf16 where fp32): fewer than 0.5%
    of the elements differ, each by at most 2 bf16 steps or 1e-3 x max|plain|."""
    assert got.dtype == want.dtype and got.shape == want.shape, name
    got, want = got.to(torch.bfloat16), want.to(torch.bfloat16)
    steps = _bf16_steps(got, want)
    share = float((steps > 0).double().mean())
    far = (steps > 2) & ((got.float() - want.float()).abs() > 1e-3 * float(want.float().abs().max()))
    print(f"{name}: {share:.2e} of the elements differ, max {int(steps.max())} steps")
    assert share < 5e-3 and not bool(far.any()), name


def _bf16_unit(b, side, c, dev, seed, co=None):
    rng = np.random.default_rng(seed)
    co = co or c
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    x = t(rng.normal(0, 1, (b, side, side, c))).bfloat16()
    w = t(rng.uniform(-1, 1, (3, 3, c, co)) / np.sqrt(9 * c)).bfloat16()
    gamma, beta = t(rng.normal(1.0, 0.5, (b, co))), t(rng.normal(0.0, 0.5, (b, co)))
    g = t(rng.normal(0, 1, (b, side, side, co))).bfloat16()
    return x, w, gamma, beta, g


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,c,co", [s + (s[2],) for s in SHAPES] + [(3, 8, 128, 384)])
@pytest.mark.parametrize("relu", [False, True])
def test_conv_kernels_bf16_entries_match_plain(cuda_device, b, side, c, co, relu):
    """The bf16 entries (bf16 x, dy or y and g, and taps; fp32 accumulation): dx
    in bf16, dW, dgamma and dbeta in fp32, within the bf16 bar of the plain
    versions on the same bf16 inputs, one launch a call, the same bits over two
    calls; Co = 384 gives a dx item a K of 9 * 384."""
    x, w, gamma, beta, g = _bf16_unit(b, side, c, cuda_device, seed=5 * side + b + co, co=co)
    before = cv.LAUNCHES[cv.BWD]
    dx, dw = cv.conv3x3_bwd(x, w, g, relu_input=relu)
    assert cv.LAUNCHES[cv.BWD] == before + 1
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    dx_p, dw_p = cv.conv3x3_bwd_plain(x, w, g, relu_input=relu)
    _bf16_bar(dx, dx_p, "dx")
    _bf16_bar(dw, dw_p, "dw")
    if relu:
        assert bool((dx[x <= 0] == 0).all()), "dx must be exactly 0 where x <= 0"
    assert all(torch.equal(a, b_) for a, b_ in zip((dx, dw), cv.conv3x3_bwd(x, w, g, relu)))
    _, (y, mu, r) = cv._adain_unit_fwd_impl(x, w, gamma, beta, relu)
    before = cv.LAUNCHES[cv.ADAIN_BWD]
    got = cv.conv3x3_adain_bwd(x, w, y, mu, r, gamma, g, relu_input=relu)
    assert cv.LAUNCHES[cv.ADAIN_BWD] == before + 1
    want = cv.conv3x3_adain_bwd_plain(x, w, y, mu, r, gamma, g, relu_input=relu)
    assert [t.dtype for t in got] == [torch.bfloat16] + [torch.float32] * 3
    for name, a, b_ in zip(("dx", "dw", "dgamma", "dbeta"), got, want):
        _bf16_bar(a, b_, name)
    again = cv.conv3x3_adain_bwd(x, w, y, mu, r, gamma, g, relu_input=relu)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again)), "two calls, the same bits"


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
def test_bf16_core_over_several_chunks_of_an_odd_map(cuda_device, relu):
    """The wgmma bf16 core at [2, 49, 49, 128] -> 256: 4,802 pixels, a map
    width that neither divides a 128-pixel tile nor is divided by it, dW's K
    in four chunks added in order (``bf16_plan``), C != Co; within the bf16
    bar of the plain version, the same bits over two calls."""
    x, w, _, _, g = _bf16_unit(2, 49, 128, cuda_device, seed=49 + relu, co=256)
    assert cv.bf16_plan(2, 49, 49, 128, 256)["chunks"] == 4
    dx, dw = cv.conv3x3_bwd(x, w, g, relu_input=relu)
    dx_p, dw_p = cv.conv3x3_bwd_plain(x, w, g, relu_input=relu)
    _bf16_bar(dx, dx_p, "dx")
    _bf16_bar(dw, dw_p, "dw")
    if relu:
        assert bool((dx[x <= 0] == 0).all()), "dx must be exactly 0 where x <= 0"
    assert all(torch.equal(a, b_) for a, b_ in zip((dx, dw), cv.conv3x3_bwd(x, w, g, relu)))


@pytest.mark.cuda
def test_wrappers_reject_mixed_dtypes(cuda_device):
    """x, w and dy (or y and g) of one type, mu, r and gamma fp32: anything else
    raises (a bf16 tensor is never cast to fp32 quietly); the autograd
    functions cast w to x's type themselves and launch the bf16 entry."""
    x, w, gamma, beta, g = _bf16_unit(2, 8, 256, cuda_device, seed=3)
    for args in ((x, w.float(), g), (x, w, g.float()), (x.float(), w, g.float())):
        with pytest.raises(ValueError, match="must be"):
            cv.conv3x3_bwd(*args)
    _, (y, mu, r) = cv._adain_unit_fwd_impl(x, w, gamma, beta, False)
    for args in ((x, w, y.float(), mu, r, gamma, g), (x, w, y, mu, r, gamma.bfloat16(), g),
                 (x, w, y, mu, r, gamma, g.float())):
        with pytest.raises(ValueError, match="must be"):
            cv.conv3x3_adain_bwd(*args)
    cv.reset_launch_counts()
    xg, wg = x.clone().requires_grad_(), w.float().requires_grad_()
    cv.relu_conv3x3(xg, wg).backward(g)
    assert cv.LAUNCHES[cv.BWD] == 1 and xg.grad.dtype == torch.bfloat16
    assert wg.grad.dtype == torch.float32


@pytest.mark.cuda
def test_autograd_functions_launch_their_kernels(cuda_device):
    x, w, gamma, g = _unit_inputs(2, 8, 256, cuda_device, seed=7)
    beta = torch.zeros_like(gamma)
    x, w, gamma, beta = (t.requires_grad_() for t in (x, w, gamma, beta))
    cv.reset_launch_counts()
    ap.reset_launch_counts()
    z = cv.relu_conv3x3_adain(x, w, gamma, beta)
    z.backward(g)
    assert cv.LAUNCHES == {cv.BWD: 0, cv.ADAIN_BWD: 1}
    y = ap.adain_pallas(cv.conv3x3_same(x, w), gamma, beta)
    y.backward(g)
    assert cv.LAUNCHES == {cv.BWD: 1, cv.ADAIN_BWD: 1}
    assert ap.LAUNCHES == {ap.FWD: 1, ap.BWD: 1}


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x, w, gamma, g = _unit_inputs(2, 8, 256, cuda_device, seed=1)
    with pytest.raises(ValueError, match="float32"):
        cv.conv3x3_bwd(x.double(), w, g)
    with pytest.raises(ValueError, match="contiguous"):
        cv.conv3x3_bwd(x, w, g.transpose(1, 2))
    with pytest.raises(ValueError, match="multiples of 128"):
        cv.conv3x3_bwd(x[..., :64].contiguous(), w[:, :, :64].contiguous(), g)
    # B*H*W needs no multiple of 128: the kernels mask the ragged pixel edge
    xr, gr = x[:1, :3, :5].contiguous(), g[:1, :3, :5].contiguous()
    dx, dw = cv.conv3x3_bwd(xr, w, gr)
    dx_p, dw_p = cv.conv3x3_bwd_plain(xr, w, gr)
    _close(dx, dx_p, "dx [1, 3, 5, 256]")
    _close(dw, dw_p, "dw [1, 3, 5, 256]")
    with pytest.raises(ValueError, match="must be on"):
        cv.conv3x3_adain_bwd(x, w, g, gamma, gamma, gamma, g.cpu())  # g on the CPU
    with pytest.raises(ValueError):
        ap.adain_fwd(x.reshape(2, 64, 256).double(), gamma, gamma)
    with pytest.raises(ValueError, match="contiguous"):
        strided = g.reshape(2, 64, 256).transpose(1, 2).contiguous().transpose(1, 2)
        ap.adain_bwd(x.reshape(2, 64, 256), gamma, gamma, gamma, strided)


def _options_step(dev, remat, diversity: bool = False):
    """Step 1 of the port's train step at ``MSIG_CONV_VJP=1`` + ``use_pallas`` on the
    card (64², batch 2, 2 resblocks: trunk maps of 16x16x256): metrics and the
    launches of the three kernels of the route."""
    import os

    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.losses import init_random_vgg
    from msig_tpu_torch.train import create_train_state, make_train_step

    torch.backends.cudnn.deterministic = True
    cfg = TrainConfig(image_size=64, batch_size=2, n_residual_blocks=2, style_dim=64,
                      use_pallas=True, device="cuda")
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)).to(dev)
             for k in ("source", "target", "target2")}
    batch["source_domain"] = torch.zeros(2, dtype=torch.int32, device=dev)
    batch["target_domain"] = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    old = os.environ.get("MSIG_CONV_VJP")
    os.environ["MSIG_CONV_VJP"] = "1"
    try:
        state = create_train_state(cfg, 3)
        ap.reset_launch_counts()
        cv.reset_launch_counts()
        met = make_train_step(cfg.ema_beta, remat=remat,
                              diversity_weight=1.0 if diversity else 0.0)(
            state, batch, init_random_vgg(1234, device="cuda"), 2e-4, 1e-4, [1, 10, 5, 1, 1])
        torch.cuda.synchronize()
    finally:
        if old is None:
            del os.environ["MSIG_CONV_VJP"]
        else:
            os.environ["MSIG_CONV_VJP"] = old
    counts = (ap.LAUNCHES[ap.FWD], ap.LAUNCHES[ap.BWD], cv.LAUNCHES["conv3x3_bwd"])
    return {k: float(v) for k, v in met.items()}, counts


@pytest.mark.cuda
@pytest.mark.parametrize("remat,launches", [(True, 3), ("cycle", 2)])
def test_remat_on_the_card_equals_no_remat_and_recomputes_its_launches(cuda_device, remat,
                                                                        launches):
    """Remat at level 1 + use_pallas: the losses equal step 1 without remat to the
    bit (the recomputed forwards give the first ones' bits), the grad norms within
    rtol 1e-6; 4 AdaIN sites a generator launch, 3 launches: 12 backwards of each
    kernel, and at most 12 + 4 x (recomputed launches) forwards."""
    base, (f0, b0, c0) = _options_step(cuda_device, False)
    got, (f1, b1, c1) = _options_step(cuda_device, remat)
    assert (f0, b0, c0) == (12, 12, 12)
    assert 12 <= f1 <= 12 + 4 * launches and (b1, c1) == (12, 12), (f1, b1, c1)
    for k in base:
        if k.endswith("grad_norm"):
            assert abs(got[k] - base[k]) <= 1e-6 * abs(base[k]), k
        else:
            assert got[k] == base[k], k


@pytest.mark.cuda
def test_diversity_adds_a_generator_launch_on_the_card(cuda_device):
    _, counts = _options_step(cuda_device, False, diversity=True)
    assert counts == (16, 16, 16)
    _, (f, b, c) = _options_step(cuda_device, True, diversity=True)
    assert 16 <= f <= 32 and (b, c) == (16, 16)


def _step1_snapshot(dev, level: str, pallas: bool, dtype):
    """Step 1 from the seeded state (128², batch 4, 2 resblocks, 3 domains) at
    ``MSIG_CONV_VJP=level``: ``reproduce.snapshot`` of every parameter, gradient,
    Adam moment and EMA copy."""
    import os

    from msig_tpu_torch.config import TrainConfig
    from msig_tpu_torch.losses import init_random_vgg
    from msig_tpu_torch.train import create_train_state, make_train_step, reproduce

    torch.backends.cudnn.deterministic = True
    cfg = TrainConfig(image_size=128, batch_size=4, n_residual_blocks=2, style_dim=64,
                      use_pallas=pallas, device="cuda")
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (4, 128, 128, 3), dtype=np.uint8)).to(dev)
             for k in ("source", "target")}
    batch["source_domain"] = torch.zeros(4, dtype=torch.int32, device=dev)
    batch["target_domain"] = torch.tensor([1, 2, 1, 2], dtype=torch.int32, device=dev)
    old = os.environ.get("MSIG_CONV_VJP")
    os.environ["MSIG_CONV_VJP"] = level
    try:
        state = create_train_state(cfg, 3)
        with reproduce.record_grads() as grads:
            make_train_step(cfg.ema_beta, dtype)(
                state, batch, init_random_vgg(1234, device="cuda"), 2e-4, 1e-4, [1, 10, 5, 1, 1])
            torch.cuda.synchronize()
    finally:
        if old is None:
            del os.environ["MSIG_CONV_VJP"]
        else:
            os.environ["MSIG_CONV_VJP"] = old
    return reproduce.snapshot(state, grads)


@pytest.mark.cuda
@pytest.mark.parametrize("level,pallas", [("0", False), ("1", True), ("2", False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step1_twice_from_one_state_equal_to_the_bit(cuda_device, level, pallas, dtype):
    """The JAX step is a pure function; the port's gives the same bits twice too:
    every parameter, gradient, both Adam moments and the EMA after step 1."""
    from msig_tpu_torch.train import reproduce

    compared, differ = reproduce.differences(_step1_snapshot(cuda_device, level, pallas, dtype),
                                             _step1_snapshot(cuda_device, level, pallas, dtype))
    assert compared == 4 * 112 + 84
    assert not any(differ.values()), {k: (len(v), v[:4]) for k, v in differ.items() if v}


@pytest.mark.cuda
@pytest.mark.parametrize("c,dtype", [(3, torch.float32), (64, torch.float32), (64, torch.bfloat16)])
def test_reflect_pad_backward_repeats_its_bits(cuda_device, c, dtype):
    """``reflect_pad2d``'s backward at the generator's 7x7 convs (8 x 256², pad 3)
    gives the same bits twice, and ``F.pad(mode="reflect")``'s backward within the
    rounding of sums of at most four terms in the input's type (its atomics add in
    another order): fp32 rtol 1e-6; bf16 each sum rounds at most three times by
    half an ulp (2^-9) of a partial sum of at most 4 max|g|, so the two differ by at
    most 2 x 3 x 2^-9 x 4 max|g|."""
    import torch.nn.functional as F

    from msig_tpu_torch.models.layers import reflect_pad2d
    from msig_tpu_torch.train import reproduce

    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.normal(size=(8, c, 256, 256)).astype(np.float32))
    x = x.to(cuda_device, dtype).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(8, c, 262, 262)).astype(np.float32)).to(cuda_device, dtype)
    a, = torch.autograd.grad(reflect_pad2d(x, 3, 3), x, g)
    b, = torch.autograd.grad(reflect_pad2d(x, 3, 3), x, g)
    want, = torch.autograd.grad(F.pad(x, (3, 3, 3, 3), mode="reflect"), x, g)
    assert reproduce.bits_equal(a, b)
    bound = 2 * 3 * 2.0 ** -9 * 4 * float(g.abs().max())
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else dict(rtol=0.0, atol=bound)
    torch.testing.assert_close(a, want, **tol)
