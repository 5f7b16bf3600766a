"""The CUDA kernels of msig_tpu_torch against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skipped without a card. Imports neither JAX nor
msig_tpu, so it runs on a machine that has only PyTorch (with
``--noconftest``, since tests/conftest.py configures JAX):

    python -m pytest --noconftest tests/test_torch_port_cuda.py
"""

from unittest import mock

import numpy as np
import pytest
import torch

from msig_tpu_torch.ops import fused_conv_int8 as v1
from msig_tpu_torch.ops import fused_conv_int8_v2 as fc
from msig_tpu_torch.ops import fused_dec_int8 as fd
from msig_tpu_torch.ops import fused_enc_int8 as fe
from msig_tpu_torch.ops import fused_trunk_v3 as f3
from msig_tpu_torch.ops import int8_epilogue as ep
from msig_tpu_torch.ops import int8_epilogue_chunked as ec


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(b, side, c, dev, seed=0, one_sign=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, side, side, c), dtype=np.int8)
    w = rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8)
    if one_sign:  # gamma > 0 on the one-sign channels: below
        x, w = _one_sign(x, w)
    h = rng.normal(0, 1.5, (b, side, side, c)).astype(np.float32)
    hs = (np.abs(h).max(axis=(1, 2, 3)) / 127.0).astype(np.float32).reshape(b, 1)
    ht = h / hs.reshape(b, 1, 1, 1)
    hq = np.clip(np.round(ht), -127, 127)
    t = dict(x=x, gamma=rng.normal(1.0, 0.5, (b, c)).astype(np.float32),
             beta=rng.normal(0.0, 0.5, (b, c)).astype(np.float32), hs=hs, h=h,
             hq=hq.astype(np.int8),
             h2=np.clip(np.round((ht - hq) * 254.0), -127, 127).astype(np.int8))
    if one_sign:
        t["gamma"][:, :4] = np.abs(t["gamma"][:, :4]) + 0.5
    t = {k: torch.from_numpy(v).to(dev) for k, v in t.items()}
    t["w"] = fc.pack_weights(torch.from_numpy(w)).to(dev)
    t["hb"] = t.pop("h").to(torch.bfloat16)
    return t


def _assert_int8_close(got, want):
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    where = torch.nonzero(diff > 1)
    assert where.numel() == 0, f"{where.shape[0]} elements off by >1, first at {where[:4].tolist()}"
    assert float((diff > 0).float().mean()) < 0.01


def _assert_int8_apart(got, want):
    """The negation of _assert_int8_close: the two part by more than its bar."""
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    assert int(diff.max()) > 1 or float((diff > 0).float().mean()) >= 0.01


def _one_sign(x, w, k=4):
    """Non-negative input and non-positive weights for the first k output
    channels (the last axis of w): those channels' conv outputs are all
    negative, where v1's true extremes and v2's zero-masked ones set
    different requant amax."""
    w = w.copy()
    w[..., :k] = -np.abs(w[..., :k])
    return np.abs(x), w


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,c", [(1, 16, 128), (2, 16, 256), (8, 64, 256)])
def test_relu_site_kernel_matches_plain(cuda_device, b, side, c):
    t = _inputs(b, side, c, cuda_device)
    before = fc.LAUNCHES[fc.RELU_SITE]
    got = fc.conv3x3_adain_relu_requant(t["x"], t["w"], t["gamma"], t["beta"])
    assert fc.LAUNCHES[fc.RELU_SITE] == before + 1
    want = fc.conv3x3_adain_relu_requant_plain(t["x"], t["w"], t["gamma"], t["beta"])
    torch.cuda.synchronize()
    _assert_int8_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,c", [(1, 16, 128), (2, 16, 256), (8, 64, 256)])
def test_residual_site_kernel_matches_plain(cuda_device, b, side, c):
    t = _inputs(b, side, c, cuda_device, seed=1)
    got_q, got_s = fc.conv3x3_adain_residual_requant(t["x"], t["hq"], t["hs"], t["w"],
                                                     t["gamma"], t["beta"])
    want_q, want_s = fc.conv3x3_adain_residual_requant_plain(t["x"], t["hq"], t["hs"], t["w"],
                                                             t["gamma"], t["beta"])
    torch.cuda.synchronize()
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=0)
    _assert_int8_close(got_q, want_q)


# Rows 1-4 on wgmma (csrc/conv_i8_wgmma.cuh): the conv is exact integer
# arithmetic and the epilogues are the plain versions' operations, so the four
# sites equal their plain versions to the bit. (8, 128, 256) is a 512² input's
# trunk, (1, 96, 256) a 384² input's: W = 96, no 128-pixel tile a whole row;
# C = 384 takes three channel tiles of 128, and row 4's epilogue the channel
# index at every step (384 does not divide 4 * kEpiThreads).
WGMMA_SHAPES = [(1, 16, 128), (2, 16, 256), (8, 64, 256), (8, 128, 256), (1, 96, 256),
                (1, 16, 384)]
_WGMMA_SITES = (fc.RELU_SITE, fc.RESIDUAL_SITE, fc.HIFI_SITE, fc.HIFI2_SITE)


def _wgmma_sites(t, plain=False, **kw):
    """Rows 1-4 on t's inputs, their outputs in one tuple (the plain versions
    where ``plain``)."""
    tail = (t["w"], t["gamma"], t["beta"])
    args = {fc.RELU_SITE: (t["x"], *tail), fc.RESIDUAL_SITE: (t["x"], t["hq"], t["hs"], *tail),
            fc.HIFI_SITE: (t["x"], t["hb"], *tail),
            fc.HIFI2_SITE: (t["x"], t["hq"], t["h2"], t["hs"], *tail)}
    out = []
    for name in _WGMMA_SITES:
        got = getattr(fc, name + "_plain")(*args[name]) if plain else getattr(fc, name)(
            *args[name], **kw)
        out += list(got) if isinstance(got, tuple) else [got]
    return tuple(out)


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,c", WGMMA_SHAPES)
def test_wgmma_sites_equal_plain_to_the_bit(cuda_device, b, side, c):
    """Rows 1-4 with and without the K-major copy, twice: every output equal
    to the plain version's, and one launch counted per call."""
    t = _inputs(b, side, c, cuda_device, seed=8)
    wk = fc.pack_weights_kmajor(t["w"])
    want = _wgmma_sites(t, plain=True)
    for kw in ({"w_kmajor": wk}, {}, {"w_kmajor": wk}):
        before = dict(fc.LAUNCHES)
        got = _wgmma_sites(t, **kw)
        assert fc.LAUNCHES == {**before, **{k: before[k] + 1 for k in _WGMMA_SITES}}
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w), f"{int((g != w).sum())} of {g.numel()} differ ({kw})"


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(1, 128), (8, 256), (2, 256)])
def test_v1_residual_site_equals_plain_to_the_bit(cuda_device, b, c):
    """Row 20 runs row 2's entry on the 64x64 maps its gate admits; it makes
    the K-major copy itself."""
    t = _inputs(b, 64, c, cuda_device, seed=9)
    before = v1.LAUNCHES[v1.RESIDUAL_SITE]
    got = v1.conv3x3_adain_residual_requant(t["x"], t["hq"], t["hs"], t["w"], t["gamma"],
                                            t["beta"])
    assert v1.LAUNCHES[v1.RESIDUAL_SITE] == before + 1
    want = v1.conv3x3_adain_residual_requant_plain(t["x"], t["hq"], t["hs"], t["w"], t["gamma"],
                                                   t["beta"])
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_wgmma_sites_reject_a_bad_kmajor_copy(cuda_device):
    t = _inputs(1, 16, 128, cuda_device)
    wk = fc.pack_weights_kmajor(t["w"])
    bad = [("shape", wk[:, :-128].contiguous()), ("shape", t["w"]), ("int8", wk.to(torch.int32)),
           ("CUDA tensor", wk.cpu()), ("contiguous", t["w"].t())]
    tail = (t["w"], t["gamma"], t["beta"])
    for match, w_kmajor in bad:
        with pytest.raises(ValueError, match=match):
            fc.conv3x3_adain_relu_requant(t["x"], *tail, w_kmajor=w_kmajor)
        with pytest.raises(ValueError):
            fc.conv3x3_adain_residual_requant(t["x"], t["hq"], t["hs"], *tail, w_kmajor=w_kmajor)
        with pytest.raises(ValueError, match=match):
            fc.conv3x3_adain_residual_hifi(t["x"], t["hb"], *tail, w_kmajor=w_kmajor)
        with pytest.raises(ValueError, match=match):
            fc.conv3x3_adain_residual_hifi2(t["x"], t["hq"], t["h2"], t["hs"], *tail,
                                            w_kmajor=w_kmajor)


def _bf16_ulps(a, b):
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits >= 0, bits, -(bits & 0x7FFF))
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,c", [(1, 16, 128), (2, 16, 256), (8, 64, 256)])
def test_hifi_site_kernel_matches_plain(cuda_device, b, side, c):
    """bf16 carry: int8 within 1 step and the carry within 1 ulp, each on < 1%."""
    t = _inputs(b, side, c, cuda_device, seed=6)
    args = (t["x"], t["hb"], t["w"], t["gamma"], t["beta"])
    before = fc.LAUNCHES[fc.HIFI_SITE]
    got_q, got_h = fc.conv3x3_adain_residual_hifi(*args)
    assert fc.LAUNCHES[fc.HIFI_SITE] == before + 1
    want_q, want_h = fc.conv3x3_adain_residual_hifi_plain(*args)
    torch.cuda.synchronize()
    assert got_h.dtype == torch.bfloat16 and got_h.shape == t["x"].shape
    ulps = _bf16_ulps(got_h, want_h)
    assert int(ulps.max()) <= 1 and float((ulps > 0).float().mean()) < 0.01
    _assert_int8_close(got_q, want_q)


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,c", [(1, 16, 128), (2, 16, 256), (8, 64, 256)])
def test_hifi2_site_kernel_matches_plain(cuda_device, b, side, c):
    """Two-plane carry: both planes within 1 step on < 1%, the scale within rtol 1e-5."""
    t = _inputs(b, side, c, cuda_device, seed=7)
    args = (t["x"], t["hq"], t["h2"], t["hs"], t["w"], t["gamma"], t["beta"])
    before = fc.LAUNCHES[fc.HIFI2_SITE]
    got = fc.conv3x3_adain_residual_hifi2(*args)
    assert fc.LAUNCHES[fc.HIFI2_SITE] == before + 1
    want = fc.conv3x3_adain_residual_hifi2_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    _assert_int8_close(got[0], want[0])
    _assert_int8_close(got[1], want[1])


@pytest.mark.cuda
def test_sum_of_squares_past_one_int64_word(cuda_device):
    """The new limit of the statistics guard. Blocks of 16 x 16 pixels of +127
    and -127 under all-positive weights near 127 put nearly every output at
    +-9 * C * 127 * 127: a channel's sum of squares is about 2e19 > 2^63, both
    signs occur in every channel, and kernel and plain version still agree; a
    map past the two words is refused."""
    b, side, c = 1, 256, 128
    i = torch.arange(side, device=cuda_device) // 16
    sign = ((i[:, None] + i[None, :]) % 2 * 2 - 1).to(torch.int8)
    x = (127 * sign)[None, :, :, None].expand(b, side, side, c).contiguous()
    w = (127 - torch.arange(c, device=cuda_device) % 5).to(torch.int8).expand(9 * c, c).contiguous()
    gamma = torch.ones((b, c), device=cuda_device)
    beta = torch.zeros((b, c), device=cuda_device)
    y = fc.conv3x3_i64(x, w)
    assert int((y * y).double().sum(dim=(1, 2)).min()) > 2 ** 63
    got = fc.conv3x3_adain_relu_requant(x, w, gamma, beta)
    want = fc.conv3x3_adain_relu_requant_plain(x, w, gamma, beta)
    torch.cuda.synchronize()
    assert int(got.max()) == 127 and 0.3 < float((got > 100).float().mean()) < 0.6
    _assert_int8_close(got, want)
    with pytest.raises(ValueError, match="two-word statistics"):
        fc.conv3x3_adain_relu_requant(
            torch.empty((1, 8, 16, 3712), dtype=torch.int8, device=cuda_device),
            torch.empty((9 * 3712, 3712), dtype=torch.int8, device=cuda_device),
            torch.empty((1, 3712), device=cuda_device), torch.empty((1, 3712), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", fc.STAGES)
@pytest.mark.parametrize("b,side", [(1, 64), (2, 128), (8, 512)])
def test_staged_sites_kernel_matches_plain(cuda_device, b, side, stage):
    """enc0_hbm on a side² image and up1_s2d16_hbm onto a side² map, in both
    stagings, each against the plain version that narrows the same way; the
    last shape is the 512² path's."""
    e = _enc_inputs(b, side, cuda_device, seed=8)
    x, w = _convt_inputs(b, side // 2, 128, 64, cuda_device, seed=9)
    before = fe.LAUNCHES[fe.ENC0_HBM_SITE], fd.LAUNCHES[fd.UP1_HBM_SITE]
    got0 = fe.enc0_hbm(e["img"], e["w0"], stage=stage)
    got1, got_s = fd.up1_s2d16_hbm(x, w, stage=stage)
    assert (fe.LAUNCHES[fe.ENC0_HBM_SITE], fd.LAUNCHES[fd.UP1_HBM_SITE]) == \
        (before[0] + 1, before[1] + 1)
    want1, want_s = fd.up1_s2d16_hbm_plain(x, w, stage=stage)
    torch.cuda.synchronize()
    assert got0.shape == (b, side, side, 64) and got1.shape == (b, side, side, 64)
    _assert_int8_close(got0, fe.enc0_hbm_plain(e["img"], e["w0"], stage=stage))
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=0)
    _assert_int8_close(got1, want1)
    if stage == "int32":  # the arithmetic of the unstaged sites
        assert torch.equal(got0, fe.enc0_in_relu_requant(e["img"], e["w0"]))
        assert torch.equal(got1, fd.up1_s2d16(x, w)[0])


@pytest.mark.cuda
def test_new_sites_reject_bad_inputs(cuda_device):
    t = _inputs(1, 16, 128, cuda_device)
    tail = (t["w"], t["gamma"], t["beta"])
    with pytest.raises(ValueError, match="bfloat16"):
        fc.conv3x3_adain_residual_hifi(t["x"], t["hb"].float(), *tail)
    with pytest.raises(ValueError, match="shape"):
        fc.conv3x3_adain_residual_hifi(t["x"], t["hb"][:, :8].contiguous(), *tail)
    with pytest.raises(ValueError, match="int8"):
        fc.conv3x3_adain_residual_hifi2(t["x"], t["hq"], t["h2"].to(torch.int32), t["hs"], *tail)
    with pytest.raises(ValueError, match="shape"):
        fc.conv3x3_adain_residual_hifi2(t["x"], t["hq"], t["h2"], t["hs"].reshape(-1), *tail)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fc.conv3x3_adain_residual_hifi2(t["x"], t["hq"].cpu(), t["h2"], t["hs"], *tail)
    e = _enc_inputs(1, 64, cuda_device)
    x, w = _convt_inputs(1, 16, 64, 64, cuda_device)
    for stage in ("float16", "bf16", None):
        with pytest.raises(ValueError, match="stage must be one of"):
            fe.enc0_hbm(e["img"], e["w0"], stage=stage)
        with pytest.raises(ValueError, match="stage must be one of"):
            fd.up1_s2d16_hbm(x, w, stage=stage)
    with pytest.raises(ValueError, match="W % 16"):
        fe.enc0_hbm(e["img"][:, :, :56].contiguous(), e["w0"], stage="fp16")


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda_device):
    t = _inputs(1, 16, 128, cuda_device)
    with pytest.raises(ValueError, match="C % 128"):
        fc.conv3x3_adain_relu_requant(t["x"][..., :64].contiguous(), t["w"][:576, :64],
                                      t["gamma"][:, :64], t["beta"][:, :64])
    with pytest.raises(ValueError, match="contiguous"):
        fc.conv3x3_adain_relu_requant(t["x"].transpose(1, 2), t["w"], t["gamma"], t["beta"])
    with pytest.raises(ValueError, match="float32"):
        fc.conv3x3_adain_relu_requant(t["x"], t["w"], t["gamma"].double(), t["beta"])


def _convt_inputs(b, side, cin, cout, dev, seed=2):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-127, 128, (b, side, side, cin), dtype=np.int8)).to(dev)
    w = rng.integers(-127, 128, (4, 4, cin, cout), dtype=np.int8)
    return x, fc.pack_convt_weights_ps(torch.from_numpy(w), cin, cout).to(dev)


def _final7_inputs(b, side, dev, seed=3):
    rng = np.random.default_rng(seed)
    t = dict(x=rng.integers(0, 128, (b, side, side, 64), dtype=np.int8),
             w=rng.integers(-127, 128, (3, 64, 7, 7), dtype=np.int8),
             ws=rng.uniform(1e-4, 2e-4, 3).astype(np.float32),
             bias=rng.uniform(-0.3, 0.3, 3).astype(np.float32),
             inv_s=rng.uniform(0.02, 0.05, (b, 1)).astype(np.float32))
    return [torch.from_numpy(v).to(dev) for v in t.values()]


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,cin,cout", [(1, 16, 64, 64), (2, 16, 256, 128),
                                             (8, 64, 256, 128), (8, 128, 128, 64)])
def test_convt_sites_kernel_matches_plain(cuda_device, b, side, cin, cout):
    """up0 and up1 run one kernel and count apart; the last two shapes are theirs."""
    x, w = _convt_inputs(b, side, cin, cout, cuda_device)
    before = fc.LAUNCHES[fc.CONVT_SITE], fd.LAUNCHES[fd.UP1_SITE]
    got = [fc.convt4x4s2_in_relu_requant_ps(x, w), fd.up1_s2d16(x, w)]
    assert (fc.LAUNCHES[fc.CONVT_SITE], fd.LAUNCHES[fd.UP1_SITE]) == (before[0] + 1, before[1] + 1)
    want_q, want_s = fc.convt4x4s2_in_relu_requant_ps_plain(x, w)
    torch.cuda.synchronize()
    for got_q, got_s in got:
        assert got_q.shape == (b, 2 * side, 2 * side, cout) and got_s.shape == (b, 1)
        torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=0)
        _assert_int8_close(got_q, want_q)


# Rows 5, 12 and 13 on wgmma (csrc/conv_i8_wgmma.cuh, two passes): exact
# integer sums and the plain version's epilogue operations, so equal to the
# bit: up0's and up1's main-path shapes, a 512² input's up1 in both stagings,
# Cin 64 (two taps a 128-byte K block) and a 384² input's up0 (W = 96).
CONVT_WGMMA_SHAPES = [(8, 64, 256, 128, "int32"), (8, 128, 128, 64, "int32"),
                      (2, 256, 128, 64, "int32"), (2, 256, 128, 64, "fp16"),
                      (1, 16, 64, 64, "int32"), (1, 96, 256, 128, "int32")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,cin,cout,stage", CONVT_WGMMA_SHAPES)
def test_convt_wgmma_sites_equal_plain_to_the_bit(cuda_device, b, side, cin, cout, stage):
    """Rows 5, 12 and 13 (one entry) with and without the K-major copy: every
    output equal to the plain version's, one launch counted per call; the
    staged site in its staging, the other two (int32) where it is int32."""
    x, w = _convt_inputs(b, side, cin, cout, cuda_device, seed=11)
    wk = fc.pack_convt_weights_ps_kmajor(w)
    want = fd.up1_s2d16_hbm_plain(x, w, stage=stage)
    sites = [(lambda **kw: fd.up1_s2d16_hbm(x, w, stage=stage, **kw), fd.LAUNCHES,
              fd.UP1_HBM_SITE)]
    if stage == "int32":
        sites += [(lambda **kw: fc.convt4x4s2_in_relu_requant_ps(x, w, **kw), fc.LAUNCHES,
                   fc.CONVT_SITE),
                  (lambda **kw: fd.up1_s2d16(x, w, **kw), fd.LAUNCHES, fd.UP1_SITE)]
    for call, counts, name in sites:
        for kw in ({"w_kmajor": wk}, {}):
            before = counts[name]
            got = call(**kw)
            assert counts[name] == before + 1
            torch.cuda.synchronize()
            for g, v in zip(got, want):
                assert g.dtype == v.dtype and g.shape == v.shape
                assert torch.equal(g, v), f"{name}: {int((g != v).sum())} of {g.numel()} differ ({kw})"


@pytest.mark.cuda
def test_convt_sites_reject_a_bad_kmajor_copy(cuda_device):
    x, w = _convt_inputs(1, 16, 64, 64, cuda_device)
    wk = fc.pack_convt_weights_ps_kmajor(w)
    bad = [("shape", wk[:, :32].contiguous()), ("shape", w), ("int8", wk.to(torch.int32)),
           ("CUDA tensor", wk.cpu()), ("contiguous", wk.transpose(1, 2).contiguous().transpose(1, 2))]
    for match, w_kmajor in bad:
        with pytest.raises(ValueError, match=match):
            fc.convt4x4s2_in_relu_requant_ps(x, w, w_kmajor=w_kmajor)
        with pytest.raises(ValueError, match=match):
            fd.up1_s2d16(x, w, w_kmajor=w_kmajor)
        with pytest.raises(ValueError, match=match):
            fd.up1_s2d16_hbm(x, w, stage="fp16", w_kmajor=w_kmajor)


@pytest.mark.cuda
def test_convt_site_allocates_no_accumulator_scratch(cuda_device):
    """At up1's main-path shape, [8, 128, 128, 128] -> 64, a call's peak memory
    beyond its inputs (its int8 output, 33.5 MB, and the statistics block)
    stays below the 134 MB of the int32 accumulator scratch it no longer has."""
    x, w = _convt_inputs(8, 128, 128, 64, cuda_device)
    wk = fc.pack_convt_weights_ps_kmajor(w)
    fd.up1_s2d16(x, w, w_kmajor=wk)  # built and warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fd.up1_s2d16(x, w, w_kmajor=wk)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 8 * (4 * 128 * 128) * 64 * 4
    del out


# Row 14 on mma.sync (csrc/final7_tanh_u8.cu): exact integer sums and the
# plain version's epilogue operations, so equal to the bit, with the packed
# weights given (as the served decoder passes out_kernel_pk) and made by the
# wrapper; a 256² and a 512² input's maps among the shapes.
@pytest.mark.cuda
@pytest.mark.parametrize("b,side", [(1, 32), (2, 64), (8, 256), (2, 512)])
@pytest.mark.parametrize("packed", [True, False])
def test_final7_kernel_matches_plain(cuda_device, b, side, packed):
    args = _final7_inputs(b, side, cuda_device)
    kw = {"w_packed": fd.pack_final7_weights(args[1])} if packed else {}
    before = fd.LAUNCHES[fd.FINAL7_SITE]
    got = fd.final7_tanh_u8(*args, **kw)
    assert fd.LAUNCHES[fd.FINAL7_SITE] == before + 1
    want = fd.final7_tanh_u8_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and got.shape == (b, side, side, 3)
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) < 1e-3
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_decoder_wrappers_reject_bad_inputs(cuda_device):
    x, w = _convt_inputs(1, 16, 64, 64, cuda_device)
    with pytest.raises(ValueError, match="int8"):
        fc.convt4x4s2_in_relu_requant_ps(x.to(torch.int32), w)
    with pytest.raises(ValueError, match="shape"):
        fd.up1_s2d16(x, w[:-64])
    with pytest.raises(ValueError, match="CUDA tensor"):
        fd.up1_s2d16(x, w.cpu())
    with pytest.raises(ValueError, match="Cin % 64"):
        fc.convt4x4s2_in_relu_requant_ps(x[..., :32].contiguous(), w[:512])
    x7, w7, ws, bias, inv_s = _final7_inputs(1, 32, cuda_device)
    with pytest.raises(ValueError, match="C == 64"):
        fd.final7_tanh_u8(x7[..., :32].contiguous(), w7, ws, bias, inv_s)
    with pytest.raises(ValueError, match="float32"):
        fd.final7_tanh_u8(x7, w7, ws.double(), bias, inv_s)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fd.final7_tanh_u8(x7, w7.cpu(), ws, bias, inv_s)
    with pytest.raises(ValueError, match="contiguous"):
        fd.final7_tanh_u8(x7.transpose(1, 2), w7, ws, bias, inv_s)
    pk = fd.pack_final7_weights(w7)
    with pytest.raises(ValueError, match="w_packed must have shape"):
        fd.final7_tanh_u8(x7, w7, ws, bias, inv_s, w_packed=pk.reshape(42, 8, 32))
    with pytest.raises(ValueError, match="w_packed must be a CUDA tensor"):
        fd.final7_tanh_u8(x7, w7, ws, bias, inv_s, w_packed=pk.cpu())


def _enc_inputs(b, side, dev, seed=4):
    """enc0's image and weights, and 0..127 maps (ReLU outputs) for enc1 and enc2."""
    rng = np.random.default_rng(seed)
    t = dict(img=rng.integers(0, 256, (b, side, side, 3), dtype=np.uint8),
             x1=rng.integers(0, 128, (b, side, side, 64), dtype=np.int8),
             x2=rng.integers(0, 128, (b, side // 2, side // 2, 128), dtype=np.int8))
    t = {k: torch.from_numpy(v).to(dev) for k, v in t.items()}
    t["w0"] = fe.pack_enc0(torch.from_numpy(
        rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8))).to(dev)
    for name, cin in (("w1", 64), ("w2", 128)):
        w = rng.integers(-127, 128, (4, 4, cin, 2 * cin), dtype=np.int8)
        t[name] = fe.pack_conv4x4(torch.from_numpy(w)).to(dev)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("b,side", [(1, 64), (2, 128), (8, 256)])
def test_encoder_sites_kernel_matches_plain(cuda_device, b, side):
    """The last shape is the main path's: 256² images, batch 8."""
    t = _enc_inputs(b, side, cuda_device)
    before = dict(fe.LAUNCHES)
    got0 = fe.enc0_in_relu_requant(t["img"], t["w0"])
    got1 = fe.enc1_in_relu_requant(t["x1"], t["w1"])
    got2, got_s = fe.enc2_in_relu_requant(t["x2"], t["w2"])
    assert fe.LAUNCHES == {k: v + (k not in (fe.ENC0_HBM_SITE, fe.ENC1_I2C_SITE))
                           for k, v in before.items()}
    want2, want_s = fe.enc2_in_relu_requant_plain(t["x2"], t["w2"])
    torch.cuda.synchronize()
    assert got0.shape == (b, side, side, 64) and got1.shape == (b, side // 2, side // 2, 128)
    assert got2.shape == (b, side // 4, side // 4, 256) and got_s.shape == (b, 1)
    _assert_int8_close(got0, fe.enc0_in_relu_requant_plain(t["img"], t["w0"]))
    _assert_int8_close(got1, fe.enc1_in_relu_requant_plain(t["x1"], t["w1"]))
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=0)
    _assert_int8_close(got2, want2)


@pytest.mark.cuda
def test_enc0_kernel_reflects_a_map_that_is_not_square(cuda_device):
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.integers(0, 256, (2, 24, 48, 3), dtype=np.uint8)).to(cuda_device)
    w = fe.pack_enc0(torch.from_numpy(
        rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8))).to(cuda_device)
    got = fe.enc0_in_relu_requant(img, w)
    torch.cuda.synchronize()
    _assert_int8_close(got, fe.enc0_in_relu_requant_plain(img, w))


@pytest.mark.cuda
def test_encoder_wrappers_reject_bad_inputs(cuda_device):
    t = _enc_inputs(1, 64, cuda_device)
    with pytest.raises(ValueError, match="uint8"):
        fe.enc0_in_relu_requant(t["img"].to(torch.int8), t["w0"])
    with pytest.raises(ValueError, match="shape"):
        fe.enc0_in_relu_requant(t["img"], t["w0"][:147].contiguous())
    with pytest.raises(ValueError, match="H % 8"):
        fe.enc0_in_relu_requant(t["img"][:, :60].contiguous(), t["w0"])
    with pytest.raises(ValueError, match="contiguous"):
        fe.enc0_in_relu_requant(t["img"].transpose(1, 2), t["w0"])
    with pytest.raises(ValueError, match="CUDA tensor"):
        fe.enc1_in_relu_requant(t["x1"], t["w1"].cpu())
    with pytest.raises(ValueError, match="Cin % 64"):
        fe.enc1_in_relu_requant(t["x1"][..., :32].contiguous(), t["w1"][:512])
    with pytest.raises(ValueError, match="int8"):
        fe.enc2_in_relu_requant(t["x2"].to(torch.int32), t["w2"])
    with pytest.raises(ValueError, match="shape"):
        fe.enc2_in_relu_requant(t["x2"], t["w2"][:-128])


# Rows 7-10 (the encoder's two entries, each two passes with no accumulator
# in device memory): exact integer sums and the plain versions' epilogue
# operations, so equal to the bit. The 4x4/s2 site (b, side, cin, cout) at
# enc1's and enc2's shapes of a 256² and a 512² input and at Cout 64; enc0
# (b, h, w, stage) at a 256² and a 512² input in both stagings and on a map
# that is not square.
ENC_WGMMA_SHAPES = [(8, 256, 64, 128), (8, 128, 128, 256), (8, 512, 64, 128),
                    (8, 256, 128, 256), (2, 32, 64, 64)]
ENC0_SHAPES = [(8, 256, 256, "int32"), (8, 512, 512, "int32"), (8, 512, 512, "fp16"),
               (1, 64, 128, "int32"), (1, 64, 128, "fp16")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,cin,cout", ENC_WGMMA_SHAPES)
def test_conv4x4s2_sites_equal_plain_to_the_bit(cuda_device, b, side, cin, cout):
    """Rows 8-9 (one entry) with and without the K-major copy: the int8 map
    and the inverse scale equal the plain version's, one launch per call."""
    rng = np.random.default_rng(side + cin + cout)
    x = torch.from_numpy(rng.integers(0, 128, (b, side, side, cin), dtype=np.int8)).to(cuda_device)
    w = fe.pack_conv4x4(torch.from_numpy(
        rng.integers(-127, 128, (4, 4, cin, cout), dtype=np.int8))).to(cuda_device)
    wk = fe.pack_conv4x4_kmajor(w)
    want_q, want_s = fe.enc2_in_relu_requant_plain(x, w)
    for fn, name in ((fe.enc1_in_relu_requant, fe.ENC1_SITE),
                     (fe.enc2_in_relu_requant, fe.ENC2_SITE)):
        for kw in ({"w_kmajor": wk}, {}):
            before = fe.LAUNCHES[name]
            got = fn(x, w, **kw)
            assert fe.LAUNCHES[name] == before + 1
            torch.cuda.synchronize()
            got_q, got_s = got if isinstance(got, tuple) else (got, want_s)
            assert got_q.shape == want_q.shape and got_s.shape == want_s.shape
            assert torch.equal(got_q, want_q), f"{name}: {int((got_q != want_q).sum())} differ"
            assert torch.equal(got_s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,stage", ENC0_SHAPES)
def test_enc0_sites_equal_plain_to_the_bit(cuda_device, b, h, w, stage):
    """Rows 7 and 10 (one entry): the staged site in its staging, the 256²
    site where it is int32, one launch per call."""
    rng = np.random.default_rng(h + w)
    img = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(cuda_device)
    w0 = fe.pack_enc0(torch.from_numpy(
        rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8))).to(cuda_device)
    want = fe.enc0_hbm_plain(img, w0, stage=stage)
    calls = [(lambda: fe.enc0_hbm(img, w0, stage=stage), fe.ENC0_HBM_SITE)]
    if stage == "int32":
        calls.append((lambda: fe.enc0_in_relu_requant(img, w0), fe.ENC0_SITE))
    for call, name in calls:
        before = fe.LAUNCHES[name]
        got = call()
        assert fe.LAUNCHES[name] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"{name}: {int((got != want).sum())} of {got.numel()} differ"


@pytest.mark.cuda
def test_conv4x4s2_sites_reject_a_bad_kmajor_copy(cuda_device):
    t = _enc_inputs(1, 64, cuda_device)
    wk = fe.pack_conv4x4_kmajor(t["w1"])
    bad = [("shape", wk[:64].contiguous()), ("shape", t["w1"]), ("int8", wk.to(torch.int32)),
           ("CUDA tensor", wk.cpu()), ("contiguous", wk.t().contiguous().t())]
    for match, w_kmajor in bad:
        with pytest.raises(ValueError, match=match):
            fe.enc1_in_relu_requant(t["x1"], t["w1"], w_kmajor=w_kmajor)
        with pytest.raises(ValueError, match=match):
            fe.enc2_in_relu_requant(t["x1"], t["w1"], w_kmajor=w_kmajor)


@pytest.mark.cuda
def test_enc0_allocates_no_accumulator_scratch(cuda_device):
    """At a 512² input, [8, 512, 512, 3], a call's peak memory beyond its
    inputs stays below its output (134 MB), the statistics block and 64 MB,
    where the int32 accumulator alone took 537 MB."""
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.integers(0, 256, (8, 512, 512, 3), dtype=np.uint8)).to(cuda_device)
    w0 = fe.pack_enc0(torch.from_numpy(
        rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8))).to(cuda_device)
    for stage in fc.STAGES:
        fe.enc0_hbm(img, w0, stage=stage)  # built and warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fe.enc0_hbm(img, w0, stage=stage)
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base < \
            out.numel() + (5 * 8 * 64 + 8) * 8 + 64 * 2 ** 20
        del out


@pytest.mark.cuda
def test_int8_generator_serves_224(cuda_device):
    """Away from 256² and 512² the int8 generator runs the unfused chain
    throughout, as the JAX package does: a 224² input (a 56 x 56 trunk map,
    which no trunk kernel site takes) is served on the card with no kernel
    site launched, in uint8 and in the float32 default."""
    from msig_tpu_torch.infer import quantized as tq
    from msig_tpu_torch.models import StyleCycleGANGenerator

    torch.manual_seed(0)
    gen = StyleCycleGANGenerator(style_dim=64, n_residual_blocks=2)
    q = {k: v.to(cuda_device) for k, v in tq.quantize_generator_params(gen.state_dict(), 2).items()}
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)).to(cuda_device)
    style = torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32)).to(cuda_device)
    for mod in (fc, fd, fe):
        mod.reset_launch_counts()
    u8 = tq.quantized_generator_apply(q, img, style, n_res=2, out_dtype=torch.uint8)
    fl = tq.quantized_generator_apply(q, img, style, n_res=2)
    torch.cuda.synchronize()
    assert not any(v for mod in (fc, fd, fe) for v in mod.LAUNCHES.values())
    assert u8.dtype == torch.uint8 and u8.shape == (2, 224, 224, 3)
    assert fl.dtype == torch.float32 and fl.shape == (2, 224, 224, 3)
    assert bool(torch.isfinite(fl).all()) and float(fl.abs().max()) <= 1.0
    assert torch.equal(tq.to_out_dtype(fl, torch.uint8), u8)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_path(cuda_device):
    x, w = _convt_inputs(1, 16, 64, 64, cuda_device)
    x7 = _final7_inputs(1, 32, cuda_device)
    e = _enc_inputs(1, 64, cuda_device)
    t = _inputs(1, 16, 128, cuda_device)
    tail = (t["w"], t["gamma"], t["beta"])
    with mock.patch.object(fc, "convt4x4s2_in_relu_requant_ps_plain") as p0, \
            mock.patch.object(fd, "up1_s2d16_plain") as p1, \
            mock.patch.object(fd, "up1_s2d16_hbm_plain") as p1h, \
            mock.patch.object(fe, "enc0_hbm_plain") as e0h, \
            mock.patch.object(fc, "conv3x3_adain_residual_hifi_plain") as h1, \
            mock.patch.object(fc, "conv3x3_adain_residual_hifi2_plain") as h2, \
            mock.patch.object(fd, "final7_tanh_u8_plain") as p7, \
            mock.patch.object(fe, "enc0_in_relu_requant_plain") as e0, \
            mock.patch.object(fe, "enc1_in_relu_requant_plain") as e1, \
            mock.patch.object(fe, "enc2_in_relu_requant_plain") as e2:
        fc.convt4x4s2_in_relu_requant_ps(x, w)
        fd.up1_s2d16(x, w)
        fd.final7_tanh_u8(*x7)
        fe.enc0_in_relu_requant(e["img"], e["w0"])
        fe.enc1_in_relu_requant(e["x1"], e["w1"])
        fe.enc2_in_relu_requant(e["x2"], e["w2"])
        for stage in fc.STAGES:
            fd.up1_s2d16_hbm(x, w, stage=stage)
            fe.enc0_hbm(e["img"], e["w0"], stage=stage)
        fc.conv3x3_adain_residual_hifi(t["x"], t["hb"], *tail)
        fc.conv3x3_adain_residual_hifi2(t["x"], t["hq"], t["h2"], t["hs"], *tail)
        torch.cuda.synchronize()
    for plain in (p0, p1, p7, e0, e1, e2, p1h, e0h, h1, h2):
        plain.assert_not_called()


# ------------------------- the single-kernel trunk, the chunked epilogue, enc1 im2col


def _trunk_inputs(b, side, c, n, dev, seed=0):
    rng = np.random.default_rng(seed)
    ws = [fc.pack_weights(torch.from_numpy(rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8)))
          for _ in range(2 * n)]
    t = dict(x=rng.integers(-127, 128, (b, side, side, c), dtype=np.int8),
             hs=rng.uniform(0.5, 2.0, (b, 1)).astype(np.float32),
             g=rng.normal(1.0, 0.5, (b, 2 * n, c)).astype(np.float32),
             bb=rng.normal(0.0, 0.5, (b, 2 * n, c)).astype(np.float32))
    t = {k: torch.from_numpy(v).to(dev) for k, v in t.items()}
    return t["x"], t["hs"], torch.cat(ws).to(dev), t["g"], t["bb"], n


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,c,n", [(2, 16, 128, 1), (2, 16, 256, 3), (8, 64, 256, 8)])
def test_trunk_v3_kernel_matches_plain(cuda_device, b, side, c, n):
    """The last shape is the main path's (256², batch 8, 8 resblocks). The
    statistics are exact integers and the epilogues repeat the plain
    version's rounded operations, so the kernel equals it to the bit, with
    the K-major stack given or made by the wrapper, and a second call gives
    the same bits."""
    args = _trunk_inputs(b, side, c, n, cuda_device)
    before = f3.LAUNCHES[f3.SITE]
    got, got_s = f3.fused_trunk_blocks(*args)
    assert f3.LAUNCHES[f3.SITE] == before + 1 and f3.LAST_GRID[f3.SITE] > 0
    want, want_s = f3.fused_trunk_blocks_plain(*args)
    again, again_s = f3.fused_trunk_blocks(*args, w_packed=f3.stack_kmajor(args[2]))
    torch.cuda.synchronize()
    assert got.shape == (b, side, side, c) and got_s.shape == (b, 1)
    assert torch.equal(got_s, want_s) and torch.equal(got, want)
    assert torch.equal(again, got) and torch.equal(again_s, got_s)


def _device_kernels(fn) -> int:
    """Kernel launches on the card in one call of ``fn`` (torch.profiler). A
    trace that holds no device event at all lost its events (every caller
    launches at least one kernel): it is taken again, up to three times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if n:
            return n
    return 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lim", [((2, 64, 128), 3000), ((1, 1000, 384), 2 ** 31 - 1),
                                       ((8, 4096, 256), 2 ** 20), ((8, 4096, 256), 2 ** 31 - 1)])
def test_chunked_epilogue_kernel_matches_plain(cuda_device, shape, lim):
    """The last two shapes are the main path's, the last over the whole int32
    range; the second takes three channel tiles. Exact statistics and the
    plain version's rounded operations: equal to it to the bit, two calls
    alike, one kernel launch a call (no statistics block to fill)."""
    rng = np.random.default_rng(shape[1])
    b, _, c = shape
    x = torch.from_numpy(rng.integers(-lim, lim, shape, dtype=np.int64).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((b, c)).astype(np.float32))
    be = torch.from_numpy(rng.standard_normal((b, c)).astype(np.float32))
    x, g, be = x.to(cuda_device), g.to(cuda_device), be.to(cuda_device)
    before = ec.LAUNCHES[ec.SITE]
    got = ec.adain_relu_requant_chunked(x, g, be)
    again = ec.adain_relu_requant_chunked(x, g, be)
    assert ec.LAUNCHES[ec.SITE] == before + 2
    want = ec.adain_relu_requant_chunked_plain(x, g, be)
    torch.cuda.synchronize()
    assert got.shape == shape and got.dtype == torch.int8
    assert torch.equal(got, want) and torch.equal(again, got)
    assert _device_kernels(lambda: ec.adain_relu_requant_chunked(x, g, be)) == 1
    assert ec.cooperative_grid() >= torch.cuda.get_device_properties(
        cuda_device).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("b,side", [(1, 64), (2, 128), (8, 256)])
def test_enc1_im2col_kernel_matches_plain_and_enc1(cuda_device, b, side):
    """With four equal phase blocks, enc1's kernel to the bit; with four
    different ones, the plain version to the bit (each phase its own block),
    the K-major copy given or made by the wrapper; three launches a call
    (the memset, pass S, pass Q)."""
    t = _enc_inputs(b, side, cuda_device)
    w4 = t["w1"].repeat(4, 1).contiguous()
    before = fe.LAUNCHES[fe.ENC1_I2C_SITE]
    got = fe.enc1_in_relu_requant_im2col(t["x1"], w4)
    assert fe.LAUNCHES[fe.ENC1_I2C_SITE] == before + 1
    assert torch.equal(got, fe.enc1_in_relu_requant(t["x1"], t["w1"]))
    rng = np.random.default_rng(side)
    wq = torch.from_numpy(rng.integers(-127, 128, (4096, 128), dtype=np.int8)).to(cuda_device)
    want = fe.enc1_in_relu_requant_im2col_plain(t["x1"], wq)
    for kw in ({}, {"w_kmajor": fe.pack_enc1_im2col_kmajor(wq)}):
        got = fe.enc1_in_relu_requant_im2col(t["x1"], wq, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert not torch.equal(want, fe.enc1_in_relu_requant_im2col_plain(
        t["x1"], wq[:1024].repeat(4, 1).contiguous()))
    wk = fe.pack_enc1_im2col_kmajor(wq)
    assert _device_kernels(lambda: fe.enc1_in_relu_requant_im2col(t["x1"], wq, w_kmajor=wk)) == 3


@pytest.mark.cuda
def test_enc1_im2col_allocates_no_accumulator_scratch(cuda_device):
    """At enc1's main-path shape, [8, 256, 256, 64] -> 128, a call's peak
    memory beyond its inputs (its int8 output, 16.8 MB, the statistics block
    and the scale) stays below the 67 MB of the int32 accumulator scratch it
    no longer has."""
    t = _enc_inputs(8, 256, cuda_device)
    w4 = t["w1"].repeat(4, 1).contiguous()
    wk = fe.pack_enc1_im2col_kmajor(w4)
    fe.enc1_in_relu_requant_im2col(t["x1"], w4, w_kmajor=wk)  # built and warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fe.enc1_in_relu_requant_im2col(t["x1"], w4, w_kmajor=wk)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 8 * 128 * 128 * 128 * 4
    del out


@pytest.mark.cuda
def test_v3_epilogue_im2col_wrappers_reject_bad_inputs(cuda_device):
    x, hs, w, g, bb, n = _trunk_inputs(1, 16, 128, 1, cuda_device)
    with pytest.raises(ValueError, match="int8"):
        f3.fused_trunk_blocks(x.to(torch.int32), hs, w, g, bb, n)
    with pytest.raises(ValueError, match="w_stack must have shape"):
        f3.fused_trunk_blocks(x, hs, w[:-128].contiguous(), g, bb, n)
    with pytest.raises(ValueError, match="CUDA tensor"):
        f3.fused_trunk_blocks(x, hs.cpu(), w, g, bb, n)
    with pytest.raises(ValueError, match="C % 128"):
        f3.fused_trunk_blocks(x[..., :64].contiguous(), hs, w[:9 * 64 * 2, :64].contiguous(),
                              g[..., :64].contiguous(), bb[..., :64].contiguous(), n)
    xi = torch.zeros((1, 64, 128), dtype=torch.int32, device=cuda_device)
    gb = torch.ones((1, 128), device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        ec.adain_relu_requant_chunked(xi.to(torch.int64), gb, gb)
    with pytest.raises(ValueError, match="S % 8"):
        ec.adain_relu_requant_chunked(xi[:, :60].contiguous(), gb, gb)
    with pytest.raises(ValueError, match="contiguous"):
        ec.adain_relu_requant_chunked(xi.reshape(1, 128, 64).transpose(1, 2), gb, gb)
    e = _enc_inputs(1, 64, cuda_device)
    with pytest.raises(ValueError, match="shape"):
        fe.enc1_in_relu_requant_im2col(e["x1"], e["w1"])
    with pytest.raises(ValueError, match="Cin == 64"):
        fe.enc1_in_relu_requant_im2col(e["x2"], e["w1"].repeat(4, 1).contiguous())
    w4 = e["w1"].repeat(4, 1).contiguous()
    for bad in (w4, fe.pack_enc1_im2col_kmajor(w4)[:128], fe.pack_enc1_im2col_kmajor(w4).cpu()):
        with pytest.raises(ValueError, match="w_kmajor"):
            fe.enc1_in_relu_requant_im2col(e["x1"], w4, w_kmajor=bad)


@pytest.mark.cuda
def test_v3_epilogue_im2col_never_take_the_plain_path(cuda_device):
    args = _trunk_inputs(1, 16, 128, 1, cuda_device)
    e = _enc_inputs(1, 64, cuda_device)
    xi = torch.ones((1, 64, 128), dtype=torch.int32, device=cuda_device)
    gb = torch.ones((1, 128), device=cuda_device)
    with mock.patch.object(f3, "fused_trunk_blocks_plain") as p3, \
            mock.patch.object(ec, "adain_relu_requant_chunked_plain") as pe, \
            mock.patch.object(fe, "enc1_in_relu_requant_im2col_plain") as pi:
        f3.fused_trunk_blocks(*args)
        ec.adain_relu_requant_chunked(xi, gb, gb)
        fe.enc1_in_relu_requant_im2col(e["x1"], e["w1"].repeat(4, 1).contiguous())
        torch.cuda.synchronize()
    for plain in (p3, pe, pi):
        plain.assert_not_called()


# ---------------- the v1 sites, the 9-tap ConvT site and the whole-slab epilogues


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,one_sign", [(1, 128, False), (8, 256, False), (2, 128, True)])
def test_v1_trunk_sites_kernel_match_plain(cuda_device, b, c, one_sign):
    """Rows 19-20 on the 64x64 map they take; (8, 256) is the main path's shape.
    Both run on the wgmma pass A (row 19 in its true-extremes mode), exact
    sums and the plain versions' operations: equal to their plain versions to
    the bit, with the K-major copy given and made by the wrapper. On one-sign
    channels row 19 also parts from row 1's kernel by more than the bar, so
    the two rules are told apart."""
    t = _inputs(b, 64, c, cuda_device, seed=5, one_sign=one_sign)
    want = v1.conv3x3_adain_relu_requant_plain(t["x"], t["w"], t["gamma"], t["beta"])
    want_q, want_s = v1.conv3x3_adain_residual_requant_plain(t["x"], t["hq"], t["hs"], t["w"],
                                                             t["gamma"], t["beta"])
    for kw in ({"w_kmajor": v1.pack_weights_kmajor(t["w"])}, {}):
        before = dict(v1.LAUNCHES)
        got = v1.conv3x3_adain_relu_requant(t["x"], t["w"], t["gamma"], t["beta"], **kw)
        got_q, got_s = v1.conv3x3_adain_residual_requant(t["x"], t["hq"], t["hs"], t["w"],
                                                         t["gamma"], t["beta"], **kw)
        assert v1.LAUNCHES == {**before, v1.RELU_SITE: before[v1.RELU_SITE] + 1,
                               v1.RESIDUAL_SITE: before[v1.RESIDUAL_SITE] + 1}
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)
    if one_sign:
        _assert_int8_apart(fc.conv3x3_adain_relu_requant(t["x"], t["w"], t["gamma"], t["beta"]),
                           got)


def _kcat_inputs(b, side, cin, cout, dev, seed=6, one_sign=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, side, side, cin), dtype=np.int8)
    w = rng.integers(-127, 128, (4, 4, cin, cout), dtype=np.int8)
    if one_sign:
        x, w = _one_sign(x, w)
    x, w = torch.from_numpy(x).to(dev), torch.from_numpy(w)
    return x, fc.pack_convt_weights(w, cin, cout).to(dev), fc.pack_convt_weights_ps(w, cin, cout).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,cin,cout,one_sign", [
    (1, 16, 64, 64, False), (2, 16, 256, 128, False), (8, 64, 256, 128, False),
    (8, 128, 128, 64, False), (2, 16, 64, 64, True), (8, 64, 256, 128, True)])
def test_kcat_convt_sites_kernel_match_plain(cuda_device, b, side, cin, cout, one_sign):
    """Rows 21 (v1) and 6 (v2) on the K-concat operand, both on row 5's two
    wgmma passes (row 21 in their true-extremes mode); (8, 64, 256, 128) and
    (8, 128, 128, 64) are up0's and up1's shapes on the main path. Equal to
    their plain versions to the bit, with the K-major copy given and made by
    the wrapper; row 6 equals row 5's kernel to the bit. On one-sign channels
    rows 21 and 6 part by more than the bar, so the two rules are told
    apart."""
    x, wk, wps = _kcat_inputs(b, side, cin, cout, cuda_device, one_sign=one_sign)
    want1 = v1.convt4x4s2_in_relu_requant_plain(x, wk)
    want6 = fc.convt4x4s2_in_relu_requant_plain(x, wk)
    got5 = fc.convt4x4s2_in_relu_requant_ps(x, wps)
    for kw in ({"w_kmajor": fc.pack_convt_kcat_kmajor(wk)}, {}):
        before1, before2 = v1.LAUNCHES[v1.CONVT_SITE], fc.LAUNCHES[fc.KCAT_SITE]
        got1 = v1.convt4x4s2_in_relu_requant(x, wk, **kw)
        got6 = fc.convt4x4s2_in_relu_requant(x, wk, **kw)
        assert (v1.LAUNCHES[v1.CONVT_SITE] == before1 + 1
                and fc.LAUNCHES[fc.KCAT_SITE] == before2 + 1)
        torch.cuda.synchronize()
        for got, want in ((got1, want1), (got6, want6)):
            assert got[0].shape == (b, 2 * side, 2 * side, cout)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got6[0], got5[0]) and torch.equal(got6[1], got5[1])
    if one_sign:
        _assert_int8_apart(got6[0], got1[0])


@pytest.mark.cuda
def test_v1_and_kcat_sites_reject_a_wrong_kmajor_copy(cuda_device):
    """Rows 6, 19, 20 and 21 check the K-major copy they are given: wrong
    shape, wrong dtype, another device."""
    t = _inputs(1, 64, 128, cuda_device, seed=7)
    wk3 = v1.pack_weights_kmajor(t["w"])
    for bad in (wk3[:64], wk3.to(torch.int32), wk3.cpu()):
        with pytest.raises(ValueError, match="w_kmajor"):
            v1.conv3x3_adain_relu_requant(t["x"], t["w"], t["gamma"], t["beta"], w_kmajor=bad)
        with pytest.raises(ValueError, match="w_kmajor"):
            v1.conv3x3_adain_residual_requant(t["x"], t["hq"], t["hs"], t["w"], t["gamma"],
                                              t["beta"], w_kmajor=bad)
    x, wk, _ = _kcat_inputs(1, 16, 64, 64, cuda_device)
    wkt = fc.pack_convt_kcat_kmajor(wk)
    for bad in (wkt[:2], wkt.transpose(1, 2).contiguous(), wkt.to(torch.int32), wkt.cpu()):
        with pytest.raises(ValueError, match="w_kmajor"):
            v1.convt4x4s2_in_relu_requant(x, wk, w_kmajor=bad)
        with pytest.raises(ValueError, match="w_kmajor"):
            fc.convt4x4s2_in_relu_requant(x, wk, w_kmajor=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lim", [((2, 64, 128), 2000), ((1, 1000, 384), 2 ** 27),
                                       ((8, 4096, 256), 2 ** 20), ((8, 4096, 256), 2 ** 31 - 1)])
@pytest.mark.parametrize("res_dtype", [torch.bfloat16, torch.float32])
def test_slab_epilogues_kernel_match_plain(cuda_device, shape, lim, res_dtype):
    """Rows 16-17; the last two shapes are the trunk slab at a 256² input, the
    last over the whole int32 range; the second takes conv-sized values (past
    2^24, where the fp32 cast rounds), a ragged last chunk and three channel
    tiles. Exact sums, the fp64 squares in the plain version's order and its
    rounded operations: equal to it to the bit (int8 and h), two calls alike,
    one kernel launch a call (no statistics block to fill)."""
    rng = np.random.default_rng(shape[1])
    b, _, c = shape
    x = torch.from_numpy(rng.integers(-lim, lim, shape, dtype=np.int64).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((b, c)).astype(np.float32))
    be = torch.from_numpy(rng.standard_normal((b, c)).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(res_dtype)
    x, g, be, res = (a.to(cuda_device) for a in (x, g, be, res))
    before = dict(ep.LAUNCHES)
    got = ep.adain_relu_requant(x, g, be)
    got_h, got_q = ep.adain_residual_requant(x, g, be, res)
    assert ep.LAUNCHES == {ep.RELU_SITE: before[ep.RELU_SITE] + 1,
                           ep.RESIDUAL_SITE: before[ep.RESIDUAL_SITE] + 1}
    want = ep.adain_relu_requant_plain(x, g, be)
    want_h, want_q = ep.adain_residual_requant_plain(x, g, be, res)
    again, (again_h, again_q) = ep.adain_relu_requant(x, g, be), ep.adain_residual_requant(x, g,
                                                                                         be, res)
    torch.cuda.synchronize()
    assert got.shape == shape and got.dtype == torch.int8 and got_h.dtype == res_dtype
    assert torch.equal(got, want) and torch.equal(got_q, want_q) and torch.equal(got_h, want_h)
    assert torch.equal(again, got) and torch.equal(again_h, got_h) and torch.equal(again_q, got_q)
    assert _device_kernels(lambda: ep.adain_relu_requant(x, g, be)) == 1
    assert _device_kernels(lambda: ep.adain_residual_requant(x, g, be, res)) == 1
    assert ep.cooperative_grid(res_dtype) >= torch.cuda.get_device_properties(
        cuda_device).multi_processor_count


@pytest.mark.cuda
def test_new_sites_reject_bad_inputs_and_never_take_the_plain_path(cuda_device):
    t = _inputs(1, 64, 128, cuda_device, seed=7)
    with pytest.raises(ValueError, match="64, 64"):
        v1.conv3x3_adain_relu_requant(t["x"][:, :32, :32].contiguous(), t["w"], t["gamma"],
                                      t["beta"])
    with pytest.raises(ValueError, match="int8"):
        v1.conv3x3_adain_residual_requant(t["x"], t["hq"].to(torch.int32), t["hs"], t["w"],
                                          t["gamma"], t["beta"])
    x, wk, _ = _kcat_inputs(1, 16, 64, 64, cuda_device)
    with pytest.raises(ValueError, match="Cin % 64"):
        v1.convt4x4s2_in_relu_requant(x[..., :32].contiguous(), wk[:9 * 32])
    with pytest.raises(ValueError, match="CUDA tensor"):
        fc.convt4x4s2_in_relu_requant(x, wk.cpu())
    xi = torch.zeros((1, 64, 128), dtype=torch.int32, device=cuda_device)
    gb = torch.ones((1, 128), device=cuda_device)
    with pytest.raises(ValueError, match="C % 128"):
        ep.adain_relu_requant(xi[..., :64].contiguous(), gb[:, :64].contiguous(),
                              gb[:, :64].contiguous())
    with pytest.raises(ValueError, match="residual must be one of"):
        ep.adain_residual_requant(xi, gb, gb, xi.to(torch.float16))
    with mock.patch.object(v1, "conv3x3_adain_relu_requant_plain") as p19, \
            mock.patch.object(v1, "conv3x3_adain_residual_requant_plain") as p20, \
            mock.patch.object(v1, "convt4x4s2_in_relu_requant_plain") as p21, \
            mock.patch.object(fc, "convt4x4s2_in_relu_requant_plain") as p6, \
            mock.patch.object(ep, "adain_relu_requant_plain") as p16, \
            mock.patch.object(ep, "adain_residual_requant_plain") as p17:
        v1.conv3x3_adain_relu_requant(t["x"], t["w"], t["gamma"], t["beta"])
        v1.conv3x3_adain_residual_requant(t["x"], t["hq"], t["hs"], t["w"], t["gamma"], t["beta"])
        v1.convt4x4s2_in_relu_requant(x, wk)
        fc.convt4x4s2_in_relu_requant(x, wk)
        ep.adain_relu_requant(xi, gb, gb)
        ep.adain_residual_requant(xi, gb, gb, xi.to(torch.bfloat16))
        torch.cuda.synchronize()
    for plain in (p19, p20, p21, p6, p16, p17):
        plain.assert_not_called()
