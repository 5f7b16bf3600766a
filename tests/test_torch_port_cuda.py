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

from msig_tpu_torch.ops import fused_conv_int8_v2 as fc
from msig_tpu_torch.ops import fused_dec_int8 as fd
from msig_tpu_torch.ops import fused_enc_int8 as fe
from msig_tpu_torch.ops import fused_trunk_v3 as f3
from msig_tpu_torch.ops import int8_epilogue_chunked as ec


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(b, side, c, dev, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, side, side, c), dtype=np.int8)
    w = rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8)
    h = rng.normal(0, 1.5, (b, side, side, c)).astype(np.float32)
    hs = (np.abs(h).max(axis=(1, 2, 3)) / 127.0).astype(np.float32).reshape(b, 1)
    ht = h / hs.reshape(b, 1, 1, 1)
    hq = np.clip(np.round(ht), -127, 127)
    t = dict(x=x, gamma=rng.normal(1.0, 0.5, (b, c)).astype(np.float32),
             beta=rng.normal(0.0, 0.5, (b, c)).astype(np.float32), hs=hs, h=h,
             hq=hq.astype(np.int8),
             h2=np.clip(np.round((ht - hq) * 254.0), -127, 127).astype(np.int8))
    t = {k: torch.from_numpy(v).to(dev) for k, v in t.items()}
    t["w"] = fc.pack_weights(torch.from_numpy(w)).to(dev)
    t["hb"] = t.pop("h").to(torch.bfloat16)
    return t


def _assert_int8_close(got, want):
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    where = torch.nonzero(diff > 1)
    assert where.numel() == 0, f"{where.shape[0]} elements off by >1, first at {where[:4].tolist()}"
    assert float((diff > 0).float().mean()) < 0.01


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,side", [(1, 32), (2, 64), (8, 256)])
def test_final7_kernel_matches_plain(cuda_device, b, side):
    args = _final7_inputs(b, side, cuda_device)
    before = fd.LAUNCHES[fd.FINAL7_SITE]
    got = fd.final7_tanh_u8(*args)
    assert fd.LAUNCHES[fd.FINAL7_SITE] == before + 1
    want = fd.final7_tanh_u8_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and got.shape == (b, side, side, 3)
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) < 1e-3


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
    statistics are integers, so a second call gives the same bits."""
    args = _trunk_inputs(b, side, c, n, cuda_device)
    before = f3.LAUNCHES[f3.SITE]
    got, got_s = f3.fused_trunk_blocks(*args)
    assert f3.LAUNCHES[f3.SITE] == before + 1 and f3.LAST_GRID[f3.SITE] > 0
    want, want_s = f3.fused_trunk_blocks_plain(*args)
    again, again_s = f3.fused_trunk_blocks(*args)
    torch.cuda.synchronize()
    assert got.shape == (b, side, side, c) and got_s.shape == (b, 1)
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=0)
    _assert_int8_close(got, want)
    assert torch.equal(again, got) and torch.equal(again_s, got_s)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lim", [((2, 64, 128), 3000), ((1, 1000, 384), 2 ** 31 - 1),
                                       ((8, 4096, 256), 2 ** 20)])
def test_chunked_epilogue_kernel_matches_plain(cuda_device, shape, lim):
    """The last shape is the main path's; the second takes the whole int32
    range and three channel tiles."""
    rng = np.random.default_rng(shape[1])
    b, _, c = shape
    x = torch.from_numpy(rng.integers(-lim, lim, shape, dtype=np.int64).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((b, c)).astype(np.float32))
    be = torch.from_numpy(rng.standard_normal((b, c)).astype(np.float32))
    x, g, be = x.to(cuda_device), g.to(cuda_device), be.to(cuda_device)
    before = ec.LAUNCHES[ec.SITE]
    got = ec.adain_relu_requant_chunked(x, g, be)
    assert ec.LAUNCHES[ec.SITE] == before + 1
    want = ec.adain_relu_requant_chunked_plain(x, g, be)
    torch.cuda.synchronize()
    assert got.shape == shape and got.dtype == torch.int8
    _assert_int8_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,side", [(1, 64), (2, 128), (8, 256)])
def test_enc1_im2col_kernel_matches_plain_and_enc1(cuda_device, b, side):
    """With four equal phase blocks, enc1's kernel to the bit; with four
    different ones, the plain version's phase mapping."""
    t = _enc_inputs(b, side, cuda_device)
    w4 = t["w1"].repeat(4, 1).contiguous()
    before = fe.LAUNCHES[fe.ENC1_I2C_SITE]
    got = fe.enc1_in_relu_requant_im2col(t["x1"], w4)
    assert fe.LAUNCHES[fe.ENC1_I2C_SITE] == before + 1
    assert torch.equal(got, fe.enc1_in_relu_requant(t["x1"], t["w1"]))
    rng = np.random.default_rng(side)
    wq = torch.from_numpy(rng.integers(-127, 128, (4096, 128), dtype=np.int8)).to(cuda_device)
    got = fe.enc1_in_relu_requant_im2col(t["x1"], wq)
    want = fe.enc1_in_relu_requant_im2col_plain(t["x1"], wq)
    torch.cuda.synchronize()
    _assert_int8_close(got, want)


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
