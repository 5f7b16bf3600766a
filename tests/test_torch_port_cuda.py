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
    t = dict(x=x, gamma=rng.normal(1.0, 0.5, (b, c)).astype(np.float32),
             beta=rng.normal(0.0, 0.5, (b, c)).astype(np.float32), hs=hs,
             hq=np.clip(np.round(h / hs.reshape(b, 1, 1, 1)), -127, 127).astype(np.int8))
    t = {k: torch.from_numpy(v).to(dev) for k, v in t.items()}
    t["w"] = fc.pack_weights(torch.from_numpy(w)).to(dev)
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
    assert fe.LAUNCHES == {k: v + 1 for k, v in before.items()}
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
    with mock.patch.object(fc, "convt4x4s2_in_relu_requant_ps_plain") as p0, \
            mock.patch.object(fd, "up1_s2d16_plain") as p1, \
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
        torch.cuda.synchronize()
    for plain in (p0, p1, p7, e0, e1, e2):
        plain.assert_not_called()
