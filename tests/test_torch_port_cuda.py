"""The CUDA kernels of msig_tpu_torch against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skipped without a card. Imports neither JAX nor
msig_tpu, so it runs on a machine that has only PyTorch (with
``--noconftest``, since tests/conftest.py configures JAX):

    python -m pytest --noconftest tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from msig_tpu_torch.ops import fused_conv_int8_v2 as fc


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
