"""The hi-fi conv2 sites (rows 3-4) on the wgmma pass A, on the CPU: the sites
with and without the K-major weights, and both C entries emulated in numpy.

``csrc/conv3x3_adain_residual_hifi.cu`` and ``..._hifi2.cu`` run their conv
on the pass A of rows 1-2 (``wgmma::conv3x3_i8_stats`` of
``csrc/conv_i8_wgmma.cuh``, K-major weights ``fc.pack_weights_kmajor``): the
int32 rows and the exact statistics block. Two epilogue kernels each then
read them: ``hifi_carry_kernel`` (the bf16 carry and max|hn|) and
``hifi_requant_kernel`` (the int8 copy from the rounded carry);
``hifi2_amax_kernel`` (max|hn|) and ``hifi2_requant_kernel`` (the two planes
and the scale). The kernels cannot run here. Pass A's schedule is emulated by
``emulate`` of tests/test_torch_port_trunk_wgmma.py; the epilogues below
repeat the kernels' fp32 operations in their order (numpy float32 rounds each
operation once, as the ``_rn`` intrinsics do) and walk their grid-stride
loops with the kernels' channel arithmetic. Together they are held to the
bit against the plain versions, which the card holds the kernels to
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch
from test_torch_port_trunk_wgmma import _site_inputs, emulate

from msig_tpu_torch.ops import fused_conv_int8_v2 as fc

F32 = np.float32
EPI_THREADS = 256  # conv_int8.cuh::kEpiThreads


def _hifi_inputs(b, side, c, seed=1):
    """The site inputs of the trunk tests and a residual h with its two-plane
    carry (h1 + h2/254) * hs, as tests/test_torch_port_hifi512.py makes them."""
    t = _site_inputs(b, side, c, seed=seed)
    rng = np.random.default_rng(seed + 100)
    h = rng.normal(0, 1.5, (b, side, side, c)).astype(F32)
    hs = (np.abs(h).max(axis=(1, 2, 3)) / 127.0).astype(F32).reshape(b, 1)
    ht = h / hs.reshape(b, 1, 1, 1)
    h1 = np.clip(np.round(ht), -127, 127)
    h2 = np.clip(np.round((ht - h1) * 254.0), -127, 127)
    t.update(hb=torch.from_numpy(h).to(torch.bfloat16), hs=torch.from_numpy(hs),
             h1=torch.from_numpy(h1.astype(np.int8)), h2=torch.from_numpy(h2.astype(np.int8)))
    return t


def _hifi(t, **kw):
    return fc.conv3x3_adain_residual_hifi(t["x"], t["hb"], t["w"], t["gamma"], t["beta"], **kw)


def _hifi2(t, **kw):
    return fc.conv3x3_adain_residual_hifi2(t["x"], t["h1"], t["h2"], t["hs"], t["w"], t["gamma"],
                                           t["beta"], **kw)


@pytest.mark.parametrize("b,side,c", [(1, 16, 128), (2, 8, 256)])
def test_hifi_sites_with_and_without_the_kmajor_copy_agree(b, side, c):
    t = _hifi_inputs(b, side, c)
    wk = fc.pack_weights_kmajor(t["w"])
    for site in (_hifi, _hifi2):
        for got, want in zip(site(t, w_kmajor=wk), site(t)):
            assert got.dtype == want.dtype and torch.equal(got, want)
        for bad in (t["w"], wk[:, :-128], wk.to(torch.int16)):
            with pytest.raises(ValueError, match="w_kmajor"):
                site(t, w_kmajor=bad)


# ---------------------------------------------- the epilogue kernels


def _channel_affine(stats, gamma, beta, n, eps=fc._EPS):
    """channel_affine of conv_int8.cuh (in_affine per (sample, channel)):
    mean = sum/n, var = max(sumsq/n - mean^2, 0), a = gamma * rcp(sqrt(var +
    eps)), d = beta - mean * a; the sum of squares rounded once from its two
    words (sumsq_to_float, as ``fc.words_to_f32``). [B, C] each."""
    n = F32(n)
    mean = stats[0].astype(F32) / n
    sumsq = fc.words_to_f32(torch.from_numpy(stats[4]), torch.from_numpy(stats[1])).numpy()
    var = np.maximum((sumsq / n) - mean * mean, F32(0))
    a = gamma * (F32(1) / np.sqrt(var + F32(eps)))
    d = beta - mean * a
    return a, d


def _group_channels(hw, c, fixed=False):
    """The first channel of each group of 4 that the epilogue kernels' threads
    read, walking their grid-stride loops as launched (grid.x =
    epilogue_blocks(HW, C), kEpiThreads threads): c = (i * 4) % C for group i,
    or with ``fixed`` (row 4's GroupAffine where C divides 4 * kEpiThreads)
    the thread's own (4 * threadIdx.x) % C at every step. Returns [HW*C/4],
    each group visited once."""
    groups = hw * c // 4
    blocks = min(max((groups + 16 * EPI_THREADS - 1) // (16 * EPI_THREADS), 1), 1024)
    first = np.full(groups, -1, np.int64)
    for bx in range(blocks):
        i = bx * EPI_THREADS + np.arange(EPI_THREADS)
        while True:
            i = i[i < groups]
            if not i.size:
                break
            assert (first[i] == -1).all(), "each group once"
            first[i] = (4 * ((i - bx * EPI_THREADS) % EPI_THREADS)) % c if fixed else (i * 4) % c
            i = i + blocks * EPI_THREADS
    assert (first >= 0).all()
    return first


def _per_element(values, hw, c, fixed=False):
    """[B, C] per-channel values laid over [B, HW*C] by the kernels' channel index."""
    idx = (_group_channels(hw, c, fixed)[:, None] + np.arange(4)).reshape(-1)
    return values[:, idx]


def _bf16_rn(v):
    """__float2bfloat16_rn: round to nearest even on the bit pattern; returns
    the bf16 values as fp32 and their 16-bit patterns."""
    bits = v.view(np.uint32).astype(np.uint64)
    hi = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint32)
    return (hi << 16).view(F32), hi.astype(np.uint16)


def _hifi_epilogues(y, stats, hb, gamma, beta):
    """hifi_carry_kernel then hifi_requant_kernel on pass A's int32 rows y
    [B, HW, C] and statistics [5, B, C]; returns (int8 copy, bf16 bits)."""
    b, hw, c = y.shape
    a, d = _channel_affine(stats, gamma, beta, hw)
    a, d = _per_element(a, hw, c), _per_element(d, hw, c)
    yf = y.reshape(b, -1).astype(F32)
    # hn = y*a + d + h, in the order of fused_conv_int8_v2.py:229-231
    hn = ((yf * a) + d) + hb.reshape(b, -1)
    amax = np.abs(hn).max(axis=1, keepdims=True)  # atomicMax over the blocks' maxima, from 0
    carry, bits = _bf16_rn(hn)
    s = np.where(amax > 0, F32(127) / np.where(amax > 0, amax, F32(1)), F32(1))
    q = np.rint(np.clip(carry * s, F32(-127), F32(127))).astype(np.int8)
    return q.reshape(y.shape), bits.reshape(y.shape)


def _hifi2_epilogues(y, stats, h1, h2, hs, gamma, beta):
    """hifi2_amax_kernel then hifi2_requant_kernel; returns (q1, q2, scale [B, 1])."""
    b, hw, c = y.shape
    a, d = _channel_affine(stats, gamma, beta, hw)
    fixed = (4 * EPI_THREADS) % c == 0  # fixed_group_channels
    a, d = _per_element(a, hw, c, fixed), _per_element(d, hw, c, fixed)
    hs2 = hs * F32(1.0 / 254.0)  # hifi2_hs2: the double quotient rounded to fp32
    # hn = y*a + d + h1*hs + h2*hs2, in the order of fused_conv_int8_v2.py:291
    base = (y.reshape(b, -1).astype(F32) * a) + d
    hn = (base + h1.reshape(b, -1).astype(F32) * hs) + h2.reshape(b, -1).astype(F32) * hs2
    amax = np.abs(hn).max(axis=1, keepdims=True)
    safe = np.where(amax > 0, amax, F32(1))
    s = np.where(amax > 0, F32(127) / safe, F32(1))
    scale = np.where(amax > 0, safe / F32(127), F32(1))
    t = hn * s
    q1f = np.rint(np.clip(t, F32(-127), F32(127)))
    e = (t - q1f) * F32(254)
    q2 = np.rint(np.clip(e, F32(-127), F32(127)))
    return q1f.astype(np.int8).reshape(y.shape), q2.astype(np.int8).reshape(y.shape), scale


# (B, W, H, C): both channel tiles, W = 24 (tiles end inside image rows), a
# map whose epilogue grid is 8 blocks a sample (each thread walks 16 groups),
# and C = 384, which does not divide 4 * kEpiThreads (row 4's channel index
# then taken at every step).
EPILOGUE_SHAPES = [(1, 16, 16, 128), (2, 16, 16, 256), (2, 24, 16, 128), (1, 64, 8, 256),
                   (1, 16, 8, 384)]


@pytest.mark.parametrize("b,w,h,c", EPILOGUE_SHAPES)
def test_hifi_entry_emulated_equals_plain(b, w, h, c):
    t = _site_inputs(b, 1, c)  # weights, gamma, beta; the maps below
    rng = np.random.default_rng(w * 100 + c)
    x = rng.integers(-127, 128, (b, h, w, c), dtype=np.int8)
    hb = torch.from_numpy(rng.normal(0, 1.5, (b, h, w, c)).astype(F32)).to(torch.bfloat16)
    y, stats = emulate(x, fc.pack_weights_kmajor(t["w"]).numpy(), grid=3)
    q, bits = _hifi_epilogues(y, stats, hb.float().numpy().reshape(b, h * w, c),
                              t["gamma"].numpy(), t["beta"].numpy())
    want_q, want_h = fc.conv3x3_adain_residual_hifi_plain(torch.from_numpy(x), hb, t["w"],
                                                          t["gamma"], t["beta"])
    np.testing.assert_array_equal(q, want_q.reshape(b, h * w, c).numpy())
    np.testing.assert_array_equal(bits, want_h.view(torch.int16).reshape(b, h * w, c).numpy()
                                  .view(np.uint16))


@pytest.mark.parametrize("b,w,h,c", EPILOGUE_SHAPES)
def test_hifi2_entry_emulated_equals_plain(b, w, h, c):
    t = _site_inputs(b, 1, c)
    rng = np.random.default_rng(w * 100 + c + 1)
    x = rng.integers(-127, 128, (b, h, w, c), dtype=np.int8)
    hr = rng.normal(0, 1.5, (b, h, w, c)).astype(F32)
    hs = (np.abs(hr).max(axis=(1, 2, 3)) / 127.0).astype(F32).reshape(b, 1)
    ht = hr / hs.reshape(b, 1, 1, 1)
    h1 = np.clip(np.round(ht), -127, 127).astype(np.int8)
    h2 = np.clip(np.round((ht - h1) * 254.0), -127, 127).astype(np.int8)
    y, stats = emulate(x, fc.pack_weights_kmajor(t["w"]).numpy(), grid=3)
    q1, q2, scale = _hifi2_epilogues(y, stats, h1.reshape(b, -1, c), h2.reshape(b, -1, c), hs,
                                     t["gamma"].numpy(), t["beta"].numpy())
    want = fc.conv3x3_adain_residual_hifi2_plain(
        *(torch.from_numpy(v) for v in (x, h1, h2, hs)), t["w"], t["gamma"], t["beta"])
    np.testing.assert_array_equal(q1, want[0].reshape(b, h * w, c).numpy())
    np.testing.assert_array_equal(q2, want[1].reshape(b, h * w, c).numpy())
    np.testing.assert_array_equal(scale, want[2].numpy())
    assert np.abs(q2).max() > 100  # the second plane carries what the first rounds away
