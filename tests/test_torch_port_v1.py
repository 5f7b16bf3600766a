"""Parity of the port's v1 fused conv sites and the 9-tap ConvT site with the JAX package.

``msig_tpu_torch/ops/fused_conv_int8.py`` (rows 19-21 of PERF.md's kernel
table: the v1 conv1, conv2 and ConvT sites) against ``msig_tpu/ops/
fused_conv_int8.py``, and ``fused_conv_int8_v2.convt4x4s2_in_relu_requant``
(row 6) against its JAX namesake, the JAX kernels in interpret mode on the
CPU, the port on its plain versions. The JAX outputs are unpacked from guard
rows or space-to-depth to dense NHWC with the port's slab helpers. Bars:
int8 at most 1 step apart on under 1% of the elements, scales rtol 1e-5. On
one-sign channels, where v1's requant rule and v2's set different amax, the
v2 sites' results part from the JAX v1 kernel's by more than that bar. The
CUDA kernels are held against the plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msig_tpu.ops import fused_conv_int8 as jfc
from msig_tpu.ops import fused_conv_int8_v2 as jf2
from msig_tpu_torch.ops import fused_conv_int8 as tv1
from msig_tpu_torch.ops import fused_conv_int8_v2 as tf2


def _assert_int8_close(got, want):
    diff = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1, f"{int((diff > 1).sum())} elements off by more than 1"
    assert (diff > 0).mean() < 0.01


def _assert_int8_apart(got, want):
    """The negation of _assert_int8_close: the two part by more than its bar."""
    diff = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() > 1 or (diff > 0).mean() >= 0.01, \
        f"max diff {diff.max()}, {(diff > 0).mean():.4%} off: within the bar"


def _one_sign(x, w, k=4):
    """Non-negative input and, for the first k output channels, non-positive
    weights: those channels' conv outputs are all negative, so their requant
    extremes differ between v1's true per-channel extremes and v2's
    zero-masked ones (cmax 0 in place of a negative one)."""
    w = w.copy()
    w[..., :k] = -np.abs(w[..., :k])
    return np.abs(x), w


def _trunk_data(b=1, c=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, 64, 64, c), dtype=np.int8)
    w = rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8)
    gamma = rng.normal(1.0, 0.5, (b, c)).astype(np.float32)
    beta = rng.normal(0.0, 0.5, (b, c)).astype(np.float32)
    return x, w, gamma, beta


def _rows(x):
    """Dense [B, 64, 64, C] numpy -> the JAX v1 slab [B, XROWS, C] (the port's helper)."""
    b, h, w, c = x.shape
    return jnp.asarray(tv1.pad_to_rows(torch.from_numpy(x).reshape(b, h * w, c)).numpy())


def _dense(rows, guard=tv1.GUARD):
    return tv1.unpad_rows(torch.from_numpy(np.array(rows)), guard).numpy()


def test_pack_weights_match_jax():
    rng = np.random.default_rng(1)
    w3 = rng.integers(-127, 128, (3, 3, 128, 128), dtype=np.int8)
    np.testing.assert_array_equal(tv1.pack_weights(torch.from_numpy(w3)).numpy(),
                                  np.asarray(jfc.pack_weights(jnp.asarray(w3))))
    w4 = rng.integers(-127, 128, (4, 4, 64, 32), dtype=np.int8)
    np.testing.assert_array_equal(tv1.pack_convt_weights(torch.from_numpy(w4), 64, 32).numpy(),
                                  np.asarray(jfc.pack_convt_weights(jnp.asarray(w4), 64, 32)))


def test_slab_helpers_invert_the_jax_layouts():
    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, (2, 64, 64, 8), dtype=np.int8)
    np.testing.assert_array_equal(_dense(_rows(x)), x)
    xf = x.reshape(2, 4096, 8)
    np.testing.assert_array_equal(tv1.pad_rows(torch.from_numpy(xf), 80).numpy(),
                                  np.asarray(jfc.pad_rows(jnp.asarray(xf), 80)))
    y = rng.integers(-127, 128, (2, 16 * 16, 4 * 8), dtype=np.int8)
    np.testing.assert_array_equal(tv1.unphase_s2d(torch.from_numpy(y), 16, 8).numpy(),
                                  _unphase_np(y, 16, 8))


def _unphase_np(y, w_img, cout):
    """out[b, 2I+qy, 2J+qx, c] = y[b, I*w_img + J, (2qy+qx)*cout + c], by index."""
    b = y.shape[0]
    out = np.zeros((b, 2 * w_img, 2 * w_img, cout), y.dtype)
    for q in range(4):
        out[:, q // 2::2, q % 2::2] = y.reshape(b, w_img, w_img, 4, cout)[:, :, :, q]
    return out


def test_relu_site_plain_matches_pallas():
    x, w, gamma, beta = _trunk_data()
    want = jfc.conv3x3_adain_relu_requant(_rows(x), jfc.pack_weights(jnp.asarray(w)),
                                          jnp.asarray(gamma), jnp.asarray(beta))
    assert not np.asarray(want)[:, :tv1.GUARD].any() and not np.asarray(want)[:, -tv1.GUARD:].any()
    got = tv1.conv3x3_adain_relu_requant(torch.from_numpy(x), tv1.pack_weights(torch.from_numpy(w)),
                                         torch.from_numpy(gamma), torch.from_numpy(beta))
    assert got.dtype == torch.int8 and got.shape == x.shape
    _assert_int8_close(got.numpy(), _dense(want))


def test_relu_site_one_sign_channels_match_pallas_and_part_from_v2():
    """On one-sign channels (gamma > 0 there) v1's rule sets a different amax
    than row 1's: the port's v1 plain version keeps to the JAX v1 kernel
    within the bar, row 1's function on the same inputs does not."""
    x, w, gamma, beta = _trunk_data(seed=2)
    x, w = _one_sign(x, w)
    gamma[:, :4] = np.abs(gamma[:, :4]) + 0.5
    want = _dense(jfc.conv3x3_adain_relu_requant(_rows(x), jfc.pack_weights(jnp.asarray(w)),
                                                 jnp.asarray(gamma), jnp.asarray(beta)))
    args = (torch.from_numpy(x), tv1.pack_weights(torch.from_numpy(w)),
            torch.from_numpy(gamma), torch.from_numpy(beta))
    _assert_int8_close(tv1.conv3x3_adain_relu_requant(*args).numpy(), want)
    _assert_int8_apart(tf2.conv3x3_adain_relu_requant(*args).numpy(), want)


def test_residual_site_plain_matches_pallas():
    x, w, gamma, beta = _trunk_data(seed=1)
    rng = np.random.default_rng(11)
    h = rng.integers(-127, 128, x.shape, dtype=np.int8)
    hs = rng.uniform(0.5, 2.0, (1, 1)).astype(np.float32)
    want_q, want_s = jfc.conv3x3_adain_residual_requant(
        _rows(x), _rows(h), jnp.asarray(hs), jfc.pack_weights(jnp.asarray(w)),
        jnp.asarray(gamma), jnp.asarray(beta))
    got_q, got_s = tv1.conv3x3_adain_residual_requant(
        *(torch.from_numpy(a) for a in (x, h, hs)), tv1.pack_weights(torch.from_numpy(w)),
        torch.from_numpy(gamma), torch.from_numpy(beta))
    assert got_s.shape == (1, 1) and got_s.dtype == torch.float32
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s).reshape(-1, 1), rtol=1e-5)
    _assert_int8_close(got_q.numpy(), _dense(want_q))


def _convt_data(side, cin, cout, seed, lo=-127):
    rng = np.random.default_rng(seed)
    x = rng.integers(lo, 128, (1, side, side, cin), dtype=np.int8)
    w = rng.integers(-127, 128, (4, 4, cin, cout), dtype=np.int8)
    return x, w


def _jax_convt_v1(x, wk, guard, chunk=256):
    b, side, _, cin = x.shape
    rows = jnp.asarray(tv1.pad_rows(torch.from_numpy(x).reshape(b, side * side, cin),
                                    guard).numpy())
    y, s = jfc.convt4x4s2_in_relu_requant(rows, wk, side, guard, chunk=chunk)
    cout = wk.shape[1] // 4
    return tv1.unphase_s2d(torch.from_numpy(np.array(y)), side, cout).numpy(), \
        np.asarray(s).reshape(-1, 1)


@pytest.mark.parametrize("side,cin,cout,guard", [(16, 64, 64, 32), (16, 128, 64, 32)])
def test_convt_site_plain_matches_pallas(side, cin, cout, guard):
    x, w = _convt_data(side, cin, cout, seed=cin)
    want_q, want_s = _jax_convt_v1(x, jfc.pack_convt_weights(jnp.asarray(w), cin, cout), guard)
    got_q, got_s = tv1.convt4x4s2_in_relu_requant(
        torch.from_numpy(x), tv1.pack_convt_weights(torch.from_numpy(w), cin, cout))
    assert got_q.shape == (1, 2 * side, 2 * side, cout) and got_s.shape == (1, 1)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5)
    _assert_int8_close(got_q.numpy(), want_q)


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 64)])
def test_convt_site_one_sign_channels_match_pallas_and_part_from_v2(cin, cout):
    """As for the relu site: on one-sign channels the port's v1 ConvT keeps to
    the JAX v1 kernel within the bar, rows 5 and 6 (zero-masked extremes,
    folded requant) on the same inputs do not."""
    x, w = _one_sign(*_convt_data(16, cin, cout, seed=cin + 1))
    want_q, want_s = _jax_convt_v1(x, jfc.pack_convt_weights(jnp.asarray(w), cin, cout), 32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got_q, got_s = tv1.convt4x4s2_in_relu_requant(xt, tv1.pack_convt_weights(wt, cin, cout))
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5)
    _assert_int8_close(got_q.numpy(), want_q)
    q6, _ = tf2.convt4x4s2_in_relu_requant(xt, tf2.pack_convt_weights(wt, cin, cout))
    q5, _ = tf2.convt4x4s2_in_relu_requant_ps(xt, tf2.pack_convt_weights_ps(wt, cin, cout))
    _assert_int8_apart(q6.numpy(), want_q)
    _assert_int8_apart(q5.numpy(), want_q)


def test_two_resblock_v1_chain_matches_pallas():
    """conv1 -> conv2 -> conv1 -> conv2, each side fed its own outputs; the
    weights packed by each package's pack_weights from the same arrays."""
    rng = np.random.default_rng(3)
    c = 128
    x = rng.integers(-127, 128, (1, 64, 64, c), dtype=np.int8)
    hs = np.full((1, 1), 0.02, np.float32)
    ws = [rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8) for _ in range(4)]
    gs = [rng.normal(1.0, 0.5, (1, c)).astype(np.float32) for _ in range(4)]
    bs = [rng.normal(0.0, 0.5, (1, c)).astype(np.float32) for _ in range(4)]
    jh, jhs = _rows(x), jnp.asarray(hs)
    th, ths = torch.from_numpy(x), torch.from_numpy(hs)
    for blk in range(2):
        i, k = 2 * blk, 2 * blk + 1
        jy = jfc.conv3x3_adain_relu_requant(jh, jfc.pack_weights(jnp.asarray(ws[i])),
                                            jnp.asarray(gs[i]), jnp.asarray(bs[i]))
        jh, jhs = jfc.conv3x3_adain_residual_requant(
            jy, jh, jhs.reshape(1, 1), jfc.pack_weights(jnp.asarray(ws[k])), jnp.asarray(gs[k]),
            jnp.asarray(bs[k]))
        ty = tv1.conv3x3_adain_relu_requant(th, tv1.pack_weights(torch.from_numpy(ws[i])),
                                            torch.from_numpy(gs[i]), torch.from_numpy(bs[i]))
        th, ths = tv1.conv3x3_adain_residual_requant(
            ty, th, ths, tv1.pack_weights(torch.from_numpy(ws[k])), torch.from_numpy(gs[k]),
            torch.from_numpy(bs[k]))
        _assert_int8_close(ty.numpy(), _dense(jy))
        np.testing.assert_allclose(ths.numpy(), np.asarray(jhs).reshape(1, 1), rtol=1e-5)
        _assert_int8_close(th.numpy(), _dense(jh))


def test_up0_up1_v1_chain_matches_pallas():
    """up0 -> up1 through the v1 ConvT site at 16 -> 32 -> 64 pixels, each side
    fed its own up0 output."""
    x, w0 = _convt_data(16, 128, 64, seed=4)
    _, w1 = _convt_data(32, 64, 64, seed=5)
    jy0, js0 = _jax_convt_v1(x, jfc.pack_convt_weights(jnp.asarray(w0), 128, 64), 32)
    jy1, js1 = _jax_convt_v1(jy0, jfc.pack_convt_weights(jnp.asarray(w1), 64, 64), 64)
    ty0, ts0 = tv1.convt4x4s2_in_relu_requant(
        torch.from_numpy(x), tv1.pack_convt_weights(torch.from_numpy(w0), 128, 64))
    ty1, ts1 = tv1.convt4x4s2_in_relu_requant(
        ty0, tv1.pack_convt_weights(torch.from_numpy(w1), 64, 64))
    np.testing.assert_allclose(ts0.numpy(), js0, rtol=1e-5)
    np.testing.assert_allclose(ts1.numpy(), js1, rtol=1e-5)
    _assert_int8_close(ty0.numpy(), jy0)
    assert ty1.shape == (1, 64, 64, 64)
    _assert_int8_close(ty1.numpy(), jy1)


def test_9tap_site_plain_matches_pallas_and_phase_split_to_the_bit():
    """Row 6: the K-concat site against its JAX namesake, and equal to the
    phase-split site (row 5) on the same weights."""
    x, w = _convt_data(16, 64, 64, seed=7)
    want_q, want_s = jf2.convt4x4s2_in_relu_requant(
        jf2.to_padded_rows(jnp.asarray(x)), jfc.pack_convt_weights(jnp.asarray(w), 64, 64), 16)
    wk = tf2.pack_convt_weights(torch.from_numpy(w), 64, 64)
    got_q, got_s = tf2.convt4x4s2_in_relu_requant(torch.from_numpy(x), wk)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s).reshape(-1, 1), rtol=1e-5)
    _assert_int8_close(got_q.numpy(), np.asarray(jf2.unphase_s2d(want_q, 16, 64)))
    ps_q, ps_s = tf2.convt4x4s2_in_relu_requant_ps(
        torch.from_numpy(x), tf2.pack_convt_weights_ps(torch.from_numpy(w), 64, 64))
    assert torch.equal(got_q, ps_q) and torch.equal(got_s, ps_s)


def test_kcat_conv_equals_phase_split_conv():
    x, w = _convt_data(8, 64, 128, seed=8)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(tf2.convt4x4s2_kcat_i64(xt, tf2.pack_convt_weights(wt, 64, 128)),
                       tf2.convt4x4s2_i64(xt, tf2.pack_convt_weights_ps(wt, 64, 128)))


def test_shapes_the_jax_wrappers_refuse_raise():
    x, w, gamma, beta = _trunk_data()
    small = x[:, :32, :32]
    with pytest.raises(AssertionError):
        jfc.conv3x3_adain_relu_requant(
            jnp.asarray(tv1.pad_to_rows(torch.from_numpy(small).reshape(1, 1024, 128)).numpy()),
            jfc.pack_weights(jnp.asarray(w)), jnp.asarray(gamma), jnp.asarray(beta))
    tw, tg, tb = tv1.pack_weights(torch.from_numpy(w)), torch.from_numpy(gamma), \
        torch.from_numpy(beta)
    with pytest.raises(ValueError, match="64, 64"):
        tv1.conv3x3_adain_relu_requant(torch.from_numpy(small.copy()), tw, tg, tb)
    with pytest.raises(ValueError, match="64, 64"):
        tv1.conv3x3_adain_residual_requant(torch.from_numpy(small.copy()),
                                           torch.from_numpy(small.copy()),
                                           torch.ones((1, 1)), tw, tg, tb)
    with pytest.raises(ValueError, match="weights"):
        tv1.conv3x3_adain_relu_requant(torch.from_numpy(x), tw[:-128], tg, tb)
    with pytest.raises(ValueError, match="C % 128"):
        tv1.conv3x3_adain_relu_requant(torch.from_numpy(x[..., :64].copy()), tw[:576, :64],
                                       tg[:, :64], tb[:, :64])
    assert tv1.supported(256) and not tv1.supported(64)
    xc, wc = _convt_data(16, 64, 64, seed=9)
    wk = jfc.pack_convt_weights(jnp.asarray(wc), 64, 64)
    with pytest.raises(AssertionError):
        jfc.convt4x4s2_in_relu_requant(jnp.asarray(xc.reshape(1, 256, 64)), wk[:-64], 16, 0)
    twk = tv1.pack_convt_weights(torch.from_numpy(wc), 64, 64)
    with pytest.raises(ValueError, match="9\\*Cin"):
        tv1.convt4x4s2_in_relu_requant(torch.from_numpy(xc), twk[:-64])
    with pytest.raises(ValueError, match="square"):
        tv1.convt4x4s2_in_relu_requant(torch.from_numpy(xc[:, :8].copy()), twk)
    x24 = np.zeros((1, 24, 24, 64), np.int8)
    with pytest.raises(AssertionError):
        jf2.convt4x4s2_in_relu_requant(jf2.to_padded_rows(jnp.asarray(x24)), wk, 24)
    with pytest.raises(ValueError, match="H % 16"):
        tf2.convt4x4s2_in_relu_requant(torch.from_numpy(x24), twk)


def test_cpu_wrappers_count_no_launches():
    x, w = _convt_data(16, 64, 64, seed=10)
    tv1.reset_launch_counts()
    tf2.reset_launch_counts()
    wk = tv1.pack_convt_weights(torch.from_numpy(w), 64, 64)
    tv1.convt4x4s2_in_relu_requant(torch.from_numpy(x), wk)
    tf2.convt4x4s2_in_relu_requant(torch.from_numpy(x), wk)
    assert set(tv1.LAUNCHES.values()) == set(tf2.LAUNCHES.values()) == {0}
