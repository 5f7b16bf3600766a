"""Measured parity of msig_tpu_torch against msig_tpu, on the CPU.

The tests in tests/test_torch_port_*.py assert bars; this script prints the
values behind them, so the records can quote them:

    JAX_PLATFORMS=cpu python tests/port_parity_report.py [section ...]

It runs the JAX side on the CPU, eagerly (Pallas in interpret mode), and the
port on the CPU (its kernels' plain versions). With no arguments it runs every
section (about a quarter of an hour); with the names of sections
(``kernel_sites``, ``float_networks``, ``int8_slice``, ``decoder_slice``,
``encoder_slice``, ``styles``, ``int8_fidelity_on_leaves``, ``hifi_sites``,
``hifi_fidelity_on_leaves``, ``chain_512``) only those.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import glob  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from msig_tpu.infer import quantized as jq  # noqa: E402
from msig_tpu.infer.loading import _load_npz  # noqa: E402
from msig_tpu.infer.styles import sample_styles as jax_sample_styles  # noqa: E402
from msig_tpu.models import MultiDomainStyleEncoder as JStyleEncoder  # noqa: E402
from msig_tpu.models import StyleCycleGANGenerator as JGenerator  # noqa: E402
from msig_tpu.ops import fused_conv_int8 as jfc  # noqa: E402
from msig_tpu.ops import fused_conv_int8_v2 as jf2  # noqa: E402
from msig_tpu.ops import fused_dec_int8 as jfd  # noqa: E402
from msig_tpu.ops import fused_enc_int8 as jfe  # noqa: E402
from msig_tpu_torch.compat.from_jax import generator_state_dict, style_encoder_state_dict  # noqa: E402
from msig_tpu_torch.infer import quantized as tq  # noqa: E402
from msig_tpu_torch.infer.styles import sample_styles  # noqa: E402
from msig_tpu_torch.models import MultiDomainStyleEncoder, StyleCycleGANGenerator  # noqa: E402
from msig_tpu_torch.ops import fused_conv_int8_v2 as tf2  # noqa: E402
from msig_tpu_torch.ops import fused_dec_int8 as tfd  # noqa: E402
from msig_tpu_torch.ops import fused_enc_int8 as tfe  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "results", "tomato_r3b", "demo_checkpoint")


def psnr_u8(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def to_u8(y):
    return np.clip(np.round((np.asarray(y) + 1.0) * 127.5), 0, 255).astype(np.uint8)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()), float((np.abs(got - want) / (np.abs(want) + 1e-4)).max())


def kernel_sites():
    for c in (32, 256):
        rng = np.random.default_rng(3)
        b, w_img = 2, 16
        x = rng.integers(-127, 128, (b, w_img, w_img, c), dtype=np.int8)
        wp = np.array(jfc.pack_weights(jnp.asarray(rng.integers(-32, 33, (3, 3, c, c),
                                                                 dtype=np.int8))))
        gamma = rng.normal(1.0, 0.5, (b, c)).astype(np.float32)
        beta = rng.normal(0.0, 0.5, (b, c)).astype(np.float32)
        h = rng.normal(0, 1.5, (b, w_img, w_img, c)).astype(np.float32)
        hs = (np.abs(h).max(axis=(1, 2, 3)) / 127.0).astype(np.float32).reshape(b, 1)
        hq = np.clip(np.round(h / hs.reshape(b, 1, 1, 1)), -127, 127).astype(np.int8)
        t = {k: torch.from_numpy(v) for k, v in dict(x=x, wp=wp, g=gamma, b=beta, hq=hq,
                                                      hs=hs).items()}
        want = jf2.conv3x3_adain_relu_requant(jf2.to_padded_rows(jnp.asarray(x)), jnp.asarray(wp),
                                              jnp.asarray(gamma), jnp.asarray(beta), w_img=w_img)
        want = tf2.from_padded_rows(torch.from_numpy(np.array(want)), w_img).numpy()
        got = tf2.conv3x3_adain_relu_requant(t["x"], t["wp"], t["g"], t["b"]).numpy()
        d = np.abs(got.astype(int) - want.astype(int))
        print(f"(b) relu site C={c}: max step {d.max()}, differing share {(d > 0).mean():.2e}")
        wq, ws = jf2.conv3x3_adain_residual_requant(
            jf2.to_padded_rows(jnp.asarray(x)), jf2.to_padded_rows(jnp.asarray(hq)),
            jnp.asarray(hs), jnp.asarray(wp), jnp.asarray(gamma), jnp.asarray(beta), w_img=w_img)
        wq = tf2.from_padded_rows(torch.from_numpy(np.array(wq)), w_img).numpy()
        gq, gs = tf2.conv3x3_adain_residual_requant(t["x"], t["hq"], t["hs"], t["wp"], t["g"],
                                                    t["b"])
        d = np.abs(gq.numpy().astype(int) - wq.astype(int))
        srel = np.abs(gs.numpy().ravel() / np.asarray(ws).ravel() - 1).max()
        print(f"(b) residual site C={c}: max step {d.max()}, differing share {(d > 0).mean():.2e}, "
              f"scale max rel err {srel:.2e}")


def float_networks():
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    style = rng.normal(0, 1, (2, 64)).astype(np.float32)
    jgen = JGenerator(style_dim=64, n_residual_blocks=2)
    params = jgen.init(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(style))
    g = StyleCycleGANGenerator(style_dim=64, n_residual_blocks=2)
    g.load_state_dict(generator_state_dict(params, 2))
    with torch.no_grad():
        got = g(torch.from_numpy(img), torch.from_numpy(style)).numpy()
    print("(c) generator 64², random params, fp32: max abs err %.2e, max rel err %.2e"
          % rel(got, jgen.apply(params, jnp.asarray(img), jnp.asarray(style))))

    gen, se, meta, _ = _load_npz(DEMO, 10)
    rng = np.random.default_rng(2)
    img = rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    ref = rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    idx = np.array([4], np.int32)
    jstyle = JStyleEncoder(style_dim=256, num_domains=10).apply(se, jnp.asarray(ref),
                                                                 jnp.asarray(idx))
    want = JGenerator(style_dim=256, n_residual_blocks=8).apply(gen, jnp.asarray(img), jstyle)
    tse = MultiDomainStyleEncoder(style_dim=256, num_domains=10)
    tse.load_state_dict(style_encoder_state_dict(se, 10, 256))
    tg = StyleCycleGANGenerator(style_dim=256, n_residual_blocks=8)
    tg.load_state_dict(generator_state_dict(gen, 8))
    with torch.no_grad():
        tstyle = tse(torch.from_numpy(ref), torch.from_numpy(idx))
        got = tg(torch.from_numpy(img), torch.from_numpy(np.array(jstyle))).numpy()
    print("(e) demo style encoder 256², fp32: max abs err %.2e, max rel err %.2e"
          % rel(tstyle.numpy(), jstyle))
    print("(e) demo generator 256², fp32: max abs err %.2e, max rel err %.2e" % rel(got, want))


def _random_int8_gen(n_res, seed):
    jgen = JGenerator(style_dim=64, n_residual_blocks=n_res, dtype=jnp.bfloat16)
    params = jgen.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3), jnp.bfloat16),
                       jnp.zeros((1, 64), jnp.bfloat16))
    return (jq.quantize_generator_params(params, n_res),
            tq.quantize_generator_params(generator_state_dict(params, n_res), n_res))


def _cr_rsqrt_instance_norm(x, eps=1e-5):
    """JAX instance_norm with a correctly rounded inverse sqrt (float64 in numpy)."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=(1, 2), keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=(1, 2), keepdims=True)
    inv = (1.0 / np.sqrt(np.asarray(var + eps, np.float64))).astype(np.float32)
    return ((xf - mean) * jnp.asarray(inv)).astype(x.dtype)


def _cr_rsqrt_stats(x, eps):
    """The port's ops/norm.py::_stats with a correctly rounded inverse sqrt."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    return xf, mean, (1.0 / torch.sqrt((var + eps).double())).float()


def int8_slice():
    jqp, q = _random_int8_gen(2, 0)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    style = rng.normal(0, 1, (2, 64)).astype(np.float32)

    def compare(tag):
        want = np.asarray(jq.quantized_generator_apply_staged(
            jqp, jnp.asarray(img), jnp.asarray(style), n_res=2, out_dtype=jnp.uint8,
            pallas=("trunk",)))
        got = tq.quantized_generator_apply(q, torch.from_numpy(img), torch.from_numpy(style),
                                           n_res=2).numpy()
        d = np.abs(got.astype(int) - want.astype(int))
        print(f"(d) int8 slice 64², random params, n_res 2, vs staged(pallas=('trunk',)){tag}: "
              f"PSNR {psnr_u8(got, want):.2f} dB, within 1: {(d <= 1).mean():.4f}, max {d.max()}")

    compare("")
    from unittest import mock

    from msig_tpu_torch.ops import norm as tnorm
    with mock.patch.object(jq, "instance_norm", _cr_rsqrt_instance_norm), \
            mock.patch.object(tnorm, "_stats", _cr_rsqrt_stats):
        compare(", correctly rounded rsqrt on both sides")

    # Where the packages part: the first encoder conv, its IN, the requant.
    x = jnp.pad((jnp.asarray(img).astype(jnp.int32) - 128).astype(jnp.int8),
                ((0, 0), (3, 3), (3, 3), (0, 0)), mode="reflect")
    y = jq._conv_i8(x, jqp["enc_conv0"], 1, ((0, 0), (0, 0)))
    yt = tq._conv_i8(torch.from_numpy(np.array(x)), q["enc_conv0"], 1, 0)
    h = jnp.maximum(jq.instance_norm(y.astype(jnp.bfloat16)), 0)
    ht = tq._in_relu(torch.from_numpy(np.array(y)))
    ulps = np.abs(ht.view(torch.int16).numpy().astype(int)
                  - np.asarray(jax.lax.bitcast_convert_type(h, jnp.int16)).astype(int))
    hb = torch.from_numpy(np.array(h.astype(jnp.float32))).to(torch.bfloat16)
    rq = (tq._requant(hb).numpy() != np.asarray(jq._requant(h))).sum()
    jit_rq = (np.asarray(jax.jit(jq._requant)(h)) != np.asarray(jq._requant(h))).mean()
    print(f"(d) where the packages part: conv0 int32 equal {np.array_equal(yt.numpy(), y)}; "
          f"relu(IN) bf16 differing share {(ulps > 0).mean():.2e}, max {ulps.max()} ulp; "
          f"_requant of the same bf16 codes differing {rq}; "
          f"jax.jit(_requant) vs eager differing share {jit_rq:.4f}")


def decoder_slice():
    """The decoder's three sites, the decoder and the generator at 256², B = 1."""
    jqp, q = _random_int8_gen(1, 1)
    hq = np.random.default_rng(0).integers(-127, 128, (1, 64, 64, 256), dtype=np.int8)
    y0, s0 = jf2.convt4x4s2_in_relu_requant_ps(jf2.to_padded_rows(jnp.asarray(hq)),
                                               jqp["up0_ps"], jf2.PS_TAPS, 64, guarded_out=True)
    y1, s1 = jfd.up1_s2d16(y0, jqp["up1_s16"])
    u8 = np.asarray(jfd.unphase_s2d16_u8(jfd.final7_tanh_u8(
        y1, jqp["final_s16"], jqp["out_wscale"], jqp["out_bias"], s1)))
    g = jf2.guard_rows(64)
    y0 = np.array(jf2.unphase_s2d(y0[:, g:-g], 64, 128))
    y1 = np.array(jfd.unphase_s2d16(y1, 64))
    sites = [("up0", tf2.convt4x4s2_in_relu_requant_ps(torch.from_numpy(hq), q["up0_ps"]), y0, s0),
             ("up1", tfd.up1_s2d16(torch.from_numpy(y0), q["up1_ps"]), y1, s1)]
    for name, (gq, gs), want, ws in sites:
        d = np.abs(gq.numpy().astype(int) - want.astype(int))
        srel = np.abs(gs.numpy().ravel() / np.asarray(ws).ravel() - 1).max()
        print(f"(g) {name} site: max step {d.max()}, differing share {(d > 0).mean():.2e}, "
              f"scale rel err {srel:.2e}")
    got = tfd.final7_tanh_u8(torch.from_numpy(y1), q["out_kernel_i8"], q["out_wscale"],
                             q["out_bias"], torch.from_numpy(np.array(s1).reshape(-1, 1))).numpy()
    d = np.abs(got.astype(int) - u8.astype(int))
    print(f"(g) final7 site: max uint8 diff {d.max()}, differing share {(d > 0).mean():.2e}")
    for dt, peak in (("uint8", 255.0), ("float32", 2.0)):
        want = np.asarray(jq._fused_decoder(jqp, jf2.to_padded_rows(jnp.asarray(hq)),
                                            getattr(jnp, dt), w_cells=64), np.float64)
        got = tq._fused_decoder(q, torch.from_numpy(hq), getattr(torch, dt)).numpy()
        mse = np.mean((got.astype(np.float64) - want) ** 2)
        print(f"(g) fused decoder, {dt} output, same trunk output: PSNR "
              f"{10 * np.log10(peak ** 2 / mse):.2f} dB (peak {peak:g})")
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)
    style = rng.normal(0, 1, (1, 64)).astype(np.float32)
    want = np.asarray(jq.quantized_generator_apply_staged(
        jqp, jnp.asarray(img), jnp.asarray(style), n_res=1, out_dtype=jnp.uint8,
        pallas=("trunk", "dec")))
    got = tq.quantized_generator_apply_staged(q, torch.from_numpy(img), torch.from_numpy(style),
                                              n_res=1, pallas=("trunk", "dec")).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    print(f"(g) int8 generator 256², n_res 1, vs staged(pallas=('trunk', 'dec')): "
          f"PSNR {psnr_u8(got, want):.2f} dB, within 1: {(d <= 1).mean():.4f}")


def _cells(o, wc=64):
    """JAX slab [B, g + wc*(wc+8) + g, L] -> the grid's cells [B, wc, wc, L]."""
    wp, srows, _, _, g, _ = jfe.enc_geometry(wc)
    o = np.asarray(o)
    return o[:, g:g + srows].reshape(o.shape[0], wc, wp, o.shape[-1])[:, :, :wc]


def _dense_enc0(o, wc=64):
    t = _cells(o, wc).reshape(-1, wc, wc, 2, 2, 2, 2, 64)
    return t.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, 4 * wc, 4 * wc, 64)


def _dense_enc1(o, wc=64):
    t = _cells(o, wc).reshape(-1, wc, wc, 2, 2, 128)
    return t.transpose(0, 1, 3, 2, 4, 5).reshape(-1, 2 * wc, 2 * wc, 128)


def encoder_slice():
    """The encoder's three sites, each on the JAX kernel's output of the site
    before it, the encoder chained, and the generator at 256², B = 1."""
    jqp, q = _random_int8_gen(1, 2)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)
    style = rng.normal(0, 1, (1, 64)).astype(np.float32)
    h0 = jfe.enc0_in_relu_requant(jfe.prep_s2d4_input(jnp.asarray(img)), jqp["enc0_p"])
    h1 = jfe.enc1_in_relu_requant(h0, jqp["enc1_p"])
    h2, s2 = jfe.enc2_in_relu_requant(h1, jqp["enc2_p"])
    d0, d1, d2 = _dense_enc0(h0), _dense_enc1(h1), _cells(h2)
    g2, gs = tfe.enc2_in_relu_requant(torch.from_numpy(d1), q["enc2_p"])
    sites = [("enc0", tfe.enc0_in_relu_requant(torch.from_numpy(img), q["enc0_p"]), d0),
             ("enc1", tfe.enc1_in_relu_requant(torch.from_numpy(d0), q["enc1_p"]), d1),
             ("enc2", g2, d2)]
    for name, got, want in sites:
        d = np.abs(got.numpy().astype(int) - want.astype(int))
        print(f"(h) {name} site, same input: max step {d.max()}, differing share "
              f"{(d > 0).mean():.2e}")
    srel = np.abs(gs.numpy().ravel() / np.asarray(s2).ravel() - 1).max()
    print(f"(h) enc2 site, same input: scale rel err {srel:.2e}")
    cq, cs = tq._fused_encoder(q, torch.from_numpy(img))
    d = np.abs(cq.numpy().astype(int) - d2.astype(int))
    srel = np.abs(cs.numpy().ravel() / np.asarray(s2).ravel() - 1).max()
    print(f"(h) fused encoder, chained: max step {d.max()}, differing share {(d > 0).mean():.2e}, "
          f"scale rel err {srel:.2e}")
    # The input of tests/test_torch_port_enc.py::test_fused_encoder_matches_jax_on_demo_weights.
    gen, _, _, _ = _load_npz(DEMO, 10)
    img6 = np.random.default_rng(6).integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)
    dq, ds = jq._fused_encoder(jq.quantize_generator_params(gen, 8), jnp.asarray(img6))
    cq, cs = tq._fused_encoder(tq.quantize_generator_params(generator_state_dict(gen, 8), 8),
                               torch.from_numpy(img6))
    d = np.abs(cq.numpy().astype(int) - _cells(dq).astype(int))
    srel = np.abs(cs.numpy().ravel() / np.asarray(ds).ravel() - 1).max()
    print(f"(h) fused encoder, chained, demo weights: max step {d.max()}, differing share "
          f"{(d > 0).mean():.2e}, scale rel err {srel:.2e}")
    want = np.asarray(jq.quantized_generator_apply_staged(
        jqp, jnp.asarray(img), jnp.asarray(style), n_res=1, out_dtype=jnp.uint8,
        pallas=("enc", "trunk", "dec")))
    got = tq.quantized_generator_apply(q, torch.from_numpy(img), torch.from_numpy(style),
                                       n_res=1).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    print(f"(h) int8 generator 256², n_res 1, vs staged(pallas=('enc', 'trunk', 'dec')): "
          f"PSNR {psnr_u8(got, want):.2f} dB, within 1: {(d <= 1).mean():.4f}, within 2: "
          f"{(d <= 2).mean():.4f}, max {d.max()}")
    # The rest of the chain from the JAX encoder's own output.
    rows = jq._fused_trunk_rows(jqp, h2, s2.reshape(1, 1), jnp.asarray(style), 1, w_img=64)
    want = np.asarray(jq._fused_decoder(jqp, rows, jnp.uint8, w_cells=64))
    hq = tq._fused_trunk_rows(q, torch.from_numpy(d2.copy()),
                              torch.from_numpy(np.array(s2).reshape(1, 1)),
                              torch.from_numpy(style), 1)
    d = np.abs(tq._fused_decoder(q, hq, torch.uint8).numpy().astype(int) - want.astype(int))
    print(f"(h) trunk + decoder from the JAX encoder's output: within 1: {(d <= 1).mean():.6f}, "
          f"max {d.max()}")


def leaf_tiles(sheet, col):
    a = np.asarray(Image.open(sheet).convert("RGB"))
    return [a[256 * k:256 * (k + 1), 256 * col:256 * (col + 1)] for k in range(a.shape[0] // 256)]


def int8_fidelity_on_leaves():
    """int8 vs fp32 on the demo checkpoint, 4 real leaf photos (the source
    column of docs/quality/samples_*.jpg), style = mean of 6 reference tiles."""
    gen, se, meta, _ = _load_npz(DEMO, 10)
    sheets = sorted(glob.glob(os.path.join(ROOT, "docs", "quality", "samples_*.jpg")))
    imgs = np.stack(leaf_tiles(sheets[0], 0)[:2] + leaf_tiles(sheets[3], 0)[:2])
    refs = np.stack(leaf_tiles(sheets[1], 1))
    st = JStyleEncoder(style_dim=256, num_domains=10).apply(
        se, jnp.asarray(refs.astype(np.float32) / 127.5 - 1), jnp.full((len(refs),), 2))
    style = jnp.broadcast_to(st.mean(0), (len(imgs), 256))
    jfp32 = to_u8(JGenerator(style_dim=256, n_residual_blocks=8).apply(
        gen, jnp.asarray(imgs.astype(np.float32) / 127.5 - 1), style))
    jqp = jq.quantize_generator_params(gen, 8)
    jint8 = {p: np.asarray(jq.quantized_generator_apply_staged(
        jqp, jnp.asarray(imgs), style, n_res=8, out_dtype=jnp.uint8, pallas=p))
        for p in (("trunk",), ("trunk", "dec"), ("enc", "trunk", "dec"))}
    sd = generator_state_dict(gen, 8)
    tg = StyleCycleGANGenerator(style_dim=256, n_residual_blocks=8)
    tg.load_state_dict(sd)
    ts = torch.from_numpy(np.array(style))
    with torch.no_grad():
        tfp32 = to_u8(tg(torch.from_numpy(imgs.astype(np.float32) / 127.5 - 1), ts).numpy())
    tq8 = tq.quantize_generator_params(sd, 8)
    tint8 = {p: tq.quantized_generator_apply_staged(tq8, torch.from_numpy(imgs), ts, n_res=8,
                                                    pallas=p).numpy()
             for p in (("trunk", "dec"), ("enc", "trunk", "dec"))}
    served = ("enc", "trunk", "dec")
    print("int8 vs fp32, demo checkpoint, 4 leaf photos at 256²: JAX staged "
          + ", ".join(f"pallas={p} {psnr_u8(jint8[p], jfp32):.2f} dB" for p in jint8)
          + "; port staged "
          + ", ".join(f"pallas={p} {psnr_u8(tint8[p], tfp32):.2f} dB" for p in tint8)
          + f"; port int8 vs JAX int8, both pallas={served}: "
          f"{psnr_u8(tint8[served], jint8[served]):.2f} dB")
    # How far the reference's own chains lie from each other on this checkpoint.
    print(f"JAX int8, pallas={served} vs pallas=('trunk',), same photos: "
          f"{psnr_u8(jint8[served], jint8[('trunk',)]):.2f} dB")


def _bf16_ordered(bits):
    bits = bits.astype(np.int32)
    return np.where(bits >= 0, bits, -(bits & 0x7FFF))


def hifi_sites():
    """The two hi-fi conv2 sites and the trunk in modes 1 and 2, 16 x 16 maps."""
    rng = np.random.default_rng(3)
    b, w_img, c = 2, 16, 256
    shape = (b, w_img, w_img, c)
    x = rng.integers(-127, 128, shape, dtype=np.int8)
    wp = np.array(jfc.pack_weights(jnp.asarray(rng.integers(-32, 33, (3, 3, c, c), dtype=np.int8))))
    gamma = rng.normal(1.0, 0.5, (b, c)).astype(np.float32)
    beta = rng.normal(0.0, 0.5, (b, c)).astype(np.float32)
    h = rng.normal(0, 1.5, shape).astype(np.float32)
    hs = (np.abs(h).max(axis=(1, 2, 3)) / 127.0).astype(np.float32).reshape(b, 1)
    ht = h / hs.reshape(b, 1, 1, 1)
    h1 = np.clip(np.round(ht), -127, 127)
    h2 = np.clip(np.round((ht - h1) * 254.0), -127, 127).astype(np.int8)
    h1 = h1.astype(np.int8)
    rows = lambda a: jf2.to_padded_rows(jnp.asarray(a))  # noqa: E731
    dense = lambda r: tf2.from_padded_rows(torch.from_numpy(np.array(r)), w_img).numpy()  # noqa: E731
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    tail = (jnp.asarray(wp), jnp.asarray(gamma), jnp.asarray(beta))
    wq, wh = jf2.conv3x3_adain_residual_hifi(rows(x), rows(jnp.asarray(h).astype(jnp.bfloat16)),
                                             *tail, w_img=w_img)
    gq, gh = tf2.conv3x3_adain_residual_hifi(t(x), t(h).to(torch.bfloat16), t(wp), t(gamma),
                                             t(beta))
    d = np.abs(gq.numpy().astype(int) - dense(wq).astype(int))
    wbits = dense(jax.lax.bitcast_convert_type(wh, jnp.int16))
    ulps = np.abs(_bf16_ordered(gh.view(torch.int16).numpy()) - _bf16_ordered(wbits))
    print(f"(i) hifi site (bf16 carry) C={c}: int8 max step {d.max()}, differing share "
          f"{(d > 0).mean():.2e}; carry max {ulps.max()} ulp, differing share "
          f"{(ulps > 0).mean():.2e}")
    want = jf2.conv3x3_adain_residual_hifi2(rows(x), rows(h1), rows(h2),
                                            jnp.asarray(hs).reshape(-1, 1, 1), *tail, w_img=w_img)
    got = tf2.conv3x3_adain_residual_hifi2(t(x), t(h1), t(h2), t(hs), t(wp), t(gamma), t(beta))
    d1 = np.abs(got[0].numpy().astype(int) - dense(want[0]).astype(int))
    d2 = np.abs(got[1].numpy().astype(int) - dense(want[1]).astype(int))
    srel = np.abs(got[2].numpy().ravel() / np.asarray(want[2]).ravel() - 1).max()
    print(f"(i) hifi2 site (two planes) C={c}: plane 1 max step {d1.max()}, differing share "
          f"{(d1 > 0).mean():.2e}; plane 2 max step {d2.max()}, differing share "
          f"{(d2 > 0).mean():.2e}; scale rel err {srel:.2e}")
    jqp, q = _random_int8_gen(2, 4)
    hq = rng.integers(0, 128, (2, w_img, w_img, 256), dtype=np.int8)
    hs = rng.uniform(0.02, 0.04, (2, 1)).astype(np.float32)
    style = rng.normal(0, 1, (2, 64)).astype(np.float32)
    for mode in (0, 1, 2):
        want = jq._fused_trunk_rows(jqp, rows(hq), jnp.asarray(hs), jnp.asarray(style), 2,
                                    w_img=w_img, hifi=mode)
        os.environ["MSIG_TRUNK_HIFI"] = str(mode)
        got = tq._fused_trunk_rows(q, t(hq), t(hs), t(style), 2).numpy()
        del os.environ["MSIG_TRUNK_HIFI"]
        d = np.abs(got.astype(int) - dense(want).astype(int))
        print(f"(i) trunk, n_res 2, MSIG_TRUNK_HIFI={mode}: max step {d.max()}, differing share "
              f"{(d > 0).mean():.2e}")


def hifi_fidelity_on_leaves():
    """int8 vs fp32 on the demo checkpoint, the four leaf photos of
    ``int8_fidelity_on_leaves``, all-kernel chain, MSIG_TRUNK_HIFI 0, 1, 2."""
    gen, se, meta, _ = _load_npz(DEMO, 10)
    sheets = sorted(glob.glob(os.path.join(ROOT, "docs", "quality", "samples_*.jpg")))
    imgs = np.stack(leaf_tiles(sheets[0], 0)[:2] + leaf_tiles(sheets[3], 0)[:2])
    refs = np.stack(leaf_tiles(sheets[1], 1))
    st = JStyleEncoder(style_dim=256, num_domains=10).apply(
        se, jnp.asarray(refs.astype(np.float32) / 127.5 - 1), jnp.full((len(refs),), 2))
    style = jnp.broadcast_to(st.mean(0), (len(imgs), 256))
    jfp32 = to_u8(JGenerator(style_dim=256, n_residual_blocks=8).apply(
        gen, jnp.asarray(imgs.astype(np.float32) / 127.5 - 1), style))
    jqp = jq.quantize_generator_params(gen, 8)
    sd = generator_state_dict(gen, 8)
    tg = StyleCycleGANGenerator(style_dim=256, n_residual_blocks=8)
    tg.load_state_dict(sd)
    ts = torch.from_numpy(np.array(style))
    with torch.no_grad():
        tfp32 = to_u8(tg(torch.from_numpy(imgs.astype(np.float32) / 127.5 - 1), ts).numpy())
    tq8 = tq.quantize_generator_params(sd, 8)
    for mode in ("0", "1", "2"):
        os.environ["MSIG_TRUNK_HIFI"] = mode
        jint8 = np.asarray(jq.quantized_generator_apply_staged(
            jqp, jnp.asarray(imgs), style, n_res=8, out_dtype=jnp.uint8))
        tint8 = tq.quantized_generator_apply(tq8, torch.from_numpy(imgs), ts, n_res=8).numpy()
        del os.environ["MSIG_TRUNK_HIFI"]
        print(f"(i) int8 vs fp32, demo checkpoint, 4 leaf photos at 256², all-kernel chain, "
              f"MSIG_TRUNK_HIFI={mode}: JAX {psnr_u8(jint8, jfp32):.2f} dB, port "
              f"{psnr_u8(tint8, tfp32):.2f} dB; port int8 vs JAX int8 "
              f"{psnr_u8(tint8, jint8):.2f} dB")


def chain_512():
    """The all-kernel chain at 512², one resblock, B = 1, both stagings, against
    the JAX function with the same ``pallas`` (its staged pairs on the 128-cell grid)."""
    jqp, q = _random_int8_gen(1, 2)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
    style = rng.normal(0, 1, (1, 64)).astype(np.float32)
    for fp16 in ("0", "1"):
        os.environ["MSIG_STAGE_FP16"] = fp16
        want = np.asarray(jq.quantized_generator_apply_staged(
            jqp, jnp.asarray(img), jnp.asarray(style), n_res=1, out_dtype=jnp.uint8))
        got = tq.quantized_generator_apply(q, torch.from_numpy(img), torch.from_numpy(style),
                                           n_res=1).numpy()
        del os.environ["MSIG_STAGE_FP16"]
        d = np.abs(got.astype(int) - want.astype(int))
        print(f"(j) int8 generator 512², n_res 1, MSIG_STAGE_FP16={fp16}, vs staged(pallas=('enc', "
              f"'trunk', 'dec')): PSNR {psnr_u8(got, want):.2f} dB, within 1: "
              f"{(d <= 1).mean():.4f}, within 2: {(d <= 2).mean():.4f}, max {d.max()}")
        if fp16 == "0":
            ref = got
    d = np.abs(got.astype(int) - ref.astype(int))
    print(f"(j) port at 512², fp16 staging vs int32 staging: PSNR {psnr_u8(got, ref):.2f} dB, "
          f"within 1: {(d <= 1).mean():.4f}")
    float_out = to_u8(tq.quantized_generator_apply(
        q, torch.from_numpy(img), torch.from_numpy(style), n_res=1,
        out_dtype=torch.float32).numpy())
    print(f"(j) port at 512², all-kernel uint8 vs pallas=('trunk',) float output: PSNR "
          f"{psnr_u8(ref, float_out):.2f} dB")


def styles():
    rng = np.random.default_rng(5)
    bank = rng.normal(0, 1, (5, 32)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    n1, n2 = jax.random.split(key)
    draws = {
        "average": None, "specific": None,
        "random": {"index": jax.random.randint(key, (6,), 0, 5)},
        "interpolate": {"index": jax.random.randint(k1, (6,), 0, 5),
                        "second": jax.random.randint(k2, (6,), 0, 4),
                        "alpha": jax.random.uniform(k3, (6, 1))},
        "noise": {"index": jax.random.randint(n1, (6,), 0, 5),
                  "normal": jax.random.normal(n2, (6, 32))},
    }
    for mode, dr in draws.items():
        want = np.asarray(jax_sample_styles(jnp.asarray(bank), mode, key, 6, 0.1))
        dr = None if dr is None else {k: torch.from_numpy(np.array(v)) for k, v in dr.items()}
        got = sample_styles(torch.from_numpy(bank), mode, None, 6, 0.1, draws=dr).numpy()
        print(f"(f) style mode {mode}: max abs diff {np.abs(got - want).max():.2e}")


SECTIONS = (kernel_sites, float_networks, int8_slice, decoder_slice, encoder_slice, styles,
            int8_fidelity_on_leaves, hifi_sites, hifi_fidelity_on_leaves, chain_512)

if __name__ == "__main__":
    by_name = {fn.__name__: fn for fn in SECTIONS}
    unknown = [a for a in sys.argv[1:] if a not in by_name]
    if unknown:
        sys.exit(f"unknown sections {unknown}; choose from {sorted(by_name)}")
    for fn in ([by_name[a] for a in sys.argv[1:]] or SECTIONS):
        fn()
