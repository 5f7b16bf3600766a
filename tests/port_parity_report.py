"""Measured parity of msig_tpu_torch against msig_tpu, on the CPU.

The tests in tests/test_torch_port_*.py assert bars; this script prints the
values behind them, so the records can quote them:

    JAX_PLATFORMS=cpu python tests/port_parity_report.py

It runs the JAX side on the CPU (Pallas in interpret mode) and the port on the
CPU (its kernels' plain versions), and takes about a minute.
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
from msig_tpu_torch.compat.from_jax import generator_state_dict, style_encoder_state_dict  # noqa: E402
from msig_tpu_torch.infer import quantized as tq  # noqa: E402
from msig_tpu_torch.infer.styles import sample_styles  # noqa: E402
from msig_tpu_torch.models import MultiDomainStyleEncoder, StyleCycleGANGenerator  # noqa: E402
from msig_tpu_torch.ops import fused_conv_int8_v2 as tf2  # noqa: E402

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


def int8_slice():
    jgen = JGenerator(style_dim=64, n_residual_blocks=2, dtype=jnp.bfloat16)
    params = jgen.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.bfloat16),
                       jnp.zeros((1, 64), jnp.bfloat16))
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    style = rng.normal(0, 1, (2, 64)).astype(np.float32)
    want = np.asarray(jq.quantized_generator_apply_staged(
        jq.quantize_generator_params(params, 2), jnp.asarray(img), jnp.asarray(style), n_res=2,
        out_dtype=jnp.uint8, pallas=("trunk",)))
    got = tq.quantized_generator_apply(tq.quantize_generator_params(generator_state_dict(params, 2),
                                                                    2),
                                       torch.from_numpy(img), torch.from_numpy(style),
                                       n_res=2).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    print(f"(d) int8 slice 64², random params, n_res 2, vs staged(pallas=('trunk',)): "
          f"PSNR {psnr_u8(got, want):.2f} dB, within 1: {(d <= 1).mean():.4f}, max {d.max()}")


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
    jint8 = np.asarray(jq.quantized_generator_apply_staged(
        jq.quantize_generator_params(gen, 8), jnp.asarray(imgs), style, n_res=8,
        out_dtype=jnp.uint8, pallas=("trunk",)))
    sd = generator_state_dict(gen, 8)
    tg = StyleCycleGANGenerator(style_dim=256, n_residual_blocks=8)
    tg.load_state_dict(sd)
    ts = torch.from_numpy(np.array(style))
    with torch.no_grad():
        tfp32 = to_u8(tg(torch.from_numpy(imgs.astype(np.float32) / 127.5 - 1), ts).numpy())
    tint8 = tq.quantized_generator_apply(tq.quantize_generator_params(sd, 8),
                                         torch.from_numpy(imgs), ts, n_res=8).numpy()
    print(f"int8 vs fp32, demo checkpoint, 4 leaf photos at 256²: JAX staged trunk "
          f"{psnr_u8(jint8, jfp32):.2f} dB, port {psnr_u8(tint8, tfp32):.2f} dB; "
          f"port int8 vs JAX int8 {psnr_u8(tint8, jint8):.2f} dB")


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


if __name__ == "__main__":
    kernel_sites()
    float_networks()
    int8_slice()
    styles()
    int8_fidelity_on_leaves()
