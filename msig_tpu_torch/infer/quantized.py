"""Int8 generator forward for serving (inference only).

Counterpart of ``msig_tpu/infer/quantized.py``. At 256² input
``quantized_generator_apply`` runs the all-kernel chain of the JAX package
(``quantized_generator_apply_staged(..., pallas=("enc", "trunk", "dec"))``),
every site a CUDA kernel on dense NHWC int8:

  - encoder (``_fused_encoder``): ``fe.enc0_in_relu_requant``,
    ``fe.enc1_in_relu_requant``, ``fe.enc2_in_relu_requant``; enc2 hands the
    trunk its int8 map and inverse scale, with no bf16 step and no second
    requant in between;
  - residual trunk (``_fused_trunk_rows``): the two kernels of
    ``ops/fused_conv_int8_v2.py``, one launch each per resblock;
  - decoder (``_fused_decoder``): for uint8 output, three kernel sites, up0
    (``fc.convt4x4s2_in_relu_requant_ps``), up1 (``fd.up1_s2d16``) and the
    final conv7 + dequant + tanh + uint8 (``fd.final7_tanh_u8``); for float
    output the ConvT site twice, then the unfused final conv on up1's int8
    output and inverse scale.

At any other input size it runs the composition ``pallas=("trunk",)``: the
unfused int8 encoder and decoder (``_xla_encoder``, ``_xla_decoder``) around
the kernel trunk. The JAX package leaves the unfused chain's convolutions to
XLA; here they are an im2col times the library's exact int8 matrix product
(``torch._int_mm``, int32 accumulation), on the CPU and on the card alike,
with the bf16 activations and requant steps of the JAX chain.
``quantized_generator_apply_staged`` runs any of the eight compositions, to
attribute a difference to one stage.

Every conv but the last is followed by an instance norm, which absorbs the
per-output-channel weight scales, the per-sample activation scales and the
conv biases, so no dequantization appears until the final RGB conv.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from msig_tpu_torch.ops import fused_conv_int8_v2 as fc
from msig_tpu_torch.ops import fused_dec_int8 as fd
from msig_tpu_torch.ops import fused_enc_int8 as fe
from msig_tpu_torch.ops.norm import adain_modulate, instance_norm

Q = Dict[str, torch.Tensor]


def _trunk_hifi_mode() -> int:
    """MSIG_TRUNK_HIFI: only the stock int8 + scale residual carry (0) is ported."""
    v = os.environ.get("MSIG_TRUNK_HIFI", "0")
    if v != "0":
        raise ValueError(
            f"MSIG_TRUNK_HIFI={v!r} is not supported by msig_tpu_torch: only mode 0 "
            "(int8 + per-sample scale residual carry) is ported; unset it or set it to 0")
    return 0


def _quantize_kernel(w: torch.Tensor) -> torch.Tensor:
    """fp32 OIHW kernel -> int8, per-output-channel symmetric; scales dropped."""
    amax = w.abs().amax(dim=(1, 2, 3), keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)


def _convt_forward_kernel(w_iohw: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose weight [I, O, kh, kw] -> the equivalent forward conv, OIHW.

    The JAX package stores this kernel (HWIO, flipped; see compat/from_jax.py)
    and runs ConvT as an input-dilated correlation with it."""
    return w_iohw.permute(1, 0, 2, 3).flip(2, 3)


def quantize_generator_params(gen_sd: Mapping[str, torch.Tensor], n_residual_blocks: int) -> Q:
    """int8 weights of the generator from its state_dict (torch names).

    Keys as in the JAX package: ``enc_conv{0,1,2}`` and ``dec_up{0,1}`` (int8
    OIHW of the forward conv), ``enc{0,1,2}_p`` (the encoder kernels packed
    [K, Cout] for their sites), ``up{0,1}_ps`` (the ConvT kernels packed
    [16*Cin, Cout] by phase), ``res{i}_conv{1,2}_p`` (packed [9C, C] int8),
    ``res{i}_adain{1,2}_{k,b}`` (style affine, fp32), ``out_kernel_i8``,
    ``out_wscale``, ``out_bias`` (final conv, with a true dequant).
    """
    sd = {k: v.detach().to(torch.float32) for k, v in gen_sd.items()}
    n = n_residual_blocks
    q: Q = {
        "enc_conv0": _quantize_kernel(sd["content_encoder.0.weight"]),
        "enc_conv1": _quantize_kernel(sd["content_encoder.3.weight"]),
        "enc_conv2": _quantize_kernel(sd["content_encoder.6.weight"]),
        "dec_up0": _quantize_kernel(_convt_forward_kernel(sd[f"decoder.{n}.weight"])),
        "dec_up1": _quantize_kernel(_convt_forward_kernel(sd[f"decoder.{n + 3}.weight"])),
    }
    q["enc0_p"] = fe.pack_enc0(q["enc_conv0"].permute(2, 3, 1, 0))
    for i in (1, 2):
        q[f"enc{i}_p"] = fe.pack_conv4x4(q[f"enc_conv{i}"].permute(2, 3, 1, 0))
    for i in (0, 1):
        w_hwio = q[f"dec_up{i}"].permute(2, 3, 1, 0)
        q[f"up{i}_ps"] = fc.pack_convt_weights_ps(w_hwio, *w_hwio.shape[2:])
    for i in range(n):
        for c in ("conv1", "conv2"):
            w_i8 = _quantize_kernel(sd[f"decoder.{i}.{c}.weight"])
            q[f"res{i}_{c}_p"] = fc.pack_weights(w_i8.permute(2, 3, 1, 0))
        for a in ("adain1", "adain2"):
            q[f"res{i}_{a}_k"] = sd[f"decoder.{i}.{a}.style_modulation.weight"].t().contiguous()
            q[f"res{i}_{a}_b"] = sd[f"decoder.{i}.{a}.style_modulation.bias"]
    # The final conv is not IN-followed: per-output-channel scales are kept
    # for a true dequant before tanh.
    wout = sd[f"decoder.{n + 6}.weight"]
    wamax = wout.abs().amax(dim=(1, 2, 3))
    ws = torch.where(wamax > 0, wamax / 127.0, 1.0)
    q["out_kernel_i8"] = torch.clamp(torch.round(wout / ws[:, None, None, None]),
                                     -127, 127).to(torch.int8)
    q["out_wscale"] = ws
    q["out_bias"] = sd[f"decoder.{n + 6}.bias"]
    return q


# ------------------------------------------------------- unfused int8 chain


def _reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """NHWC reflect pad of H and W by p (``jnp.pad(mode='reflect')``), any dtype."""
    x = torch.cat([x[:, 1:p + 1].flip(1), x, x[:, -p - 1:-1].flip(1)], dim=1)
    return torch.cat([x[:, :, 1:p + 1].flip(2), x, x[:, :, -p - 1:-1].flip(2)], dim=2)


def _conv_i8(x_i8: torch.Tensor, w_oihw: torch.Tensor, stride: int, pad: int,
             lhs_dilation: bool = False) -> torch.Tensor:
    """Exact int8 conv, NHWC in, int32 NHWC out (``jax.lax.conv_general_dilated``).

    An im2col (pad and strided slices) times the int8 weight matrix on the
    library's int8 product, ``torch._int_mm``, which accumulates exactly in
    int32 on the CPU and the card. ``lhs_dilation`` inserts one zero between
    input pixels, as the JAX chain does for its ConvT sites, so the kernel
    keeps the JAX orientation."""
    if lhs_dilation:
        b, h, w, c = x_i8.shape
        xd = x_i8.new_zeros((b, 2 * h - 1, 2 * w - 1, c))
        xd[:, ::2, ::2] = x_i8
        x_i8 = xd
    if pad:
        x_i8 = F.pad(x_i8, (0, 0, pad, pad, pad, pad))
    b, h, w, c = x_i8.shape
    o, _, kh, kw = w_oihw.shape
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    cols = torch.stack([x_i8[:, ky:ky + stride * (ho - 1) + 1:stride,
                             kx:kx + stride * (wo - 1) + 1:stride]
                        for ky in range(kh) for kx in range(kw)], dim=3)
    cols = cols.reshape(b * ho * wo, kh * kw * c)
    wm = w_oihw.permute(0, 2, 3, 1).reshape(o, kh * kw * c)
    # _int_mm wants K and N in multiples of 8: zero-pad them, slice N back.
    k8, o8 = -(-cols.shape[1] // 8) * 8, -(-o // 8) * 8
    cols = F.pad(cols, (0, k8 - cols.shape[1]))
    wm = F.pad(wm, (0, k8 - wm.shape[1], 0, o8 - o))
    y = torch._int_mm(cols, wm.t())
    return y[:, :o].reshape(b, ho, wo, o).contiguous()


def _bf16(y_i32: torch.Tensor) -> torch.Tensor:
    """int32 -> bf16 through fp32, as XLA converts."""
    return y_i32.to(torch.float32).to(torch.bfloat16)


def _requant(x: torch.Tensor) -> torch.Tensor:
    """bf16 activations -> int8 with a per-sample dynamic scale (never dequantized)."""
    amax = x.abs().amax(dim=(1, 2, 3), keepdim=True).to(torch.float32)
    scale = torch.where(amax > 0, fc.div_rn(127.0, amax), 1.0).to(x.dtype)
    return torch.clamp(torch.round((x * scale).to(torch.float32)), -127, 127).to(torch.int8)


def _requant_with_inv_scale(x: torch.Tensor):
    """Like :func:`_requant`, plus the fp32 inverse scale [B, 1, 1, 1]."""
    amax = x.abs().amax(dim=(1, 2, 3), keepdim=True).to(torch.float32)
    scale = torch.where(amax > 0, fc.div_rn(127.0, amax), 1.0)
    xi = torch.clamp(torch.round((x * scale.to(x.dtype)).to(torch.float32)), -127, 127)
    return xi.to(torch.int8), fc.div_rn(1.0, scale)


def _in_relu(y_i32: torch.Tensor) -> torch.Tensor:
    return torch.relu(instance_norm(_bf16(y_i32)))


def _xla_encoder(q: Q, img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC image -> post-IN-relu bf16 encoder output."""
    # Recentre uint8 to int8; the affine x/127.5 - 1 is absorbed by the IN.
    x = (img_u8.to(torch.int32) - 128).to(torch.int8)
    h = _in_relu(_conv_i8(_reflect_pad(x, 3), q["enc_conv0"], 1, 0))
    h = _in_relu(_conv_i8(_requant(h), q["enc_conv1"], 2, 1))
    return _in_relu(_conv_i8(_requant(h), q["enc_conv2"], 2, 1))


def _style_affines(q: Q, style: torch.Tensor, n_res: int):
    """All 2n resblock affines in one batched product: (gammas, betas), [2n, B, C]."""
    names = [f"res{i}_{a}" for i in range(n_res) for a in ("adain1", "adain2")]
    ks = torch.stack([q[f"{m}_k"] for m in names])   # [2n, S, 2C]
    bs = torch.stack([q[f"{m}_b"] for m in names])   # [2n, 2C]
    params = torch.einsum("bs,nsc->nbc", style.to(torch.float32), ks) + bs[:, None, :]
    gammas, betas = params.chunk(2, dim=-1)
    return gammas.contiguous(), betas.contiguous()


def _fused_encoder(q: Q, img_u8: torch.Tensor):
    """uint8 NHWC image -> (int8 trunk input [B, H/4, W/4, 256], residual scale [B, 1]).

    Dense counterpart of ``msig_tpu/infer/quantized.py::_fused_encoder``: the
    three encoder sites chained on int8, enc2's inverse scale as it comes."""
    h0 = fe.enc0_in_relu_requant(img_u8, q["enc0_p"])
    h1 = fe.enc1_in_relu_requant(h0, q["enc1_p"])
    return fe.enc2_in_relu_requant(h1, q["enc2_p"])


def _fused_trunk_rows(q: Q, hq: torch.Tensor, hs: torch.Tensor, style: torch.Tensor,
                      n_res: int) -> torch.Tensor:
    """int8 trunk input and its inverse scale [B, 1] -> int8 trunk output with an
    absorbed per-sample scale (the stock int8 + scale residual carry)."""
    gammas, betas = _style_affines(q, style, n_res)
    for i in range(n_res):
        y1q = fc.conv3x3_adain_relu_requant(hq, q[f"res{i}_conv1_p"], gammas[2 * i],
                                            betas[2 * i])
        hq, hs = fc.conv3x3_adain_residual_requant(y1q, hq, hs, q[f"res{i}_conv2_p"],
                                                   gammas[2 * i + 1], betas[2 * i + 1])
    return hq


def _fused_trunk(q: Q, h: torch.Tensor, style: torch.Tensor, n_res: int) -> torch.Tensor:
    """bf16-input wrapper of :func:`_fused_trunk_rows` (after the unfused encoder)."""
    hq, inv_s = _requant_with_inv_scale(h)
    return _fused_trunk_rows(q, hq, inv_s.reshape(h.shape[0], 1).to(torch.float32), style, n_res)


def _xla_trunk(q: Q, h: torch.Tensor, style: torch.Tensor, n_res: int) -> torch.Tensor:
    """bf16 trunk input -> bf16 trunk output on the unfused int8 chain
    (``_xla_trunk`` without ``fused_epilogue``), the residual carried in bf16."""
    gammas, betas = _style_affines(q, style, n_res)
    for i in range(n_res):
        # OIHW kernels back from the packed [9C, C] rows (ky*3 + kx)*C + ci.
        w1, w2 = (q[f"res{i}_{c}_p"].reshape(3, 3, h.shape[-1], -1).permute(3, 2, 0, 1)
                  for c in ("conv1", "conv2"))
        y = _conv_i8(_requant(h), w1, 1, 1)
        y = torch.relu(adain_modulate(_bf16(y), gammas[2 * i], betas[2 * i]))
        y = _conv_i8(_requant(y), w2, 1, 1)
        h = adain_modulate(_bf16(y), gammas[2 * i + 1], betas[2 * i + 1]) + h
    return h


def _rows_to_spatial(hq: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
    """int8 map and its inverse scale [B, 1] -> bf16 activations (``_rows_to_spatial``)."""
    return hq.to(torch.bfloat16) * hs.reshape(-1, 1, 1, 1).to(torch.bfloat16)


def _xla_decoder(q: Q, h: torch.Tensor, out_dtype) -> torch.Tensor:
    """Trunk output -> final image on the unfused int8 chain.

    An int8 ``h`` carries an absorbed per-sample scale, which dec_up0
    (IN-followed) consumes directly (``_xla_decoder(..., int8_body=True)``);
    a bf16 ``h`` is requantized first."""
    hq = h if h.dtype == torch.int8 else _requant(h)
    h = _in_relu(_conv_i8(hq, q["dec_up0"], 1, 2, lhs_dilation=True))
    h = _in_relu(_conv_i8(_requant(h), q["dec_up1"], 1, 2, lhs_dilation=True))
    return _final_conv(q, h, out_dtype)


def _final_conv(q: Q, h: torch.Tensor, out_dtype) -> torch.Tensor:
    """Requant -> reflect pad -> int8 conv7 -> dequant -> tanh."""
    return _final_conv_i8(q, *_requant_with_inv_scale(h), out_dtype)


def _final_conv_i8(q: Q, hi: torch.Tensor, inv_s: torch.Tensor, out_dtype) -> torch.Tensor:
    """int8 map and its inverse scale -> reflect pad -> int8 conv7 -> dequant -> tanh."""
    y = _conv_i8(_reflect_pad(hi, 3), q["out_kernel_i8"], 1, 0)
    yf = y.to(torch.float32) * (q["out_wscale"] * inv_s.reshape(-1, 1, 1, 1))
    return to_out_dtype(torch.tanh(yf + q["out_bias"]), out_dtype)


def to_out_dtype(y: torch.Tensor, out_dtype) -> torch.Tensor:
    """[-1,1] float -> out_dtype; uint8 means the [0,255] serving image."""
    if out_dtype == torch.uint8:
        return torch.clamp(torch.round((y + 1.0) * 127.5), 0, 255).to(torch.uint8)
    return y.to(out_dtype)


def _fused_decoder(q: Q, hq: torch.Tensor, out_dtype) -> torch.Tensor:
    """int8 trunk output -> final image on the decoder's kernel sites.

    Dense counterpart of ``msig_tpu/infer/quantized.py::_fused_decoder``
    (:290-329). uint8 output: up0, up1 and the fused final conv7 + tanh +
    uint8, three launches. Float output: the ConvT site for up0 and up1,
    then the unfused final conv on up1's int8 output and its inverse scale,
    with no second requant."""
    y0, _ = fc.convt4x4s2_in_relu_requant_ps(hq, q["up0_ps"])
    if out_dtype == torch.uint8:
        y1, inv_s = fd.up1_s2d16(y0, q["up1_ps"])
        return fd.final7_tanh_u8(y1, q["out_kernel_i8"], q["out_wscale"], q["out_bias"], inv_s)
    return _final_conv_i8(q, *fc.convt4x4s2_in_relu_requant_ps(y0, q["up1_ps"]), out_dtype)


ALL_STAGES = ("enc", "trunk", "dec")


def quantized_generator_apply_staged(q: Q, img_u8: torch.Tensor, style: torch.Tensor,
                                     n_res: int = 8, out_dtype=torch.uint8,
                                     pallas: Tuple[str, ...] = ALL_STAGES) -> torch.Tensor:
    """Per-stage composition of the int8 generator (``quantized_generator_apply_staged``).

    ``pallas`` names the stages that run on their kernel sites; the others run
    the unfused int8 chain. Each hybrid swaps whole stages, so a difference
    between two compositions names its stage. Between a kernel stage and an
    unfused one the activations cross as the JAX package's do: int8 times its
    inverse scale to bf16, or bf16 requantized to int8 and an inverse scale."""
    unknown = set(pallas) - set(ALL_STAGES)
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)}: pallas takes a subset of {ALL_STAGES}")
    _trunk_hifi_mode()
    if "enc" in pallas:
        hq, hs = _fused_encoder(q, img_u8)
        h = hq if "trunk" in pallas else _rows_to_spatial(hq, hs)
    else:
        h = _xla_encoder(q, img_u8)
    if "trunk" not in pallas:
        h = _xla_trunk(q, h, style, n_res)
    elif "enc" in pallas:
        h = _fused_trunk_rows(q, hq, hs, style, n_res)
    else:
        h = _fused_trunk(q, h, style, n_res)
    # h: the trunk's int8 output with an absorbed scale, or the unfused trunk's bf16.
    if "dec" not in pallas:
        return _xla_decoder(q, h, out_dtype)
    return _fused_decoder(q, h if h.dtype == torch.int8 else _requant(h), out_dtype)


def quantized_generator_apply(q: Q, img_u8: torch.Tensor, style: torch.Tensor, n_res: int = 8,
                              out_dtype=torch.uint8) -> torch.Tensor:
    """uint8 NHWC image + style [B, S] -> image (uint8, or [-1,1] float).

    At 256² input, the JAX package's all-kernel chain (``quantized.py:352-368``,
    ``pallas=("enc", "trunk", "dec")``): 3 + 2*n_res + 3 kernel-site calls. At
    any other size ``pallas=("trunk",)``, the unfused encoder and decoder
    around the kernel trunk (the choice is by shape)."""
    stages = ALL_STAGES if tuple(img_u8.shape[1:3]) == (256, 256) else ("trunk",)
    return quantized_generator_apply_staged(q, img_u8, style, n_res, out_dtype, pallas=stages)
