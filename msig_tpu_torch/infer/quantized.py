"""Int8 generator forward for serving (inference only).

Counterpart of ``msig_tpu/infer/quantized.py``. At 256² input, and at 512²
for uint8 output, ``quantized_generator_apply`` runs the all-kernel chain of
the JAX package (``quantized_generator_apply_staged(..., pallas=("enc",
"trunk", "dec"))``), every site a CUDA kernel on dense NHWC int8:

  - encoder (``_fused_encoder``): ``fe.enc0_in_relu_requant`` (on inputs
    wider than 256 pixels the staged site ``fe.enc0_hbm``),
    ``fe.enc1_in_relu_requant``, ``fe.enc2_in_relu_requant``; enc2 hands the
    trunk its int8 map and inverse scale, with no bf16 step and no second
    requant in between;
  - residual trunk (``_fused_trunk_rows``): conv1 and conv2 of each resblock,
    one launch each, of ``ops/fused_conv_int8_v2.py``; ``MSIG_TRUNK_HIFI``
    chooses conv2's residual carry: 0 int8 + scale, 1 bf16, 2 two int8 planes;
  - decoder (``_fused_decoder``): for uint8 output, three kernel sites, up0
    (``fc.convt4x4s2_in_relu_requant_ps``), up1 (``fd.up1_s2d16``; on maps
    wider than 128 pixels the staged site ``fd.up1_s2d16_hbm``) and the
    final conv7 + dequant + tanh + uint8 (``fd.final7_tanh_u8``); for float
    output the ConvT site twice, then the unfused final conv on up1's int8
    output and inverse scale.

The staged sites pass their accumulator as int32, or as fp16 x 2^-12 with
``MSIG_STAGE_FP16=1``. ``MSIG_512_FUSED=0`` keeps 512² off the all-kernel chain.

Two opt-in compositions of the JAX package, each read when the weights are
quantized (which builds their weights) and again when the generator runs:
``MSIG_TRUNK_V3=1`` runs the trunk on the 64-grid (256² input) as one kernel,
``fused_trunk_blocks`` of ``ops/fused_trunk_v3.py``, instead of 2*n_res site
calls; ``MSIG_ENC1_IM2COL=1`` runs enc1 as ``fe.enc1_in_relu_requant_im2col``.
``quantized_generator_apply(..., fused_trunk=False)`` runs the unfused chain,
whose relu sites take ``adain_relu_requant_chunked`` of
``ops/int8_epilogue_chunked.py`` with ``fused_epilogue=True``.

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
import warnings
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from msig_tpu_torch.ops import fused_conv_int8_v2 as fc
from msig_tpu_torch.ops import fused_dec_int8 as fd
from msig_tpu_torch.ops import fused_enc_int8 as fe
from msig_tpu_torch.ops import fused_trunk_v3 as f3
from msig_tpu_torch.ops import int8_epilogue_chunked as ec
from msig_tpu_torch.ops.norm import adain_modulate, instance_norm

Q = Dict[str, torch.Tensor]


def _env_choice(name: str, default: str, choices: Tuple[str, ...]) -> str:
    """An environment setting that takes one of ``choices``; anything else raises."""
    v = os.environ.get(name, default)
    if v not in choices:
        raise ValueError(f"{name}={v!r} is not one of {', '.join(choices)}: unset it or "
                         f"set it to one of them")
    return v


def _trunk_hifi_mode() -> int:
    """MSIG_TRUNK_HIFI: the trunk's residual carry between resblocks. 0 (default)
    int8 + per-sample scale, 1 bf16, 2 two int8 planes under one scale. The JAX
    package reads any other value as 1; here it raises."""
    return int(_env_choice("MSIG_TRUNK_HIFI", "0", ("0", "1", "2")))


def _trunk_v3() -> bool:
    """MSIG_TRUNK_V3: "1" runs the trunk on the 64-grid as one kernel
    (``fused_trunk_blocks``), "0" (default) as 2*n_res site calls. The JAX
    package reads any value but "1" as off; here others raise."""
    return _env_choice("MSIG_TRUNK_V3", "0", ("0", "1")) == "1"


def _enc1_im2col() -> bool:
    """MSIG_ENC1_IM2COL: "1" runs enc1 in its dense K = 1024 form
    (``fe.enc1_in_relu_requant_im2col``), "0" (default) as ``fe.enc1_in_relu_requant``.
    The JAX package reads any value but "1" as off; here others raise."""
    return _env_choice("MSIG_ENC1_IM2COL", "0", ("0", "1")) == "1"


def _stage_mode() -> str:
    """MSIG_STAGE_FP16: how the staged 512² sites pass their accumulator on:
    "0" (default) as int32, "1" as fp16 x 2^-12 (``fc.STAGES``)."""
    return fc.STAGES[int(_env_choice("MSIG_STAGE_FP16", "0", ("0", "1")))]


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
    ``out_wscale``, ``out_bias`` (final conv, with a true dequant). Under
    ``MSIG_TRUNK_V3=1`` also ``trunk_w_stack`` (the 2*n packed trunk weights
    stacked, 9.4 MB at C = 256, n = 8), and under ``MSIG_ENC1_IM2COL=1`` with
    enc1's [4, 4, 64, 128] kernel ``enc1_i2c_p`` (``fe.pack_enc1_im2col``), as
    the JAX package builds them (``quantized.py:72-75, 97-100``): only then do
    the generator's branches find them.
    """
    v3, enc1_im2col = _trunk_v3(), _enc1_im2col()
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
    if v3:
        q["trunk_w_stack"] = f3.pack_trunk_weights(q, n)
    w_enc1 = q["enc_conv1"].permute(2, 3, 1, 0)
    if enc1_im2col and tuple(w_enc1.shape) == (4, 4, 64, 128):
        q["enc1_i2c_p"] = fe.pack_enc1_im2col(w_enc1)
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


def _affine_weights(q: Q, n_res: int):
    """The 2n resblock style-affine kernels [2n, S, 2C] and biases [2n, 2C], site-major."""
    names = [f"res{i}_{a}" for i in range(n_res) for a in ("adain1", "adain2")]
    return torch.stack([q[f"{m}_k"] for m in names]), torch.stack([q[f"{m}_b"] for m in names])


def _style_affines(q: Q, style: torch.Tensor, n_res: int):
    """All 2n resblock affines in one batched product: (gammas, betas), [2n, B, C]."""
    ks, bs = _affine_weights(q, n_res)
    params = torch.einsum("bs,nsc->nbc", style.to(torch.float32), ks) + bs[:, None, :]
    gammas, betas = params.chunk(2, dim=-1)
    return gammas.contiguous(), betas.contiguous()


def _fused_encoder(q: Q, img_u8: torch.Tensor):
    """uint8 NHWC image -> (int8 trunk input [B, H/4, W/4, 256], residual scale [B, 1]).

    Dense counterpart of ``msig_tpu/infer/quantized.py::_fused_encoder``: the
    three encoder sites chained on int8, enc2's inverse scale as it comes.
    Where the grid of 4x4-pixel cells is wider than 64 (a 512² input), enc0
    is the staged site (``msig_tpu/ops/fused_enc_int8.py:617``)."""
    if img_u8.shape[1] // 4 > 64:
        h0 = fe.enc0_hbm(img_u8, q["enc0_p"], stage=_stage_mode())
    else:
        h0 = fe.enc0_in_relu_requant(img_u8, q["enc0_p"])
    if _enc1_im2col() and "enc1_i2c_p" in q:  # msig_tpu/infer/quantized.py:280-282
        h1 = fe.enc1_in_relu_requant_im2col(h0, q["enc1_i2c_p"])
    else:
        h1 = fe.enc1_in_relu_requant(h0, q["enc1_p"])
    return fe.enc2_in_relu_requant(h1, q["enc2_p"])


def _fused_trunk_rows(q: Q, hq: torch.Tensor, hs: torch.Tensor, style: torch.Tensor,
                      n_res: int) -> torch.Tensor:
    """int8 trunk input and its inverse scale [B, 1] -> int8 trunk output with an
    absorbed per-sample scale.

    The residual crosses resblocks as ``MSIG_TRUNK_HIFI`` says
    (``msig_tpu/infer/quantized.py:220-251``): 0, int8 + scale; 1, bf16,
    starting from the bf16 product of the int8 map and its scale; 2, two int8
    planes under one scale, the second starting at zero.

    With ``MSIG_TRUNK_V3=1`` on the 64-grid, and ``trunk_w_stack`` in ``q``,
    the whole trunk is one ``f3.fused_trunk_blocks`` call (:175-200). It has no
    hi-fi carry: with ``MSIG_TRUNK_HIFI`` also set it warns and runs the hi-fi
    chain, as the JAX package does."""
    hifi = _trunk_hifi_mode()
    v3 = hq.shape[2] == 64 and _trunk_v3()
    if v3 and hifi:
        warnings.warn("MSIG_TRUNK_V3=1 and MSIG_TRUNK_HIFI are both set; the v3 trunk has no "
                      "hi-fi residual carry, so MSIG_TRUNK_V3 is being IGNORED in favor of the "
                      "quality mode.", stacklevel=2)
        v3 = False
    if v3 and "trunk_w_stack" in q:
        ks, bs = _affine_weights(q, n_res)
        params = torch.einsum("bs,nsc->bnc", style.to(torch.float32), ks) + bs[None]
        gammas, betas = (t.contiguous() for t in params.chunk(2, dim=-1))  # [B, 2n, C]
        return f3.fused_trunk_blocks(hq, hs, q["trunk_w_stack"], gammas, betas, n_res)[0]
    gammas, betas = _style_affines(q, style, n_res)
    if hifi == 1:
        carry = (hq.to(torch.bfloat16) * hs.reshape(-1, 1, 1, 1).to(torch.bfloat16),)
        site = fc.conv3x3_adain_residual_hifi
    elif hifi == 2:
        carry = (hq, torch.zeros_like(hq), hs)
        site = fc.conv3x3_adain_residual_hifi2
    else:
        carry = (hq, hs)
        site = fc.conv3x3_adain_residual_requant
    for i in range(n_res):
        y1q = fc.conv3x3_adain_relu_requant(hq, q[f"res{i}_conv1_p"], gammas[2 * i],
                                            betas[2 * i])
        # Every carry's first output is the int8 map that the next conv1 reads;
        # modes 0 and 2 carry it on, mode 1 carries only the bf16 map.
        hq, *rest = site(y1q, *carry, q[f"res{i}_conv2_p"], gammas[2 * i + 1], betas[2 * i + 1])
        carry = tuple(rest) if hifi == 1 else (hq, *rest)
    return hq


def _fused_trunk(q: Q, h: torch.Tensor, style: torch.Tensor, n_res: int) -> torch.Tensor:
    """bf16-input wrapper of :func:`_fused_trunk_rows` (after the unfused encoder)."""
    hq, inv_s = _requant_with_inv_scale(h)
    return _fused_trunk_rows(q, hq, inv_s.reshape(h.shape[0], 1).to(torch.float32), style, n_res)


def _xla_trunk(q: Q, h: torch.Tensor, style: torch.Tensor, n_res: int,
               fused_epilogue: bool = False) -> torch.Tensor:
    """bf16 trunk input -> bf16 trunk output on the unfused int8 chain, the
    residual carried in bf16.

    With ``fused_epilogue`` and a shape ``ec.supported`` takes, each relu
    site's int32 conv output goes through ``ec.adain_relu_requant_chunked``
    and its int8 straight into conv2, with no bf16 step and no second requant
    (``quantized.py:416-435``); conv2's AdaIN and the residual stay unfused."""
    gammas, betas = _style_affines(q, style, n_res)
    b, hh, ww, ch = h.shape
    use_fused = fused_epilogue and ec.supported((b, hh * ww, ch))
    for i in range(n_res):
        # OIHW kernels back from the packed [9C, C] rows (ky*3 + kx)*C + ci.
        w1, w2 = (q[f"res{i}_{c}_p"].reshape(3, 3, ch, -1).permute(3, 2, 0, 1)
                  for c in ("conv1", "conv2"))
        y = _conv_i8(_requant(h), w1, 1, 1)
        if use_fused:
            y = ec.adain_relu_requant_chunked(y.reshape(b, hh * ww, ch), gammas[2 * i],
                                              betas[2 * i]).reshape(b, hh, ww, ch)
        else:
            y = _requant(torch.relu(adain_modulate(_bf16(y), gammas[2 * i], betas[2 * i])))
        y = _conv_i8(y, w2, 1, 1)
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
    uint8, three launches; where the cell grid is wider than 64 (a 512²
    image) up1 is the staged site (:308-309). Float output: the ConvT site
    for up0 and up1, then the unfused final conv on up1's int8 output and its
    inverse scale, with no second requant."""
    y0, _ = fc.convt4x4s2_in_relu_requant_ps(hq, q["up0_ps"])
    if out_dtype == torch.uint8:
        if hq.shape[1] > 64:
            y1, inv_s = fd.up1_s2d16_hbm(y0, q["up1_ps"], stage=_stage_mode())
        else:
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
    _trunk_hifi_mode(), _stage_mode(), _trunk_v3(), _enc1_im2col()  # bad settings raise first
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
                              out_dtype=torch.uint8, fused_epilogue: bool = False,
                              fused_trunk=None) -> torch.Tensor:
    """uint8 NHWC image + style [B, S] -> image (uint8, or [-1,1] float).

    The JAX package's choice of chain by shape and output type
    (``quantized.py:352-400``): at 256² input the all-kernel chain
    ``pallas=("enc", "trunk", "dec")``, 3 + 2*n_res + 3 kernel-site calls
    (one trunk call under ``MSIG_TRUNK_V3=1``); at 512² the same for uint8
    output unless ``MSIG_512_FUSED=0``, with enc0 and up1 as their staged
    sites; at 512² float output and at any other size ``pallas=("trunk",)``,
    the unfused encoder and decoder around the kernel trunk. That is
    ``fused_trunk`` None (the JAX package's choice on its accelerator) or True;
    False runs the unfused chain throughout, ``_xla_trunk(fused_epilogue)``
    between the unfused encoder and decoder."""
    if fused_trunk is False:
        h = _xla_trunk(q, _xla_encoder(q, img_u8), style, n_res, fused_epilogue)
        return _xla_decoder(q, h, out_dtype)
    fused_512 = _env_choice("MSIG_512_FUSED", "1", ("0", "1")) == "1"
    side = tuple(img_u8.shape[1:3])
    all_kernels = side == (256, 256) or (
        side == (512, 512) and out_dtype == torch.uint8 and fused_512)
    return quantized_generator_apply_staged(q, img_u8, style, n_res, out_dtype,
                                            pallas=ALL_STAGES if all_kernels else ("trunk",))
