"""One train step: G update + EMA + D update (counterpart of ``msig_tpu/train/step.py``).

The reference runs a G phase, an EMA pass and a D phase per step
(reference trainer.py:74-155); this is the JAX package's fused step, term for
term, in eager PyTorch:

  - the G loss (five weighted terms) is differentiated jointly over the G
    group {G_A2B, G_B2A, SE_A, SE_B}; D_A and D_B score the fakes with their
    pre-update parameters, which are frozen (``requires_grad`` off) for the
    G phase, so the G update sees no D gradient and none is left for the D
    update;
  - clip by global norm, then Adam, then EMA (beta 0.995) after the G update
    (trainer.py:131-134);
  - the D phase trains on the detached fakes of the pre-update generator
    (trainer.py:146-147), with its own clip and Adam;
  - at batch <= ``BATCH_FORWARDS_MAX`` (16) the independent forwards through
    one network share a launch: 2B, 2B and B generator forwards and one 4B
    VGG forward; above it each runs on its own (``step.py:115-164``).

``compute_dtype=torch.bfloat16`` casts as the JAX step does: the images are
prepared in bf16, so every conv, ConvTranspose and dense layer (and the VGG
prefix) runs in bf16 on the fp32 parameters cast at the call; instance-norm
and AdaIN statistics and the affine run in fp32 and cast back
(``ops/norm.py``), the Grams and every loss mean in fp32; the master
parameters, the gradients, clip, Adam and EMA stay fp32. The explicit casts
are threaded through the modules (``models/layers.py``); no autocast. The
training kernels of ``MSIG_CONV_VJP=1|2`` (``conv3x3_bwd``,
``conv3x3_adain_bwd``) then run their bf16 entries, as the JAX package's
Pallas kernels run in bf16: bf16 x, taps and cotangent, fp32 accumulation,
the unit's dy rounded to bf16, dx in bf16 and dW in fp32
(``ops/conv3x3_vjp.py``); ``adain_pallas`` takes bf16 too.

The JAX step's options, each off by default (``step.py:52-101``):

  - ``remat``: ``True`` recomputes every generator launch in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
    activations, ``"cycle"`` only the cycle launches (the ``G_B2A`` launch
    over [real_B, fake_B] and ``cyc_B``; unbatched, ``cyc_A`` and ``cyc_B``);
    the losses and gradients are those of the step without it, to the bit
    where the recomputed forward gives the first one's bits;
  - ``style_recon_weight`` (extension): + w * (L1(SE_B(fake_B), style_B) +
    L1(SE_A(fake_A), style_A)) / 2, the term ``style_recon``;
  - ``diversity_weight`` (extension): with a second image of the target
    domain (``batch["target2"]``, ``TrainLoader(second_target=True)``),
    + w * -L1(G_A2B(real_A, SE_B(target2)), fake_B), the term
    ``diversity``, one more generator launch;
  - ``r1_gamma`` (extension): + gamma / 2 * (R1(D_A, real_A) + R1(D_B, real_B))
    on the D loss (``extensions/r1.py``), a double backward through D;
  - ``grad_hists``: also the histogram of every gradient, ``grad_hists`` bins
    each, binned on the device from the gradients that clip and Adam take
    (``train/watch.py``), under ``metrics["_grad_hists"]``.

``distributed=True`` (data parallelism over the default process group,
``parallel/mesh.py``): each rank runs the step on its rows of the global
batch; the batch-coupled Grams of the style loss are formed over the global
batch (``gather_rows``), as the JAX step forms them under its mesh; after each
phase's backward, before clip, Adam and EMA, its gradients are averaged over
the ranks in one flat bucket, and so are the metrics. Every other term is a
per-sample mean, so the mean of the ranks' gradients of equal shards is the
gradient of the global batch: every rank applies the same update, and the
parameters stay equal without a broadcast. The structure choice below keys
off the rows a rank holds, as the JAX step's ``n_devices`` does.

Parameters, moments and EMA copies are updated in place; the metrics come
back as 0-d tensors on the device, so a step needs no host sync.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Union

import torch
from torch.utils.checkpoint import checkpoint

from msig_tpu_torch.extensions.r1 import r1_penalty
from msig_tpu_torch.losses import (
    l1_loss,
    lsgan_fake,
    lsgan_real,
    style_content_loss,
    style_content_loss_pair,
)
from msig_tpu_torch.losses.vgg import VGGPrefix
from msig_tpu_torch.ops.gram import gram_nchw
from msig_tpu_torch.parallel.mesh import all_reduce_mean_, gather_rows
from msig_tpu_torch.train.schedule import WEIGHT_KEYS
from msig_tpu_torch.train.state import (
    D_KEYS,
    G_KEYS,
    TrainState,
    clip_adam_update_,
    ema_update_,
)
from msig_tpu_torch.train.watch import gradient_histograms

Batch = Dict[str, torch.Tensor]
StepFn = Callable[[TrainState, Batch, VGGPrefix, float, float, Sequence[float]],
                  Dict[str, torch.Tensor]]

# Largest batch whose independent forwards share a launch (the JAX step's
# ``shard <= 16``, ``step.py:123-125``).
BATCH_FORWARDS_MAX = 16


def prepare_images(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> [-1, 1] float; float inputs pass through (cast only)."""
    if x.dtype == torch.uint8:
        return x.to(dtype) / 127.5 - 1.0
    return x.to(dtype)


def _run(net, *args):
    return net(*args)


def _remat(net, *args):
    """``net(*args)``, its activations recomputed in the backward instead of kept."""
    return checkpoint(net, *args, use_reentrant=False)


def make_train_step(
    ema_beta: float,
    compute_dtype=torch.float32,
    r1_gamma: float = 0.0,
    remat: Union[bool, str] = False,
    style_recon_weight: float = 0.0,
    diversity_weight: float = 0.0,
    grad_hists: int = 0,
    grad_clip_norm: float = 1.0,
    adam_b1: float = 0.5,
    adam_b2: float = 0.999,
    distributed: bool = False,
) -> StepFn:
    """Returns ``fn(state, batch, vgg, g_lr, d_lr, loss_weights) -> metrics``.

    ``loss_weights`` are the five weights in ``WEIGHT_KEYS`` order. The
    metrics are D_loss, G_loss, the five unweighted terms (and ``style_recon``
    and ``diversity`` when their weights are on), the pre-clip global grad
    norms of the G and D groups and, with ``grad_hists``, ``_grad_hists``."""
    if remat not in (False, True, "cycle"):
        raise ValueError(f"remat must be False, True or 'cycle', got {remat!r}")
    gen_apply = _remat if remat is True else _run
    gen_apply_cyc = _remat if remat else _run  # "cycle" (or True) remats the cycle launches
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be torch.float32 or torch.bfloat16, got "
                         f"{compute_dtype}")

    def global_gram(f):
        return gram_nchw(gather_rows(f))

    gram = global_gram if distributed else gram_nchw

    def average(params, grads):
        """Each gradient (zeros for an unused parameter) as its mean over the ranks."""
        if not distributed:
            return grads
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        all_reduce_mean_(grads)
        return grads

    def adam(params, grads, opt, lr):
        return clip_adam_update_(params, grads, opt, lr, grad_clip_norm, adam_b1, adam_b2)

    def train_step(state: TrainState, batch: Batch, vgg: VGGPrefix, g_lr: float, d_lr: float,
                   loss_weights: Sequence[float]) -> Dict[str, torch.Tensor]:
        nets = state.models.nets
        G_A2B, G_B2A, SE_A, SE_B = (nets[k] for k in G_KEYS)
        D_A, D_B = nets["D_A"], nets["D_B"]
        real_A = prepare_images(batch["source"], compute_dtype)
        real_B = prepare_images(batch["target"], compute_dtype)
        batched = real_A.shape[0] <= BATCH_FORWARDS_MAX
        y_org = batch["source_domain"].to(torch.long)
        y_trg = batch["target_domain"].to(torch.long)
        g_params, d_params = state.models.g_params(), state.models.d_params()

        # ---------------- Generator phase (D frozen: it only scores the fakes)
        for p in d_params:
            p.requires_grad_(False)
        try:
            style_A = SE_A(real_A, y_org)
            style_B = SE_B(real_B, y_trg)
            if batched:
                id_B, fake_B = gen_apply(G_A2B, torch.cat([real_B, real_A]),
                                         torch.cat([style_B, style_B])).chunk(2)
                fake_A, cyc_A = gen_apply_cyc(G_B2A, torch.cat([real_B, fake_B]),
                                              torch.cat([style_A, style_A])).chunk(2)
            else:
                id_B = gen_apply(G_A2B, real_B, style_B)
                fake_B = gen_apply(G_A2B, real_A, style_B)
                fake_A = gen_apply(G_B2A, real_B, style_A)
                cyc_A = gen_apply_cyc(G_B2A, fake_B, style_A)
            loss_identity = l1_loss(id_B, real_B)
            cyc_B = gen_apply_cyc(G_A2B, fake_A, style_B)

            loss_gan_A2B = lsgan_real(D_B(fake_B, y_trg))
            loss_gan_B2A = lsgan_real(D_A(fake_A, y_org))
            if batched:
                (content_B, style_loss_B), (content_A, style_loss_A) = \
                    style_content_loss_pair(vgg, fake_B, real_B, real_A, fake_A, gram=gram)
            else:
                content_B, style_loss_B = style_content_loss(vgg, fake_B, real_B, real_A, gram)
                content_A, style_loss_A = style_content_loss(vgg, fake_A, real_A, real_B, gram)

            individual = {
                "gan": (loss_gan_A2B + loss_gan_B2A) / 2,
                "cycle": (l1_loss(cyc_A, real_A) + l1_loss(cyc_B, real_B)) / 2,
                "identity": loss_identity,
                "content": (content_A + content_B) / 2,
                "style": (style_loss_A + style_loss_B) / 2,
            }
            w = dict(zip(WEIGHT_KEYS, loss_weights))
            g_loss = sum(individual[k] * w[k] for k in WEIGHT_KEYS)
            if style_recon_weight > 0.0:
                individual["style_recon"] = (l1_loss(SE_B(fake_B, y_trg), style_B)
                                             + l1_loss(SE_A(fake_A, y_org), style_A)) / 2
                g_loss = g_loss + style_recon_weight * individual["style_recon"]
            if diversity_weight > 0.0:
                style_B2 = SE_B(prepare_images(batch["target2"], compute_dtype), y_trg)
                individual["diversity"] = -l1_loss(gen_apply(G_A2B, real_A, style_B2), fake_B)
                g_loss = g_loss + diversity_weight * individual["diversity"]
            g_grads = average(g_params, torch.autograd.grad(g_loss, g_params, allow_unused=True))
        finally:
            for p in d_params:
                p.requires_grad_(True)

        # clip and Adam read the gradients without writing them: the histograms
        # below bin the same values
        g_by_net = _by_net(nets, G_KEYS, g_grads) if grad_hists else None
        g_norm = adam(g_params, g_grads, state.opt_g, g_lr)
        del g_grads
        # ---------------- EMA (after the G update, reference trainer.py:131-134)
        ema = state.models.ema
        ema_update_([e for k in G_KEYS for e in ema[k].parameters()], g_params, ema_beta)

        # ---------------- Discriminator phase, on the detached fakes
        fake_A_sg, fake_B_sg = fake_A.detach(), fake_B.detach()
        if batched:
            pa_real, pa_fake = D_A(torch.cat([real_A, fake_A_sg]), torch.cat([y_org, y_org])).chunk(2)
            pb_real, pb_fake = D_B(torch.cat([real_B, fake_B_sg]), torch.cat([y_trg, y_trg])).chunk(2)
        else:
            pa_real, pa_fake = D_A(real_A, y_org), D_A(fake_A_sg, y_org)
            pb_real, pb_fake = D_B(real_B, y_trg), D_B(fake_B_sg, y_trg)
        d_loss = (lsgan_real(pa_real) + lsgan_fake(pa_fake)
                  + lsgan_real(pb_real) + lsgan_fake(pb_fake)) / 2
        if r1_gamma > 0.0:
            d_loss = d_loss + (r1_gamma / 2.0) * (r1_penalty(D_A, real_A, y_org)
                                                  + r1_penalty(D_B, real_B, y_trg))
        d_grads = average(d_params, torch.autograd.grad(d_loss, d_params))
        d_norm = adam(d_params, d_grads, state.opt_d, d_lr)
        state.step += 1

        metrics = {"D_loss": d_loss, "G_loss": g_loss, **individual,
                   "g_grad_norm": g_norm, "d_grad_norm": d_norm}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if distributed:
            all_reduce_mean_(list(metrics.values()))
        if grad_hists:
            names = {k: [n for n, _ in nets[k].named_parameters()] for k in G_KEYS + D_KEYS}
            metrics["_grad_hists"] = gradient_histograms(
                g_by_net, _by_net(nets, D_KEYS, d_grads), names, bins=grad_hists)
        return metrics

    return train_step


def _by_net(nets, keys, grads) -> Dict[str, list]:
    """A group's flat gradient list -> {net: its gradients}, a None (an unused
    parameter) as zeros, as clip and Adam take it."""
    out, it = {}, iter(grads)
    for k in keys:
        out[k] = [g if g is not None else torch.zeros_like(p)
                  for p, g in zip(nets[k].parameters(), it)]
    return out
