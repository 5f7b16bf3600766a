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

Parameters, moments and EMA copies are updated in place; the metrics come
back as 0-d tensors on the device, so a step needs no host sync.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from msig_tpu_torch.losses import (
    l1_loss,
    lsgan_fake,
    lsgan_real,
    style_content_loss,
    style_content_loss_pair,
)
from msig_tpu_torch.losses.vgg import VGGPrefix
from msig_tpu_torch.train.schedule import WEIGHT_KEYS
from msig_tpu_torch.train.state import G_KEYS, TrainState, clip_adam_update_, ema_update_

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


# Options of the JAX step that this port does not run yet, with the ROADMAP.md
# Queue 1 item that brings them.
_NOT_PORTED = {
    "r1_gamma": "Queue 1 item 11 (extensions: R1 penalty)",
    "style_recon_weight": "Queue 1 item 11 (extensions: style reconstruction loss)",
    "diversity_weight": "Queue 1 item 11 (extensions: diversity loss)",
    "remat": "Queue 1 item 7 (remat as torch.utils.checkpoint)",
    "grad_hists": "Queue 1 item 7 (train/watch.py gradient histograms)",
}


def check_ported(**options) -> None:
    """Raise NotImplementedError for a non-default value of an option not ported yet."""
    for name, value in options.items():
        if value:
            raise NotImplementedError(f"{name}={value!r} is not yet ported to msig_tpu_torch: "
                                      f"{_NOT_PORTED[name]}")


def make_train_step(
    ema_beta: float,
    compute_dtype=torch.float32,
    r1_gamma: float = 0.0,
    remat: bool = False,
    style_recon_weight: float = 0.0,
    diversity_weight: float = 0.0,
    grad_hists: int = 0,
    grad_clip_norm: float = 1.0,
    adam_b1: float = 0.5,
    adam_b2: float = 0.999,
) -> StepFn:
    """Returns ``fn(state, batch, vgg, g_lr, d_lr, loss_weights) -> metrics``.

    ``loss_weights`` are the five weights in ``WEIGHT_KEYS`` order. The
    metrics are D_loss, G_loss, the five unweighted terms and the pre-clip
    global grad norms of the G and D groups."""
    check_ported(r1_gamma=r1_gamma, remat=remat, style_recon_weight=style_recon_weight,
                 diversity_weight=diversity_weight, grad_hists=grad_hists)
    if compute_dtype != torch.float32:
        raise NotImplementedError(f"compute_dtype {compute_dtype} is not yet ported to "
                                  "msig_tpu_torch (Queue 1 item 7: bf16 as autocast); the port "
                                  "trains in float32")

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
                id_B, fake_B = G_A2B(torch.cat([real_B, real_A]),
                                     torch.cat([style_B, style_B])).chunk(2)
                fake_A, cyc_A = G_B2A(torch.cat([real_B, fake_B]),
                                      torch.cat([style_A, style_A])).chunk(2)
            else:
                id_B = G_A2B(real_B, style_B)
                fake_B = G_A2B(real_A, style_B)
                fake_A = G_B2A(real_B, style_A)
                cyc_A = G_B2A(fake_B, style_A)
            loss_identity = l1_loss(id_B, real_B)
            cyc_B = G_A2B(fake_A, style_B)

            loss_gan_A2B = lsgan_real(D_B(fake_B, y_trg))
            loss_gan_B2A = lsgan_real(D_A(fake_A, y_org))
            if batched:
                (content_B, style_loss_B), (content_A, style_loss_A) = \
                    style_content_loss_pair(vgg, fake_B, real_B, real_A, fake_A)
            else:
                content_B, style_loss_B = style_content_loss(vgg, fake_B, real_B, real_A)
                content_A, style_loss_A = style_content_loss(vgg, fake_A, real_A, real_B)

            individual = {
                "gan": (loss_gan_A2B + loss_gan_B2A) / 2,
                "cycle": (l1_loss(cyc_A, real_A) + l1_loss(cyc_B, real_B)) / 2,
                "identity": loss_identity,
                "content": (content_A + content_B) / 2,
                "style": (style_loss_A + style_loss_B) / 2,
            }
            w = dict(zip(WEIGHT_KEYS, loss_weights))
            g_loss = sum(individual[k] * w[k] for k in WEIGHT_KEYS)
            g_grads = torch.autograd.grad(g_loss, g_params, allow_unused=True)
        finally:
            for p in d_params:
                p.requires_grad_(True)

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
        d_grads = torch.autograd.grad(d_loss, d_params)
        d_norm = adam(d_params, d_grads, state.opt_d, d_lr)
        state.step += 1

        metrics = {"D_loss": d_loss, "G_loss": g_loss, **individual,
                   "g_grad_norm": g_norm, "d_grad_norm": d_norm}
        return {k: v.detach() for k, v in metrics.items()}

    return train_step
