"""VAE adversarial training: the LPIPS + PatchGAN loss and the two optimizer
steps (port of `udifftext_tpu/diffusion/vae_loss.py`).

The reference's AutoencodingEngine training path: GeneralLPIPSWithDiscriminator
driven by the alternating-optimizer training_step. Images are NHWC in
[-1, 1]. The perceptual net is a callable `perceptual_fn(x, y) -> (B,)` on
NHWC pairs (for example `models.lpips.LPIPSAlex` behind a permute). Where
the JAX build takes an `rng`, the port takes the posterior's standard-normal
noise `eps` (the mean's shape), so a run can replay the JAX build's draws.

`make_vae_train_steps` returns the two halves of the alternating loop:
`ae_step` moves the VAE only (its optimizer holds the VAE's parameters) and
runs the discriminator in train mode (batch statistics) on copies of its
buffers, so its running statistics come out bit for bit; `disc_step` moves the
discriminator only and advances its running statistics, real batch then
reconstructions, through the one module.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import image_resize
from ..models.vae import AutoencoderKL, DiagonalGaussian

Tensor = torch.Tensor
Log = Dict[str, Tensor]


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """`value` before step `threshold`, `weight` from it on."""
    return value if global_step < threshold else weight


def diagonal_gaussian_regularizer(z: Tensor, eps: Optional[Tensor] = None,
                                  sample: bool = True) -> Tuple[Tensor, Log]:
    """Moments z → the posterior's sample (mean + std·eps) or mode, and the
    KL summed over each sample and averaged over the batch as "kl_loss"."""
    posterior = DiagonalGaussian(z)
    if sample and eps is None:
        raise ValueError("diagonal_gaussian_regularizer(sample=True) requires the posterior "
                         "noise (pass eps=..., or sample=False for the posterior mode)")
    out = posterior.sample(eps) if sample else posterior.mode()
    kl = posterior.kl()
    return out, {"kl_loss": kl.sum() / kl.shape[0]}


class DiagonalGaussianRegularizer:
    """The config-instantiable form (`regularizer_config` target)."""

    def __init__(self, sample: bool = True):
        self.sample = sample

    def __call__(self, z: Tensor, eps: Optional[Tensor] = None) -> Tuple[Tensor, Log]:
        return diagonal_gaussian_regularizer(z, eps=eps, sample=self.sample)


def measure_perplexity(predicted_indices: Tensor, num_centroids: int) -> Tuple[Tensor, Tensor]:
    """Cluster-usage perplexity of VQ codes (num_centroids when all are used
    equally) and the number of clusters used."""
    encodings = F.one_hot(predicted_indices.reshape(-1).long(), num_centroids).float()
    avg_probs = encodings.mean(dim=0)
    perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
    return perplexity, torch.sum(avg_probs > 0)


def latent_lpips_loss(
    decode_fn: Callable[[Tensor], Tensor],
    perceptual_fn: Callable[[Tensor, Tensor], Tensor],
    latent_inputs: Tensor,
    latent_predictions: Tensor,
    image_inputs: Optional[Tensor] = None,
    split: str = "train",
    perceptual_weight: float = 1.0,
    latent_weight: float = 1.0,
    perceptual_weight_on_inputs: float = 0.0,
    scale_input_to_tgt_size: bool = False,
    scale_tgt_to_input_size: bool = False,
) -> Tuple[Tensor, Log]:
    """LatentLPIPS: latent L2 plus the perceptual distance of the two
    latents' decodes, and optionally a perceptual term against the original
    pixels, one side resized to the other by jax.image.resize's bicubic
    (antialiased when it shrinks). With perceptual_weight 0 the loss stays
    the elementwise L2, as in the reference."""
    log: Log = {}
    l2 = (latent_inputs - latent_predictions) ** 2
    log[f"{split}/latent_l2_loss"] = l2.mean()
    loss = l2
    recons = None
    if perceptual_weight > 0.0:
        recons = decode_fn(latent_predictions)
        targets = decode_fn(latent_inputs)
        p = perceptual_fn(targets, recons)
        loss = latent_weight * l2.mean() + perceptual_weight * p.mean()
        log[f"{split}/perceptual_loss"] = p.mean()
    if perceptual_weight_on_inputs > 0.0:
        if recons is None:
            recons = decode_fn(latent_predictions)
        if image_inputs is None:
            raise ValueError("perceptual_weight_on_inputs needs image_inputs")
        if scale_input_to_tgt_size:
            image_inputs = image_resize(image_inputs, recons.shape[1:3], "bicubic")
        elif scale_tgt_to_input_size:
            recons = image_resize(recons, image_inputs.shape[1:3], "bicubic")
        p2 = perceptual_fn(image_inputs, recons)
        loss = loss + perceptual_weight_on_inputs * p2.mean()
        log[f"{split}/perceptual_loss_on_inputs"] = p2.mean()
    return loss, log


def hinge_d_loss(logits_real: Tensor, logits_fake: Tensor) -> Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: Tensor, logits_fake: Tensor) -> Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


@dataclasses.dataclass(frozen=True)
class VAEGanLossConfig:
    disc_start: int = 0
    pixelloss_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    disc_loss: str = "hinge"  # or "vanilla"
    kl_weight: float = 1e-6   # regularization_weights["kl_loss"]
    logvar_init: float = 0.0


def _nll(cfg: VAEGanLossConfig, x: Tensor, xrec: Tensor, logvar: Tensor,
         perceptual_fn) -> Tuple[Tensor, Tensor]:
    rec = torch.abs(x - xrec) * cfg.pixelloss_weight
    if cfg.perceptual_weight > 0.0 and perceptual_fn is not None:
        rec = rec + cfg.perceptual_weight * perceptual_fn(x, xrec).reshape(-1, 1, 1, 1)
    nll = rec / torch.exp(logvar) + logvar
    return nll.sum() / x.shape[0], rec.mean()


def on_batch_statistics(disc: torch.nn.Module, x: Tensor) -> Tensor:
    """disc(x) in train mode (its BatchNorms normalize by the batch's
    statistics), its running statistics left as they were: the pass
    updates copies of the buffers. The module's mode is restored."""
    was_training = disc.training
    disc.train()
    try:
        return torch.func.functional_call(
            disc, {name: b.clone() for name, b in disc.named_buffers()}, (x,))
    finally:
        disc.train(was_training)


def generator_loss(cfg: VAEGanLossConfig, vae: AutoencoderKL, disc: torch.nn.Module,
                   logvar: Tensor, x: Tensor, eps: Tensor, global_step: int,
                   perceptual_fn: Optional[Callable] = None) -> Tuple[Tensor, Log]:
    """The VAE's loss: NLL (L1 plus perceptual, over exp(logvar)) +
    adaptive-weighted generator GAN loss + KL. The adaptive weight is
    ‖∇nll‖ / (‖∇g‖ + 1e-4) with respect to the decoder's conv_out weight,
    clipped to [0, 1e4], times disc_weight, detached. The discriminator runs
    on batch statistics and leaves its running statistics as they were."""
    post = DiagonalGaussian(vae.encode_moments(x))
    z = post.sample(eps)
    kl = post.kl().mean()
    xrec = vae.decode(z)
    nll_loss, rec_loss = _nll(cfg, x, xrec, logvar, perceptual_fn)
    g_loss = -on_batch_statistics(disc, xrec).mean()

    if cfg.disc_factor > 0.0:
        last = vae.decoder.conv_out.weight
        nll_g, = torch.autograd.grad(nll_loss, last, retain_graph=True)
        gan_g, = torch.autograd.grad(g_loss, last, retain_graph=True)
        d_weight = torch.linalg.vector_norm(nll_g) / (torch.linalg.vector_norm(gan_g) + 1e-4)
        d_weight = (torch.clamp(d_weight, 0.0, 1e4) * cfg.disc_weight).detach()
    else:
        d_weight = torch.zeros((), device=x.device)

    disc_factor = adopt_weight(cfg.disc_factor, global_step, cfg.disc_start)
    loss = nll_loss + d_weight * disc_factor * g_loss + cfg.kl_weight * kl
    log = {"loss/total_loss": loss, "loss/nll_loss": nll_loss, "loss/rec_loss": rec_loss,
           "loss/kl_loss": kl, "loss/g_loss": g_loss, "loss/d_weight": d_weight,
           "loss/logvar": logvar}
    return loss, {k: v.detach() for k, v in log.items()}


def discriminator_loss(cfg: VAEGanLossConfig, vae: AutoencoderKL, disc: torch.nn.Module,
                       x: Tensor, eps: Tensor, global_step: int,
                       train_bn: bool = True) -> Tuple[Tensor, Log]:
    """The discriminator's loss on the real batch and the (detached)
    reconstructions, one after the other through the module: with
    `train_bn`, on batch statistics, each pass advancing the running
    statistics; otherwise on the running statistics."""
    with torch.no_grad():
        xrec = vae.decode(DiagonalGaussian(vae.encode_moments(x)).sample(eps))
    d_fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
    was_training = disc.training
    disc.train(train_bn)
    try:
        logits_real = disc(x)
        logits_fake = disc(xrec)
    finally:
        disc.train(was_training)
    d_loss = adopt_weight(cfg.disc_factor, global_step, cfg.disc_start) * d_fn(logits_real,
                                                                                logits_fake)
    log = {"loss/disc_loss": d_loss, "loss/logits_real": logits_real.mean(),
           "loss/logits_fake": logits_fake.mean()}
    return d_loss, {k: v.detach() for k, v in log.items()}


def make_vae_train_steps(cfg: VAEGanLossConfig, vae: AutoencoderKL, disc: torch.nn.Module,
                         ae_optimizer: torch.optim.Optimizer,
                         disc_optimizer: torch.optim.Optimizer,
                         perceptual_fn: Optional[Callable] = None):
    """(ae_step, disc_step), the two halves of the alternating optimizer
    loop. `ae_optimizer` holds the VAE's parameters, `disc_optimizer` the
    discriminator's. Each step is `step(ae_state, x, eps) -> (loss, log)`
    with `ae_state = {"logvar": 0-d tensor, "step": int}` (logvar is not
    learned); both read `ae_state["step"]` for `disc_start`, and `ae_step`
    advances it."""
    vae_params = [p for p in vae.parameters() if p.requires_grad]
    disc_params = [p for p in disc.parameters() if p.requires_grad]

    def ae_step(ae_state: Dict, x: Tensor, eps: Tensor) -> Tuple[Tensor, Log]:
        ae_optimizer.zero_grad(set_to_none=True)
        loss, log = generator_loss(cfg, vae, disc, ae_state["logvar"], x, eps,
                                   ae_state["step"], perceptual_fn)
        loss.backward(inputs=vae_params)
        ae_optimizer.step()
        ae_state["step"] += 1
        return loss.detach(), log

    def disc_step(ae_state: Dict, x: Tensor, eps: Tensor) -> Tuple[Tensor, Log]:
        disc_optimizer.zero_grad(set_to_none=True)
        d_loss, log = discriminator_loss(cfg, vae, disc, x, eps, ae_state["step"])
        d_loss.backward(inputs=disc_params)
        disc_optimizer.step()
        return d_loss.detach(), log

    return ae_step, disc_step
