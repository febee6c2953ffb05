"""DiffusionEngine, the sampling half (port of `udifftext_tpu/engine.py`).

`sample` runs the inference path of test.py / demo.py: conditioning (label
embedding, mask rescale, VAE encode of the masked image), the init-noise
search (candidates scored by the min-local attention loss after a 2-step
rollout), the CFG Euler-EDM loop and the VAE decode.

Noise is injectable: `posterior_eps` (the VAE posterior's standard-normal
draw) and `noise` (the search's candidates) may be given explicitly;
otherwise both are drawn from `generator`, eps first. This is how the port
is held to the JAX engine, whose threefry draws torch cannot reproduce.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from .conditioning import Conditioner
from .diffusion import sampling as SP
from .diffusion.denoiser import DiscreteDenoiser
from .diffusion.guiders import VanillaCFG
from .diffusion.loss import LocalLossConfig, min_local_loss
from .diffusion.schedules import LegacyDDPMDiscretization, append_dims
from .models.label_encoder import LabelEncoder
from .models.unet import UNetModel
from .models.vae import AutoencoderKL

Batch = Dict[str, torch.Tensor]


class DiffusionEngine(nn.Module):
    def __init__(
        self,
        unet: UNetModel,
        vae: AutoencoderKL,
        label_encoder: LabelEncoder,
        denoiser: DiscreteDenoiser = DiscreteDenoiser(),
        discretization: LegacyDDPMDiscretization = LegacyDDPMDiscretization(),
        loss_cfg: LocalLossConfig = LocalLossConfig(),
        scale_factor: float = 0.18215,
        mask_multiplier: float = 0.125,
        latent_factor: int = 8,
    ):
        super().__init__()
        self.unet, self.vae, self.label_encoder = unet, vae, label_encoder
        self.denoiser = denoiser
        self.discretization = discretization
        self.loss_cfg = loss_cfg
        self.scale_factor = scale_factor
        self.mask_multiplier = mask_multiplier
        self.latent_factor = latent_factor

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def conditioner(self) -> Conditioner:
        return Conditioner(self.label_encoder, self.vae, self.scale_factor, self.mask_multiplier)

    def conditionings(self, batch: Batch, posterior_eps: Optional[torch.Tensor] = None):
        return self.conditioner.get_unconditional_conditioning(batch, posterior_eps)

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z / self.scale_factor)

    def network(self, capture_attn: bool = False, ctx_kv=None) -> Callable:
        """The UNet with the conditioning's channel concat in front."""

        def net(x: torch.Tensor, c_noise: torch.Tensor, cond: Dict[str, Any]):
            if "concat" in cond:
                x = torch.cat([x, cond["concat"].to(x.dtype)], dim=-1)
            return self.unet(x, c_noise, cond.get("t_crossattn"), cond.get("v_crossattn"),
                             capture_attn=capture_attn, ctx_kv=ctx_kv)

        return net

    def make_denoise_fn(self, c, uc, cfg_scale: float, capture_attn: bool = False):
        """CFG denoiser x, sigma → denoised (and, with capture_attn, the
        conditional half's t_attn maps). The doubled cond dict and its
        cross-attention K/V are computed once, outside the step loop."""
        guider = VanillaCFG(cfg_scale)
        c_in = guider.prepare_cond(c, uc)
        ctx_kv = self.unet.precompute_context_kv(c_in.get("t_crossattn"), c_in.get("v_crossattn"))
        network = self.network(capture_attn, ctx_kv)

        def denoise(x, sigma):
            d, aux = self.denoiser(network, torch.cat([x, x]), torch.cat([sigma, sigma]), c_in)
            if not capture_attn:
                return guider(d, sigma)
            return guider(d, sigma), {k: v[v.shape[0] // 2:] for k, v in aux.items()}

        return denoise

    def _rollout_loss(self, denoise, x, sigmas, mask, seg_mask) -> torch.Tensor:
        """Min-local loss (B,) of the last of two Euler steps from x."""
        kernel = torch.as_tensor(self.loss_cfg.kernel, device=x.device)
        n = x.shape[0]
        loss = None
        for i in range(2):
            sigma = sigmas[i].expand(n).to(x.dtype)
            denoised, aux = denoise(x, sigma)
            loss = min_local_loss(aux, mask, seg_mask, kernel, self.loss_cfg.min_attn_size)
            if i == 0:
                x = x + append_dims(sigmas[1] - sigma, x.ndim) * SP.to_d(x, sigma, denoised)
        return loss

    def get_init_noise(
        self, c, uc, batch: Batch, noise: torch.Tensor, cfg_scale: float = 5.0,
        candidate_batched: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Init-noise search over the candidates `noise` (K, B, h, w, 4):
        each is scored by the summed min-local loss of a 2-step rollout, and
        the lowest score wins (the first on ties). Returns (best (B, h, w, 4),
        scores (K,)).

        candidate_batched=True stacks the candidates on the batch axis: 2 UNet
        evals at batch K·B instead of 2·K at batch B, the same function."""
        k, b = noise.shape[:2]
        sigmas = torch.as_tensor(self.discretization(2, do_append_zero=True), device=noise.device)
        mask, seg_mask = batch["mask"], batch["seg_mask"]
        if candidate_batched:
            def tile(t):
                return torch.cat([t] * k, dim=0)

            denoise = self.make_denoise_fn({n: tile(t) for n, t in c.items()},
                                           {n: tile(t) for n, t in uc.items()},
                                           cfg_scale, capture_attn=True)
            x = SP.init_latent(noise.reshape((k * b,) + noise.shape[2:]), sigmas)
            loss = self._rollout_loss(denoise, x, sigmas, tile(mask), tile(seg_mask))
            scores = loss.reshape(k, b).sum(dim=1)
            return noise[torch.argmin(scores)], scores

        denoise = self.make_denoise_fn(c, uc, cfg_scale, capture_attn=True)
        best = torch.zeros_like(noise[0])
        best_score = torch.tensor(float("inf"), device=noise.device)
        scores = []
        for i in range(k):
            s = self._rollout_loss(denoise, SP.init_latent(noise[i], sigmas), sigmas,
                                   mask, seg_mask).sum()
            better = s < best_score  # strict: the first minimum stays
            best = torch.where(better, noise[i], best)
            best_score = torch.where(better, s, best_score)
            scores.append(s)
        return best, torch.stack(scores)

    @torch.no_grad()
    def sample(
        self,
        batch: Batch,
        generator: Optional[torch.Generator] = None,
        num_steps: int = 50,
        cfg_scale: float = 5.0,
        noise_iters: int = 10,
        aae_enabled: bool = False,
        detailed: bool = False,
        noise_search_batched: bool = False,
        posterior_eps: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        return_latents: bool = False,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Text inpainting (test.py predict() semantics) → (images in [0, 1]
        (B, H, W, 3), aux). aux["noise_scores"] holds the search's scores.

        posterior_eps: (B, h, w, 4) standard normal; noise: (max(noise_iters,
        1), B, h, w, 4) standard normal, with (h, w) the latent size."""
        if aae_enabled or detailed:
            raise NotImplementedError(
                "attend-and-excite (aae_enabled) and attention-map capture (detailed) "
                "are not ported yet"
            )
        b, h, w = batch["masked"].shape[:3]
        shape = (b, h // self.latent_factor, w // self.latent_factor, 4)
        dev = self.device
        if posterior_eps is None:
            posterior_eps = torch.randn(shape, generator=generator, device=dev)
        if noise is None:
            noise = torch.randn((max(noise_iters, 1),) + shape, generator=generator, device=dev)
        if noise.shape[1:] != shape or noise.shape[0] != max(noise_iters, 1):
            raise ValueError(f"noise must be {(max(noise_iters, 1),) + shape}, "
                             f"got {tuple(noise.shape)}")

        c, uc = self.conditionings(batch, posterior_eps)
        aux: Dict[str, torch.Tensor] = {}
        if noise_iters > 0:
            x0, aux["noise_scores"] = self.get_init_noise(
                c, uc, batch, noise, cfg_scale, candidate_batched=noise_search_batched
            )
        else:
            x0 = noise[0]
        sigmas = torch.as_tensor(self.discretization(num_steps, do_append_zero=True), device=dev)
        denoise = self.make_denoise_fn(c, uc, cfg_scale)
        z = SP.sample_euler_edm(denoise, SP.init_latent(x0, sigmas), sigmas)
        if return_latents:
            return z, aux
        img = self.decode_first_stage(z)
        return torch.clamp((img + 1.0) / 2.0, 0.0, 1.0), aux
