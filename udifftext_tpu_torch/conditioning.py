"""Conditioning for the shipped embedder graph (port of
`udifftext_tpu/conditioning.py:43-132`): LabelEncoder → t_crossattn, and
concat = [bilinear ×multiplier mask (1 ch), scaled VAE latent of the masked
image (4 ch)], NHWC. For training, the label embedding is dropped per
sample (classifier-free guidance dropout) by a keep mask drawn as
Bernoulli(1 − ucg_rate_label).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .models.label_encoder import LabelEncoder
from .models.vae import AutoencoderKL, DiagonalGaussian


def spatial_rescale(x: torch.Tensor, multiplier: float = 0.125) -> torch.Tensor:
    """Bilinear resize of NHWC x by `multiplier` (align_corners=False, no
    antialiasing: F.interpolate's semantics, as the reference rescaler)."""
    b, h, w, c = x.shape
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(int(h * multiplier), int(w * multiplier)),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class Conditioner:
    """Builds the cond dict of a batch, for sampling or (with a keep mask)
    for training."""

    label_encoder: LabelEncoder
    vae: AutoencoderKL
    scale_factor: float = 0.18215
    mask_multiplier: float = 0.125
    ucg_rate_label: float = 0.0

    def draw_ucg_keep(self, n: int, generator: Optional[torch.Generator] = None,
                      device: torch.device | str = "cpu") -> Optional[torch.Tensor]:
        """The training label-dropout mask (n,) fp32: 1 keeps a sample's label
        embedding (probability 1 − ucg_rate_label), 0 zeroes it; None when
        the rate is 0."""
        if self.ucg_rate_label <= 0.0:
            return None
        u = torch.rand(n, generator=generator, device=device)
        return (u < 1.0 - self.ucg_rate_label).float()

    def encode_masked(self, masked: torch.Tensor,
                      posterior_eps: Optional[torch.Tensor]) -> torch.Tensor:
        """Scaled latent of the masked image: a posterior sample for the given
        standard-normal `posterior_eps`, or the posterior mode for None."""
        post = DiagonalGaussian(self.vae.encode_moments(masked))
        z = post.mode() if posterior_eps is None else post.sample(posterior_eps.to(post.mean.dtype))
        return self.scale_factor * z

    def __call__(self, batch: Dict[str, torch.Tensor],
                 posterior_eps: Optional[torch.Tensor] = None,
                 force_zero_label: bool = False,
                 ucg_keep: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The cond dict; `ucg_keep` (B,) multiplies the label embedding (the
        training dropout, `draw_ucg_keep`)."""
        t_emb = self.label_encoder(batch["label_ids"])
        if ucg_keep is not None:
            t_emb = t_emb * ucg_keep.to(t_emb.dtype)[:, None, None]
        if force_zero_label:
            t_emb = torch.zeros_like(t_emb)
        mask_small = spatial_rescale(batch["mask"], self.mask_multiplier)
        z_masked = self.encode_masked(batch["masked"], posterior_eps)
        concat = torch.cat([mask_small, z_masked.to(mask_small.dtype)], dim=-1)
        return {"t_crossattn": t_emb, "concat": concat}

    def get_unconditional_conditioning(
        self, batch: Dict[str, torch.Tensor], posterior_eps: Optional[torch.Tensor] = None,
        force_uc_zero_label: bool = True, batch_uc: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(c, uc). Without `batch_uc` and with the forced zero, uc differs
        from c only in the zeroed label embedding, so it shares c's concat
        (one VAE encode, one posterior sample). Otherwise uc is encoded from
        `batch_uc` (or `batch`) with the same `posterior_eps`, its label
        embedding zeroed under `force_uc_zero_label`."""
        c = self(batch, posterior_eps)
        if batch_uc is None and force_uc_zero_label:
            return c, {"t_crossattn": torch.zeros_like(c["t_crossattn"]), "concat": c["concat"]}
        src = batch if batch_uc is None else batch_uc
        return c, self(src, posterior_eps, force_zero_label=force_uc_zero_label)
