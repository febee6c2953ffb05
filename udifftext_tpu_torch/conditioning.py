"""Conditioning (port of `udifftext_tpu/conditioning.py`).

`Conditioner` is the fused form of the shipped embedder graph: LabelEncoder
→ t_crossattn, and concat = [bilinear ×multiplier mask (1 ch), scaled VAE
latent of the masked image (4 ch)], NHWC. For training, the label embedding
is dropped per sample (classifier-free guidance dropout) by a keep mask
drawn as Bernoulli(1 − ucg_rate_label).

`GeneralConditioner` runs any other embedder list of a model graph (the
reference GeneralConditioner, modules.py:105-217): each embedder reads its
`input_key` of the batch; its outputs go to their `emb_key` or, without
one, to the key of their rank (OUTPUT_DIM2KEYS: 2 → vector, 3 →
t_crossattn, 4 → concat) and are concatenated on the last axis in list
order; for training each output of an embedder with a `ucg_rate` is
dropped per sample by its own keep mask; `force_zero_keys` zeroes the
outputs of the embedders reading those keys (the unconditional half). Its
embedders are modules in a ModuleList, so their parameters sit in the
engine's state dict; the LabelEncoder and LatentEncoder entries use the
engine's own LabelEncoder and VAE without holding them as submodules.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .models.label_encoder import LabelEncoder
from .models.layers import image_resize
from .models.vae import AutoencoderKL, DiagonalGaussian

# reference modules.py:107 maps rank 3 to "crossattn"; this fork's UNet and
# guider read t_crossattn / v_crossattn, so rank 3 goes to t_crossattn
OUTPUT_DIM2KEYS = {2: "vector", 3: "t_crossattn", 4: "concat", 5: "concat"}

Batch = Dict[str, torch.Tensor]


def spatial_rescale(x: torch.Tensor, multiplier: float = 0.125,
                    method: str = "bilinear") -> torch.Tensor:
    """Resize of NHWC x by `multiplier` without antialiasing, by
    jax.image.resize's `method`: "bilinear" is F.interpolate's
    (align_corners=False), the reference rescaler's; the others go through
    `image_resize` (the half-pixel "nearest", Keys' "bicubic")."""
    b, h, w, c = x.shape
    size = (int(h * multiplier), int(w * multiplier))
    if method != "bilinear":
        return image_resize(x, size, method, antialias=False)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear", align_corners=False,
                      antialias=False)
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


class LabelEncoderEmbedder(nn.Module):
    """The engine's LabelEncoder as a conditioner embedder (not held as a
    submodule: its parameters stay under the engine's `label_encoder`)."""

    def __init__(self, label_encoder: LabelEncoder):
        super().__init__()
        self._shared = (label_encoder,)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self._shared[0](ids)


class SpatialRescaler(nn.Module):
    """`spatial_rescale` applied n_stages times (reference modules.py:842-845:
    staged halvings differ numerically from one direct resize)."""

    def __init__(self, multiplier: float = 0.5, method: str = "bilinear", n_stages: int = 1):
        super().__init__()
        self.multiplier, self.method, self.n_stages = multiplier, method, n_stages

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.n_stages):
            x = spatial_rescale(x, self.multiplier, self.method)
        return x


class LatentEncoder(nn.Module):
    """Scaled latent of the engine's VAE (reference modules.py:999-1014): a
    posterior sample for standard-normal `eps` (drawn from `generator` when
    only that is given), the posterior mode otherwise."""

    takes_eps = True

    def __init__(self, vae: AutoencoderKL, scale_factor: float = 0.18215):
        super().__init__()
        self._shared = (vae,)
        self.scale_factor = scale_factor

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        post = DiagonalGaussian(self._shared[0].encode_moments(x))
        if eps is None and generator is not None:
            eps = torch.randn(post.mean.shape, generator=generator, device=post.mean.device)
        z = post.mode() if eps is None else post.sample(eps.to(post.mean.dtype))
        return self.scale_factor * z


@dataclasses.dataclass(frozen=True)
class EmbedderSpec:
    """How the conditioner routes one embedder of the list: its name
    ("<index>_<target>", the JAX build's params["embedders"] key), the batch
    key it reads, its training dropout rate, its output key (None: by rank)
    and whether its parameters train."""

    name: str
    input_key: str
    ucg_rate: float = 0.0
    emb_key: Optional[str] = None
    is_trainable: bool = False


class GeneralConditioner(nn.Module):
    """The embedder list of a model graph; see the module docstring.

    The draws: a LatentEncoder's posterior ε is `posterior_eps` (every
    LatentEncoder of the list takes the same one), else drawn from
    `generator`, else the posterior mode. A training keep mask (B,) of
    output j of embedder i is `ucg_keep[(i, j)]`, else 1{u < 1 − ucg_rate}
    for u uniform from `generator`, else no dropout."""

    def __init__(self, specs: Sequence[EmbedderSpec], embedders: Sequence[nn.Module]):
        super().__init__()
        if len(specs) != len(embedders):
            raise ValueError("one EmbedderSpec per embedder")
        self.specs = tuple(specs)
        self.embedders = nn.ModuleList(embedders)

    @property
    def trainable_embedders(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.specs if s.is_trainable)

    @property
    def input_keys(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(s.input_key for s in self.specs))

    def draw_ucg_keep(self, n: int, generator: Optional[torch.Generator] = None,
                      device: torch.device | str = "cpu") -> Dict[Tuple[int, int], torch.Tensor]:
        """The training keep masks (n,) fp32 of the single-output embedders
        with a ucg_rate, in list order, keyed (index, 0)."""
        return {(i, 0): (torch.rand(n, generator=generator, device=device)
                         < 1.0 - s.ucg_rate).float()
                for i, s in enumerate(self.specs) if s.ucg_rate > 0.0}

    def _embed(self, batch: Batch, posterior_eps: Optional[torch.Tensor], generator,
               train: bool, ucg_keep) -> List[Tuple[int, str, torch.Tensor]]:
        """(embedder index, output key, output) of every output, in order."""
        parts = []
        for i, (spec, mod) in enumerate(zip(self.specs, self.embedders)):
            x = batch[spec.input_key]
            out = (mod(x, posterior_eps, generator) if getattr(mod, "takes_eps", False)
                   else mod(x))
            for j, emb in enumerate(out if isinstance(out, (tuple, list)) else (out,)):
                if train and spec.ucg_rate > 0.0:
                    keep = (ucg_keep or {}).get((i, j))
                    if keep is None and generator is not None:
                        keep = (torch.rand(emb.shape[0], generator=generator, device=emb.device)
                                < 1.0 - spec.ucg_rate)
                    if keep is not None:
                        emb = emb * keep.to(emb.dtype).reshape((-1,) + (1,) * (emb.ndim - 1))
                parts.append((i, spec.emb_key or OUTPUT_DIM2KEYS[emb.ndim], emb))
        return parts

    def _assemble(self, parts, force_zero_keys: Sequence[str]) -> Batch:
        out: Batch = {}
        for i, key, emb in parts:
            if self.specs[i].input_key in force_zero_keys:
                emb = torch.zeros_like(emb)
            if key in out:
                dt = torch.promote_types(out[key].dtype, emb.dtype)
                emb = torch.cat([out[key].to(dt), emb.to(dt)], dim=-1)
            out[key] = emb
        return out

    def forward(self, batch: Batch, posterior_eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, train: bool = False,
                force_zero_keys: Sequence[str] = (),
                ucg_keep: Optional[Mapping[Tuple[int, int], torch.Tensor]] = None) -> Batch:
        """The cond dict of `batch`."""
        return self._assemble(self._embed(batch, posterior_eps, generator, train, ucg_keep),
                              force_zero_keys)

    def get_unconditional_conditioning(
        self, batch: Batch, posterior_eps: Optional[torch.Tensor] = None,
        batch_uc: Optional[Batch] = None,
        force_uc_zero_keys: Sequence[str] = ("label_ids",),
    ) -> Tuple[Batch, Batch]:
        """(c, uc) without dropout (reference :203-217): uc is c with the
        outputs of the embedders reading `force_uc_zero_keys` zeroed, each
        embedder run once; with `batch_uc`, uc is embedded from it with the
        same posterior draws."""
        if batch_uc is None:
            parts = self._embed(batch, posterior_eps, None, False, None)
            return self._assemble(parts, ()), self._assemble(parts, force_uc_zero_keys)
        c = self(batch, posterior_eps)
        return c, self(batch_uc, posterior_eps, force_zero_keys=force_uc_zero_keys)

    def init_params(self, seed: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Initialize the embedders that have parameters again, each from
        its own seed (seed + index), as their modules initialize; returns
        {name: state dict}."""
        out = {}
        for i, (spec, mod) in enumerate(zip(self.specs, self.embedders)):
            if not any(True for _ in mod.parameters()):
                continue
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed + i)
                for m in mod.modules():
                    if hasattr(m, "reset_parameters"):
                        m.reset_parameters()
            out[spec.name] = {k: v.detach() for k, v in mod.state_dict().items()}
        return out
