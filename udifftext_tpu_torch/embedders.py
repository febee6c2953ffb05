"""Conditioning embedders beyond the shipped three (port of
`udifftext_tpu/embedders.py`; the reference's sgm/modules/encoders/modules.py):

  - ClassEmbedder: a class-id table (`embedding.weight`, n_classes rows);
    with a keep mask or a generator, dropped ids become the last class.
  - concat_timestep_embedder_nd / ConcatTimestepEmbedderND: each scalar of
    a (B, D) input embedded sinusoidally to `outdim`, concatenated.
  - gaussian_encode: a posterior sample (or mode) of encoder moments and
    its KL to the standard normal.
  - SpatialRescalerRemap: n_stages resizes by `multiplier` (jax.image's
    methods: the half-pixel "nearest", Keys' "bicubic", "bilinear"; no
    antialiasing), then a bias-free conv to `out_channels`
    (`channel_mapper.weight`).
  - LowScaleEncoder: noise augmentation of a low-resolution latent at a
    random DDPM level, then a nearest resize.
  - IdentityFirstStage / IdentityEncoder: pass-throughs.
  - InceptionV3Embedder: the port's FIDInceptionV3 pool3 features.
  - The frozen text encoders: CLIP, ByT5 and T5 through `transformers`'
    PyTorch models from local files only, and the OpenCLIP towers
    (`models/open_clip.py`) from an open_clip state dict, each refused with
    a RuntimeError when what it needs is absent. Nothing is downloaded.

Activations are NHWC, as everywhere in the port. Random draws are explicit:
a `torch.Generator` or the draw itself.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .diffusion.schedules import make_beta_schedule
from .models.layers import _ConvNHWC, image_resize, timestep_embedding
from .models.vae import DiagonalGaussian


class ClassEmbedder(nn.Module):
    """Class-id embedding (reference modules.py:255-285). The table has
    exactly n_classes rows; the unconditional class is the last one."""

    def __init__(self, embed_dim: int, n_classes: int = 1000, add_sequence_dim: bool = False,
                 ucg_rate: float = 0.1):
        super().__init__()
        self.n_classes, self.add_sequence_dim, self.ucg_rate = n_classes, add_sequence_dim, ucg_rate
        self.embedding = nn.Embedding(n_classes, embed_dim)

    def forward(self, c: torch.Tensor, generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """c (B,) ids → (B, embed_dim) (or (B, 1, embed_dim)). Ids where the
        boolean `keep` is False, or where a draw from `generator` falls at
        or above 1 − ucg_rate, become the unconditional class."""
        if keep is None and generator is not None and self.ucg_rate > 0.0:
            keep = torch.rand(c.shape, generator=generator, device=c.device) < 1.0 - self.ucg_rate
        if keep is not None:
            c = torch.where(keep.to(c.device), c, torch.full_like(c, self.n_classes - 1))
        emb = self.embedding(c.long())
        return emb[:, None, :] if self.add_sequence_dim else emb


def concat_timestep_embedder_nd(x: torch.Tensor, outdim: int) -> torch.Tensor:
    """x (B,) or (B, D) → (B, D·outdim): each scalar embedded independently
    (reference :958-977)."""
    if x.ndim == 1:
        x = x[:, None]
    b, d = x.shape
    return timestep_embedding(x.reshape(-1), outdim).reshape(b, d * outdim)


class ConcatTimestepEmbedderND(nn.Module):
    """`concat_timestep_embedder_nd` as a conditioner embedder."""

    def __init__(self, outdim: int):
        super().__init__()
        self.outdim = outdim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return concat_timestep_embedder_nd(x, self.outdim)


def gaussian_encode(moments: torch.Tensor, eps: Optional[torch.Tensor] = None,
                    flatten: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """GaussianEncoder's head (reference :980-996): (z, kl) of the diagonal
    posterior of NHWC `moments`: z = mean + std·eps for standard-normal
    `eps`, the mode for None; flattened to (B, H·W, C) with `flatten`."""
    post = DiagonalGaussian(moments)
    z = post.mode() if eps is None else post.sample(eps.to(post.mean.dtype))
    if flatten:
        z = z.reshape(z.shape[0], -1, z.shape[-1])
    return z, post.kl()


class SpatialRescalerRemap(nn.Module):
    """SpatialRescaler with the out-channel remap conv (reference
    :800-860): n_stages resizes by `multiplier` (`image_resize`, no
    antialiasing), then a bias-free conv of `kernel_size` to out_channels."""

    def __init__(self, multiplier: float = 0.5, out_channels: Optional[int] = None,
                 method: str = "bilinear", n_stages: int = 1, kernel_size: int = 1,
                 in_channels: int = 3):
        super().__init__()
        self.multiplier, self.method, self.n_stages = multiplier, method, n_stages
        self.channel_mapper = None
        if out_channels is not None:
            self.channel_mapper = _ConvNHWC(in_channels, out_channels, kernel_size,
                                            padding=kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.n_stages):
            b, h, w, c = x.shape
            x = image_resize(x, (int(h * self.multiplier), int(w * self.multiplier)),
                             self.method, antialias=False)
        if self.channel_mapper is not None:
            x = self.channel_mapper(x)
        return x


@dataclasses.dataclass(frozen=True)
class LowScaleEncoder:
    """Noise-augmented low-resolution conditioning (reference :863-955) of
    an already encoded latent z: scaled by scale_factor, q-sampled at a
    level t drawn uniformly from [0, max_noise_level), resized (nearest) to
    out_size². Returns (z_noised, t)."""

    scale_factor: float = 1.0
    max_noise_level: int = 250
    timesteps: int = 1000
    linear_start: float = 1e-4
    linear_end: float = 2e-2
    out_size: Optional[int] = 64

    def alphas_cumprod(self) -> np.ndarray:
        betas = make_beta_schedule(self.timesteps, self.linear_start, self.linear_end)
        return np.cumprod(1.0 - betas, axis=0)

    def q_sample(self, z: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        acp = torch.as_tensor(self.alphas_cumprod(), dtype=torch.float32, device=z.device)
        shape = (-1,) + (1,) * (z.ndim - 1)
        return (acp.sqrt()[t].reshape(shape) * z
                + (1.0 - acp).sqrt()[t].reshape(shape) * noise.to(z.dtype))

    def __call__(self, z: torch.Tensor, generator: Optional[torch.Generator] = None,
                 t: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """t (B,) int and noise (z's shape, standard normal) are drawn from
        `generator` in that order unless given."""
        z = z * self.scale_factor
        if t is None:
            t = torch.randint(0, self.max_noise_level, (z.shape[0],), generator=generator,
                              device=z.device)
        if noise is None:
            noise = torch.randn(z.shape, generator=generator, device=z.device)
        z = self.q_sample(z, t.long(), noise)
        if self.out_size is not None:
            z = image_resize(z, (self.out_size, self.out_size), "nearest")
        return z, t


class IdentityFirstStage:
    """Pass-through first stage (reference autoencoder.py:324-335)."""

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        return x


class IdentityEncoder:
    """Pass-through embedder (reference modules.py:246-252)."""

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x


class InceptionV3Embedder(nn.Module):
    """InceptionV3 feature embedder (reference modules.py:220-243 over
    pytorch_fid): the port's FIDInceptionV3 on NHWC images, resized to 299²
    inside; with the default normalize_input=False the caller supplies
    [-1, 1] images. Loads pytorch_fid's state dict from `weights_path`."""

    def __init__(self, normalize_input: bool = False, weights_path: Optional[str] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        from .models.inception import FIDInceptionV3, fid_inception_features
        from .utils.ckpt import load_state_dict

        with torch.device(device):
            self.model = FIDInceptionV3(resize_input=True, normalize_input=normalize_input)
        if weights_path:
            self.model.load_state_dict(fid_inception_features(load_state_dict(weights_path)),
                                       strict=True)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.squeeze(self.model(x.permute(0, 3, 1, 2)))


def _transformers(*names: str):
    try:
        import transformers
    except ImportError as e:
        raise RuntimeError("transformers (with its PyTorch models) is required") from e
    return [getattr(transformers, n) for n in names]


def _tokens(tokenizer, texts, max_length: int, device) -> torch.Tensor:
    return tokenizer(texts, truncation=True, max_length=max_length, padding="max_length",
                     return_tensors="pt")["input_ids"].to(device)


def load_frozen_clip_text_embedder(version: str = "openai/clip-vit-large-patch14",
                                   max_length: int = 77, layer: str = "last",
                                   device: torch.device | str = "cuda"):
    """FrozenCLIPEmbedder (reference :371-433) on transformers' CLIP text
    model, from local files only: texts → the last hidden state, the pooled
    output (B, 1, D) for layer "pooled", or the penultimate hidden state."""
    tok_cls, model_cls = _transformers("CLIPTokenizer", "CLIPTextModel")
    tokenizer = tok_cls.from_pretrained(version, local_files_only=True)
    model = model_cls.from_pretrained(version, local_files_only=True).to(device).eval()

    @torch.no_grad()
    def embed(texts):
        out = model(input_ids=_tokens(tokenizer, texts, max_length, device),
                    output_hidden_states=layer != "last")
        if layer == "last":
            return out.last_hidden_state
        if layer == "pooled":
            return out.pooler_output[:, None]
        return out.hidden_states[-2]

    return embed


def _t5_embedder(tokenizer, model_cls, version: str, max_length: int, device):
    model = model_cls.from_pretrained(version, local_files_only=True).to(device).eval()

    @torch.no_grad()
    def embed(texts):
        return model(input_ids=_tokens(tokenizer, texts, max_length, device)).last_hidden_state

    return embed


def load_frozen_byt5_embedder(version: str = "google/byt5-base", max_length: int = 77,
                              device: torch.device | str = "cuda"):
    """FrozenByT5Embedder (reference :330-368): the byte-level tokenizer
    (no vocabulary file) and the T5 encoder from local files only."""
    tok_cls, model_cls = _transformers("ByT5Tokenizer", "T5EncoderModel")
    return _t5_embedder(tok_cls(), model_cls, version, max_length, device)


def load_frozen_t5_embedder(version: str = "google/t5-v1_1-xxl", max_length: int = 77,
                            device: torch.device | str = "cuda"):
    """FrozenT5Embedder (reference :289-328), from local files only."""
    tok_cls, model_cls = _transformers("T5Tokenizer", "T5EncoderModel")
    tokenizer = tok_cls.from_pretrained(version, local_files_only=True)
    return _t5_embedder(tokenizer, model_cls, version, max_length, device)


OPEN_CLIP_WEIGHTS = os.environ.get(
    "UDIFFTEXT_OPEN_CLIP_WEIGHTS", "./checkpoints/clip/open_clip_pytorch_model.bin"
)


def _open_clip_state(weights_path: Optional[str], tower: str):
    """The `tower` ("text" or "visual") entries of an open_clip CLIP state
    dict (the text tower's keys sit at the top level, the vision tower's
    under "visual.")."""
    from .models.open_clip import text_state, visual_state
    from .utils.ckpt import load_state_dict

    path = weights_path or OPEN_CLIP_WEIGHTS
    if not os.path.exists(path):
        raise RuntimeError(
            f"open_clip weights not found at {path} — place an open_clip "
            "state dict (e.g. ViT-H-14 laion2b_s32b_b79k) there or set "
            "UDIFFTEXT_OPEN_CLIP_WEIGHTS"
        )
    sd = (text_state if tower == "text" else visual_state)(load_state_dict(path))
    if not sd:
        raise RuntimeError(f"{path} carries no {tower} tower")
    return sd


def load_frozen_open_clip_text_embedder(max_length: int = 77, layer: str = "last",
                                        legacy: bool = True, always_return_pooled: bool = False,
                                        weights_path: Optional[str] = None,
                                        bpe_path: Optional[str] = None,
                                        device: torch.device | str = "cuda", **tower_kwargs):
    """FrozenOpenCLIPEmbedder / FrozenOpenCLIPEmbedder2 (reference
    modules.py:436-609) over the port's text tower, from an open_clip state
    dict (weight-gated like the loaders above). Without the BPE vocabulary
    the embedder takes token ids only."""
    from .models.open_clip import (FrozenOpenCLIPTextEmbedder, OpenClipTextTransformer,
                                   SimpleTokenizer)

    sd = _open_clip_state(weights_path, "text")
    tokenizer = None
    try:
        tokenizer = SimpleTokenizer(bpe_path, context_length=max_length)
    except FileNotFoundError:
        pass
    with torch.device(device):
        model = OpenClipTextTransformer(**tower_kwargs)
    model.load_state_dict(sd, strict=True)
    return FrozenOpenCLIPTextEmbedder(model, max_length=max_length, layer=layer, legacy=legacy,
                                      always_return_pooled=always_return_pooled,
                                      tokenizer=tokenizer)


def load_frozen_open_clip_image_embedder(antialias: bool = True, max_length: int = 77,
                                         unsqueeze_dim: bool = False,
                                         repeat_to_max_len: bool = False,
                                         output_tokens: bool = False,
                                         weights_path: Optional[str] = None,
                                         device: torch.device | str = "cuda", **tower_kwargs):
    """FrozenOpenCLIPImageEmbedder (reference modules.py:612-769) over the
    port's vision tower, from an open_clip state dict (weight-gated)."""
    from .models.open_clip import FrozenOpenCLIPImageEmbedder, OpenClipVisionTransformer

    sd = _open_clip_state(weights_path, "visual")
    with torch.device(device):
        model = OpenClipVisionTransformer(**tower_kwargs)
    model.load_state_dict(sd, strict=True)
    return FrozenOpenCLIPImageEmbedder(model, antialias=antialias, max_length=max_length,
                                       unsqueeze_dim=unsqueeze_dim,
                                       repeat_to_max_len=repeat_to_max_len,
                                       output_tokens=output_tokens)
