"""Vision Transformer encoders of PARSeq and ViTSTR (port of
`udifftext_tpu/models/vit.py`).

timm's `VisionTransformer.forward_features`: a conv patch embedding, an
optional class token, a learned position embedding, pre-LN blocks (x +=
attn(norm1(x)); x += mlp(norm2(x)), packed qkv with bias, exact GELU) and a
final norm; every token is returned. Parameter names are timm's
(`cls_token`, `patch_embed.proj.weight`, `pos_embed`,
`blocks.0.attn.qkv.weight`, `blocks.0.mlp.fc1.bias`, `norm.weight`, …), the
keys the PARSeq checkpoint holds under `encoder.` and a ViTSTR checkpoint
holds beside its classifier head. Images are NHWC; attention is plain matmul
and fp32 softmax, as in the JAX package (not the flash kernels).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, LayerNormF32


class ViTSelfAttention(nn.Module):
    """timm Attention: packed qkv (with bias), scale 1/sqrt(dh)."""

    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(d, 3 * d)
        self.proj = Dense(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        q, k, v = (t.reshape(b, n, h, d // h) for t in self.qkv(x).chunk(3, dim=-1))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d // h)
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        return self.proj(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, d))


class ViTMlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(d, hidden)
        self.fc2 = Dense(hidden, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    def __init__(self, d: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNormF32(d, eps=1e-6)
        self.attn = ViTSelfAttention(d, num_heads)
        self.norm2 = LayerNormF32(d, eps=1e-6)
        self.mlp = ViTMlp(d, int(d * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """Conv patchify: (B, H, W, C) → (B, N, D), patches in row-major order.
    The conv's stride is its kernel, so it is one product of the flattened
    patches with the flattened (D, C·ph·pw) kernel: a matmul, which on the
    card stays in full fp32 where cuDNN would take TF32 for an fp32 conv."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: Tuple[int, int]):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ph, pw = self.patch_size
        patches = x.reshape(b, h // ph, ph, w // pw, pw, c).permute(0, 1, 3, 5, 2, 4)
        patches = patches.reshape(b, (h // ph) * (w // pw), c * ph * pw)
        weight = self.proj.weight.reshape(self.proj.out_channels, -1)
        return F.linear(patches, weight.to(x.dtype), self.proj.bias.to(x.dtype))


class ViTEncoder(nn.Module):
    """timm VisionTransformer forward_features (all tokens, post-norm).
    PARSeq's: img 32×128, patch 4×8, dim 384, depth 12, heads 6, no class
    token. With `class_token`, a zero-initialized `cls_token` goes before
    the patches, and the position embedding covers it too."""

    def __init__(self, img_size: Tuple[int, int] = (32, 128), patch_size: Tuple[int, int] = (4, 8),
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, in_chans: int = 3, class_token: bool = False):
        super().__init__()
        n = (img_size[0] // patch_size[0]) * (img_size[1] // patch_size[1])
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim)) if class_token else None
        n += int(class_token)
        self.pos_embed = nn.Parameter(torch.empty(1, n, embed_dim).normal_(std=0.02))
        self.blocks = nn.ModuleList(ViTBlock(embed_dim, num_heads, mlp_ratio)
                                    for _ in range(depth))
        self.norm = LayerNormF32(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


class ViTSTREncoder(ViTEncoder):
    """ViTSTR-base's feature extractor: a ViT with class token over grayscale
    size² images (NHWC), returning all (size/patch)² + 1 tokens (197 at 224,
    patch 16). Only features are read; the checkpoint's classifier head is
    dropped by `vitstr_features`."""

    def __init__(self, size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 in_chans: int = 1):
        super().__init__((size, size), (patch_size, patch_size), embed_dim, depth, num_heads,
                         mlp_ratio, in_chans, class_token=True)


def vitstr_features(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A ViTSTR (timm) state dict without its classifier: the `head*`,
    `dist_token` and `pre_logits*` entries dropped, as the JAX package's
    `convert_vitstr` drops them; the rest are `ViTSTREncoder`'s keys."""
    return {k: v for k, v in sd.items() if not k.startswith(("head", "dist_token", "pre_logits"))}
