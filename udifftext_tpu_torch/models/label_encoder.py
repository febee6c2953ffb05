"""Character-level LabelEncoder (port of `udifftext_tpu/models/label_encoder.py`).

Char-id embedding plus a fixed sinusoidal position code, then a stack of
post-LN transformer encoder layers with torch's `nn.TransformerEncoderLayer`
semantics (packed in-projection, residual then norm, ReLU feed-forward).
Parameter names are the reference checkpoint's (`label_embedding.weight`,
`encoder.layers.0.self_attn.in_proj_weight`, `...linear1.weight`, …).

`LabelEncoderPretrain` adds the pretraining heads around it (cls, pos, and
the text/visual projections into the contrastive space, with the learned
logit scale); the loss is `diffusion.loss.clip_contrastive_loss`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..charset import NUM_CLASSES
from .layers import Dense, lecun_normal_


def sinusoidal_positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """pe[:, 0::2] = sin, pe[:, 1::2] = cos."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class MultiheadSelfAttention(nn.Module):
    """torch `nn.MultiheadAttention` self-attention with its packed in-proj."""

    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Dense(d, d)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        h = self.num_heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, l, h, d // h) for t in (q, k, v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d // h)
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, l, d)
        return self.out_proj(out)


class TorchTransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer (norm_first=False, ReLU)."""

    def __init__(self, d: int, num_heads: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d, num_heads)
        self.linear1 = Dense(d, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1((x + self.self_attn(x)).float()).to(x.dtype)
        ff = self.linear2(F.relu(self.linear1(x)))
        return self.norm2((x + ff).float()).to(x.dtype)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class LabelEncoder(nn.Module):
    def __init__(self, max_len: int = 12, emb_dim: int = 2048, n_heads: int = 8,
                 n_trans_layers: int = 12, dim_feedforward: int = 2048):
        super().__init__()
        self.label_embedding = nn.Embedding(NUM_CLASSES, emb_dim)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_positional_encoding(max_len, emb_dim)),
            persistent=False,
        )
        self.encoder = _Encoder(
            [TorchTransformerEncoderLayer(emb_dim, n_heads, dim_feedforward)
             for _ in range(n_trans_layers)]
        )

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """ids (B, max_len) int → embeddings (B, max_len, emb_dim)."""
        x = self.label_embedding(ids.long()) + self.pe[None]
        for layer in self.encoder.layers:
            x = layer(x)
        return x


class InstanceNorm(nn.Module):
    """torch `InstanceNorm1d(max_len)` as the reference applies it to
    (B, L, D): each token normalized over its D features (biased variance),
    no affine."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], eps=self.eps)


class TokenMix(nn.Module):
    """The reference's `Conv1d(n_tokens, 1, kernel_size=1)` over (B, L, D):
    a learned weighted sum of the L tokens plus one bias, (B, L, D) →
    (B, D). Computed as a product (no cuDNN convolution, so fp32 stays fp32
    on the card); the weight keeps the conv's (1, L, 1) shape."""

    def __init__(self, n_tokens: int):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal_(torch.empty(1, n_tokens, 1)))
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bld,l->bd", x, self.weight[0, :, 0].to(x.dtype)) + self.bias.to(x.dtype)


class LabelEncoderPretrain(nn.Module):
    """LabelEncoder plus the pretraining heads: `forward(ids, visual_emb)` →
    {"text_emb", "cls_out" (B, L, 95), "pos_out" (B, L, L), "text_out"
    (B, clip_dim), "logit_scale" (never clamped), and with `visual_emb`
    (B, visual_len, visual_dim) "visual_out" (B, clip_dim)}.

    cls head: InstanceNorm → Linear(emb) → exact GELU → Linear(95); pos
    head: InstanceNorm → Linear(max_len, no bias); text and visual heads:
    InstanceNorm → Linear(clip_dim, no bias) → TokenMix."""

    def __init__(self, max_len: int = 12, emb_dim: int = 2048, n_heads: int = 8,
                 n_trans_layers: int = 12, clip_dim: int = 1024, visual_len: int = 197,
                 visual_dim: int = 768):
        super().__init__()
        self.max_len, self.visual_len, self.visual_dim = max_len, visual_len, visual_dim
        self.encoder = LabelEncoder(max_len, emb_dim, n_heads, n_trans_layers)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.norm = InstanceNorm()  # the reference's four InstanceNorms: none has parameters
        self.cls_fc1 = Dense(emb_dim, emb_dim)
        self.cls_fc2 = Dense(emb_dim, NUM_CLASSES)
        self.pos_fc = Dense(emb_dim, max_len, bias=False)
        self.text_fc = Dense(emb_dim, clip_dim, bias=False)
        self.text_mix = TokenMix(max_len)
        self.visual_fc = Dense(visual_dim, clip_dim, bias=False)
        self.visual_mix = TokenMix(visual_len)

    def forward(self, ids: torch.Tensor, visual_emb: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        text_emb = self.encoder(ids)
        h = self.norm(text_emb)
        out = {
            "text_emb": text_emb,
            "cls_out": self.cls_fc2(F.gelu(self.cls_fc1(h))),
            "pos_out": self.pos_fc(h),
            "text_out": self.text_mix(self.text_fc(h)),
            "logit_scale": self.logit_scale,
        }
        if visual_emb is not None:
            out["visual_out"] = self.visual_mix(self.visual_fc(self.norm(visual_emb)))
        return out
