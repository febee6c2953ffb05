"""ABINet: a vision model, a bidirectional cloze language model and their
gated fusion, iterated (port of `udifftext_tpu/models/abinet.py`).

Parameter and buffer names are strhub's (`vision.backbone.resnet.layer3.0.
downsample.0`, `vision.backbone.transformer.layers.0.self_attn.in_proj_weight`,
`vision.attention.k_decoder.3.1`, `language.model.layers.0.multihead_attn`,
`alignment.w_att`, the sinusoid buffers `*.pos_encoder.pe` /
`language.token_encoder.pe`, …), so the strhub ABINet checkpoint loads by
name after its `model.` prefix. Images are NHWC; the conv stacks run on an
NCHW view; BatchNorm reads its running statistics in eval mode (the JAX
build's always do). Attention is plain fp32 matmul and softmax; masks add
−1e9, not −inf. The key decoder's nearest upsampling is jax.image.resize's
half-pixel rule (`layers.image_resize`).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .label_encoder import sinusoidal_positional_encoding
from .layers import image_resize
from .parseq import NEG_INF, TorchMHA


class PositionalEncoding(nn.Module):
    """strhub's sinusoid table, a (max_len, 1, d) buffer `pe`."""

    def __init__(self, d_model: int, max_len: int):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(
            sinusoidal_positional_encoding(max_len, d_model))[:, None])

    def table(self, n: int) -> torch.Tensor:
        if n > self.pe.shape[0]:
            raise ValueError(f"positional table of {self.pe.shape[0]} rows, {n} asked")
        return self.pe[:n, 0]


def _conv3x3(c_in: int, c_out: int, stride=1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, stride, 1, bias=False)


class ABIBasicBlock(nn.Module):
    """A 1×1 conv, then a (strided) 3×3 conv (abinet resnet.py:8-16)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv3x3(planes, planes, stride)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                                         nn.BatchNorm2d(planes))
                           if stride != 1 or inplanes != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class ResNet45(nn.Module):
    """resnet45: a 3×3 stem, then layers of [3, 4, 6, 6, 3] blocks of widths
    d/16 … d (at least 8) and strides [2, 1, 2, 1, 1]. NCHW."""

    def __init__(self, d_model: int = 512, in_channels: int = 3):
        super().__init__()
        d = d_model
        widths = [max(d // 16, 8), max(d // 8, 8), max(d // 4, 8), max(d // 2, 8), d]
        self.conv1 = _conv3x3(in_channels, widths[0])
        self.bn1 = nn.BatchNorm2d(widths[0])
        inplanes = widths[0]
        for i, (w, n, s) in enumerate(zip(widths, (3, 4, 6, 6, 3), (2, 1, 2, 1, 1)), start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                *(ABIBasicBlock(inplanes if b == 0 else w, w, s if b == 0 else 1)
                  for b in range(n))))
            inplanes = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        for i in range(1, 6):
            x = getattr(self, f"layer{i}")(x)
        return x  # (B, d_model, 8, 32) for a 32×128 input


class PostLNEncoderLayer(nn.Module):
    """torch's TransformerEncoderLayer: post-LN, ReLU, eps 1e-5."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = TorchMHA(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x, x, x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class _Layers(nn.Module):
    """A `layers` list (torch's TransformerEncoder/Decoder key layout)."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class ResTransformer(nn.Module):
    """ResNet45, the sinusoid added to its 8×32 tokens, post-LN encoder
    layers → NHWC features (B, H, W, d_model)."""

    def __init__(self, d_model: int = 512, nhead: int = 8, d_inner: int = 2048,
                 num_layers: int = 2):
        super().__init__()
        self.resnet = ResNet45(d_model)
        self.pos_encoder = PositionalEncoding(d_model, max_len=8 * 32)
        self.transformer = _Layers(PostLNEncoderLayer(d_model, nhead, d_inner)
                                   for _ in range(num_layers))

    def forward(self, x_nchw: torch.Tensor) -> torch.Tensor:
        feat = self.resnet(x_nchw).permute(0, 2, 3, 1)
        b, h, w, e = feat.shape
        seq = feat.reshape(b, h * w, e) + self.pos_encoder.table(h * w)
        for layer in self.transformer.layers:
            seq = layer(seq)
        return seq.reshape(b, h, w, e)


def _conv_bn_relu(c_in: int, c_out: int, stride=1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(c_in, c_out, 3, stride, 1), nn.BatchNorm2d(c_out), nn.ReLU())


class PositionAttention(nn.Module):
    """Character-position queries over a U-Net key encoder of the features
    (attention.py:49-100) → (vectors (B, T, E), scores (B, T, H, W)). Slot 0
    of each key-decoder layer is strhub's nn.Upsample; here the upsampling
    runs before the layer, to the size of the skip it meets."""

    def __init__(self, max_length: int = 26, in_channels: int = 512, num_channels: int = 64):
        super().__init__()
        self.max_length = max_length
        self.k_encoder = nn.Sequential(*(
            _conv_bn_relu(in_channels if i == 0 else num_channels, num_channels, s)
            for i, s in enumerate(((1, 2), (2, 2), (2, 2), (2, 2)))))
        self.k_decoder = nn.Sequential(*(
            nn.Sequential(nn.Identity(), *_conv_bn_relu(num_channels, c_out))
            for c_out in (num_channels, num_channels, num_channels, in_channels)))
        self.pos_encoder = PositionalEncoding(in_channels, max_len=max_length)
        self.project = nn.Linear(in_channels, in_channels)

    @staticmethod
    def _resize(k: torch.Tensor, hw) -> torch.Tensor:
        return image_resize(k.permute(0, 2, 3, 1), hw, "nearest").permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor):  # x (B, H, W, E)
        b, h, w, e = x.shape
        k = x.permute(0, 3, 1, 2)
        feats = []
        for layer in self.k_encoder:
            k = layer(k)
            feats.append(k)
        for i in range(3):
            skip = feats[2 - i]
            k = self.k_decoder[i](self._resize(k, skip.shape[2:])) + skip
        k = self.k_decoder[3](self._resize(k, (h, w)))  # back to the features' size

        q = self.project(self.pos_encoder.table(self.max_length))  # (T, E)
        kf = k.permute(0, 2, 3, 1).reshape(b, h * w, e)
        scores = torch.softmax(torch.einsum("te,bne->btn", q, kf) / math.sqrt(e), dim=-1)
        vecs = torch.einsum("btn,bne->bte", scores, x.reshape(b, h * w, e))
        return vecs, scores.reshape(b, self.max_length, h, w)


class BaseVision(nn.Module):
    def __init__(self, max_length: int = 26, num_classes: int = 37, d_model: int = 512,
                 nhead: int = 8, d_inner: int = 2048, num_layers: int = 2):
        super().__init__()
        self.backbone = ResTransformer(d_model, nhead, d_inner, num_layers)
        self.attention = PositionAttention(max_length, d_model)
        self.cls = nn.Linear(d_model, num_classes)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        vecs, scores = self.attention(self.backbone(images.permute(0, 3, 1, 2)))
        return {"feature": vecs, "logits": self.cls(vecs), "attn_scores": scores}


class BCNDecoderLayer(nn.Module):
    """strhub's TransformerDecoderLayer with self_attn=False: cross-attention
    (location- and padding-masked), then the feed-forward; post-LN."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int = 2048):
        super().__init__()
        self.multihead_attn = TorchMHA(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, q, memory, memory_mask=None, memory_key_padding_mask=None):
        a = self.multihead_attn(q, memory, memory, attn_mask=memory_mask,
                                key_padding_mask=memory_key_padding_mask)
        q = self.norm2(q + a)
        return self.norm3(q + self.linear2(F.relu(self.linear1(q))))


class BCNLanguage(nn.Module):
    """The cloze language model over detached token distributions: each
    position reads every other one within the length, not itself."""

    def __init__(self, max_length: int = 26, num_classes: int = 37, d_model: int = 512,
                 nhead: int = 8, d_inner: int = 2048, num_layers: int = 4):
        super().__init__()
        self.max_length = max_length
        self.proj = nn.Linear(num_classes, d_model, bias=False)
        self.token_encoder = PositionalEncoding(d_model, max_len=max_length)
        self.pos_encoder = PositionalEncoding(d_model, max_len=max_length)
        self.model = _Layers(BCNDecoderLayer(d_model, nhead, d_inner) for _ in range(num_layers))
        self.cls = nn.Linear(d_model, num_classes)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
        t = self.max_length
        embed = self.proj(tokens.detach()) + self.token_encoder.table(t)
        query = self.pos_encoder.table(t).expand_as(embed)
        eye = torch.eye(t, dtype=torch.bool, device=tokens.device)
        location = torch.zeros(t, t, device=tokens.device).masked_fill(eye, NEG_INF)
        padding = torch.arange(t, device=tokens.device)[None] >= lengths[:, None]
        h = query
        for layer in self.model.layers:
            h = layer(h, embed, memory_mask=location, memory_key_padding_mask=padding)
        return {"feature": h, "logits": self.cls(h)}


class BaseAlignment(nn.Module):
    """Gated fusion of the language and vision features."""

    def __init__(self, d_model: int = 512, num_classes: int = 37):
        super().__init__()
        self.w_att = nn.Linear(2 * d_model, d_model)
        self.cls = nn.Linear(d_model, num_classes)

    def forward(self, l_feature: torch.Tensor, v_feature: torch.Tensor) -> Dict[str, torch.Tensor]:
        gate = torch.sigmoid(self.w_att(torch.cat([l_feature, v_feature], dim=-1)))
        out = gate * v_feature + (1 - gate) * l_feature
        return {"logits": self.cls(out), "feature": out}


def _pt_lengths(logits: torch.Tensor, null_label: int = 0) -> torch.Tensor:
    """The first null/EOS position + 1, or the full length without one."""
    is_null = logits.argmax(dim=-1) == null_label
    first = is_null.int().argmax(dim=-1) + 1
    return torch.where(is_null.any(dim=-1), first, torch.full_like(first, logits.shape[1]))


class ABINet(nn.Module):
    """ABINetIterModel: vision, then (language → alignment) `iter_size`
    times → the last aligned logits (B, max_length, num_classes)."""

    def __init__(self, max_length: int = 26, num_classes: int = 37, iter_size: int = 3,
                 d_model: int = 512, nhead: int = 8, d_inner: int = 2048,
                 v_num_layers: int = 2, l_num_layers: int = 4):
        super().__init__()
        self.max_length = max_length
        self.iter_size = iter_size
        self.vision = BaseVision(max_length, num_classes, d_model, nhead, d_inner, v_num_layers)
        self.language = BCNLanguage(max_length, num_classes, d_model, nhead, d_inner,
                                    l_num_layers)
        self.alignment = BaseAlignment(d_model, num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        v_res = self.vision(images)
        a_logits = v_res["logits"]
        for _ in range(self.iter_size):
            lengths = torch.clamp(_pt_lengths(a_logits), 2, self.max_length)
            l_res = self.language(torch.softmax(a_logits, dim=-1), lengths)
            a_logits = self.alignment(l_res["feature"], v_res["feature"])["logits"]
        return a_logits
