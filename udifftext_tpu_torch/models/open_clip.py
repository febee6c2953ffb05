"""OpenCLIP towers, their sgm wrappers and the CLIP BPE tokenizer (port of
`udifftext_tpu/models/open_clip.py`).

The reference's FrozenOpenCLIPEmbedder / FrozenOpenCLIPEmbedder2
(sgm/modules/encoders/modules.py:436-609) and FrozenOpenCLIPImageEmbedder
(:612-769) wrap `open_clip.create_model_and_transforms("ViT-H-14")`. The
towers are restated here (open_clip model/transformer.py):

  text:   token_embedding(49408, 1024) + positional_embedding(77) → 24
          pre-LN ResidualAttentionBlocks (16 heads, MLP 4×, exact GELU,
          causal mask) → ln_final → EOT-pooled @ text_projection
  visual: conv1 patchify (14×14 stride 14, no bias) + class token +
          positional_embedding(257) → ln_pre → 32 blocks (width 1280, 16
          heads) → ln_post on the class token → @ proj (1024)

Parameter names are open_clip's (`transformer.resblocks.0.attn.in_proj_weight`,
`ln_final.weight`, `text_projection`; the vision tower's under `visual.` in
a CLIP state dict, `text_state` / `visual_state` split one), so a published
open_clip file loads without a converter. Attention is plain PyTorch
(`parseq.TorchMHA`, nn.MultiheadAttention's packed projections);
LayerNorms compute in fp32. Images are NHWC.
"""

from __future__ import annotations

import math
import os
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .layers import Dense, LayerNormF32, image_resize
from .parseq import TorchMHA

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def text_state(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The text tower's entries of an open_clip CLIP state dict (without the
    vision tower, the contrastive head's logit_scale/logit_bias and the
    attention-mask buffer, which the tower rebuilds)."""
    return {k: v for k, v in sd.items()
            if not k.startswith("visual.") and k not in ("logit_scale", "logit_bias", "attn_mask")}


def visual_state(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The vision tower's entries of an open_clip CLIP state dict, without
    their "visual." prefix."""
    return {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}


class ResidualAttentionBlock(nn.Module):
    """open_clip's pre-LN block: x + MHA(ln_1 x), then + MLP(ln_2 x) with
    exact (erf) GELU."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(width * mlp_ratio)
        self.ln_1 = LayerNormF32(width)
        self.attn = TorchMHA(width, heads)
        self.ln_2 = LayerNormF32(width)
        self.mlp = nn.Sequential(OrderedDict([("c_fc", Dense(width, hidden)), ("gelu", nn.GELU()),
                                              ("c_proj", Dense(hidden, width))]))

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.ln_1(x)
        x = x + self.attn(h, h, h, attn_mask=attn_mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, mlp_ratio) for _ in range(layers)])


class OpenClipTextTransformer(nn.Module):
    """The text tower. `encode` returns the last and the penultimate hidden
    states, so one forward serves FrozenOpenCLIPEmbedder's `penultimate`
    (the stack stopped before its last block) and FrozenOpenCLIPEmbedder2's
    state captured before the last block: the two are the same."""

    def __init__(self, vocab_size: int = 49408, width: int = 1024, heads: int = 16,
                 layers: int = 24, context_length: int = 77, embed_dim: int = 1024):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.randn(context_length, width) * 0.01)
        self.transformer = Transformer(width, heads, layers)
        self.ln_final = LayerNormF32(width)
        self.text_projection = nn.Parameter(torch.randn(width, embed_dim) * width ** -0.5)

    @staticmethod
    def causal_mask(n: int, device=None) -> torch.Tensor:
        """open_clip's build_attention_mask: −inf above the diagonal."""
        return torch.full((n, n), float("-inf"), device=device).triu(1)

    def encode(self, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """ids (B, L ≤ context_length) → {"last", "penultimate"} hidden states
        (B, L, width), neither through ln_final (modules.py:521-531)."""
        x = self.token_embedding(ids.long())
        x = x + self.positional_embedding[:x.shape[1]].to(x.dtype)
        mask = self.causal_mask(x.shape[1], x.device)
        blocks = self.transformer.resblocks
        penultimate = x
        for i, block in enumerate(blocks):
            if i == len(blocks) - 1:
                penultimate = x
            x = block(x, attn_mask=mask)
        return {"last": x, "penultimate": penultimate}

    def final_ln(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln_final(x)

    def pool(self, x_ln: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """EOT pooling (modules.py:510-516): the feature at argmax(ids)
        through the text projection."""
        feats = x_ln[torch.arange(x_ln.shape[0], device=x_ln.device), ids.argmax(dim=-1)]
        return feats @ self.text_projection.to(feats.dtype)

    def forward(self, ids: torch.Tensor, layer: str = "last", legacy: bool = True,
                return_pooled: bool = False):
        """legacy=True: FrozenOpenCLIPEmbedder (ln_final of the chosen layer,
        modules.py:589-601); legacy=False: FrozenOpenCLIPEmbedder2 (only
        "last" through ln_final; with return_pooled also the EOT-pooled
        projection, modules.py:495-516)."""
        states = self.encode(ids)
        if legacy:
            return self.final_ln(states[layer])
        last_ln = self.final_ln(states["last"])
        out = last_ln if layer == "last" else states[layer]
        if return_pooled:
            return out, self.pool(last_ln, ids)
        return out


class OpenClipVisionTransformer(nn.Module):
    """The vision tower: the projected class-token embedding of a
    clip-preprocessed NHWC image; with output_tokens also the patch tokens
    (before ln_post and the projection)."""

    def __init__(self, image_size: int = 224, patch_size: int = 14, width: int = 1280,
                 heads: int = 16, layers: int = 32, output_dim: int = 1024,
                 mlp_ratio: float = 4.0):
        super().__init__()
        grid = image_size // patch_size
        self.image_size, self.width = image_size, width
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        scale = width ** -0.5
        self.class_embedding = nn.Parameter(torch.randn(width) * scale)
        self.positional_embedding = nn.Parameter(torch.randn(grid * grid + 1, width) * scale)
        self.ln_pre = LayerNormF32(width)
        self.transformer = Transformer(width, heads, layers, mlp_ratio)
        self.ln_post = LayerNormF32(width)
        self.proj = nn.Parameter(torch.randn(width, output_dim) * scale)

    def forward(self, x: torch.Tensor, output_tokens: bool = False):
        h = self.conv1(x.permute(0, 3, 1, 2).to(self.conv1.weight.dtype))
        b = h.shape[0]
        h = h.reshape(b, self.width, -1).permute(0, 2, 1)
        cls = self.class_embedding.to(h.dtype).expand(b, 1, self.width)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding.to(h.dtype)
        h = self.ln_pre(h)
        for block in self.transformer.resblocks:
            h = block(h)
        pooled = self.ln_post(h[:, 0]) @ self.proj.to(h.dtype)
        if output_tokens:
            return pooled, h[:, 1:]
        return pooled


def clip_preprocess(x: torch.Tensor, antialias: bool = True, size: int = 224) -> torch.Tensor:
    """FrozenOpenCLIPImageEmbedder.preprocess (modules.py:660-672) of NHWC x
    in [-1, 1]: a bicubic resize to size² (jax.image's Keys cubic with the
    half-pixel convention, where the reference's kornia resize aligns
    corners; images already size² skip it), to [0, 1], CLIP mean/std."""
    if x.shape[1] != size or x.shape[2] != size:
        x = image_resize(x, (size, size), "bicubic", antialias=antialias)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


class FrozenOpenCLIPTextEmbedder(nn.Module):
    """FrozenOpenCLIPEmbedder / FrozenOpenCLIPEmbedder2 (modules.py:436-609)
    over the text tower: strings (through `tokenizer`, the CLIP BPE) or
    token ids → the embedding of `layer`."""

    def __init__(self, model: Optional[OpenClipTextTransformer] = None, max_length: int = 77,
                 layer: str = "last", legacy: bool = True, always_return_pooled: bool = False,
                 tokenizer: Optional["SimpleTokenizer"] = None):
        super().__init__()
        self.model = model if model is not None else OpenClipTextTransformer()
        self.max_length, self.layer, self.legacy = max_length, layer, legacy
        self.always_return_pooled, self.tokenizer = always_return_pooled, tokenizer

    @torch.no_grad()
    def forward(self, text_or_ids):
        if isinstance(text_or_ids, str):
            text_or_ids = [text_or_ids]
        if isinstance(text_or_ids, (list, tuple)) and (not text_or_ids
                                                       or isinstance(text_or_ids[0], str)):
            if self.tokenizer is None:
                raise ValueError("string input needs the CLIP BPE vocabulary: construct with "
                                 "tokenizer=SimpleTokenizer(vocab_path)")
            text_or_ids = self.tokenizer.tokenize(list(text_or_ids), self.max_length)
        ids = (text_or_ids if isinstance(text_or_ids, torch.Tensor)
               else torch.as_tensor(np.asarray(text_or_ids)))
        ids = ids.to(self.model.text_projection.device)
        return self.model(ids, layer=self.layer, legacy=self.legacy,
                          return_pooled=self.always_return_pooled)


class FrozenOpenCLIPImageEmbedder(nn.Module):
    """FrozenOpenCLIPImageEmbedder (modules.py:612-769) over the vision
    tower: clip_preprocess → the class-token embedding, with the reference's
    output modes (unsqueeze_dim, repeat_to_max_len, output_tokens → (tokens,
    pooled)). The conditioner applies its dropout, as the reference's
    GeneralConditioner drives it."""

    def __init__(self, model: Optional[OpenClipVisionTransformer] = None,
                 antialias: bool = True, max_length: int = 77, unsqueeze_dim: bool = False,
                 repeat_to_max_len: bool = False, output_tokens: bool = False):
        super().__init__()
        self.model = model if model is not None else OpenClipVisionTransformer()
        self.antialias, self.max_length = antialias, max_length
        self.unsqueeze_dim, self.repeat_to_max_len = unsqueeze_dim, repeat_to_max_len
        self.output_tokens = output_tokens

    @torch.no_grad()
    def forward(self, image: torch.Tensor):
        x = clip_preprocess(image, antialias=self.antialias, size=self.model.image_size)
        out = self.model(x, output_tokens=self.output_tokens)
        if self.output_tokens:
            z, tokens = out
            return tokens, z  # the reference returns (tokens, pooled) (:706-709)
        z = out
        if self.unsqueeze_dim:
            z = z[:, None, :]
        if self.repeat_to_max_len:
            z_ = z[:, None, :] if z.ndim == 2 else z
            return z_.expand(z_.shape[0], self.max_length, z_.shape[-1]), z
        return z


def _bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2/CLIP byte ↔ unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class SimpleTokenizer:
    """open_clip.tokenizer.SimpleTokenizer over the public
    `bpe_simple_vocab_16e6.txt.gz` merges file (at `bpe_path`,
    $UDIFFTEXT_CLIP_BPE or ./checkpoints/clip/bpe_simple_vocab_16e6.txt.gz):
    every byte has a token of its own, so a word no merge covers falls back
    to its bytes. Cleaning is html-unescape and whitespace collapse (what
    ftfy yields for well-formed text). Needs the `regex` package."""

    def __init__(self, bpe_path: Optional[str] = None, context_length: int = 77):
        import gzip
        import html

        path = bpe_path or os.environ.get(
            "UDIFFTEXT_CLIP_BPE", "./checkpoints/clip/bpe_simple_vocab_16e6.txt.gz")
        if not os.path.exists(path):
            raise FileNotFoundError(f"CLIP BPE vocab not found at {path}; set UDIFFTEXT_CLIP_BPE "
                                    "or pass token ids directly")
        import regex

        self._html = html
        self.byte_encoder = _bytes_to_unicode()
        with gzip.open(path) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1] if m]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab] + ["".join(m) for m in merges]
        vocab += ["<start_of_text>", "<end_of_text>"]
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<start_of_text>": "<start_of_text>", "<end_of_text>": "<end_of_text>"}
        self.pat = regex.compile(
            r"<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", regex.IGNORECASE)
        self.sot = self.encoder["<start_of_text>"]
        self.eot = self.encoder["<end_of_text>"]
        self.context_length = context_length

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word, word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, math.inf))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word, word[1:]))
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str):
        text = self._html.unescape(self._html.unescape(text))
        text = " ".join(text.strip().split()).lower()
        ids = []
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def tokenize(self, texts, context_length: Optional[int] = None) -> np.ndarray:
        """(len(texts), context_length) int32: sot, the text's ids (cut to
        fit), eot, zeros."""
        n = context_length or self.context_length
        out = np.zeros((len(texts), n), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode_text(text)[:n - 2] + [self.eot]
            out[i, :len(ids)] = ids
        return out
