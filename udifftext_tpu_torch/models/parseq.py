"""PARSeq scene-text recognizer, the frozen OCR model of the fine-tuning loss
(port of `udifftext_tpu/models/parseq.py`: the tokenizer, the inference
model and the permuted-language-modelling training loss).

PARSeq-base: a ViT encoder over 32×128 crops (patch 4×8, dim 384, depth 12,
heads 6) and one two-stream pre-LN decoder layer (12 heads). Parameter
names are strhub's (`encoder.*`, `decoder.layers.0.self_attn.in_proj_weight`,
`decoder.norm.weight`, `text_embed.embedding.weight`, `pos_queries`,
`head.weight`), so `parseq-bb5792a6.pt` loads by name.

The full read is the JAX package's, not strhub's early-exit loop: all
`max_label_length + 1` greedy steps run over a fixed PAD-filled context
with the keys masked causally (no exit on EOS), then one cloze refinement
whose query mask unmasks every key but the next position and whose padding
mask hides the keys from the first EOS on. The logits are always
(B, max_label_length + 1, num_tokens − 2) fp32. Masks add −1e9, not −inf.
Attention is plain matmul and fp32 softmax.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense
from .vit import ViTEncoder

# PARSeq's training charset (94_full): its own ordering, distinct from
# udifftext_tpu_torch.charset.CHARSET.
PARSEQ_CHARSET = (
    "0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
)

NEG_INF = -1e9


class ParseqTokenizer:
    """strhub's Tokenizer: EOS first (id 0), the charset, BOS, PAD."""

    def __init__(self, charset: str = PARSEQ_CHARSET):
        self.itos = ("[E]",) + tuple(charset) + ("[B]", "[P]")
        self.stoi = {s: i for i, s in enumerate(self.itos)}
        self.eos_id = 0
        self.bos_id = self.stoi["[B]"]
        self.pad_id = self.stoi["[P]"]

    def __len__(self):
        return len(self.itos)

    def encode(self, labels: Sequence[str], max_length: int = 25) -> np.ndarray:
        """(B, max_length + 2) int32: [BOS, chars, EOS, PAD...]; characters
        outside the charset are dropped and longer labels truncated."""
        out = np.full((len(labels), max_length + 2), self.pad_id, np.int32)
        for i, y in enumerate(labels):
            chars = [self.stoi[c] for c in y if c in self.stoi]
            ids = [self.bos_id] + chars[:max_length] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out

    def decode_ids(self, ids) -> List[str]:
        """Greedy ids (B, L) → strings truncated at the first EOS."""
        labels = []
        for row in np.asarray(ids):
            chars = []
            for i in row:
                if i == self.eos_id:
                    break
                if 0 < i < self.bos_id:
                    chars.append(self.itos[i])
            labels.append("".join(chars))
        return labels


class TorchMHA(nn.Module):
    """`nn.MultiheadAttention` (packed `in_proj_weight`/`in_proj_bias`,
    `out_proj`) with an additive float `attn_mask` (Lq, Lk) and a boolean
    `key_padding_mask` (B, Lk) whose True keys get −1e9."""

    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Dense(d, d)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        d = query.shape[-1]
        h = self.num_heads
        w, b = self.in_proj_weight.to(query.dtype), self.in_proj_bias.to(query.dtype)
        q = F.linear(query, w[:d], b[:d])
        k = F.linear(key, w[d:2 * d], b[d:2 * d])
        v = F.linear(value, w[2 * d:], b[2 * d:])
        bsz, lq = q.shape[:2]
        lk = k.shape[1]
        q = q.reshape(bsz, lq, h, d // h)
        k = k.reshape(bsz, lk, h, d // h)
        v = v.reshape(bsz, lk, h, d // h)
        logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d // h)).float()
        if attn_mask is not None:
            logits = logits + attn_mask.float()
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
        wts = torch.softmax(logits, dim=-1).to(query.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", wts, v).reshape(bsz, lq, d)
        return self.out_proj(out)


class ParseqDecoderLayer(nn.Module):
    """strhub's two-stream pre-LN DecoderLayer (eps 1e-5, exact GELU)."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = TorchMHA(d_model, num_heads)
        self.cross_attn = TorchMHA(d_model, num_heads)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm_q = nn.LayerNorm(d_model, eps=1e-5)
        self.norm_c = nn.LayerNorm(d_model, eps=1e-5)

    def forward_stream(self, tgt, tgt_norm, tgt_kv, memory, tgt_mask, kp_mask):
        tgt = tgt + self.self_attn(tgt_norm, tgt_kv, tgt_kv, tgt_mask, kp_mask)
        tgt = tgt + self.cross_attn(self.norm1(tgt), memory, memory)
        return tgt + self.linear2(F.gelu(self.linear1(self.norm2(tgt))))

    def forward(self, query, content, memory, query_mask=None, content_mask=None,
                content_key_padding_mask=None, update_content: bool = True):
        query_norm = self.norm_q(query)
        content_norm = self.norm_c(content)
        query = self.forward_stream(query, query_norm, content_norm, memory, query_mask,
                                    content_key_padding_mask)
        if update_content:
            content = self.forward_stream(content, content_norm, content_norm, memory,
                                          content_mask, content_key_padding_mask)
        return query, content


class ParseqDecoder(nn.Module):
    """strhub's Decoder: the layers and the final norm."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int, depth: int):
        super().__init__()
        self.layers = nn.ModuleList(ParseqDecoderLayer(d_model, num_heads, dim_feedforward)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(d_model, eps=1e-5)


class TokenEmbedding(nn.Module):
    def __init__(self, num_tokens: int, embed_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(num_tokens, embed_dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return math.sqrt(self.embedding.embedding_dim) * self.embedding(tokens)


class PARSeq(nn.Module):
    """PARSeq-base inference model, fp32. Images (B, 32, 128, 3) normalized
    to [-1, 1]."""

    def __init__(self, max_label_length: int = 25, img_size: Tuple[int, int] = (32, 128),
                 patch_size: Tuple[int, int] = (4, 8), embed_dim: int = 384,
                 enc_depth: int = 12, enc_num_heads: int = 6, enc_mlp_ratio: float = 4.0,
                 dec_depth: int = 1, dec_num_heads: int = 12, dec_mlp_ratio: float = 4.0,
                 num_tokens: int = len(PARSEQ_CHARSET) + 3):
        super().__init__()
        self.max_label_length = max_label_length
        self.img_size = tuple(img_size)
        self.embed_dim = embed_dim
        self.num_tokens = num_tokens
        self.encoder = ViTEncoder(img_size, patch_size, embed_dim, enc_depth, enc_num_heads,
                                  enc_mlp_ratio)
        self.decoder = ParseqDecoder(embed_dim, dec_num_heads, int(embed_dim * dec_mlp_ratio),
                                     dec_depth)
        self.head = Dense(embed_dim, num_tokens - 2)
        self.text_embed = TokenEmbedding(num_tokens, embed_dim)
        self.pos_queries = nn.Parameter(
            nn.init.trunc_normal_(torch.empty(1, max_label_length + 1, embed_dim), std=0.02))

    @property
    def bos_id(self) -> int:
        return self.num_tokens - 2

    @property
    def eos_id(self) -> int:
        return 0

    @property
    def pad_id(self) -> int:
        return self.num_tokens - 1

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return self.encoder(images)

    def _embed_context(self, tgt: torch.Tensor) -> torch.Tensor:
        """The null (BOS) context, then position queries plus the char
        embeddings."""
        null_ctx = self.text_embed(tgt[:, :1])
        if tgt.shape[1] == 1:
            return null_ctx
        emb = self.pos_queries[:, :tgt.shape[1] - 1] + self.text_embed(tgt[:, 1:])
        return torch.cat([null_ctx, emb], dim=1)

    def decode(self, tgt: torch.Tensor, memory: torch.Tensor,
               tgt_mask: Optional[torch.Tensor] = None,
               tgt_padding_mask: Optional[torch.Tensor] = None,
               tgt_query: Optional[torch.Tensor] = None,
               tgt_query_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bsz, l = tgt.shape
        content = self._embed_context(tgt)
        query = (self.pos_queries[:, :l].expand(bsz, l, self.embed_dim)
                 if tgt_query is None else tgt_query)
        layers = self.decoder.layers
        for i, layer in enumerate(layers):
            query, content = layer(query, content, memory, tgt_query_mask, tgt_mask,
                                   tgt_padding_mask, update_content=i < len(layers) - 1)
        return self.decoder.norm(query)

    def forward(self, images: torch.Tensor, refine_iters: int = 1) -> torch.Tensor:
        """Full read: the greedy AR decode over a fixed context, then
        `refine_iters` cloze refinements → logits (B, max_label_length + 1,
        num_tokens − 2) fp32. With a refinement, the AR steps only choose
        the context (their argmax carries no gradient), so they run without
        autograd; the logits and their gradient are the same."""
        bsz = images.shape[0]
        steps = self.max_label_length + 1
        dev = images.device
        memory = self.encode(images)
        pos_q = self.pos_queries[:, :steps].expand(bsz, steps, self.embed_dim)
        causal = torch.triu(torch.full((steps, steps), NEG_INF, device=dev), 1)

        col = torch.arange(steps, device=dev)
        tgt_in = torch.where(col == 0, self.bos_id, self.pad_id).expand(bsz, steps)
        logits = torch.zeros(bsz, steps, self.num_tokens - 2, device=dev)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not refine_iters):
            for i in range(steps):
                out = self.decode(tgt_in, memory, tgt_mask=causal, tgt_query=pos_q[:, i:i + 1],
                                  tgt_query_mask=causal[i:i + 1])
                p_i = self.head(out).float()[:, 0]
                logits[:, i] = p_i
                # a new context each step: the embedding saved the old one
                tgt_in = torch.where(col == i + 1, p_i.argmax(dim=-1)[:, None], tgt_in)

        if refine_iters:
            triu2 = torch.triu(torch.ones(steps, steps, dtype=torch.bool, device=dev), 2)
            query_mask = causal.masked_fill(triu2, 0.0)
            bos = torch.full((bsz, 1), self.bos_id, dtype=torch.long, device=dev)
            for _ in range(refine_iters):
                tgt_in = torch.cat([bos, logits[:, :-1].argmax(dim=-1)], dim=1)
                pad_mask = (tgt_in == self.eos_id).cumsum(dim=-1) > 0
                out = self.decode(tgt_in, memory, tgt_mask=causal, tgt_padding_mask=pad_mask,
                                  tgt_query=pos_q, tgt_query_mask=query_mask)
                logits = self.head(out).float()
        return logits

    def forward_logits(self, images: torch.Tensor, tgt_in: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits over the context `tgt_in` (B, L), causal."""
        num = tgt_in.shape[1]
        memory = self.encode(images)
        causal = torch.triu(torch.full((num, num), NEG_INF, device=images.device), 1)
        out = self.decode(tgt_in, memory, tgt_mask=causal, tgt_query_mask=causal)
        return self.head(out).float()


# ---------------------------------------------------------------------------
# Permutation language modelling: the training loss (system.py:154-259)
# ---------------------------------------------------------------------------


def gen_tgt_perms(rng: np.random.Generator, max_num_chars: int, perm_num: int = 6,
                  perm_forward: bool = True, perm_mirrored: bool = True) -> np.ndarray:
    """The batch's shared orderings, BOS and EOS positions included
    (n_perms, max_num_chars + 2) int32: the forward one first, each drawn
    one followed by its mirror, the second replaced by the reverse order."""
    import itertools

    if max_num_chars == 1:
        return np.arange(3, dtype=np.int32)[None]

    perms = [np.arange(max_num_chars)] if perm_forward else []
    max_gen_perms = perm_num // 2 if perm_mirrored else perm_num
    max_perms = math.factorial(max_num_chars)
    if perm_mirrored:
        max_perms //= 2
    num_gen_perms = min(max_gen_perms, max_perms)

    if max_num_chars < 5:
        if max_num_chars == 4 and perm_mirrored:
            selector = [0, 3, 4, 6, 9, 10, 12, 16, 17, 18, 19, 21]
        else:
            selector = list(range(max_perms))
        pool = np.asarray(list(itertools.permutations(range(max_num_chars))))[selector]
        if perm_forward:
            pool = pool[1:]
        perms = np.stack(perms)
        if len(pool):
            i = rng.choice(len(pool), size=num_gen_perms - len(perms), replace=False)
            perms = np.concatenate([perms, pool[i]])
    else:
        perms.extend(rng.permutation(max_num_chars) for _ in range(num_gen_perms - len(perms)))
        perms = np.stack(perms)

    if perm_mirrored:
        perms = np.stack([perms, perms[:, ::-1]], axis=1).reshape(-1, max_num_chars)

    bos_idx = np.zeros((len(perms), 1), perms.dtype)
    eos_idx = np.full((len(perms), 1), max_num_chars + 1, perms.dtype)
    perms = np.concatenate([bos_idx, perms + 1, eos_idx], axis=1)
    if len(perms) > 1:
        perms[1, 1:] = max_num_chars + 1 - np.arange(max_num_chars + 1)
    return perms.astype(np.int32)


def attn_masks_from_perm(perm: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(content_mask, query_mask) of one ordering, additive −1e9 masks:
    a position reads only those before it in the ordering; the query
    stream not even itself."""
    sz = perm.shape[0]
    mask = np.zeros((sz, sz), np.float32)
    for i in range(sz):
        mask[perm[i], perm[i + 1:]] = NEG_INF
    content_mask = mask[:-1, :-1].copy()
    mask[np.eye(sz, dtype=bool)] = NEG_INF
    return content_mask, mask[1:, :-1]


def perm_attn_masks(perms: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The masks of every ordering, stacked."""
    cms, qms = zip(*(attn_masks_from_perm(np.asarray(p)) for p in perms))
    return np.stack(cms), np.stack(qms)


def parseq_training_loss(model: PARSeq, images: torch.Tensor, label_ids: torch.Tensor,
                         perms: np.ndarray) -> torch.Tensor:
    """The permuted autoregressive CE (system.py:244-259), under autograd:
    the teacher-forced CE over `label_ids` (B, L) ([BOS, chars, EOS, PAD…])
    for each ordering of `perms` (from `gen_tgt_perms`), weighted by its
    count of targets; EOS targets count only in the first two orderings."""
    content_masks, query_masks = perm_attn_masks(np.asarray(perms))
    dev = images.device
    content_masks = torch.as_tensor(content_masks, dtype=torch.float32, device=dev)
    query_masks = torch.as_tensor(query_masks, dtype=torch.float32, device=dev)
    label_ids = label_ids.to(dev).long()
    tgt_in, tgt_out = label_ids[:, :-1], label_ids[:, 1:]
    padding = (tgt_in == model.pad_id) | (tgt_in == model.eos_id)
    memory = model.encode(images)

    loss = numel = 0.0
    n = (tgt_out != model.pad_id).sum()
    for i in range(content_masks.shape[0]):
        out = model.decode(tgt_in, memory, tgt_mask=content_masks[i], tgt_padding_mask=padding,
                           tgt_query_mask=query_masks[i])
        logp = torch.log_softmax(model.head(out).float(), dim=-1)
        idx = tgt_out.clamp(0, logp.shape[-1] - 1)
        nll = -logp.gather(-1, idx[..., None])[..., 0]
        valid = tgt_out != model.pad_id
        loss = loss + n * (nll * valid).sum() / valid.sum().clamp(min=1)
        numel = numel + n
        if i == 1:
            tgt_out = torch.where(tgt_out == model.eos_id, model.pad_id, tgt_out)
            n = (tgt_out != model.pad_id).sum()
    return loss / numel
