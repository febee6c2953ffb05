"""Transformer blocks of the UNet (port of `udifftext_tpu/models/attention.py`,
the `fuse_glue="off"` path the UNet runs).

Module and parameter names follow the reference torch checkpoint
(`transformer_blocks.0.attn1.to_q.weight`, `...ff.net.0.proj.weight`, …), so
a published state dict loads with `load_state_dict`. Attention maps are
returned, not stored on modules: (B, heads, N, L) fp32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import sdpa
from ..ops.geglu import geglu_ff
from .layers import Dense, GroupNorm32, LayerNormF32

KV = Tuple[torch.Tensor, torch.Tensor]


class SelfAttention(nn.Module):
    """Multi-head self-attention through `ops.sdpa` (flash on CUDA at the
    latent shapes)."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(dim, inner, bias=False)
        self.to_k = Dense(dim, inner, bias=False)
        self.to_v = Dense(dim, inner, bias=False)
        self.to_out = nn.ModuleList([Dense(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        shape = (b, n, self.heads, self.dim_head)
        q = self.to_q(x).reshape(shape)
        k = self.to_k(x).reshape(shape)
        v = self.to_v(x).reshape(shape)
        out = sdpa(q, k, v).reshape(b, n, self.heads * self.dim_head)
        return self.to_out[0](out)


class CrossAttention(nn.Module):
    """Cross-attention with an explicit map: softmax over the L context
    tokens in fp32, sigmoid when L == 1."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(dim, inner, bias=False)
        self.to_k = Dense(context_dim, inner, bias=False)
        self.to_v = Dense(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Dense(inner, dim)])

    def project_kv(self, context: torch.Tensor) -> KV:
        """The context's K/V, (B, L, heads, dim_head) each; constant across
        sampling steps, so samplers compute it once."""
        b, l, _ = context.shape
        shape = (b, l, self.heads, self.dim_head)
        return self.to_k(context).reshape(shape), self.to_v(context).reshape(shape)

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor],
        capture_map: bool = False,
        kv: Optional[KV] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        b, n, _ = x.shape
        k, v = self.project_kv(context) if kv is None else kv
        q = self.to_q(x).reshape(b, n, self.heads, self.dim_head)
        sim = (torch.einsum("bnhd,blhd->bhnl", q, k) * self.dim_head**-0.5).float()
        attn = torch.softmax(sim, dim=-1) if k.shape[1] > 1 else torch.sigmoid(sim)
        out = torch.einsum("bhnl,blhd->bnhd", attn.to(x.dtype), v)
        out = self.to_out[0](out.reshape(b, n, self.heads * self.dim_head))
        return out, (attn if capture_map else None)


class _Proj(nn.Module):
    """Holds the GEGLU input projection under the reference name `proj`."""

    def __init__(self, dim: int, out: int):
        super().__init__()
        self.proj = Dense(dim, out)


class GEGLUFeedForward(nn.Module):
    """(h ⊙ gelu(g))·W2 + b2 with [h, g] = x·W1 + b1, inner width 4·dim.

    On CUDA with N % 128 == 0 it runs the fused kernel (ops/geglu.py,
    differentiable), which keeps the 8×-wide hidden out of device memory;
    otherwise the plain composition in the compute dtype."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([_Proj(dim, 2 * mult * dim), nn.Identity(), Dense(mult * dim, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj, out = self.net[0].proj, self.net[2]
        dt = x.dtype
        w1, b1 = proj.weight.to(dt), proj.bias.to(dt)
        w2, b2 = out.weight.to(dt), out.bias.to(dt)
        if x.is_cuda and x.shape[1] % 128 == 0:
            return geglu_ff(x.contiguous(), w1, b1, w2, b2)
        h, g = F.linear(x, w1, b1).chunk(2, dim=-1)
        return F.linear(h * F.gelu(g), w2, b2)


class BasicTransformerBlock(nn.Module):
    """self-attn → t_attn → (v_attn) → GEGLU FF, pre-LayerNorm residuals."""

    def __init__(self, heads: int, dim_head: int, t_context_dim: Optional[int] = None,
                 v_context_dim: Optional[int] = None):
        super().__init__()
        dim = heads * dim_head
        self.attn1 = SelfAttention(dim, heads, dim_head)
        self.norm1 = LayerNormF32(dim)
        self.has_t = bool(t_context_dim)
        self.has_v = bool(v_context_dim)
        if self.has_t:
            self.t_attn = CrossAttention(dim, t_context_dim, heads, dim_head)
            self.t_norm = LayerNormF32(dim)
        if self.has_v:
            self.v_attn = CrossAttention(dim, v_context_dim, heads, dim_head)
            self.v_norm = LayerNormF32(dim)
        self.ff = GEGLUFeedForward(dim)
        self.norm3 = LayerNormF32(dim)

    def forward(
        self,
        x: torch.Tensor,
        t_context: Optional[torch.Tensor] = None,
        v_context: Optional[torch.Tensor] = None,
        capture_map: bool = False,
        ctx_kv: Optional[Dict[str, KV]] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        ctx_kv = ctx_kv or {}
        x = self.attn1(self.norm1(x)) + x
        t_map = None
        if self.has_t:
            h, t_map = self.t_attn(self.t_norm(x), t_context, capture_map, ctx_kv.get("t"))
            x = h + x
        if self.has_v:
            h, _ = self.v_attn(self.v_norm(x), v_context, False, ctx_kv.get("v"))
            x = h + x
        x = self.ff(self.norm3(x)) + x
        return x, t_map


class SpatialTransformer(nn.Module):
    """GroupNorm → linear proj_in → blocks → proj_out → residual, on NHWC x."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 t_context_dim: Optional[int] = None, v_context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Dense(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(heads, dim_head, t_context_dim, v_context_dim)
             for _ in range(depth)]
        )
        self.proj_out = Dense(inner, channels)

    def precompute_kv(self, t_context: Optional[torch.Tensor],
                      v_context: Optional[torch.Tensor]) -> List[Dict[str, KV]]:
        """Per block, the cross-attention K/V of constant contexts."""
        out = []
        for blk in self.transformer_blocks:
            entry = {}
            if t_context is not None and blk.has_t:
                entry["t"] = blk.t_attn.project_kv(t_context)
            if v_context is not None and blk.has_v:
                entry["v"] = blk.v_attn.project_kv(v_context)
            out.append(entry)
        return out

    def forward(
        self,
        x: torch.Tensor,
        t_context: Optional[torch.Tensor] = None,
        v_context: Optional[torch.Tensor] = None,
        capture_map: bool = False,
        ctx_kv: Optional[List[Dict[str, KV]]] = None,
    ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
        b, h, w, c = x.shape
        x_in = x
        x = self.proj_in(self.norm(x).reshape(b, h * w, c))
        maps = []
        for d, blk in enumerate(self.transformer_blocks):
            x, m = blk(x, t_context, v_context, capture_map,
                       ctx_kv[d] if ctx_kv is not None else None)
            maps.append(m)
        x = self.proj_out(x).reshape(b, h, w, c)
        return x + x_in, maps
