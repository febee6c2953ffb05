"""Transformer blocks of the UNet (port of `udifftext_tpu/models/attention.py`).

Module and parameter names follow the reference torch checkpoint
(`transformer_blocks.0.attn1.to_q.weight`, `...ff.net.0.proj.weight`, …), so
a published state dict loads with `load_state_dict`. Attention maps are
returned, not stored on modules: (B, heads, N, L) fp32.

The UNet runs the blocks with `fuse_glue="off"`. A `BasicTransformerBlock`
built with `fuse_qkv=True, fuse_glue="auto"|"force"` instead fuses every
pre-LayerNorm into its consumer (ops/ln_gemm.py, ops/cross_attention.py,
ops/geglu.py `geglu_ff_ln`): a block-level A/B configuration, as in the JAX
build, with the same state-dict keys either way. The fused branches take the
raw x and the norm's `(weight, bias)` as `ln`.

Tensor parallelism (`parallel/sharding.shard_model_`) sets `tp` on the
attention and feed-forward modules it shards: they then hold their rank's
heads / hidden units, take their input through Megatron's f and sum their
row-parallel output over the tensor group (g). The fused branches are not
sharded.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import sdpa
from ..ops.attention import IMPLS as ATTN_IMPLS
from ..ops.cross_attention import (
    cross_attention_supported,
    fused_cross_attention,
    fused_cross_attention_ref,
)
from ..ops.geglu import geglu_ff, geglu_ff_ln
from ..ops.ln_gemm import ln_gemm3, ln_gemm3_supported, ln_ref_f32
from ..parallel.sharding import copy_to_tensor_parallel, reduce_from_tensor_parallel
from .layers import Dense, GroupNorm32, LayerNormF32, zero_init

KV = Tuple[torch.Tensor, torch.Tensor]
LN = Tuple[torch.Tensor, torch.Tensor]  # a pre-norm's (scale, bias)


def _check_attn_impl(attn_impl: str) -> str:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    return attn_impl


def _ln_pair(norm: nn.LayerNorm) -> LN:
    """A LayerNorm module's parameters as the fp32 `ln` pair of the fused ops."""
    return norm.weight.float(), norm.bias.float()


class SelfAttention(nn.Module):
    """Multi-head self-attention through `ops.sdpa` (flash on CUDA at the
    latent shapes). `fuse_qkv` is the A/B switch of the q/k/v projections:
    one concatenated product then a split or, with `ln`, the `ln_gemm3`
    kernel; the parameters are the same three `to_q/to_k/to_v` either way.
    `attn_impl` is handed to `sdpa` as its `impl`."""

    def __init__(self, dim: int, heads: int, dim_head: int, fuse_qkv: bool = False,
                 attn_impl: str = "auto"):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.fuse_qkv = fuse_qkv
        self.attn_impl = _check_attn_impl(attn_impl)
        self.to_q = Dense(dim, inner, bias=False)
        self.to_k = Dense(dim, inner, bias=False)
        self.to_v = Dense(dim, inner, bias=False)
        self.to_out = nn.ModuleList([Dense(inner, dim)])
        self.tp = None  # sharding.TensorParallel once sharded

    def forward(self, x: torch.Tensor, ln: Optional[LN] = None) -> torch.Tensor:
        """With `ln`, x is the raw input and the LayerNorm is applied here:
        inside the `ln_gemm3` kernel when `fuse_qkv` and the shape is one it
        takes (q, k, v come back compact), else by `ln_ref_f32`."""
        b, n, _ = x.shape
        shape = (b, n, self.heads, self.dim_head)
        if not self.fuse_qkv:
            if ln is not None:
                x = ln_ref_f32(x, ln[0], ln[1])
            if self.tp is not None:
                x = copy_to_tensor_parallel(x, self.tp.group)
            q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        else:
            wq, wk, wv = (m.weight.to(x.dtype) for m in (self.to_q, self.to_k, self.to_v))
            if ln is not None and ln_gemm3_supported(x, wq.shape[0]):
                q, k, v = ln_gemm3(x.contiguous(), ln[0], ln[1], wq, wk, wv)
            else:  # one wide product, then strided views of it
                if ln is not None:
                    x = ln_ref_f32(x, ln[0], ln[1])
                q, k, v = F.linear(x, torch.cat([wq, wk, wv], dim=0)).chunk(3, dim=-1)
        out = sdpa(q.reshape(shape), k.reshape(shape), v.reshape(shape), impl=self.attn_impl)
        out = out.reshape(b, n, self.heads * self.dim_head)
        if self.tp is not None:
            return self.tp.row_parallel(out, self.to_out[0].weight, self.to_out[0].bias)
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
        # zero-initialized, as in the reference (attention.py:129-134)
        self.to_out = nn.ModuleList([zero_init(Dense(inner, dim))])
        self.tp = None  # sharding.TensorParallel once sharded

    def project_kv(self, context: torch.Tensor) -> KV:
        """The context's K/V, (B, L, heads, dim_head) each; constant across
        sampling steps, so samplers compute it once."""
        b, l, _ = context.shape
        if self.tp is not None:
            context = copy_to_tensor_parallel(context, self.tp.group)
        shape = (b, l, self.heads, self.dim_head)
        return self.to_k(context).reshape(shape), self.to_v(context).reshape(shape)

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor],
        capture_map: bool = False,
        kv: Optional[KV] = None,
        ln: Optional[LN] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """With `ln`, x is the raw input and the returned output includes the
        residual (x + branch). With `ln` and hoisted `kv`, no map to capture
        and L > 1, the whole branch is `fused_cross_attention` (one kernel on
        CUDA at the shapes it takes); a single-token context keeps the
        sigmoid path."""
        b, n, _ = x.shape
        dt = x.dtype
        if ln is not None and kv is not None and not capture_map and kv[0].shape[1] > 1:
            k, v = kv
            fn = (fused_cross_attention if cross_attention_supported(x, k, self.heads)
                  else fused_cross_attention_ref)
            to_out = self.to_out[0]
            out = fn(x.contiguous(), ln[0], ln[1], self.to_q.weight.to(dt), k.contiguous(),
                     v.contiguous(), to_out.weight.to(dt), to_out.bias.to(dt), self.heads)
            return out, None
        residual = None
        if ln is not None:
            residual = x
            x = ln_ref_f32(x, ln[0], ln[1])
        k, v = self.project_kv(context) if kv is None else kv
        if self.tp is not None:
            x = copy_to_tensor_parallel(x, self.tp.group)
        q = self.to_q(x).reshape(b, n, self.heads, self.dim_head)
        sim = (torch.einsum("bnhd,blhd->bhnl", q, k) * self.dim_head**-0.5).float()
        attn = torch.softmax(sim, dim=-1) if k.shape[1] > 1 else torch.sigmoid(sim)
        out = torch.einsum("bhnl,blhd->bnhd", attn.to(x.dtype), v)
        out = out.reshape(b, n, self.heads * self.dim_head)
        if self.tp is not None:
            out = self.tp.row_parallel(out, self.to_out[0].weight, self.to_out[0].bias)
        else:
            out = self.to_out[0](out)
        if residual is not None:
            out = out + residual
        return out, (attn if capture_map else None)


class _Proj(nn.Module):
    """Holds the GEGLU input projection under the reference name `proj`."""

    def __init__(self, dim: int, out: int):
        super().__init__()
        self.proj = Dense(dim, out)


FF_IMPLS = ("auto", "fused", "plain")


def geglu_shape_ok(n: int) -> bool:
    """The token counts `geglu_auto_ok` sends to the fused kernel."""
    return n % 128 == 0


def geglu_auto_ok(x: torch.Tensor) -> bool:
    """The "auto" gate of `GEGLUFeedForward`: the fused kernel for CUDA bf16
    tensors with N % 128 == 0, the plain composition (two cuBLAS products
    around an eager gate) for everything else.

    Measured on an NVIDIA H100 80GB HBM3 at 700 W by `chip_smoke.py` (phase
    3, medians of single calls, kernel against plain composition, ms). fp32,
    ds2 B=2: 3.985 against 0.627 on the FMA kernel `geglu_simt_kernel`, so
    fp32 takes the plain composition (`impl="fused"` still reaches the
    kernel). bf16, ds1 / ds2 / ds4: at B=20 0.732 / 1.039 / 1.514 against
    1.085 / 0.666 / 0.509; at B=2 0.201 / 0.246 / 0.178 against 0.144 /
    0.094 / 0.122, where six launches of the composition cost the host about
    what the kernel's one launch costs the device. bf16 stays on the kernel:
    end to end the two are level (a 5-step sample with 7 UNet evals, phase
    5b: 0.760 s against 0.734 s with only the feed-forwards forced plain,
    inside the spread of repeated runs), the kernel is one launch a call, and
    it keeps the (M, 8·C) hidden out of device memory."""
    return x.is_cuda and x.dtype == torch.bfloat16 and geglu_shape_ok(x.shape[1])


class GEGLUFeedForward(nn.Module):
    """(h ⊙ gelu(g))·W2 + b2 with [h, g] = x·W1 + b1, inner width 4·dim.

    `impl` "auto" runs the fused kernel (ops/geglu.py, differentiable), which
    keeps the 8×-wide hidden out of device memory, where `geglu_auto_ok` says
    it pays, and the plain composition in the compute dtype elsewhere;
    "fused" always takes the kernel wrapper (its plain version on the CPU; a
    CUDA shape it does not serve raises); "plain" never launches a kernel.
    With `ln`, x is the raw input and the LayerNorm runs in the kernel's
    prologue (`geglu_ff_ln`) or, on the plain path, as `ln_ref_f32`."""

    def __init__(self, dim: int, mult: int = 4, impl: str = "auto"):
        super().__init__()
        if impl not in FF_IMPLS:
            raise ValueError(f"GEGLUFeedForward: impl must be one of {FF_IMPLS}, got {impl!r}")
        self.impl = impl
        self.net = nn.ModuleList([_Proj(dim, 2 * mult * dim), nn.Identity(), Dense(mult * dim, dim)])
        self.tp = None  # sharding.TensorParallel once sharded

    def forward(self, x: torch.Tensor, ln: Optional[LN] = None) -> torch.Tensor:
        """Sharded (`tp`), the rank's [h_t | g_t] hidden units of the
        unfused path, b2 once, the partial outputs summed over the group."""
        if self.tp is not None:
            if ln is not None:
                x = ln_ref_f32(x, ln[0], ln[1])
            x = copy_to_tensor_parallel(x, self.tp.group)
            return reduce_from_tensor_parallel(self._ff(x, self.tp.once(self.net[2].bias)),
                                               self.tp.group)
        return self._ff(x, self.net[2].bias, ln)

    def _ff(self, x: torch.Tensor, b2: torch.Tensor, ln: Optional[LN] = None) -> torch.Tensor:
        proj, out = self.net[0].proj, self.net[2]
        dt = x.dtype
        w1, b1 = proj.weight.to(dt), proj.bias.to(dt)
        w2, b2 = out.weight.to(dt), b2.to(dt)
        if self.impl == "fused" or (self.impl == "auto" and geglu_auto_ok(x)):
            if ln is not None:
                return geglu_ff_ln(x.contiguous(), ln[0], ln[1], w1, b1, w2, b2)
            return geglu_ff(x.contiguous(), w1, b1, w2, b2)
        if ln is not None:
            x = ln_ref_f32(x, ln[0], ln[1])
        h, g = F.linear(x, w1, b1).chunk(2, dim=-1)
        return F.linear(h * F.gelu(g), w2, b2)


class BasicTransformerBlock(nn.Module):
    """self-attn → t_attn → (v_attn) → GEGLU FF, pre-LayerNorm residuals.

    `fuse_glue` ("off" | "auto" | "force") fuses each pre-LayerNorm into its
    consumer instead of writing the normalized (B, N, C) activation to device
    memory: norm1 into the q/k/v projections (`ln_gemm3`), t_norm/v_norm into
    the one-kernel cross-attention branch (residual included; hoisted K/V and
    no map capture), norm3 into the GEGLU prologue. "force" always takes the
    fused branches (their plain versions on the CPU); "auto" takes them with
    `fuse_qkv`, bf16, a CUDA tensor, N % 128 == 0 and `attn_impl` other than
    "plain". The default is "off", as in the JAX build; the LayerNorm modules
    and every state-dict key are the same in all three. `attn_impl` ("auto" |
    "plain" | "flash") goes to the self-attention; "plain" also hands
    "plain" to the feed-forward, so that no kernel launches in the block."""

    def __init__(self, heads: int, dim_head: int, t_context_dim: Optional[int] = None,
                 v_context_dim: Optional[int] = None, fuse_qkv: bool = False,
                 fuse_glue: str = "off", attn_impl: str = "auto"):
        super().__init__()
        self.attn_impl = _check_attn_impl(attn_impl)
        if fuse_glue not in ("off", "auto", "force"):
            raise ValueError(f"fuse_glue must be 'off', 'auto' or 'force', got {fuse_glue!r}")
        dim = heads * dim_head
        self.fuse_qkv, self.fuse_glue = fuse_qkv, fuse_glue
        # the q/k/v projections fuse whenever the glue does, as in the JAX block
        self.attn1 = SelfAttention(dim, heads, dim_head,
                                   fuse_qkv=fuse_qkv or fuse_glue == "force",
                                   attn_impl=attn_impl)
        self.norm1 = LayerNormF32(dim)
        self.has_t = bool(t_context_dim)
        self.has_v = bool(v_context_dim)
        if self.has_t:
            self.t_attn = CrossAttention(dim, t_context_dim, heads, dim_head)
            self.t_norm = LayerNormF32(dim)
        if self.has_v:
            self.v_attn = CrossAttention(dim, v_context_dim, heads, dim_head)
            self.v_norm = LayerNormF32(dim)
        self.ff = GEGLUFeedForward(dim, impl="plain" if attn_impl == "plain" else "auto")
        self.norm3 = LayerNormF32(dim)

    def fuses(self, is_cuda: bool, dtype: torch.dtype, n: int) -> bool:
        """Whether a (B, n, C) input of `dtype` takes the fused-glue branches."""
        return self.fuse_glue == "force" or (
            self.fuse_glue == "auto" and self.fuse_qkv and dtype == torch.bfloat16
            and self.attn_impl != "plain" and is_cuda and n % 128 == 0)

    def forward(
        self,
        x: torch.Tensor,
        t_context: Optional[torch.Tensor] = None,
        v_context: Optional[torch.Tensor] = None,
        capture_map: bool = False,
        ctx_kv: Optional[Dict[str, KV]] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        ctx_kv = ctx_kv or {}
        fuse = self.fuses(x.is_cuda, x.dtype, x.shape[1])
        if fuse:
            x = self.attn1(x, ln=_ln_pair(self.norm1)) + x
        else:
            x = self.attn1(self.norm1(x)) + x
        t_map = None
        if self.has_t:
            if fuse and ctx_kv.get("t") is not None and not capture_map:
                x, _ = self.t_attn(x, t_context, False, ctx_kv["t"], ln=_ln_pair(self.t_norm))
            else:
                h, t_map = self.t_attn(self.t_norm(x), t_context, capture_map, ctx_kv.get("t"))
                x = h + x
        if self.has_v:
            if fuse and ctx_kv.get("v") is not None:
                x, _ = self.v_attn(x, v_context, False, ctx_kv["v"], ln=_ln_pair(self.v_norm))
            else:
                h, _ = self.v_attn(self.v_norm(x), v_context, False, ctx_kv.get("v"))
                x = h + x
        x = (self.ff(x, ln=_ln_pair(self.norm3)) if fuse else self.ff(self.norm3(x))) + x
        return x, t_map


class SpatialTransformer(nn.Module):
    """GroupNorm → linear proj_in → blocks → proj_out → residual, on NHWC x."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 t_context_dim: Optional[int] = None, v_context_dim: Optional[int] = None,
                 attn_impl: str = "auto"):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Dense(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(heads, dim_head, t_context_dim, v_context_dim,
                                   attn_impl=attn_impl)
             for _ in range(depth)]
        )
        self.proj_out = zero_init(Dense(inner, channels))

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
