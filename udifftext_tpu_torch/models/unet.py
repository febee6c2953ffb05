"""UNet of the SD2-inpainting backbone (port of `udifftext_tpu/models/unet.py`).

The block layout comes from `unet_plan`, the same loop as the JAX build and
the reference (openaimodel.py:382-533). Module and parameter names are the
reference checkpoint's: `input_blocks.1.0.in_layers.0.weight`,
`middle_block.1.transformer_blocks.0.t_attn.to_k.weight`, `out.2.bias`, ….
Activations are NHWC. `forward` returns the output in fp32 and the captured
t_attn maps keyed by module path (e.g. "output_blocks.6.1.t_attn").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import SpatialTransformer
from .layers import (Conv1x1, Conv3x3, Dense, GroupNorm32, timestep_embedding,
                     upsample_nearest_2x, zero_init)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str  # conv | res | attn | down | up
    in_ch: int = 0
    out_ch: int = 0
    heads: int = 0
    dim_head: int = 0
    ds: int = 0  # downsample factor at this layer (attn only)


@dataclasses.dataclass(frozen=True)
class UNetPlan:
    input_blocks: Tuple[Tuple[LayerSpec, ...], ...]
    middle_block: Tuple[LayerSpec, ...]
    output_blocks: Tuple[Tuple[LayerSpec, ...], ...]
    out_ch: int


def unet_plan(
    model_channels: int,
    num_res_blocks: int,
    attention_resolutions: Sequence[int],
    channel_mult: Sequence[int],
    num_head_channels: int,
    num_heads: int = -1,
) -> UNetPlan:
    """The block layout loops of openaimodel.py:382-533."""

    def attn_spec(ch: int, ds: int) -> LayerSpec:
        if num_head_channels == -1:
            heads, dim_head = num_heads, ch // num_heads
        else:
            heads, dim_head = ch // num_head_channels, num_head_channels
        return LayerSpec("attn", ch, ch, heads, dim_head, ds)

    input_blocks: List[Tuple[LayerSpec, ...]] = [(LayerSpec("conv", 0, model_channels),)]
    input_chans = [model_channels]
    ch = model_channels
    ds = 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            layers = [LayerSpec("res", ch, mult * model_channels)]
            ch = mult * model_channels
            if ds in attention_resolutions:
                layers.append(attn_spec(ch, ds))
            input_blocks.append(tuple(layers))
            input_chans.append(ch)
        if level != len(channel_mult) - 1:
            input_blocks.append((LayerSpec("down", ch, ch),))
            input_chans.append(ch)
            ds *= 2

    middle = (LayerSpec("res", ch, ch), attn_spec(ch, ds), LayerSpec("res", ch, ch))

    output_blocks: List[Tuple[LayerSpec, ...]] = []
    for level, mult in list(enumerate(channel_mult))[::-1]:
        for i in range(num_res_blocks + 1):
            ich = input_chans.pop()
            layers = [LayerSpec("res", ch + ich, model_channels * mult)]
            ch = model_channels * mult
            if ds in attention_resolutions:
                layers.append(attn_spec(ch, ds))
            if level and i == num_res_blocks:
                layers.append(LayerSpec("up", ch, ch))
                ds //= 2
            output_blocks.append(tuple(layers))

    return UNetPlan(tuple(input_blocks), middle, tuple(output_blocks), out_ch=model_channels)


class ResBlock(nn.Module):
    """Residual block (openaimodel.py:149-268) without up/down sampling."""

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int):
        super().__init__()
        self.in_layers = nn.ModuleList([GroupNorm32(in_ch), nn.SiLU(), Conv3x3(in_ch, out_ch)])
        self.emb_layers = nn.ModuleList([nn.SiLU(), Dense(emb_ch, out_ch)])
        self.out_layers = nn.ModuleList(
            [GroupNorm32(out_ch), nn.SiLU(), nn.Identity(), zero_init(Conv3x3(out_ch, out_ch))]
        )
        self.skip_connection = Conv1x1(in_ch, out_ch) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[2](F.silu(self.in_layers[0](x)))
        h = h + self.emb_layers[1](F.silu(emb))[:, None, None, :].to(h.dtype)
        h = self.out_layers[3](F.silu(self.out_layers[0](h)))
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return x + h


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = Conv3x3(ch, ch, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv3x3(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest_2x(x))


class UNetModel(nn.Module):
    """UnifiedUNetModel without the ctrl block, label embedding or
    scale-shift norm (the shipped graph uses none of them)."""

    def __init__(
        self,
        in_channels: int = 9,
        model_channels: int = 320,
        out_channels: int = 4,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        num_head_channels: int = 64,
        num_heads: int = -1,
        transformer_depth: int = 1,
        t_context_dim: Optional[int] = 2048,
        v_context_dim: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        attn_impl: str = "auto",
    ):
        super().__init__()
        self.attn_impl = attn_impl  # "auto" | "plain" | "flash", for every transformer block
        self.in_channels = in_channels
        self.model_channels = model_channels
        self.channel_mult = tuple(channel_mult)
        self.transformer_depth = transformer_depth
        self.t_context_dim = t_context_dim
        self.dtype = dtype
        # gradient checkpointing of every ResBlock and SpatialTransformer
        # (the JAX build's `remat`): their activations are recomputed in the
        # backward instead of kept, so the kernels in them launch again there
        self.remat = remat
        self.plan = unet_plan(model_channels, num_res_blocks, attention_resolutions,
                              channel_mult, num_head_channels, num_heads)
        time_dim = model_channels * 4

        def make(spec: LayerSpec) -> nn.Module:
            if spec.kind == "conv":
                return Conv3x3(in_channels, spec.out_ch)
            if spec.kind == "res":
                return ResBlock(spec.in_ch, spec.out_ch, time_dim)
            if spec.kind == "attn":
                return SpatialTransformer(spec.in_ch, spec.heads, spec.dim_head,
                                          transformer_depth, t_context_dim, v_context_dim,
                                          attn_impl=attn_impl)
            if spec.kind == "down":
                return Downsample(spec.out_ch)
            if spec.kind == "up":
                return Upsample(spec.out_ch)
            raise ValueError(spec.kind)

        self.time_embed = nn.Sequential(
            Dense(model_channels, time_dim), nn.SiLU(), Dense(time_dim, time_dim)
        )
        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([make(s) for s in blk]) for blk in self.plan.input_blocks]
        )
        self.middle_block = nn.ModuleList([make(s) for s in self.plan.middle_block])
        self.output_blocks = nn.ModuleList(
            [nn.ModuleList([make(s) for s in blk]) for blk in self.plan.output_blocks]
        )
        self.out = nn.ModuleList(
            [GroupNorm32(model_channels), nn.SiLU(),
             zero_init(Conv3x3(model_channels, out_channels))]
        )

    def _blocks(self):
        """(path prefix, modules, specs) of every block in execution order."""
        for i, (mods, specs) in enumerate(zip(self.input_blocks, self.plan.input_blocks)):
            yield f"input_blocks.{i}", mods, specs
        yield "middle_block", self.middle_block, self.plan.middle_block
        for i, (mods, specs) in enumerate(zip(self.output_blocks, self.plan.output_blocks)):
            yield f"output_blocks.{i}", mods, specs

    def precompute_context_kv(
        self, t_context: Optional[torch.Tensor], v_context: Optional[torch.Tensor] = None
    ) -> Optional[Dict[str, Any]]:
        """Every cross-attention layer's K/V of contexts that stay constant
        across sampling steps, keyed "input_blocks.1.1" etc.; pass as
        `ctx_kv` to `forward` to skip the per-step projections."""
        if t_context is None and v_context is None:
            return None
        tc = t_context.to(self.dtype) if t_context is not None else None
        vc = v_context.to(self.dtype) if v_context is not None else None
        out = {}
        for prefix, mods, specs in self._blocks():
            for j, (m, s) in enumerate(zip(mods, specs)):
                if s.kind == "attn":
                    out[f"{prefix}.{j}"] = m.precompute_kv(tc, vc)
        return out

    def _apply_block(self, prefix, mods, specs, h, emb, t_context, v_context,
                     capture_attn, attn_maps, ctx_kv):
        remat = self.remat and torch.is_grad_enabled()
        for j, (m, s) in enumerate(zip(mods, specs)):
            if s.kind == "res":
                h = checkpoint(m, h, emb, use_reentrant=False) if remat else m(h, emb)
            elif s.kind == "attn":
                layer_kv = ctx_kv.get(f"{prefix}.{j}") if ctx_kv else None
                args = (h, t_context, v_context, capture_attn, layer_kv)
                h, maps = checkpoint(m, *args, use_reentrant=False) if remat else m(*args)
                if capture_attn:
                    for d, amap in enumerate(maps):
                        if amap is None:
                            continue
                        key = (f"{prefix}.{j}.t_attn" if self.transformer_depth == 1
                               else f"{prefix}.{j}.blocks_{d}.t_attn")
                        attn_maps[key] = amap
            else:
                h = m(h)
        return h

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        t_context: Optional[torch.Tensor] = None,
        v_context: Optional[torch.Tensor] = None,
        capture_attn: bool = False,
        ctx_kv: Optional[Dict[str, Any]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x (B, H, W, in_channels), timesteps (B,) → ((B, H, W, out), maps)."""
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels).to(self.dtype))
        if t_context is not None:
            t_context = t_context.to(self.dtype)
        if v_context is not None:
            v_context = v_context.to(self.dtype)
        attn_maps: Dict[str, torch.Tensor] = {}
        h = x.to(self.dtype)
        hs = []
        blocks = list(self._blocks())
        n_in = len(self.input_blocks)
        for prefix, mods, specs in blocks[:n_in]:
            h = self._apply_block(prefix, mods, specs, h, emb, t_context, v_context,
                                  capture_attn, attn_maps, ctx_kv)
            hs.append(h)
        prefix, mods, specs = blocks[n_in]
        h = self._apply_block(prefix, mods, specs, h, emb, t_context, v_context,
                              capture_attn, attn_maps, ctx_kv)
        for prefix, mods, specs in blocks[n_in + 1:]:
            h = torch.cat([h, hs.pop()], dim=-1)
            h = self._apply_block(prefix, mods, specs, h, emb, t_context, v_context,
                                  capture_attn, attn_maps, ctx_kv)
        h = self.out[2](F.silu(self.out[0](h)))
        return h.float(), attn_maps
