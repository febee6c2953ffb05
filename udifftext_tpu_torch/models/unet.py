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
    """Residual block (openaimodel.py:149-268) without up/down sampling. With
    `use_scale_shift_norm` the embedding projects to 2·out_ch (scale, shift)
    and the output norm becomes GroupNorm(h)·(1 + scale) + shift."""

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int, use_scale_shift_norm: bool = False):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.ModuleList([GroupNorm32(in_ch), nn.SiLU(), Conv3x3(in_ch, out_ch)])
        self.emb_layers = nn.ModuleList(
            [nn.SiLU(), Dense(emb_ch, 2 * out_ch if use_scale_shift_norm else out_ch)])
        self.out_layers = nn.ModuleList(
            [GroupNorm32(out_ch), nn.SiLU(), nn.Identity(), zero_init(Conv3x3(out_ch, out_ch))]
        )
        self.skip_connection = Conv1x1(in_ch, out_ch) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[2](self.in_layers[0](x, silu=True))
        emb_out = self.emb_layers[1](F.silu(emb))[:, None, None, :].to(h.dtype)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = F.silu(self.out_layers[0](h) * (1 + scale) + shift)
        else:
            h = self.out_layers[0](h + emb_out, silu=True)
        h = self.out_layers[3](h)
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return x + h


CTRL_WIDTHS = (16, 16, 32, 32, 96, 96, 256)


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
    """UnifiedUNetModel. Options the shipped graph leaves off:
    `ctrl_channels` > 0 adds the ControlNet-style hint encoder (`ctrl_block`:
    seven 3×3 convs of widths CTRL_WIDTHS, each followed by SiLU, then a
    zero-initialized conv to model_channels, at `ctrl_block.14`), which
    reads x[..., in_channels:in_channels + ctrl_channels] and is added after
    input block 0; `use_label` adds `label_emb` (two Dense layers over `y`
    with `adm_in_channels` inputs, at `label_emb.0.0` / `label_emb.0.2`) to
    the time embedding; `use_scale_shift_norm` switches every ResBlock to
    the scale-shift norm."""

    def __init__(
        self,
        in_channels: int = 9,
        ctrl_channels: int = 0,
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
        adm_in_channels: Optional[int] = None,
        use_label: Optional[int] = None,
        use_scale_shift_norm: bool = False,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        attn_impl: str = "auto",
    ):
        super().__init__()
        self.attn_impl = attn_impl  # "auto" | "plain" | "flash", for every transformer block
        self.in_channels = in_channels
        self.ctrl_channels = int(ctrl_channels)
        self.use_label = use_label
        self.adm_in_channels = adm_in_channels
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
                return ResBlock(spec.in_ch, spec.out_ch, time_dim, use_scale_shift_norm)
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
        if use_label is not None:
            if adm_in_channels is None:
                raise ValueError("use_label needs adm_in_channels")
            self.label_emb = nn.Sequential(nn.Sequential(
                Dense(adm_in_channels, time_dim), nn.SiLU(), Dense(time_dim, time_dim)))
        if self.ctrl_channels > 0:
            layers: List[nn.Module] = []
            ch = self.ctrl_channels
            for w in CTRL_WIDTHS:
                layers += [Conv3x3(ch, w), nn.SiLU()]
                ch = w
            self.ctrl_block = nn.Sequential(*layers, zero_init(Conv3x3(ch, model_channels)))
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
        # the tensor group's `parallel.sharding.TensorParallel` once
        # `sharding.shard_model_` has sharded the transformer blocks
        self.tp = None

    def _blocks(self):
        """(path prefix, modules, specs) of every block in execution order."""
        for i, (mods, specs) in enumerate(zip(self.input_blocks, self.plan.input_blocks)):
            yield f"input_blocks.{i}", mods, specs
        yield "middle_block", self.middle_block, self.plan.middle_block
        for i, (mods, specs) in enumerate(zip(self.output_blocks, self.plan.output_blocks)):
            yield f"output_blocks.{i}", mods, specs

    def map_key(self, prefix: str, j: int, d: int) -> str:
        """The key of the t_attn map of block d of the transformer at
        `prefix`.j."""
        return (f"{prefix}.{j}.t_attn" if self.transformer_depth == 1
                else f"{prefix}.{j}.blocks_{d}.t_attn")

    def map_layers(self):
        """(map key, module path, heads) of every t_attn layer."""
        for prefix, mods, specs in self._blocks():
            for j, (m, s) in enumerate(zip(mods, specs)):
                if s.kind == "attn":
                    for d, blk in enumerate(m.transformer_blocks):
                        if blk.has_t:
                            yield (self.map_key(prefix, j, d),
                                   f"{prefix}.{j}.transformer_blocks.{d}.t_attn", s.heads)

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
                        attn_maps[self.map_key(prefix, j, d)] = amap
            else:
                h = m(h)
        return h

    def _prepare(self, timesteps, t_context, v_context, y):
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels).to(self.dtype))
        if self.use_label is not None:
            if y is None:
                raise ValueError("this UNet has a label embedding (use_label): pass y")
            emb = emb + self.label_emb(y.to(self.dtype))
        if t_context is not None:
            t_context = t_context.to(self.dtype)
        if v_context is not None:
            v_context = v_context.to(self.dtype)
        return emb, t_context, v_context

    def _run_encoder(self, x, emb, t_context, v_context, capture_attn, attn_maps,
                     ctx_kv) -> List[torch.Tensor]:
        """Input blocks → the skip activations hs; hs[-1] feeds the middle
        block."""
        h = x.to(self.dtype)
        if self.ctrl_channels > 0:
            h, ctrl = (h[..., :self.in_channels],
                       h[..., self.in_channels:self.in_channels + self.ctrl_channels])
        hs = []
        for i, (prefix, mods, specs) in enumerate(list(self._blocks())[:len(self.input_blocks)]):
            h = self._apply_block(prefix, mods, specs, h, emb, t_context, v_context,
                                  capture_attn, attn_maps, ctx_kv)
            if i == 0 and self.ctrl_channels > 0:
                h = h + self.ctrl_block(ctrl)
            hs.append(h)
        return hs

    def _run_decoder(self, hs, emb, t_context, v_context, capture_attn, attn_maps,
                     ctx_kv) -> torch.Tensor:
        """Middle and output blocks on the skip stack hs (left as it is)."""
        hs = list(hs)
        h = hs[-1]
        blocks = list(self._blocks())[len(self.input_blocks):]
        prefix, mods, specs = blocks[0]
        h = self._apply_block(prefix, mods, specs, h, emb, t_context, v_context,
                              capture_attn, attn_maps, ctx_kv)
        for prefix, mods, specs in blocks[1:]:
            h = torch.cat([h, hs.pop()], dim=-1)
            h = self._apply_block(prefix, mods, specs, h, emb, t_context, v_context,
                                  capture_attn, attn_maps, ctx_kv)
        h = self.out[2](self.out[0](h, silu=True))
        return h.float()

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        t_context: Optional[torch.Tensor] = None,
        v_context: Optional[torch.Tensor] = None,
        y: Optional[torch.Tensor] = None,
        capture_attn: bool = False,
        ctx_kv: Optional[Dict[str, Any]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x (B, H, W, in_channels + ctrl_channels), timesteps (B,), y (B,
        adm_in_channels) with use_label → ((B, H, W, out), maps)."""
        emb, t_context, v_context = self._prepare(timesteps, t_context, v_context, y)
        attn_maps: Dict[str, torch.Tensor] = {}
        hs = self._run_encoder(x, emb, t_context, v_context, capture_attn, attn_maps, ctx_kv)
        h = self._run_decoder(hs, emb, t_context, v_context, capture_attn, attn_maps, ctx_kv)
        return h, attn_maps

    def refuse_ctrl(self) -> None:
        if self.ctrl_channels > 0:
            raise NotImplementedError("encoder propagation: the ctrl block is not supported")

    def forward_cached(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        t_context: Optional[torch.Tensor] = None,
        v_context: Optional[torch.Tensor] = None,
        y: Optional[torch.Tensor] = None,
        ctx_kv: Optional[Dict[str, Any]] = None,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """`forward` without map capture that also returns the encoder skip
        stack, for encoder-propagation sampling ("Faster Diffusion", arXiv
        2312.09608: encoder features vary little across adjacent noise
        levels). Pair with `decode_cached`. A UNet with the ctrl block
        refuses it, as the JAX build does."""
        self.refuse_ctrl()
        emb, t_context, v_context = self._prepare(timesteps, t_context, v_context, y)
        hs = self._run_encoder(x, emb, t_context, v_context, False, {}, ctx_kv)
        return self._run_decoder(hs, emb, t_context, v_context, False, {}, ctx_kv), tuple(hs)

    def decode_cached(
        self,
        hs: Tuple[torch.Tensor, ...],
        timesteps: torch.Tensor,
        t_context: Optional[torch.Tensor] = None,
        v_context: Optional[torch.Tensor] = None,
        y: Optional[torch.Tensor] = None,
        ctx_kv: Optional[Dict[str, Any]] = None,
    ) -> torch.Tensor:
        """The middle and output blocks only, on a `forward_cached` skip
        stack with the current timestep's embedding (the approximation of
        encoder propagation: the input blocks are skipped)."""
        self.refuse_ctrl()
        emb, t_context, v_context = self._prepare(timesteps, t_context, v_context, y)
        return self._run_decoder(hs, emb, t_context, v_context, False, {}, ctx_kv)
