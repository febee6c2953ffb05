"""Plain PyTorch reference of the UDiffText networks: the SD-2 inpainting UNet
with its t_attn text cross-attention, the KL autoencoder and the character
LabelEncoder.

Written from the published architecture (sgm's openaimodel.py, attention.py,
autoencoder model.py, UDiffText's LabelEncoder), with the checkpoint's
parameter names, so one state dict loads here and into the program. It
imports nothing of the program. Activations are NCHW, as in the original.

Every product (linear, convolution, and attention's q·kᵀ and p·v) reads
its operands through `Precision.cast`, which is the identity for the
reference and rounds for a control (`Float8`, `BFloat16`). Parameters are
held in float32; the caller decides what values they hold.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn


class Precision:
    """The arithmetic of the products: the reference computes in float32."""

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        return t


class Float8(Precision):
    """The control: each product's operands rounded to float8 e4m3 with one
    scale a tensor (its largest magnitude at 448), then multiplied in
    float32: a bf16 UNet taken one precision step down. Gradients pass the
    rounding unchanged (in float32: e4m3 would flush them to zero)."""

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        x = t.detach()
        scale = 448.0 / x.abs().amax().clamp(min=1e-30)
        return t + ((x * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale - x)


class BFloat16(Precision):
    """A control: each product's operands rounded to bfloat16, then
    multiplied in float32: float32 arithmetic (TF32 allowed) taken one step
    down. Gradients pass the rounding unchanged."""

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        x = t.detach()
        return t + (x.to(torch.bfloat16).to(t.dtype) - x)


FP32 = Precision()


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = True, prec: Precision = FP32):
        super().__init__()
        self.prec = prec
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.prec.cast(x), self.prec.cast(self.weight), self.bias)


class Conv(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1, padding: int = 0,
                 prec: Precision = FP32):
        super().__init__()
        self.prec, self.stride, self.padding = prec, stride, padding
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.empty(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(self.prec.cast(x), self.prec.cast(self.weight), self.bias,
                        self.stride, self.padding)


class GroupNorm(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5, groups: int = 32):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.groups, self.weight, self.bias, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


NORMS = (GroupNorm, LayerNorm)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              maps: bool = False, prec: Precision = FP32):
    """softmax(q kᵀ / √d) v over (B, N, heads·d) inputs; with `maps`, also the
    probabilities (B, heads, N, L)."""
    b, n, inner = q.shape
    d = inner // heads
    q, k, v = (prec.cast(t).reshape(b, -1, heads, d).transpose(1, 2) for t in (q, k, v))
    p = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5, dim=-1)
    out = (prec.cast(p) @ v).transpose(1, 2).reshape(b, n, inner)
    return (out, p) if maps else out


# -- UNet -------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, emb: int, prec: Precision):
        super().__init__()
        self.in_layers = nn.ModuleList([GroupNorm(c_in), nn.SiLU(), Conv(c_in, c_out, 3, 1, 1, prec)])
        self.emb_layers = nn.ModuleList([nn.SiLU(), Linear(emb, c_out, prec=prec)])
        self.out_layers = nn.ModuleList([GroupNorm(c_out), nn.SiLU(), nn.Identity(),
                                         Conv(c_out, c_out, 3, 1, 1, prec)])
        self.skip_connection = Conv(c_in, c_out, 1, prec=prec) if c_in != c_out else None

    def forward(self, x, emb):
        h = self.in_layers[2](F.silu(self.in_layers[0](x)))
        h = h + self.emb_layers[1](F.silu(emb))[:, :, None, None]
        h = self.out_layers[3](F.silu(self.out_layers[0](h)))
        return (x if self.skip_connection is None else self.skip_connection(x)) + h


class SelfAttn(nn.Module):
    def __init__(self, dim: int, heads: int, context: Optional[int], prec: Precision):
        super().__init__()
        self.heads, self.prec = heads, prec
        self.to_q = Linear(dim, dim, bias=False, prec=prec)
        self.to_k = Linear(context or dim, dim, bias=False, prec=prec)
        self.to_v = Linear(context or dim, dim, bias=False, prec=prec)
        self.to_out = nn.ModuleList([Linear(dim, dim, prec=prec)])

    def forward(self, x, context=None, maps=False):
        ctx = x if context is None else context
        out = attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads, maps, self.prec)
        if maps:
            return self.to_out[0](out[0]), out[1]
        return self.to_out[0](out)


class Proj(nn.Module):
    def __init__(self, dim: int, out: int, prec: Precision):
        super().__init__()
        self.proj = Linear(dim, out, prec=prec)


class FeedForward(nn.Module):
    def __init__(self, dim: int, prec: Precision):
        super().__init__()
        self.net = nn.ModuleList([Proj(dim, 8 * dim, prec), nn.Identity(),
                                  Linear(4 * dim, dim, prec=prec)])

    def forward(self, x):
        h, g = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](h * F.gelu(g))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, t_context: int, prec: Precision):
        super().__init__()
        self.attn1 = SelfAttn(dim, heads, None, prec)
        self.norm1 = LayerNorm(dim)
        self.t_attn = SelfAttn(dim, heads, t_context, prec)
        self.t_norm = LayerNorm(dim)
        self.ff = FeedForward(dim, prec)
        self.norm3 = LayerNorm(dim)

    def forward(self, x, context, maps: Dict[str, torch.Tensor], key: str):
        x = self.attn1(self.norm1(x)) + x
        h, maps[key] = self.t_attn(self.t_norm(x), context, maps=True)
        x = h + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    def __init__(self, ch: int, heads: int, t_context: int, prec: Precision):
        super().__init__()
        self.norm = GroupNorm(ch, eps=1e-6)
        self.proj_in = Linear(ch, ch, prec=prec)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(ch, heads, t_context, prec)])
        self.proj_out = Linear(ch, ch, prec=prec)

    def forward(self, x, context, maps, key):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        y = self.transformer_blocks[0](y, context, maps, key)
        return self.proj_out(y).transpose(1, 2).reshape(b, c, h, w) + x


class Downsample(nn.Module):
    def __init__(self, ch: int, prec: Precision):
        super().__init__()
        self.op = Conv(ch, ch, 3, 2, 1, prec)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int, prec: Precision):
        super().__init__()
        self.conv = Conv(ch, ch, 3, 1, 1, prec)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNet(nn.Module):
    """openaimodel's UNet at `net` (network_config.params), transformer depth 1,
    a text context and no other; `forward` returns (eps, t_attn maps by
    layer)."""

    def __init__(self, net: dict, prec: Precision = FP32):
        super().__init__()
        mc, mult = net["model_channels"], list(net["channel_mult"])
        head_ch, attn_res = net["num_head_channels"], set(net["attention_resolutions"])
        ctx, nrb = net["t_context_dim"], net["num_res_blocks"]
        if net.get("transformer_depth", 1) != 1 or net.get("ctrl_channels", 0):
            raise ValueError("the reference covers transformer_depth 1 without a ctrl block")
        emb = 4 * mc
        self.mc = mc
        self.time_embed = nn.ModuleList([Linear(mc, emb, prec=prec), nn.SiLU(),
                                         Linear(emb, emb, prec=prec)])
        blocks: List[nn.ModuleList] = [nn.ModuleList([Conv(net["in_channels"], mc, 3, 1, 1, prec)])]
        chans, ch, ds = [mc], mc, 1
        for level, m in enumerate(mult):
            for _ in range(nrb):
                layers = [ResBlock(ch, m * mc, emb, prec)]
                ch = m * mc
                if ds in attn_res:
                    layers.append(SpatialTransformer(ch, ch // head_ch, ctx, prec))
                blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(mult) - 1:
                blocks.append(nn.ModuleList([Downsample(ch, prec)]))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = nn.ModuleList([ResBlock(ch, ch, emb, prec),
                                           SpatialTransformer(ch, ch // head_ch, ctx, prec),
                                           ResBlock(ch, ch, emb, prec)])
        out_blocks = []
        for level, m in list(enumerate(mult))[::-1]:
            for i in range(nrb + 1):
                layers = [ResBlock(ch + chans.pop(), m * mc, emb, prec)]
                ch = m * mc
                if ds in attn_res:
                    layers.append(SpatialTransformer(ch, ch // head_ch, ctx, prec))
                if level and i == nrb:
                    layers.append(Upsample(ch, prec))
                    ds //= 2
                out_blocks.append(nn.ModuleList(layers))
        self.output_blocks = nn.ModuleList(out_blocks)
        self.out = nn.ModuleList([GroupNorm(mc), nn.SiLU(),
                                  Conv(mc, net["out_channels"], 3, 1, 1, prec)])

    @staticmethod
    def _run(mods, prefix, h, emb, context, maps):
        for j, m in enumerate(mods):
            if isinstance(m, ResBlock):
                h = m(h, emb)
            elif isinstance(m, SpatialTransformer):
                h = m(h, context, maps, f"{prefix}.{j}.t_attn")
            else:
                h = m(h)
        return h

    def forward(self, x, timesteps, context):
        emb = self.time_embed[2](F.silu(self.time_embed[0](timestep_embedding(timesteps, self.mc))))
        maps: Dict[str, torch.Tensor] = {}
        hs, h = [], x
        for i, mods in enumerate(self.input_blocks):
            h = self._run(mods, f"input_blocks.{i}", h, emb, context, maps)
            hs.append(h)
        h = self._run(self.middle_block, "middle_block", h, emb, context, maps)
        for i, mods in enumerate(self.output_blocks):
            h = self._run(mods, f"output_blocks.{i}", torch.cat([h, hs.pop()], dim=1), emb,
                          context, maps)
        return self.out[2](F.silu(self.out[0](h))), maps


# -- autoencoder --------------------------------------------------------------

class VaeResBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, prec: Precision):
        super().__init__()
        self.norm1 = GroupNorm(c_in, 1e-6)
        self.conv1 = Conv(c_in, c_out, 3, 1, 1, prec)
        self.norm2 = GroupNorm(c_out, 1e-6)
        self.conv2 = Conv(c_out, c_out, 3, 1, 1, prec)
        self.nin_shortcut = Conv(c_in, c_out, 1, prec=prec) if c_in != c_out else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class VaeAttn(nn.Module):
    def __init__(self, ch: int, prec: Precision):
        super().__init__()
        self.prec = prec
        self.norm = GroupNorm(ch, 1e-6)
        self.q, self.k, self.v, self.proj_out = (Conv(ch, ch, 1, prec=prec) for _ in range(4))

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q, k, v = (m(h).flatten(2).transpose(1, 2) for m in (self.q, self.k, self.v))
        out = attention(q, k, v, 1, prec=self.prec).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(out)


class Mid(nn.Module):
    def __init__(self, ch: int, prec: Precision):
        super().__init__()
        self.block_1, self.attn_1, self.block_2 = (VaeResBlock(ch, ch, prec), VaeAttn(ch, prec),
                                                   VaeResBlock(ch, ch, prec))

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class Resample(nn.Module):
    def __init__(self, ch: int, down: bool, prec: Precision):
        super().__init__()
        self.down = down
        self.conv = Conv(ch, ch, 3, 2 if down else 1, 0 if down else 1, prec)

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Level(nn.Module):
    def __init__(self, blocks, name: Optional[str], resample: Optional[nn.Module]):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.resample_name = name
        if name:
            setattr(self, name, resample)

    def forward(self, h):
        for blk in self.block:
            h = blk(h)
        return getattr(self, self.resample_name)(h) if self.resample_name else h


class Autoencoder(nn.Module):
    """The KL autoencoder at `dd` (ddconfig) without attention levels."""

    def __init__(self, dd: dict, embed_dim: int, prec: Precision = FP32):
        super().__init__()
        if dd.get("attn_resolutions"):
            raise ValueError("the reference covers an autoencoder without attention levels")
        ch, mult, nrb, z = dd["ch"], list(dd["ch_mult"]), dd["num_res_blocks"], dd["z_channels"]
        self.encoder = nn.Module()
        enc = self.encoder
        enc.conv_in = Conv(dd["in_channels"], ch, 3, 1, 1, prec)
        levels, c = [], ch
        for i, m in enumerate(mult):
            blocks = []
            for _ in range(nrb):
                blocks.append(VaeResBlock(c, ch * m, prec))
                c = ch * m
            last = i == len(mult) - 1
            levels.append(Level(blocks, None if last else "downsample",
                                None if last else Resample(c, True, prec)))
        enc.down = nn.ModuleList(levels)
        enc.mid = Mid(c, prec)
        enc.norm_out = GroupNorm(c, 1e-6)
        enc.conv_out = Conv(c, 2 * z, 3, 1, 1, prec)
        self.decoder = nn.Module()
        dec = self.decoder
        c = ch * mult[-1]
        dec.conv_in = Conv(z, c, 3, 1, 1, prec)
        dec.mid = Mid(c, prec)
        ups: List[Optional[Level]] = [None] * len(mult)
        for i in reversed(range(len(mult))):
            blocks = []
            for _ in range(nrb + 1):
                blocks.append(VaeResBlock(c, ch * mult[i], prec))
                c = ch * mult[i]
            ups[i] = Level(blocks, "upsample" if i else None, Resample(c, False, prec) if i else None)
        dec.up = nn.ModuleList(ups)
        dec.norm_out = GroupNorm(c, 1e-6)
        dec.conv_out = Conv(c, dd["out_ch"], 3, 1, 1, prec)
        self.quant_conv = Conv(2 * z, 2 * embed_dim, 1, prec=prec)
        self.post_quant_conv = Conv(embed_dim, z, 1, prec=prec)

    def encode(self, x: torch.Tensor):
        """(mean, std) of the posterior of images x (B, 3, H, W) in [-1, 1]."""
        enc = self.encoder
        h = enc.conv_in(x)
        for level in enc.down:
            h = level(h)
        h = enc.conv_out(F.silu(enc.norm_out(enc.mid(h))))
        mean, logvar = self.quant_conv(h).chunk(2, dim=1)
        return mean, torch.exp(0.5 * logvar.clamp(-30.0, 20.0))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        dec = self.decoder
        h = dec.mid(dec.conv_in(self.post_quant_conv(z)))
        for level in reversed(dec.up):
            h = level(h)
        return dec.conv_out(F.silu(dec.norm_out(h)))


# -- LabelEncoder ---------------------------------------------------------------

class MHA(nn.Module):
    def __init__(self, d: int, heads: int, prec: Precision):
        super().__init__()
        self.heads, self.prec = heads, prec
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = Linear(d, d, prec=prec)

    def forward(self, x):
        q, k, v = F.linear(self.prec.cast(x), self.prec.cast(self.in_proj_weight),
                           self.in_proj_bias).chunk(3, dim=-1)
        return self.out_proj(attention(q, k, v, self.heads, prec=self.prec))


class EncoderLayer(nn.Module):
    """torch's post-norm TransformerEncoderLayer with ReLU, no dropout."""

    def __init__(self, d: int, heads: int, ff: int, prec: Precision):
        super().__init__()
        self.self_attn = MHA(d, heads, prec)
        self.linear1, self.linear2 = Linear(d, ff, prec=prec), Linear(ff, d, prec=prec)
        self.norm1, self.norm2 = LayerNorm(d), LayerNorm(d)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class LabelEncoder(nn.Module):
    def __init__(self, p: dict, num_classes: int, prec: Precision = FP32):
        super().__init__()
        d, n = p["emb_dim"], p["max_len"]
        self.label_embedding = nn.Embedding(num_classes, d)
        self.register_buffer("pe", torch.empty(n, d), persistent=False)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [EncoderLayer(d, p["n_heads"], p.get("dim_feedforward", 2048), prec)
             for _ in range(p["n_trans_layers"])])

    def reset_pe(self) -> None:
        """The sinusoidal position code: pe[:, 0::2] = sin, pe[:, 1::2] = cos."""
        n, d = self.pe.shape
        pos = torch.arange(n, dtype=torch.float64)[:, None]
        div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64) * (-math.log(10000.0) / d))
        pe = torch.zeros(n, d, dtype=torch.float64)
        pe[:, 0::2], pe[:, 1::2] = torch.sin(pos * div), torch.cos(pos * div)
        self.pe.copy_(pe.float())

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.label_embedding(ids.long()) + self.pe[None]
        for layer in self.encoder.layers:
            x = layer(x)
        return x


class Networks(nn.Module):
    """The three networks under the program's state-dict prefixes; `prec`
    is the UNet's arithmetic, `frozen_prec` that of the autoencoder and the
    LabelEncoder."""

    def __init__(self, graph: dict, num_classes: int, prec: Precision = FP32,
                 frozen_prec: Precision = FP32):
        super().__init__()
        net = graph["network_config"]["params"]
        vae = graph["first_stage_config"]["params"]
        le = next(e for e in graph["conditioner_config"]["params"]["emb_models"]
                  if e["target"].endswith("LabelEncoder"))["params"]
        self.unet = UNet(net, prec)
        self.vae = Autoencoder(vae["ddconfig"], vae["embed_dim"], frozen_prec)
        self.label_encoder = LabelEncoder(le, num_classes, frozen_prec)


def is_norm_param(model: nn.Module, name: str) -> bool:
    mod = model.get_submodule(name.rsplit(".", 1)[0])
    return isinstance(mod, NORMS)


def is_embedding(model: nn.Module, name: str) -> bool:
    return isinstance(model.get_submodule(name.rsplit(".", 1)[0]), nn.Embedding)
