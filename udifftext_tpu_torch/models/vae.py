"""KL autoencoder, the SD first stage (port of `udifftext_tpu/models/vae.py`).

Module and parameter names are the reference checkpoint's
(`encoder.down.1.block.0.norm1.weight`, `decoder.mid.attn_1.q.weight`,
`post_quant_conv.bias`, …). Images and latents are NHWC.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import sdpa
from ..ops.attention import IMPLS as ATTN_IMPLS
from ..utils import profiling
from .layers import Conv1x1, Conv3x3, GroupNorm32, upsample_nearest_2x


class DiagonalGaussian:
    """Posterior q(z|x) from (mean, logvar) stacked on the channel axis."""

    def __init__(self, parameters: torch.Tensor):
        self.mean, logvar = parameters.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, eps: torch.Tensor) -> torch.Tensor:
        """mean + std·eps, for standard-normal `eps` of the mean's shape."""
        return self.mean + self.std * eps

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL(q ‖ N(0, 1)) of each sample, (B,)."""
        return 0.5 * torch.sum(self.mean ** 2 + torch.exp(self.logvar) - 1.0 - self.logvar,
                               dim=(1, 2, 3))

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        """−log q(sample) of each sample, (B,)."""
        return 0.5 * torch.sum(math.log(2.0 * math.pi) + self.logvar
                               + (sample - self.mean) ** 2 / torch.exp(self.logvar),
                               dim=(1, 2, 3))


class VAEResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6)
        self.conv1 = Conv3x3(in_ch, out_ch)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.conv2 = Conv3x3(out_ch, out_ch)
        self.nin_shortcut = Conv1x1(in_ch, out_ch) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head self-attention over pixels; `attn_impl` is `sdpa`'s `impl`."""

    def __init__(self, ch: int, attn_impl: str = "auto"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        self.attn_impl = attn_impl
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.q, self.k, self.v = Conv1x1(ch, ch), Conv1x1(ch, ch), Conv1x1(ch, ch)
        self.proj_out = Conv1x1(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = self.norm(x)
        q, k, v = (m(h).reshape(b, hh * ww, 1, c) for m in (self.q, self.k, self.v))
        return x + self.proj_out(sdpa(q, k, v, impl=self.attn_impl).reshape(b, hh, ww, c))


class VAEDownsample(nn.Module):
    """Pad right/bottom by one, then a stride-2 3×3 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv3x3(ch, ch, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class VAEUpsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv3x3(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest_2x(x))


@dataclasses.dataclass(frozen=True)
class DDConfig:
    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    in_channels: int = 3
    resolution: int = 256
    z_channels: int = 4
    double_z: bool = True


class _Mid(nn.Module):
    def __init__(self, ch: int, attn_impl: str = "auto"):
        super().__init__()
        self.block_1 = VAEResnetBlock(ch, ch)
        self.attn_1 = VAEAttnBlock(ch, attn_impl)
        self.block_2 = VAEResnetBlock(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(x)))


class _Level(nn.Module):
    """One resolution level: `block` resnets, `attn` blocks, optional resample."""

    def __init__(self, blocks, attns, resample_name: Optional[str], resample: Optional[nn.Module]):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)
        self.resample_name = resample_name
        if resample_name is not None:
            setattr(self, resample_name, resample)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for j, blk in enumerate(self.block):
            h = blk(h)
            if len(self.attn):
                h = self.attn[j](h)
        if self.resample_name is not None:
            h = getattr(self, self.resample_name)(h)
        return h


class Encoder(nn.Module):
    def __init__(self, cfg: DDConfig, attn_impl: str = "auto"):
        super().__init__()
        self.conv_in = Conv3x3(cfg.in_channels, cfg.ch)
        levels = []
        res = cfg.resolution
        ch = cfg.ch
        n = len(cfg.ch_mult)
        for i, mult in enumerate(cfg.ch_mult):
            out = cfg.ch * mult
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks):
                blocks.append(VAEResnetBlock(ch, out))
                ch = out
                if res in cfg.attn_resolutions:
                    attns.append(VAEAttnBlock(ch, attn_impl))
            last = i == n - 1
            levels.append(_Level(blocks, attns, None if last else "downsample",
                                 None if last else VAEDownsample(ch)))
            if not last:
                res //= 2
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(ch, attn_impl)
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = Conv3x3(ch, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
        h = self.mid(h)
        return self.conv_out(self.norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: DDConfig, attn_impl: str = "auto"):
        super().__init__()
        n = len(cfg.ch_mult)
        ch = cfg.ch * cfg.ch_mult[-1]
        res = cfg.resolution // 2 ** (n - 1)
        self.conv_in = Conv3x3(cfg.z_channels, ch)
        self.mid = _Mid(ch, attn_impl)
        levels = [None] * n
        for i in reversed(range(n)):
            out = cfg.ch * cfg.ch_mult[i]
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(VAEResnetBlock(ch, out))
                ch = out
                if res in cfg.attn_resolutions:
                    attns.append(VAEAttnBlock(ch, attn_impl))
            levels[i] = _Level(blocks, attns, "upsample" if i else None,
                               VAEUpsample(ch) if i else None)
            if i:
                res *= 2
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = Conv3x3(ch, cfg.out_ch)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level(h)
        return self.conv_out(self.norm_out(h, silu=True))


class AutoencoderKL(nn.Module):
    """encode → DiagonalGaussian parameters; decode; quant convs included.
    Each encode and decode is a span (`vae.encode`, `vae.decode`,
    `utils.profiling`)."""

    def __init__(self, cfg: DDConfig = DDConfig(), embed_dim: int = 4,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.encoder = Encoder(cfg, attn_impl)
        self.decoder = Decoder(cfg, attn_impl)
        self.quant_conv = Conv1x1(2 * cfg.z_channels, 2 * embed_dim)
        self.post_quant_conv = Conv1x1(embed_dim, cfg.z_channels)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        with profiling.span("vae.encode"):
            return self.quant_conv(self.encoder(x.to(self.dtype)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        with profiling.span("vae.decode"):
            return self.decoder(self.post_quant_conv(z.to(self.dtype)))
