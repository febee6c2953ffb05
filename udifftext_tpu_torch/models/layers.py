"""Shared NN primitives (port of `udifftext_tpu/models/layers.py`).

Activations are NHWC (B, H, W, C), as in the JAX build. Convolutions keep
PyTorch's OIHW weights and run on an NCHW view of the NHWC tensor (a
`permute`, no copy: the view is channels_last in memory), so a conv reads
and writes NHWC without transposing data.

Dense and conv layers compute in the dtype of their input; their weights
are cast to it at use (a no-op once `cast_weights` has stored them in the
compute dtype; for fp32 master weights the cast is in the autograd graph,
so their gradient arrives in fp32). Norm parameters stay fp32 and norms
compute in fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding, cos first, fp32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 centered two-pass statistics on NHWC input; the
    affine runs in fp32 and the output is in the input dtype."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        g = self.num_groups
        xf = x.reshape(x.shape[0], -1, g, c // g).float()
        mean = xf.mean(dim=(1, 3), keepdim=True)
        xc = xf - mean
        var = xc.square().mean(dim=(1, 3), keepdim=True)
        y = (xc * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class LayerNormF32(nn.LayerNorm):
    """LayerNorm computed in fp32, output in the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps
        ).to(x.dtype)


class Dense(nn.Linear):
    """Linear layer computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class _ConvNHWC(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class Conv3x3(_ConvNHWC):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, padding: int = 1):
        super().__init__(in_ch, out_ch, 3, stride=stride, padding=padding)


class Conv1x1(_ConvNHWC):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 1)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsample of NHWC x."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def name_has_key(name: str, keys) -> bool:
    """Whether a dotted parameter/module name has a segment containing one of
    `keys` (the JAX build's per-path-segment `opt_keys` match)."""
    return any(k in seg for seg in name.split(".") for k in keys)


def cast_weights(module: nn.Module, dtype: torch.dtype, keep_fp32=()) -> nn.Module:
    """Store every Linear/Conv2d weight and bias of `module` in `dtype` (the
    compute dtype), leaving norm parameters, and modules whose name matches
    one of `keep_fp32` (trainable master weights), in fp32."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)) and not name_has_key(name, keep_fp32):
            m.to(dtype)
    return module
