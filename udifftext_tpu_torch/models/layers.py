"""Shared NN primitives (port of `udifftext_tpu/models/layers.py`).

Activations are NHWC (B, H, W, C), as in the JAX build. Convolutions keep
PyTorch's OIHW weights and run on an NCHW view of the NHWC tensor (a
`permute`, no copy: the view is channels_last in memory), so a conv reads
and writes NHWC without transposing data.

Dense and conv layers compute in the dtype of their input; their weights
are cast to it at use (a no-op once `cast_weights` has stored them in the
compute dtype; for fp32 master weights the cast is in the autograd graph,
so their gradient arrives in fp32). Norm parameters stay fp32 and norms
compute in fp32. Dense and conv layers start as the JAX build's do:
lecun-normal weights (`lecun_normal_`) and zero biases.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.groupnorm import kernel_takes, launch
from ..utils.profiling import count


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
    affine runs in fp32 and the output is in the input dtype. `silu=True`
    adds the SiLU that follows it in the models.

    Where autograd would not record the call and the kernel takes x
    (`ops.groupnorm.kernel_takes`: a CUDA tensor of its dtypes and shapes,
    contiguous and 16-byte aligned), the norm and the SiLU run as one launch
    of the kernel of `ops.groupnorm.fused_groupnorm_silu` (SiLU on the fp32
    value, one rounding); otherwise, and always with `impl="plain"`, on `plain`, the
    eager version, followed by `F.silu`. Each call adds one to the counter
    `groupnorm.kernel` or `groupnorm.plain` (`utils.profiling.RECORDER`)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 impl: str = "auto"):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.impl = impl  # "auto" | "plain"
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def plain(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        """The eager version (on every device, differentiable), then `F.silu`."""
        c = x.shape[-1]
        g = self.num_groups
        xf = x.reshape(x.shape[0], -1, g, c // g).float()
        mean = xf.mean(dim=(1, 3), keepdim=True)
        xc = xf - mean
        var = xc.square().mean(dim=(1, 3), keepdim=True)
        y = (xc * torch.rsqrt(var + self.eps)).reshape(x.shape)
        y = (y * self.weight.float() + self.bias.float()).to(x.dtype)
        return F.silu(y) if silu else y

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        if self.impl != "plain" and kernel_takes(x, self.weight, self.bias, self.num_groups):
            count("groupnorm.kernel")
            return launch(x, self.weight, self.bias, self.num_groups, self.eps, silu)
        count("groupnorm.plain")
        return self.plain(x, silu)


def set_norm_impl(module: nn.Module, attn_impl: str) -> nn.Module:
    """Every `GroupNorm32` of `module` on the plain path when `attn_impl` is
    "plain" (the implementation switch: no hand-written kernel anywhere),
    else on the kernel where it takes the call."""
    for m in module.modules():
        if isinstance(m, GroupNorm32):
            m.impl = "plain" if attn_impl == "plain" else "auto"
    return module


class LayerNormF32(nn.LayerNorm):
    """LayerNorm computed in fp32, output in the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps
        ).to(x.dtype)


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax's `lecun_normal` in place: a normal truncated at ±2 standard
    deviations, scaled so that the variance is 1 / fan_in (fan_in: every
    axis but the first, the output axis, of a Linear or OIHW conv weight)."""
    fan_in = math.prod(weight.shape[1:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # the truncation's std
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


class Dense(nn.Linear):
    """Linear layer computing in its input's dtype."""

    def reset_parameters(self) -> None:
        lecun_normal_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class _ConvNHWC(nn.Conv2d):
    def reset_parameters(self) -> None:
        lecun_normal_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

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


def zero_init(module: nn.Module) -> nn.Module:
    """Zero every parameter of `module` in place (the reference's
    `zero_module`, util.py:233-238): an output projection that starts at
    zero, so a branch no checkpoint sets adds nothing."""
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()
    return module


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsample of NHWC x."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel (a = −0.5) of |distance| x."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius: int):
    def kernel(x: torch.Tensor) -> torch.Tensor:
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        safe = torch.where(x != 0, math.pi ** 2 * x * x, torch.ones_like(x))
        out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)

    return kernel


RESIZE_KERNELS = {
    "linear": lambda x: torch.clamp(1.0 - x.abs(), min=0.0),
    "cubic": keys_cubic,
    "lanczos3": _lanczos(3),
    "lanczos5": _lanczos(5),
}
RESIZE_METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
                  "trilinear": "linear", "triangle": "linear", "cubic": "cubic",
                  "bicubic": "cubic", "tricubic": "cubic", "lanczos3": "lanczos3",
                  "lanczos5": "lanczos5"}


def resize_weights(in_size: int, out_size: int, method: str, antialias: bool,
                   device=None) -> torch.Tensor:
    """(in_size, out_size) fp32 weights of one axis of `image_resize`:
    output pixel o samples the input at (o + 0.5)·in/out − 0.5 under the
    method's kernel, widened by in/out when downsampling with `antialias`;
    each column is normalized to sum 1 (jax.image's `compute_weight_mat`
    with scale out/in and no translation)."""
    kernel = RESIZE_KERNELS[RESIZE_METHODS[method]]
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    in_pos = torch.arange(in_size, dtype=torch.float32, device=device)
    w = kernel(torch.abs(sample_f[None, :] - in_pos[:, None]) / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def image_resize(x: torch.Tensor, out_hw, method: str = "bilinear",
                 antialias: bool = True) -> torch.Tensor:
    """`jax.image.resize` of NHWC x to (B, out_h, out_w, C): "nearest" takes
    input pixel floor((o + 0.5)·in/out) (the half-pixel rule, torch's
    "nearest-exact"); "bilinear" / "bicubic" (Keys, a = −0.5) / "lanczos3" /
    "lanczos5" are separable weighted sums (`resize_weights`); an axis whose
    size does not change is left as it is."""
    if method not in RESIZE_METHODS:
        raise ValueError(f"unknown resize method {method!r}")
    kind = RESIZE_METHODS[method]
    for axis, n in ((1, int(out_hw[0])), (2, int(out_hw[1]))):
        m = x.shape[axis]
        if m == n:
            continue
        if kind == "nearest":
            pos = (np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(m) / np.float32(n)
            idx = torch.from_numpy(np.floor(pos.astype(np.float32)).astype(np.int64))
            x = x.index_select(axis, idx.to(x.device))
            continue
        w = resize_weights(m, n, method, antialias, x.device)
        x = torch.einsum("bhwc,ho->bowc" if axis == 1 else "bhwc,wo->bhoc", x.float(), w)
    return x


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
