"""The min-local attention loss that scores init-noise candidates (port of
`udifftext_tpu/diffusion/loss.py:32-156`).

Layouts (NHWC): mask (B, H, W, 1); seg_mask (B, L); attention maps
{name: (B, heads, N, L')} with N = h·w.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def get_gaussian_kernel(kernel_size: int = 3, sigma: float = 1.0) -> np.ndarray:
    """2-D gaussian, normalized to sum 1."""
    coords = np.arange(kernel_size, dtype=np.float64)
    grid = np.stack(np.meshgrid(coords, coords, indexing="xy"), axis=-1)
    mean = (kernel_size - 1) / 2.0
    variance = sigma**2
    kernel = (1.0 / (2.0 * np.pi * variance)) * np.exp(
        -np.sum((grid - mean) ** 2, axis=-1) / (2 * variance)
    )
    return (kernel / kernel.sum()).astype(np.float32)


def gaussian_blur_depthwise(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 2-D blur with zero padding: x (B, S, S, C), one kernel."""
    k = kernel.shape[0]
    c = x.shape[-1]
    w = kernel.to(x.dtype)[None, None].expand(c, 1, k, k)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=k // 2, groups=c)
    return y.permute(0, 2, 3, 1)


def interpolate_nearest_torch(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """F.interpolate(mode='nearest') index rule, out[i] = in[floor(i·s)],
    computed in float64 as the JAX build does: x (B, H, W, C)."""
    h, w = x.shape[1:3]
    rows = torch.from_numpy((np.arange(size[0]) * (h / size[0])).astype(np.int64)).to(x.device)
    cols = torch.from_numpy((np.arange(size[1]) * (w / size[1])).astype(np.int64)).to(x.device)
    return x[:, rows][:, :, cols]


def _attn_hw(n: int, img_h: int, img_w: int) -> Tuple[int, int]:
    """Spatial shape of an N-token attention map for an image's aspect."""
    h = max(int(round(math.sqrt(n * img_h / img_w))), 1)
    while n % h:
        h -= 1
    return h, n // h


def min_local_loss(attn_maps: Dict[str, torch.Tensor], mask: torch.Tensor,
                   seg_mask: torch.Tensor, kernel: torch.Tensor,
                   min_attn_size: int = 16) -> torch.Tensor:
    """The weakest in-mask character activation, negated, averaged over
    the t_attn layers of side >= min_attn_size. Returns (B,)."""
    seg_l = seg_mask.shape[1]
    total = 0.0
    count = 0
    for name in sorted(attn_maps):
        if not name.endswith("t_attn"):
            continue
        amap = attn_maps[name].float()
        b, _, n, _ = amap.shape
        hw = _attn_hw(n, mask.shape[1], mask.shape[2])
        if min(hw) < min_attn_size:
            continue
        m = amap[..., :seg_l].mean(dim=1).reshape(b, hw[0], hw[1], seg_l)
        blurred = gaussian_blur_depthwise(m, kernel).reshape(b, -1, seg_l)
        mask_map = interpolate_nearest_torch(mask, hw).float().reshape(b, -1, 1)
        p = (mask_map * blurred).amax(dim=1) + (1.0 - seg_mask)
        total = total - p.amin(dim=-1)
        count += 1
    if count == 0:
        return torch.zeros(mask.shape[0], dtype=torch.float32, device=mask.device)
    return total / count


class LocalLossConfig:
    """The min-local loss settings of the model graph's `loss_fn_config`."""

    def __init__(self, kernel_size: int = 3, gaussian_sigma: float = 1.0,
                 min_attn_size: int = 16):
        self.kernel_size = kernel_size
        self.gaussian_sigma = gaussian_sigma
        self.min_attn_size = min_attn_size

    @property
    def kernel(self) -> np.ndarray:
        return get_gaussian_kernel(self.kernel_size, self.gaussian_sigma)
