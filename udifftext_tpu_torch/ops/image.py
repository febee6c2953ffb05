"""Bilinear grid sampling of NHWC images (port of `udifftext_tpu/ops/image.py`),
for the TPS spatial transformer of TRBA. The JAX function is plain `jnp`
(gathers and weights); here it is `F.grid_sample`, which computes the same
function: with align_corners=True and border padding it clamps the sampling
point into the image, where the JAX build clamps the four gathered indices
and keeps the weights, and both give the edge pixel's value."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C); grid (B, Hg, Wg, 2) of (x, y) in [-1, 1]
    (align_corners=True, padding_mode='border') → (B, Hg, Wg, C)."""
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid.to(img.dtype), mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.permute(0, 2, 3, 1)
