"""Attention heatmaps, segment maps and intermediate GIFs of the eval and
demo flows (port of `udifftext_tpu/utils/viz.py`).

`average_attn_maps` and `save_segment_map` are numpy only.
`save_attn_map_grid` (matplotlib, seaborn) and `save_intermediates_gif`
(imageio) import their packages when called, so the module imports where
they are not installed.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def average_attn_maps(attn_maps: Dict[str, np.ndarray], layers: Optional[Sequence[str]] = None,
                      attn_type: str = "t_attn") -> np.ndarray:
    """(B, heads, N, L) maps of the layers named `*<attn_type>` (those under
    `layers` when given) averaged over layers and heads → (B, L, h, w). With
    no layer filter and several resolutions, the finest group is kept; h is
    the largest divisor of N not above √N (square for square latents)."""
    picked = []
    for name, m in sorted(attn_maps.items()):
        if not name.endswith(attn_type):
            continue
        if layers and not any(name.startswith(layer) for layer in layers):
            continue
        picked.append(np.asarray(m, np.float32))
    if not picked:
        raise ValueError("no attention maps matched")
    if len({p.shape for p in picked}) > 1:
        best = max(p.shape[2] for p in picked)
        picked = [p for p in picked if p.shape[2] == best]
    avg = np.stack(picked, axis=0).mean(axis=(0, 2))  # (B, N, L)
    b, n, l = avg.shape
    h = int(np.sqrt(n))
    while n % h:
        h -= 1
    return avg.transpose(0, 2, 1).reshape(b, l, h, n // h)


def save_attn_map_grid(maps_blhw: np.ndarray, tokens: str = "",
                       save_path: str = "temp/attn_map/attn_map.png", max_tokens: int = 12) -> str:
    """The last sample's per-token heatmaps in a 3×4 grid (matplotlib and
    seaborn)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns

    attn = maps_blhw[-1]
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig = plt.figure(figsize=(12, 8), dpi=150)
    for j in range(min(max_tokens, attn.shape[0])):
        ax = fig.add_subplot(3, 4, j + 1)
        sns.heatmap(attn[j], square=True, xticklabels=False, yticklabels=False, ax=ax)
        if j < len(tokens):
            ax.set_title(tokens[j])
    fig.savefig(save_path)
    plt.close(fig)
    return save_path


def save_segment_map(maps_blhw: np.ndarray, tokens: str,
                     save_path: str = "temp/seg_map/seg.npy") -> str:
    """The last sample's maps of the first len(tokens) tokens (all of them
    for no tokens) as .npy."""
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    section = np.stack([maps_blhw[-1][i] for i in range(len(tokens))]) if tokens else maps_blhw[-1]
    np.save(save_path, section)
    return save_path


def save_intermediates_gif(frames: List[np.ndarray], save_path: str = "temp/inters/sample.gif",
                           duration: float = 0.02) -> str:
    """A GIF of (H, W, 3) frames, float in [0, 1] or uint8 (imageio)."""
    import imageio

    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    frames8 = [f if f.dtype == np.uint8 else (np.clip(f, 0, 1) * 255).astype(np.uint8)
               for f in frames]
    imageio.mimsave(save_path, frames8, "GIF", duration=duration)
    return save_path
