"""The one generator of every traffic mix: requests and arrival times of a
served cell, micro-batches and draws of a fine-tuning cell, each made from
the run's seed and the mix's file of parameters (benchmark/traffic/<mix>.json).
A new mix of these kinds is a new file of parameters.

Kinds of mix:
- "closed_loop": `clients` callers, each sending its next request when its
  reply comes.
- "open_loop": arrival events at `rate_per_s` / `burst` a second, each
  bringing `burst` requests at once (default 1: Poisson arrivals). The gaps
  between events are the quantiles of the exponential distribution in one
  fixed random order, the same schedule for every seed (a tail is set by
  where the bursts fall, so a schedule drawn from each seed would change the
  work; the seed still draws the requests).
- "train_steps": optimizer steps of `accumulate` micro-batches of
  `micro_batch` rows; the first `checked_steps` steps' rows all differ, and
  later steps take those rows again in turn, with draws of their own.
Served requests come from a pool of `pool` distinct requests, drawn from the
seed: a uint8 image, a text box of seeded size and place, and a text of
`min_chars` to `max_chars` characters of the LabelEncoder's vocabulary
(`charset`, the configuration's reference's `CHARSET`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from .weights import sub_seed


@dataclasses.dataclass
class Request:
    image: np.ndarray  # (size, size, 3) uint8
    mask: np.ndarray  # (size, size) uint8, 255 inside the text box
    text: str


def requests(mix: dict, seed: int, size: int, charset: str) -> List[Request]:
    """The mix's pool of distinct requests."""
    rng = np.random.default_rng(sub_seed(seed, "requests"))
    out = []
    for _ in range(mix["pool"]):
        coarse = rng.integers(0, 256, (size // 32, size // 32, 3))
        image = np.repeat(np.repeat(coarse, 32, axis=0), 32, axis=1)
        image = np.clip(image + rng.integers(-24, 25, image.shape), 0, 255).astype(np.uint8)
        n = int(rng.integers(mix["min_chars"], mix["max_chars"] + 1))
        h = int(rng.integers(size // 8, size // 3))
        w = min(size, n * int(rng.integers(size // 32, size // 12)))
        y0, x0 = int(rng.integers(0, size - h + 1)), int(rng.integers(0, size - w + 1))
        mask = np.zeros((size, size), np.uint8)
        mask[y0:y0 + h, x0:x0 + w] = 255
        text = "".join(charset[i] for i in rng.integers(0, len(charset), n))
        out.append(Request(image, mask, text))
    return out


def arrival_gaps(mix: dict, seconds: float) -> np.ndarray:
    """Seconds between successive sends of an open loop, enough for
    `seconds`: between events, the exponential's quantiles at (k + ½)/n in a
    fixed order; within an event's burst, 0."""
    burst = int(mix.get("burst", 1))
    rate = float(mix["rate_per_s"]) / burst
    n = int(math.ceil(rate * seconds)) + 1
    q = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    events = np.random.default_rng(sub_seed(0, "arrivals")).permutation(q)
    gaps = np.zeros((n, burst))
    gaps[:, 0] = events
    return gaps.reshape(-1)


def train_rows(mix: dict, seed: int, step: int, index: int, size: int, seq_len: int,
               charset: str, device: torch.device) -> Dict[str, torch.Tensor]:
    """One fine-tuning micro-batch's rows, made on `device` from the seed:
    a smooth image in [-1, 1] (NHWC), a text box as mask (1 inside) and
    masked image, one segmentation channel per character (a column of the
    box), the character mask and label ids."""
    g = torch.Generator(device).manual_seed(sub_seed(seed, f"train:{step}:{index}:rows"))
    b = mix["micro_batch"]

    def ints(lo, hi):
        return torch.randint(lo, hi, (b,), generator=g, device=device)

    coarse = torch.randn(b, 3, size // 32, size // 32, generator=g, device=device)
    image = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear",
                                            align_corners=False)
    image = torch.tanh(image + 0.1 * torch.randn(image.shape, generator=g, device=device))
    image = image.permute(0, 2, 3, 1).contiguous()
    n = ints(mix["min_chars"], mix["max_chars"] + 1)
    h, cw = ints(size // 8, size // 3), ints(max(1, size // 64), max(2, size // 24))
    y0, x0 = ints(0, size // 2), ints(0, size // 2)
    ar = torch.arange(size, device=device)
    rows = (ar[None] >= y0[:, None]) & (ar[None] < (y0 + h)[:, None])  # (b, H)
    col = (ar[None] - x0[:, None]).div(cw[:, None], rounding_mode="floor")  # character index
    chars = torch.arange(seq_len, device=device)
    in_char = (col[:, :, None] == chars[None, None]) & (chars[None, None] < n[:, None, None])
    seg = (rows[:, :, None, None] & in_char[:, None]).float()  # (b, H, W, L)
    mask = seg.amax(dim=-1, keepdim=True)
    seg_mask = (chars[None] < n[:, None]).float()
    label_ids = torch.randint(1, len(charset) + 1, (b, seq_len), generator=g,
                              device=device) * seg_mask.long()
    return {"image": image, "masked": image * (1.0 - mask), "mask": mask, "seg": seg,
            "seg_mask": seg_mask, "label_ids": label_ids}


def loss_draws(mix: dict, seed: int, step: int, index: int, latent: int, ucg_rate: float,
               num_idx: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The loss's draws for one micro-batch, made on `device` from the seed:
    image_eps, masked_eps, noise (B, latent, latent, 4), the label keep mask
    (Bernoulli 1 − ucg_rate) and the sigma indices."""
    g = torch.Generator(device).manual_seed(sub_seed(seed, f"train:{step}:{index}:draws"))
    b = mix["micro_batch"]
    lat = (b, latent, latent, 4)
    return {
        "image_eps": torch.randn(lat, generator=g, device=device),
        "masked_eps": torch.randn(lat, generator=g, device=device),
        "ucg_keep": (torch.rand(b, generator=g, device=device) < 1.0 - ucg_rate).float(),
        "sigma_idx": torch.randint(0, num_idx, (b,), generator=g, device=device),
        "noise": torch.randn(lat, generator=g, device=device),
    }
