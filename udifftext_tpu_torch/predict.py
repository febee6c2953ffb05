"""Predictor for the demo and test flows (port of `udifftext_tpu/predict.py`).

Holds the sampler settings, turns a batch's array fields into tensors on
the engine's device, and runs `DiffusionEngine.sample` (with
attend-and-excite and middle-step map capture when asked). The candidate-
batched init-noise search is chosen per call: batched only while
noise_iters·B stays within `noise_search_max_rows`, since the stacked
candidates' UNet batch (and its captured maps) grows with it.

The default of 160 rows is the card's, not the TPU build's 128 (sized for a
v5e's HBM). Peak device memory of the demo flow at full width, bf16, CFG
4.0, 10 candidates (`scripts/sizing_probe.py search`, NVIDIA H100 80GB HBM3,
700 W, 79.2 GiB): the batched search 5.20 / 19.31 / 35.43 GiB at 10 / 80 /
160 rows and out of memory at 320; the whole call (search, sampling steps,
fp32 VAE decode) peaks in the search, and with the sequential search at
4.44 / 13.24 / 23.31 / 43.44 GiB. 160 rows leave 44 GiB free; 320 do not fit.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# array fields DiffusionEngine.sample consumes; strings stay on the host
ARRAY_KEYS = ("image", "masked", "mask", "seg", "seg_mask", "label_ids", "r_bbox")


class Predictor:
    def __init__(
        self,
        engine,
        num_steps: int = 50,
        cfg_scale: float = 5.0,
        noise_iters: int = 10,
        aae_enabled: bool = False,
        detailed: bool = False,
        encprop_interval: int = 0,
        noise_search_batched: bool = False,
        noise_search_max_rows: int = 160,
    ):
        if encprop_interval > 1:
            raise NotImplementedError("encoder-propagation sampling is not ported yet")
        self.engine = engine
        self.num_steps = int(num_steps)
        self.cfg_scale = float(cfg_scale)
        self.noise_iters = int(noise_iters)
        self.aae_enabled = bool(aae_enabled)
        self.detailed = bool(detailed)
        self.noise_search_batched = bool(noise_search_batched)
        self.noise_search_max_rows = int(noise_search_max_rows)

    def array_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The float batch's array fields as tensors on the engine's device."""
        out = {}
        dev = self.engine.device
        for k in ARRAY_KEYS:
            v = batch.get(k)
            if v is None or (isinstance(v, np.ndarray) and v.dtype == object):
                continue
            t = torch.as_tensor(v)
            if k == "image" and t.dtype == torch.uint8:
                raise NotImplementedError(
                    "the uint8 wire format (serving) is not ported yet: send float "
                    "image/mask/masked arrays"
                )
            out[k] = t.to(dev)
        if not out:
            raise ValueError(f"batch carries none of the predictor's array keys "
                             f"{ARRAY_KEYS} — got {sorted(batch)}")
        return out

    def __call__(
        self,
        batch: Dict[str, Any],
        generator: Optional[torch.Generator] = None,
        posterior_eps: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        arr = self.array_batch(batch)
        b = next(iter(arr.values())).shape[0]
        batched = self.noise_search_batched and self.noise_iters * b <= self.noise_search_max_rows
        return self.engine.sample(
            arr, generator, num_steps=self.num_steps, cfg_scale=self.cfg_scale,
            noise_iters=self.noise_iters, aae_enabled=self.aae_enabled, detailed=self.detailed,
            noise_search_batched=batched, posterior_eps=posterior_eps, noise=noise,
        )
