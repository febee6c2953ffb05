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

The uint8 wire format (serving, `serving.InpaintService`): a batch whose
`image` is uint8 carries raw `image` (B, H, W, 3) and `mask` (B, H, W[, 1])
and no `masked`. They go to the device as uint8 and are preprocessed there
with the float path's math (image / 127.5 − 1, mask > 0, masked = image ·
(1 − mask)); the images come back as uint8, clip(images, 0, 1) · 255
truncated. Float batches (the demo and eval flows) are untouched.

`encprop_interval` > 1 opts into APPROXIMATE encoder-propagation sampling.
It is gated once, at construction (`utils.encprop_gate.gate_encprop` with
`ckpt_id`, `min_quality_psnr` and the predictor's steps and scale): refused
for a checkpoint with no passing quality report, warned once when the
checkpoint's identity is unknown (`ckpt_id` None).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .utils.encprop_gate import DEFAULT_MIN_PSNR, gate_encprop

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
        ckpt_id: Optional[str] = None,
        min_quality_psnr: Optional[float] = None,
        noise_search_batched: bool = False,
        noise_search_max_rows: int = 160,
    ):
        self.engine = engine
        self.num_steps = int(num_steps)
        self.cfg_scale = float(cfg_scale)
        self.encprop_interval = int(encprop_interval)
        if self.encprop_interval > 1:
            gate_encprop(ckpt_id, self.encprop_interval,
                         DEFAULT_MIN_PSNR if min_quality_psnr is None else float(min_quality_psnr),
                         settings={"steps": self.num_steps, "scale": self.cfg_scale})
        self.noise_iters = int(noise_iters)
        self.aae_enabled = bool(aae_enabled)
        self.detailed = bool(detailed)
        self.noise_search_batched = bool(noise_search_batched)
        self.noise_search_max_rows = int(noise_search_max_rows)
        # a GeneralConditioner's embedders may read more keys (e.g. a
        # ClassEmbedder's class ids)
        gc = getattr(engine, "general_conditioner", None)
        self.array_keys = tuple(dict.fromkeys(ARRAY_KEYS + (gc.input_keys if gc is not None else ())))

    def array_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's array fields as tensors on the engine's device (uint8
        ones still uint8)."""
        out = {}
        dev = self.engine.device
        for k in self.array_keys:
            v = batch.get(k)
            if v is None or (isinstance(v, np.ndarray) and v.dtype == object):
                continue
            out[k] = torch.as_tensor(v).to(dev)
        if not out:
            raise ValueError(f"batch carries none of the predictor's array keys "
                             f"{self.array_keys} — got {sorted(batch)}")
        if "image" in out and out["image"].dtype == torch.uint8:
            if "mask" not in out:
                raise ValueError(
                    "uint8 wire format: a uint8 'image' requires a 'mask' — "
                    "normalization and `masked` synthesis run on-device from "
                    "(image, mask); send float arrays for the preprocessed "
                    "path"
                )
            if "masked" in out:
                raise ValueError(
                    "uint8 wire format synthesizes 'masked' on-device from "
                    "image*(1-mask); drop the 'masked' key (or send float "
                    "image/mask/masked for the preprocessed path)"
                )
        return out

    @staticmethod
    def preprocess_uint8(arr: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The float batch of a uint8 one, on its device: image / 127.5 − 1,
        mask > 0 (with a channel axis added where it has none), masked =
        image · (1 − mask)."""
        arr = dict(arr)
        img = arr["image"].float() / 127.5 - 1.0
        mask = (arr["mask"] > 0).float()
        if mask.ndim == img.ndim - 1:
            mask = mask[..., None]
        arr.update(image=img, mask=mask, masked=img * (1.0 - mask))
        return arr

    @torch.no_grad()
    def __call__(
        self,
        batch: Dict[str, Any],
        generator: Optional[torch.Generator] = None,
        posterior_eps: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(images (B, H, W, 3), aux) of `engine.sample`: images in [0, 1],
        or uint8 for a uint8 batch."""
        arr = self.array_batch(batch)
        uint8_in = "image" in arr and arr["image"].dtype == torch.uint8
        if uint8_in:
            arr = self.preprocess_uint8(arr)
        b = next(iter(arr.values())).shape[0]
        batched = self.noise_search_batched and self.noise_iters * b <= self.noise_search_max_rows
        images, aux = self.engine.sample(
            arr, generator, num_steps=self.num_steps, cfg_scale=self.cfg_scale,
            noise_iters=self.noise_iters, aae_enabled=self.aae_enabled, detailed=self.detailed,
            noise_search_batched=batched, posterior_eps=posterior_eps, noise=noise,
            encprop_interval=self.encprop_interval,
        )
        if uint8_in:
            images = (images.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        return images, aux
