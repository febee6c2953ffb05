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

Data parallelism (`data_group`, one process per card): every process of the
group is called with the same global batch and the same generator state. Each
draws the whole batch's posterior noise (B, h, w, 4) and candidates (K, B, h,
w, 4), as one process would, keeps its own rows of them and of the batch
(rank r of n takes rows r·B/n .. (r+1)·B/n), and samples them with the
engine's group sums (`DiffusionEngine.sample(data_group=)`). The images, the
per-step local losses and the captured maps come back whole on every process
of the group: each fills its rows of a zeroed buffer and one all-reduce adds
them up (sample 0's decoded intermediates of attend-and-excite are broadcast
from the group's first process). The results do not depend on the group's size, injected draws
included. A batch that the group does not divide raises.

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
import torch.distributed as dist

from .parallel.dist import group_src
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
        data_group: Any = None,
    ):
        self.engine = engine
        self.data_group = data_group
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

    def shard_rows(self, b: int) -> slice:
        """This process's rows of a global batch of b (all of them without a
        data group); raises where the group does not divide b."""
        if self.data_group is None:
            return slice(0, b)
        n, r = dist.get_world_size(self.data_group), dist.get_rank(self.data_group)
        if b % n != 0:
            raise ValueError(
                f"eval batch size {b} must be divisible by the data-mesh axis ({n} devices) — "
                f"raise batch_size in the test config or disable eval_data_parallel")
        return slice(r * (b // n), (r + 1) * (b // n))

    @torch.no_grad()
    def __call__(
        self,
        batch: Dict[str, Any],
        generator: Optional[torch.Generator] = None,
        posterior_eps: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(images (B, H, W, 3), aux) of `engine.sample`: images in [0, 1],
        or uint8 for a uint8 batch. With a data group, `batch` is the global
        batch and every process gets the whole result (aux["inters"], sample
        0's, comes from the group's first process)."""
        arr = self.array_batch(batch)
        uint8_in = "image" in arr and arr["image"].dtype == torch.uint8
        if uint8_in:
            arr = self.preprocess_uint8(arr)
        b = next(iter(arr.values())).shape[0]
        rows = self.shard_rows(b)
        if self.data_group is not None:
            h, w = arr["masked"].shape[1:3]
            lf = self.engine.latent_factor
            posterior_eps, noise = self.engine.sample_draws(
                (b, h // lf, w // lf, 4), generator, self.noise_iters, posterior_eps, noise)
            dev = self.engine.device
            arr = {k: v[rows] for k, v in arr.items()}
            posterior_eps, noise = posterior_eps[rows].to(dev), noise[:, rows].to(dev)
            generator = None
        batched = self.noise_search_batched and self.noise_iters * b <= self.noise_search_max_rows
        images, aux = self.engine.sample(
            arr, generator, num_steps=self.num_steps, cfg_scale=self.cfg_scale,
            noise_iters=self.noise_iters, aae_enabled=self.aae_enabled, detailed=self.detailed,
            noise_search_batched=batched, posterior_eps=posterior_eps, noise=noise,
            encprop_interval=self.encprop_interval, data_group=self.data_group,
        )
        if uint8_in:
            images = (images.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        if self.data_group is not None:
            images = self._gather(images, 0, b, rows)
            for k in list(aux):
                if k == "local_losses":
                    aux[k] = self._gather(aux[k], 1, b, rows)
                elif k.endswith("t_attn"):
                    aux[k] = self._gather(aux[k], 0, b, rows)
            if "inters" in aux:
                dist.broadcast(aux["inters"], src=group_src(self.data_group),
                               group=self.data_group)
        return images, aux

    def _gather(self, t: torch.Tensor, axis: int, b: int, rows: slice) -> torch.Tensor:
        """The group's shards of `t` along `axis` (this process's rows at
        `rows` of b) put together on every process: each fills its rows of a
        zeroed buffer and one all-reduce sums them (uint8 and fp32 sum in
        NCCL and gloo alike; x + 0 is exact)."""
        shape = list(t.shape)
        shape[axis] = b
        out = torch.zeros(shape, dtype=t.dtype, device=t.device)
        out.narrow(axis, rows.start, rows.stop - rows.start).copy_(t)
        dist.all_reduce(out, group=self.data_group)
        return out
