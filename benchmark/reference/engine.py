"""Plain PyTorch reference of what a cell's timed path computes: UDiffText's
inpainting sample (conditioning, the init-noise search, the CFG Euler-EDM
loop, the decode) and its fine-tuning step (the diffusion and local
attention losses, their gradients in the t_attn/t_norm parameters, AdamW).

Written from the published method (sgm's DiscreteDenoiser with eps scaling,
LegacyDDPMDiscretization, EulerEDMSampler, VanillaCFG; UDiffText's
min-local and local losses), with every random draw passed in. It imports
nothing of the program and takes nothing the program made: the networks
get the seeded weights from `benchmark.weights`, and the inputs are the
benchmark's own. Tensors are NCHW inside, NHWC at the boundary. Products run
in float32 with TF32 off (`fp32_products`); work is done in blocks of rows
so that the reference fits beside nothing else on the card.
"""

from __future__ import annotations

import contextlib
import string
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .model import FP32, Networks, Precision

CHARSET = string.printable[:-6]  # 94 characters; id 0 pads
NUM_CLASSES = len(CHARSET) + 1
SEQ_MIN_SIDE = 16  # min_attn_size: t_attn maps of a smaller side are left out


def encode_text(text: str, max_len: int) -> np.ndarray:
    ids = np.zeros(max_len, np.int64)
    for i, ch in enumerate(text):
        ids[i] = CHARSET.find(ch) + 1
    return ids


@contextlib.contextmanager
def fp32_products():
    """Float32 products: TF32 off for matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def ddpm_sigmas(n: int, start: float = 0.00085, end: float = 0.012,
                steps: int = 1000) -> np.ndarray:
    """LegacyDDPMDiscretization: n descending float32 sigmas (no zero)."""
    betas = np.linspace(start ** 0.5, end ** 0.5, steps, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    if n < steps:
        acp = acp[np.linspace(steps - 1, 0, n, endpoint=False).astype(int)[::-1]]
    return np.sqrt((1 - acp) / acp).astype(np.float32)[::-1].copy()


def gaussian_kernel(size: int = 3, sigma: float = 1.0) -> np.ndarray:
    c = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(c[:, None] ** 2 + c[None, :] ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


class Reference:
    """The reference networks and method of one configuration on `device`."""

    def __init__(self, cfg: dict, device: torch.device, weights: Iterator[Tuple[str, torch.Tensor]],
                 prec: Precision = FP32, frozen_prec: Precision = FP32, block: int = 4):
        graph = cfg["graph"]
        with torch.device("meta"):
            self.nets = Networks(graph, NUM_CLASSES, prec, frozen_prec)
        self.nets.to_empty(device=device)
        self.nets.label_encoder.reset_pe()
        params = dict(self.nets.named_parameters())
        with torch.no_grad():
            for name, value in weights:
                params.pop(name).copy_(value.float())
        if params:
            raise ValueError(f"no weights for {sorted(params)[:3]}")
        self.nets.requires_grad_(False)
        self.device, self.block = device, block
        self.scale_factor = graph.get("scale_factor", 0.18215)
        loss = graph["loss_fn_config"]["params"]
        self.lambda_local = loss.get("lambda_local_loss", 0.01)
        self.min_side = loss.get("min_attn_size", SEQ_MIN_SIDE)
        self.kernel = torch.as_tensor(gaussian_kernel(loss.get("kernel_size", 3),
                                                      loss.get("gaussian_sigma", 1.0)), device=device)
        table = ddpm_sigmas(1000)[::-1].copy()  # ascending: index = DDPM timestep
        self.table = torch.as_tensor(table, device=device)
        embedders = graph["conditioner_config"]["params"]["emb_models"]
        self.mask_multiplier = next(e["params"]["multiplier"] for e in embedders
                                    if e["target"].endswith("SpatialRescaler"))

    # -- pieces ----------------------------------------------------------------

    def encode(self, images: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """Scaled posterior sample of NHWC images in [-1, 1], eps NHWC."""
        mean, std = self.nets.vae.encode(images.permute(0, 3, 1, 2))
        return self.scale_factor * (mean + std * eps.permute(0, 3, 1, 2))

    def decode_u8(self, z: torch.Tensor) -> torch.Tensor:
        img = self.nets.vae.decode(z / self.scale_factor)
        return (torch.clamp((img + 1.0) / 2.0, 0.0, 1.0) * 255.0).to(torch.uint8).permute(0, 2, 3, 1)

    def concat(self, mask: torch.Tensor, masked: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        m = mask.permute(0, 3, 1, 2)
        size = (int(m.shape[2] * self.mask_multiplier), int(m.shape[3] * self.mask_multiplier))
        small = F.interpolate(m, size=size, mode="bilinear", align_corners=False)
        return torch.cat([small, self.encode(masked, eps)], dim=1)

    def denoise(self, x: torch.Tensor, sigma: torch.Tensor, concat: torch.Tensor,
                context: torch.Tensor):
        """D(x; σ) with eps scaling, σ quantized to the table: (D, maps)."""
        idx = torch.argmin((sigma[:, None] - self.table[None]).abs(), dim=1)
        s = self.table[idx][:, None, None, None]
        out, maps = self.nets.unet(torch.cat([x / torch.sqrt(s ** 2 + 1.0), concat], dim=1),
                                   idx.float(), context)
        return x - s * out, maps

    def _maps(self, maps: Dict[str, torch.Tensor]):
        """(head-mean map of each qualifying layer, blurred, (B, h, w, L), side)."""
        for name in sorted(maps):
            p = maps[name]
            b, _, n, l = p.shape
            side = int(round(n ** 0.5))
            if side < self.min_side:
                continue
            m = p.mean(dim=1).transpose(1, 2).reshape(b * l, 1, side, side)
            m = F.conv2d(m, self.kernel[None, None], padding=self.kernel.shape[0] // 2)
            yield m.reshape(b, l, side * side).transpose(1, 2), side

    @staticmethod
    def _nearest(x: torch.Tensor, side: int) -> torch.Tensor:
        """NHWC x sampled at rows and columns floor(i·H/side): (B, side², C)."""
        step = x.shape[1] // side
        return x[:, ::step, ::step].reshape(x.shape[0], side * side, x.shape[-1]).float()

    def min_local_loss(self, maps, mask: torch.Tensor, seg_mask: torch.Tensor) -> torch.Tensor:
        total, count = 0.0, 0
        for blurred, side in self._maps(maps):
            p = (self._nearest(mask, side) * blurred).amax(dim=1) + (1.0 - seg_mask)
            total = total - p.amin(dim=-1)
            count += 1
        return total / count

    def local_loss(self, maps, seg: torch.Tensor, seg_mask: torch.Tensor) -> torch.Tensor:
        total, count = 0.0, 0
        denom = seg_mask.sum(dim=-1)
        for blurred, side in self._maps(maps):
            s = self._nearest(seg, side)
            pos = ((s * blurred).amax(dim=1) * seg_mask).sum(-1) / denom
            neg = (((1.0 - s) * blurred).amax(dim=1) * seg_mask).sum(-1) / denom
            total = total + (neg - pos)
            count += 1
        return total / count

    # -- sampling ----------------------------------------------------------------

    def conditions(self, batch: Dict[str, torch.Tensor], posterior_eps: torch.Tensor):
        """(context (B, L, D), concat (B, 5, h, w), mask (B, H, W, 1) in {0, 1})
        of a uint8 serving batch (image, mask, label_ids)."""
        image = batch["image"].float() / 127.5 - 1.0
        mask = (batch["mask"] > 0).float()
        context = self.nets.label_encoder(batch["label_ids"])
        return context, self.concat(mask, image * (1.0 - mask), posterior_eps), mask

    def cfg_denoise(self, x, sigma, context, concat, scale, maps=False):
        b = x.shape[0]
        d, m = self.denoise(torch.cat([x, x]), torch.cat([sigma, sigma]), torch.cat([concat, concat]),
                            torch.cat([torch.zeros_like(context), context]))
        out = d[:b] + scale * (d[b:] - d[:b])
        return (out, {k: v[b:] for k, v in m.items()}) if maps else out

    def _blocks(self, n: int) -> List[slice]:
        return [slice(i, min(i + self.block, n)) for i in range(0, n, self.block)]

    @torch.no_grad()
    def search_scores(self, batch, posterior_eps, noise, scale: float) -> torch.Tensor:
        """Each candidate's score (K,): the summed min-local loss after a
        2-step rollout from it, over every row of the batch. noise is
        (K, B, h, w, 4)."""
        sig = torch.as_tensor(np.append(ddpm_sigmas(2), 0.0).astype(np.float32), device=self.device)
        scores = torch.zeros(noise.shape[0], device=self.device)
        for rows in self._blocks(noise.shape[1]):
            part = {k: v[rows] for k, v in batch.items()}
            context, concat, mask = self.conditions(part, posterior_eps[rows])
            for k in range(noise.shape[0]):
                x = noise[k, rows].permute(0, 3, 1, 2) * torch.sqrt(1.0 + sig[0] ** 2)
                n = x.shape[0]
                for i in range(2):
                    s = sig[i].expand(n)
                    d, maps = self.cfg_denoise(x, s, context, concat, scale, maps=True)
                    if i == 0:
                        x = x + (sig[1] - sig[0]) * (x - d) / sig[0]
                loss = self.min_local_loss(maps, mask, part["seg_mask"])
                scores[k] += loss.sum()
        return scores

    @torch.no_grad()
    def sample_rows(self, batch, posterior_eps, x0, steps: int, scale: float) -> torch.Tensor:
        """uint8 images (B, H, W, 3) of the Euler loop from x0 (B, h, w, 4)."""
        sig = torch.as_tensor(np.append(ddpm_sigmas(steps), 0.0).astype(np.float32),
                              device=self.device)
        out = []
        for rows in self._blocks(x0.shape[0]):
            part = {k: v[rows] for k, v in batch.items()}
            context, concat, _ = self.conditions(part, posterior_eps[rows])
            x = x0[rows].permute(0, 3, 1, 2) * torch.sqrt(1.0 + sig[0] ** 2)
            for i in range(steps):
                s = sig[i].expand(x.shape[0])
                x = x + (sig[i + 1] - sig[i]) * (x - self.cfg_denoise(x, s, context, concat, scale)) / sig[i]
            out.append(self.decode_u8(x))
        return torch.cat(out)

    # -- fine-tuning -----------------------------------------------------------

    def trainable(self, keys: Sequence[str]) -> Dict[str, torch.nn.Parameter]:
        """The UNet parameters a segment of whose name contains one of `keys`,
        marked to take gradients, by their program names."""
        out = {}
        for name, p in self.nets.named_parameters():
            if name.startswith("unet.") and any(k in seg for seg in name.split(".") for k in keys):
                p.requires_grad_(True)
                out[name] = p
        return out

    def loss(self, mb: Dict[str, torch.Tensor], n_total: int) -> torch.Tensor:
        """Backward of one micro-batch's loss, in blocks of rows; returns the
        loss (the mean over its rows of diffusion + λ·local loss)."""
        total = 0.0
        for rows in self._blocks(mb["image"].shape[0]):
            part = {k: v[rows] for k, v in mb.items()}
            with torch.no_grad():
                x = self.encode(part["image"], part["image_eps"])
                context = self.nets.label_encoder(part["label_ids"]) * part["ucg_keep"][:, None, None]
                concat = self.concat(part["mask"], part["masked"], part["masked_eps"])
            sigma = self.table[part["sigma_idx"]]
            noised = x + part["noise"].permute(0, 3, 1, 2) * sigma[:, None, None, None]
            d, maps = self.denoise(noised, sigma, concat, context)
            diff = (sigma[:, None, None, None] ** -2.0 * (d - x) ** 2).flatten(1).mean(dim=1)
            local = self.local_loss(maps, part["seg"], part["seg_mask"])
            part_loss = (diff + self.lambda_local * local).sum() / n_total
            part_loss.backward()
            total += float(part_loss.detach())
        return torch.tensor(total)


class AdamW:
    """torch.optim.AdamW's update (decoupled weight decay, bias-corrected
    moments), written out."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.01):
        self.params, self.lr, self.betas, self.eps, self.wd = params, lr, betas, eps, weight_decay
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        for n, p in self.params.items():
            g = grads[n]
            p.mul_(1.0 - self.lr * self.wd)
            self.m[n].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[n] / (1.0 - b2 ** self.t)).sqrt() + self.eps
            p.addcdiv_(self.m[n], denom, value=-self.lr / (1.0 - b1 ** self.t))


def train_steps(ref: Reference, steps: Sequence[Sequence[Dict[str, torch.Tensor]]],
                keys: Sequence[str], lr: float) -> Dict[str, object]:
    """The reference's first len(steps) optimizer steps, each over its
    micro-batches: {"losses": [...], "grad1": {name: the first step's mean
    gradient}, "start": {name: parameters before}, "end": {name: after}}."""
    params = ref.trainable(keys)
    opt = AdamW(params, lr)
    start = {n: p.detach().clone() for n, p in params.items()}
    losses, grad1 = [], None
    for micro in steps:
        for p in params.values():
            p.grad = None
        loss = sum(float(ref.loss(mb, mb["image"].shape[0])) for mb in micro) / len(micro)
        grads = {n: p.grad / len(micro) for n, p in params.items()}
        if grad1 is None:
            grad1 = {n: g.clone() for n, g in grads.items()}
        opt.step(grads)
        losses.append(loss)
    return {"losses": losses, "grad1": grad1, "start": start,
            "end": {n: p.detach().clone() for n, p in params.items()}}
