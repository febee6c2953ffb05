"""Training and guidance losses (port of `udifftext_tpu/diffusion/loss.py`):
the local attention loss of fine-tuning, the min-local loss that scores
init-noise candidates and drives attend-and-excite, the weighted diffusion
loss and their sum with the optional OCR term, `full_loss`; and the
LabelEncoder pretraining loss, `clip_contrastive_loss`.

Layouts (NHWC): seg (B, H, W, L); mask (B, H, W, 1); seg_mask (B, L);
attention maps {name: (B, heads, N, L')} with N = h·w.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .schedules import append_dims


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


def _layer_maps(attn_maps: Dict[str, torch.Tensor], seg_l: int, img_hw: Tuple[int, int],
                kernel: torch.Tensor, min_attn_size: int) -> Iterator[Tuple[torch.Tensor, Tuple]]:
    """Per qualifying t_attn layer (sorted by name, side >= min_attn_size):
    the head-mean map of the first seg_l tokens, blurred, (B, h·w, seg_l),
    and its (h, w)."""
    for name in sorted(attn_maps):
        if not name.endswith("t_attn"):
            continue
        amap = attn_maps[name].float()
        b, _, n, _ = amap.shape
        hw = _attn_hw(n, *img_hw)
        if min(hw) < min_attn_size:
            continue
        m = amap[..., :seg_l].mean(dim=1).reshape(b, hw[0], hw[1], seg_l)
        yield gaussian_blur_depthwise(m, kernel).reshape(b, -1, seg_l), hw


def local_loss(attn_maps: Dict[str, torch.Tensor], seg: torch.Tensor, seg_mask: torch.Tensor,
               kernel: torch.Tensor, min_attn_size: int = 16) -> torch.Tensor:
    """Each valid character's out-of-seg peak minus its in-seg peak, averaged
    over the characters and the qualifying layers. Returns (B,)."""
    seg_l = seg_mask.shape[1]
    total = 0.0
    count = 0
    for blurred, hw in _layer_maps(attn_maps, seg_l, seg.shape[1:3], kernel, min_attn_size):
        s = interpolate_nearest_torch(seg, hw).float().reshape(seg.shape[0], -1, seg_l)
        p_loss = (s * blurred).amax(dim=1)
        n_loss = ((1.0 - s) * blurred).amax(dim=1)
        denom = seg_mask.sum(dim=-1)
        p = (p_loss * seg_mask).sum(dim=-1) / denom
        n = (n_loss * seg_mask).sum(dim=-1) / denom
        total = total + (n - p)
        count += 1
    if count == 0:
        return torch.zeros(seg.shape[0], dtype=torch.float32, device=seg.device)
    return total / count


def min_local_loss(attn_maps: Dict[str, torch.Tensor], mask: torch.Tensor,
                   seg_mask: torch.Tensor, kernel: torch.Tensor,
                   min_attn_size: int = 16) -> torch.Tensor:
    """The weakest in-mask character activation, negated, averaged over
    the t_attn layers of side >= min_attn_size. Returns (B,)."""
    seg_l = seg_mask.shape[1]
    total = 0.0
    count = 0
    for blurred, hw in _layer_maps(attn_maps, seg_l, mask.shape[1:3], kernel, min_attn_size):
        mask_map = interpolate_nearest_torch(mask, hw).float().reshape(mask.shape[0], -1, 1)
        p = (mask_map * blurred).amax(dim=1) + (1.0 - seg_mask)
        total = total - p.amin(dim=-1)
        count += 1
    if count == 0:
        return torch.zeros(mask.shape[0], dtype=torch.float32, device=mask.device)
    return total / count


def diff_loss(model_output: torch.Tensor, target: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-sample weighted L2 reconstruction loss. Returns (B,)."""
    per = w * (model_output - target) ** 2
    return per.reshape(target.shape[0], -1).mean(dim=1)


@dataclasses.dataclass(frozen=True)
class FullLossConfig:
    """The `loss_fn_config` settings the port runs."""

    kernel_size: int = 3
    gaussian_sigma: float = 1.0
    min_attn_size: int = 16
    lambda_local_loss: float = 0.01
    lambda_ocr_loss: float = 0.001
    ocr_enabled: bool = False

    @property
    def kernel(self) -> np.ndarray:
        return get_gaussian_kernel(self.kernel_size, self.gaussian_sigma)


OcrLossFn = Callable[[torch.Tensor, Dict[str, torch.Tensor]], torch.Tensor]


def full_loss(cfg: FullLossConfig, denoiser, network: Callable, cond: Dict[str, Any],
              x: torch.Tensor, batch: Dict[str, torch.Tensor], sigmas: torch.Tensor,
              noise: torch.Tensor, ocr_loss_fn: Optional[OcrLossFn] = None,
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Diffusion loss + lambda·local loss of the clean latent x noised at
    `sigmas` (B,) with standard-normal `noise`; `network` must capture the
    t_attn maps. With `cfg.ocr_enabled` and an `ocr_loss_fn` (denoised
    latent, batch → per-sample OCR loss (B,)), lambda_ocr·its mean is added
    too. Returns (loss, {loss/diff_loss, loss/local_loss[, loss/ocr_loss],
    loss/full_loss}), batch means."""
    noised = x + noise * append_dims(sigmas, x.ndim)
    model_output, aux = denoiser(network, noised, sigmas, cond)
    w = append_dims(denoiser.w(sigmas), x.ndim)
    d_loss = diff_loss(model_output, x, w).mean()
    kernel = torch.as_tensor(cfg.kernel, device=x.device)
    l_loss = local_loss(aux, batch["seg"], batch["seg_mask"], kernel, cfg.min_attn_size).mean()
    loss = d_loss + cfg.lambda_local_loss * l_loss
    parts = {"loss/diff_loss": d_loss, "loss/local_loss": l_loss}
    if cfg.ocr_enabled and ocr_loss_fn is not None:
        o_loss = ocr_loss_fn(model_output, batch).mean()
        loss = loss + cfg.lambda_ocr_loss * o_loss
        parts["loss/ocr_loss"] = o_loss
    return loss, {**parts, "loss/full_loss": loss}


def clip_contrastive_loss(text_out: torch.Tensor, visual_out: torch.Tensor,
                          logit_scale: torch.Tensor, cls_out: torch.Tensor, pos_out: torch.Tensor,
                          cls_target: torch.Tensor, lambda_cls: float = 0.1,
                          lambda_pos: float = 0.1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """LabelEncoder pretraining loss: the symmetric contrastive CE over
    exp(logit_scale)·v̂·t̂ᵀ, whose targets are the diagonal, plus λ_cls times
    the character CE of cls_out (B, L, 95) against cls_target (B, L) and
    λ_pos times the position CE of pos_out (B, L, L). text_out and
    visual_out (N, D) may hold the rows of every process (N ≥ B,
    `parallel.dist.all_gather_rows`): the similarity matrix is then the
    global batch's. Returns (loss, {loss/clip_loss, loss/cls_loss,
    loss/pos_loss, loss/full_loss, acc/clip_acc, acc/cls_acc, acc/pos_acc})."""
    b, l = cls_target.shape
    t = text_out / text_out.norm(dim=1, keepdim=True)
    v = visual_out / visual_out.norm(dim=1, keepdim=True)
    logits_per_image = logit_scale.exp() * (v @ t.T)
    logits_per_text = logits_per_image.T
    clip_target = torch.arange(text_out.shape[0], device=text_out.device)
    clip_loss = 0.5 * (F.cross_entropy(logits_per_image.float(), clip_target)
                       + F.cross_entropy(logits_per_text.float(), clip_target))
    cls_target = cls_target.long()
    cls_loss = F.cross_entropy(cls_out.float().flatten(0, 1), cls_target.flatten())
    pos_target = torch.arange(l, device=pos_out.device).expand(b, l)
    pos_loss = F.cross_entropy(pos_out.float().flatten(0, 1), pos_target.flatten())
    loss = clip_loss + lambda_cls * cls_loss + lambda_pos * pos_loss

    def acc(logits, target):
        return (logits.argmax(-1) == target).float().mean()

    return loss, {
        "loss/clip_loss": clip_loss,
        "loss/cls_loss": cls_loss,
        "loss/pos_loss": pos_loss,
        "loss/full_loss": loss,
        "acc/clip_acc": acc(logits_per_text, clip_target),
        "acc/cls_acc": acc(cls_out, cls_target),
        "acc/pos_acc": acc(pos_out, pos_target),
    }
