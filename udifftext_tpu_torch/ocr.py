"""OCR predictor over PARSeq (port of `udifftext_tpu/ocr.py`).

  - preprocessing: crops resized to 32×128, normalized (x − 0.5) / 0.5;
  - img2txt: greedy decode as the reader's strhub tokenizer does it (CTC
    collapse for CRNN, up to the first EOS for the others);
  - calc_loss: per-sample CE over the characters before the first EOS,
    clamped at 1.0, differentiable in the images.

Two resamplers, each the function of its JAX-package counterpart:

  - `crop_resize_bbox` is `jax.image.scale_and_translate(method="cubic",
    antialias=True)` of each image's bbox region: Keys' cubic (a = −0.5)
    whose support widens by 1/scale when the bbox is larger than the
    output, each output sample's weights normalized, samples whose center
    falls outside the input zeroed. It builds one (in, out) weight matrix per
    axis per sample from that sample's r_bbox and applies them as two batched
    products, so autograd carries the gradient to the images.
    `F.interpolate(mode="bicubic")` is another function (a = −0.75, no
    antialias, no per-sample scale or translation).
  - `bicubic_resize` is `cv2.resize(interpolation=INTER_CUBIC)` on the
    device: a = −0.75, half-pixel centers, edge pixels replicated.
"""

from __future__ import annotations

import inspect
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .models.layers import keys_cubic
from .models.parseq import PARSeq, ParseqTokenizer
from .models.str_models import CRNN, ctc_collapse
from .str_eval import sequence_confidence


def scale_translate_weights(in_size: int, out_size: int, scale: torch.Tensor,
                            translation: torch.Tensor) -> torch.Tensor:
    """(B, in_size, out_size) fp32 resampling weights of one axis, for
    per-sample `scale` and `translation` (B,): output pixel o samples the
    input at (o + 0.5 − translation) / scale − 0.5 (jax.image's
    `compute_weight_mat` with the cubic kernel and antialias)."""
    scale = scale.float()[:, None, None]
    translation = translation.float()[:, None, None]
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)[None, None, :]
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)[None, :, None]
    sample_f = (out_pos + 0.5) * inv_scale - translation * inv_scale - 0.5
    weights = keys_cubic(torch.abs(sample_f - in_pos) / kernel_scale)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside, weights, torch.zeros_like(weights))


def crop_resize_bbox(images: torch.Tensor, r_bbox: torch.Tensor,
                     out_hw: Tuple[int, int] = (32, 128)) -> torch.Tensor:
    """Resample each image's bbox region to `out_hw`: images (B, H, W, C),
    r_bbox (B, 4) = (top, bottom, left, right) → (B, oh, ow, C) fp32."""
    top, bottom, left, right = r_bbox.to(images.device).float().unbind(dim=-1)
    oh, ow = out_hw
    scale_y = oh / torch.clamp(bottom - top, min=1.0)
    scale_x = ow / torch.clamp(right - left, min=1.0)
    wy = scale_translate_weights(images.shape[1], oh, scale_y, -top * scale_y)
    wx = scale_translate_weights(images.shape[2], ow, scale_x, -left * scale_x)
    rows = torch.einsum("bhwc,bho->bowc", images.float(), wy)
    return torch.einsum("bowc,bwp->bopc", rows, wx)


def _cv2_cubic_matrix(in_size: int, out_size: int, device) -> torch.Tensor:
    """(out_size, in_size) fp32 weights of cv2's INTER_CUBIC along one axis."""
    a = -0.75
    f = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
    sx = np.floor(f)
    t = (f - sx).astype(np.float32)
    c0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    c1 = ((a + 2) * t - (a + 3)) * t * t + 1
    c2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    coeffs = np.stack([c0, c1, c2, 1.0 - c0 - c1 - c2], axis=1).astype(np.float32)
    taps = np.clip(sx[:, None].astype(np.int64) + np.arange(-1, 3), 0, in_size - 1)
    m = np.zeros((out_size, in_size), np.float32)
    np.add.at(m, (np.repeat(np.arange(out_size), 4), taps.reshape(-1)), coeffs.reshape(-1))
    return torch.from_numpy(m).to(device)


def bicubic_resize(image: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(image, (ow, oh), interpolation=INTER_CUBIC) of one (H, W, C)
    fp32 image, on its device."""
    h, w = image.shape[:2]
    my = _cv2_cubic_matrix(h, out_hw[0], image.device)
    mx = _cv2_cubic_matrix(w, out_hw[1], image.device)
    return torch.einsum("oh,hwc,pw->opc", my, image.float(), mx)


class ParseqPredictor:
    """A frozen PARSeq, or another hub reader, with its tokenizer; runs on
    the model's device. How the reader is called (with `refine_iters` or
    without) and decoded (CTC or EOS-first) is fixed when it is built."""

    def __init__(self, model: PARSeq, tokenizer: ParseqTokenizer = None):
        self.model = model
        self.tokenizer = tokenizer or ParseqTokenizer()
        self.takes_refine = "refine_iters" in inspect.signature(model.forward).parameters
        self.ctc = isinstance(model, CRNN)

    @property
    def img_hw(self) -> Tuple[int, int]:
        return tuple(getattr(self.model, "img_size", (32, 128)))  # every hub reader's size

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def preprocess(self, crops: torch.Tensor) -> torch.Tensor:
        """crops (B, H, W, 3) in [0, 1] → (x − 0.5) / 0.5."""
        return (crops - 0.5) / 0.5

    def read_logits(self, crops: torch.Tensor, refine_iters: int = 1) -> torch.Tensor:
        if self.takes_refine:
            return self.model(self.preprocess(crops), refine_iters)
        return self.model(self.preprocess(crops))

    def decode(self, logits: np.ndarray) -> Tuple[List[str], List[float]]:
        """(B, T, C) logits → the greedy strings and sequence confidences, as
        strhub's tokenizers give them: a CTC reader's best path with repeats
        merged and blanks (id 0) dropped, its confidence over every frame;
        the others' ids up to the first EOS (id 0), confidence up to it."""
        ids = logits.argmax(-1)
        if self.ctc:
            texts = ["".join(self.tokenizer.itos[i] for i in seq) for seq in ctc_collapse(ids)]
            return texts, sequence_confidence(logits, eos_id=None)
        return self.tokenizer.decode_ids(ids), sequence_confidence(logits)

    @torch.no_grad()
    def img2txt(self, crops: torch.Tensor) -> List[str]:
        """crops already (B, 32, 128, 3), [0, 1] → the greedy strings."""
        logits = self.read_logits(torch.as_tensor(crops, device=self.device))
        return self.decode(logits.float().cpu().numpy())[0]

    def img2txt_ragged(self, images: Sequence[np.ndarray]) -> List[str]:
        """Crops of any size (H_i, W_i, 3) in [0, 1]: each resized to 32×128
        as cv2's INTER_CUBIC does, clipped to [0, 1], then read as a batch."""
        crops = torch.stack([
            bicubic_resize(torch.as_tensor(np.asarray(im, np.float32), device=self.device),
                           self.img_hw)
            for im in images])
        return self.img2txt(crops.clamp(0.0, 1.0))

    def calc_loss(self, images: torch.Tensor, r_bbox: torch.Tensor, label_ids: torch.Tensor,
                  refine_iters: int = 1) -> torch.Tensor:
        """Per-sample clamped CE (B,), differentiable in `images`.

        images (B, H, W, 3), unclamped, as the decoder gives them; r_bbox
        (B, 4); label_ids (B, L) from `tokenizer.encode` ([BOS, chars, EOS,
        PAD...]). The full read (AR + refinement) gives the logits, its greedy
        ids are constants; CE is taken at the positions before the first EOS
        of label_ids[:, 1:], averaged per sample and clamped at 1.0."""
        crops = crop_resize_bbox(images, r_bbox, self.img_hw)
        logits = self.read_logits(crops, refine_iters)
        tgt = torch.as_tensor(label_ids, device=logits.device).long()[:, 1:]
        n = min(tgt.shape[1], logits.shape[1])
        tgt, logits = tgt[:, :n], logits[:, :n]
        is_char = ((tgt == self.tokenizer.eos_id).cumsum(dim=-1) == 0).float()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, tgt.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        per_sample = (nll * is_char).sum(dim=-1) / is_char.sum(dim=-1).clamp(min=1.0)
        return per_sample.clamp(max=1.0)
