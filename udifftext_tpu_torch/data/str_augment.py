"""STR training augmentation, rand-augment style (port of
`udifftext_tpu/data/str_augment.py`; the same seed gives the same output
bit for bit).

Parity: src/parseq/strhub/data/augment.py composes imgaug rand-augment ops
for PARSeq training. Here a pool of eleven geometric and photometric
Pillow/numpy ops (the perspective one through cv2) is applied with random
magnitude, `n_ops` at a time. Pillow and cv2 are imported by the ops that
use them, so the module imports where neither is installed.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np


def _to_pil(img: np.ndarray):
    from PIL import Image

    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return Image.fromarray(img)


def _rotate(im, mag, rng):
    from PIL import Image

    return im.rotate(rng.uniform(-10, 10) * mag, resample=Image.BILINEAR, expand=False)


def _shear_x(im, mag, rng):
    from PIL import Image

    s = rng.uniform(-0.3, 0.3) * mag
    return im.transform(im.size, Image.AFFINE, (1, s, 0, 0, 1, 0), resample=Image.BILINEAR)


def _translate(im, mag, rng):
    from PIL import Image

    tx = rng.uniform(-0.1, 0.1) * mag * im.size[0]
    ty = rng.uniform(-0.1, 0.1) * mag * im.size[1]
    return im.transform(im.size, Image.AFFINE, (1, 0, tx, 0, 1, ty), resample=Image.BILINEAR)


def _perspective(im, mag, rng):
    import cv2
    from PIL import Image

    w, h = im.size
    d = 0.15 * mag
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    dst = src + np.float32([[rng.uniform(-d, d) * w, rng.uniform(-d, d) * h] for _ in range(4)])
    m = cv2.getPerspectiveTransform(src, dst)
    arr = cv2.warpPerspective(np.asarray(im), m, (w, h), borderMode=cv2.BORDER_REPLICATE)
    return Image.fromarray(arr)


def _contrast(im, mag, rng):
    from PIL import ImageEnhance

    return ImageEnhance.Contrast(im).enhance(1 + rng.uniform(-0.5, 0.5) * mag)


def _brightness(im, mag, rng):
    from PIL import ImageEnhance

    return ImageEnhance.Brightness(im).enhance(1 + rng.uniform(-0.5, 0.5) * mag)


def _sharpness(im, mag, rng):
    from PIL import ImageEnhance

    return ImageEnhance.Sharpness(im).enhance(1 + rng.uniform(-0.9, 0.9) * mag)


def _color(im, mag, rng):
    from PIL import ImageEnhance

    return ImageEnhance.Color(im).enhance(1 + rng.uniform(-0.5, 0.5) * mag)


def _blur(im, mag, rng):
    from PIL import ImageFilter

    return im.filter(ImageFilter.GaussianBlur(radius=rng.uniform(0, 1.5) * mag))


def _posterize(im, mag, rng):
    from PIL import ImageOps

    bits = max(1, 8 - int(rng.uniform(0, 4) * mag))
    return ImageOps.posterize(im, bits)


def _noise(im, mag, rng):
    from PIL import Image

    arr = np.asarray(im, np.float32)
    arr = arr + rng.normal(0, 12 * mag, arr.shape)
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


_OPS = [
    _rotate, _shear_x, _translate, _perspective,
    _contrast, _brightness, _sharpness, _color,
    _blur, _posterize, _noise,
]


class STRAugment:
    """Apply `n_ops` random ops at `magnitude` ∈ [0, 1]."""

    def __init__(self, n_ops: int = 3, magnitude: float = 0.5, seed: Optional[int] = None):
        self.n_ops = n_ops
        self.magnitude = magnitude
        self.rng = np.random.default_rng(seed)
        self.pyrng = random.Random(seed)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """img (H, W, 3) float [0,1] or uint8 → float32 [0,1]."""
        im = _to_pil(img)
        for op in self.pyrng.sample(_OPS, min(self.n_ops, len(_OPS))):
            im = op(im, self.magnitude, self.rng)
        return np.asarray(im, np.float32) / 255.0
