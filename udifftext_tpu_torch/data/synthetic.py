"""Synthetic seg-capable training batches made from a seed, for runs that
have no dataset on disk (the GPU smoke test, the OCR-step probe).

Each sample has the fields a scene-text dataset gives (loader.collate's
input): a smooth image with noise in [-1, 1], a text-box mask (1 inside,
the region to inpaint), the masked image, one segmentation channel per
character (a column of the box), the character mask, the box as r_bbox
(top, bottom, left, right) and a random word as the label. Batches are
`loader.collate` of the samples, so label_ids and parseq_label_ids come
from the pipeline's own tokenization. numpy only.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from .loader import collate

WORD_CHARS = list("ABCDEFGHabcdefgh0123")


def synthetic_sample(rs: np.random.RandomState, size: int = 512,
                     seq: int = 12) -> Dict[str, Any]:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    f = rs.uniform(1, 4, 3)
    image = np.sin(np.stack([xx * f[0], yy * f[1], (xx + yy) * f[2]], -1) * 3)
    image = np.clip(image + 0.1 * rs.standard_normal(image.shape), -1, 1).astype(np.float32)
    n_chars = rs.randint(2, seq + 1)
    y0, x0 = rs.randint(0, size // 2, 2)
    h = rs.randint(size // 8, size // 3)
    cw = rs.randint(max(size // 64, 1), max(size // (2 * seq), 2))  # a character's width
    w = n_chars * cw
    mask = np.zeros((size, size, 1), np.float32)
    mask[y0:y0 + h, x0:x0 + w] = 1.0
    seg = np.zeros((size, size, seq), np.float32)
    for c in range(n_chars):
        seg[y0:y0 + h, x0 + c * cw:x0 + (c + 1) * cw, c] = 1.0
    seg_mask = np.zeros(seq, np.float32)
    seg_mask[:n_chars] = 1.0
    return {"image": image, "masked": image * (1 - mask), "mask": mask, "seg": seg,
            "seg_mask": seg_mask, "r_bbox": np.array([y0, y0 + h, x0, x0 + w], np.int32),
            "label": "".join(rs.choice(WORD_CHARS) for _ in range(n_chars))}


class SyntheticBatches:
    """`n` collated micro-batches of `b` synthetic samples; sized and
    re-iterable, as `train.train` takes its batches."""

    def __init__(self, n: int, b: int, size: int = 512, seq: int = 12, seed: int = 0):
        rs = np.random.RandomState(seed)
        self.batches: List[Dict[str, Any]] = [
            collate([synthetic_sample(rs, size, seq) for _ in range(b)], seq) for _ in range(n)]

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)
