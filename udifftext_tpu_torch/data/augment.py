"""Shared host-side augmentation geometry for the scene-text datasets (port of
`udifftext_tpu/data/augment.py`, the same numpy/cv2 code).

Behavior parity with the reference's per-dataset `augment` methods
(dataset/dataloader.py: ICDAR13 :183-240, TextSeg :356-437, SynthText
:567-645, LAION-OCR :771-859): square-pad with border-replicate (constant for
mask/seg), zoom toward the mask when its area ratio is below 4× the minimum,
resize to the target size, and recompute the region bbox. The per-character
segmentation extraction (morphology, connected components, charseg id
matching) also lives here.

This is ragged host code (cv2/numpy): it stays off the device and feeds
fixed-shape NHWC batches to the training step. cv2 is imported inside the
functions that use it, so the package imports where OpenCV is not
installed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..charset import CHARSET


def square_pad(
    image: np.ndarray,
    mask: np.ndarray,
    bbox: Tuple[int, int, int, int],
    seg: Optional[np.ndarray] = None,
):
    """Pad to square: image border-replicated, mask constant-1 (outside is
    'keep'), seg constant-0. bbox is (top, bottom, left, right)."""
    import cv2

    h, w = image.shape[:2]
    m_top, m_bottom, m_left, m_right = bbox
    if h >= w:
        delta = (h - w) // 2
        m_left += delta
        m_right += delta
        image = cv2.copyMakeBorder(image, 0, 0, delta, delta, cv2.BORDER_REPLICATE)
        mask = cv2.copyMakeBorder(mask, 0, 0, delta, delta, cv2.BORDER_CONSTANT, value=(1, 1, 1))
        if seg is not None:
            seg = cv2.copyMakeBorder(seg, 0, 0, delta, delta, cv2.BORDER_CONSTANT, value=(0, 0, 0))
    else:
        delta = (w - h) // 2
        m_top += delta
        m_bottom += delta
        image = cv2.copyMakeBorder(image, delta, delta, 0, 0, cv2.BORDER_REPLICATE)
        mask = cv2.copyMakeBorder(mask, delta, delta, 0, 0, cv2.BORDER_CONSTANT, value=(1, 1, 1))
        if seg is not None:
            seg = cv2.copyMakeBorder(seg, delta, delta, 0, 0, cv2.BORDER_CONSTANT, value=(0, 0, 0))
    return image, mask, seg, (m_top, m_bottom, m_left, m_right)


def zoom_to_mask(
    image: np.ndarray,
    mask: np.ndarray,
    bbox: Tuple[int, int, int, int],
    area: float,
    min_ratio: float,
    seg: Optional[np.ndarray] = None,
    seg_layout: str = "hw",  # "hw" | "hwc" | "lhw"
):
    """Crop a window around the mask center when the mask is too small
    (reference 'aug_min_ratio = mask_min_ratio * 4' branch)."""
    h, w = image.shape[:2]
    m_top, m_bottom, m_left, m_right = bbox
    m_h, m_w = int(m_bottom - m_top), int(m_right - m_left)
    c_h, c_w = m_top + m_h // 2, m_left + m_w // 2

    aug_min_ratio = min_ratio * 4
    if area / (h * w) >= aug_min_ratio:
        return image, mask, seg, bbox

    d = int((area / aug_min_ratio) ** 0.5)
    d = max(d, max(m_h, m_w))
    if c_h <= h - c_h:
        delta_top = min(c_h, d // 2)
        delta_bottom = d - delta_top
    else:
        delta_bottom = min(h - c_h, d // 2)
        delta_top = d - delta_bottom
    if c_w <= w - c_w:
        delta_left = min(c_w, d // 2)
        delta_right = d - delta_left
    else:
        delta_right = min(w - c_w, d // 2)
        delta_left = d - delta_right

    n_top, n_bottom = c_h - delta_top, c_h + delta_bottom
    n_left, n_right = c_w - delta_left, c_w + delta_right

    image = image[n_top:n_bottom, n_left:n_right]
    mask = mask[n_top:n_bottom, n_left:n_right]
    if seg is not None:
        if seg_layout == "lhw":
            seg = seg[:, n_top:n_bottom, n_left:n_right]
        else:  # hw / hwc share leading spatial dims
            seg = seg[n_top:n_bottom, n_left:n_right]
    return image, mask, seg, (m_top - n_top, m_bottom - n_top, m_left - n_left, m_right - n_left)


def resize_all(
    image: np.ndarray,
    mask: np.ndarray,
    bbox: Tuple[int, int, int, int],
    H: int,
    W: int,
    seg_lhw: Optional[np.ndarray] = None,
):
    """Resize image/mask/(seg L,H,W) to (H, W) and rescale the bbox."""
    import cv2

    h, w = image.shape[:2]
    m_top, m_bottom, m_left, m_right = bbox
    m_top, m_bottom = int(m_top * (H / h)), int(m_bottom * (H / h))
    m_left, m_right = int(m_left * (W / w)), int(m_right * (W / w))

    image = cv2.resize(image, (W, H))
    mask = cv2.resize(mask, (W, H))
    if seg_lhw is not None:
        seg_lhw = cv2.resize(seg_lhw.transpose(1, 2, 0), (W, H))
        if seg_lhw.ndim == 2:
            seg_lhw = seg_lhw[..., None]
        seg_lhw = seg_lhw.transpose(2, 0, 1)
    return image, mask, (m_top, m_bottom, m_left, m_right), seg_lhw


def denoise_dilate(seg_i: np.ndarray, open_iters: int, dilate_iters: int) -> np.ndarray:
    """Morphological cleanup used on char masks (reference :411-414, :822-825)."""
    import cv2

    seg_i = cv2.morphologyEx(seg_i, cv2.MORPH_OPEN, np.ones((1, 2), np.int8), iterations=open_iters)
    seg_i = cv2.morphologyEx(seg_i, cv2.MORPH_OPEN, np.ones((2, 1), np.int8), iterations=open_iters)
    seg_i = cv2.morphologyEx(seg_i, cv2.MORPH_DILATE, np.ones((3, 3), np.int8), iterations=dilate_iters)
    return seg_i


def _pad_truncate_channels(segs: List[np.ndarray], seq_len: int) -> np.ndarray:
    """Stack per-character channels to EXACTLY seq_len: zero-pad short lists
    and truncate over-long text (with seq_len < word_len max, len(text)
    channels would desynchronize seg from the (seq_len,) seg_mask)."""
    segs = segs[:seq_len]
    segs = segs + [np.zeros_like(segs[0]) for _ in range(seq_len - len(segs))]
    return np.concatenate(segs, axis=0)


def charseg_from_ids(
    seg: np.ndarray, text: str, seq_len: int
) -> Optional[np.ndarray]:
    """LAION-OCR per-character channels from a charseg id map (:811-847).

    seg: (H, W) uint8 of charset ids (1-based; 0 = background). Repeated
    characters are split by connected components ordered left-to-right.
    Returns (seq_len, H, W) or None when components cannot be matched.
    """
    import cv2

    segs: List[Optional[np.ndarray]] = [None] * len(text)
    ch_positions = {}
    for i, ch in enumerate(text):
        ch_positions.setdefault(ch, []).append(i)

    for ch, positions in ch_positions.items():
        ind = CHARSET.find(ch) + 1
        ind_l = CHARSET.find(ch.lower()) + 1
        # uint8 SUM, not union: for single-case characters ind == ind_l so
        # the channel holds value 2, exactly as the reference builds it
        # (dataloader.py:822) — its FullLoss consumes these doubled masks
        seg_i = (seg == ind).astype(np.uint8) + (seg == ind_l).astype(np.uint8)
        seg_i = denoise_dilate(seg_i, open_iters=1, dilate_iters=5)

        retval, labels, stats, _ = cv2.connectedComponentsWithStats(seg_i, connectivity=4)
        if retval < len(positions) + 1:
            return None
        stats = stats[1:].tolist()
        if retval > len(positions) + 1:
            stats.sort(key=lambda st: st[-1], reverse=True)
            stats = stats[: len(positions)]
        stats.sort(key=lambda st: st[0])  # left-to-right
        for idx, (x, y, w, h, s) in enumerate(stats):
            s_mask = np.zeros_like(seg_i)
            s_mask[y : y + h, x : x + w] = 1
            segs[positions[idx]] = (seg_i * s_mask)[None]

    return _pad_truncate_channels(segs, seq_len)


def charseg_from_values(
    seg_rgb: np.ndarray, text: str, seg_values: List[int], seq_len: int
) -> np.ndarray:
    """TextSeg per-character channels from per-char mask values (:410-422).

    Position-unaware: a character's channel is the union over all positions
    of that character (matching the reference). The (identical) channel of a
    repeated character is computed once and shared across its positions."""
    by_char: Dict[str, np.ndarray] = {}
    for ch in dict.fromkeys(text):
        indices = [j for j, c in enumerate(text) if c == ch]
        seg_i = np.sum(
            [(seg_rgb == seg_values[j]).astype(np.uint8).mean(axis=-1) for j in indices],
            axis=0,
        )
        seg_i = np.clip(seg_i, 0, 1).astype(np.float32)
        by_char[ch] = denoise_dilate(seg_i, open_iters=2, dilate_iters=7)[None]
    segs = [by_char[ch] for ch in text]
    return _pad_truncate_channels(segs, seq_len)


def charseg_from_boxes(
    shape_hw: Tuple[int, int], char_bboxes: np.ndarray, n_chars: int, seq_len: int
) -> Tuple[np.ndarray, float]:
    """SynthText per-character channels from char quads (:577-586).

    Returns ((seq_len, H, W), mean char area ratio)."""
    import cv2

    segs = []
    seg_sum = 0
    for qb in char_bboxes[:n_chars]:
        seg_i = np.zeros(shape_hw, np.uint8)
        seg_i = cv2.fillConvexPoly(seg_i, qb.astype(np.int32), 1)
        segs.append(seg_i[None])
        seg_sum += seg_i.sum()
    ratio = float(seg_sum / max(len(segs), 1)) / (shape_hw[0] * shape_hw[1])
    return _pad_truncate_channels(segs, seq_len), ratio
