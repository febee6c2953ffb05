"""Character set and label tokenization for the LabelEncoder (port of
`udifftext_tpu/charset.py`, so the port needs nothing of the JAX package).

The charset is ``string.printable[:-6]`` (94 visible ASCII characters);
id 0 is the pad/unknown class, so ``NUM_CLASSES == 95``. A label encodes as
``charset.find(c) + 1`` per character, right-padded with 0 to ``max_len``.
"""

from __future__ import annotations

import string
from typing import Sequence

import numpy as np

CHARSET: str = string.printable[:-6]
NUM_CLASSES: int = len(CHARSET) + 1  # +1 for pad id 0
PAD_ID: int = 0

_CHAR_TO_ID = {c: i + 1 for i, c in enumerate(CHARSET)}


def encode_label(label: str, max_len: int) -> np.ndarray:
    """One label → (max_len,) int32 ids; characters outside the charset
    map to 0."""
    if len(label) > max_len:
        raise ValueError(f"label {label!r} longer than max_len={max_len}")
    ids = np.zeros((max_len,), dtype=np.int32)
    for i, c in enumerate(label):
        ids[i] = _CHAR_TO_ID.get(c, PAD_ID)
    return ids


def encode_labels(labels: Sequence[str], max_len: int) -> np.ndarray:
    """A batch of labels → (B, max_len) int32."""
    return np.stack([encode_label(l, max_len) for l in labels], axis=0)
