"""Scene-text-recognition metrics (port of `udifftext_tpu/str_eval.py`):
word accuracy, 1 − normalized edit distance and mean sequence confidence
(strhub's BaseSystem._eval_step), with strhub's CharsetAdapter."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


class CharsetAdapter:
    """Case coercion to a one-case charset, then unsupported characters removed."""

    def __init__(self, target_charset: str):
        self.lowercase_only = target_charset == target_charset.lower()
        self.uppercase_only = target_charset == target_charset.upper()
        self.unsupported = f"[^{re.escape(target_charset)}]"

    def __call__(self, label: str) -> str:
        if self.lowercase_only:
            label = label.lower()
        elif self.uppercase_only:
            label = label.upper()
        return re.sub(self.unsupported, "", label)


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance."""
    if not a or not b:
        return len(a) + len(b)
    prev = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        cur = [i] + [0] * len(b)
        for j in range(1, len(b) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[-1]


@dataclass
class STRResult:
    num_samples: int = 0
    correct: int = 0
    ned: float = 0.0
    confidence: float = 0.0
    label_length: int = 0

    def update(self, pred: str, gt: str, conf: float) -> None:
        self.num_samples += 1
        self.correct += pred == gt
        self.ned += edit_distance(pred, gt) / max(len(pred), len(gt), 1)
        self.confidence += conf
        self.label_length += len(pred)

    @property
    def accuracy(self) -> float:
        return 100 * self.correct / max(self.num_samples, 1)

    @property
    def mean_1_minus_ned(self) -> float:
        return 100 * (1 - self.ned / max(self.num_samples, 1))

    @property
    def mean_confidence(self) -> float:
        return 100 * self.confidence / max(self.num_samples, 1)


def evaluate_predictions(preds: Sequence[str], gts: Sequence[str], confidences: Sequence[float],
                         charset_test: str = "0123456789abcdefghijklmnopqrstuvwxyz") -> STRResult:
    """The metrics over (prediction, label, confidence) triples, both strings
    adapted to `charset_test`."""
    adapter = CharsetAdapter(charset_test)
    res = STRResult()
    for p, g, c in zip(preds, gts, confidences):
        res.update(adapter(p), adapter(g), float(c))
    return res


def sequence_confidence(logits: np.ndarray, eos_id: Optional[int] = 0) -> List[float]:
    """The product of each step's top softmax probability, up to and
    including the first EOS (every step with `eos_id=None`, as strhub's CTC
    tokenizer scores a best path), per sequence of (B, T, C) logits."""
    logits = np.asarray(logits)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    out = []
    for dist in probs:
        conf = 1.0
        for prob, idx in zip(dist.max(-1), dist.argmax(-1)):
            conf *= float(prob)
            if idx == eos_id:
                break
        out.append(conf)
    return out
