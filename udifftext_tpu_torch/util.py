"""Entry-point helpers of the eval and train CLIs (port of root util.py):
`init_model` / `init_sampling` (from `loading`), `numpy_batch_to_device`
and `prepare_batch`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .loading import init_model, init_sampling

__all__ = ["init_model", "init_sampling", "numpy_batch_to_device", "prepare_batch"]


def numpy_batch_to_device(batch: Mapping[str, Any],
                          device: torch.device | str = "cuda") -> Dict[str, Any]:
    """The batch with its numeric numpy arrays as tensors on `device`;
    strings, lists and object arrays stay on the host."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            out[k] = torch.as_tensor(v).to(device)
        else:
            out[k] = v
    return out


def prepare_batch(cfgs: Mapping[str, Any], batch: Mapping[str, Any],
                  device: torch.device | str = "cuda") -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(batch, batch_uc) on `device` (root util.py:62-78). The
    unconditional batch takes `ntxt` as its `txt` (else empty strings),
    empties `label` and zeroes `label_ids`; the engine also zeroes the label
    embedding of uc outright (force_uc_zero_label)."""
    batch = numpy_batch_to_device(batch, device)
    batch_uc = dict(batch)
    if "ntxt" in batch:
        batch_uc["txt"] = batch["ntxt"]
    elif "txt" in batch:
        batch_uc["txt"] = ["" for _ in batch["txt"]]
    if "label" in batch:
        batch_uc["label"] = ["" for _ in batch["label"]]
        batch_uc["label_ids"] = torch.zeros_like(batch["label_ids"])
    return batch, batch_uc
