"""Seeded weights for both sides of a cell, made on the device.

The values are drawn from one `torch.Generator` on the device in a few large
calls, then scaled per parameter: weights N(0, 1/fan_in), norm scales
1 + N(0, 0.1²) and shifts N(0, 0.1²), biases N(0, 0.02²), embeddings
N(0, 1). None is zero, so no branch hides behind a zero-initialized output
projection. Each value is rounded to the dtype the configuration serves it
in (`served_dtype`), and the reference reads those same rounded values.
"""

from __future__ import annotations

import hashlib
from types import ModuleType
from typing import Iterator, List, Tuple

import torch
from torch import nn

CHUNK = 1 << 27  # elements drawn per call


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def served_dtype(name: str, graph: dict, unet_dtype: torch.dtype, train: bool,
                 norm: bool) -> torch.dtype:
    """The dtype the configuration stores a parameter in: the UNet's linear
    and convolution weights and biases in its compute dtype, except the
    trainable ones (a segment containing one of `opt_keys`), which stay fp32
    master weights in training; norms, the autoencoder and the LabelEncoder
    in fp32."""
    if not name.startswith("unet.") or norm:
        return torch.float32
    keys = graph.get("opt_keys", ("t_attn", "t_norm"))
    if train and any(k in seg for seg in name.split(".") for k in keys):
        return torch.float32
    return unet_dtype


def iter_weights(model: nn.Module, seed: int, device: torch.device, graph: dict,
                 unet_dtype: torch.dtype, train: bool,
                 ref: ModuleType) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor on `device`) for every parameter of the reference `model`
    (which may live on the meta device), in its order; `ref`, the reference
    package that defines it, tells its norms and embeddings. Parameters are
    drawn in groups of up to CHUNK elements, one call a group, so that no
    more than a group's draw is held at a time."""
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "weights"))
    params = list(model.named_parameters())
    group: List[Tuple[str, nn.Parameter]] = []
    size = 0
    for name, p in params + [("", None)]:
        if p is not None and (not group or size + p.numel() <= CHUNK):
            group.append((name, p))
            size += p.numel()
            continue
        flat = torch.randn(size, generator=gen, device=device)
        at = 0
        for gname, gp in group:
            r = flat[at:at + gp.numel()].view(gp.shape)
            at += gp.numel()
            yield gname, _scale(model, gname, r, ref).to(
                served_dtype(gname, graph, unet_dtype, train, ref.is_norm_param(model, gname)))
        group, size = ([(name, p)], p.numel()) if p is not None else ([], 0)


def _scale(model: nn.Module, name: str, r: torch.Tensor, ref: ModuleType) -> torch.Tensor:
    if ref.is_embedding(model, name):
        return r
    if ref.is_norm_param(model, name):
        return 1.0 + 0.1 * r if name.endswith("weight") else 0.1 * r
    if name.endswith("bias"):
        return 0.02 * r
    fan_in = 1
    for s in r.shape[1:]:
        fan_in *= s
    return r * fan_in ** -0.5
