"""Scaled-dot-product attention dispatch.

The port of `udifftext_tpu/ops/attention.py`: CUDA tensors of the latent
self-attention shapes go to the flash kernels (ops/flash_attention.py,
differentiable: its backward is the flash backward kernel); every other
shape, and every CPU tensor, takes the plain matmul + fp32 softmax path, as
the TPU build sends them to XLA. `impl` is the TPU build's switch: "auto"
(that gate), "plain" (its "xla": never a kernel) or "flash" (always the
kernel wrapper, which takes its plain version for a CPU tensor and raises on
a CUDA shape it does not serve).

Shapes: q (B, Nq, H, D), k/v (B, Nk, H, D) → out (B, Nq, H, D).
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention


def plain_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: Optional[float] = None) -> torch.Tensor:
    """Products in the input dtype, softmax in fp32, weights rounded back to
    the input dtype (`_xla_sdpa` of the TPU build)."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def flash_shape_ok(nq: int, nk: int, d: int) -> bool:
    """The TPU build's `_flash_ok` shape gate: below 512 query tokens the
    plain path is kept (ds4 N=256, the middle block N=64), as is any head
    size other than 64/128 (the VAE's single d=512 head)."""
    return nq >= 512 and nq % 128 == 0 and nk % 128 == 0 and d in (64, 128)


def flash_ok(q: torch.Tensor, k: torch.Tensor) -> bool:
    """CUDA tensors of a shape the flash kernel serves (the TPU build
    checked for a TPU backend instead)."""
    return q.is_cuda and flash_shape_ok(q.shape[1], k.shape[1], q.shape[-1])


IMPLS = ("auto", "plain", "flash")


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: Optional[float] = None, impl: str = "auto") -> torch.Tensor:
    """Attention; `impl` in {"auto", "plain", "flash"}."""
    if impl not in IMPLS:
        raise ValueError(f"sdpa: impl must be one of {IMPLS}, got {impl!r}")
    if impl == "flash" or (impl == "auto" and flash_ok(q, k)):
        return flash_attention(q, k, v, scale)[0]
    return plain_sdpa(q, k, v, scale)
