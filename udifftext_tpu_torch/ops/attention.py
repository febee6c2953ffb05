"""Scaled-dot-product attention dispatch.

The port of `udifftext_tpu/ops/attention.py`: bf16 CUDA tensors of the
latent self-attention shapes go to the flash kernels (ops/flash_attention.py,
differentiable: its backward is the flash backward kernel); every other
shape, fp32 (`flash_dtype_ok`), and every CPU tensor take the plain matmul +
fp32 softmax path, as the TPU build sends them to XLA. `impl` is the TPU build's switch: "auto"
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


def flash_dtype_ok(dtype: torch.dtype) -> bool:
    """Whether "auto" sends attention of `dtype` to the flash kernels: bf16
    only. fp32 forward and backward through autograd, the kernels against
    the plain path (`scripts/sizing_probe.py attention`, NVIDIA H100 80GB
    HBM3, 700 W): 1.467 against 1.489 ms at ds2 B=2 (N=1024, 10 heads),
    7.925 against 6.395 ms at ds1 B=2 (N=4096, 5 heads); the fp32 FMA
    backward loses more than the forward gains. So fp32 takes the plain
    path, which holds the (B, H, N, N) fp32 logits in memory."""
    return dtype == torch.bfloat16


def flash_auto_ok(dtype: torch.dtype, nq: int, nk: int, d: int) -> bool:
    """The "auto" gate on the card: the dtype's and the shape's."""
    return flash_dtype_ok(dtype) and flash_shape_ok(nq, nk, d)


def flash_ok(q: torch.Tensor, k: torch.Tensor) -> bool:
    """CUDA tensors of a dtype and shape that "auto" sends to the flash
    kernels (the TPU build checked for a TPU backend instead)."""
    return q.is_cuda and flash_auto_ok(q.dtype, q.shape[1], k.shape[1], q.shape[-1])


IMPLS = ("auto", "plain", "flash")


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: Optional[float] = None, impl: str = "auto") -> torch.Tensor:
    """Attention; `impl` in {"auto", "plain", "flash"}."""
    if impl not in IMPLS:
        raise ValueError(f"sdpa: impl must be one of {IMPLS}, got {impl!r}")
    if impl == "flash" or (impl == "auto" and flash_ok(q, k)):
        return flash_attention(q, k, v, scale)[0]
    return plain_sdpa(q, k, v, scale)
