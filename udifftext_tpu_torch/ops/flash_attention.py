"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

The kernel (csrc/flash_attention.cu) replaces the Pallas TPU kernel
`udifftext_tpu/ops/flash_attention.py` `_flash_fwd_impl` / `_flash_kernel`.
`flash_attention` launches it for CUDA tensors and runs the plain PyTorch
version, `flash_attention_ref`, for CPU tensors.

Layout: q (B, Nq, H, D), k/v (B, Nk, H, D) → out (B, Nq, H, D) in q's dtype,
lse (B, H, Nq) fp32 (log-sum-exp of the scaled logits, for a backward).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_ARGTYPES = (
    [ctypes.c_void_p] * 5                     # q, k, v, o, lse
    + [ctypes.c_int] * 5                      # B, H, Nq, Nk, D
    + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)  # strides, scale, dtype, stream

BLOCK = 64  # query rows per block and keys per tile in the kernel


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's function: fp32 logits from the
    inputs, exact softmax, fp32 p·v, one rounding to q's dtype."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float())
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q·kᵀ·scale)·v → (out, lse). CUDA tensors launch the kernel
    (or raise on what it does not take); CPU tensors take the plain version."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, scale)
    b, nq, h, d = q.shape
    nk = k.shape[1]
    if not (k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype} not supported "
                        "(bf16 or fp32, all equal)")
    if k.shape != (b, nk, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d not in (64, 128) or nq % BLOCK or nk % BLOCK:
        raise ValueError(f"flash_attention: needs D in (64, 128) and N % {BLOCK} == 0, "
                         f"got D={d}, Nq={nq}, Nk={nk}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the head dimension must be contiguous")
    scale = d**-0.5 if scale is None else float(scale)
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _build.kernel_function("udt_flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
             b, h, nq, nk, d, ctypes.cast(strides, ctypes.c_void_p), scale,
             _build.DTYPE_CODES[q.dtype], _build.stream_handle(q))
    _build.check(err, "udt_flash_attention_fwd")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
