"""Flash attention: the hand-written CUDA kernels and their plain versions.

The forward kernel (csrc/flash_attention.cu) replaces the Pallas TPU kernel
`udifftext_tpu/ops/flash_attention.py` `_flash_fwd_impl` / `_flash_kernel`;
the backward kernel (csrc/flash_attention_bwd.cu) replaces
`_flash_bwd_impl` / `_flash_bwd_kernel`. `flash_attention` is differentiable:
a `torch.autograd.Function` whose forward is the forward kernel and whose
backward is `flash_attention_bwd`. Each wrapper launches its kernel for CUDA
tensors (or raises on what the kernel does not take) and runs its plain
PyTorch version, `flash_attention_ref` / `flash_attention_bwd_ref`, for CPU
tensors.

Layout: q (B, Nq, H, D), k/v (B, Nk, H, D) → out (B, Nq, H, D) in q's dtype,
lse (B, H, Nq) fp32 (log-sum-exp of the scaled logits, which the backward
reads to rebuild p = exp(s·scale − lse)). The TPU backward rebuilt p from a
max-free denominator with logits clamped at ±75; the two agree wherever
|logits| < 75.
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
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 10                    # q, k, v, o, dout, lse, delta, dq, dk, dv
    + [ctypes.c_int] * 5                      # B, H, Nq, Nk, D
    + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)  # strides, scale, dtype, stream

BLOCK = 64  # query rows per block and keys per tile in the kernels


def _scale(d: int, scale: Optional[float]) -> float:
    return d**-0.5 if scale is None else float(scale)


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: fp32 logits from the
    inputs, exact softmax, fp32 p·v, one rounding to q's dtype."""
    scale = _scale(q.shape[-1], scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float())
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel, in fp32 from the inputs
    with one rounding of each gradient: p = exp(s·scale − lse), delta =
    rowsum(dout ⊙ out), ds = p ⊙ (dout·vᵀ − delta)."""
    scale = _scale(q.shape[-1], scale)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    delta = (gf * out.float()).sum(-1).transpose(1, 2)  # (B, H, Nq)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gf, vf) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    b, nq, h, d = q.shape
    nk = k.shape[1]
    if not (k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v must be on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype} not supported "
                        "(bf16 or fp32, all equal)")
    if k.shape != (b, nk, h, d) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d not in (64, 128) or nq % BLOCK or nk % BLOCK:
        raise ValueError(f"{name}: needs D in (64, 128) and N % {BLOCK} == 0, "
                         f"got D={d}, Nq={nq}, Nk={nk}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{name}: the head dimension must be contiguous")


def _flash_fwd(q, k, v, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's launch (CUDA) or its plain version (CPU)."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, scale)
    _check_qkv("flash_attention", q, k, v)
    b, nq, h, d = q.shape
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _build.kernel_function("udt_flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
             b, h, nq, k.shape[1], d, ctypes.cast(strides, ctypes.c_void_p), _scale(d, scale),
             _build.DTYPE_CODES[q.dtype], _build.stream_handle(q))
    _build.check(err, "udt_flash_attention_fwd")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention given the forward's out and lse and the
    output gradient dout. CUDA tensors launch the kernel (or raise on what it
    does not take); CPU tensors take the plain version."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, scale)
    _check_qkv("flash_attention_bwd", q, k, v)
    b, nq, h, d = q.shape
    nk = k.shape[1]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"flash_attention_bwd: {name} must match q's shape, dtype and "
                             f"device with a contiguous head dimension, got {tuple(t.shape)} "
                             f"{t.dtype} {t.device} strides {t.stride()}")
    if (lse.shape != (b, h, nq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous fp32 (B, H, Nq) tensor "
                         f"on q's device, got {tuple(lse.shape)} {lse.dtype}")
    delta = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, nk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, nk, h, d), dtype=v.dtype, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]))
    fn = _build.kernel_function("udt_flash_attention_bwd", _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b, h, nq, nk, d, ctypes.cast(strides, ctypes.c_void_p), _scale(d, scale),
             _build.DTYPE_CODES[q.dtype], _build.stream_handle(q))
    _build.check(err, "udt_flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel → (out, lse); backward kernel from the saved q, k, v,
    out and lse. lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.scale)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q·kᵀ·scale)·v → (out, lse), differentiable in q, k and v. CUDA
    tensors launch the kernels (or raise on what they do not take); CPU
    tensors take the plain versions."""
    return _FlashAttention.apply(q, k, v, scale)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
