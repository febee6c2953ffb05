"""Fused LayerNorm → projection(s): the hand-written CUDA kernel and its plain
versions.

The kernel (csrc/ln_gemm.cu) replaces two Pallas TPU kernels of
`udifftext_tpu/ops/ln_gemm.py`: `_ln_gemm_fwd_impl` / `_ln_gemm_kernel`
(`ln_gemm`: one wide output) and `_ln_gemm3_fwd_impl` / `_ln_gemm3_kernel`
(`ln_gemm3`: q, k, v as three compact arrays). Both launch it for CUDA
tensors, or raise on what it does not take, and run their plain PyTorch
versions, `ln_gemm_ref` / `ln_gemm3_ref`, for CPU tensors. Both are
differentiable through a `torch.autograd.Function` whose backward recomputes
through the plain version, as the JAX build's custom VJPs do (it has no
backward kernel for these).

`ln_ref_f32` is the one LayerNorm every fused op of this package shares: fp32
mean and centered variance, eps 1e-5, output in x's dtype. Weights are in
PyTorch's Linear layout (F, C); LayerNorm scale and bias are fp32 (C,).

Bound on an H100 at the ds1 width with 32 × 4096 rows (C = F = 320, three
outputs, bf16): 84 MB read and 252 MB written, 0.10 ms at 3.35 TB/s, against
80.5 GFLOP, 0.08 ms at 989 TFLOP/s. The kernel keeps the normalized rows in
shared memory, so x is read once and only the outputs are written.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence, Tuple

import torch

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# x, scale, bias, w0, w1, w2, o0, o1, o2, n_w, M, C, F, eps, dtype, stream

ROW_TILE = 64   # rows per block: B·N % 64 == 0
MAX_C = 1536    # 64 normalized rows of C bf16 values stay in shared memory
EPS = 1e-5


def ln_ref_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = EPS) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 centered statistics, output in
    x's dtype: the prologue of every fused kernel and of its plain version."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * scale.float() + bias.float()).to(x.dtype)


def ln_gemm_ref(x, scale, bias, w, eps: float = EPS) -> torch.Tensor:
    """Plain PyTorch version at the kernel's rounding points: the normalized
    rows rounded to x's dtype, the product in fp32, one rounding at the end."""
    return (ln_ref_f32(x, scale, bias, eps).float() @ w.float().t()).to(x.dtype)


def ln_gemm3_ref(x, scale, bias, wq, wk, wv, eps: float = EPS):
    """(LN(x)·wqᵀ, LN(x)·wkᵀ, LN(x)·wvᵀ), plain, at the kernel's rounding points."""
    xn = ln_ref_f32(x, scale, bias, eps).float()
    return tuple((xn @ w.float().t()).to(x.dtype) for w in (wq, wk, wv))


def _shape_ok(x: torch.Tensor, f: int) -> bool:
    c = x.shape[-1]
    rows = x.numel() // max(c, 1)
    return (x.dtype in _build.DTYPE_CODES and rows > 0 and rows % ROW_TILE == 0
            and c % 16 == 0 and 0 < c <= MAX_C and f > 0 and f % 16 == 0)


def ln_gemm_supported(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the CUDA kernel takes x (..., C) and w (F, C): bf16 or fp32,
    rows % 64 == 0, C % 16 == 0, F % 16 == 0, C <= 1536. These are the CUDA
    kernel's own limits (a 64-row tile of C values in shared memory, 16-wide
    tensor-core tiles), not the TPU kernel's."""
    return w.ndim == 2 and w.shape[1] == x.shape[-1] and _shape_ok(x, w.shape[0])


def ln_gemm3_supported(x: torch.Tensor, f: int) -> bool:
    """`ln_gemm_supported` for three (f, C) weights. The TPU kernel needed
    all three weights resident and so refused C = 1280; this one reads weight
    tiles as it uses them and takes it."""
    return _shape_ok(x, f)


def recompute_grads(fn: Callable, inputs: Sequence[torch.Tensor], needs: Sequence[bool],
                    grad_outputs) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of `fn(*inputs)` by running it again under autograd: one
    entry per input, None where `needs` is false."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = fn(*leaves)
    wanted = [t for t, n in zip(leaves, needs) if n]
    grads = iter(torch.autograd.grad(out, wanted, grad_outputs, allow_unused=True))
    return tuple(next(grads) if n else None for n in needs)


def _launch(name: str, x, scale, bias, ws) -> Tuple[torch.Tensor, ...]:
    c = x.shape[-1]
    f = ws[0].shape[0]
    ts = (x, scale, bias, *ws)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if any(w.dtype != x.dtype for w in ws) or x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: x and the weights must share one dtype, bf16 or fp32; got "
                        + ", ".join(str(t.dtype) for t in (x, *ws)))
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"{name}: the LayerNorm scale and bias must be fp32")
    if scale.shape != (c,) or bias.shape != (c,) or any(w.shape != (f, c) for w in ws):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} scale {tuple(scale.shape)} "
                         f"bias {tuple(bias.shape)} w {[tuple(w.shape) for w in ws]}")
    if not _shape_ok(x, f):
        raise ValueError(f"{name}: needs rows % {ROW_TILE} == 0, C % 16 == 0, F % 16 == 0 and "
                         f"C <= {MAX_C}; got x {tuple(x.shape)}, F={f}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: x, the LayerNorm parameters and the weights must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: tensors must start at 16-byte aligned addresses")
    outs = tuple(torch.empty(x.shape[:-1] + (f,), dtype=x.dtype, device=x.device) for _ in ws)
    ptr = lambda seq, i: seq[i].data_ptr() if i < len(seq) else None  # noqa: E731
    fn = _build.kernel_function("udt_ln_gemm", _ARGTYPES)
    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), ptr(ws, 0), ptr(ws, 1), ptr(ws, 2),
             ptr(outs, 0), ptr(outs, 1), ptr(outs, 2), len(ws), x.numel() // c, c, f, EPS,
             _build.DTYPE_CODES[x.dtype], _build.stream_handle(x))
    _build.check(err, "udt_ln_gemm")
    return outs


class _LnGemm(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward: the
    plain version run again under autograd, for the gradients asked for."""

    @staticmethod
    def forward(ctx, x, scale, bias, w):
        ctx.save_for_backward(x, scale, bias, w)
        if not x.is_cuda:
            return ln_gemm_ref(x, scale, bias, w)
        out, = _launch("ln_gemm", x, scale, bias, (w,))
        ln_gemm.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        return recompute_grads(ln_gemm_ref, ctx.saved_tensors, ctx.needs_input_grad, g)


class _LnGemm3(torch.autograd.Function):
    """As `_LnGemm`, with three weights and three outputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, wq, wk, wv):
        ctx.save_for_backward(x, scale, bias, wq, wk, wv)
        if not x.is_cuda:
            return ln_gemm3_ref(x, scale, bias, wq, wk, wv)
        outs = _launch("ln_gemm3", x, scale, bias, (wq, wk, wv))
        ln_gemm3.launches += 1
        return outs

    @staticmethod
    def backward(ctx, *gs):
        return recompute_grads(ln_gemm3_ref, ctx.saved_tensors, ctx.needs_input_grad, gs)


def ln_gemm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """LN(x)·wᵀ: x (..., C), scale/bias (C,) fp32, w (F, C) → (..., F) in x's
    dtype, differentiable in every input. CUDA tensors launch the kernel (or
    raise on what it does not take); CPU tensors take the plain version."""
    return _LnGemm.apply(x, scale, bias, w)


def ln_gemm3(x, scale, bias, wq, wk, wv) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(LN(x)·wqᵀ, LN(x)·wkᵀ, LN(x)·wvᵀ) as three compact (..., F) tensors
    from one read of x; otherwise as `ln_gemm`."""
    return _LnGemm3.apply(x, scale, bias, wq, wk, wv)


ln_gemm.launches = 0
ln_gemm3.launches = 0
