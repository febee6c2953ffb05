"""Fused GEGLU feed-forward: the hand-written CUDA kernel and its plain version.

The kernel (csrc/geglu.cu) replaces the Pallas TPU kernel
`udifftext_tpu/ops/geglu.py` `_geglu_fwd_impl` / `_geglu_kernel`.
`geglu_ff` launches it for CUDA tensors and runs the plain PyTorch version,
`geglu_ff_ref`, for CPU tensors.

out = (h ⊙ gelu(g))·w2ᵀ + b2 with [h, g] = x·w1ᵀ + b1, the weights in
PyTorch's Linear layout: w1 (2I, C), b1 (2I,), w2 (C, I), b2 (C,).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# x, w1, b1, w2, b2, out, partial, M, C, I, row_tiles, splits, dtype, stream

CHUNK_BF16 = 64   # hidden units per tensor-core step: I % (64·splits) == 0
CHUNK_F32 = 32    # hidden units per FMA step
MAX_C = 2048      # widest C the register accumulator takes


def _bf16_plan(m: int, c: int, inner: int, sms: int):
    """(row_tiles, splits) of the tensor-core kernel: 16·row_tiles rows per
    block with row_tiles·C <= 1280 (the output accumulator stays in
    registers), and the hidden dimension split in two while that keeps the
    grid within two blocks per SM."""
    row_tiles = 4 if c <= 320 else 2 if c <= 640 else 1
    row_blocks = -(-m // (16 * row_tiles))
    chunks = inner // CHUNK_BF16
    splits = 1
    while row_blocks * splits * 2 <= 2 * sms and chunks % (splits * 2) == 0:
        splits *= 2
    return row_tiles, splits


def geglu_ff_ref(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version at the kernel's rounding points: h and g in
    fp32, act rounded to x's dtype, the second product and b2 in fp32, one
    rounding at the end."""
    inner = w2.shape[1]
    hg = x.float() @ w1.float().t() + b1.float()
    h, g = hg[..., :inner], hg[..., inner:]
    act = (h * torch.nn.functional.gelu(g)).to(x.dtype)
    out = act.float() @ w2.float().t() + b2.float()
    return out.to(x.dtype)


def geglu_ff(x, w1, b1, w2, b2) -> torch.Tensor:
    """x (..., C) → (..., C). CUDA tensors launch the kernel (or raise on
    what it does not take); CPU tensors take the plain version."""
    if not x.is_cuda:
        return geglu_ff_ref(x, w1, b1, w2, b2)
    c = x.shape[-1]
    inner = w2.shape[1]
    ts = (x, w1, b1, w2, b2)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("geglu_ff: all tensors must be on one CUDA device")
    if any(t.dtype != x.dtype for t in ts) or x.dtype not in _build.DTYPE_CODES:
        raise TypeError("geglu_ff: x and the weights must share one dtype, bf16 or fp32; got "
                        + ", ".join(str(t.dtype) for t in ts))
    if (w1.shape != (2 * inner, c) or b1.shape != (2 * inner,) or w2.shape != (c, inner)
            or b2.shape != (c,)):
        raise ValueError(f"geglu_ff: shapes x {tuple(x.shape)} w1 {tuple(w1.shape)} "
                         f"b1 {tuple(b1.shape)} w2 {tuple(w2.shape)} b2 {tuple(b2.shape)}")
    bf16 = x.dtype == torch.bfloat16
    if c > MAX_C or inner % (CHUNK_BF16 if bf16 else CHUNK_F32) or (bf16 and c % 16):
        raise ValueError(f"geglu_ff: needs C <= {MAX_C}, and for bf16 C % 16 == 0 and "
                         f"I % {CHUNK_BF16} == 0 (fp32: I % {CHUNK_F32} == 0); "
                         f"got C={c}, I={inner}, {x.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("geglu_ff: x and the weights must be contiguous")
    if any(t.data_ptr() % 32 for t in ts):
        raise ValueError("geglu_ff: tensors must start at 32-byte aligned addresses")
    m = x.numel() // c
    out = torch.empty_like(x)
    row_tiles, splits = 1, 1
    partial = None
    if bf16:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        row_tiles, splits = _bf16_plan(m, c, inner, sms)
        partial = torch.empty((splits, m, c), dtype=torch.float32, device=x.device)
    fn = _build.kernel_function("udt_geglu_ff", _ARGTYPES)
    err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
             out.data_ptr(), None if partial is None else partial.data_ptr(), m, c, inner,
             row_tiles, splits, _build.DTYPE_CODES[x.dtype], _build.stream_handle(x))
    _build.check(err, "udt_geglu_ff")
    geglu_ff.launches += 1
    return out


geglu_ff.launches = 0
