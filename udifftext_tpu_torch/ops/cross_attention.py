"""The textual cross-attention branch as one op: the hand-written CUDA kernel
and its plain version.

    out = x + (softmax(LN(x)·wqᵀ·kᵀ/√d)·v)·woᵀ + bo

with the context's k, v projected beforehand (hoisted): x (B, N, C), LayerNorm
scale/bias (C,) fp32, wq (H·d, C), k/v (B, L, H, d), wo (C, H·d), bo (C,), the
weights in PyTorch's Linear layout. The kernel (csrc/cross_attention.cu)
replaces the Pallas TPU kernel `udifftext_tpu/ops/cross_attention.py`
`_fwd_impl` / `_kernel`. `fused_cross_attention` launches it for CUDA tensors,
or raises on what it does not take, and runs the plain PyTorch version,
`fused_cross_attention_ref`, for CPU tensors. It is differentiable through a
`torch.autograd.Function` whose backward recomputes through the plain version,
as the JAX build's `_fca_bwd` does.

Bound on an H100 at the ds1 width with 32 × 4096 rows (C = 320, L = 12,
bf16): x read and out written once, 168 MB, 0.05 ms at 3.35 TB/s, against
55.7 GFLOP, 0.056 ms at 989 TFLOP/s. The kernel keeps the normalized rows, q,
the attention weights and the head outputs in shared memory and registers.

Routes (`cross_attention_plan`, a pure function of dtype and shape): "mma"
(`wgmma`, weights staged through a shared-memory ring, 64 or 128 rows a
block) for bf16 with C % 64 == 0, C >= 128 and the block's tiles within
shared memory (the ds1 and ds2 widths); "wmma" (the first-cut kernel) for the other
bf16 widths, C = 1280 among them; "fma" for fp32. A CUDA tensor takes the
route its shape names; none gives way to another or to the plain version.
`fused_cross_attention.last_route` and `.last_plan` report the latest launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .ln_gemm import EPS, ln_ref_f32, recompute_grads

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# x, ln_scale, ln_bias, wq, k, v, wo, bo, out, B, N, C, inner, L, eps, scale, dtype, stream
_MMA_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
# x, ln_scale, ln_bias, wq, k, v, wo, bo, out, B, N, C, inner, L, rows, eps, scale, stream

ROW_TILE = 64    # N % 64 == 0: a block's rows stay within one batch element
HEAD_DIM = 64    # the kernel holds one 64-wide head slice in registers
MAX_C = 1536     # two 32-row buffers of C bf16 values stay in shared memory
MAX_L = 64
# route "mma" (csrc/cross_attention.cu cross_attn_mma_kernel<RG>)
TILE_BYTES = 64 * 64 * 2   # one swizzled 64×64 bf16 tile
RING_BYTES = 4 * 2 * TILE_BYTES
SMEM_MAX = 232448          # dynamic shared memory one block may opt in to (227 KB)
SMS = 132                  # the H100's multiprocessors


class CrossAttentionPlan(NamedTuple):
    """The route of one call, the rows a block owns and its bytes of
    dynamic shared memory (0 off the "mma" route)."""
    route: str
    rows: int
    smem_bytes: int


def mma_smem_bytes(row_groups: int, c: int, inner: int) -> int:
    """Dynamic shared memory of the "mma" route (csrc/cross_attention.cu
    `mma_smem_bytes`): 1 KB of alignment slack, the x rows and the attention
    outputs of `row_groups` × 64 rows as 64×64 tiles, and a ring of four
    stages of two tiles."""
    return 1024 + TILE_BYTES * row_groups * (c // 64 + inner // 64) + RING_BYTES


@functools.lru_cache(maxsize=None)
def cross_attention_plan(dtype: torch.dtype, b: int, n: int, c: int, inner: int,
                         sms: int = SMS) -> CrossAttentionPlan:
    """The route of `fused_cross_attention` for x (b, n, c) of `dtype` and
    `inner` = heads·64 on a card with `sms` multiprocessors (the shape must
    pass `cross_attention_supported`).

    "mma": bf16 with c % 64 == 0, c >= 128 (a warpgroup's two first x tiles
    stage its fp32 output tile) and 64 rows' tiles within shared memory; 128
    rows a block (two warpgroups sharing each staged weight tile) where those
    fit, n % 128 == 0 and the grid of b·n/128 blocks still covers the card,
    else 64. "wmma": the other bf16 widths, 64 rows a block up to a width of
    384, 32 above. "fma": fp32, 16 rows."""
    if dtype == torch.float32:
        return CrossAttentionPlan("fma", 16, 0)
    if c % 64 == 0 and c >= 128 and mma_smem_bytes(1, c, inner) <= SMEM_MAX:
        if (mma_smem_bytes(2, c, inner) <= SMEM_MAX and n % 128 == 0
                and b * n // 128 >= sms):
            return CrossAttentionPlan("mma", 128, mma_smem_bytes(2, c, inner))
        return CrossAttentionPlan("mma", 64, mma_smem_bytes(1, c, inner))
    return CrossAttentionPlan("wmma", 64 if max(c, inner) <= 384 else 32, 0)


def fused_cross_attention_ref(x, ln_scale, ln_bias, wq, k, v, wo, bo, heads: int,
                              eps: float = EPS) -> torch.Tensor:
    """Plain PyTorch version at the kernel's rounding points: q, the softmax
    weights and the head outputs rounded to x's dtype; logits, softmax and
    every product in fp32; the projection, bo and the fp32 x summed before
    the one rounding at the end."""
    b, n, _ = x.shape
    dt = x.dtype
    inner = wq.shape[0]
    d = inner // heads
    xn = ln_ref_f32(x, ln_scale, ln_bias, eps)
    q = (xn.float() @ wq.float().t()).to(dt).reshape(b, n, heads, d)
    sim = torch.einsum("bnhd,blhd->bhnl", q.float(), k.float()) * d**-0.5
    attn = torch.softmax(sim, dim=-1).to(dt)
    out = torch.einsum("bhnl,blhd->bnhd", attn.float(), v.float()).to(dt).reshape(b, n, inner)
    proj = out.float() @ wo.float().t() + bo.float()
    return (proj + x.float()).to(dt)


def cross_attention_supported(x: torch.Tensor, k: torch.Tensor, heads: int) -> bool:
    """Whether the CUDA kernel takes x (B, N, C) with k (B, L, heads, d): bf16
    or fp32, N % 64 == 0, C % 16 == 0, d == 64, C and heads·64 <= 1536 (so at
    most 24 heads, inside the TPU kernel's 32), 1 < L <= 64 (the softmax
    branch over a short context, as on the TPU). The rest are the CUDA
    kernel's own limits: row tiles within a batch element, a head slice in
    registers, two row buffers in shared memory."""
    if x.ndim != 3 or k.ndim != 4:
        return False
    _, n, c = x.shape
    _, l, h, d = k.shape
    return (x.dtype in _build.DTYPE_CODES and h == heads and d == HEAD_DIM
            and n > 0 and n % ROW_TILE == 0 and c % 16 == 0 and 0 < c <= MAX_C
            and h * d <= MAX_C and 1 < l <= MAX_L)


def _launch(x, ln_scale, ln_bias, wq, k, v, wo, bo, heads: int) -> torch.Tensor:
    name = "fused_cross_attention"
    ts = (x, ln_scale, ln_bias, wq, k, v, wo, bo)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if any(t.dtype != x.dtype for t in (wq, k, v, wo, bo)) or x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: x, wq, k, v, wo and bo must share one dtype, bf16 or fp32; "
                        "got " + ", ".join(str(t.dtype) for t in (x, wq, k, v, wo, bo)))
    if ln_scale.dtype != torch.float32 or ln_bias.dtype != torch.float32:
        raise TypeError(f"{name}: the LayerNorm scale and bias must be fp32")
    if x.ndim != 3 or k.ndim != 4:
        raise ValueError(f"{name}: x must be (B, N, C) and k (B, L, H, d); got "
                         f"{tuple(x.shape)}, {tuple(k.shape)}")
    b, n, c = x.shape
    l = k.shape[1]
    inner = heads * HEAD_DIM
    if (k.shape != (b, l, heads, HEAD_DIM) or v.shape != k.shape or wq.shape != (inner, c)
            or wo.shape != (c, inner) or bo.shape != (c,) or ln_scale.shape != (c,)
            or ln_bias.shape != (c,)):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} wq {tuple(wq.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} wo {tuple(wo.shape)} "
                         f"bo {tuple(bo.shape)} for {heads} heads of {HEAD_DIM}")
    if not cross_attention_supported(x, k, heads):
        raise ValueError(f"{name}: needs N % {ROW_TILE} == 0, C % 16 == 0, C and heads·64 <= "
                         f"{MAX_C}, 1 < L <= {MAX_L}; got "
                         f"x {tuple(x.shape)}, k {tuple(k.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: all tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: tensors must start at 16-byte aligned addresses")
    plan = cross_attention_plan(x.dtype, b, n, c, inner, _sm_count(x.device))
    out = torch.empty_like(x)
    ptrs = (x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wq.data_ptr(), k.data_ptr(),
            v.data_ptr(), wo.data_ptr(), bo.data_ptr(), out.data_ptr())
    if plan.route == "mma":
        err = _entry("udt_cross_attention_mma")(*ptrs, b, n, c, inner, l, plan.rows, EPS,
                                                 HEAD_DIM**-0.5, _build.stream_handle(x))
    else:
        err = _entry("udt_cross_attention")(*ptrs, b, n, c, inner, l, EPS, HEAD_DIM**-0.5,
                                             _build.DTYPE_CODES[x.dtype], _build.stream_handle(x))
    _build.check(err, f"fused_cross_attention (route {plan.route})")
    fused_cross_attention.launches += 1
    fused_cross_attention.last_route = plan.route
    fused_cross_attention.last_plan = plan
    return out


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    return _build.kernel_function(name, _MMA_ARGTYPES if name.endswith("mma") else _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class _FusedCrossAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward: the
    plain version run again under autograd, for the gradients asked for."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wq, k, v, wo, bo, heads):
        ctx.save_for_backward(x, ln_scale, ln_bias, wq, k, v, wo, bo)
        ctx.heads = heads
        if not x.is_cuda:
            return fused_cross_attention_ref(x, ln_scale, ln_bias, wq, k, v, wo, bo, heads)
        return _launch(x, ln_scale, ln_bias, wq, k, v, wo, bo, heads)

    @staticmethod
    def backward(ctx, g):
        heads = ctx.heads
        grads = recompute_grads(lambda *a: fused_cross_attention_ref(*a, heads),
                                ctx.saved_tensors, ctx.needs_input_grad[:8], g)
        return (*grads, None)


def fused_cross_attention(x, ln_scale, ln_bias, wq, k, v, wo, bo, heads: int) -> torch.Tensor:
    """x + OutProj(Attn(LN(x)·wqᵀ, k, v)): the whole t_attn residual branch of
    a transformer block, differentiable in every tensor. CUDA tensors launch
    the kernel (or raise on what it does not take); CPU tensors take the
    plain version."""
    return _FusedCrossAttention.apply(x, ln_scale, ln_bias, wq, k, v, wo, bo, heads)


fused_cross_attention.launches = 0
# the route and plan of the latest launch, for the tests and the smoke run
fused_cross_attention.last_route = None
fused_cross_attention.last_plan = None
