"""Fused GEGLU feed-forward: the hand-written CUDA kernel and its plain version.

The kernel (csrc/geglu.cu) replaces the Pallas TPU kernel
`udifftext_tpu/ops/geglu.py` `_geglu_fwd_impl` / `_geglu_kernel` and, with a
LayerNorm prologue on the x rows, `_geglu_ln_fwd_impl` / `_geglu_ln_kernel`.
`geglu_ff` and `geglu_ff_ln` launch it for CUDA tensors and run the plain
PyTorch versions, `geglu_ff_ref` and `geglu_ff_ln_ref`, for CPU tensors. Both
are differentiable through a `torch.autograd.Function` whose backward is
`geglu_ff_bwd`, plain PyTorch (after the LayerNorm's own recompute for
`geglu_ff_ln`).

out = (h ⊙ gelu(g))·w2ᵀ + b2 with [h, g] = x·w1ᵀ + b1, the weights in
PyTorch's Linear layout: w1 (2I, C), b1 (2I,), w2 (C, I), b2 (C,);
`geglu_ff_ln` feeds it LN(x) (fp32 centered statistics, scale and bias fp32
(C,)) without the normalized rows reaching device memory. Bound on an H100
at the ds1 width with 32 × 4096 rows (C = 320, I = 1280, bf16): 322 GFLOP,
0.33 ms at 989 TFLOP/s, against 168 MB of x and out, 0.05 ms at 3.35 TB/s.

Routes (`geglu_kernel_route`): "mma" for bf16 at the widths csrc/geglu.cu
builds its `wgmma` kernel for (C / 64 in `MMA_TILES`: 320, 640 and 1280 among
them), "wmma" for other bf16 widths with C % 16 == 0, "fma" for fp32.
`geglu_plan` says how a call is cut into blocks (rows a block, splits of the
hidden dimension, launches, bytes of partial sums); both are pure functions.
A CUDA tensor that no route takes raises; no route gives way to another or to
the plain version. `geglu_ff_tiled_ref` walks the hidden dimension as the
"mma" kernel does, roundings included; the tests hold it against the plain
versions to settle what that order costs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .ln_gemm import EPS, ln_ref_f32, recompute_grads

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# x, ln_scale, ln_bias, w1, b1, w2, b2, out, partial, M, C, I, rows, splits, eps, dtype, route,
# stream

ROUTE_CODES = {"fma": 0, "wmma": 1, "mma": 2}  # as the C entry point reads them
CHUNK_BF16 = 64   # hidden units per tensor-core step: I % (64·splits) == 0
CHUNK_F32 = 32    # hidden units per FMA step
MAX_C = 2048      # widest C the register accumulator takes
MMA_TILES = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20)  # C / 64 the "mma" kernels are built for
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def geglu_kernel_route(dtype: torch.dtype, c: int) -> str:
    """Which hand-written kernel serves (dtype, width C) on the card: "mma"
    (`wgmma`, staged weights: bf16 with C / 64 = NT·G, NT <= 5 output tiles a
    warpgroup and G in (1, 2, 4) warpgroups over the same rows, which covers
    320, 640 and 1280), "wmma" (bf16 with any other C % 16 == 0) or "fma"
    (fp32). Raises on what none takes."""
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"geglu_ff: dtype {dtype} not supported (bf16 or fp32)")
    if c <= 0 or c > MAX_C:
        raise ValueError(f"geglu_ff: needs 0 < C <= {MAX_C}, got C={c}")
    if dtype == torch.float32:
        return "fma"
    if c % 64 == 0 and c // 64 in MMA_TILES:
        return "mma"
    if c % 16 == 0:
        return "wmma"
    raise ValueError(f"geglu_ff: bf16 needs C % 16 == 0, got C={c}")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class GegluPlan(NamedTuple):
    """How one call is cut into blocks: the route, the rows a block owns, the
    number of blocks that split the hidden dimension, the device launches of
    the call and the bytes of fp32 partial sums it writes (and reads back)."""
    route: str
    rows: int
    splits: int
    launches: int
    partial_bytes: int


@functools.lru_cache(maxsize=None)
def geglu_plan(dtype: torch.dtype, m: int, c: int, inner: int, sms: int) -> GegluPlan:
    """The launch plan of `geglu_ff` / `geglu_ff_ln` for M rows on a card
    with `sms` multiprocessors.

    "mma": 64 rows a block; up to C = 320, where a block's two warpgroups own
    64 rows each, 128 rows once there are more 64-row blocks than
    multiprocessors. From C = 768 on a block is a cluster of two CTAs and a
    chunk 128 hidden units, else 64. Up to C = 640 the hidden dimension is
    split over 1, 2 or 4 CTAs of one cluster while the grid stays within the
    card; they add their sums up in shared memory, so the call is one launch
    and writes no partial sums. From C = 768 on it is split over the largest
    divisor of its chunks that keeps the grid within the card and the fp32
    partial sums (splits·M·C·4 bytes) within the weights' 3·C·I·2 bytes, and
    a second launch adds them up; with one split the kernel writes the output
    itself, in one launch.
    "wmma": 16·row_tiles rows with row_tiles·C <= 1280, the hidden dimension
    split in two while the grid stays within two blocks a multiprocessor; a
    product and a reduce launch. "fma": 16 rows, one launch."""
    route = geglu_kernel_route(dtype, c)
    if route == "fma":
        return GegluPlan(route, 16, 1, 1, 0)
    if route == "wmma":
        rows = 16 * (4 if c <= 320 else 2 if c <= 640 else 1)
        row_blocks = -(-m // rows)
        chunks = inner // CHUNK_BF16
        splits = 1
        while row_blocks * splits * 2 <= 2 * sms and chunks % (splits * 2) == 0:
            splits *= 2
        return GegluPlan(route, rows, splits, 2, splits * m * c * 4)
    tiles = c // 64
    ctas = 2 if tiles > 10 else 1            # CTAs that share a block's rows (a cluster)
    chunk = 128 if tiles > 10 else 64
    rows = 128 if tiles <= 5 and -(-m // 64) > sms else 64
    if inner % chunk:
        raise ValueError(f"geglu_ff: C={c} needs I % {chunk} == 0, got I={inner}")
    chunks = inner // chunk
    blocks = -(-m // rows) * ctas
    if ctas == 1:
        # the splits are the CTAs of one cluster, summed on the chip: no partial bytes
        splits = max(d for d in (1, 2, 4) if chunks % d == 0 and (d == 1 or blocks * d <= sms))
        return GegluPlan(route, rows, splits, 1, 0)
    weight_bytes = 3 * c * inner * 2
    splits = max(d for d in range(1, chunks + 1)
                 if chunks % d == 0 and (d == 1 or (blocks * d <= sms
                                                    and d * m * c * 4 <= weight_bytes)))
    return GegluPlan(route, rows, splits, 1 if splits == 1 else 2,
                     0 if splits == 1 else splits * m * c * 4)


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


def geglu_ff_ln_ref(x, ln_scale, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of the LayerNorm-fused kernel: `ln_ref_f32`
    (rounded to x's dtype), then `geglu_ff_ref`."""
    return geglu_ff_ref(ln_ref_f32(x, ln_scale, ln_bias), w1, b1, w2, b2)


def geglu_ff_tiled_ref(x, w1, b1, w2, b2, splits: int = 1, chunk: int = 64,
                       ln=None) -> torch.Tensor:
    """The forward as the "mma" kernel walks it, in plain PyTorch (tests
    only, on either device): with `ln` = (scale, bias) the rows are first
    `ln_ref_f32`'s LayerNorm rounded to x's dtype; the hidden dimension is
    cut into `splits` equal parts, each walked in chunks of `chunk` units:
    h and g of a chunk in fp32 plus b1, act = h·gelu(g) rounded to x's dtype,
    act·w2ᵀ added to the part's fp32 sum; the parts' sums are added in order
    from zero, b2 is added in fp32, one rounding at the end."""
    inner = w2.shape[1]
    if ln is not None:
        x = ln_ref_f32(x, ln[0], ln[1])
    xf, w1f, w2f = x.float(), w1.float(), w2.float()
    per = inner // splits
    total = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for s in range(splits):
        part = torch.zeros_like(total)
        for j0 in range(s * per, (s + 1) * per, chunk):
            h = xf @ w1f[j0:j0 + chunk].t() + b1[j0:j0 + chunk].float()
            g = xf @ w1f[inner + j0:inner + j0 + chunk].t() + b1[inner + j0:inner + j0 + chunk].float()
            act = (h * torch.nn.functional.gelu(g)).to(x.dtype).float()
            part = part + act @ w2f[:, j0:j0 + chunk].t()
        total = total + part
    return (total + b2.float()).to(x.dtype)


def geglu_ff_bwd(x, w1, b1, w2, b2, g_out, needs=(True,) * 5):
    """Gradients (dx, dw1, db1, dw2, db2) of the feed-forward, a port of the
    JAX build's `_geglu_bwd`: h and g recomputed from one product in x's
    dtype, exact-erf gelu′ in fp32, every product in x's dtype at the same
    rounding points. `needs` says which gradients to compute (None for the
    others)."""
    dt = x.dtype
    inner = w2.shape[1]
    c = x.shape[-1]
    w1c, w2c = w1.to(dt), w2.to(dt)
    hg = x @ w1c.t() + b1.to(dt)
    h, g = hg[..., :inner].float(), hg[..., inner:].float()
    gelu_g = torch.nn.functional.gelu(g)
    go = g_out.to(dt)
    dw2 = db2 = dx = dw1 = db1 = None
    if needs[3]:
        act = (h * gelu_g).to(dt)
        dw2 = (go.reshape(-1, c).t() @ act.reshape(-1, inner)).to(w2.dtype)
    if needs[4]:
        db2 = go.float().reshape(-1, c).sum(0).to(b2.dtype)
    if needs[0] or needs[1] or needs[2]:
        dact = (go @ w2c).float()
        dgelu = (0.5 * (1.0 + torch.erf(g * _INV_SQRT2))
                 + g * torch.exp(-0.5 * g * g) * _INV_SQRT_2PI)
        dhg = torch.cat([dact * gelu_g, dact * h * dgelu], dim=-1).to(dt)
        if needs[0]:
            dx = (dhg @ w1c).to(x.dtype)
        if needs[1]:
            dw1 = (dhg.reshape(-1, 2 * inner).t() @ x.reshape(-1, c)).to(w1.dtype)
        if needs[2]:
            db1 = dhg.float().reshape(-1, 2 * inner).sum(0).to(b1.dtype)
    return dx, dw1, db1, dw2, db2


class _GegluFF(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward: the
    plain recompute of `geglu_ff_bwd` (the JAX build has no backward kernel
    for GEGLU either)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        if not x.is_cuda:
            return geglu_ff_ref(x, w1, b1, w2, b2)
        return _geglu_launch(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g_out):
        return geglu_ff_bwd(*ctx.saved_tensors, g_out, ctx.needs_input_grad)


class _GegluFFLn(torch.autograd.Function):
    """Forward: the kernel with its LayerNorm prologue (CUDA) or the plain
    version (CPU). Backward: the LayerNorm recomputed under autograd, chained
    into `geglu_ff_bwd` (the JAX build differentiates its plain version)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        if not x.is_cuda:
            return geglu_ff_ln_ref(x, ln_scale, ln_bias, w1, b1, w2, b2)
        return _geglu_launch(x, w1, b1, w2, b2, (ln_scale, ln_bias))

    @staticmethod
    def backward(ctx, g_out):
        x, ln_scale, ln_bias, *ff = ctx.saved_tensors
        needs = ctx.needs_input_grad
        ln_needs = needs[:3]
        xn = ln_ref_f32(x, ln_scale, ln_bias)
        dxn, *dff = geglu_ff_bwd(xn, *ff, g_out, (any(ln_needs), *needs[3:]))
        dln = (None, None, None)
        if any(ln_needs):
            dln = recompute_grads(ln_ref_f32, (x, ln_scale, ln_bias), ln_needs, dxn)
        return (*dln, *dff)


def geglu_ff(x, w1, b1, w2, b2) -> torch.Tensor:
    """x (..., C) → (..., C), differentiable in every input. CUDA tensors
    launch the kernel (or raise on what it does not take); CPU tensors take
    the plain version."""
    return _GegluFF.apply(x, w1, b1, w2, b2)


def geglu_ff_ln(x, ln_scale, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """GEGLU(LN(x)): x (..., C), ln_scale/ln_bias (C,) fp32 → (..., C),
    differentiable in every input. CUDA tensors launch the kernel with its
    LayerNorm prologue (or raise on what it does not take); CPU tensors take
    the plain version."""
    return _GegluFFLn.apply(x, ln_scale, ln_bias, w1, b1, w2, b2)


def _geglu_launch(x, w1, b1, w2, b2, ln=None) -> torch.Tensor:
    """One launch of the kernel; `ln` is the (scale, bias) of the LayerNorm
    prologue, or None for none."""
    wrapper = geglu_ff if ln is None else geglu_ff_ln
    name = wrapper.__name__
    c = x.shape[-1]
    inner = w2.shape[1]
    ts = (x, w1, b1, w2, b2)
    if not all(t.is_cuda and t.device == x.device for t in ts + (ln or ())):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if any(t.dtype != x.dtype for t in ts) or x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: x and the weights must share one dtype, bf16 or fp32; got "
                        + ", ".join(str(t.dtype) for t in ts))
    if (w1.shape != (2 * inner, c) or b1.shape != (2 * inner,) or w2.shape != (c, inner)
            or b2.shape != (c,)):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} w1 {tuple(w1.shape)} "
                         f"b1 {tuple(b1.shape)} w2 {tuple(w2.shape)} b2 {tuple(b2.shape)}")
    route = geglu_kernel_route(x.dtype, c)
    if inner % (CHUNK_F32 if route == "fma" else CHUNK_BF16):
        raise ValueError(f"{name}: needs I % {CHUNK_BF16} == 0 for bf16 and I % {CHUNK_F32} == 0 "
                         f"for fp32; got C={c}, I={inner}, {x.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: x and the weights must be contiguous")
    if any(t.data_ptr() % 32 for t in ts):
        raise ValueError(f"{name}: tensors must start at 32-byte aligned addresses")
    if ln is not None and not all(t.dtype == torch.float32 and t.shape == (c,)
                                  and t.is_contiguous() for t in ln):
        raise ValueError(f"{name}: the LayerNorm scale and bias must be contiguous fp32 "
                         f"({c},) tensors")
    m = x.numel() // c
    out = torch.empty_like(x)
    plan = geglu_plan(x.dtype, m, c, inner, _sm_count(x.device))
    partial = None
    if plan.partial_bytes:
        partial = torch.empty((plan.splits, m, c), dtype=torch.float32, device=x.device)
    ln_scale, ln_bias = (None, None) if ln is None else (t.data_ptr() for t in ln)
    fn = _build.kernel_function("udt_geglu_ff", _ARGTYPES)
    err = fn(x.data_ptr(), ln_scale, ln_bias, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
             b2.data_ptr(), out.data_ptr(), None if partial is None else partial.data_ptr(), m,
             c, inner, plan.rows, plan.splits, EPS, _build.DTYPE_CODES[x.dtype],
             ROUTE_CODES[route], _build.stream_handle(x))
    _build.check(err, f"udt_geglu_ff ({name}, route {route})")
    wrapper.launches += 1
    wrapper.last_route = route
    wrapper.last_plan = plan
    return out


geglu_ff.launches = 0
geglu_ff_ln.launches = 0
# the route and plan of each wrapper's latest launch, for the tests and the smoke run
geglu_ff.last_route = geglu_ff_ln.last_route = None
geglu_ff.last_plan = geglu_ff_ln.last_plan = None
