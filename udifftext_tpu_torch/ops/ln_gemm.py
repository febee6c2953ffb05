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

Routes (`ln_gemm_plan`, a pure function of dtype and shape): "mma" (`wgmma`
on the normalized rows in shared memory, weight tiles through a TMA ring fed
by a producer warp, a grid over row tiles × column groups) for bf16 with
C % 64 == 0; "wmma" (the first-cut kernel) for the other bf16 widths; "fma"
for fp32. A CUDA tensor takes the route its shape names; none gives way to
another or to the plain version. `ln_gemm.last_route` / `.last_plan` (and
`ln_gemm3`'s) report the latest launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# x, scale, bias, w0, w1, w2, o0, o1, o2, n_w, M, C, F, eps, dtype, stream

_MMA_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                 + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# x, scale, bias, w0, w1, w2, o0, o1, o2, n_w, M, C, F, eps, rows, n, group_tiles, stages, stream

ROW_TILE = 64   # rows per block: B·N % 64 == 0
MAX_C = 1536    # 64 normalized rows of C bf16 values stay in shared memory
EPS = 1e-5
# route "mma" (csrc/ln_gemm.cu ln_gemm_mma_kernel<N, RG>)
TILE_BYTES = 64 * 64 * 2   # one swizzled 64×64 bf16 tile
MMA_WIDTHS = (160, 64)     # output columns of a tile (wgmma m64n160k16, m64n64k16), widest first
MAX_STAGES = 4
SMEM_MAX = 232448          # dynamic shared memory one block may opt in to (227 KB)
SMS = 132                  # the H100's multiprocessors


class LnGemmPlan(NamedTuple):
    """How one call runs. "mma": `rows` = 64·RG rows a block, `n` output
    columns a tile, `group_tiles` column tiles a block (of `tiles` over the
    n_w weights, ⌈F/n⌉ each), `groups` column groups, `blocks` in the grid,
    a ring of `stages`, `steps` ring steps of the busiest block,
    `smem_bytes` of dynamic shared memory. "wmma" / "fma": 64 / 16 rows a
    block, every column in each block; n, stages, steps and smem_bytes 0."""
    route: str
    rows: int
    n: int
    group_tiles: int
    groups: int
    tiles: int
    blocks: int
    stages: int
    steps: int
    smem_bytes: int


def mma_smem_bytes(row_groups: int, c: int, n: int, stages: int) -> int:
    """Dynamic shared memory of the "mma" route (csrc/ln_gemm.cu
    `mma_smem_bytes`): 1 KB of alignment slack, the x rows of `row_groups`
    warpgroups as 64×64 tiles, the ring (`stages` boxes of n weight rows × 64
    columns), a 64×n staging tile a warpgroup for the epilogue's TMA stores
    and 128 bytes of barriers."""
    return (1024 + row_groups * (c // 64) * TILE_BYTES + stages * n * 128
            + row_groups * n * 128 + 128)


def _mma_plan(m: int, c: int, f: int, n_w: int, sms: int, n: int, rg: int) -> Optional[LnGemmPlan]:
    """The "mma" plan at tile width n and rg warpgroups a block, or None where
    the rows do not split into blocks or shared memory cannot hold a ring of
    two stages. Its column groups are the widest whose grid still has `sms`
    blocks (or one tile each where no grid does): at large m a block walks
    every column tile and normalizes its rows once."""
    if m % (64 * rg):
        return None
    stages = next((s for s in range(MAX_STAGES, 1, -1)
                   if mma_smem_bytes(rg, c, n, s) <= SMEM_MAX), None)
    if stages is None:
        return None
    row_tiles, tiles = m // (64 * rg), n_w * -(-f // n)
    target = min(sms, row_tiles * tiles)
    group_tiles = next(w for w in range(tiles, 0, -1) if row_tiles * -(-tiles // w) >= target)
    groups = -(-tiles // group_tiles)
    return LnGemmPlan("mma", 64 * rg, n, group_tiles, groups, tiles, row_tiles * groups,
                      stages, group_tiles * (c // 64), mma_smem_bytes(rg, c, n, stages))


@functools.lru_cache(maxsize=None)
def ln_gemm_plan(dtype: torch.dtype, m: int, c: int, f: int, n_w: int,
                 sms: int = SMS) -> LnGemmPlan:
    """The route and launch plan of `ln_gemm` (n_w = 1) or `ln_gemm3`
    (n_w = 3) for x with m rows of c `dtype` values and weights of f rows, on
    a card with `sms` multiprocessors (the shape must pass the `*_supported`
    gate).

    "mma": bf16 with c % 64 == 0. Tiles of n = 160 columns where 160 divides
    f (the UNet's f = 320, 640, 1280 and 3·c), else 64; 128 rows a block (two
    warpgroups share every staged weight tile) where that fits in shared
    memory with a ring of at least three stages (c = 320), else 64; a
    ring as deep as shared memory allows, up to four stages (two at c = 1280
    with n = 160). The first of these in the order (n, then rows) whose grid
    of row tiles × column groups covers the card is taken; where none does,
    the one with the most blocks. "wmma": the other bf16 widths, "fma": fp32,
    both a block per 64 / 16 rows walking every column."""
    if dtype == torch.float32 or c % 64:
        rows = 16 if dtype == torch.float32 else ROW_TILE
        tiles = n_w * f // 16
        return LnGemmPlan("fma" if dtype == torch.float32 else "wmma", rows, 0, tiles, 1, tiles,
                          m // rows, 0, 0, 0)
    widths = [n for n in MMA_WIDTHS if f % n == 0 or n == MMA_WIDTHS[-1]]
    candidates = [(n, rg) for n in widths for rg in (2, 1)
                  if not (rg == 2 and mma_smem_bytes(2, c, n, 3) > SMEM_MAX)]
    plans = [p for n, rg in candidates for p in (_mma_plan(m, c, f, n_w, sms, n, rg),) if p]
    return next((p for p in plans if p.blocks >= sms), None) or max(plans, key=lambda p: p.blocks)


def ln_gemm_block_columns(plan: LnGemmPlan, f: int, block: int) -> List[Tuple[int, int, int]]:
    """The output columns block `block` of an "mma" plan writes, as (weight
    index, first column, end column) per column tile, in the kernel's order
    (a pure-Python mirror of ln_gemm_mma_kernel's block → tile map and of
    its stores' clipping at column f)."""
    tiles_per_w = -(-f // plan.n)
    tile0 = (block % plan.groups) * plan.group_tiles
    out = []
    for tile in range(tile0, min(tile0 + plan.group_tiles, plan.tiles)):
        wi, col0 = divmod(tile, tiles_per_w)
        out.append((wi, col0 * plan.n, min((col0 + 1) * plan.n, f)))
    return out


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


def _refuse(name: str, x, scale, bias, ws) -> None:
    """Raise the error that names the first check of `_launch` the call fails."""
    c, f = x.shape[-1], ws[0].shape[0]
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
    raise AssertionError(f"{name}: a check of _launch failed that _refuse does not know")


def _launch(name: str, x, scale, bias, ws) -> Tuple[torch.Tensor, ...]:
    """One call on the card. Every check of `_refuse` is made here as one
    expression (the host's time per call is most of a small call's time);
    `_refuse` says which failed."""
    c, f, dt = x.shape[-1], ws[0].shape[0], x.dtype
    dev = x.get_device()
    ins = (x, scale, bias, *ws)
    ptrs = [t.data_ptr() for t in ins]
    if not (dev >= 0 and dt in _build.DTYPE_CODES and scale.dtype == torch.float32
            and bias.dtype == torch.float32 and scale.shape == (c,) and bias.shape == (c,)
            and all(t.get_device() == dev and t.is_contiguous() for t in ins)
            and all(w.dtype == dt and w.shape == (f, c) for w in ws)
            and _shape_ok(x, f) and not any(p % 16 for p in ptrs)):
        _refuse(name, x, scale, bias, ws)
    m = x.numel() // c
    plan = ln_gemm_plan(dt, m, c, f, len(ws), _sm_count(dev))
    outs = tuple(torch.empty(x.shape[:-1] + (f,), dtype=dt, device=x.device) for _ in ws)
    unused = [None] * (3 - len(ws))  # w1, w2, o1, o2 of a single weight
    args = (*ptrs, *unused, *(o.data_ptr() for o in outs), *unused, len(ws), m, c, f, EPS)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if plan.route == "mma":
        err = _entry("udt_ln_gemm_mma")(*args, plan.rows, plan.n, plan.group_tiles, plan.stages,
                                         stream)
    else:
        err = _entry("udt_ln_gemm")(*args, _build.DTYPE_CODES[dt], stream)
    if err:
        _build.check(err, f"{name} (route {plan.route})")
    wrapper = ln_gemm if len(ws) == 1 else ln_gemm3
    wrapper.launches += 1
    wrapper.last_route = plan.route
    wrapper.last_plan = plan
    return outs


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    return _build.kernel_function(name, _MMA_ARGTYPES if name.endswith("mma") else _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class _LnGemm(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward: the
    plain version run again under autograd, for the gradients asked for."""

    @staticmethod
    def forward(ctx, x, scale, bias, w):
        ctx.save_for_backward(x, scale, bias, w)
        if not x.is_cuda:
            return ln_gemm_ref(x, scale, bias, w)
        out, = _launch("ln_gemm", x, scale, bias, (w,))
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
        return _launch("ln_gemm3", x, scale, bias, (wq, wk, wv))

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


for _wrapper in (ln_gemm, ln_gemm3):
    _wrapper.launches = 0
    # the route and plan of the latest launch, for the tests and the smoke run
    _wrapper.last_route = None
    _wrapper.last_plan = None
