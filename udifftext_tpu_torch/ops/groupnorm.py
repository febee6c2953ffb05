"""Fused GroupNorm (+ SiLU): the hand-written CUDA kernel and its plain version.

The kernel (csrc/groupnorm.cu) replaces the Pallas TPU kernel
`udifftext_tpu/ops/groupnorm.py` `fused_groupnorm_silu` / `_gn_kernel`.
`fused_groupnorm_silu` launches it for CUDA tensors (or raises on what it
does not take) and runs the plain PyTorch version,
`fused_groupnorm_silu_ref`, for CPU tensors. Like the JAX function it is
forward-only (that one has no custom VJP): asked for a gradient, it raises.

No model calls it: the UNet and the VAE keep `GroupNorm32` + `F.silu`, as the
JAX models do; `scripts/resblock_probe.py` times the two against each other.

Layout: x (B, H, W, C) or (B, N, C), channels last and contiguous; scale and
bias (C,) fp32. Statistics are fp32 per (sample, group of C/num_groups adjacent
channels) with the centered variance of `GroupNorm32` (the TPU kernel's
E[x²] − mean² cancels under a large common offset), the affine and SiLU run on
the fp32 value, and the result is rounded once to x's dtype.

Bound on an H100: x read once and y written once over 3.35 TB/s, 0.050 ms at
(32, 64, 64, 320) bf16. The kernel reads x in two launches (statistics, then
normalize); above the 50 MB L2 the second read comes from device memory.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# x, scale, bias, partial, y, B, N, C, G, rows_per_chunk, eps, with_silu, dtype, stream

MAX_C = 4096       # one fp32 per channel of a block's column sums in shared memory
MAX_GROUPS = 256
MAX_BATCH = 65535  # the grid's second dimension
_FILL_BLOCKS = 2 * 132  # two blocks for each of the H100's SMs
MAX_CHUNKS = 64         # partial statistics of a sample that every block merges in order


def fused_groupnorm_silu_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                             num_groups: int = 32, eps: float = 1e-5,
                             with_silu: bool = True) -> torch.Tensor:
    """Plain PyTorch version at the kernel's rounding points: fp32 centered
    statistics, fp32 affine, SiLU on the fp32 value, one cast to x's dtype."""
    c = x.shape[-1]
    xf = x.reshape(x.shape[0], -1, num_groups, c // num_groups).float()
    xc = xf - xf.mean(dim=(1, 3), keepdim=True)
    var = xc.square().mean(dim=(1, 3), keepdim=True)
    y = (xc * torch.rsqrt(var + eps)).reshape(x.shape) * scale.float() + bias.float()
    if with_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def groupnorm_silu_supported(x: torch.Tensor, num_groups: int = 32) -> bool:
    """Whether the CUDA kernel takes x: bf16 or fp32, (B, N, C) or
    (B, H, W, C) with at least one row, C % num_groups == 0, C % 8 == 0 (16-byte
    vector loads along C), C <= 4096, num_groups <= 256, B <= 65535. These are
    the CUDA kernel's own limits; the TPU kernel's were a 4 MiB sample."""
    if x.dtype not in _build.DTYPE_CODES or x.ndim not in (3, 4) or x.numel() == 0:
        return False
    c = x.shape[-1]
    return (0 < num_groups <= MAX_GROUPS and c % num_groups == 0 and c % 8 == 0
            and c <= MAX_C and x.shape[0] <= MAX_BATCH)


def rows_per_chunk(b: int, n: int) -> int:
    """Rows of one sample that a block owns: 128, halved down to 16 while the
    grid of b·ceil(n / rows) blocks would leave SMs idle and a sample stays
    within `MAX_CHUNKS` chunks (every block of the second pass merges its
    sample's partial statistics one after the other)."""
    rows = 128
    while (rows > 16 and b * -(-n // rows) < _FILL_BLOCKS
           and -(-n // (rows // 2)) <= MAX_CHUNKS):
        rows //= 2
    return rows


def _launch(x, scale, bias, num_groups: int, eps: float, with_silu: bool) -> torch.Tensor:
    name = "fused_groupnorm_silu"
    c = x.shape[-1]
    if not (scale.is_cuda and bias.is_cuda and x.device == scale.device == bias.device):
        raise ValueError(f"{name}: x, scale and bias must be on one CUDA device")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: x must be bf16 or fp32, got {x.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"{name}: scale and bias must be fp32")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} and bias {tuple(bias.shape)} "
                         f"must be ({c},)")
    if not groupnorm_silu_supported(x, num_groups):
        raise ValueError(f"{name}: needs (B, N, C) or (B, H, W, C) with C % num_groups == 0, "
                         f"C % 8 == 0, C <= {MAX_C}, num_groups <= {MAX_GROUPS} and "
                         f"B <= {MAX_BATCH}; got x {tuple(x.shape)}, num_groups={num_groups}")
    ts = (x, scale, bias)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: x (channels last), scale and bias must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: tensors must start at 16-byte aligned addresses")
    b = x.shape[0]
    n = x.numel() // (b * c)
    rows = rows_per_chunk(b, n)
    partial = torch.empty((b, -(-n // rows), num_groups, 2), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    fn = _build.kernel_function("udt_groupnorm_silu", _ARGTYPES)
    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), partial.data_ptr(), y.data_ptr(),
             b, n, c, num_groups, rows, float(eps), int(with_silu),
             _build.DTYPE_CODES[x.dtype], _build.stream_handle(x))
    _build.check(err, "udt_groupnorm_silu")
    return y


def fused_groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         num_groups: int = 32, eps: float = 1e-5,
                         with_silu: bool = True) -> torch.Tensor:
    """GroupNorm over groups of adjacent channels of channels-last x, then
    SiLU unless `with_silu` is false; same shape and dtype as x. CUDA tensors
    launch the kernel (or raise on what it does not take); CPU tensors take
    the plain version. Forward-only: raises if a gradient is asked through it.
    `.launches` counts calls that reached the card; each is two device
    launches (`gn_stats`, then `gn_apply`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        raise RuntimeError("fused_groupnorm_silu is forward-only (no backward is defined): call "
                           "it under torch.no_grad() or on tensors that do not require grad")
    if not x.is_cuda:
        return fused_groupnorm_silu_ref(x, scale, bias, num_groups, eps, with_silu)
    y = _launch(x, scale, bias, num_groups, eps, with_silu)
    fused_groupnorm_silu.launches += 1
    return y


fused_groupnorm_silu.launches = 0
