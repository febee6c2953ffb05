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
(32, 64, 64, 320) bf16.

Routes (`groupnorm_plan`, a pure function of the shape): "cluster", one
launch in which a thread-block cluster holds one (sample, slice of whole
groups) in shared memory, x read once; "two_pass" (the first-cut kernels: statistics,
then normalize, x read twice) for a (sample, slice) that no cluster of 8 CTAs
holds. A CUDA tensor takes the route its shape names; none gives way to the
other or to the plain version. `fused_groupnorm_silu.last_route` and
`.last_plan` report the latest launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# x, scale, bias, partial, y, B, N, C, G, rows_per_chunk, eps, with_silu, dtype, stream
_CLUSTER_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# x, scale, bias, y, B, N, C, G, slice_groups, cluster, rows_per_cta, eps, with_silu, dtype,
# stream

MAX_C = 4096       # one fp32 per channel of a block's column sums in shared memory
MAX_GROUPS = 256
MAX_BATCH = 65535  # the grid's second dimension
_FILL_BLOCKS = 2 * 132  # two blocks for each of the H100's SMs
MAX_CHUNKS = 64         # partial statistics of a sample that every block merges in order

# route "cluster" (csrc/groupnorm.cu gn_cluster_kernel)
THREADS = 256
MAX_CLUSTER = 8          # the portable limit of a thread-block cluster
SMEM_MAX = 232448        # dynamic shared memory one block may opt in to (227 KB)
SMEM_SM = 233472         # a multiprocessor's shared memory (228 KB), 1 KB of it kept per block
MAX_SLICE_BYTES = 2048   # a row of the slice: at most THREADS / 2 vectors of 16 bytes
SMS = 132                # the H100's multiprocessors, for the plan's grid target


class GroupNormPlan(NamedTuple):
    """How one call is cut: the route; for "cluster" the groups of a slice,
    the CTAs of a cluster, the rows a CTA holds and its bytes of shared
    memory (for "two_pass" the rows of a chunk, and 0); device launches."""
    route: str
    slice_groups: int
    cluster: int
    rows: int
    smem_bytes: int
    launches: int


def cluster_smem_bytes(rows: int, width: int, esize: int, slice_groups: int) -> int:
    """A cluster CTA's dynamic shared memory (csrc/groupnorm.cu
    `ClusterLayout`): its copy of rows × width elements (padded to 16 bytes),
    the column sums of 256 threads × one 16-byte vector in fp32, and two fp32
    pairs a group."""
    vec = 16 // esize
    return -(-rows * width * esize // 16) * 16 + THREADS * vec * 4 + 2 * slice_groups * 8


def blocks_per_sm(smem_bytes: int) -> int:
    """CTAs of `smem_bytes` dynamic shared memory one multiprocessor holds."""
    return SMEM_SM // (smem_bytes + 1024)


@functools.lru_cache(maxsize=None)
def groupnorm_plan(dtype: torch.dtype, b: int, n: int, c: int, num_groups: int = 32,
                   sms: int = SMS) -> GroupNormPlan:
    """The route of `fused_groupnorm_silu` for x (b, n, c) of `dtype` on a card
    with `sms` multiprocessors (the shape must pass `groupnorm_silu_supported`).

    "cluster": a slice of S whole groups (S divides num_groups, the slice a
    multiple of 16 bytes and at most 2 KB a row) and a cluster of K <= 8 CTAs
    that split the n rows, every CTA at least one row and its copy within
    227 KB. Of all (S, K) the plan takes the one whose grid b·(G/S)·K comes
    closest to two CTAs for each SM, then the one whose CTAs an SM holds
    most of, up to four (a CTA computes on its copy or writes while the
    others load: it has no other overlap), then the widest slice, then the
    fewest CTAs a cluster. "two_pass" when no slice fits a cluster of 8:
    `rows_per_chunk` rows a block, two launches."""
    esize = torch.empty((), dtype=dtype).element_size()
    vec = 16 // esize
    cg = c // num_groups
    target = 2 * sms
    best, best_key = None, None
    for s in range(num_groups, 0, -1):
        width = s * cg
        if num_groups % s or width % vec or width * esize > MAX_SLICE_BYTES:
            continue
        for k in range(1, min(MAX_CLUSTER, n) + 1):
            rows = -(-n // k)
            k = -(-n // rows)  # every CTA holds at least one row
            smem = cluster_smem_bytes(rows, width, esize, s)
            if smem > SMEM_MAX:
                continue
            key = (min(b * (num_groups // s) * k, target), min(4, blocks_per_sm(smem)), width, -k)
            if best_key is None or key > best_key:
                best, best_key = GroupNormPlan("cluster", s, k, rows, smem, 1), key
    if best is not None:
        return best
    return GroupNormPlan("two_pass", 0, 0, rows_per_chunk(b, n), 0, 2)


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


def fused_groupnorm_silu_cluster_ref(x, scale, bias, num_groups: int = 32, eps: float = 1e-5,
                                     with_silu: bool = True, parts: int = 4) -> torch.Tensor:
    """The "cluster" route's order of operations in plain PyTorch (tests
    only, on either device): each sample's rows cut into `parts` runs of
    ceil(n / parts) rows, as a cluster's CTAs hold them; per run and group the
    fp32 mean and the M2 about that mean; the runs merged in order with
    Chan's update; then the plain version's affine, SiLU and one rounding."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.reshape(b, -1, num_groups, c // num_groups).float()
    n = xf.shape[1]
    rows = -(-n // parts)
    count = mean = m2 = None
    for r0 in range(0, n, rows):
        part = xf[:, r0:r0 + rows]
        nk = float(part.shape[1] * part.shape[3])
        mk = part.sum(dim=(1, 3)) / nk
        m2k = (part - mk[:, None, :, None]).square().sum(dim=(1, 3))
        if count is None:
            count, mean, m2 = nk, mk, m2k
            continue
        tot = count + nk
        delta = mk - mean
        mean = mean + delta * (nk / tot)
        m2 = m2 + m2k + delta * delta * (count * nk / tot)
        count = tot
    rstd = torch.rsqrt(m2 / count + eps)
    y = ((xf - mean[:, None, :, None]) * rstd[:, None, :, None]).reshape(x.shape)
    y = y * scale.float() + bias.float()
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


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    return _build.kernel_function(name, _CLUSTER_ARGTYPES if name.endswith("cluster")
                                  else _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _refuse(x, scale, bias, num_groups: int) -> None:
    """Raise with the reason `_launch` does not take its arguments."""
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
    if not (x.is_contiguous() and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"{name}: x (channels last), scale and bias must be contiguous")
    raise ValueError(f"{name}: tensors must start at 16-byte aligned addresses")


def _launch(x, scale, bias, num_groups: int, eps: float, with_silu: bool) -> torch.Tensor:
    """One call on the card. Every check of `_refuse` is made here as one
    expression (the host's time per call is most of a small call's time);
    `_refuse` says which failed."""
    c, b = x.shape[-1], x.shape[0]
    dev = x.get_device()
    xp, sp, bp = x.data_ptr(), scale.data_ptr(), bias.data_ptr()
    if not (dev >= 0 and scale.get_device() == dev and bias.get_device() == dev
            and x.dtype in _build.DTYPE_CODES and scale.dtype == torch.float32
            and bias.dtype == torch.float32 and scale.shape == (c,) and bias.shape == (c,)
            and groupnorm_silu_supported(x, num_groups) and x.is_contiguous()
            and scale.is_contiguous() and bias.is_contiguous() and not (xp | sp | bp) % 16):
        _refuse(x, scale, bias, num_groups)
    n = x.numel() // (b * c)
    plan = groupnorm_plan(x.dtype, b, n, c, num_groups, _sm_count(dev))
    y = torch.empty_like(x)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if plan.route == "cluster":
        err = _entry("udt_groupnorm_silu_cluster")(
            xp, sp, bp, y.data_ptr(), b, n, c, num_groups, plan.slice_groups, plan.cluster,
            plan.rows, float(eps), int(with_silu), _build.DTYPE_CODES[x.dtype], stream)
    else:
        partial = torch.empty((b, -(-n // plan.rows), num_groups, 2), dtype=torch.float32,
                              device=x.device)
        err = _entry("udt_groupnorm_silu")(
            xp, sp, bp, partial.data_ptr(), y.data_ptr(), b, n, c, num_groups, plan.rows,
            float(eps), int(with_silu), _build.DTYPE_CODES[x.dtype], stream)
    if err:
        _build.check(err, f"fused_groupnorm_silu (route {plan.route})")
    fused_groupnorm_silu.last_route = plan.route
    fused_groupnorm_silu.last_plan = plan
    return y


def fused_groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         num_groups: int = 32, eps: float = 1e-5,
                         with_silu: bool = True) -> torch.Tensor:
    """GroupNorm over groups of adjacent channels of channels-last x, then
    SiLU unless `with_silu` is false; same shape and dtype as x. CUDA tensors
    launch the kernel (or raise on what it does not take); CPU tensors take
    the plain version. Forward-only: raises if a gradient is asked through it.
    `.launches` counts calls that reached the card: one device launch each
    on route "cluster" (`gn_cluster`), two on "two_pass" (`gn_stats`, then
    `gn_apply`); `.last_route` and `.last_plan` describe the latest."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        raise RuntimeError("fused_groupnorm_silu is forward-only (no backward is defined): call "
                           "it under torch.no_grad() or on tensors that do not require grad")
    if not x.is_cuda:
        return fused_groupnorm_silu_ref(x, scale, bias, num_groups, eps, with_silu)
    y = _launch(x, scale, bias, num_groups, eps, with_silu)
    fused_groupnorm_silu.launches += 1
    return y


fused_groupnorm_silu.launches = 0
fused_groupnorm_silu.last_route = None
fused_groupnorm_silu.last_plan = None
