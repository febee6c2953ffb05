"""Fused GroupNorm (+ SiLU): the hand-written CUDA kernel and its plain version.

The kernel (csrc/groupnorm.cu) replaces the Pallas TPU kernel
`udifftext_tpu/ops/groupnorm.py` `fused_groupnorm_silu` / `_gn_kernel`.
`fused_groupnorm_silu` launches it for CUDA tensors (or raises on what it
does not take) and runs the plain PyTorch version,
`fused_groupnorm_silu_ref`, for CPU tensors. Like the JAX function it is
forward-only (that one has no custom VJP): asked for a gradient, it raises.

`models.layers.GroupNorm32` launches the kernel (with the SiLU that follows
it folded in where the models have one) where `kernel_takes`, the one check
of a call, holds, through `launch`, which checks nothing again: every GroupNorm of the UNet and the autoencoder in sampling,
serving and the frozen encodes of fine-tuning. `scripts/resblock_probe.py`
times it against the eager `GroupNorm32.plain` + `F.silu`.

Layout: x (B, H, W, C) or (B, N, C), channels last and contiguous; scale and
bias (C,) fp32. Statistics are fp32 per (sample, group of C/num_groups adjacent
channels) with the centered variance of `GroupNorm32` (the TPU kernel's
E[x²] − mean² cancels under a large common offset), the affine and SiLU run on
the fp32 value, and the result is rounded once to x's dtype.

Bound on an H100: x read once and y written once over 3.35 TB/s, 0.050 ms at
(32, 64, 64, 320) bf16.

Routes (`groupnorm_plan`, a pure function of the shape): "cluster", one
launch in which a thread-block cluster holds one (sample, slice of whole
groups) in shared memory, x read once; "stream", two launches over one grid
of (row chunk, slab of whole groups, sample) blocks (Welford statistics of
each block's rows, at most `MAX_CHUNKS` centered partials a (sample, group);
then every block merges its partials in chunk order and normalizes its rows,
x read twice), for a (sample, slice) that no cluster of 8 CTAs holds or holds
only as a slice narrower than `MIN_CLUSTER_SLICE_BYTES` or in CTAs too large
for two an SM (the autoencoder's largest fp32 levels). A CUDA tensor takes
the route its shape names; none gives way to the other or to the plain
version. `fused_groupnorm_silu.last_route` and `.last_plan` report the
latest launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build

_STREAM_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# x, scale, bias, partial, y, B, N, C, G, slice_groups, rows_per_chunk, eps, with_silu, dtype,
# stream
_CLUSTER_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# x, scale, bias, y, B, N, C, G, slice_groups, cluster, rows_per_cta, eps, with_silu, dtype,
# stream

MAX_C = 4096       # one fp32 per channel of a block's column sums in shared memory
MAX_GROUPS = 256
MAX_BATCH = 65535  # the grid's last dimension

# route "stream" (csrc/groupnorm.cu gn_stream_stats_kernel, gn_stream_apply_kernel)
MAX_CHUNKS = 64            # partials of a (sample, group) that every apply block merges in order
STREAM_BLOCKS_PER_SM = 4   # the grid the plan aims at: four 256-thread blocks an SM
MIN_SLAB_BYTES = 128       # a slab narrower than the row reads under 128 bytes a row no further
MIN_CLUSTER_SLICE_BYTES = 32  # a cluster slice narrower than this reads half its sectors

# route "cluster" (csrc/groupnorm.cu gn_cluster_kernel)
THREADS = 256
MAX_CLUSTER = 8          # the portable limit of a thread-block cluster
SMEM_MAX = 232448        # dynamic shared memory one block may opt in to (227 KB)
SMEM_SM = 233472         # a multiprocessor's shared memory (228 KB), 1 KB of it kept per block
MAX_SLICE_BYTES = 2048   # a row of the slice: at most THREADS / 2 vectors of 16 bytes
SMS = 132                # the H100's multiprocessors, for the plan's grid target


class GroupNormPlan(NamedTuple):
    """How one call is cut: the route; the groups of a slice (a slab on
    "stream"); for "cluster" the CTAs of a cluster, the rows a CTA holds and
    its bytes of shared memory (for "stream" 0, the rows of a chunk, and 0);
    device launches; the partial statistics of a (sample, group) that are
    merged (the cluster's CTAs, or the chunks of a sample)."""
    route: str
    slice_groups: int
    cluster: int
    rows: int
    smem_bytes: int
    launches: int
    partials: int


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
    with `sms` multiprocessors (the shape must pass `groupnorm_silu_supported`):
    `cluster_plan`'s when it has one whose slice is at least
    `MIN_CLUSTER_SLICE_BYTES` a row and whose CTAs an SM holds two of (one
    loads while the other computes), else `stream_plan`'s. On the H100 the
    cluster lost to the stream 2.8× at a 16-byte slice ((16, 256², 128)
    fp32) and 1.1× with one CTA an SM ((16, 128², 512) fp32), and won
    1.2× at a 64-byte slice with three ((16, 64², 512) fp32)."""
    plan = cluster_plan(dtype, b, n, c, num_groups, sms)
    esize = torch.empty((), dtype=dtype).element_size()
    if (plan is not None and blocks_per_sm(plan.smem_bytes) >= 2
            and plan.slice_groups * (c // num_groups) * esize >= MIN_CLUSTER_SLICE_BYTES):
        return plan
    return stream_plan(dtype, b, n, c, num_groups, sms)


def cluster_plan(dtype: torch.dtype, b: int, n: int, c: int, num_groups: int = 32,
                 sms: int = SMS) -> Optional[GroupNormPlan]:
    """Route "cluster": a slice of S whole groups (S divides num_groups, the
    slice a multiple of 16 bytes and at most 2 KB a row) and a cluster of
    K <= 8 CTAs that split the n rows, every CTA at least one row and its copy
    within 227 KB; None when no slice fits. Of all (S, K) the plan takes the
    one whose grid b·(G/S)·K comes closest to two CTAs for each SM, then the
    one whose CTAs an SM holds most of, up to four (a CTA computes on its
    copy or writes while the others load: it has no other overlap), then the
    widest slice, then the fewest CTAs a cluster."""
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
                best, best_key = GroupNormPlan("cluster", s, k, rows, smem, 1, k), key
    return best


def stream_plan(dtype: torch.dtype, b: int, n: int, c: int, num_groups: int = 32,
                sms: int = SMS) -> GroupNormPlan:
    """Route "stream": slabs of S whole groups (S divides num_groups, the slab a
    multiple of 16 bytes; narrower than the row only down to
    `MIN_SLAB_BYTES`) and P <= `MAX_CHUNKS` chunks of ceil(n / P) rows a
    sample, every chunk at least one row. The widest slab whose grid
    b·(G/S)·P reaches half of `STREAM_BLOCKS_PER_SM` blocks an SM, P the
    fewest that aim at all of them; else the narrowest slab, the largest
    grid. Two launches."""
    esize = torch.empty((), dtype=dtype).element_size()
    vec, cg = 16 // esize, c // num_groups
    target = STREAM_BLOCKS_PER_SM * sms
    plan = None
    for s in range(num_groups, 0, -1):
        width = s * cg
        if num_groups % s or width % vec or (s < num_groups and width * esize < MIN_SLAB_BYTES):
            continue
        slabs = num_groups // s
        chunks = max(1, min(MAX_CHUNKS, n, -(-target // (b * slabs))))
        rows = -(-n // chunks)
        chunks = -(-n // rows)
        plan = GroupNormPlan("stream", s, 0, rows, 0, 2, chunks)
        if 2 * b * slabs * chunks >= target:
            break
    return plan


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


def _chan_merge(a, b):
    """Chan's update of (n, mean, M2) a with the disjoint part b (csrc's
    `chan_merge`): a part of no elements changes nothing."""
    (na, ma, m2a), (nb, mb, m2b) = a, b
    if nb == 0:
        return a
    tot = na + nb
    delta = mb - ma
    w = nb / tot
    return tot, ma + delta * w, m2a + m2b + delta * delta * (na * w)


def fused_groupnorm_silu_stream_ref(x, scale, bias, num_groups: int = 32, eps: float = 1e-5,
                                    with_silu: bool = True,
                                    plan: Optional[GroupNormPlan] = None) -> torch.Tensor:
    """The "stream" route's order of operations in plain PyTorch (tests only,
    on either device), on `plan` or `stream_plan`'s: in each chunk of
    `plan.rows` rows and slab of `plan.slice_groups` groups, a thread row t of
    the block (256 threads over 16-byte vectors of the slab) keeps a Welford
    (mean, M2) per channel over rows t, t + ty_n, ...; per group the entries
    (t, channel) are merged with Chan's update, entry e by lane e mod 32 in
    order, then the lanes down a shuffle tree to lane 0; the chunks merged in
    order; then the kernel's fused normalize (x − mean)·(rstd·scale) + bias,
    SiLU and one rounding."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.reshape(b, -1, c).float()
    n, g_all = xf.shape[1], num_groups
    cg = c // g_all
    if plan is None:
        plan = stream_plan(x.dtype, b, n, c, num_groups)
    width = plan.slice_groups * cg
    vr = width // (16 // x.element_size())
    ty_n = THREADS // min(vr, THREADS)
    total = None
    for r0 in range(0, n, plan.rows):
        part = xf[:, r0:r0 + plan.rows]
        rows = part.shape[1]
        mean = torch.zeros(b, ty_n, c, device=x.device)
        m2 = torch.zeros_like(mean)
        for k, r in enumerate(range(0, rows, ty_n)):
            blk = part[:, r:r + ty_n]
            m = blk.shape[1]
            d = blk - mean[:, :m]
            mean[:, :m] = mean[:, :m] + d * (1.0 / (k + 1))
            m2[:, :m] = m2[:, :m] + d * (blk - mean[:, :m])
        visits = [max(0, -(-(rows - t) // ty_n)) for t in range(ty_n)]
        # entries of group g: e = t·cg + i for thread row t and its channel g·cg + i
        e_mean = mean.reshape(b, ty_n, g_all, cg).permute(0, 2, 1, 3).reshape(b, g_all, -1)
        e_m2 = m2.reshape(b, ty_n, g_all, cg).permute(0, 2, 1, 3).reshape(b, g_all, -1)
        zero = torch.zeros(b, g_all, device=x.device)
        lanes = []
        for lane in range(32):
            st = (0.0, zero, zero)
            for e in range(lane, ty_n * cg, 32):
                st = _chan_merge(st, (float(visits[e // cg]), e_mean[..., e], e_m2[..., e]))
            lanes.append(st)
        for off in (16, 8, 4, 2, 1):
            lanes = [_chan_merge(lanes[i], lanes[i + off]) for i in range(off)]
        chunk = (float(rows * cg), lanes[0][1], lanes[0][2])
        total = chunk if total is None else _chan_merge(total, chunk)
    _, mean, m2 = total
    rstd = torch.rsqrt(m2 / (n * cg) + eps)
    a = (rstd.repeat_interleave(cg, dim=1) * scale.float())[:, None]
    y = (xf - mean.repeat_interleave(cg, dim=1)[:, None]) * a + bias.float()
    if with_silu:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def shape_supported(dtype: torch.dtype, shape, num_groups: int = 32) -> bool:
    """Whether the CUDA kernel takes x of `dtype` and `shape`: bf16 or fp32,
    (B, N, C) or (B, H, W, C) with at least one row, C % num_groups == 0,
    C % 8 == 0 (16-byte vector loads along C), C <= 4096, num_groups <= 256,
    B <= 65535. These are the CUDA kernel's own limits; the TPU kernel's were
    a 4 MiB sample."""
    if dtype not in _build.DTYPE_CODES or len(shape) not in (3, 4) or 0 in shape:
        return False
    c = shape[-1]
    return (0 < num_groups <= MAX_GROUPS and c % num_groups == 0 and c % 8 == 0
            and c <= MAX_C and shape[0] <= MAX_BATCH)


def groupnorm_silu_supported(x: torch.Tensor, num_groups: int = 32) -> bool:
    """`shape_supported` of x."""
    return shape_supported(x.dtype, tuple(x.shape), num_groups)


def groupnorm_gate(is_cuda: bool, dtype: torch.dtype, shape, contiguous: bool, aligned: bool,
                   records_grad: bool, num_groups: int = 32) -> bool:
    """Whether `GroupNorm32` runs on the kernel, from what it sees of a call:
    x on a CUDA device (with fp32 scale and bias on the same one), its dtype
    and shape within `shape_supported`'s limits, x, scale and bias
    contiguous and 16-byte aligned, and no gradient to record (the kernel is
    forward-only)."""
    return (is_cuda and not records_grad and contiguous and aligned
            and shape_supported(dtype, shape, num_groups))


def kernel_takes(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 num_groups: int = 32) -> bool:
    """`groupnorm_gate` of a call, with scale and bias fp32 (C,) on x's
    device: True exactly when autograd would not record the call and the
    kernel takes these tensors. The one check before `launch`."""
    if not (x.is_cuda and scale.dtype == torch.float32 and bias.dtype == torch.float32
            and scale.device == x.device == bias.device and scale.shape == bias.shape
            and scale.shape == (x.shape[-1],)):
        return False
    return groupnorm_gate(
        True, x.dtype, tuple(x.shape),
        x.is_contiguous() and scale.is_contiguous() and bias.is_contiguous(),
        not (x.data_ptr() | scale.data_ptr() | bias.data_ptr()) % 16,
        torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                     or bias.requires_grad),
        num_groups)


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    return _build.kernel_function(name, _CLUSTER_ARGTYPES if name.endswith("cluster")
                                  else _STREAM_ARGTYPES)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _refuse(x, scale, bias, num_groups: int) -> None:
    """Raise with the reason `kernel_takes` refused a CUDA call."""
    name = "fused_groupnorm_silu"
    c = x.shape[-1]
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        raise RuntimeError(f"{name} is forward-only (no backward is defined): call it under "
                           "torch.no_grad() or on tensors that do not require grad")
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


def launch(x, scale, bias, num_groups: int, eps: float, with_silu: bool) -> torch.Tensor:
    """One call on the card, on tensors `kernel_takes` took: it checks
    nothing again (the host's time is most of a small call's time). Adds one
    to `fused_groupnorm_silu.launches`."""
    c, b = x.shape[-1], x.shape[0]
    dev = x.get_device()
    xp, sp, bp = x.data_ptr(), scale.data_ptr(), bias.data_ptr()
    n = x.numel() // (b * c)
    plan = groupnorm_plan(x.dtype, b, n, c, num_groups, _sm_count(dev))
    y = torch.empty_like(x)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if plan.route == "cluster":
        err = _entry("udt_groupnorm_silu_cluster")(
            xp, sp, bp, y.data_ptr(), b, n, c, num_groups, plan.slice_groups, plan.cluster,
            plan.rows, float(eps), int(with_silu), _build.DTYPE_CODES[x.dtype], stream)
    else:
        partial = torch.empty((b, plan.partials, num_groups, 2), dtype=torch.float32,
                              device=x.device)
        err = _entry("udt_groupnorm_silu_stream")(
            xp, sp, bp, partial.data_ptr(), y.data_ptr(), b, n, c, num_groups,
            plan.slice_groups, plan.rows, float(eps), int(with_silu),
            _build.DTYPE_CODES[x.dtype], stream)
    if err:
        _build.check(err, f"fused_groupnorm_silu (route {plan.route})")
    fused_groupnorm_silu.launches += 1
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
    `.launches` counts calls that reached the card, `GroupNorm32`'s
    included: one device launch each on route "cluster" (`gn_cluster`), two
    on "stream" (`gn_stream_stats`, then `gn_stream_apply`); `.last_route`
    and `.last_plan` describe the latest."""
    if x.is_cuda and kernel_takes(x, scale, bias, num_groups):
        return launch(x, scale, bias, num_groups, eps, with_silu)
    if not x.is_cuda and not (torch.is_grad_enabled() and (
            x.requires_grad or scale.requires_grad or bias.requires_grad)):
        return fused_groupnorm_silu_ref(x, scale, bias, num_groups, eps, with_silu)
    _refuse(x, scale, bias, num_groups)


fused_groupnorm_silu.launches = 0
fused_groupnorm_silu.last_route = None
fused_groupnorm_silu.last_plan = None
