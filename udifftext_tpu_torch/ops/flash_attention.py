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
lse (B, H, Nq) fp32 (log-sum-exp of the scaled logits in natural-log units,
which the backward reads to rebuild p = exp(s·scale − lse)). The TPU backward
rebuilt p from a max-free denominator with logits clamped at ±75; the two
agree wherever |logits| < 75.

Routes (`flash_kernel_route`): each source holds two hand-written kernels.
- "mma": bf16 with D = 64, every shape the UNet runs. All products run on
  the tensor cores (`wgmma`), the score-shaped tiles (s, p, dP, ds) stay in
  registers, p and ds are rounded to bf16 before the second product, and
  K/V (in the backward's second pass Q/dO) arrive through a `cp.async` ring
  in shared memory. The forward takes `BLOCK_Q` = 128 query rows a block
  against `BLOCK` = 64 keys a tile; the backward 128 rows a block in both
  passes against 64-row tiles. 16-byte copies need every tensor's address
  and its batch, token and head strides to be multiples of 16 bytes
  (`aligned16`); the wrappers raise `ValueError` otherwise and never copy.
- "fma": fp32 (D = 64 or 128) and bf16 with D = 128 (no caller in the UNet):
  fp32 FMAs from fp32 tiles in shared memory, 64 rows by 64 keys, any
  alignment.
Nq and Nk are multiples of `BLOCK` on both routes. A CUDA tensor that no
route takes raises; no route gives way to another or to the plain version.

`flash_attention_tiled_ref` / `flash_attention_bwd_tiled_ref` walk the tiles
as the "mma" kernels do, roundings included; the tests hold them against the
plain versions to settle what that rounding costs.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build

_ARGTYPES = (
    [ctypes.c_void_p] * 5                     # q, k, v, o, lse
    + [ctypes.c_int] * 5                      # B, H, Nq, Nk, D
    + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)  # strides, scale, dtype, route, stream
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 10                    # q, k, v, o, dout, lse, delta, dq, dk, dv
    + [ctypes.c_int] * 5                      # B, H, Nq, Nk, D
    + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)  # strides, scale, dtype, route, stream

BLOCK = 64     # keys (backward pass 2: query rows) per tile; Nq and Nk are multiples of it
BLOCK_Q = 128  # rows a block of the "mma" kernels owns (two warpgroups of 64)
ROUTE_CODES = {"fma": 0, "mma": 1}  # as the C entry points read them
LOG2E = 1.4426950408889634


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


def flash_attention_tiled_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
    bq: int = BLOCK_Q, bk: int = BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward as the "mma" kernel walks it, in plain PyTorch (tests
    only, on either device): per `bq` query rows a loop over `bk`-key tiles
    with fp32 logits t = s·(scale·log2 e), a running max and sum,
    p = exp2(t − m) summed in fp32 and rounded to the input dtype before p·v,
    an fp32 accumulator rescaled by exp2(m_old − m_new), one rounding of
    acc / l, and lse = (m + log2 l)·ln 2."""
    c = _scale(q.shape[-1], scale) * LOG2E
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, N, D)
    b, h, nq, d = qf.shape
    out = torch.empty((b, h, nq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    for q0 in range(0, nq, bq):
        qt = qf[:, :, q0:q0 + bq]
        m = torch.full(qt.shape[:-1], -float("inf"), device=q.device)
        l = torch.zeros(qt.shape[:-1], device=q.device)
        acc = torch.zeros(qt.shape, device=q.device)
        for k0 in range(0, kf.shape[2], bk):
            t = (qt @ kf[:, :, k0:k0 + bk].transpose(-1, -2)) * c
            m_new = torch.maximum(m, t.amax(-1))
            p = torch.exp2(t - m_new[..., None])
            alpha = torch.exp2(m - m_new)  # 0 on the first tile
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.to(q.dtype).float() @ vf[:, :, k0:k0 + bk]
            m = m_new
        out[:, :, q0:q0 + bq] = acc / l[..., None]
        lse[:, :, q0:q0 + bq] = (m + torch.log2(l)) / LOG2E
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def flash_attention_bwd_tiled_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, scale: Optional[float] = None, bq: int = BLOCK, bk: int = BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward as the "mma" kernels walk it, in plain PyTorch (tests
    only, on either device), in two passes that both rebuild
    p = exp2(s·scale·log2 e − lse·log2 e) per (`bq` rows, `bk` keys) tile.
    Pass 1 sums dq over the key tiles from ds = p ⊙ (dO·vᵀ − delta) rounded to
    the input dtype; pass 2 builds the transposed tiles k·qᵀ and v·dOᵀ and sums
    dv from pᵀ and dk from dsᵀ, both rounded to the input dtype, over the query
    tiles. fp32 accumulators, one rounding of each gradient."""
    sc = _scale(q.shape[-1], scale)
    c = sc * LOG2E
    qf, kf, vf, of, gf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, out, dout))
    lse2 = lse.float() * LOG2E                # (B, H, Nq)
    delta = (gf * of).sum(-1)                 # (B, H, Nq)
    nq, nk = qf.shape[2], kf.shape[2]
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, nq, bq):               # pass 1: dq
        rows = slice(q0, q0 + bq)
        for k0 in range(0, nk, bk):
            kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
            p = torch.exp2((qf[:, :, rows] @ kt.transpose(-1, -2)) * c - lse2[:, :, rows, None])
            ds = p * (gf[:, :, rows] @ vt.transpose(-1, -2) - delta[:, :, rows, None])
            dq[:, :, rows] += ds.to(q.dtype).float() @ kt
    for k0 in range(0, nk, bk):               # pass 2: dk, dv from the transposed tiles
        keys = slice(k0, k0 + bk)
        for q0 in range(0, nq, bq):
            qt, gt = qf[:, :, q0:q0 + bq], gf[:, :, q0:q0 + bq]
            pt = torch.exp2((kf[:, :, keys] @ qt.transpose(-1, -2)) * c
                            - lse2[:, :, None, q0:q0 + bq])
            dst = pt * (vf[:, :, keys] @ gt.transpose(-1, -2) - delta[:, :, None, q0:q0 + bq])
            dv[:, :, keys] += pt.to(q.dtype).float() @ gt
            dk[:, :, keys] += dst.to(q.dtype).float() @ qt
    return tuple((g * s_).permute(0, 2, 1, 3).to(t.dtype)
                 for g, s_, t in ((dq, sc, q), (dk, sc, k), (dv, 1.0, v)))


def flash_kernel_route(dtype: torch.dtype, d: int) -> str:
    """Which hand-written kernel serves (dtype, head size) on the card:
    "mma" (tensor cores, bf16 with D = 64) or "fma" (fp32 FMAs: fp32, and
    bf16 with D = 128). Raises on what neither takes."""
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash attention: dtype {dtype} not supported (bf16 or fp32)")
    if d not in (64, 128):
        raise ValueError(f"flash attention: needs D in (64, 128), got D={d}")
    return "mma" if dtype == torch.bfloat16 and d == 64 else "fma"


def aligned16(address: int, strides: Sequence[int], itemsize: int) -> bool:
    """Whether 16-byte copies of whole rows are possible: the first element's
    byte address and every stride but the last (in elements, as
    `Tensor.stride()` gives them) are multiples of 16 bytes, and the last
    dimension is contiguous."""
    return (address % 16 == 0 and strides[-1] == 1
            and all((s * itemsize) % 16 == 0 for s in strides[:-1]))


def _check_aligned(name: str, **tensors: torch.Tensor) -> None:
    for label, t in tensors.items():
        if not aligned16(t.data_ptr(), t.stride(), t.element_size()):
            raise ValueError(f"{name}: {label} must start on a 16-byte boundary with batch, token "
                             f"and head strides that are multiples of 16 bytes, got offset "
                             f"{t.data_ptr() % 16} and strides {t.stride()}")


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Raise on what no kernel takes; else the route that serves q, k, v."""
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
    route = flash_kernel_route(q.dtype, d)
    if route == "mma":
        _check_aligned(name, q=q, k=k, v=v)
    return route


def _flash_fwd(q, k, v, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's launch (CUDA) or its plain version (CPU)."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, scale)
    route = _check_qkv("flash_attention", q, k, v)
    b, nq, h, d = q.shape
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _build.kernel_function("udt_flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
             b, h, nq, k.shape[1], d, ctypes.cast(strides, ctypes.c_void_p), _scale(d, scale),
             _build.DTYPE_CODES[q.dtype], ROUTE_CODES[route], _build.stream_handle(q))
    _build.check(err, "udt_flash_attention_fwd")
    flash_attention.launches += 1
    flash_attention.last_route = route
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
    route = _check_qkv("flash_attention_bwd", q, k, v)
    b, nq, h, d = q.shape
    nk = k.shape[1]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"flash_attention_bwd: {name} must match q's shape, dtype and "
                             f"device with a contiguous head dimension, got {tuple(t.shape)} "
                             f"{t.dtype} {t.device} strides {t.stride()}")
    if route == "mma":
        _check_aligned("flash_attention_bwd", out=out, dout=dout, lse=lse)
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
             _build.DTYPE_CODES[q.dtype], ROUTE_CODES[route], _build.stream_handle(q))
    _build.check(err, "udt_flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.last_route = route
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
# the route of each wrapper's latest launch, for the tests and the smoke run
flash_attention.last_route = None
flash_attention_bwd.last_route = None
