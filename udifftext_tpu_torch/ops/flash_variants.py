"""Flash-attention forward variants for a layout probe: the hand-written CUDA
kernels and their plain versions.

The kernels (csrc/flash_variants.cu, one templated source) replace the Pallas
TPU kernels of `scripts/flash_variants.py`: `run_variant` → `_kernel_v2`
(with and without `clamp_exp`) and `_kernel_v3`, and `v1_fn`, which runs the
shipped TPU forward `_flash_kernel` at caller-chosen block sizes.

  v1  rows layout (s = q·kᵀ, acc += p·v), clamp 75: `_flash_kernel`'s
      function, output and log Σp (the log of its saved denominator `l`)
  v2  transposed layout (sᵀ = k·qᵀ, accᵀ += vᵀ·pᵀ), online max: softmax
  v3  rows layout, clamp 60
  v4  transposed layout, clamp 60

A clamped variant computes p = exp(clip(s·scale, −C, C)), out = Σp·v / Σp
with no running max: softmax while every logit stays inside ±C, a different
function past it. `VARIANTS` holds each variant's layout and clamp. The rows
layout with the online max is the shipped forward (`ops/flash_attention.py`),
which the probe times beside these.

Layout: q (B·H, Nq, 64), k/v (B·H, Nk, 64) contiguous → out like q. bf16 runs
on the `wgmma` kernel (route "mma"), fp32 on FMAs for the accuracy check
(route "fma"). `flash_variant` launches the kernel for CUDA tensors (or raises
on what it does not take) and runs the plain version, `flash_variant_ref`,
for CPU tensors. Like the JAX variants it is forward-only: asked for a
gradient, it raises. Only `scripts/flash_variants.py` calls it; the models use
`ops/flash_attention.py`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# q, k, v, o, lse, BH, Nq, Nk, D, bq, bk, transposed, clamp, scale, dtype, stream

HEAD_DIM = 64
CLAMP_V1 = 75.0   # `_CLAMP` of udifftext_tpu/ops/flash_attention.py: `_flash_kernel`'s clamp
CLAMP_EXP = 60.0  # `clamp_exp` of scripts/flash_variants.py (`_kernel_v2`, `_kernel_v3`)
# variant → (transposed, clamp: None for the online max)
VARIANTS: Dict[str, Tuple[bool, Optional[float]]] = {
    "v1": (False, CLAMP_V1), "v2": (True, None), "v3": (False, CLAMP_EXP), "v4": (True, CLAMP_EXP),
}
# (block_q, block_k) pairs the source instantiates, by dtype. They are sized
# for 227 KB of shared memory and the register file, not for the TPU's VMEM
# (its probe ran 512-1024 × 256-512). bf16: every pair for both layouts, 0
# bytes of spill (the build log, `chip_smoke.py` phase 2); fp32 (64, 64).
TILE_MENU = {
    torch.bfloat16: ((64, 64), (64, 128), (128, 64), (128, 128)),
    torch.float32: ((64, 64),),
}
_REF_CHUNK_BYTES = 2 << 30  # logits of one chunk of batch·heads in the plain version


def kernel_route(dtype: torch.dtype) -> str:
    """The kernel that serves `dtype`: "mma" (bf16, `wgmma`) or "fma" (fp32)."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def flash_variant_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      clamp: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: fp32 from the inputs, one rounding of the output.
    clamp None: exact softmax attention and its log-sum-exp. clamp C:
    p = exp(clip(s·scale, −C, C)), out = p·v / Σp, and log Σp. Batch·heads
    are walked in chunks so that the fp32 logits stay under 2 GiB."""
    scale = q.shape[-1] ** -0.5
    bh, nq, _ = q.shape
    step = max(1, _REF_CHUNK_BYTES // (4 * nq * k.shape[1]))
    outs, lses = [], []
    for i in range(0, bh, step):
        qf, kf, vf = (t[i:i + step].float() for t in (q, k, v))
        s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
        if clamp is not None:
            m = torch.zeros_like(s[..., :1])
            p = torch.exp(s.clamp_(-clamp, clamp))
        else:
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s.sub_(m))
        l = p.sum(dim=-1, keepdim=True)
        outs.append((torch.einsum("bqk,bkd->bqd", p, vf) / l).to(q.dtype))
        lses.append((m + torch.log(l)).squeeze(-1))
    return torch.cat(outs), torch.cat(lses)


def flash_variant_supported(q: torch.Tensor, k: torch.Tensor, bq: int, bk: int) -> bool:
    """Whether the CUDA kernels take q (BH, Nq, 64) and k (BH, Nk, 64) at the
    tile pair (bq, bk): bf16 or fp32, head width 64, the pair in `TILE_MENU`
    for the dtype, Nq % bq == 0, Nk % bk == 0, BH <= 65535."""
    if q.ndim != 3 or k.ndim != 3 or q.dtype not in TILE_MENU:
        return False
    bh, nq, d = q.shape
    nk = k.shape[1]
    return (d == HEAD_DIM and (bq, bk) in TILE_MENU[q.dtype] and 0 < bh <= 65535
            and nq > 0 and nk > 0 and nq % bq == 0 and nk % bk == 0)


def smem_bytes(bq: int, bk: int, transposed: bool, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the kernel for this tile pair, from the
    library's own plan (builds the library on first use)."""
    fn = _build.kernel_function("udt_flash_variant_smem_bytes", [ctypes.c_int] * 4)
    n = fn(bq, bk, int(transposed), _build.DTYPE_CODES[dtype])
    if n < 0:
        raise ValueError(f"flash_variant: no kernel for tiles ({bq}, {bk}) in {dtype}")
    return n


def _launch(q, k, v, variant: str, bq: int, bk: int, want_lse: bool):
    name = f"flash_variant[{variant}]"
    transposed, clamp = VARIANTS[variant]
    if not (k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v must be on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in TILE_MENU:
        raise TypeError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype} not supported "
                        "(bf16 or fp32, all equal)")
    if q.ndim != 3 or k.shape != (q.shape[0], k.shape[1], q.shape[2]) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}, expected (BH, N, {HEAD_DIM})")
    if not flash_variant_supported(q, k, bq, bk):
        raise ValueError(f"{name}: needs head width {HEAD_DIM}, tiles from "
                         f"{TILE_MENU[q.dtype]} for {q.dtype}, Nq % bq == 0 and Nk % bk == 0; "
                         f"got q {tuple(q.shape)}, Nk={k.shape[1]}, tiles ({bq}, {bk})")
    ts = (q, k, v)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: q, k, v must be contiguous (BH, N, {HEAD_DIM})")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: tensors must start at 16-byte aligned addresses")
    bh, nq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, nq), dtype=torch.float32, device=q.device) if want_lse else None
    fn = _build.kernel_function("udt_flash_variant", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if want_lse else None, bh, nq, k.shape[1], d, bq, bk,
             int(transposed), clamp or 0.0, HEAD_DIM ** -0.5, _build.DTYPE_CODES[q.dtype],
             _build.stream_handle(q))
    _build.check(err, "udt_flash_variant")
    flash_variant.launches[variant] += 1
    return out, lse


def _forward(q, k, v, variant: str, bq: int, bk: int, want_lse: bool):
    if variant not in VARIANTS:
        raise ValueError(f"flash_variant: unknown variant {variant!r}, expected one of "
                         f"{sorted(VARIANTS)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_variant is forward-only (no backward is defined): call it "
                           "under torch.no_grad() or on tensors that do not require grad")
    if not q.is_cuda:
        return flash_variant_ref(q, k, v, VARIANTS[variant][1])
    return _launch(q, k, v, variant, bq, bk, want_lse)


def flash_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, variant: str,
                  bq: int = 64, bk: int = 64) -> torch.Tensor:
    """Attention output of `variant` ("v1".."v4") at tile pair (bq, bk). CUDA
    tensors launch the kernel (or raise on what it does not take); CPU tensors
    take the plain version, which has no tiles. Forward-only: raises if a
    gradient is asked through it."""
    return _forward(q, k, v, variant, bq, bk, False)[0]


def flash_v1_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bq: int = 64,
                      bk: int = 64):
    """v1's two outputs, as `_flash_kernel`'s: (out, log Σp (BH, Nq) fp32), the
    log of its denominator `l`; that is the log-sum-exp while no logit leaves
    ±75."""
    return _forward(q, k, v, "v1", bq, bk, True)


flash_variant.launches = {name: 0 for name in VARIANTS}
