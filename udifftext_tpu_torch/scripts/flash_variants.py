"""Flash-attention forward variants at the ds1 self-attention shape (port of
`scripts/flash_variants.py`).

    python -m udifftext_tpu_torch.scripts.flash_variants [K=40] [--device cpu]

Times `ops.flash_variants.flash_variant` at B=32, H=5, N=4096, d=64, bf16
(the CFG-doubled ds1 latent self-attention), every variant at every tile pair
of the card's menu, each label naming the kernel route that served it ("mma":
`wgmma`, bf16; "fma": fp32):

  v1  rows layout (s = q·kᵀ, acc += p·v), logits clamped at ±75, no running
      max: the function of the TPU's shipped forward `_flash_kernel`
  v2  transposed: sᵀ = k·qᵀ, statistics per query column, accᵀ += vᵀ·pᵀ,
      online max
  v3  v1's layout, clamped at ±60
  v4  v2's layout, clamped at ±60

beside the shipped forward kernel (`ops.flash_attention`: for bf16 the
tensor-core kernel with scores in registers and the online max, 128 query
rows by 64 keys, the rows layout's online-max form; for fp32 the FMA kernel,
64×64) and, as the library yardstick that the port
itself never calls, `torch.nn.functional.scaled_dot_product_attention` on the
same tensors.
Inputs come from numpy's `RandomState(0)`, scaled by 0.3, as in the JAX
script. Every kernel's output on the first two batch·heads is held to plain
fp32 softmax attention (max error < 0.02; at these inputs no clamp binds)
before it is timed; a failed check raises. Each time is CUDA events around K back-to-back calls, divided by K,
the median of several such runs (on the CPU: the host clock and the plain
versions, for checking the script). `run` returns {label: (ms, TFLOP/s)} with
flops = 4·B·H·N²·d and prints one line per label.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention
from ..ops.flash_variants import TILE_MENU, VARIANTS, flash_variant, kernel_route
from ._timing import probe_device, time_ms

MAX_ERR = 0.02
NAMES = {"v1": "v1 clamp-75", "v2": "v2 transposed", "v3": "v3 clamped-exp",
         "v4": "v4 transposed+clamp"}
SHIPPED_LABEL = "shipped flash_attention"
LIBRARY_LABEL = "library scaled_dot_product_attention"


def variant_label(variant: str, bq: int, bk: int, dtype: torch.dtype) -> str:
    return f"{NAMES[variant]} bq={bq} bk={bk} {kernel_route(dtype)}"


@torch.no_grad()
def run(reps: int = 40, batch: int = 32, heads: int = 5, n: int = 4096, runs: int = 3,
        device: str = "cuda",
        dtype: torch.dtype = torch.bfloat16) -> Dict[str, Tuple[float, float]]:
    """The probe on (batch·heads, n, 64) tensors; returns {label: (ms, TFLOP/s)}."""
    dev = probe_device("flash_variants", device)
    clock = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU host clock"
    bh, d = batch * heads, 64
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(bh, n, d).astype(np.float32)).to(dev, dtype) * 0.3
               for _ in range(3))
    flops = 4 * bh * n * n * d
    print(f"== flash variants at (B·H={bh}, N={n}, d={d}), {dtype}, {clock} ==", flush=True)

    # correctness oracle: plain softmax attention on the first two batch·heads
    q0, k0, v0 = (t[:2].float() for t in (q, k, v))
    oracle = torch.softmax(torch.einsum("bnd,bmd->bnm", q0, k0) * d**-0.5, dim=-1) @ v0
    results: Dict[str, Tuple[float, float]] = {}

    def timed(label: str, fn: Callable[[], torch.Tensor], check: bool = True,
              to_bhnd: Callable[[torch.Tensor], torch.Tensor] = lambda o: o) -> None:
        if check:
            err = float((to_bhnd(fn())[:2].float() - oracle).abs().max())
            print(f"  {label} max err vs softmax attention: {err:.4f}", flush=True)
            if not err < MAX_ERR:
                raise RuntimeError(f"flash_variants: {label} is {err} from softmax attention "
                                   f"(limit {MAX_ERR})")
        ms = time_ms(fn, reps, runs, dev)
        results[label] = (ms, flops / ms / 1e9)
        print(f"{label:46s} {ms:8.3f} ms  {results[label][1]:6.1f} TF/s", flush=True)

    # (B, N, H, d) views of the same tensors for the shipped kernel
    q4, k4, v4 = (t.view(batch, heads, n, d).transpose(1, 2) for t in (q, k, v))
    timed(SHIPPED_LABEL, lambda: flash_attention(q4, k4, v4)[0],
          to_bhnd=lambda o: o.transpose(1, 2).reshape(bh, n, d))
    for variant in VARIANTS:
        for bq, bk in TILE_MENU[dtype]:
            timed(variant_label(variant, bq, bk, dtype),
                  lambda variant=variant, bq=bq, bk=bk: flash_variant(q, k, v, variant, bq, bk))
    # four dimensions: on (B·H, N, d) the call would not reach its fused kernels
    qh, kh, vh = (t.view(batch, heads, n, d) for t in (q, k, v))
    timed(LIBRARY_LABEL, lambda: F.scaled_dot_product_attention(qh, kh, vh), check=False)
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("reps", nargs="?", type=int, default=40, metavar="K",
                   help="back-to-back calls per timed run")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("flash_variants: no CUDA device found; pass --device cpu to check the "
                         "script on the CPU")
    run(args.reps, device=args.device)


if __name__ == "__main__":
    main()
