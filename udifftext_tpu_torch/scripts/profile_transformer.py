"""Per-op breakdown of one ds1 SpatialTransformer layer (port of
`scripts/profile_transformer.py`).

    python -m udifftext_tpu_torch.scripts.profile_transformer [batch=16] [K=20] [--runs N] [--device cpu]

At the shipped graph's ds1 shape (CFG-doubled batch 2·batch, N = 64² = 4096,
C = 320, 5 heads × 64, a context of 12 × 2048 tokens; bf16, seeded random
weights) it times:

  the whole layer (GroupNorm, proj_in, the block, proj_out, residual)
  the self-attention residual (LayerNorm, q/k/v, sdpa, out, residual)
    sdpa alone (the flash kernel)
    one (N, C)·(C, C) projection
    LayerNormF32 alone
  the t_attn residual (LayerNorm, cross-attention with inline K/V, residual)
  the GEGLU feed-forward residual (LayerNorm, C → 8C, gate, 4C → C)
  GroupNorm32 alone

Each row carries its operations (`utils.profiling.flops_of` on the plain
twin of each block: attn_impl / impl "plain" on the same weights), its H100
bound and its share of the whole layer; the last line is the layer's eager
bytes. Times: CUDA events around K back-to-back
calls, divided by K, the median of `runs` windows (on the CPU the host clock,
for checking the script, not a device time). `run` returns {label: ms}.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch
import torch.nn.functional as F

from ..models.attention import CrossAttention, GEGLUFeedForward, SelfAttention, SpatialTransformer
from ..models.layers import GroupNorm32, LayerNormF32
from ..ops import sdpa
from ._engine import CTX_LEN, SEED, plain_twin, seeded, work
from ._timing import Rows, card_line, probe_device

WHOLE = "SpatialTransformer (whole layer)"
LABELS = (WHOLE, "self-attention residual (LN+qkv+sdpa+out)", "  sdpa alone",
          "  one (N,C)·(C,C) projection", "  LayerNormF32 alone",
          "t_attn residual (LN+cross-attention, inline K/V)",
          "GEGLU feed-forward residual (LN+8C+4C)", "GroupNorm32 alone")


def _stages(m, impl, x_sp, x, q, w, ctx):
    """label → (call, its inputs, its modules) on one set of modules `m`,
    attention through `sdpa` with `impl`."""
    return {
        WHOLE: (lambda: m["st"](x_sp, ctx)[0], (x_sp, ctx), (m["st"],)),
        LABELS[1]: (lambda: m["sa"](m["ln"](x)) + x, (x,), (m["sa"], m["ln"])),
        LABELS[2]: (lambda: sdpa(q, q, q, impl=impl), (q,), ()),
        LABELS[3]: (lambda: F.linear(x, w), (x, w), ()),
        LABELS[4]: (lambda: m["ln"](x), (x,), (m["ln"],)),
        LABELS[5]: (lambda: m["ca"](m["ln"](x), ctx)[0] + x, (x, ctx), (m["ca"], m["ln"])),
        LABELS[6]: (lambda: m["ff"](m["ln"](x)) + x, (x,), (m["ff"], m["ln"])),
        LABELS[7]: (lambda: m["gn"](x_sp), (x_sp,), (m["gn"],)),
    }


@torch.no_grad()
def run(batch: int = 16, reps: int = 20, runs: int = 3, device: str = "cuda",
        channels: int = 320, heads: int = 5, side: int = 64, ctx_dim: int = 2048,
        dtype: torch.dtype = torch.bfloat16) -> Dict[str, float]:
    """The probe at CFG-doubled batch 2·`batch`; returns {label: ms}."""
    dev = probe_device("profile_transformer", device)
    b2, n, c, d = 2 * batch, side * side, channels, channels // heads

    def builders(impl):
        return {
            "st": lambda: SpatialTransformer(c, heads, d, 1, ctx_dim, attn_impl=impl),
            "sa": lambda: SelfAttention(c, heads, d, attn_impl=impl),
            "ln": lambda: LayerNormF32(c),
            "ca": lambda: CrossAttention(c, ctx_dim, heads, d),
            "ff": lambda: GEGLUFeedForward(c, impl="plain" if impl == "plain" else "auto"),
            "gn": lambda: GroupNorm32(c, eps=1e-6),
        }

    mods = {k: seeded(f, dev, SEED + i, dtype)
            for i, (k, f) in enumerate(builders("auto").items())}
    twins = {k: plain_twin(mods[k], f) for k, f in builders("plain").items()}
    gen = torch.Generator(dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    x_sp, x = randn(b2, side, side, c), randn(b2, n, c)
    q, w, ctx = randn(b2, n, heads, d), randn(c, c, scale=c**-0.5), randn(b2, CTX_LEN, ctx_dim)
    print(f"== ds1 SpatialTransformer per op: B_cfg={b2}, N={n}, C={c}, {heads}×{d}, "
          f"context {CTX_LEN}×{ctx_dim}, {dtype} ==\n{card_line(dev)}", flush=True)
    timed = _stages(mods, "auto", x_sp, x, q, w, ctx)
    counted = _stages(twins, "plain", x_sp, x, q, w, ctx)
    rows = Rows(dev, reps, runs)
    eager = {}
    for label, (fn, _, _) in timed.items():
        flops, moved, eager[label] = work(*counted[label])
        rows.time(label, fn, (flops, moved), dtype)
    whole = rows.results[WHOLE]
    print("share of the whole layer: " + ", ".join(
        f"{label.strip()} {ms / whole:.3f}" for label, ms in rows.results.items()
        if label != WHOLE), flush=True)
    print(f"whole layer (flops_of, plain twin): {eager[WHOLE] / 1e9:.2f} GB of eager traffic",
          flush=True)
    return rows.results


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=16,
                   help="samples; the layer runs at the CFG-doubled 2·batch")
    p.add_argument("reps", nargs="?", type=int, default=20, metavar="K",
                   help="back-to-back calls per timed window")
    p.add_argument("--runs", type=int, default=3, help="timed windows; the median is kept")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return run(args.batch, args.reps, args.runs, args.device)


if __name__ == "__main__":
    main()
