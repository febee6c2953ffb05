"""Transformer-glue fusion probe (port of `scripts/glue_fusion_probe.py`).

    python -m udifftext_tpu_torch.scripts.glue_fusion_probe [batch=16] [K=20] [--device cpu]

Times, at the shapes the sampling loop gives the ds1 and ds2 transformer
blocks of the shipped graph (C=320, N=4096, 5 heads; C=640, N=1024, 10 heads;
CFG-doubled batch 2·batch; 12 context tokens of width 2048; bf16), the fused
kernels against the compositions they replace:

  D. bare products: three (C→C) against one (C→3C)
  C. LayerNormF32 alone
  F. LN then products (one wide, three separate) against the `ln_gemm`
     kernel (C→3C) and the `ln_gemm3` kernel (three compact C→C outputs)
  A. SelfAttention with fuse_qkv off and on
  E. LN + CrossAttention (hoisted K/V) + residual, unfused
  G. the one-kernel t_attn branch, `fused_cross_attention`
  B. the whole BasicTransformerBlock with hoisted K/V:
     (fuse_qkv, fuse_glue) = (off, off), (on, off), (on, auto)

Weights and inputs are seeded random. Each label's time is CUDA events around
K back-to-back calls, divided by K, the median of several such runs (on the
CPU: the host clock, for checking the script, not a device time). `run`
returns {label: ms} and prints one line per label.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..builders import randomize_parameters
from ..models.attention import BasicTransformerBlock, CrossAttention, SelfAttention
from ..models.layers import LayerNormF32, cast_weights
from ..ops.cross_attention import fused_cross_attention
from ..ops.ln_gemm import ln_gemm, ln_gemm3
from ._timing import probe_device, time_ms

CTX_DIM = 2048
CTX_LEN = 12
DIM_HEAD = 64
SHAPES = (("ds1", 64, 320), ("ds2", 32, 640))  # (name, latent side, C)


def _module(mod: torch.nn.Module, seed: int, dtype: torch.dtype, device: torch.device):
    """`mod` with seeded random parameters, Linear weights stored in `dtype`."""
    return cast_weights(randomize_parameters(mod, seed), dtype).to(device).eval()


@torch.no_grad()
def run(batch: int = 16, reps: int = 20, device: str = "cuda",
        shapes: Sequence[Tuple[str, int, int]] = SHAPES, ctx_dim: int = CTX_DIM,
        dim_head: int = DIM_HEAD, dtype: torch.dtype = torch.bfloat16,
        runs: int = 5) -> Dict[str, float]:
    """The probe at CFG-doubled batch 2·`batch`; returns {label: ms}."""
    dev = probe_device("glue_fusion_probe", device)
    clock = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU host clock"
    b2 = 2 * batch
    gen = torch.Generator(dev).manual_seed(0)
    results: Dict[str, float] = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def timed(label: str, fn: Callable[[], object]) -> float:
        ms = results[label] = time_ms(fn, reps, runs, dev)
        print(f"{label:66s} {ms:9.3f} ms", flush=True)
        return ms

    tctx = randn(b2, CTX_LEN, ctx_dim)
    for name, side, c in shapes:
        n = side * side
        heads = c // dim_head
        x = randn(b2, n, c)
        print(f"\n== {name}: (B={b2}, N={n}, C={c}), {dtype}, {clock} ==", flush=True)

        # D. bare products
        w1 = [randn(c, c, scale=c**-0.5) for _ in range(3)]
        w3 = torch.cat(w1, dim=0)
        t3 = timed(f"{name} D. 3x separate ({c}->{c}) GEMMs",
                   lambda: [F.linear(x, w) for w in w1])
        tf = timed(f"{name} D. 1x fused ({c}->{3 * c}) GEMM",
                   lambda: F.linear(x, w3).chunk(3, dim=-1))

        # C. LayerNorm alone
        ln = randomize_parameters(LayerNormF32(c), 1).to(dev)
        ln_s, ln_b = ln.weight.float(), ln.bias.float()
        timed(f"{name} C. LayerNormF32 (fp32 stats) alone", lambda: ln(x))

        # F. LN then products, plain and fused
        timed(f"{name} F. LN -> fused ({c}->{3 * c}) GEMM", lambda: F.linear(ln(x), w3))
        timed(f"{name} F. LN -> 3x separate ({c}->{c}) GEMMs",
              lambda: [F.linear(h, w) for h in (ln(x),) for w in w1])
        timed(f"{name} F. ln_gemm kernel ({c}->{3 * c})", lambda: ln_gemm(x, ln_s, ln_b, w3))
        timed(f"{name} F. ln_gemm3 kernel (3x {c}->{c} compact)",
              lambda: ln_gemm3(x, ln_s, ln_b, *w1))

        # A. self-attention with the q/k/v products separate and concatenated
        for fuse in (False, True):
            sa = _module(SelfAttention(c, heads, dim_head, fuse_qkv=fuse), 2, dtype, dev)
            timed(f"{name} A. SelfAttention fuse_qkv={fuse}", lambda sa=sa: sa(x))

        # E. the unfused t_attn branch with hoisted K/V; G. the one-kernel branch
        ca = _module(CrossAttention(c, ctx_dim, heads, dim_head), 3, dtype, dev)
        kv = ca.project_kv(tctx)
        timed(f"{name} E. LN + CrossAttention (hoisted KV) + residual",
              lambda: ca(ln(x), None, False, kv)[0] + x)
        to_out = ca.to_out[0]
        timed(f"{name} G. fused t_attn branch kernel (LN+q+attn+out+res)",
              lambda: fused_cross_attention(x, ln_s, ln_b, ca.to_q.weight, kv[0], kv[1],
                                            to_out.weight, to_out.bias, heads))

        # B. the whole block, hoisted K/V
        for fuse, glue in ((False, "off"), (True, "off"), (True, "auto")):
            blk = _module(BasicTransformerBlock(heads, dim_head, ctx_dim, fuse_qkv=fuse,
                                                fuse_glue=glue), 4, dtype, dev)
            ctx_kv = {"t": blk.t_attn.project_kv(tctx)}
            timed(f"{name} B. BasicTransformerBlock qkv={fuse} glue={glue} (hoisted KV)",
                  lambda blk=blk, ctx_kv=ctx_kv: blk(x, tctx, None, False, ctx_kv)[0])

        print(f"   one ({c}->{3 * c}) product against three ({c}->{c}) at this shape: "
              f"{tf - t3:+.3f} ms", flush=True)
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=16,
                   help="samples per step; the probe runs at the CFG-doubled 2·batch")
    p.add_argument("reps", nargs="?", type=int, default=20, metavar="K",
                   help="back-to-back calls per timed run")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("glue_fusion_probe: no CUDA device found; pass --device cpu to check "
                         "the script on the CPU")
    run(args.batch, args.reps, args.device)


if __name__ == "__main__":
    main()
