"""Inline against hoisted cross-attention K/V (port of `scripts/kv_hoist_probe.py`).

    python -m udifftext_tpu_torch.scripts.kv_hoist_probe [batch=16] [K=20] [--runs N] [--device cpu]

The sampling loop projects the constant 12-token context to every
cross-attention layer's K/V once (`UNetModel.precompute_context_kv`) and
hands them to each step as `ctx_kv`. This probe times, at CFG-doubled batch
2·batch with seeded random weights (bf16):

  1. one ds1 t_attn residual (LayerNorm, CrossAttention, residual; N = 4096,
     C = 320, 5 × 64 heads, context 12 × 2048) with inline and hoisted K/V;
  2. one UNet CFG step of the shipped graph (builders.TEXTDESIGN_SD_2) with
     inline and hoisted K/V;

and prints the largest difference between the inline and hoisted outputs of
each, over the larger of 1 and the inline output's largest value: they must
agree (the same products on the same operands). Times: CUDA
events around K back-to-back calls, divided by K, the median of `runs`
windows (on the CPU the host clock, for checking the script, not a device
time). `run` returns {label: ms} and the two differences under DIFF_LABELS.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import torch

from ..models.attention import CrossAttention
from ..models.layers import LayerNormF32
from ._engine import CTX_LEN, SEED, latent_side, seeded, seeded_engine, unet_inputs
from ._timing import Rows, card_line, probe_device

LABELS = ("ds1 t_attn residual, inline K/V", "ds1 t_attn residual, hoisted K/V",
          "UNet CFG step, inline K/V", "UNet CFG step, hoisted K/V")
# max |inline − hoisted| over max(1, max |inline|)
DIFF_LABELS = ("inline-hoisted difference, t_attn residual",
               "inline-hoisted difference, UNet step")


@torch.no_grad()
def run(batch: int = 16, reps: int = 20, runs: int = 3, device: str = "cuda",
        model_cfg: Optional[Dict[str, Any]] = None, size: int = 512, channels: int = 320,
        heads: int = 5, side: int = 64, dtype: torch.dtype = torch.bfloat16) -> Dict[str, float]:
    """The probe at CFG-doubled batch 2·`batch`; returns {label: ms} and the
    two inline-hoisted differences."""
    dev = probe_device("kv_hoist_probe", device)
    b2 = 2 * batch
    bundle = seeded_engine(dev, model_cfg, dtype)
    unet = bundle.engine.unet
    ctx_dim = unet.t_context_dim
    gen = torch.Generator(dev).manual_seed(SEED)
    print(f"== K/V hoist: B_cfg={b2}, {dtype} ==\n{card_line(dev)}", flush=True)
    rows = Rows(dev, reps, runs)

    ca = seeded(lambda: CrossAttention(channels, ctx_dim, heads, channels // heads), dev, SEED,
                dtype)
    ln = seeded(lambda: LayerNormF32(channels), dev, SEED + 1, dtype)
    x = torch.randn(b2, side * side, channels, generator=gen, device=dev).to(dtype)
    ctx = torch.randn(b2, CTX_LEN, ctx_dim, generator=gen, device=dev).to(dtype)
    kv = ca.project_kv(ctx)
    layer = {"inline": lambda: ca(ln(x), ctx)[0] + x,
             "hoisted": lambda: ca(ln(x), ctx, False, kv)[0] + x}
    t_in = rows.time(LABELS[0], layer["inline"])
    t_ho = rows.time(LABELS[1], layer["hoisted"])
    n_layers = sum(1 for _ in unet.map_layers())
    print(f"  a layer saves {t_in - t_ho:+.3f} ms; × {n_layers} cross-attention layers = "
          f"{(t_in - t_ho) * n_layers:+.2f} ms a step", flush=True)

    x9, ts, tctx = unet_inputs(bundle, b2, latent_side(bundle, size), dev, gen)
    ctx_kv = unet.precompute_context_kv(tctx)
    step = {"inline": lambda: unet(x9, ts, tctx)[0],
            "hoisted": lambda: unet(x9, ts, tctx, ctx_kv=ctx_kv)[0]}
    s_in = rows.time(LABELS[2], step["inline"])
    s_ho = rows.time(LABELS[3], step["hoisted"])
    print(f"  a step saves {s_in - s_ho:+.3f} ms ({(s_in - s_ho) / s_in:+.3f} of it); × 50 steps "
          f"= {(s_in - s_ho) * 50 / 1e3:+.4f} s a batch of {batch}", flush=True)

    out = dict(rows.results)
    for label, pair in zip(DIFF_LABELS, (layer, step)):
        inline = pair["inline"]().float()
        out[label] = float((inline - pair["hoisted"]().float()).abs().max()
                           / max(1.0, float(inline.abs().max())))
        print(f"{label} (max |inline - hoisted| / max(1, max |inline|)): {out[label]:.3e}",
              flush=True)
    return out


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=16,
                   help="samples; the probe runs at the CFG-doubled 2·batch")
    p.add_argument("reps", nargs="?", type=int, default=20, metavar="K",
                   help="back-to-back calls per timed window")
    p.add_argument("--runs", type=int, default=3, help="timed windows; the median is kept")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return run(args.batch, args.reps, args.runs, args.device)


if __name__ == "__main__":
    main()
