"""Measured against bound for one UNet CFG step (port of `scripts/step_floor_probe.py`).

    python -m udifftext_tpu_torch.scripts.step_floor_probe [batch=16] [K=20] [--runs N] [--device cpu]

Splits one CFG step of the shipped graph (builders.TEXTDESIGN_SD_2, bf16,
seeded random weights, CFG-doubled batch 2·batch, hoisted cross-attention
K/V as the sampling loop runs it) into buckets and sets each beside the least
time an H100 could take for it:

  each kind of transformer layer in the UNet's plan (`layer_list`, read from
  `unet.plan`: ds1, ds2, ds4 and the middle block in the shipped graph),
  timed alone on its own seeded layer, times its count;
  the full step;
  ResBlocks + glue = the step minus the layers;
  the bf16 VAE decode of `batch` latents.

A bucket's bound is the larger of its operations over 989 TFLOP/s and its
bytes over 3.35 TB/s, the operations from `utils.profiling.flops_of` on a
plain twin (attn_impl "plain" on the same weights; ResBlocks + glue: the
step's minus the layers'). The last line is the samples/s that 50 measured
steps and the decode imply, beside what their bounds imply. Times: CUDA
events around K back-to-back calls, divided by K, the median of `runs`
windows (on the CPU the host clock, for checking the script, not a device
time). `run` returns {label: ms}.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from ..models.attention import SpatialTransformer
from ..models.unet import UNetModel
from ._engine import (SEED, latent_side, param_bytes, plain_engine, plain_twin, seeded,
                      seeded_engine, unet_inputs, vae_in, work)
from ._timing import Rows, bound_ms, card_line, probe_device

STEP = "full UNet CFG step, hoisted K/V"
REST = "ResBlocks + glue (step - layers)"
DECODE = "VAE decode bf16"


class Layer(NamedTuple):
    """One kind of transformer layer of a UNet's plan: where it sits ("ds1",
    …, "mid" for the middle block), how many the plan holds, the latent side
    it runs at, its width and heads."""
    name: str
    count: int
    side: int
    channels: int
    heads: int
    dim_head: int


def layer_list(unet: UNetModel, latent: int) -> List[Layer]:
    """The transformer layers of `unet.plan` grouped by kind, in plan order,
    for a latent of `latent`² (the layer list the JAX probe wrote by hand)."""
    plan = unet.plan
    specs = ([(s, "") for blk in plan.input_blocks for s in blk]
             + [(s, "mid") for s in plan.middle_block]
             + [(s, "") for blk in plan.output_blocks for s in blk])
    kinds: Dict[tuple, int] = {}
    for s, where in specs:
        if s.kind == "attn":
            key = (where or f"ds{s.ds}", latent // s.ds, s.in_ch, s.heads, s.dim_head)
            kinds[key] = kinds.get(key, 0) + 1
    return [Layer(name, n, side, c, h, d) for (name, side, c, h, d), n in kinds.items()]


def layer_label(layer: Layer) -> str:
    return f"{layer.name} transformer layer ({layer.side}²×{layer.channels})"


@torch.no_grad()
def run(batch: int = 16, reps: int = 20, runs: int = 3, device: str = "cuda",
        model_cfg: Optional[Dict[str, Any]] = None, size: int = 512,
        dtype: torch.dtype = torch.bfloat16) -> Dict[str, float]:
    """The probe at CFG-doubled batch 2·`batch`; returns {label: ms} with the
    derived ResBlocks + glue bucket under REST."""
    dev = probe_device("step_floor_probe", device)
    b2 = 2 * batch
    bundle = seeded_engine(dev, model_cfg, dtype)
    twin = plain_engine(bundle, model_cfg, dtype)
    unet, punet = bundle.engine.unet, twin.unet
    latent = latent_side(bundle, size)
    gen = torch.Generator(dev).manual_seed(SEED)
    x9, ts, tctx = unet_inputs(bundle, b2, latent, dev, gen)
    print(f"== UNet CFG step against its bound: B_cfg={b2}, latent {latent}², {dtype} ==\n"
          f"{card_line(dev)}", flush=True)
    rows = Rows(dev, reps, runs)

    table = []  # (label, count, measured ms, flops, moved) per bucket
    for i, lay in enumerate(layer_list(unet, latent)):
        def build(lay=lay, impl="auto"):
            return SpatialTransformer(lay.channels, lay.heads, lay.dim_head,
                                      unet.transformer_depth, unet.t_context_dim,
                                      attn_impl=impl)

        st = seeded(build, dev, SEED + 1 + i, dtype)
        pst = plain_twin(st, lambda: build(impl="plain"))
        x = torch.randn(b2, lay.side, lay.side, lay.channels, generator=gen,
                        device=dev).to(dtype)
        kv = st.precompute_kv(tctx, None)
        flops, moved, _ = work(lambda: pst(x, tctx, None, False, kv), (x,), (pst,))
        ms = rows.time(layer_label(lay), lambda: st(x, tctx, None, False, kv),
                       (flops, moved), dtype)
        table.append((layer_label(lay), lay.count, ms, flops, moved, param_bytes(st)))
        del st, pst, x, kv

    kv_full = unet.precompute_context_kv(tctx)
    s_flops, s_moved, _ = work(lambda: punet(x9, ts, tctx, ctx_kv=kv_full), (x9, ts, tctx),
                               (punet,))
    step_ms = rows.time(STEP, lambda: unet(x9, ts, tctx, ctx_kv=kv_full)[0],
                        (s_flops, s_moved), dtype)
    layers_ms = sum(n * ms for _, n, ms, _, _, _ in table)
    rest_ms = rows.results[REST] = step_ms - layers_ms
    rest_flops = s_flops - sum(n * f for _, n, _, f, _, _ in table)
    # the ResBlocks' and the glue's parameters, read once
    rest_moved = param_bytes(punet) - sum(n * p for _, n, _, _, _, p in table)

    vae, pvae = vae_in(bundle.engine.vae, torch.bfloat16), vae_in(twin.vae, torch.bfloat16)
    z = torch.randn(batch, latent, latent, 4, generator=gen, device=dev)
    d_flops, d_moved, _ = work(lambda: pvae.decode(z), (z,), (pvae,))
    dec_ms = rows.time(DECODE, lambda: vae.decode(z), (d_flops, d_moved), torch.bfloat16,
                       note=f"({batch} latents)")

    def bound(flops, moved):
        return bound_ms(flops, moved, dtype)[0]

    print(f"\n{'bucket':44s} {'count':>5s} {'measured ms':>12s} {'bound ms':>9s} "
          f"{'bound/measured':>14s}")
    layer_bound = 0.0
    for label, n, ms, flops, moved, _ in table:
        b = bound(flops, moved)
        layer_bound += n * b
        print(f"{label:44s} {n:5d} {n * ms:12.3f} {n * b:9.3f} {b / ms:14.3f}")
    rest_bound = bound(rest_flops, rest_moved)
    step_bound = bound(s_flops, s_moved)
    dec_bound = bound(d_flops, d_moved)
    print(f"{'sum of the transformer layers':44s} {'':5s} {layers_ms:12.3f} {layer_bound:9.3f} "
          f"{layer_bound / layers_ms:14.3f}")
    print(f"{REST:44s} {'':5s} {rest_ms:12.3f} {rest_bound:9.3f} "
          f"{rest_bound / rest_ms if rest_ms > 0 else float('nan'):14.3f}")
    print(f"{'FULL STEP':44s} {'':5s} {step_ms:12.3f} {step_bound:9.3f} "
          f"{step_bound / step_ms:14.3f}")
    print(f"\n50 steps + the bf16 decode of {batch}: "
          f"{batch / (50 * step_ms + dec_ms) * 1e3:.4f} samples/s measured; "
          f"{batch / (50 * step_bound + dec_bound) * 1e3:.4f} at the bounds", flush=True)
    return rows.results


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=16,
                   help="samples; the step runs at the CFG-doubled 2·batch")
    p.add_argument("reps", nargs="?", type=int, default=20, metavar="K",
                   help="back-to-back calls per timed window")
    p.add_argument("--runs", type=int, default=3, help="timed windows; the median is kept")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return run(args.batch, args.reps, args.runs, args.device)


if __name__ == "__main__":
    main()
