"""Per-stage times of the fine-tuning step (port of `scripts/train_probe.py`).

    python -m udifftext_tpu_torch.scripts.train_probe [batch=16] [K=4] [--runs N] [--device cpu]

With seeded random weights of the shipped graph (builders.TEXTDESIGN_SD_2,
UNet in bf16) at the training latent shape (batch, 64², 9), it times:

  the VAE encode of batch 512² images, in fp32 (the graph's setting) and in
    bf16 (`first_stage_bf16`);
  the UNet forward, and the forward with the t_attn maps captured;
  the forward and backward with every parameter's gradient;
  the forward and backward with only the trainable branch's gradients (the
    t_attn/t_norm parameters `parallel.train.trainable_mask` picks, as the
    optimizer needs them), which the flash backward kernel serves.

The backward is `torch.autograd.grad` of sum(out²) with respect to the
parameters asked for: every gradient it returns is computed (eager PyTorch
prunes nothing it was asked for), and no other. Times: CUDA events around K
back-to-back calls, divided by K, the median of `runs` windows (on the CPU
the host clock, for checking the script, not a device time). `run` returns
{label: ms}.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import torch

from ..parallel.train import trainable_mask
from ._engine import SEED, latent_side, seeded_engine, unet_inputs, vae_in
from ._timing import Rows, card_line, probe_device

OPT_KEYS = ("t_attn", "t_norm")
LABELS = ("VAE encode fp32", "VAE encode bf16", "UNet forward", "UNet forward + maps",
          "UNet forward+backward, every gradient",
          "UNet forward+backward, trainable gradients only")


def loss_grads(unet, x9, ts, ctx, params):
    """The gradients of sum(out²) of one UNet forward with respect to `params`."""
    out, _ = unet(x9, ts, ctx)
    return torch.autograd.grad(out.float().square().sum(), params)


def run(batch: int = 16, reps: int = 4, runs: int = 3, device: str = "cuda",
        model_cfg: Optional[Dict[str, Any]] = None, size: int = 512,
        dtype: torch.dtype = torch.bfloat16) -> Dict[str, float]:
    """The probe at `batch` training samples; returns {label: ms}."""
    dev = probe_device("train_probe", device)
    bundle = seeded_engine(dev, model_cfg, dtype)
    engine = bundle.engine
    unet = engine.unet
    gen = torch.Generator(dev).manual_seed(SEED)
    print(f"== fine-tuning stages: batch {batch}, {size}² images, latent "
          f"{latent_side(bundle, size)}², UNet {dtype} ==\n{card_line(dev)}", flush=True)
    rows = Rows(dev, reps, runs)

    img = torch.rand(batch, size, size, 3, generator=gen, device=dev) * 2.0 - 1.0
    with torch.no_grad():
        for vdt, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            vae = vae_in(engine.vae, vdt)
            rows.time(f"VAE encode {name}", lambda: vae.encode_moments(img),
                      note=f"({batch} images)")
            del vae
        del img
        x9, ts, ctx = unet_inputs(bundle, batch, latent_side(bundle, size), dev, gen)
        rows.time(LABELS[2], lambda: unet(x9, ts, ctx))
        rows.time(LABELS[3], lambda: unet(x9, ts, ctx, capture_attn=True))

    every = list(unet.parameters())
    mask = trainable_mask(engine.named_parameters(), OPT_KEYS)
    trainable = [p for n, p in engine.named_parameters() if mask[n]]

    for label, params in ((LABELS[4], every), (LABELS[5], trainable)):
        for p in params:
            p.requires_grad_(True)
        rows.time(label, lambda: loss_grads(unet, x9, ts, ctx, params),
                  note=f"({len(params)} tensors, {sum(p.numel() for p in params) / 1e6:.1f} M "
                  "values)")
        for p in params:
            p.requires_grad_(False)
    return rows.results


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=16, help="training samples")
    p.add_argument("reps", nargs="?", type=int, default=4, metavar="K",
                   help="back-to-back calls per timed window")
    p.add_argument("--runs", type=int, default=3, help="timed windows; the median is kept")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return run(args.batch, args.reps, args.runs, args.device)


if __name__ == "__main__":
    main()
