"""Component timings of the shipped graph on the card (port of
`scripts/profile_components.py`).

    python -m udifftext_tpu_torch.scripts.profile_components [B=16] [K=20] [--runs N] [--device cpu]

Times, with seeded random weights (builders.TEXTDESIGN_SD_2, UNet in bf16)
and a batch of B UNet rows (a CFG batch):

  UNet forward, and with the t_attn maps captured (the training and AAE path)
  VAE decode of B/2 latents, fp32 and bf16
  self-attention at (N, H, d) = (4096, 5, 64), (1024, 10, 64), (256, 20, 64):
    the flash kernel (`ops.flash_attention.flash_attention` called directly,
    N = 256 included, which `flash_shape_ok` would send to the plain path),
    the plain path (`plain_sdpa`), and `F.scaled_dot_product_attention`,
    the library yardstick, which the port calls nowhere
  GroupNorm32 + SiLU at 64² × 320 (the UNet's eager glue)

Each row has its operations and the H100 bound: the UNet's and the VAE's
from `utils.profiling.flops_of` on the engine's plain twin (attn_impl
"plain" on the same weights), attention's 4·B·H·N²·d.
Times are CUDA events around K back-to-back calls, divided by K, the median
of `runs` such windows (on the CPU: the host clock, for checking the script,
not a device time). `run` returns {label: ms}.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import GroupNorm32
from ..ops.attention import plain_sdpa
from ..ops.flash_attention import flash_attention
from ._engine import (SEED, latent_side, plain_engine, seeded_engine, unet_inputs, vae_in,
                      work)
from ._timing import Rows, card_line, nbytes, probe_device

ATTN_SHAPES = ((4096, 5, 64), (1024, 10, 64), (256, 20, 64))  # (N, heads, d)
ATTN_PATHS = ("flash kernel", "plain", "SDPA library")


def attn_label(n: int, heads: int, d: int, path: str) -> str:
    return f"self-attention N={n} H={heads} d={d}: {path}"


def labels(attn_shapes: Sequence[Tuple[int, int, int]] = ATTN_SHAPES) -> Tuple[str, ...]:
    return (("UNet forward", "UNet forward + maps", "VAE decode fp32", "VAE decode bf16")
            + tuple(attn_label(*s, p) for s in attn_shapes for p in ATTN_PATHS)
            + ("GroupNorm32 + SiLU",))


@torch.no_grad()
def run(batch: int = 16, reps: int = 20, runs: int = 3, device: str = "cuda",
        model_cfg: Optional[Dict[str, Any]] = None, size: int = 512,
        attn_shapes: Sequence[Tuple[int, int, int]] = ATTN_SHAPES,
        dtype: torch.dtype = torch.bfloat16) -> Dict[str, float]:
    """The probe at `batch` UNet rows on `size`² images; returns {label: ms}."""
    dev = probe_device("profile_components", device)
    bundle = seeded_engine(dev, model_cfg, dtype)
    twin = plain_engine(bundle, model_cfg, dtype)
    side = latent_side(bundle, size)
    gen = torch.Generator(dev).manual_seed(SEED)
    print(f"== profile_components: UNet rows B={batch}, latent {side}², {dtype} ==\n"
          f"{card_line(dev)}", flush=True)
    rows = Rows(dev, reps, runs)

    x, ts, ctx = unet_inputs(bundle, batch, side, dev, gen)
    for label, capture in (("UNet forward", False), ("UNet forward + maps", True)):
        flops, moved, _ = work(lambda: twin.unet(x, ts, ctx, capture_attn=capture),
                               (x, ts, ctx), (twin.unet,))
        rows.time(label, lambda: bundle.engine.unet(x, ts, ctx, capture_attn=capture),
                  (flops, moved), dtype)

    z = torch.randn(max(1, batch // 2), side, side, 4, generator=gen, device=dev)
    for vdt, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        vae, pvae = vae_in(bundle.engine.vae, vdt), vae_in(twin.vae, vdt)
        flops, moved, _ = work(lambda: pvae.decode(z), (z,), (pvae,))
        # fp32 convolutions take TF32 through cuDNN, PyTorch's default
        rows.time(f"VAE decode {name}", lambda: vae.decode(z), (flops, moved), vdt,
                  tf32=vdt == torch.float32, note=f"({z.shape[0]} latents)")
        del vae, pvae

    for n, heads, d in attn_shapes:
        q, k, v = (torch.randn(batch, n, heads, d, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # SDPA's (B, H, N, d) views
        done = (4.0 * batch * heads * n * n * d, nbytes(q, k, v, q))
        for path, fn in zip(ATTN_PATHS, (
                lambda: flash_attention(q, k, v)[0],
                lambda: plain_sdpa(q, k, v),
                lambda: F.scaled_dot_product_attention(qt, kt, vt))):
            rows.time(attn_label(n, heads, d, path), fn, done, dtype)
        del q, k, v, qt, kt, vt

    gn = GroupNorm32(bundle.engine.unet.model_channels).to(dev)
    h = torch.randn(batch, side, side, bundle.engine.unet.model_channels, generator=gen,
                    device=dev).to(dtype)
    rows.time("GroupNorm32 + SiLU", lambda: F.silu(gn(h)), (10.0 * h.numel(), nbytes(h, h)),
              dtype)
    return rows.results


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=16, help="UNet rows (a CFG batch)")
    p.add_argument("reps", nargs="?", type=int, default=20, metavar="K",
                   help="back-to-back calls per timed window")
    p.add_argument("--runs", type=int, default=3, help="timed windows; the median is kept")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return run(args.batch, args.reps, args.runs, args.device)


if __name__ == "__main__":
    main()
