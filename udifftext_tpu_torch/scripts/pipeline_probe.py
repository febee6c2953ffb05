"""Where the composed sampling pipeline's time goes (port of `scripts/pipeline_probe.py`).

    python -m udifftext_tpu_torch.scripts.pipeline_probe [batch=16] [K=1] [--runs N] [--device cpu]

With seeded random weights of the shipped graph (builders.TEXTDESIGN_SD_2,
UNet in bf16) and a conditioning of `batch` samples, it times:

  A. 50 raw UNet CFG evals (CFG-doubled batch, each output fed back as the
     next input; no sampler arithmetic)
  B. `sample_euler_edm` through `DiscreteDenoiser` and `VanillaCFG` (the
     engine's CFG denoiser with hoisted K/V), without the VAE
  C. B plus the bf16 VAE decode in chunks of at most 16 latents and the clip
     to [0, 1] (`sample_and_decode`, the default scope of the JAX benchmark)

and prints B − A (the sampler's arithmetic) and C − B (the decode). The
initial noise is drawn from an explicit `torch.Generator`. Times: CUDA events
around K back-to-back calls, divided by K, the median of `runs` windows (on
the CPU the host clock, for checking the script, not a device time). `run`
returns {label: ms}.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import torch

from ..diffusion import sampling as SP
from ._engine import CTX_LEN, SEED, latent_side, seeded_engine, unet_inputs, vae_in
from ._timing import Rows, card_line, probe_device

STEPS, CFG = 50, 5.0
LABELS = ("A. raw UNet CFG evals, one a step", "B. sample_euler_edm (no VAE)",
          "C. B + chunked bf16 VAE decode + clip")


def conditioning(bundle, batch: int, side: int, device: torch.device,
                 generator: Optional[torch.Generator] = None):
    """(c, uc) of `batch` samples as the engine's conditioner gives them: the
    masked image's latent concatenated with the mask ("concat"), the label
    tokens ("t_crossattn"); standard normal values."""
    unet = bundle.engine.unet

    def cond():
        return {"concat": torch.randn(batch, side, side, unet.in_channels - 4,
                                      generator=generator, device=device),
                "t_crossattn": torch.randn(batch, CTX_LEN, unet.t_context_dim,
                                           generator=generator, device=device)}

    return cond(), cond()


def sample_and_decode(engine, vae, c, uc, noise: torch.Tensor, steps: int = STEPS,
                      cfg_scale: float = CFG, decode: bool = True) -> torch.Tensor:
    """`steps` CFG Euler-EDM steps from `noise` (B, h, w, 4), then (with
    `decode`) `vae`'s decode in chunks of the largest divisor of B up to 16
    and the clip to [0, 1]."""
    sigmas = torch.as_tensor(engine.discretization(steps, do_append_zero=True),
                             device=noise.device)
    z = SP.sample_euler_edm(engine.make_denoise_fn(c, uc, cfg_scale),
                            SP.init_latent(noise, sigmas), sigmas)
    if not decode:
        return z
    b = z.shape[0]
    chunk = max(d for d in range(1, min(b, 16) + 1) if b % d == 0)
    img = torch.cat([vae.decode(part / engine.scale_factor) for part in z.split(chunk)])
    return torch.clamp((img + 1.0) / 2.0, 0.0, 1.0)


@torch.no_grad()
def run(batch: int = 16, reps: int = 1, runs: int = 2, device: str = "cuda",
        model_cfg: Optional[Dict[str, Any]] = None, size: int = 512, steps: int = STEPS,
        dtype: torch.dtype = torch.bfloat16) -> Dict[str, float]:
    """The probe at `batch` samples; returns {label: ms}."""
    dev = probe_device("pipeline_probe", device)
    bundle = seeded_engine(dev, model_cfg, dtype)
    engine = bundle.engine
    side = latent_side(bundle, size)
    gen = torch.Generator(dev).manual_seed(SEED)
    vae = vae_in(engine.vae, torch.bfloat16)
    print(f"== sampling pipeline: batch {batch} (UNet rows {2 * batch}), {steps} steps, "
          f"{size}², UNet {dtype} ==\n{card_line(dev)}", flush=True)
    rows = Rows(dev, reps, runs)

    x9, ts, ctx = unet_inputs(bundle, 2 * batch, side, dev, gen)

    def raw_evals():
        cur = x9
        for _ in range(steps):
            out, _ = engine.unet(cur, ts, ctx)
            cur = torch.cat([out, out, out[..., :cur.shape[-1] - 2 * out.shape[-1]]],
                            dim=-1).to(cur.dtype)
        return cur

    c, uc = conditioning(bundle, batch, side, dev, gen)
    noise = torch.randn(batch, side, side, 4, generator=gen, device=dev)
    a = rows.time(LABELS[0], raw_evals)
    b = rows.time(LABELS[1], lambda: sample_and_decode(engine, vae, c, uc, noise, steps,
                                                        decode=False))
    c_ms = rows.time(LABELS[2], lambda: sample_and_decode(engine, vae, c, uc, noise, steps))
    print(f"B - A (sampler arithmetic, K/V hoist) {b - a:+.3f} ms; C - B (decode, clip) "
          f"{c_ms - b:+.3f} ms; {batch / c_ms * 1e3:.4f} samples/s", flush=True)
    return rows.results


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=16, help="samples")
    p.add_argument("reps", nargs="?", type=int, default=1, metavar="K",
                   help="back-to-back calls per timed window")
    p.add_argument("--runs", type=int, default=2, help="timed windows; the median is kept")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return run(args.batch, args.reps, args.runs, args.device)


if __name__ == "__main__":
    main()
