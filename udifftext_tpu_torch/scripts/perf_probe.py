"""Per-stage times and operation counts of the sampling pipeline (port of
`scripts/perf_probe.py`).

    python -m udifftext_tpu_torch.scripts.perf_probe [batch=16] [K=10] [--runs N] [--device cpu]

With seeded random weights of the shipped graph (builders.TEXTDESIGN_SD_2,
UNet in bf16) and a conditioning of `batch` samples, it times and counts:

  one UNet CFG eval as the sampling loop runs it (CFG-doubled batch, hoisted
    K/V), with its operations and eager bytes (`utils.profiling.flops_of` on
    the engine's plain twin, attn_impl "plain" on the same weights) and the
    TFLOP/s and GB/s they imply
  the bf16 VAE decode of `batch` latents, with its operations
  self-attention at (N, H, d) = (4096, 5, 64), (1024, 10, 64), (256, 20, 64)
    through `ops.sdpa` with impl "flash" and "plain", CFG-doubled batch
  the warm default pipeline (`pipeline_probe.sample_and_decode`: 50 steps
    and the chunked bf16 decode) as samples/s and TFLOP/s

Eager counting sees every step, so the pipeline's count must equal 50 × the
eval's plus the K/V hoist's plus the decode's; both are printed and their
difference is returned under COUNT_GAP. Times: CUDA events around K
back-to-back calls, divided by K, the median of `runs` windows (the pipeline
one call a window; on the CPU the host clock, for checking the script, not a
device time). `run` returns {label: ms}.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..ops import sdpa
from ._engine import SEED, latent_side, plain_engine, seeded_engine, vae_in, work
from ._timing import Rows, card_line, nbytes, probe_device, time_ms
from .pipeline_probe import STEPS, conditioning, sample_and_decode
from .profile_components import ATTN_SHAPES

EVAL = "UNet CFG eval, hoisted K/V"
DECODE = "VAE decode bf16"
PIPELINE = "default pipeline (the steps + bf16 decode)"
COUNT_GAP = "pipeline count - (steps × eval + K/V hoist + decode)"


def attn_label(n: int, heads: int, impl: str) -> str:
    return f"self-attention {impl} N={n} H={heads}"


def labels(attn_shapes: Sequence[Tuple[int, int, int]] = ATTN_SHAPES) -> Tuple[str, ...]:
    return ((EVAL, DECODE) + tuple(attn_label(n, h, i) for n, h, _ in attn_shapes
                                   for i in ("flash", "plain")) + (PIPELINE,))


@torch.no_grad()
def run(batch: int = 16, reps: int = 10, runs: int = 3, device: str = "cuda",
        model_cfg: Optional[Dict[str, Any]] = None, size: int = 512, steps: int = STEPS,
        attn_shapes: Sequence[Tuple[int, int, int]] = ATTN_SHAPES,
        dtype: torch.dtype = torch.bfloat16) -> Dict[str, float]:
    """The probe at `batch` samples; returns {label: ms} and the count check
    under COUNT_GAP (0 when the counts compose)."""
    dev = probe_device("perf_probe", device)
    b2 = 2 * batch
    bundle = seeded_engine(dev, model_cfg, dtype)
    engine = bundle.engine
    twin = plain_engine(bundle, model_cfg, dtype)
    side = latent_side(bundle, size)
    gen = torch.Generator(dev).manual_seed(SEED)
    print(f"== pipeline stages: batch {batch} (UNet rows {b2}), {size}², UNet {dtype} ==\n"
          f"{card_line(dev)}", flush=True)
    rows = Rows(dev, reps, runs)

    c, uc = conditioning(bundle, batch, side, dev, gen)
    x = torch.randn(batch, side, side, 4, generator=gen, device=dev)
    sigma = torch.full((batch,), 10.0, device=dev)
    denoise, pdenoise = (e.make_denoise_fn(c, uc, 5.0) for e in (engine, twin))
    e_flops, e_moved, e_eager = work(lambda: pdenoise(x, sigma), (x, sigma), (twin.unet,))
    ms = rows.time(EVAL, lambda: denoise(x, sigma), (e_flops, e_moved), dtype)
    print(f"  eval: {e_flops / 1e12:.3f} TFLOP, {e_eager / 1e9:.1f} GB of eager traffic -> "
          f"{e_flops / ms / 1e9:.1f} TFLOP/s, {e_eager / ms / 1e6:.0f} GB/s", flush=True)

    vae, pvae = vae_in(engine.vae, torch.bfloat16), vae_in(twin.vae, torch.bfloat16)
    z = torch.randn(batch, side, side, 4, generator=gen, device=dev)
    d_flops, d_moved, d_eager = work(lambda: pvae.decode(z), (z,), (pvae,))
    rows.time(DECODE, lambda: vae.decode(z), (d_flops, d_moved), torch.bfloat16)
    print(f"  decode: {d_flops / 1e12:.3f} TFLOP, {d_eager / 1e9:.1f} GB of eager traffic",
          flush=True)

    for n, heads, d in attn_shapes:
        q = torch.randn(b2, n, heads, d, generator=gen, device=dev).to(dtype)
        done = (4.0 * b2 * heads * n * n * d, nbytes(q, q, q, q))
        for impl in ("flash", "plain"):
            rows.time(attn_label(n, heads, impl), lambda: sdpa(q, q, q, impl=impl), done, dtype)
        del q

    kv_flops = work(lambda: twin.unet.precompute_context_kv(
        torch.cat([c["t_crossattn"], uc["t_crossattn"]])))[0]
    p_flops = work(lambda: sample_and_decode(twin, pvae, c, uc, x, steps))[0]
    composed = steps * e_flops + kv_flops + d_flops
    gap = p_flops - composed
    print(f"  pipeline count {p_flops / 1e12:.4f} TFLOP; {steps} × eval + K/V hoist + decode "
          f"{composed / 1e12:.4f} TFLOP (difference {gap:.0f})", flush=True)
    p_ms = rows.results[PIPELINE] = time_ms(
        lambda: sample_and_decode(engine, vae, c, uc, x, steps), 1, runs, dev)
    print(f"{PIPELINE:56s} {p_ms:10.3f} ms  {batch / p_ms * 1e3:.4f} samples/s, "
          f"{p_flops / p_ms / 1e9:.1f} TFLOP/s sustained", flush=True)
    out = dict(rows.results)
    out[COUNT_GAP] = gap
    return out


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=16, help="samples")
    p.add_argument("reps", nargs="?", type=int, default=10, metavar="K",
                   help="back-to-back calls per timed window (one for the pipeline)")
    p.add_argument("--runs", type=int, default=3, help="timed windows; the median is kept")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return run(args.batch, args.reps, args.runs, args.device)


if __name__ == "__main__":
    main()
