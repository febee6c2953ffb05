"""Stage table of the eval CLI's prediction flow (port of `scripts/test_parity_probe.py`).

    python -m udifftext_tpu_torch.scripts.test_parity_probe [batch=16] [K=1] [--runs N] [--device cpu]

The `test.py` flow (configs/test.yaml through `test.make_predictor`: the
graph's 50 steps and CFG 5.0, 10 candidates in the init-noise search, which
`Predictor` runs batched only when asked and under its row cap) at `batch`
synthetic 512² samples, seeded random weights of the shipped graph
(builders.TEXTDESIGN_SD_2: UNet bf16, VAE fp32), stage by stage:

  the conditioner (LabelEncoder, fp32 VAE encode of the masked image, rescale)
  the fp32 VAE decode of the latents
  the 50-step CFG Euler-EDM loop with hoisted K/V
  the 10-candidate init-noise search (`engine.get_init_noise`: a 2-step
    rollout with map capture and min-local scoring per candidate)
  the whole `engine.sample` call

then the sum of the stages against the whole call (the composition's
overhead), the time a step and a rollout eval. The posterior draw and the
candidates are injected, so that the stages and the whole call see the same
draws; `compose` runs the stages in turn, and the whole call must give its
image (the difference is returned under DIFF_LABEL). Times: CUDA events
around K back-to-back calls, divided by K, the median of `runs` windows (on
the CPU the host clock, for checking the script, not a device time). `run`
returns {label: ms}.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import torch

from ..diffusion import sampling as SP
from ..models.label_encoder import NUM_CLASSES
from ..predict import Predictor
from ..test import make_predictor
from ._engine import CTX_LEN, SEED, latent_side, seeded_engine
from ._timing import Rows, card_line, probe_device

# configs/test.yaml's sampler keys
TEST_RUN = {"noise_iters": 10, "aae_enabled": False, "detailed": False, "encprop_interval": 0}
LABELS = ("conditioner (LabelEncoder + fp32 VAE encode + rescale)",
          "fp32 VAE decode", "50-step CFG Euler-EDM loop (hoisted K/V)",
          "init-noise search (candidates × 2-step rollout, capture)",
          "whole engine.sample")
DIFF_LABEL = "max |whole - composed stages|"


def synthetic_batch(batch: int, size: int, label_ids: int, device: torch.device,
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """`batch` samples of the test flow's float batch: an image in [-1, 1],
    the centre square masked, its masked copy, random label ids, every
    segment on."""
    image = torch.rand(batch, size, size, 3, generator=generator, device=device) * 2.0 - 1.0
    mask = torch.zeros(batch, size, size, 1, device=device)
    mask[:, size // 4:3 * size // 4, size // 4:3 * size // 4] = 1.0
    return {"image": image, "mask": mask, "masked": image * (1.0 - mask),
            "seg_mask": torch.ones(batch, CTX_LEN, device=device),
            "label_ids": torch.randint(1, label_ids, (batch, CTX_LEN), generator=generator,
                                       device=device)}


def search_batched(predictor: Predictor, b: int) -> bool:
    """Whether `predictor` stacks the search's candidates for a batch of b."""
    return (predictor.noise_search_batched
            and predictor.noise_iters * b <= predictor.noise_search_max_rows)


def stages(predictor: Predictor, batch, posterior_eps, noise):
    """label → call of each stage, on the inputs the whole call hands it."""
    engine = predictor.engine
    batched = search_batched(predictor, batch["masked"].shape[0])
    c, uc = engine.conditionings(batch, posterior_eps)
    sigmas = torch.as_tensor(engine.discretization(predictor.num_steps, do_append_zero=True),
                             device=noise.device)
    cfg = predictor.cfg_scale
    return {
        LABELS[0]: lambda: engine.conditionings(batch, posterior_eps),
        LABELS[1]: lambda: engine.decode_first_stage(noise[0]),
        LABELS[2]: lambda: SP.sample_euler_edm(engine.make_denoise_fn(c, uc, cfg),
                                               SP.init_latent(noise[0], sigmas), sigmas),
        LABELS[3]: lambda: engine.get_init_noise(c, uc, batch, noise, cfg,
                                                 candidate_batched=batched)[0],
        LABELS[4]: lambda: engine.sample(
            batch, num_steps=predictor.num_steps, cfg_scale=cfg,
            noise_iters=predictor.noise_iters, noise_search_batched=batched,
            posterior_eps=posterior_eps, noise=noise)[0],
    }


def compose(predictor: Predictor, batch, posterior_eps, noise) -> torch.Tensor:
    """The image of the whole call from its stages in turn: conditioner,
    search, loop, decode and clip."""
    engine = predictor.engine
    batched = search_batched(predictor, batch["masked"].shape[0])
    c, uc = engine.conditionings(batch, posterior_eps)
    x0, _ = engine.get_init_noise(c, uc, batch, noise, predictor.cfg_scale,
                                  candidate_batched=batched)
    sigmas = torch.as_tensor(engine.discretization(predictor.num_steps, do_append_zero=True),
                             device=noise.device)
    z = SP.sample_euler_edm(engine.make_denoise_fn(c, uc, predictor.cfg_scale),
                            SP.init_latent(x0, sigmas), sigmas)
    return torch.clamp((engine.decode_first_stage(z) + 1.0) / 2.0, 0.0, 1.0)


@torch.no_grad()
def run(batch: int = 16, reps: int = 1, runs: int = 2, device: str = "cuda",
        model_cfg: Optional[Dict[str, Any]] = None, size: int = 512,
        noise_iters: int = TEST_RUN["noise_iters"], dtype: torch.dtype = torch.bfloat16) -> Dict[str, float]:
    """The probe at `batch` samples with `noise_iters` search candidates;
    returns {label: ms} and the whole call's difference from the composed
    stages under DIFF_LABEL."""
    dev = probe_device("test_parity_probe", device)
    bundle = seeded_engine(dev, model_cfg, dtype)
    engine = bundle.engine
    predictor = make_predictor(dict(TEST_RUN, noise_iters=noise_iters), bundle, bundle.sampler)
    k = predictor.noise_iters
    side = latent_side(bundle, size)
    gen = torch.Generator(dev).manual_seed(SEED)
    data = synthetic_batch(batch, size, NUM_CLASSES, dev, gen)
    posterior_eps = torch.randn(batch, side, side, 4, generator=gen, device=dev)
    noise = torch.randn(k, batch, side, side, 4, generator=gen, device=dev)
    print(f"== test.py flow by stage: batch {batch}, {size}², {predictor.num_steps} steps, "
          f"CFG {predictor.cfg_scale}, {k} candidates ==\n{card_line(dev)}", flush=True)
    rows = Rows(dev, reps, runs)
    for label, fn in stages(predictor, data, posterior_eps, noise).items():
        rows.time(label, fn)
    t = rows.results
    parts = sum(t[label] for label in LABELS[:4])
    whole = t[LABELS[4]]
    evals = 2 * (1 if search_batched(predictor, batch) else k)
    print(f"{'sum of the stages':56s} {parts:10.3f} ms\n"
          f"{'whole - sum (the composition)':56s} {whole - parts:10.3f} ms\n"
          f"samples/s: whole {batch / whole * 1e3:.4f}, sum of the stages "
          f"{batch / parts * 1e3:.4f}\n"
          f"a step {t[LABELS[2]] / predictor.num_steps:.3f} ms; a rollout eval of the search "
          f"{t[LABELS[3]] / evals:.3f} ms ({evals} evals)", flush=True)
    out = dict(t)
    got = stages(predictor, data, posterior_eps, noise)[LABELS[4]]()
    out[DIFF_LABEL] = float((got - compose(predictor, data, posterior_eps, noise)).abs().max())
    print(f"{DIFF_LABEL}: {out[DIFF_LABEL]:.3e}", flush=True)
    return out


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
