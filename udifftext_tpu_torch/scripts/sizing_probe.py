"""The measurements behind two of the port's defaults, on the card.

    python -m udifftext_tpu_torch.scripts.sizing_probe [attention|search|all]

attention: fp32 attention forward and backward through autograd, as `sdpa`
dispatches it, at the ds2 and ds1 self-attention shapes of the demo's
sampling batch (B=2): the flash kernels (impl="flash") against the plain path
(impl="plain"). Each time is CUDA events around K back-to-back
forward+backward calls, divided by K, the median of several runs. It decides
where fp32 goes under impl="auto" (`ops.attention.flash_dtype_ok`).

search: peak device memory (`torch.cuda.max_memory_allocated`) of the demo
flow at full width (`builders.TEXTDESIGN_SD_2`, bf16, seeded random weights,
CFG 4.0, 10 candidates) at 10, 80, 160 and 320 candidate rows (noise_iters·B,
B = 1, 8, 16, 32): the batched search alone (search and one sampling step, no
decode), and the whole predictor call, with the batched and with the
sequential search (the search, 2 sampling steps, the fp32 VAE decode; a
step's memory does not depend on how many steps follow). An out-of-memory
error is a result and is printed as such. It sets `Predictor`'s
`noise_search_max_rows`.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.attention import sdpa
from ._timing import probe_device, time_ms

# (label, B, N, heads): the UNet's self-attention at the demo's sampling batch
ATTN_SHAPES = (("ds2 B=2", 2, 1024, 10), ("ds1 B=2", 2, 4096, 5))
SEARCH_ROWS = (10, 80, 160, 320)


def attention_fp32(shapes=ATTN_SHAPES, reps: int = 5, runs: int = 5,
                   device: str = "cuda") -> Dict[str, Tuple[float, float]]:
    """{label: (flash ms, plain ms)} of fp32 forward + backward (d = 64)."""
    dev = probe_device("sizing_probe", device)
    clock = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU host clock"
    print(f"== fp32 attention forward + backward through autograd, {clock} ==", flush=True)
    rng = np.random.RandomState(0)
    results = {}
    for label, b, n, h in shapes:
        q, k, v, do = (torch.from_numpy(rng.randn(b, n, h, 64).astype(np.float32)).to(dev)
                       for _ in range(4))
        leaves = [t.requires_grad_(True) for t in (q, k, v)]

        def step(impl: str):
            return torch.autograd.grad(sdpa(*leaves, impl=impl), leaves, do)

        flash_ms = time_ms(lambda: step("flash"), reps, runs, dev)
        plain_ms = time_ms(lambda: step("plain"), reps, runs, dev)
        results[label] = (flash_ms, plain_ms)
        print(f"{label} (N={n}, {h} heads): flash kernels {flash_ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms", flush=True)
    return results


def synthetic_batch(b: int, size: int = 512, seq: int = 12, seed: int = 0) -> Dict[str, np.ndarray]:
    """The demo's float batch for b samples: a smooth image in [-1, 1], a text
    box mask, the text "HELLO"."""
    from ..charset import encode_labels

    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    image = np.sin(np.stack([xx * 3, yy * 2, (xx + yy) * 4], -1))[None].repeat(b, 0)
    image = np.clip(image + 0.1 * rs.standard_normal(image.shape), -1, 1).astype(np.float32)
    mask = np.zeros((b, size, size, 1), np.float32)
    mask[:, size // 3:size // 2, size // 4:3 * size // 4] = 1.0
    seg_mask = np.zeros((b, seq), np.float32)
    seg_mask[:, :5] = 1.0
    return {"image": image, "mask": mask, "masked": image * (1 - mask), "seg_mask": seg_mask,
            "label_ids": encode_labels(["HELLO"] * b, seq)}


def search_memory(rows=SEARCH_ROWS, noise_iters: int = 10,
                  device: str = "cuda") -> Dict[int, Dict[str, Optional[float]]]:
    """{rows: {"search" | "batched" | "sequential": peak GiB, or None on an
    out-of-memory error}} of the demo flow at full width."""
    from ..builders import TEXTDESIGN_SD_2, build_engine, randomize_parameters
    from ..predict import Predictor

    dev = probe_device("sizing_probe", device)
    if dev.type != "cuda":
        raise RuntimeError("sizing_probe: peak device memory is measured on the card only")
    engine = build_engine(TEXTDESIGN_SD_2, torch.bfloat16, dev).engine
    randomize_parameters(engine, 0)
    total = torch.cuda.get_device_properties(dev).total_memory / 2**30
    print(f"== peak device memory of the demo flow, {torch.cuda.get_device_name(dev)}, "
          f"{total:.1f} GiB ==", flush=True)
    results = {}
    for r in rows:
        b = r // noise_iters
        batch = synthetic_batch(b)

        def predictor(batched: bool, steps: int) -> Predictor:
            return Predictor(engine, num_steps=steps, cfg_scale=4.0, noise_iters=noise_iters,
                             noise_search_batched=batched, noise_search_max_rows=r)

        def search_only():
            p = predictor(True, 1)
            return engine.sample(p.array_batch(batch), torch.Generator(dev).manual_seed(0),
                                 num_steps=1, cfg_scale=4.0, noise_iters=noise_iters,
                                 noise_search_batched=True, return_latents=True)

        runs = {"search": search_only,
                "batched": lambda: predictor(True, 2)(batch, torch.Generator(dev).manual_seed(0)),
                "sequential": lambda: predictor(False, 2)(batch,
                                                          torch.Generator(dev).manual_seed(0))}
        results[r] = {}
        for what, fn in runs.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            try:
                out = fn()
                torch.cuda.synchronize(dev)
                results[r][what] = torch.cuda.max_memory_allocated(dev) / 2**30
                del out
            except torch.cuda.OutOfMemoryError:
                results[r][what] = None
            peak = results[r][what]
            print(f"{r} rows (B={b}) {what}: " + ("out of memory" if peak is None else
                                                   f"peak {peak:.2f} GiB"), flush=True)
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", nargs="?", default="all", choices=("attention", "search", "all"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sizing_probe: no CUDA device found; these are card measurements")
    if args.what in ("attention", "all"):
        attention_fp32()
    if args.what in ("search", "all"):
        search_memory()


if __name__ == "__main__":
    main()
