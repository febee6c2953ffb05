"""STR model benchmark: parameters, FLOPs and latency (port of
`scripts/str_bench.py`; src/parseq/bench.py:28-59 parity, which uses
torch.utils.benchmark and fvcore).

FLOPs are counted by `torch.utils.flop_counter` over one forward; the
latency is the median over 5 runs of 10 back-to-back forwards, timed by
CUDA events on the card (the host clock with --device cpu).

Usage: python -m udifftext_tpu_torch.scripts.str_bench [parseq|parseq-tiny|vitstr|abinet|trba|crnn]
       [batch] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models.str_hub import build_model
from ._timing import probe_device, time_ms


@torch.no_grad()
def bench(name: str, batch: int, device: torch.device, reps: int = 10,
          runs: int = 5) -> Dict[str, float]:
    """Parameters (M), GFLOPs of one forward at `batch` 32×128 images, and
    the median ms per forward, of hub model `name` with seed-0 weights."""
    torch.manual_seed(0)
    # no parameter requires grad: flop_counter's module tracker hooks the
    # autograd graph of any that does, which no_grad leaves unbuilt
    model = build_model(name).to(device).eval().requires_grad_(False)
    x = torch.zeros(batch, 32, 128, 3, device=device)
    counter = FlopCounterMode(display=False)
    with counter:
        model(x)
    ms = time_ms(lambda: model(x), reps, runs, device)
    return {"params_m": sum(p.numel() for p in model.parameters()) / 1e6,
            "gflops": counter.get_total_flops() / 1e9, "ms": ms,
            "images_per_s": batch / ms * 1e3}


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("model", nargs="?", default="parseq")
    ap.add_argument("batch", nargs="?", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = probe_device("str_bench", args.device)
    r = bench(args.model, args.batch, device)
    where = (f"{torch.cuda.get_device_name(device)}, CUDA events" if device.type == "cuda"
             else "CPU, host clock")
    print(f"model: {args.model}")
    print(f"params: {r['params_m']:.3f} M")
    print(f"flops (torch.utils.flop_counter, batch {args.batch}): {r['gflops']:.3f} GFLOPs")
    print(f"median latency: {r['ms']:.3f} ms per forward ({where}; batch {args.batch}, "
          f"{r['images_per_s']:.1f} images/s)")
    return r


if __name__ == "__main__":
    main()
