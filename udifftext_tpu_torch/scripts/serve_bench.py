"""Serving benchmark of the port (port of `scripts/serve_bench.py`):
`InpaintService` throughput and latency on the card.

Two phases, after a warmup group per bucket:

1. saturated: `batches × max_batch` requests submitted at once to a
   service with a long coalescing deadline (`--saturated-delay-ms`), so the
   dispatcher runs full groups back to back; samples/s is the server's
   capacity. With `--pipeline 2` the next group's host work overlaps this
   group's device work; `overlap` reports how much of each later group's
   launch ran before the group ahead of it had finished.
2. latency: requests one at a time at `--qps`, paced from completion, each
   a group of one padded to the smallest bucket: p50/p95 end to end.

The full predict flow runs (conditioner, init-noise search, the Euler steps
with CFG, fp32 VAE decode) on uint8 512² requests, at full width
(`builders.TEXTDESIGN_SD_2`) with seeded random weights
(`randomize_parameters`). Prints one JSON line; the metric name marks the
port and the device (`torch_h100_serve_512_50step_samples_per_sec` on an
H100).

  python -m udifftext_tpu_torch.scripts.serve_bench [--max-batch 8]
      [--buckets 1,8] [--pipeline 2] [--steps 50] [--scale 5.0]
      [--noise-iters 10] [--noise-search-batched] [--batches 4] [--qps 0.5]
      [--latency-requests 8] [--device cuda|cpu]
  torchrun --nproc_per_node N -m udifftext_tpu_torch.scripts.serve_bench --dp N ...

`run(...)` is the entry function (chip_smoke.py calls it with small counts).
With dp > 1 it runs inside a process group of dp processes, through the
service's data-parallel path (`scripts/serve.data_parallel_predict_fn`):
rank 0 measures and returns the record, the other ranks serve its groups and
return None.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..builders import TEXTDESIGN_SD_2
from ..parallel import dist
from ..serving import InpaintRequest, InpaintService
from . import serve

RESULT_TIMEOUT_S = 1200.0  # a request that has not come back by then has failed


def request(size: int = 512, text: str = "bench") -> InpaintRequest:
    """The benchmark's request: seeded uint8 noise, a centered square mask."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (size, size, 3), np.uint8)
    mask = np.zeros((size, size), np.uint8)
    mask[size // 4: 3 * size // 4, size // 4: 3 * size // 4] = 1
    return InpaintRequest(image=img, mask=mask, text=text)


def metric_name(device: torch.device, size: int, steps: int) -> str:
    tag = device.type
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        tag = "h100" if "H100" in name else "cuda"
    return f"torch_{tag}_serve_{size}_{steps}step_samples_per_sec"


@dataclasses.dataclass
class Bench:
    """What `run` measured: the JSON record, the predictor callable the
    services shared, the request, each phase's responses, and per batch_key
    the launch interval and the completion time (seconds on
    time.perf_counter)."""

    record: Dict[str, Any]
    predict: Callable
    request: InpaintRequest
    saturated: List[Dict[str, Any]]
    latency: List[Dict[str, Any]]
    timeline: Dict[int, List[Optional[float]]]
    make_service: Callable[[float], InpaintService]


def _overlap(timeline: Dict[int, List[Optional[float]]], keys: Sequence[int]) -> Dict[str, Any]:
    """For each group after the first of `keys` (in launch order): how much
    of its launch (host work on the dispatcher thread) ran before the group
    ahead of it completed."""
    launch = overlapped = 0.0
    for prev, key in zip(keys, keys[1:]):
        a, b, _ = timeline[key]
        done = timeline[prev][2]
        launch += b - a
        overlapped += max(0.0, min(b, done) - a)
    return {"groups": len(keys), "launch_s": launch, "overlapped_s": overlapped,
            "share": overlapped / launch if launch > 0 else 0.0}


def run(max_batch: int = 8, steps: int = 50, noise_iters: int = 10, batches: int = 4,
        qps: float = 0.5, latency_requests: int = 8, max_delay_ms: float = 50.0,
        buckets: Optional[Sequence[int]] = None, noise_search_batched: bool = False,
        pipeline: int = 1, saturated_delay_ms: float = 2000.0, cfg_scale: float = 5.0,
        model_cfg: Optional[Mapping[str, Any]] = None, size: int = 512,
        device: str = "cuda", dp: int = 1) -> Optional[Bench]:
    """Both phases on an engine with `randomize_parameters(0)` weights (the
    graph `model_cfg`, by default the shipped one, at image size `size`);
    with dp > 1 on every process of a group of dp (None on all but rank 0)."""
    dev = torch.device(device)
    cfgs = {"load_ckpt_path": None, "bf16": dev.type == "cuda", "H": size, "seq_len": 12,
            "steps": steps, "scale": [cfg_scale, 0.0], "noise_iters": noise_iters}
    graph = TEXTDESIGN_SD_2 if model_cfg is None else model_cfg
    if dp > 1:
        predict = serve.data_parallel_predict_fn(cfgs, graph, dev, dp, seed=0,
                                                 noise_search_batched=noise_search_batched)
        if dist.rank_and_world()[0] != 0:
            predict.serve()
            return None
        dev = predict.device
    else:
        predict = serve.build_predict_fn(cfgs, graph, dev, seed=0,
                                         noise_search_batched=noise_search_batched)
    timeline: Dict[int, List[Optional[float]]] = {}

    def timed(arr_batch, key):
        t0 = time.perf_counter()
        images = predict(arr_batch, key)
        timeline[key] = [t0, time.perf_counter(), None]
        return images

    def make(delay_ms: float) -> InpaintService:
        # the services share one predictor; only the coalescing deadline differs
        return InpaintService(timed, max_batch=max_batch, max_delay_ms=delay_ms, size=size,
                              batch_buckets=buckets, pipeline_depth=pipeline, dp=dp)

    def submit(svc: InpaintService, req: InpaintRequest):
        fut = svc.submit(req)

        def done(f):
            if not f.cancelled() and f.exception() is None:
                entry = timeline[f.result()["batch_key"]]
                entry[2] = entry[2] or time.perf_counter()

        fut.add_done_callback(done)
        return fut

    req = request(size)
    service = make(max_delay_ms)
    t0 = time.perf_counter()
    service.warmup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    warmup_s = time.perf_counter() - t0

    # 1. saturated throughput, on a service whose long deadline fills every group
    sat_service = make(saturated_delay_ms)  # its batch keys count from 0 again
    timeline.clear()
    n = batches * max_batch
    t0 = time.perf_counter()
    futures = [submit(sat_service, req) for _ in range(n)]
    saturated = [f.result(timeout=RESULT_TIMEOUT_S) for f in futures]
    saturated_s = time.perf_counter() - t0
    sat_stats = sat_service.stats()
    sat_service.shutdown()
    sat_keys = sorted({r["batch_key"] for r in saturated})

    # 2. single-request latency at a fixed rate, paced from completion: a
    # fixed-rate clock would queue behind the card and measure the queue
    latency, lat = [], []
    period = 1.0 / qps if qps > 0 else 0.0
    for _ in range(latency_requests):
        t0 = time.perf_counter()
        latency.append(submit(service, req).result(timeout=RESULT_TIMEOUT_S))
        lat.append(time.perf_counter() - t0)
        if period:
            time.sleep(max(0.0, period - (time.perf_counter() - t0)))
    stats = service.stats()
    service.shutdown()
    if dp > 1:
        predict.stop()

    record = {
        "metric": metric_name(dev, size, steps),
        "value": n / saturated_s,
        "unit": "samples/s",
        "scope": (f"InpaintService saturated throughput: {batches} full groups of "
                  f"max_batch={max_batch} through the micro-batcher; full predict flow "
                  f"({steps} steps, CFG {cfg_scale}, {noise_iters}-candidate noise search, "
                  f"conditioner, fp32 VAE decode), uint8 {size}x{size} requests"),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "latency_p50_s": float(np.percentile(lat, 50)) if lat else None,
        "latency_p95_s": float(np.percentile(lat, 95)) if lat else None,
        "latency_s": lat,  # each single request's, in order
        "latency_qps": qps,
        "latency_note": (f"single request padded to the smallest fitting bucket of "
                         f"{list(service.batch_buckets)} (group of 1); includes host batch "
                         "assembly"),
        "buckets": list(service.batch_buckets),
        "noise_search_batched": bool(noise_search_batched),
        "pipeline_depth": pipeline,
        "dp": dp,
        "compile_s": warmup_s,  # the warmup groups (nothing is compiled ahead on the card)
        "overlap": _overlap(timeline, sat_keys),
        "batcher_stats": stats,
        "saturated_batcher_stats": sat_stats,
    }
    return Bench(record, predict, req, saturated, latency, timeline, make)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("--noise-iters", type=int, default=10)
    p.add_argument("--batches", type=int, default=4, help="full groups in the saturated phase")
    p.add_argument("--qps", type=float, default=0.5)
    p.add_argument("--latency-requests", type=int, default=8)
    p.add_argument("--max-delay-ms", type=float, default=50.0)
    p.add_argument("--buckets", type=lambda s: [int(b) for b in s.split(",")], default=None,
                   help="batch buckets (largest == --max-batch), e.g. '1,8'")
    p.add_argument("--noise-search-batched", action="store_true")
    p.add_argument("--pipeline", type=int, default=1, help="InpaintService pipeline_depth")
    p.add_argument("--saturated-delay-ms", type=float, default=2000.0,
                   help="coalescing deadline of the saturated phase only")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel degree, under torchrun --nproc_per_node equal to it")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("serve_bench: no CUDA device found; --device cpu runs on the CPU")
    bench = run(max_batch=args.max_batch, steps=args.steps, noise_iters=args.noise_iters,
                batches=args.batches, qps=args.qps, latency_requests=args.latency_requests,
                max_delay_ms=args.max_delay_ms, buckets=args.buckets,
                noise_search_batched=args.noise_search_batched, pipeline=args.pipeline,
                saturated_delay_ms=args.saturated_delay_ms, cfg_scale=args.scale,
                device=args.device, dp=args.dp)
    if bench is not None:
        print(json.dumps(bench.record))


if __name__ == "__main__":
    main()
