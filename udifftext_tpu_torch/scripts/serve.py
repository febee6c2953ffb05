"""HTTP inference server for scene-text inpainting on the port (port of
`scripts/serve.py`): a threaded stdlib HTTP server in front of
`serving.InpaintService`, which micro-batches concurrent requests.

Endpoints
---------
POST /v1/inpaint   {"image": <b64 PNG/JPEG>, "mask": <b64 PNG>, "text": "WORD"}
                   -> {"image": <b64 PNG>, "batch_key": int, "row": int,
                       "batch_size": int}   (the replay coordinates)
                   400 on a bad request, 500 on a model failure
GET  /healthz      -> 200 once warmup has run every bucket, 503 before
GET  /v1/stats     -> batcher counters (requests, batches, mean batch size,
                      queue-wait and model-call p50/p95)

Usage
-----
  python -m udifftext_tpu_torch.scripts.serve [--config ./configs/demo.yaml]
      [--port 8000] [--max-batch 8] [--max-delay-ms 50] [--buckets 1,8]
      [--pipeline 2] [--steps N] [--scale S] [--seed 0]
      [--noise-search-batched] [--device cuda|cpu]
  torchrun --nproc_per_node N -m udifftext_tpu_torch.scripts.serve --dp N ...

With --dp N (one process per card, N = WORLD_SIZE, every bucket a multiple
of N) rank 0 runs the HTTP server, the batcher and the service, and the
other ranks sample their rows of each group (`serving.DataParallelPredictor`);
a group's images do not depend on N beyond the kernels' rounding.

The model graph, checkpoints and sampler settings come from the run config
(`loading.init_model`; without a checkpoint file the weights are seeded
random); --steps/--scale override it. SIGTERM stops accepting, lets the
queued groups finish, then exits. PNG coding needs Pillow (and the run
config PyYAML); the card's machine has neither, so there the service runs
through `build_service` (scripts/serve_bench.py, chip_smoke.py).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..loading import init_model, init_sampling
from ..parallel import dist
from ..parallel.mesh import make_groups
from ..predict import Predictor
from ..serving import (DataParallelPredictor, DataParallelService, InpaintRequest,
                       InpaintService, batch_seed)
from ..utils.encprop_gate import ckpt_id_if_encprop


def _b64_image(data_b64: str, mode: str) -> np.ndarray:
    from PIL import Image

    raw = base64.b64decode(data_b64, validate=True)
    return np.asarray(Image.open(io.BytesIO(raw)).convert(mode))


def _png_b64(arr: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def make_handler(service: InpaintService, ready: threading.Event):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D102 — keep the default logging quiet
            pass

        def _reply(self, code: int, payload) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                if ready.is_set():
                    self._reply(200, {"status": "ok"})
                else:
                    self._reply(503, {"status": "warming up"})
            elif self.path == "/v1/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/inpaint":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length))
                image = _b64_image(req["image"], "RGB")
                mask = _b64_image(req["mask"], "L")
                result = service.inpaint(
                    InpaintRequest(image=image, mask=mask, text=req["text"]),
                    timeout=float(req.get("timeout", 600.0)))
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — report model-side failures
                self._reply(500, {"error": str(e)})
                return
            self._reply(200, {"image": _png_b64(result["image"]),
                              "batch_key": result["batch_key"], "row": result["row"],
                              "batch_size": result["batch_size"]})

    return Handler


def serve(service: InpaintService, port: int, ready: threading.Event,
          broken: Optional[threading.Event] = None) -> None:
    """Serve HTTP until SIGTERM, Ctrl-C or `broken` is set, then shut the
    service down."""
    import signal

    httpd = ThreadingHTTPServer(("0.0.0.0", port), make_handler(service, ready))

    def _drain(signum, _frame):
        # SIGTERM: stop accepting; service.shutdown() below serves what is queued
        print(f"signal {signum}: draining and shutting down", flush=True)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    if broken is not None:
        def _on_broken():
            broken.wait()
            print("the data-parallel group failed: shutting down", flush=True)
            httpd.shutdown()

        threading.Thread(target=_on_broken, daemon=True).start()
    print(f"serving on :{port} (POST /v1/inpaint, GET /healthz, GET /v1/stats)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.shutdown()


def build_predict_fn(cfgs: Mapping[str, Any], model_cfg: Optional[Mapping[str, Any]] = None,
                     device: torch.device | str = "cuda", steps: Optional[int] = None,
                     scale: Optional[float] = None, seed: int = 0,
                     noise_search_batched: bool = False, data_group: Any = None
                     ) -> Callable[[Dict[str, np.ndarray], int], Any]:
    """The service's predictor callable for a run config `cfgs` (a dict:
    load_ckpt_path, bf16, steps, scale, noise_iters, encprop_interval;
    the graph from `model_cfg` or cfgs' model_cfg_path): batch `key` runs
    `Predictor` with the generator seeded by `batch_seed(seed, key)` and
    returns the uint8 images on the engine's device. The `Predictor` is
    kept as the callable's `.predictor`, the latest call's aux (the search's
    scores) as its `.last_aux`. With a `data_group` every process
    of the group makes the same call on the same batch and samples its own
    rows of it."""
    bundle = init_model(cfgs, device, seed=seed, model_cfg=model_cfg)
    sampling = init_sampling(cfgs)
    predictor = Predictor(
        bundle.engine,
        num_steps=int(steps if steps is not None else sampling.num_steps),
        cfg_scale=float(scale if scale is not None else sampling.cfg_scale),
        noise_iters=int(cfgs.get("noise_iters", 10)),
        encprop_interval=int(cfgs.get("encprop_interval", 0)),
        ckpt_id=ckpt_id_if_encprop(cfgs),
        noise_search_batched=noise_search_batched,
        data_group=data_group,
    )
    dev = bundle.engine.device

    def run(arr_batch: Dict[str, np.ndarray], key: int):
        images, run.last_aux = predictor(arr_batch,
                                         torch.Generator(dev).manual_seed(batch_seed(seed, key)))
        return images

    run.predictor = predictor
    run.last_aux = None
    return run


def data_parallel_predict_fn(cfgs: Mapping[str, Any], model_cfg: Optional[Mapping[str, Any]],
                             device: torch.device | str, dp: int,
                             **predict_kw) -> DataParallelPredictor:
    """`build_predict_fn` over a data group of `dp` processes, wrapped in a
    `DataParallelPredictor`: the process group is the one torchrun's
    environment describes (joined here if it is not yet; a caller that
    shares one card between processes joins its gloo group itself), and
    `dp` must be its size."""
    dev = dist.maybe_init_distributed(device)
    if not dist.is_distributed():
        raise ValueError(f"dp={dp} needs a process group of {dp} processes, one per card "
                         f"(torchrun --nproc_per_node {dp}); this process has none")
    world = dist.rank_and_world()[1]
    if world != dp:
        raise ValueError(f"--dp {dp} must equal the process group's size (WORLD_SIZE {world})")
    group = make_groups(dp, 1).data
    run = build_predict_fn(cfgs, model_cfg, dev, data_group=group, **predict_kw)
    front = DataParallelPredictor(run, group, run.predictor.engine.device,
                                  int(cfgs.get("H", 512)), int(cfgs.get("seq_len", 12)))
    front.predictor = run.predictor
    return front


def build_service(cfgs: Mapping[str, Any], model_cfg: Optional[Mapping[str, Any]] = None,
                  device: torch.device | str = "cuda", max_batch: int = 8,
                  max_delay_ms: float = 50.0, buckets: Optional[Sequence[int]] = None,
                  pipeline: int = 1, dp: int = 1,
                  **predict_kw) -> Union[InpaintService, DataParallelPredictor]:
    """An `InpaintService` over `build_predict_fn(cfgs, model_cfg, device,
    **predict_kw)` at the run config's image size (H) and seq_len. With dp >
    1, inside a process group of dp processes (`data_parallel_predict_fn`):
    on rank 0 a `DataParallelService` (its shutdown stops the other ranks),
    on every other rank the `DataParallelPredictor`, whose `serve()` is that
    rank's loop."""
    size, seq_len = int(cfgs.get("H", 512)), int(cfgs.get("seq_len", 12))
    kw = dict(max_batch=max_batch, max_delay_ms=max_delay_ms, size=size, seq_len=seq_len,
              batch_buckets=buckets, pipeline_depth=pipeline, dp=dp)
    if dp > 1:
        front = data_parallel_predict_fn(cfgs, model_cfg, device, dp, **predict_kw)
        if dist.rank_and_world()[0] != 0:
            return front
        return DataParallelService(front, **kw)
    return InpaintService(build_predict_fn(cfgs, model_cfg, device, **predict_kw), **kw)


def main(argv=None) -> None:
    from ..config import load_config

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="./configs/demo.yaml")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--buckets", type=lambda s: [int(b) for b in s.split(",")], default=None,
                   help="comma-separated batch buckets, the largest == --max-batch (e.g. "
                        "'1,8'): each group is padded only to the smallest bucket that fits it")
    p.add_argument("--noise-search-batched", action="store_true",
                   help="run the init-noise search with the candidates stacked on the batch "
                        "axis (exact; memory grows with noise_iters × bucket)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel serving degree: one process per card under torchrun "
                        "(--nproc_per_node equal to it); every bucket must divide by it")
    p.add_argument("--max-delay-ms", type=float, default=50.0)
    p.add_argument("--pipeline", type=int, default=1,
                   help="pipeline depth: > 1 overlaps the next group's host work with the "
                        "card's compute on this one")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--scale", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve: no CUDA device found; run on a machine with a GPU, or pass "
                         "--device cpu to run (slowly) on the CPU")
    if args.dp > 1:
        world = int(os.environ.get("WORLD_SIZE", 1))
        if world != args.dp:
            raise SystemExit(f"--dp {args.dp} must equal WORLD_SIZE ({world}): start it with "
                             f"torchrun --nproc_per_node {args.dp}")
        if device.type == "cuda" and torch.cuda.device_count() < args.dp:
            raise SystemExit(f"--dp {args.dp} requested but only {torch.cuda.device_count()} "
                             f"device(s) visible")

    service = build_service(load_config(args.config), device=device, max_batch=args.max_batch,
                            max_delay_ms=args.max_delay_ms, buckets=args.buckets,
                            pipeline=args.pipeline, dp=args.dp, steps=args.steps,
                            scale=args.scale, seed=args.seed,
                            noise_search_batched=args.noise_search_batched)
    if isinstance(service, DataParallelPredictor):  # a rank other than 0
        print(f"data-parallel worker: {service.serve()} groups served", flush=True)
        return
    ready = threading.Event()

    def warmup():
        try:
            service.warmup()
        except Exception as e:  # noqa: BLE001 — keep /healthz at 503, and say why
            print(f"FATAL: warmup failed, /healthz stays 503: {e}", flush=True)
            raise
        ready.set()
        print(f"warm for buckets {service.batch_buckets}; serving traffic", flush=True)

    threading.Thread(target=warmup, daemon=True).start()
    broken = service.predictor.broken if isinstance(service, DataParallelService) else None
    serve(service, args.port, ready, broken)
    if broken is not None and broken.is_set():
        raise SystemExit("serve: a group failed on the data-parallel group; ending the job")


if __name__ == "__main__":
    main()
