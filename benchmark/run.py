"""Runs one cell of BENCHMARK.json once and prints its result line.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell names a configuration
(benchmark/configs/<config>.json: the model graph as the program takes it,
its settings and the limits of the comparison) and a traffic mix
(benchmark/traffic/<mix>.json, read by benchmark/traffic.py); each per-layer
metric is read by benchmark/metrics/<metric>.py. A configuration's `mode`
picks the driver: "serve" drives `serving.InpaintService` as the serve CLI
builds it, "train" drives `parallel.train.train_step` as the train CLI runs
it. Weights and inputs come from the seed; the set-up warms every shape the
window uses, the window runs for --seconds, and the program's outputs are
then held to the plain reference (benchmark/judge.py). The reference and the
count of operations are the modules the configuration names
(benchmark/modules.py; by default benchmark/reference and benchmark/flops).

With --trace 0 the metrics are the cell's end-to-end ones; with --trace 1
its per-layer ones, read from counters, the window, and a torch.profiler
window over whole groups or steps run after the measured window closes.
The last line of standard output is the result as JSON; the numbers
compared for `correct` are also the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Callable, Dict, List, Optional, Tuple  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "udifftext_tpu")
GIB = 2.0 ** 30
DRAIN_S = 120.0
Control = Tuple[Any, Any]  # (the UNet's Precision, the autoencoder's and LabelEncoder's)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int


def load_cell(root: Path, name: str) -> Cell:
    """The workload `name` of root/BENCHMARK.json with its configuration,
    its traffic mix and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{work['traffic']}.json").read_text())

    def applies(m: dict) -> bool:
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name, config, traffic, e2e, per_layer, int(work["chips"]))


def reader(root: Path, metric: str) -> Callable[["Readout"], Optional[float]]:
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Readout:
    """What the per-layer readers read: the cell, the window's seconds and
    the operations of the work it completed, the program's counters at the
    window's close, and the profiler window's summary."""

    cell: Cell
    seconds: float = 0.0
    flops: float = 0.0
    counters: Optional[dict] = None
    trace: Any = None
    traced_units: int = 0  # groups or steps inside the profiler window


class Tracer:
    """A torch.profiler window over `n` whole groups or steps, opened and
    closed on the thread that runs them, with the device synchronized at
    both ends."""

    def __init__(self, device):
        self.device, self.n, self.seen, self.prof = device, 0, 0, None
        self.done = threading.Event()
        self.t0 = self.t1 = 0.0

    def arm(self, n: int) -> None:
        self.n = n

    def enter(self) -> None:
        import torch
        if self.n and self.prof is None and not self.done.is_set():
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":  # device activity alone: see benchmark/trace.py
                torch.cuda.synchronize(self.device)
                acts = [torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.t0 = time.perf_counter()

    def exit(self) -> None:
        import torch
        if self.prof is None or self.done.is_set():
            return
        self.seen += 1
        if self.seen == self.n:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.t1 = time.perf_counter()
            self.prof.stop()
            self.done.set()

    def summary(self):
        from .trace import summarize
        return summarize(self.prof, self.t1 - self.t0)


def group_draws(seed: int, key: int, b: int, latent: int, iters: int, device):
    """A served group's draws: the masked image's posterior noise (b, h, w, 4)
    and the search's candidates (iters, b, h, w, 4)."""
    import torch
    from .weights import sub_seed
    g = torch.Generator(device).manual_seed(sub_seed(seed, f"group:{key}"))
    post = torch.randn((b, latent, latent, 4), generator=g, device=device)
    return post, torch.randn((max(iters, 1), b, latent, latent, 4), generator=g, device=device)


def reference_networks(cfg: dict):
    import torch
    from .modules import reference
    ref = reference(cfg)
    with torch.device("meta"):
        return ref.Networks(cfg["graph"], ref.NUM_CLASSES)


def seeded_weights(cfg: dict, seed: int, device, train: bool):
    import torch
    from .modules import reference
    from .weights import iter_weights
    return iter_weights(reference_networks(cfg), seed, device, cfg["graph"],
                        getattr(torch, cfg["unet_dtype"]), train, reference(cfg))


def load_program_weights(engine, cfg: dict, seed: int, device, train: bool) -> None:
    """The seeded weights copied into the program's engine: every parameter
    the reference names, in the dtype the configuration serves it in."""
    import torch
    state = engine.state_dict()
    with torch.no_grad():
        for name, value in seeded_weights(cfg, seed, device, train):
            t = state.pop(name, None)
            if t is None or t.shape != value.shape or t.dtype != value.dtype:
                raise RuntimeError(f"the program's {name} is {None if t is None else (tuple(t.shape), t.dtype)}, "
                                   f"the configuration's {(tuple(value.shape), value.dtype)}")
            t.copy_(value)
    if state:
        raise RuntimeError(f"the program holds weights the reference does not: {sorted(state)[:3]}")


def free_device() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def nearest_rank(values: List[float], q: float) -> float:
    xs = sorted(values)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


# -- a served cell --------------------------------------------------------------

def serve_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
               controls: Optional[Dict[str, Control]] = None) -> dict:
    import numpy as np
    import torch
    from udifftext_tpu_torch.builders import build_engine
    from udifftext_tpu_torch.predict import Predictor
    from udifftext_tpu_torch.serving import InpaintRequest, InpaintService

    from . import modules, traffic
    from .weights import sub_seed

    cfg, mix = cell.config, cell.traffic
    flops = modules.counts(cfg)
    size, seq, smp, srv = cfg["image_size"], cfg["seq_len"], cfg["sampler"], cfg["serving"]
    bundle = build_engine(cfg["graph"], getattr(torch, cfg["unet_dtype"]), device)
    load_program_weights(bundle.engine, cfg, seed, device, train=False)
    predictor = Predictor(bundle.engine, num_steps=smp["num_steps"], cfg_scale=smp["cfg_scale"],
                          noise_iters=smp["noise_iters"],
                          noise_search_batched=smp["noise_search_batched"])
    latent = size // bundle.engine.latent_factor
    scores: Dict[int, Any] = {}
    tracer = Tracer(device)

    def run(arr_batch, key):
        post, noise = group_draws(seed, key, len(arr_batch["image"]), latent, smp["noise_iters"],
                                  device)
        tracer.enter()
        images, aux = predictor(arr_batch, posterior_eps=post, noise=noise)
        scores[key] = aux.get("noise_scores")
        tracer.exit()
        return images

    service = InpaintService(run, max_batch=srv["max_batch"], max_delay_ms=srv["max_delay_ms"],
                             size=size, seq_len=seq, batch_buckets=srv["buckets"],
                             pipeline_depth=srv["pipeline"])
    pool = traffic.requests(mix, seed, size, modules.reference(cfg).CHARSET)
    service.warmup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START

    lock = threading.Lock()
    done: List[tuple] = []  # (due, done, key, row, request index, image or None)
    stop = threading.Event()
    threads: List[threading.Thread] = []
    closed = mix["kind"] == "closed_loop"

    def finish(due, i, fut):
        try:
            res = fut.result()
            item = (due, time.perf_counter(), res["batch_key"], res["row"], i, res["image"])
        except Exception as e:  # noqa: BLE001 — a failed request counts as missing
            print(f"request {i} failed: {e!r}", file=sys.stderr)
            item = (due, time.perf_counter(), None, None, i, None)
        with lock:
            done.append(item)

    def submit(i):
        r = pool[i % len(pool)]
        return service.submit(InpaintRequest(r.image, r.mask, r.text))

    lags: List[float] = []
    sent: List[Any] = []
    if closed:
        counter = iter(range(10 ** 9))

        def client():
            while not stop.is_set():
                with lock:
                    i = next(counter)
                t = time.perf_counter()
                finish(t, i, submit(i))

        threads = [threading.Thread(target=client, daemon=True) for _ in range(mix["clients"])]
    else:
        gaps = traffic.arrival_gaps(mix, seconds + 60.0)

        def sender():
            due = time.perf_counter()
            for i, gap in enumerate(gaps):
                due += gap
                while (wait := due - time.perf_counter()) > 0:
                    time.sleep(min(wait, 0.05))
                if stop.is_set():
                    return
                lags.append(time.perf_counter() - due)
                fut = submit(i)
                fut.add_done_callback(lambda f, d=due, j=i: finish(d, j, f))
                sent.append(fut)

        threads = [threading.Thread(target=sender, daemon=True)]
    for t in threads:
        t.start()
    while True:  # the window opens at the first group's completion
        with lock:
            first = next((it[2] for it in done if it[2] is not None), None)
        if first is not None:
            break
        time.sleep(0.005)
    time.sleep(0.2)  # a group's replies resolve together; let every one be recorded
    with lock:
        t0 = max(it[1] for it in done if it[2] == first)
    t_close = t0 + seconds
    time.sleep(max(0.0, t_close - time.perf_counter()))
    counters = service.stats()
    if trace:
        tracer.arm(mix["trace_groups"])
        if not tracer.done.wait(timeout=300):
            raise RuntimeError("the traced groups did not complete")
    stop.set()
    for t in threads:
        t.join(timeout=DRAIN_S)
    for fut in list(sent):
        try:
            fut.result(timeout=DRAIN_S)
        except Exception:  # noqa: BLE001 — recorded by its callback
            pass
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    service.shutdown()
    with lock:
        items = list(done)

    bucket = max(srv["buckets"])
    per_sample = flops.serve_group(cfg["graph"], bucket, size, smp["num_steps"],
                                   smp["noise_iters"]) / bucket
    if closed:
        finished: Dict[int, float] = {}
        for it in items:
            if it[2] is not None:
                finished[it[2]] = max(finished.get(it[2], 0.0), it[1])
        in_window = {k for k, t in finished.items() if t0 < t <= t_close}
        window = [it for it in items if (it[2] in in_window if it[2] is not None
                                         else t0 < it[1] <= t_close)]
        units = sum(1 for it in window if it[2] is not None)
        span = max((finished[k] for k in in_window), default=t_close) - t0
        e2e = {"serve_samples_per_s": units / span}
        attempted, failed = len(window), sum(1 for it in window if it[2] is None)
    else:
        window = [it for it in items if t0 <= it[0] <= t_close]
        lat = [it[1] - it[0] if it[2] is not None else float("inf") for it in window]
        units = sum(1 for it in window if it[2] is not None)
        span = seconds
        e2e = {"serve_latency_p90_s": nearest_rank(lat, 0.9)}
        attempted, failed = len(window), sum(1 for it in window if it[2] is None)
        late = sorted(lags)
        print(f"open loop: {len(lags)} sent, send lag median {late[len(late) // 2]:.6f} s, "
              f"max {late[-1]:.6f} s", flush=True)
    readout = Readout(cell, span, units * per_sample, counters,
                      tracer.summary() if trace else None, mix.get("trace_groups", 0))

    # -- correctness: one group from the window, drawn from the seed --------------
    rng = np.random.default_rng(sub_seed(seed, "check"))
    keys = sorted({it[2] for it in window if it[2] is not None})
    if not keys:
        raise RuntimeError("no group completed inside the window")
    key = int(rng.choice(keys))
    rows = {it[3]: it for it in items if it[2] == key}
    n_real = len(rows)
    by_len = sorted(rows, key=lambda r: (-len(pool[rows[r][4] % len(pool)].text), r))
    others = [r for r in rng.permutation(n_real).tolist() if r != by_len[0]]
    checked = sorted([by_len[0]] + others[:mix["checked_rows"] - 1])
    check = {"key": key, "bucket": bucket, "latent": latent, "checked": checked,
             "reqs": [pool[rows[r][4] % len(pool)] for r in range(n_real)],
             "choice": int(torch.argmin(scores[key])),
             "images": torch.as_tensor(np.stack([rows[r][5] for r in checked]))}
    del predictor, bundle, service, scores, run, items, done
    free_device()
    t_ref = time.perf_counter()
    numbers = serve_reference(cfg, seed, check, device, controls)
    return {"e2e": e2e, "setup_s": setup_s, "peak": peak, "attempted": attempted,
            "failed": failed, "readout": readout, "numbers": numbers.pop("program"),
            "controls": numbers, "reference_s": time.perf_counter() - t_ref}


def serve_batch(cfg: dict, reqs, bucket: int, device):
    """A group's uint8 batch as the service pads it (the last request
    repeated), on `device`, for the reference."""
    import numpy as np
    import torch
    from .modules import reference
    encode_text, seq = reference(cfg).encode_text, cfg["seq_len"]
    reqs = list(reqs) + [reqs[-1]] * (bucket - len(reqs))
    seg_mask = np.zeros((bucket, seq), np.float32)
    for i, r in enumerate(reqs):
        seg_mask[i, :len(r.text)] = 1.0
    arr = {"image": np.stack([r.image for r in reqs]),
           "mask": np.stack([(r.mask > 0).astype(np.uint8) * 255 for r in reqs])[..., None],
           "label_ids": np.stack([encode_text(r.text, seq) for r in reqs]),
           "seg_mask": seg_mask}
    return {k: torch.as_tensor(v, device=device) for k, v in arr.items()}


def serve_reference(cfg: dict, seed: int, check: dict, device,
                    controls: Optional[Dict[str, Control]] = None) -> Dict[str, Dict[str, float]]:
    """The numbers of a checked group against the reference: of the
    program's outputs ("program") and of each of `controls`, the reference at
    that arithmetic put in the program's place (its own search choosing its
    candidate). The reference follows the candidate each side chose."""
    import torch
    from .judge import serve_numbers
    from .modules import reference
    ref_mod = reference(cfg)
    smp = cfg["sampler"]
    outs = {"program": (check["choice"], check["images"])}
    with ref_mod.fp32_products():
        batch = serve_batch(cfg, check["reqs"], check["bucket"], device)
        post, noise = group_draws(seed, check["key"], check["bucket"], check["latent"],
                                  smp["noise_iters"], device)
        idx = torch.as_tensor(check["checked"], device=device)
        rows = {k: v[idx] for k, v in batch.items()}

        def sample(net, choice):
            return net.sample_rows(rows, post[idx], noise[choice][idx], smp["num_steps"],
                                   smp["cfg_scale"])

        for name, (prec, frozen) in (controls or {}).items():
            ctrl = ref_mod.Reference(cfg, device, seeded_weights(cfg, seed, device, train=False),
                                     prec, frozen)
            choice = int(torch.argmin(ctrl.search_scores(batch, post, noise, smp["cfg_scale"])))
            outs[name] = (choice, sample(ctrl, choice))
            del ctrl
            free_device()
        ref = ref_mod.Reference(cfg, device, seeded_weights(cfg, seed, device, train=False))
        ref_images = {c: sample(ref, c) for c in {c for c, _ in outs.values()}}
    del ref
    free_device()
    return {name: serve_numbers(images, ref_images[choice]) for name, (choice, images) in outs.items()}


# -- a fine-tuning cell -----------------------------------------------------------

def train_rows(cell: Cell, seed: int, step: int, device) -> List[dict]:
    """The rows of a step's micro-batches, on `device`."""
    from . import modules, traffic
    cfg = cell.config
    charset = modules.reference(cfg).CHARSET
    return [traffic.train_rows(cell.traffic, seed, step, j, cfg["image_size"], cfg["seq_len"],
                               charset, device)
            for j in range(cell.traffic["accumulate"])]


def train_draws(cell: Cell, seed: int, step: int, device) -> List[dict]:
    """The loss's draws of a step's micro-batches, on `device`."""
    from . import traffic
    graph = cell.config["graph"]
    vae = graph["first_stage_config"]["params"]["ddconfig"]
    latent = cell.config["image_size"] // 2 ** (len(vae["ch_mult"]) - 1)
    ucg_rate = graph["conditioner_config"]["params"]["emb_models"][0].get("ucg_rate", 0.0)
    return [traffic.loss_draws(cell.traffic, seed, step, j, latent, ucg_rate, 1000, device)
            for j in range(cell.traffic["accumulate"])]


def train_feed(cell: Cell, seed: int, step: int, device) -> List[dict]:
    """A checked step's micro-batches, rows and draws, as the reference takes them."""
    return [dict(r, **d) for r, d in zip(train_rows(cell, seed, step, device),
                                         train_draws(cell, seed, step, device))]


def train_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
               controls: Optional[Dict[str, Control]] = None) -> dict:
    import torch
    from udifftext_tpu_torch.builders import build_engine
    from udifftext_tpu_torch.parallel.train import TrainState, train_step
    from udifftext_tpu_torch.train import batch_keys, to_device

    from . import modules

    cfg, mix = cell.config, cell.traffic
    flops = modules.counts(cfg)
    tr = cfg["training"]
    bundle = build_engine(cfg["graph"], getattr(torch, cfg["unet_dtype"]), device, train=True)
    engine = bundle.engine
    load_program_weights(engine, cfg, seed, device, train=True)
    state = TrainState.create(engine, base_lr=tr["base_learning_rate"],
                              steps_per_epoch=tr["steps_per_epoch"], use_ema=tr["use_ema"])
    keys = batch_keys(engine)
    # the data loader's numpy batches: the checked steps' rows, taken again in turn
    host = [[{k: v.cpu().numpy() for k, v in r.items()} for r in train_rows(cell, seed, s, device)]
            for s in range(mix["checked_steps"])]

    def loss_fn(mb):
        return engine.loss({k: mb[k] for k in keys if k in mb}, image_eps=mb["image_eps"],
                           masked_eps=mb["masked_eps"], ucg_keep=mb["ucg_keep"],
                           sigma_idx=mb["sigma_idx"], noise=mb["noise"])

    def run_step(step):
        """A step as train.train runs it: the host-to-device copy of its
        micro-batches, then train_step (the draws are the loss's own)."""
        micro = [dict(to_device(h, device, keys), **d)
                 for h, d in zip(host[step % len(host)], train_draws(cell, seed, step, device))]
        return train_step(state, micro, loss_fn)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # the first steps are the warm-up, and what the reference follows
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    prog = {"losses": [], "start": {n: p.detach().float().clone() for n, p in state.params.items()}}
    for step in range(mix["checked_steps"]):
        loss, _ = run_step(step)
        prog["losses"].append(float(loss))
        if step == 0:
            prog["grad1"] = {n: state.optimizer.state[p]["exp_avg"].float() / (1.0 - beta1)
                             for n, p in state.params.items()}
    prog["end"] = {n: p.detach().float().clone() for n, p in state.params.items()}
    sync()
    setup_s = time.perf_counter() - T_START

    rows = mix["micro_batch"] * mix["accumulate"]
    t0 = time.perf_counter()
    t_close, t_last, steps, step = t0 + seconds, t0, 0, mix["checked_steps"]
    while time.perf_counter() < t_close:
        run_step(step)
        sync()
        step += 1
        if time.perf_counter() <= t_close:
            t_last, steps = time.perf_counter(), steps + 1
    units = steps * rows
    span = t_last - t0
    tracer = Tracer(device)
    if trace:
        tracer.arm(mix["trace_steps"])
        for _ in range(mix["trace_steps"]):
            tracer.enter()
            run_step(step)
            tracer.exit()
            step += 1
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    per_sample = flops.train_micro_batch(cfg["graph"], mix["micro_batch"], cfg["image_size"]) / mix["micro_batch"]
    readout = Readout(cell, span, units * per_sample, None,
                      tracer.summary() if trace else None, mix.get("trace_steps", 0))
    del state, engine, bundle, loss_fn, run_step, host
    free_device()
    t_ref = time.perf_counter()
    numbers = train_reference(cell, seed, prog, device, controls)
    return {"e2e": {"train_samples_per_s": units / span if span > 0 else 0.0},
            "setup_s": setup_s, "peak": peak, "attempted": steps, "failed": 0,
            "readout": readout, "numbers": numbers.pop("program"), "controls": numbers,
            "reference_s": time.perf_counter() - t_ref}


def train_reference(cell: Cell, seed: int, prog: Optional[dict], device,
                    controls: Optional[Dict[str, Control]] = None) -> Dict[str, Dict[str, float]]:
    """The numbers of the checked steps against the reference: of the
    program's `prog` ("program", when given) and of each of `controls`, the
    reference at that arithmetic put in the program's place."""
    from .judge import train_numbers
    from .modules import reference
    ref_mod = reference(cell.config)
    cfg = cell.config
    keys = cfg["graph"].get("opt_keys", ("t_attn", "t_norm"))
    lr = cfg["training"]["base_learning_rate"]
    feeds = [train_feed(cell, seed, s, device) for s in range(cell.traffic["checked_steps"])]
    outs = {} if prog is None else {"program": prog}
    with ref_mod.fp32_products():
        for name, (prec, frozen) in (controls or {}).items():
            ctrl = ref_mod.Reference(cfg, device, seeded_weights(cfg, seed, device, train=True),
                                     prec, frozen)
            outs[name] = ref_mod.train_steps(ctrl, feeds, keys, lr)
            del ctrl
            free_device()
        ref = ref_mod.Reference(cfg, device, seeded_weights(cfg, seed, device, train=True))
        out = ref_mod.train_steps(ref, feeds, keys, lr)
    del ref, feeds
    free_device()
    return {name: train_numbers(o, out) for name, o in outs.items()}


# -- the run ---------------------------------------------------------------------

DRIVERS = {"serve": serve_cell, "train": train_cell}


def run_cell(root: Path, cell: Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of `cell`: the result object of the contract, its last key
    `checks` holding each compared number beside its limit."""
    import torch
    from .judge import verdict
    out = DRIVERS[cell.config["mode"]](cell, seed, seconds, trace, device)
    print(f"set-up {out['setup_s']:.3f} s, reference {out['reference_s']:.3f} s, "
          f"run {time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    correct, checks = verdict(out["numbers"], cell.config["limits"])
    if trace:
        r: Readout = out["readout"]
        metrics = {}
        for m in cell.per_layer:
            value = reader(root, m["name"])(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=out["setup_s"], peak_mem_gib=out["peak"] / GIB)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": out["peak"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        t = out["readout"].trace
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in t.device_ops()],
                               "idle_gaps": [list(x) for x in t.idle_gaps]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    cell = load_cell(root, args.workload)
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    result = run_cell(root, cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"the run loaded {found}: the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
