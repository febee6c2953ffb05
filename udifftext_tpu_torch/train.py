"""The fine-tuning CLI and loop on the port (the flow of the JAX build's
root train.py).

    python -m udifftext_tpu_torch.train [--config ./configs/train.yaml] [--device cpu]
    torchrun --nproc_per_node N -m udifftext_tpu_torch.train   # one process per card

`main(cfgs)` is the run: the seed drawn at random and printed (rank 0's, on
every rank), the engine of `loading.init_model(cfgs, train=True)` (cfgs'
`load_ckpt_path`, the graph's component checkpoints; what they do not set
is drawn from the seed), the loader of `data.get_dataloader(cfgs, "train")`
unless one is passed, then `train` with checkpoints under
`<save_ckpt_dir>/udifftext_tpu_torch` and a `SimpleProfiler` (sections
host_to_device, train_step, image_logs, checkpoint: the loop blocked in
`save`; restore; and the background writes' own seconds; its table printed
at the end, on a card with each section's device seconds beside its host
seconds: train_step's host seconds are its enqueue, host_to_device's the
wait for the previous step's device work).
Under torchrun each process takes its share of every micro-batch, and the
gradients are averaged once per optimizer step (`parallel/dist.py`).

`train(cfgs, batches, bundle)` is the loop: AdamW with the per-epoch ×0.95
LR decay over the t_attn/t_norm branches (and the embedders the graph marks
is_trainable), `lightning.accumulate_grad_batches`
micro-batches per update (a group left incomplete at an epoch's end is
dropped), `lightning.max_epochs` epochs, every loss component logged every
`log_every` updates (stdout and `train_metrics.{csv,jsonl}` under cfgs'
log_dir, default ./logs). The JAX build logs every 10 updates; `log_every`
exists so that a short run can read each update. `batches` is a sized,
re-iterable collection of numpy batches with the keys of BATCH_KEYS (image,
masked, mask in [-1, 1] / {0, 1} NHWC; seg (B, H, W, L); seg_mask (B, L);
label_ids (B, L); for the OCR term r_bbox (B, 4) and parseq_label_ids
(B, 27)) and the input keys of the graph's other embedders, one micro-batch each, as `data.loader.DataLoader` yields them.
The loss's draws come from one generator seeded by (seed, rank).

With a `ckpt_dir`, the loop resumes from its newest checkpoint (the step
goes on, the epoch counter starts again at 0, as in the JAX build) and
writes one every `save_ckpt_freq` epochs through the asynchronous writer,
keeping `keep_ckpts` (`utils/train_ckpt.py`). With `log_images_freq`, every
that many updates rank 0 writes PNGs of the first micro-batch's inputs,
reconstructions and fresh samples of `log_images_steps` steps (default 20)
to <log_dir>/images, sampled with the EMA weights swapped in under
`use_ema`. Rank 0 alone writes checkpoints, image logs and metrics.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import random
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .builders import EngineBundle
from .parallel import dist
from .parallel.train import TrainState, train_step
from .utils.logger import MetricsLogger
from .utils.png import write_png
from .utils import profiling
from .utils.profiling import SimpleProfiler
from .utils.train_ckpt import AsyncCheckpointWriter, latest_checkpoint, restore_checkpoint

BATCH_KEYS = ("image", "masked", "mask", "seg", "seg_mask", "label_ids", "r_bbox",
              "parseq_label_ids")
CKPT_SUBDIR = "udifftext_tpu_torch"  # the JAX build writes its own format under "udifftext_tpu"


def batch_keys(engine) -> Tuple[str, ...]:
    """BATCH_KEYS and the input keys of the engine's GeneralConditioner
    (e.g. a ClassEmbedder's class ids), when it has one."""
    gc = getattr(engine, "general_conditioner", None)
    return tuple(dict.fromkeys(BATCH_KEYS + (gc.input_keys if gc is not None else ())))


def to_device(batch: Mapping[str, Any], device: torch.device,
              keys: Sequence[str] = BATCH_KEYS) -> Dict[str, torch.Tensor]:
    """The batch's `keys` as tensors on `device` (the span `train.to_device`)."""
    with profiling.span("train.to_device"):
        return {k: torch.as_tensor(np.asarray(batch[k])).to(device) for k in keys if k in batch}


def save_image_logs(engine, batch: Dict[str, torch.Tensor], generator: torch.Generator,
                    img_dir: str, step: int, n: int = 4, num_steps: int = 20) -> List[str]:
    """`engine.log_images` of the batch's first n samples as one PNG row
    per key, step<step>_<key>.png; returns the paths."""
    logs = engine.log_images(batch, generator, n=n, num_steps=num_steps)
    os.makedirs(img_dir, exist_ok=True)
    paths = []
    for key, imgs in logs.items():
        arr = ((imgs.float().cpu().numpy() + 1.0) / 2.0).clip(0.0, 1.0)
        row = np.concatenate(list(arr), axis=1)
        paths.append(write_png(os.path.join(img_dir, f"step{step:07d}_{key}.png"),
                               (row * 255).astype(np.uint8)))
    return paths


@contextlib.contextmanager
def ema_weights(state: TrainState):
    """The EMA swapped into the trainable parameters for the duration (a
    no-op without EMA)."""
    if state.ema is None:
        yield
        return
    with torch.no_grad():
        saved = {n: p.detach().clone() for n, p in state.params.items()}
        for n, p in state.params.items():
            p.copy_(state.ema[n])
    try:
        yield
    finally:
        with torch.no_grad():
            for n, p in state.params.items():
                p.copy_(saved[n])


def train(cfgs: Mapping[str, Any], batches, bundle: EngineBundle, seed: Optional[int] = None,
          log_every: int = 10, ckpt_dir: Optional[str] = None,
          profiler: Optional[SimpleProfiler] = None) -> TrainState:
    """Run the loop over `batches` for `lightning.max_epochs` epochs;
    returns the state."""
    seed = random.randint(0, 2**31 - 1) if seed is None else int(seed)
    rank, _ = dist.rank_and_world()
    if rank == 0:
        print(f"seed: {seed}", flush=True)
    engine = bundle.engine
    dev = engine.device
    profiler = profiler or SimpleProfiler(cuda=dev.type == "cuda")
    lightning = cfgs.get("lightning", {}) or {}
    accum = max(int(lightning.get("accumulate_grad_batches", 1)), 1)
    max_epochs = int(lightning.get("max_epochs", 100))
    state = TrainState.create(engine, base_lr=float(cfgs.get("base_learning_rate", 5e-5)),
                              steps_per_epoch=max(len(batches) // accum, 1),
                              use_ema=bool(cfgs.get("use_ema", False)))
    writer = None
    if ckpt_dir is not None:
        resume = latest_checkpoint(ckpt_dir)
        if resume:
            with profiler.profile("restore"):
                restore_checkpoint(resume, engine, state)
            if rank == 0:
                print(f"resuming from {resume} at step {state.step}", flush=True)
        if rank == 0:
            writer = AsyncCheckpointWriter(ckpt_dir, keep=int(cfgs.get("keep_ckpts", 3)))
    log_dir = str(cfgs.get("log_dir", "./logs"))
    logger = MetricsLogger(log_dir) if rank == 0 else None
    img_freq = int(cfgs.get("log_images_freq", 0) or 0)
    save_freq = max(int(cfgs.get("save_ckpt_freq", 1)), 1)
    gen = torch.Generator(dev).manual_seed(dist.rank_seed(seed, rank))
    keys = batch_keys(engine)

    def loss_fn(batch):
        return engine.loss(batch, gen)

    t0 = time.time()
    try:
        for epoch in range(max_epochs):
            micro = []
            for batch in batches:
                micro.append(batch)
                if len(micro) < accum:
                    continue
                with profiler.profile("host_to_device"):
                    dev_micro = [to_device(b, dev, keys) for b in micro]
                micro = []
                with profiler.profile("train_step"):
                    loss, aux = train_step(state, dev_micro, loss_fn)
                if logger is not None and state.step % log_every == 0:
                    dt = time.time() - t0
                    comps = {k: float(v) for k, v in sorted(aux.items())}
                    logger.log(state.step, {"loss": float(loss), **comps}, epoch=epoch)
                    comp_str = " ".join(f"{k.split('/')[-1]} {v:.4f}" for k, v in comps.items())
                    print(f"epoch {epoch} step {state.step} loss {float(loss):.4f} {comp_str} "
                          f"({dt / log_every:.2f}s/step)", flush=True)
                    t0 = time.time()
                if rank == 0 and img_freq and state.step % img_freq == 0:
                    with profiler.profile("image_logs"), ema_weights(state):
                        save_image_logs(engine, dev_micro[0],
                                        torch.Generator(dev).manual_seed(seed + state.step),
                                        os.path.join(log_dir, "images"), state.step,
                                        num_steps=int(cfgs.get("log_images_steps", 20)))
            if writer is not None and (epoch + 1) % save_freq == 0:
                with profiler.profile("checkpoint"):
                    path = writer.save(engine, state)
                print(f"saving {path} (async)", flush=True)
    finally:
        if writer is not None:
            writer.close()
            for seconds in writer.write_s:
                profiler.add("checkpoint_write (background)", seconds)
        if logger is not None:
            logger.close()
    return state


def main(cfgs: Mapping[str, Any], dataloader=None, device: torch.device | str = "cuda",
         model_cfg: Optional[Mapping[str, Any]] = None, seed: Optional[int] = None,
         log_every: int = 10, profiler: Optional[SimpleProfiler] = None) -> TrainState:
    """A fine-tuning run of the run config `cfgs` (configs/train.yaml's
    keys); `model_cfg` stands in for the file `cfgs.model_cfg_path`, and
    `dataloader` for `get_dataloader(cfgs, "train")`. Runs on the card
    unless `device` is "cpu"; without a card the default fails. The
    sections' times go to `profiler` (a new one by default)."""
    from .data.loader import get_dataloader
    from .loading import init_model

    dev = dist.maybe_init_distributed(device)
    seed = random.randint(0, 2**31 - 1) if seed is None else int(seed)
    seed = dist.broadcast_int(seed, dev)
    bundle = init_model(cfgs, dev, seed=seed, model_cfg=model_cfg, train=True)
    if dataloader is None:
        dataloader = get_dataloader(cfgs, "train")
    profiler = profiler or SimpleProfiler(cuda=dev.type == "cuda")
    ckpt_dir = os.path.join(str(cfgs.get("save_ckpt_dir", "./checkpoints")), CKPT_SUBDIR)
    state = train(cfgs, dataloader, bundle, seed=seed, log_every=log_every, ckpt_dir=ckpt_dir,
                  profiler=profiler)
    if dist.rank_and_world()[0] == 0:
        profiler.print_summary()
    return state


def cli(argv=None) -> None:
    p = argparse.ArgumentParser(description="Fine-tune UDiffText's t_attn/t_norm branches.")
    p.add_argument("--config", default="./configs/train.yaml")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: no CUDA device found; run on a machine with a GPU, or pass "
                         "--device cpu to run (slowly) on the CPU")
    from .config import load_config

    main(load_config(args.config), device=args.device)


if __name__ == "__main__":
    cli()
