"""The fine-tuning loop on the port (the loop of the JAX build's train.py).

`train(cfgs, batches, bundle)` fine-tunes the t_attn/t_norm branches of an
engine built with `build_engine(model_cfg, ..., train=True)`: AdamW with the
per-epoch ×0.95 LR decay, `lightning.accumulate_grad_batches` micro-batches
per update, every loss component logged every `log_every` updates (stdout
and `train_metrics.{csv,jsonl}` under cfgs' log_dir, default ./logs). The
JAX build logs every 10 updates; `log_every` exists so that a short run
(the chip smoke test, the CPU tests) can read each update's time and loss.
`batches` is a sized, re-iterable collection of numpy batches with the
keys of BATCH_KEYS (image, masked, mask in [-1, 1] / {0, 1} NHWC at the
image size; seg (B, H, W, L); seg_mask (B, L); label_ids (B, L)), one
micro-batch each; an epoch is one pass over it. All random draws of the
loss come from one generator seeded by `seed`, drawn at random (and
printed) when None, as the JAX build does. The loop reads no checkpoint:
build the bundle with `loading.init_model(cfgs, train=True)`, which loads
cfgs' `load_ckpt_path` (configs/train.yaml: the SD2-inpainting bootstrap,
whose missing t_attn branches keep their zero-output init) and the graph's
component checkpoints, as the JAX train.py's `init_model` does.

The dataset and loader, checkpoint writing and image logs are not ported
yet; neither is the OCR loss term.
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .builders import EngineBundle
from .parallel.train import TrainState, train_step
from .utils.logger import MetricsLogger

BATCH_KEYS = ("image", "masked", "mask", "seg", "seg_mask", "label_ids")


def to_device(batch: Mapping[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's BATCH_KEYS as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device) for k in BATCH_KEYS if k in batch}


def train(cfgs: Mapping[str, Any], batches: Sequence[Mapping[str, Any]], bundle: EngineBundle,
          seed: Optional[int] = None, log_every: int = 10) -> TrainState:
    """Run the loop over `batches` for `lightning.max_epochs` epochs; a
    group of fewer than `accumulate_grad_batches` micro-batches left at an
    epoch's end is dropped. Returns the state."""
    seed = random.randint(0, 2**31 - 1) if seed is None else int(seed)
    print(f"seed: {seed}")
    engine = bundle.engine
    dev = engine.device
    lightning = cfgs.get("lightning", {}) or {}
    accum = max(int(lightning.get("accumulate_grad_batches", 1)), 1)
    max_epochs = int(lightning.get("max_epochs", 100))
    steps_per_epoch = max(len(batches) // accum, 1)
    state = TrainState.create(engine, base_lr=float(cfgs.get("base_learning_rate", 5e-5)),
                              steps_per_epoch=steps_per_epoch,
                              use_ema=bool(cfgs.get("use_ema", False)))
    logger = MetricsLogger(str(cfgs.get("log_dir", "./logs")))
    gen = torch.Generator(dev).manual_seed(seed)

    def loss_fn(batch):
        return engine.loss(to_device(batch, dev), gen)

    t0 = time.time()
    try:
        for epoch in range(max_epochs):
            micro = []
            for batch in batches:
                micro.append(batch)
                if len(micro) < accum:
                    continue
                loss, aux = train_step(state, micro, loss_fn)
                micro = []
                if state.step % log_every == 0:
                    dt = time.time() - t0
                    comps = {k: float(v) for k, v in sorted(aux.items())}
                    logger.log(state.step, {"loss": float(loss), **comps}, epoch=epoch)
                    comp_str = " ".join(f"{k.split('/')[-1]} {v:.4f}" for k, v in comps.items())
                    print(f"epoch {epoch} step {state.step} loss {float(loss):.4f} {comp_str} "
                          f"({dt / log_every:.2f}s/step)", flush=True)
                    t0 = time.time()
    finally:
        logger.close()
    return state
