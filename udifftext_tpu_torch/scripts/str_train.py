"""PARSeq training (port of `scripts/str_train.py`; src/parseq/train.py
parity).

Permutation-language-modelling training of PARSeq on an LMDB database or a
labels.txt image folder (`str_test.load_folder`), with the JAX script's
optimizer: optax's one-cycle cosine schedule (`--warmup_pct` of the steps
up), the gradient clipped at global norm 20, AdamW with weight decay 1e-4.
`--swa` averages the parameters over the last (1 − `--swa_start_pct`) of
the steps (the reference's Lightning StochasticWeightAveraging(
swa_epoch_start=0.75), src/parseq/train.py:69), and the saved checkpoint
carries the average.

One `np.random.default_rng(0)` draws each step's batch and then its
permutations, in the JAX script's order, so both draw the same. Images are
decoded on the host (`data.lmdb.decode_image`), resized on the device by
`ocr.bicubic_resize` and normalized to [-1, 1]. The checkpoint is a torch
file in strhub's `model.`-prefixed key layout, which `str_hub.create_model`
(and so `str_test --ckpt`) loads strictly.

Usage: python -m udifftext_tpu_torch.scripts.str_train --data_root <root>
       [--steps N] [--swa] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.parseq import PARSeq, ParseqTokenizer, gen_tgt_perms, parseq_training_loss
from ..parallel.train import (
    clip_grad_global_norm_,
    make_str_optimizer,
    onecycle_cosine_schedule,
    swa_start,
    swa_update,
)
from ._timing import probe_device
from .str_test import Item, load_crop, load_folder

CLIP_NORM = 20.0


@dataclasses.dataclass
class TrainResult:
    """What `train` returns: the state dict to save (the SWA average where
    --swa ran), each step's loss, the SWA count and first averaged step
    (0-based), and each step's host seconds (batch load, decode, resize)
    and total seconds."""

    state_dict: Dict[str, torch.Tensor]
    losses: List[float]
    swa_n: int
    swa_from: int
    host_s: List[float]
    step_s: List[float]


def load_batch(items: Sequence[Item], idx: Sequence[int], out_hw: Tuple[int, int],
               device: torch.device) -> Tuple[torch.Tensor, List[str]]:
    """The items at `idx`: images decoded on the host, resized on `device`
    and normalized to [-1, 1] (B, h, w, 3), and their labels."""
    crops, labels = [], []
    for j in idx:
        open_fn, label = items[j]
        crops.append(load_crop(open_fn(), out_hw, device))
        labels.append(label)
    return (torch.stack(crops) - 0.5) / 0.5, labels


def train_step(model: PARSeq, opt: torch.optim.Optimizer, images: torch.Tensor,
               ids: np.ndarray, perms: np.ndarray, lr: float,
               clip_norm: Optional[float] = CLIP_NORM) -> torch.Tensor:
    """One update: the permuted loss, its gradient clipped at global norm
    `clip_norm` (None: no clip), then the optimizer at `lr`. Returns the
    loss (detached, on the device)."""
    opt.zero_grad(set_to_none=True)
    loss = parseq_training_loss(model, images, torch.as_tensor(ids), perms)
    loss.backward()
    if clip_norm is not None:
        clip_grad_global_norm_([p.grad for p in model.parameters() if p.grad is not None],
                               clip_norm)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    return loss.detach()


def train(items: Sequence[Item], model: PARSeq, device: torch.device, rng: np.random.Generator,
          *, steps: int = 1000, batch: int = 64, lr: float = 7e-4, warmup_pct: float = 0.075,
          perm_num: int = 6, swa: bool = False, swa_start_pct: float = 0.75,
          log: Callable[[str], None] = print,
          on_step: Optional[Callable[[int, PARSeq], None]] = None) -> TrainResult:
    """`steps` updates of `model` (already on `device`) on batches of
    `batch` items drawn with replacement by `rng`. Each step ends in a
    device synchronize, so its seconds are the card's too. `on_step(i,
    model)` runs after update i."""
    tok = ParseqTokenizer()
    model.train()
    params = dict(model.named_parameters())
    opt = make_str_optimizer(params.values(), lr)
    schedule = onecycle_cosine_schedule(steps, lr, pct_start=warmup_pct)
    swa_from = int(steps * swa_start_pct) if swa else steps
    avg, swa_n = None, 0
    losses, host_s, step_s = [], [], []
    t_log = time.perf_counter()
    for i in range(steps):
        t0 = time.perf_counter()
        idx = rng.choice(len(items), batch)
        images, labels = load_batch(items, idx, model.img_size, device)
        ids = tok.encode(labels)
        perms = gen_tgt_perms(rng, ids.shape[1] - 2, perm_num=perm_num)
        t1 = time.perf_counter()
        losses.append(train_step(model, opt, images, ids, perms, schedule(i)))
        if swa and i >= swa_from:
            if avg is None:
                avg = swa_start(params)
            else:
                swa_update(avg, params, swa_n)
            swa_n += 1
        if on_step is not None:
            on_step(i, model)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        host_s.append(t1 - t0)
        step_s.append(t2 - t0)
        if (i + 1) % 20 == 0:
            log(f"step {i + 1}/{steps} loss {float(losses[-1]):.4f} "
                f"({(t2 - t_log) / 20:.2f}s/step)")
            t_log = t2
    state = {k: v.detach() for k, v in model.state_dict().items()}
    if avg is not None:
        # the checkpoint (what str_test evaluates) carries the averaged
        # parameters, as Lightning's SWA swaps them in at the end
        state.update(avg)
        log(f"swa: averaged {swa_n} snapshots from step {swa_from + 1}")
    return TrainResult(state, torch.stack(losses).tolist() if losses else [], swa_n, swa_from,
                       host_s, step_s)


def save_checkpoint(state_dict: Dict[str, torch.Tensor], ckpt_dir: str, step: int) -> str:
    """`<ckpt_dir>/parseq_step<step>.pt`: the state dict on the CPU under
    strhub's `model.` prefix."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"parseq_step{step}.pt")
    torch.save({f"model.{k}": v.cpu() for k, v in state_dict.items()}, path)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=7e-4)
    ap.add_argument("--warmup_pct", type=float, default=0.075)
    ap.add_argument("--perm_num", type=int, default=6)
    ap.add_argument("--ckpt_dir", default="./checkpoints/parseq_torch")
    ap.add_argument("--swa", action="store_true",
                    help="stochastic weight averaging over the training tail "
                         "(reference: Lightning StochasticWeightAveraging("
                         "swa_epoch_start=0.75), src/parseq/train.py:69); the "
                         "SAVED checkpoint carries the averaged params")
    ap.add_argument("--swa_start_pct", type=float, default=0.75)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = probe_device("str_train", args.device)

    items = load_folder(args.data_root)
    if not items:
        raise SystemExit(f"no LMDB or labels.txt data under {args.data_root}")
    torch.manual_seed(0)
    model = PARSeq().to(device)
    res = train(items, model, device, np.random.default_rng(0), steps=args.steps,
                batch=args.batch, lr=args.lr, warmup_pct=args.warmup_pct,
                perm_num=args.perm_num, swa=args.swa, swa_start_pct=args.swa_start_pct)
    path = save_checkpoint(res.state_dict, args.ckpt_dir, args.steps)
    print(f"saved {path}")
    return path


if __name__ == "__main__":
    main()
