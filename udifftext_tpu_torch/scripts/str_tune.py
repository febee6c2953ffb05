"""Learning-rate search for PARSeq training (port of `scripts/str_tune.py`;
src/parseq/tune.py parity).

The reference runs ray-tune's ASHA over the LR; this is a log-space sweep
of short runs from one set of initial weights, each with AdamW at a
constant LR (optax.adamw's defaults, no clip) and the default 6
permutations, picking the LR with the lowest final loss.

Usage: python -m udifftext_tpu_torch.scripts.str_tune --data_root <root>
       [--trials 6 --steps 60] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..models.parseq import PARSeq, ParseqTokenizer, gen_tgt_perms
from ..parallel.train import make_str_optimizer
from ._timing import probe_device
from .str_test import Item, load_folder
from .str_train import load_batch, train_step


def sweep(items: Sequence[Item], model: PARSeq, device: torch.device, lrs: Sequence[float],
          steps: int = 60, batch: int = 32) -> List[Tuple[float, float]]:
    """(final loss, lr) of a run of `steps` updates from `model`'s weights
    at each lr; every run draws its batches from np.random.default_rng(0)."""
    tok = ParseqTokenizer()
    results = []
    for lr in lrs:
        trial = copy.deepcopy(model).train()
        opt = make_str_optimizer(trial.parameters(), float(lr))
        rng = np.random.default_rng(0)
        last = float("nan")
        for _ in range(steps):
            idx = rng.choice(len(items), batch)
            images, labels = load_batch(items, idx, trial.img_size, device)
            ids = tok.encode(labels)
            perms = gen_tgt_perms(rng, ids.shape[1] - 2)
            last = float(train_step(trial, opt, images, ids, perms, float(lr), clip_norm=None))
        print(f"lr {lr:.2e}: final loss {last:.4f}")
        results.append((last, lr))
        del trial, opt
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr_min", type=float, default=1e-5)
    ap.add_argument("--lr_max", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = probe_device("str_tune", args.device)

    items = load_folder(args.data_root)
    if not items:
        raise SystemExit(f"no LMDB or labels.txt data under {args.data_root}")
    torch.manual_seed(0)
    model = PARSeq().to(device)
    lrs = np.exp(np.linspace(np.log(args.lr_min), np.log(args.lr_max), args.trials))
    best = min(sweep(items, model, device, lrs, args.steps, args.batch))
    print(f"best lr: {best[1]:.2e} (loss {best[0]:.4f})")
    return best


if __name__ == "__main__":
    main()
