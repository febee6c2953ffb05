"""Readings that the limits of `correct` are set from, on the chip, at a cell's
own size, in one process:

    python -m benchmark.calibrate --workload <name> --seeds 1 2 ... [--controls 3]
        [--faults 3] [--seconds 6]

For each seed, one run of the cell with a short window (the program's
numbers, as every run reads them); for the first `--controls` seeds also
each control of `controls(cfg)`, the reference at a lower arithmetic put
in the program's place; for the first `--faults` seeds also the faults
planted in the program that the cell can have (a served image altered where
it is produced; a fine-tuning step that leaves its state unchanged; half of
each micro-batch left out, the mean taken over the rest). One JSON line a
reading: its numbers and the verdict of the cell's own limits on them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path

import torch


def controls(cfg: dict) -> dict:
    """name: (the UNet's arithmetic, the autoencoder's and LabelEncoder's),
    in the precisions of the configuration's reference. "control" is the
    contract's: every product one step below what the configurations state
    (float8 for the bf16 UNet; bfloat16 for the frozen networks' float32,
    whose convolutions run in TF32)."""
    from .modules import reference
    ref = reference(cfg)
    return {"control": (ref.Float8(), ref.BFloat16())}


@contextlib.contextmanager
def planted(fault: str):
    """A fault planted in the program for the duration."""
    from udifftext_tpu_torch import engine as eng
    from udifftext_tpu_torch.parallel import train as ptrain
    saved = (eng.DiffusionEngine.sample, eng.DiffusionEngine.loss, ptrain.train_step)
    sample, loss, step = saved
    if fault == "altered_image":
        def sample_altered(self, *a, **kw):
            images, aux = sample(self, *a, **kw)
            return (images + 0.25).remainder(1.0), aux
        eng.DiffusionEngine.sample = sample_altered
    elif fault == "half_batch":
        def loss_half(self, batch, *a, **kw):
            n = batch["image"].shape[0] // 2
            cut = {k: v[:n] for k, v in batch.items()}
            kw = {k: (v[:n] if torch.is_tensor(v) and v.ndim and v.shape[0] == 2 * n else v)
                  for k, v in kw.items()}
            return loss(self, cut, *a, **kw)
        eng.DiffusionEngine.loss = loss_half
    elif fault == "unchanged_state":
        def step_unchanged(state, micro_batches, loss_fn, *a, **kw):
            saved_p = {n: p.detach().clone() for n, p in state.params.items()}
            out = step(state, micro_batches, loss_fn, *a, **kw)
            with torch.no_grad():
                for n, p in state.params.items():
                    p.copy_(saved_p[n])
            return out
        ptrain.train_step = step_unchanged
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        eng.DiffusionEngine.sample, eng.DiffusionEngine.loss, ptrain.train_step = saved


FAULTS = {"serve": ("altered_image",), "train": ("unchanged_state", "half_batch")}


def main(argv=None) -> None:
    from .judge import verdict
    from .run import DRIVERS, load_cell
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--seconds", type=float, default=6.0)
    args = p.parse_args(argv)
    cell = load_cell(Path.cwd(), args.workload)
    device = torch.device("cuda")
    mode = cell.config["mode"]

    def emit(kind, seed, numbers):
        correct, _ = verdict(numbers, cell.config["limits"])
        print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed, **numbers,
                          "correct": correct}), flush=True)

    for i, seed in enumerate(args.seeds):
        out = DRIVERS[mode](cell, seed, args.seconds, False, device,
                            controls(cell.config) if i < args.controls else None)
        emit("program", seed, out["numbers"])
        for name, numbers in out["controls"].items():
            emit(name, seed, numbers)
        if i < args.faults:
            for fault in FAULTS[mode]:
                with planted(fault):
                    res = DRIVERS[mode](cell, seed, args.seconds, False, device)
                emit(fault, seed, res["numbers"])


if __name__ == "__main__":
    main()
