"""Peak device memory and step time of the OCR-loss fine-tuning step at full
width, by micro-batch size, on the card.

    python -m udifftext_tpu_torch.scripts.ocr_train_probe [--sizes 2,4,8,16]
        [--steps 2]

The graph is `builders.TEXTDESIGN_SD_2_TRAIN` with `ocr_enabled: true`
(bf16 UNet with fp32 t_attn/t_norm master weights, fp32 VAE, fp32
PARSeq-base), seeded random weights; the batches are
`data.synthetic.SyntheticBatches` (512², collated by the port's loader).
Each size runs in a process of its own: `steps` optimizer steps of one
micro-batch through `train.train`, then one JSON line with the peak
device memory (`torch.cuda.max_memory_allocated`), the seconds of the last
step and samples/s. An out-of-memory error is a result and is printed as
such, with the peak reached before it. The decoder keeps its fp32
activations for the backward of the OCR term; this probe is how the GPU
smoke test's OCR micro-batch was chosen.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import tempfile
from typing import Dict, List

import torch

from ..builders import TEXTDESIGN_SD_2_TRAIN, build_engine, randomize_parameters
from ..data.synthetic import SyntheticBatches
from ..train import train
from ._timing import probe_device


def ocr_train_graph() -> Dict:
    """The shipped fine-tuning graph with the OCR loss term on."""
    cfg = copy.deepcopy(TEXTDESIGN_SD_2_TRAIN)
    cfg["loss_fn_config"]["params"]["ocr_enabled"] = True
    return cfg


def run_one(micro_b: int, steps: int = 2, device: str = "cuda") -> Dict:
    """The OCR-loss step at one micro-batch size in this process."""
    dev = probe_device("ocr_train_probe", device)
    bundle = build_engine(ocr_train_graph(), torch.bfloat16, dev, train=True)
    randomize_parameters(bundle.engine, 0)
    batches = SyntheticBatches(1, micro_b, seed=0)
    result = {"micro_batch": micro_b, "steps": steps,
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(prefix="udt_ocr_probe_") as log_dir:
        cfgs = {"batch_size": micro_b, "log_dir": log_dir, "lightning": {"max_epochs": steps}}
        try:
            train(cfgs, batches, bundle, seed=0, log_every=1)
        except torch.OutOfMemoryError:
            result["oom"] = True
        else:
            with open(f"{log_dir}/train_metrics.jsonl") as f:
                rows = [json.loads(line) for line in f]
            result["oom"] = False
            result["loss"] = {k: v for k, v in rows[-1].items() if k.startswith("loss")}
            if len(rows) > 1:
                step_s = rows[-1]["time"] - rows[-2]["time"]
                result["s_per_step"] = step_s
                result["samples_per_s"] = micro_b / step_s
    if dev.type == "cuda":
        result["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return result


def run(sizes: List[int], steps: int = 2, device: str = "cuda",
        timeout: int = 900) -> List[Dict]:
    """`run_one` for each size, each in a fresh process (an out-of-memory
    error leaves nothing behind for the next size)."""
    results = []
    for b in sizes:
        proc = subprocess.run(
            [sys.executable, "-m", "udifftext_tpu_torch.scripts.ocr_train_probe", "--one", str(b),
             "--steps", str(steps), "--device", device],
            capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"micro-batch {b}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    return results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="2,4,8,16")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(run_one(args.one, args.steps, args.device)), flush=True)
        return
    run([int(s) for s in args.sizes.split(",")], args.steps, args.device)


if __name__ == "__main__":
    main()
