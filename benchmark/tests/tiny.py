"""A cell of BENCHMARK.json cut to a size that the CPU runs in seconds, for
the tests: the same configuration file with every width, depth and count
made small, and the limits of `correct` for that size (TINY_LIMITS)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark.run import Cell, load_cell

ROOT = Path(__file__).resolve().parents[2]

# a window that holds a whole tiny group even on a loaded CPU
TINY_SECONDS = 3.0

# Set like the configurations' limits, from the tiny graph's readings on the
# CPU (benchmark/calibrate.py's drivers; the program on seeds 5-8, the
# control on 5-6): served, the program's largest image_gap 1.28 against the
# control's least 11.6; fine-tuning, the program's largest loss_gap 7.5e-4,
# grad_gap 0.013, change_gap 0.0070 against the control's least 4.9e-3,
# 0.10, 0.021.
TINY_LIMITS = {"serve": {"image_gap": 4.0},
               "train": {"loss_gap": 1.0e-3, "grad_gap": 0.04, "change_gap": 0.015}}


def tiny_cell(name: str) -> Cell:
    cell = load_cell(ROOT, name)
    cfg = copy.deepcopy(cell.config)
    g = cfg["graph"]
    net = g["network_config"]["params"]
    net.update(model_channels=32, channel_mult=[1, 2], attention_resolutions=[1, 2],
               num_head_channels=16, t_context_dim=32)
    le = g["conditioner_config"]["params"]["emb_models"][0]["params"]
    le.update(emb_dim=32, n_heads=2, n_trans_layers=1)
    g["conditioner_config"]["params"]["emb_models"][1]["params"]["multiplier"] = 0.5
    for node in (g["first_stage_config"], g["conditioner_config"]["params"]["emb_models"][2]["params"]["config"]):
        node["params"]["ddconfig"].update(ch=32, ch_mult=[1, 2])
    cfg["image_size"] = 32
    cfg["limits"] = dict(TINY_LIMITS[cfg["mode"]])
    mix = copy.deepcopy(cell.traffic)
    if cfg["mode"] == "serve":
        cfg["sampler"].update(num_steps=3, noise_iters=2)
        cfg["serving"].update(max_batch=2, buckets=[2])
        mix.update(pool=4, clients=2, trace_groups=1, checked_rows=2)
        if "rate_per_s" in mix:
            mix["rate_per_s"] = 4.0
    else:
        mix.update(micro_batch=2, accumulate=2, checked_steps=2, trace_steps=1)
    return Cell(cell.name, cfg, mix, cell.end_to_end, cell.per_layer, cell.chips)


def dump(obj) -> str:
    return json.dumps(obj, indent=1)
