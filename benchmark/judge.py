"""The comparison that decides `correct`: the numbers read from the program's
outputs against the plain reference's, each held to the limit that the
cell's configuration file states (`limits`; PERF.md gives the readings each
was set from).

Served cells:
- image_gap: the mean absolute difference, in uint8 levels, of the checked
  rows' images, the reference following the candidate the program chose
  (with random weights the search's scores tie within about 1e-4, so a
  near-tie may break the other way in either). The search's scores and
  choice are not judged: no number on them separates the program from the
  control (PERF.md).
Fine-tuning cells (the first steps, taken by the worst leaf):
- loss_gap: each step's loss against the reference's, as a share of it;
- grad_gap: the gap between the norms of the first step's mean gradient of
  a leaf in the program and in the reference, as a share of the larger of
  the reference's norm of that leaf and of the median leaf;
- change_gap: the same for the leaves' change over the checked steps.
A leaf whose reference gradient is under a thousandth of the median leaf's
moves by round-off alone and is not counted.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

ROUNDOFF_LEAF = 1e-3


def serve_numbers(prog_images: torch.Tensor, ref_images: torch.Tensor) -> Dict[str, float]:
    return {"image_gap": float((prog_images.cpu().double() - ref_images.cpu().double()).abs().mean())}


def _leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], counted) -> float:
    p = {n: float(prog[n].double().norm()) for n in counted}
    r = {n: float(ref[n].double().norm()) for n in counted}
    median = float(torch.tensor(list(r.values())).median())
    return max(abs(p[n] - r[n]) / max(r[n], median) for n in counted)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog and ref: {"losses": [...], "grad1": {leaf: gradient},
    "start": {leaf: before}, "end": {leaf: after}}."""
    g_norm = {n: float(g.double().norm()) for n, g in ref["grad1"].items()}
    median = float(torch.tensor(list(g_norm.values())).median())
    counted = [n for n, v in g_norm.items() if v >= ROUNDOFF_LEAF * median]
    change_p = {n: prog["end"][n].double() - prog["start"][n].double() for n in counted}
    change_r = {n: ref["end"][n].double() - ref["start"][n].double() for n in counted}
    return {
        "loss_gap": max(abs(lp - lr) / abs(lr) for lp, lr in zip(prog["losses"], ref["losses"])),
        "grad_gap": _leaf_gap(prog["grad1"], ref["grad1"], counted),
        "change_gap": _leaf_gap(change_p, change_r, counted),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(v == v and v <= limits[k] for k, v in numbers.items())  # NaN fails
    return ok, checks
