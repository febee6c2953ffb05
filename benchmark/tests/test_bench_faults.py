"""`correct` comes out false when the timed path is broken underneath: a
tiny run of each cell on the CPU, skipping only the harness's look for a
card, with each fault the cell can have planted in the program (a served
image altered where it is produced; a fine-tuning step that leaves its state
unchanged; half of each micro-batch left out, the mean taken over the rest),
judged by the limits of the cell's configuration. The sound run beside them
comes out true. The control, the reference with every product one step
below the configured arithmetic in the program's place, comes out false on
the numbers it reads."""

from __future__ import annotations

import pytest
import torch

from benchmark.calibrate import FAULTS, controls, planted
from benchmark.judge import verdict
from benchmark.run import DRIVERS
from benchmark.tests.tiny import TINY_SECONDS, tiny_cell

CPU = torch.device("cpu")
SEED = 2**31 + 11
CASES = [(w, f) for w in ("serve-saturated", "finetune-b16x4")
         for f in (None,) + FAULTS["serve" if w.startswith("serve") else "train"]]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_fault_is_not_correct(workload, fault):
    torch.set_num_threads(2)
    cell = tiny_cell(workload)
    drive = DRIVERS[cell.config["mode"]]
    if fault is None:
        out = drive(cell, SEED, TINY_SECONDS, False, CPU)
    else:
        with planted(fault):
            out = drive(cell, SEED, TINY_SECONDS, False, CPU)
    correct, _ = verdict(out["numbers"], cell.config["limits"])
    assert correct is (fault is None), out["numbers"]


@pytest.mark.parametrize("workload", ["serve-saturated", "finetune-b16x4"])
def test_the_control_is_not_correct(workload):
    torch.set_num_threads(2)
    cell = tiny_cell(workload)
    out = DRIVERS[cell.config["mode"]](cell, SEED, TINY_SECONDS, False, CPU,
                                       {"control": controls(cell.config)["control"]})
    numbers = out["controls"]["control"]
    correct, _ = verdict(numbers, cell.config["limits"])
    assert not correct, numbers
