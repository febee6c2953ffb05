"""A run of a cell loads neither JAX nor the JAX package: a tiny served and a
tiny fine-tuning run in a fresh process, then its modules' top-level names
compared whole against the forbidden ones (the port's name begins with the
JAX package's, and stays allowed)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark.run import FORBIDDEN
from benchmark.tests.tiny import ROOT

SCRIPT = """
import json, sys, torch
torch.set_num_threads(2)
from benchmark.run import run_cell
from benchmark.tests.tiny import ROOT, TINY_SECONDS, tiny_cell
out = run_cell(ROOT, tiny_cell(sys.argv[1]), 2**31 + 3, TINY_SECONDS, False, torch.device("cpu"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("workload", ["serve-saturated", "finetune-b16x4"])
def test_a_run_imports_no_jax(workload):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", SCRIPT, workload], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    top = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "udifftext_tpu_torch" in top
    assert not top & set(FORBIDDEN)
