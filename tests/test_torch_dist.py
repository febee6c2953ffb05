"""Data parallelism of the port (`udifftext_tpu_torch/parallel/dist.py`) on
the CPU: two processes in a gloo group, as torchrun starts them, against one
process.

- The fine-tuning step: each process takes half of every micro-batch of a
  global batch (2 micro-batches of 4, the tiny model graph, fp32, the draws
  injected); after two updates the trainable parameters and the logged loss
  equal one process's on the whole micro-batches within 1e-6, and the EMA
  too.
- The helpers: the seed broadcast from rank 0, the bucketed mean of tensors
  of two dtypes.
- The eval CLI with `eval_data_parallel`: rank 0 alone wipes the output
  directory, each process writes its own samples, the OCR counts are summed
  over both before the mean is printed.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import torch_port_util as U
from udifftext_tpu_torch.builders import build_engine, randomize_parameters
from udifftext_tpu_torch.data.synthetic import SyntheticBatches
from udifftext_tpu_torch.models.parseq import PARSeq
from udifftext_tpu_torch.parallel import dist
from udifftext_tpu_torch.parallel import train as PT
from udifftext_tpu_torch.train import to_device

REPO = Path(__file__).resolve().parent.parent
MICRO, GLOBAL_B, STEPS = 2, 4, 2

_CHILD = r"""
import json, os, sys
import torch
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
from test_torch_dist import global_batches, step_engine
from udifftext_tpu_torch import test as port_test
from udifftext_tpu_torch.builders import build_engine, randomize_parameters, SamplerSettings
from udifftext_tpu_torch.data.synthetic import SyntheticBatches
from udifftext_tpu_torch.parallel import dist

torch.set_num_threads(1)
cfg, out_dir, parseq = json.loads(sys.argv[2]), sys.argv[3], sys.argv[4]
dev = dist.maybe_init_distributed("cpu")
rank, world = dist.rank_and_world()
assert (rank, world) == (int(os.environ["RANK"]), 2) and dev.type == "cpu"
assert dist.broadcast_int(100 + rank, dev) == 100
mixed = [torch.full((3,), float(rank)), torch.full((2, 2), 2.0 * rank, dtype=torch.float64),
         torch.full((5,), 4.0 * rank)]
dist.all_reduce_mean_(mixed, bucket_bytes=16)  # a bucket per tensor, one dtype each
assert [float(t.flatten()[0]) for t in mixed] == [0.5, 1.0, 2.0]

state, losses = step_engine(cfg, global_batches(), rank, world)
# the eval CLI, one batch of 2 per process
bundle = build_engine(cfg, torch.float32, "cpu")
randomize_parameters(bundle.engine, 0)
batch = SyntheticBatches(1, 2, size=32, seed=10 + rank).batches[0]
batch["name"] = [f"r{rank}", f"r{rank}b"]
cfgs = {"output_dir": os.path.join(out_dir, "outputs"), "temp_dir": os.path.join(out_dir, "temp"),
        "noise_iters": 0, "eval_data_parallel": True, "ocr_enabled": True, "max_iter": 1,
        "predictor_config": {"params": {"ckpt_path": parseq}}}
res = port_test.test(bundle, SamplerSettings(num_steps=1), [batch], cfgs, seed=0)
if rank == 0:
    torch.save({"params": state.params, "ema": state.ema, "losses": losses, "eval": res},
               os.path.join(out_dir, "rank0.pt"))
print(json.dumps({"rank": rank, "eval_total": res["total"]}))
torch.distributed.destroy_process_group()
"""


def global_batches():
    """The global batch: MICRO micro-batches of GLOBAL_B samples, and each
    sample's draws."""
    batches = SyntheticBatches(MICRO, GLOBAL_B, size=32, seed=1).batches
    g = torch.Generator().manual_seed(2)
    shape = (GLOBAL_B, U.LAT, U.LAT, 4)
    draws = [dict(image_eps=torch.randn(shape, generator=g),
                  masked_eps=torch.randn(shape, generator=g),
                  ucg_keep=(torch.rand(GLOBAL_B, generator=g) < 0.9).float(),
                  sigma_idx=torch.randint(0, 1000, (GLOBAL_B,), generator=g),
                  noise=torch.randn(shape, generator=g)) for _ in batches]
    return batches, draws


def step_engine(cfg, batches_draws, rank, world):
    """STEPS updates of the tiny engine (seeded weights, EMA on) on this
    process's share of every micro-batch; returns (state, logged losses)."""
    bundle = build_engine(cfg, torch.float32, "cpu", train=True)
    randomize_parameters(bundle.engine, 0)
    engine = bundle.engine
    batches, draws = batches_draws
    per = GLOBAL_B // world
    rows = slice(rank * per, (rank + 1) * per)
    micro = [({k: v[rows] for k, v in to_device(b, "cpu").items()},
              {k: v[rows] for k, v in d.items()}) for b, d in zip(batches, draws)]
    # configs/train.yaml's LR: Adam moves an element whose gradient is near 0 by up to
    # the LR on the gradient's last bits, which the two reductions order differently
    state = PT.TrainState.create(engine, base_lr=5e-5, steps_per_epoch=1, use_ema=True)
    losses = []
    for _ in range(STEPS):
        loss, aux = PT.train_step(state, micro, lambda m: engine.loss(m[0], **m[1]))
        losses.append([float(loss)] + [float(aux[k]) for k in sorted(aux)])
    return state, losses


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_step_and_eval_match_one_process(tmp_path):
    parseq = tmp_path / "parseq.pt"
    torch.save(randomize_parameters(PARSeq(), 3).state_dict(), parseq)
    stale = tmp_path / "outputs" / "stale.png"
    stale.parent.mkdir()
    stale.write_bytes(b"x")
    cfg = json.dumps(U.tiny_model_cfg())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(REPO), cfg, str(tmp_path),
                               str(parseq)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        results = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = []
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert [o["eval_total"] for o in outs] == [4, 4]  # 2 samples a process, summed over both

    got = torch.load(tmp_path / "rank0.pt", weights_only=True)
    state, losses = step_engine(U.tiny_model_cfg(), global_batches(), 0, 1)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-6, atol=1e-7)
    assert set(got["params"]) == set(state.params) and len(state.params) > 0
    for name, p in state.params.items():
        U.assert_close(got["params"][name], p.detach().numpy(), 0, 1e-6, name)
        U.assert_close(got["ema"][name], state.ema[name].numpy(), 0, 1e-6, f"ema {name}")
    assert got["eval"]["names"] == ["r0"]
    assert not stale.exists()
    assert sorted(os.listdir(tmp_path / "outputs" / "fake")) == ["r0.png", "r1.png"]


def test_helpers_without_a_process_group():
    assert not dist.is_distributed() and dist.rank_and_world() == (0, 1)
    assert dist.broadcast_int(7, "cpu") == 7 and dist.rank_seed(7, 0) == 7
    assert len({dist.rank_seed(7, r) for r in range(8)}) == 8
    t = [torch.ones(3)]
    dist.all_reduce_mean_(t)  # a no-op without a process group
    assert torch.equal(t[0], torch.ones(3))
    assert dist.maybe_init_distributed("cpu") == torch.device("cpu")
    sizes = [[t.numel() for t in b] for b in dist._buckets([torch.zeros(n) for n in
                                                            (4, 4, 10, 1, 1)], cap=32)]
    assert sizes == [[4, 4], [10], [1, 1]]
