"""The port's fine-tuning CLI (`udifftext_tpu_torch.train.main`) and the
pieces it adds, on the CPU with the tiny model graph
(tests/test_cli_scripts.py TINY_MODEL_YAML, 32² images):

- the three LR schedules against the JAX package's over 200 steps (1e-6);
- `SimpleProfiler`'s summary against the JAX one's, character for character;
- resumable checkpoints: save → restore bit-equal (every engine tensor, the
  AdamW moments, the step, the EMA); pruning to `keep`; a temporary file left
  by a crash ignored; the asynchronous writer's snapshot unaffected by
  in-place updates after `save`, and durable after `close`;
- `main` for two epochs (checkpoints, image logs, the profiler table), then a
  second `main` on the same directory resuming at the saved step with the
  first run's weights, although it draws another seed;
- the overfit check the reference never had: a few steps on one fixed batch
  with fixed draws, the loss falling;
- the CLI needing `--device cpu` without a GPU, and running on a LAION-OCR
  fixture through `data.get_dataloader` with it.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import torch_port_util as U
from test_torch_data import _laion
from udifftext_tpu.parallel import train as JT
from udifftext_tpu.utils.profiling import SimpleProfiler as JProfiler
from udifftext_tpu_torch import train as port_train
from udifftext_tpu_torch.builders import build_engine, randomize_parameters
from udifftext_tpu_torch.data.synthetic import SyntheticBatches
from udifftext_tpu_torch.parallel import train as PT
from udifftext_tpu_torch.utils import png, train_ckpt
from udifftext_tpu_torch.utils.profiling import SimpleProfiler

REPO = Path(__file__).resolve().parent.parent


# --- schedules and the profiler ---------------------------------------------------


SCHEDULES = {
    "warmup_cosine": (JT.warmup_cosine_schedule, PT.warmup_cosine_schedule,
                      dict(base_lr=1e-4, warmup_steps=20, total_steps=150, lr_min=1e-6,
                           lr_start=1e-7)),
    "warmup_linear": (JT.warmup_linear_schedule, PT.warmup_linear_schedule,
                      dict(base_lr=5e-5, warmup_steps=30, total_steps=160, lr_min=2e-6)),
    "cycles_cosine": (JT.warmup_cosine_cycles_schedule, PT.warmup_cosine_cycles_schedule,
                      dict(warm_up_steps=[10, 5], f_min=[0.1, 0.05], f_max=[1.0, 0.5],
                           f_start=[1e-3, 0.1], cycle_lengths=[80, 90])),
    "cycles_linear": (JT.warmup_cosine_cycles_schedule, PT.warmup_cosine_cycles_schedule,
                      dict(warm_up_steps=[10, 5], f_min=[0.1, 0.05], f_max=[1.0, 0.5],
                           f_start=[1e-3, 0.1], cycle_lengths=[80, 90], linear=True)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedules_match_jax(name):
    jax_fn, port_fn, kw = SCHEDULES[name]
    js, ps = jax_fn(**kw), port_fn(**kw)
    want = np.array([float(js(s)) for s in range(200)])
    got = np.array([ps(s) for s in range(200)])
    assert all(isinstance(ps(s), float) for s in (0, 199))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_simple_profiler_summary_matches_jax(capsys):
    got, want = SimpleProfiler(), JProfiler()
    for prof in (got, want):
        for name, secs, n in (("train_step", 12.3456, 40), ("host_to_device", 0.5, 40),
                              ("checkpoint", 2.25, 2)):
            prof.totals[name] += secs
            prof.counts[name] += n
    assert got.summary() == want.summary()
    assert got.summary().splitlines()[1].startswith("train_step")
    with got.profile("x"):
        pass
    assert got.counts["x"] == 1 and got.totals["x"] >= 0.0
    got.print_summary()
    assert "== profiler summary ==" in capsys.readouterr().out


# --- checkpoints ------------------------------------------------------------------


def _engine(seed, dtype=torch.bfloat16):
    bundle = build_engine(U.tiny_model_cfg(), dtype, "cpu", train=True)
    randomize_parameters(bundle.engine, seed)
    return bundle


def _stepped_state(engine, steps=2):
    """A state with EMA after `steps` updates of a stand-in loss, so that the
    AdamW moments and the EMA differ from the parameters."""
    state = PT.TrainState.create(engine, base_lr=1e-2, steps_per_epoch=1, use_ema=True)
    for _ in range(steps):
        PT.train_step(state, [None], lambda _: (sum((p.float() ** 2).sum() for p in
                                                    state.params.values()), {}))
    return state


def _equal_states(a_engine, a_state, b_engine, b_state):
    sa, sb = a_engine.state_dict(), b_engine.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    oa, ob = a_state.optimizer.state_dict(), b_state.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a_state.step == b_state.step
    assert all(torch.equal(v, b_state.ema[k]) for k, v in a_state.ema.items())


def test_checkpoint_save_restore_bit_equal(tmp_path):
    src = _engine(0).engine
    state = _stepped_state(src)
    path = train_ckpt.save_checkpoint(str(tmp_path), src, state, keep=3)
    assert os.path.basename(path) == "step_00000002.pt"
    dst = _engine(1).engine  # other weights, frozen ones included
    fresh = PT.TrainState.create(dst, base_lr=1e-2, steps_per_epoch=1, use_ema=True)
    assert not torch.equal(dst.vae.encoder.conv_in.weight, src.vae.encoder.conv_in.weight)
    assert train_ckpt.restore_checkpoint(path, dst, fresh) == 2
    _equal_states(src, state, dst, fresh)
    # the restored optimizer goes on as the saved one does
    loss = lambda st: (lambda _: (sum((p.float() ** 2).sum() for p in st.params.values()), {}))  # noqa: E731
    PT.train_step(state, [None], loss(state))
    PT.train_step(fresh, [None], loss(fresh))
    _equal_states(src, state, dst, fresh)
    no_ema = PT.TrainState.create(dst, base_lr=1e-2, steps_per_epoch=1, use_ema=False)
    with pytest.raises(ValueError, match="EMA"):
        train_ckpt.restore_checkpoint(path, dst, no_ema)


def test_checkpoint_pruning_and_leftover_tmp(tmp_path):
    engine = _engine(0, torch.float32).engine
    state = PT.TrainState.create(engine, steps_per_epoch=1)
    assert train_ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    for step in (1, 2, 3, 4):
        state.step = step
        train_ckpt.save_checkpoint(str(tmp_path), engine, state, keep=2)
    crash = tmp_path / "step_00000009.pt.tmp-123"  # a write cut by a crash
    crash.write_bytes(b"partial")
    assert sorted(os.listdir(tmp_path)) == ["step_00000003.pt", "step_00000004.pt",
                                            crash.name]
    assert train_ckpt.latest_checkpoint(str(tmp_path)).endswith("step_00000004.pt")
    state.step = 5
    train_ckpt.save_checkpoint(str(tmp_path), engine, state, keep=1)
    assert sorted(os.listdir(tmp_path)) == ["step_00000005.pt", crash.name]


def test_async_writer_snapshot_and_durability(tmp_path):
    engine = _engine(0, torch.float32).engine
    state = _stepped_state(engine, steps=1)
    name, p = next(iter(state.params.items()))
    before = p.detach().clone()
    with train_ckpt.AsyncCheckpointWriter(str(tmp_path), keep=2) as writer:
        first = writer.save(engine, state)
        with torch.no_grad():
            p.add_(1.0)  # the optimizer's in-place update racing the write
        state.step = 2
        second = writer.save(engine, state)
    assert len(writer.blocked_s) == len(writer.write_s) == 2
    assert sorted(os.listdir(tmp_path)) == ["step_00000001.pt", "step_00000002.pt"]
    saved = torch.load(first, weights_only=True)["engine"][name]
    assert torch.equal(saved, before)
    assert torch.equal(torch.load(second, weights_only=True)["engine"][name], before + 1.0)
    with pytest.raises(RuntimeError, match="closed"):
        writer.save(engine, state)


# --- the CLI ----------------------------------------------------------------------


def _run_cfgs(tmp_path, **over):
    cfgs = {"save_ckpt_dir": str(tmp_path / "ckpt"), "log_dir": str(tmp_path / "logs"),
            "load_ckpt_path": None, "bf16": False, "base_learning_rate": 1e-3, "use_ema": True,
            "batch_size": 2, "save_ckpt_freq": 1, "keep_ckpts": 1, "log_images_freq": 2,
            "log_images_steps": 1, "lightning": {"accumulate_grad_batches": 2, "max_epochs": 2}}
    cfgs.update(over)
    return cfgs


def test_train_cli_two_epochs_then_resume(tmp_path, capsys):
    batches = SyntheticBatches(4, 2, size=32, seed=0)  # 2 updates an epoch
    cfgs = _run_cfgs(tmp_path)
    state = port_train.main(cfgs, batches, device="cpu", model_cfg=U.tiny_model_cfg(), seed=5,
                            log_every=1)
    out = capsys.readouterr().out
    assert state.step == 4 and "seed: 5" in out and "resuming" not in out
    ckpt_dir = tmp_path / "ckpt" / "udifftext_tpu_torch"
    assert sorted(os.listdir(ckpt_dir)) == ["step_00000004.pt"]
    assert out.count("(async)") == 2
    images = sorted(os.listdir(tmp_path / "logs" / "images"))
    assert images == [f"step{s:07d}_{k}.png" for s in (2, 4)
                      for k in ("inputs", "reconstructions", "samples")]
    assert png.read_png(str(tmp_path / "logs" / "images" / images[0])).shape == (32, 64, 3)
    summary = out[out.index("== profiler summary =="):]
    for section in ("train_step", "host_to_device", "checkpoint", "image_logs"):
        assert section in summary
    first = {k: v.clone() for k, v in state.params.items()}

    resumed = port_train.main(dict(cfgs, lightning={"accumulate_grad_batches": 2,
                                                    "max_epochs": 1}),
                              batches, device="cpu", model_cfg=U.tiny_model_cfg(), seed=6,
                              log_every=1)
    out = capsys.readouterr().out
    assert f"resuming from {ckpt_dir / 'step_00000004.pt'} at step 4" in out
    assert resumed.step == 6 and "epoch 0 step 5" in out
    assert sorted(os.listdir(ckpt_dir)) == ["step_00000006.pt"]
    saved = torch.load(ckpt_dir / "step_00000006.pt", weights_only=True)
    assert saved["step"] == 6 and set(saved["ema"]) == set(first)
    # the frozen weights are the first run's (seed 5), not seed 6's draw
    other = _engine(6, torch.float32).engine.state_dict()
    first_run = _engine(5, torch.float32).engine.state_dict()
    frozen = [k for k in saved["engine"] if k not in first]
    assert frozen and all(torch.equal(saved["engine"][k], first_run[k]) for k in frozen)
    assert not all(torch.equal(saved["engine"][k], other[k]) for k in frozen)
    assert all(not torch.equal(resumed.params[k], first[k]) for k in first)


def test_overfit_one_batch():
    """Eight updates on one fixed batch with fixed draws: the loss falls."""
    bundle = _engine(0, torch.float32)
    engine = bundle.engine
    state = PT.TrainState.create(engine, base_lr=1e-3, steps_per_epoch=100)
    batch = port_train.to_device(SyntheticBatches(1, 2, size=32, seed=3).batches[0], "cpu")
    g = torch.Generator().manual_seed(0)
    shape = (2, U.LAT, U.LAT, 4)
    draws = dict(image_eps=torch.randn(shape, generator=g),
                 masked_eps=torch.randn(shape, generator=g), ucg_keep=torch.ones(2),
                 sigma_idx=torch.tensor([300, 700]), noise=torch.randn(shape, generator=g))
    losses = [float(PT.train_step(state, [batch], lambda b: engine.loss(b, **draws))[0])
              for _ in range(8)]
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.9 * losses[0], losses
    assert sum(b < a for a, b in zip(losses, losses[1:])) >= 6, losses


def test_train_cli_entry(tmp_path):
    """`python -m udifftext_tpu_torch.train --device cpu` on a LAION-OCR
    fixture through get_dataloader; without a GPU and without the flag it
    stops with a message, before building."""
    _laion(tmp_path)
    (tmp_path / "model.yaml").write_text(yaml.safe_dump({"model": {"params":
                                                                   U.tiny_model_cfg()}}))
    (tmp_path / "dataset.yaml").write_text(textwrap.dedent(f"""
        target: LAIONOCRDataset
        params: {{data_root: '{tmp_path}', H: 32, W: 32, word_len: [1, 8], seq_len: 12,
                  mask_min_ratio: 0.01, seg_min_ratio: 0.001, aug_text_enabled: False,
                  aug_text_ratio: 0.0, use_cached: False, length: 2}}
    """))
    cfgs = _run_cfgs(tmp_path, model_cfg_path=str(tmp_path / "model.yaml"),
                     dataset_cfg_path=str(tmp_path / "dataset.yaml"), batch_size=1,
                     shuffle=False, log_images_freq=0,
                     lightning={"accumulate_grad_batches": 1, "max_epochs": 1})
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(cfgs))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "udifftext_tpu_torch.train", "--config",
           str(tmp_path / "train.yaml")]
    res = subprocess.run(cmd + ["--device", "cpu"], capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "epoch 0 step 2" not in res.stdout  # logs every 10 updates, as the JAX CLI
    assert os.listdir(tmp_path / "ckpt" / "udifftext_tpu_torch") == ["step_00000002.pt"]
    if not torch.cuda.is_available():
        res = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=str(tmp_path),
                             timeout=120)
        assert res.returncode != 0 and "--device cpu" in res.stderr


def test_smoke_run_config_is_train_yaml():
    """chip_smoke.py's configs/train.yaml equals the file, and its phase 13
    changes only the keys it lists."""
    import chip_smoke

    with open(REPO / "configs" / "train.yaml") as f:
        assert chip_smoke.TRAIN_RUN == yaml.safe_load(f)
    got = U.flat_dict(chip_smoke.train_run_config("/work"))
    want = U.flat_dict(chip_smoke.TRAIN_RUN)
    assert sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k)) == sorted(
        chip_smoke.TRAIN_OVERRIDES)
    assert got["lightning.max_epochs"] == 2 and got["batch_size"] == 16
