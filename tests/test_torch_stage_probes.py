"""The port's stage and floor probes on the CPU at the tiny graph.

Each of the nine probes (`udifftext_tpu_torch/scripts/`: profile_components,
profile_transformer, kv_hoist_probe, step_floor_probe, train_probe,
pipeline_probe, perf_probe, test_parity_probe, geglu_sweep) runs through its
`run(..., device="cpu", reps=1, runs=1)` on the repo's tiny model graph
(tests/test_cli_scripts.py TINY_MODEL_YAML, fp32) or at tiny block shapes, and
must return every label; without a card each refuses to run unless asked for
the CPU. What the probes hold to be equal is checked here in fp32: inline and
hoisted K/V give the same output (1e-5), the stages of the test flow composed
give `engine.sample`'s image from the same injected draws (1e-5), the
pipeline's operation count is the steps' plus the K/V hoist's plus the
decode's, and the trainable-only gradients equal the full tree's on the
t_attn/t_norm leaves (1e-6 relative). The GEGLU sweep's plans are those the
C entry's documented rules take, the shipped `geglu_plan` among them.
"""

import math

import pytest
import torch

import torch_port_util as U
from udifftext_tpu_torch.builders import build_engine
from udifftext_tpu_torch.ops.geglu import MMA_TILES, GegluPlan, geglu_plan
from udifftext_tpu_torch.parallel.train import trainable_mask
from udifftext_tpu_torch.scripts import (geglu_sweep, kv_hoist_probe, perf_probe,
                                         pipeline_probe, profile_components, profile_transformer,
                                         step_floor_probe, test_parity_probe, train_probe)
from udifftext_tpu_torch.scripts._engine import latent_side, seeded_engine, unet_inputs

F32 = torch.float32
ATTN = ((64, 2, 16),)


def _tiny():
    return dict(model_cfg=U.tiny_model_cfg(), size=U.IMG, dtype=F32)


def _layers():
    bundle = build_engine(U.tiny_model_cfg(), F32, "meta")
    lat = latent_side(bundle, U.IMG)
    return tuple(step_floor_probe.layer_label(lay)
                 for lay in step_floor_probe.layer_list(bundle.engine.unet, lat))


# probe → (its run's keyword arguments, the labels it must return)
PROBES = {
    "profile_components": lambda: (
        dict(batch=1, attn_shapes=ATTN, **_tiny()), profile_components.labels(ATTN)),
    "profile_transformer": lambda: (
        dict(batch=1, channels=32, heads=2, side=8, ctx_dim=32, dtype=F32),
        profile_transformer.LABELS),
    "kv_hoist_probe": lambda: (
        dict(batch=1, channels=32, heads=4, side=8, **_tiny()),
        kv_hoist_probe.LABELS + kv_hoist_probe.DIFF_LABELS),
    "step_floor_probe": lambda: (
        dict(batch=1, **_tiny()),
        _layers() + (step_floor_probe.STEP, step_floor_probe.REST, step_floor_probe.DECODE)),
    "train_probe": lambda: (dict(batch=1, **_tiny()), train_probe.LABELS),
    "pipeline_probe": lambda: (dict(batch=1, steps=1, **_tiny()), pipeline_probe.LABELS),
    "perf_probe": lambda: (
        dict(batch=1, steps=1, attn_shapes=ATTN, **_tiny()),
        perf_probe.labels(ATTN) + (perf_probe.COUNT_GAP,)),
    "test_parity_probe": lambda: (
        dict(batch=1, noise_iters=2, **_tiny()),
        test_parity_probe.LABELS + (test_parity_probe.DIFF_LABEL,)),
    "geglu_sweep": lambda: (
        dict(batch=1, n=128, channels=64),
        tuple(geglu_sweep.plan_label(p, geglu_plan(torch.bfloat16, 128, 64, 256, 132))
              for p in geglu_sweep.mma_plans(128, 64, 256))
        + (geglu_sweep.WRAPPER, geglu_sweep.COMPOSITION, geglu_sweep.PRODUCTS)),
}
MODULES = {"profile_components": profile_components, "profile_transformer": profile_transformer,
           "kv_hoist_probe": kv_hoist_probe, "step_floor_probe": step_floor_probe,
           "train_probe": train_probe, "pipeline_probe": pipeline_probe, "perf_probe": perf_probe,
           "test_parity_probe": test_parity_probe, "geglu_sweep": geglu_sweep}


@pytest.fixture(scope="module")
def results():
    """Each probe's result, run once on the CPU."""
    done = {}

    def get(name):
        if name not in done:
            kwargs, _ = PROBES[name]()
            done[name] = MODULES[name].run(reps=1, runs=1, device="cpu", **kwargs)
        return done[name]

    return get


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_returns_every_label(name, results):
    _, labels = PROBES[name]()
    got = results(name)
    assert set(got) == set(labels)
    assert all(math.isfinite(v) for v in got.values())


@pytest.mark.parametrize("name", sorted(MODULES))
def test_probe_refuses_to_run_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MODULES[name].main([])


def test_kv_hoist_outputs_agree(results):
    got = results("kv_hoist_probe")
    assert all(got[label] <= 1e-5 for label in kv_hoist_probe.DIFF_LABELS)


def test_test_parity_stages_compose_to_sample(results):
    assert results("test_parity_probe")[test_parity_probe.DIFF_LABEL] <= 1e-5


def test_perf_probe_pipeline_count_composes(results):
    assert results("perf_probe")[perf_probe.COUNT_GAP] == 0


def test_trainable_gradients_equal_the_full_trees():
    bundle = seeded_engine(torch.device("cpu"), U.tiny_model_cfg(), dtype=F32)
    engine = bundle.engine
    unet = engine.unet
    inputs = unet_inputs(bundle, 2, latent_side(bundle, U.IMG), torch.device("cpu"),
                         torch.Generator().manual_seed(0))
    names = [n for n, _ in engine.named_parameters() if n.startswith("unet.")]
    mask = trainable_mask(engine.named_parameters(), train_probe.OPT_KEYS)
    every = [p.requires_grad_(True) for p in unet.parameters()]
    full = dict(zip(names, train_probe.loss_grads(unet, *inputs, every)))
    for p in every:
        p.requires_grad_(False)
    kept = [n for n in names if mask[n]]
    assert kept and all(("t_attn" in n or "t_norm" in n) for n in kept)
    params = dict(engine.named_parameters())
    trainable = [params[n].requires_grad_(True) for n in kept]
    only = dict(zip(kept, train_probe.loss_grads(unet, *inputs, trainable)))
    for n in kept:
        scale = float(full[n].abs().max())
        assert float((only[n] - full[n]).abs().max()) <= 1e-6 * max(scale, 1e-12), n


def _entry_takes(plan, m, c, inner):
    """csrc/geglu.cu: dispatch_mma and launch_mma's checks for route "mma"."""
    t = c // 64
    g = 4 if t > 10 else 2 if t > 5 else 1
    chunk = 128 if g == 4 else 64
    rows_ok = plan.rows == 64 or (plan.rows == 128 and t <= 5)
    split_ok = inner % (chunk * plan.splits) == 0 and (
        g == 4 or (plan.splits <= 8 and plan.rows % plan.splits == 0))
    partial = plan.splits * m * c * 4 if g == 4 and plan.splits > 1 else 0
    return (c % 64 == 0 and t in MMA_TILES and rows_ok and split_ok and plan.route == "mma"
            and plan.partial_bytes == partial and plan.launches == 1 + (partial > 0))


@pytest.mark.parametrize("m,c", [(32 * 4096, 320), (2 * 4096, 320), (32 * 1024, 640),
                                 (2 * 1024, 640), (32 * 256, 1280), (2 * 256, 1280)])
def test_geglu_sweep_plans_are_the_entrys(m, c):
    inner = 4 * c
    plans = geglu_sweep.mma_plans(m, c, inner)
    assert len(set(plans)) == len(plans)
    assert geglu_plan(torch.bfloat16, m, c, inner, geglu_sweep.H100_SMS) in plans
    assert all(_entry_takes(p, m, c, inner) for p in plans)
    # and every plan the rules take is swept
    rows = (64, 128) if c <= 320 else (64,)
    taken = [p for r in rows for s in range(1, inner // 64 + 1)
             for p in (GegluPlan("mma", r, s, 1 + (c > 640 and s > 1),
                                               s * m * c * 4 if c > 640 and s > 1 else 0),)
             if _entry_takes(p, m, c, inner)]
    assert sorted(taken) == sorted(plans)
