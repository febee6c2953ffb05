"""A configuration names its reference package and its count of operations
(benchmark/modules.py): the accepted configurations name neither and take
UDiffText's, whose counts stay what they were; one that names other modules
of the benchmark gets them, in the reference, the seeded weights, the
traffic, the served batch and the per-layer readers alike; a module outside
the benchmark is refused."""

from __future__ import annotations

import copy
import sys
import types

import pytest
import torch

from benchmark import flops, modules, reference, traffic
from benchmark.reference import engine, model
from benchmark.run import (Readout, load_cell, reader, reference_networks, seeded_weights,
                           serve_batch)
from benchmark.tests.tiny import ROOT, tiny_cell

CONFIGS = ("textdesign_sd_2-serve", "textdesign_sd_2-finetune")
# the counts before a configuration could name its own (served group of 8
# at 512² with 50 steps and 10 candidates; a fine-tuning micro-batch of 16)
SERVE_GROUP = 922275260923904.0
TRAIN_MICRO_BATCH = 62771020431360.0


def _config(name: str) -> dict:
    work = {"textdesign_sd_2-serve": "serve-saturated", "textdesign_sd_2-finetune": "finetune-b16x4"}
    return load_cell(ROOT, work[name]).config


@pytest.mark.parametrize("name", CONFIGS)
def test_an_accepted_configuration_takes_the_udifftext_modules(name):
    cfg = _config(name)
    assert not {"reference", "flops"} & set(cfg)
    ref = modules.reference(cfg)
    assert ref is reference
    assert (ref.Reference, ref.train_steps, ref.CHARSET) == (engine.Reference, engine.train_steps,
                                                             engine.CHARSET)
    assert (ref.Networks, ref.Float8, ref.is_norm_param) == (model.Networks, model.Float8,
                                                             model.is_norm_param)
    assert modules.counts(cfg) is flops


@pytest.mark.parametrize("name", CONFIGS)
def test_the_counts_stay_as_they_were(name):
    cfg = _config(name)
    count = modules.counts(cfg)
    assert count.serve_group(cfg["graph"], 8, 512, 50, 10) == SERVE_GROUP
    assert count.train_micro_batch(cfg["graph"], 16, 512) == TRAIN_MICRO_BATCH


@pytest.fixture
def other_modules(monkeypatch):
    """Two modules of the benchmark's namespace standing in for a new
    configuration's own: a reference package with another vocabulary and
    encoding whose networks and reference record being built, and a count."""
    built = []

    class Networks(model.Networks):
        def __init__(self, *a, **kw):
            built.append("networks")
            super().__init__(*a, **kw)

    class Reference(engine.Reference):
        def __init__(self, *a, **kw):
            built.append("reference")
            super().__init__(*a, **kw)

    ref = types.ModuleType("benchmark.other_reference")
    ref.__dict__.update({k: getattr(reference, k) for k in reference.__all__})
    ref.Networks, ref.Reference, ref.CHARSET = Networks, Reference, "ab"
    ref.encode_text = lambda text, seq: [" ab".index(c) for c in text] + [0] * (seq - len(text))
    count = types.ModuleType("benchmark.other_flops")
    count.__dict__.update({k: v for k, v in vars(flops).items() if not k.startswith("__")})
    count.attn_layers = lambda net, h, w: [(1024, 640, 10)]
    for m in (ref, count):
        monkeypatch.setitem(sys.modules, m.__name__, m)
    return {"reference": ref.__name__, "flops": count.__name__, "built": built}


def test_a_configuration_that_names_other_modules_gets_them(other_modules):
    cell = tiny_cell("serve-saturated")
    cfg = copy.deepcopy(cell.config)
    cfg.update({k: other_modules[k] for k in ("reference", "flops")})
    ref = modules.reference(cfg)
    assert ref is sys.modules["benchmark.other_reference"]
    assert modules.counts(cfg) is sys.modules["benchmark.other_flops"]
    cpu = torch.device("cpu")
    reference_networks(cfg)
    assert other_modules["built"] == ["networks"]
    # the seeded weights' meta networks, then the package's reference
    ref.Reference(cfg, cpu, seeded_weights(cfg, 5, cpu, train=False))
    assert other_modules["built"] == ["networks", "networks", "reference"]
    reqs = traffic.requests(dict(cell.traffic, pool=3), 5, 32, ref.CHARSET)
    assert all(set(r.text) <= set("ab") for r in reqs)
    batch = serve_batch(cfg, reqs, 4, cpu)
    assert batch["label_ids"].tolist()[0] == ref.encode_text(reqs[0].text, cfg["seq_len"])
    # a per-layer reader takes the configuration's count
    r = Readout(type(cell)(cell.name, cfg, cell.traffic, [], [], 1), traced_units=1,
                trace=types.SimpleNamespace(device_seconds=lambda p: 1.0))
    ours = reader(ROOT, "geglu_roofline.serve")(r)
    r.cell.config = cell.config
    assert ours != reader(ROOT, "geglu_roofline.serve")(r)


def test_a_module_outside_the_benchmark_is_refused():
    cfg = dict(_config("textdesign_sd_2-finetune"), reference="udifftext_tpu_torch.engine")
    with pytest.raises(ValueError, match="not the benchmark's"):
        modules.reference(cfg)
