"""The port's span recorder (`utils/profiling.Recorder`, `RECORDER`), the
spans the program records at its layer boundaries, and the benchmark's
readers of them, on the CPU:

- off, a span reads no clock, makes no CUDA call and records nothing, also
  through the tiny engine's `sample` and a `train_step`;
- on, spans nest with parents, keys and threads;
- a stub-predictor `InpaintService` writes its group, stage and request
  spans, the requests keyed and parented by their group;
- the tiny engine's `sample` records its four stages in order with the
  autoencoder's spans inside, and counts 2·noise_iters + num_steps UNet
  evals;
- `train_step` records a forward and a backward for each micro-batch and
  one optimizer span inside its step;
- `SimpleProfiler` adds a device column only where events were recorded;
- `trace` writes the spans into its Chrome trace on the profiler's clock;
- a recorder records while any torch.profiler window is open, each into
  its own records;
- each of the benchmark's three span readers reads the program's spans,
  and returns None without them or without the recorder.
"""

import glob
import importlib.util
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_port_util as U
from udifftext_tpu_torch import train as port_train
from udifftext_tpu_torch.builders import build_engine, randomize_parameters
from udifftext_tpu_torch.parallel import train as PT
from udifftext_tpu_torch.serving import InpaintRequest, InpaintService
from udifftext_tpu_torch.utils import profiling
from udifftext_tpu_torch.utils.profiling import RECORDER, SimpleProfiler, Span

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def recorder():
    """The port's recorder, on for the test (no CUDA events) and off after."""
    RECORDER.start(cuda=False)
    try:
        yield RECORDER
    finally:
        RECORDER.stop()
        RECORDER.start(cuda=False)  # drop the test's records
        RECORDER.stop()


@pytest.fixture(scope="module")
def tiny_engine():
    return randomize_parameters(build_engine(U.tiny_model_cfg(), torch.float32, "cpu",
                                             train=True).engine, 3)


def _sample(engine, steps=2, iters=2):
    gen = torch.Generator().manual_seed(1)
    batch = U.to_torch(U.numpy_batch(2))
    return engine.sample(batch, gen, num_steps=steps, cfg_scale=4.0, noise_iters=iters)


def _linear_state():
    model = torch.nn.Linear(4, 3)
    return PT.TrainState.create(model, base_lr=1e-2, steps_per_epoch=1, use_ema=True), model


class _NoClock:
    """Stands in for the `time` module: any use fails the test."""

    def __getattr__(self, name):
        raise AssertionError(f"time.{name} used while the recorder is off")


def _fail(*args, **kwargs):
    raise AssertionError("a clock or CUDA call while the recorder is off")


# -- the recorder ---------------------------------------------------------------


def test_recorder_off_reads_no_clock_and_makes_no_cuda_call(monkeypatch, tiny_engine):
    RECORDER.stop()
    assert not RECORDER.recording()
    before = len(RECORDER.records())
    monkeypatch.setattr(profiling, "time", _NoClock())
    monkeypatch.setattr(profiling, "clock_ns", _fail)
    for name in ("Event", "synchronize", "is_initialized", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, _fail)
    assert profiling.span("a") is profiling.span("b", key=3)  # one shared no-op object
    with profiling.span("outer", key=1):
        with profiling.span("inner"):
            RECORDER.set_key(2, "outer")
            RECORDER.requests("req", [0.0, 1.0])
    _sample(tiny_engine, steps=1, iters=1)
    state, model = _linear_state()
    PT.train_step(state, [None, None], lambda _: (model(torch.ones(2, 4)).sum(), {}))
    port_train.to_device({"image": np.zeros((1, 2), np.float32)}, torch.device("cpu"))
    assert len(RECORDER.records()) == before


def test_recorder_on_nests_spans_with_parents_keys_and_threads(recorder):
    with profiling.span("outer", key="k") as outer:
        with profiling.span("mid"):
            with profiling.span("leaf", key=7):
                pass
            recorder.set_key(9, "outer")
            recorder.set_key(10, "absent")  # no open span of that name: nothing
        seen = {}

        def other():
            with profiling.span("thread.root"):
                with profiling.span("thread.leaf"):
                    seen["tid"] = threading.get_native_id()

        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert outer.key == 9
    recs = {s.name: s for s in recorder.records()}
    assert list(recs) == ["leaf", "mid", "thread.leaf", "thread.root", "outer"]  # by closing
    main = threading.get_native_id()
    assert recs["outer"].parent is None and recs["outer"].key == 9
    assert recs["mid"].parent == recs["outer"].id and recs["leaf"].parent == recs["mid"].id
    assert recs["leaf"].key == 7 and recs["mid"].key is None
    assert {recs[n].thread for n in ("outer", "mid", "leaf")} == {main}
    assert recs["thread.root"].parent is None  # parents are on the same thread only
    assert recs["thread.leaf"].parent == recs["thread.root"].id
    assert recs["thread.root"].thread == recs["thread.leaf"].thread == seen["tid"] != main
    for s in recs.values():
        assert s.start_ns <= s.end_ns and s.device_s is None
    assert recs["outer"].start_ns <= recs["mid"].start_ns <= recs["leaf"].start_ns
    assert recs["leaf"].end_ns <= recs["mid"].end_ns <= recs["outer"].end_ns
    recorder.count("x.y", 3)
    recorder.count("x.y")
    assert recorder.counters()["x.y"] >= 4


def test_counters_count_with_the_recorder_off():
    RECORDER.stop()
    n = RECORDER.counters().get("test.counter", 0)
    profiling.count("test.counter")
    profiling.count("test.counter", 2)
    assert RECORDER.counters()["test.counter"] == n + 3


# -- the program's spans ----------------------------------------------------------


def test_service_request_spans_carry_their_group_key(recorder):
    def predictor(arr_batch, key):
        return np.full((len(arr_batch["image"]), 8, 8, 3), key % 256, np.uint8)

    svc = InpaintService(predictor, max_batch=2, max_delay_ms=2000.0, size=8, seq_len=4)
    try:
        req = InpaintRequest(np.zeros((8, 8, 3), np.uint8), np.ones((8, 8), np.uint8), "ab")
        futs = [svc.submit(req) for _ in range(4)]
        results = [f.result(timeout=30) for f in futs]
    finally:
        svc.shutdown()
    spans = recorder.records()
    groups = {s.key: s for s in spans if s.name == "serve.group"}
    assert sorted(groups) == sorted({r["batch_key"] for r in results}) == [0, 1]
    reqs = [s for s in spans if s.name == "serve.request"]
    assert len(reqs) == 4 and sorted(s.key for s in reqs) == [0, 0, 1, 1]
    for s in reqs:
        g = groups[s.key]
        assert s.parent == g.id and s.thread is None
        assert s.start_ns <= g.end_ns and g.start_ns <= s.end_ns <= g.end_ns
    for name in ("serve.stack", "serve.predict", "serve.finalize"):
        kids = [s for s in spans if s.name == name]
        assert len(kids) == 2 and {groups[k].id for k in (0, 1)} == {s.parent for s in kids}
        assert all(s.thread == groups[0].thread for s in kids)
    assert len([s for s in spans if s.name == "serve.collect"]) == 2


def test_a_profiler_window_opened_in_the_predictor_records_its_stages_whole():
    """As the benchmark's traced window runs: opened inside the first
    traced group's predictor call, closed inside the last one's. Every
    stage of the predictor is recorded; the first group's own span, opened
    before the window, and the last group's finalize, after it, are not."""
    RECORDER.stop()
    RECORDER.take()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    calls = []

    def predictor(arr_batch, key):
        calls.append(key)
        if len(calls) == 1:
            prof.start()
        with profiling.span("predict.upload"):
            pass
        with profiling.span("sample.loop"):
            out = np.full((len(arr_batch["image"]), 8, 8, 3), key % 256, np.uint8)
        if len(calls) == 2:
            prof.stop()
        return out

    svc = InpaintService(predictor, max_batch=1, max_delay_ms=1.0, size=8, seq_len=4)
    try:
        req = InpaintRequest(np.zeros((8, 8, 3), np.uint8), np.ones((8, 8), np.uint8), "ab")
        for _ in range(3):
            svc.submit(req).result(timeout=30)
    finally:
        svc.shutdown()
    spans = RECORDER.take()
    names = [s.name for s in spans]
    assert names.count("predict.upload") == names.count("sample.loop") == 2
    (group,) = [s for s in spans if s.name == "serve.group"]
    assert group.key == 1
    first = [s for s in spans if s.name in ("predict.upload", "sample.loop") and s.parent is None]
    assert len(first) == 2 and all(s.end_ns <= group.start_ns for s in first)
    finalize = [s for s in spans if s.name == "serve.finalize"]
    assert len(finalize) == 1 and finalize[0].end_ns <= group.start_ns


def test_engine_sample_records_its_stages_and_counts_unet_evals(recorder, tiny_engine):
    evals = recorder.counters().get("unet.evals", 0)
    _sample(tiny_engine, steps=3, iters=2)
    assert recorder.counters()["unet.evals"] - evals == 2 * 2 + 3
    spans = recorder.records()
    stages = [s for s in spans if s.name.startswith("sample.")]
    assert [s.name for s in stages] == ["sample.condition", "sample.search", "sample.loop",
                                        "sample.decode"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(stages, stages[1:]))
    by_id = {s.id: s for s in spans}
    (enc,) = [s for s in spans if s.name == "vae.encode"]
    (dec,) = [s for s in spans if s.name == "vae.decode"]
    assert by_id[enc.parent].name == "sample.condition"
    assert by_id[dec.parent].name == "sample.decode"


def test_train_step_records_forward_and_backward_per_micro_batch(recorder):
    state, model = _linear_state()
    micro = [port_train.to_device({"image": np.ones((2, 4), np.float32)}, torch.device("cpu"))
             for _ in range(3)]
    for _ in range(2):
        PT.train_step(state, micro, lambda mb: (model(mb["image"]).square().sum(), {}))
    spans = recorder.records()
    steps = [s for s in spans if s.name == "train.step"]
    assert [s.key for s in steps] == [0, 1]
    assert len([s for s in spans if s.name == "train.to_device"]) == 3
    for step in steps:
        kids = [s.name for s in spans if s.parent == step.id]
        assert kids == ["loss.forward", "loss.backward"] * 3 + ["train.optimizer"]


def test_simple_profiler_device_column_only_with_events():
    prof = SimpleProfiler(cuda=False)
    with prof.profile("train_step"):
        pass
    prof.add("checkpoint", 0.5)
    plain = prof.summary()
    assert "device s" not in plain and prof.counts["train_step"] == 1
    prof.device["train_step"] += 2.25
    lines = prof.summary().splitlines()
    assert lines[0].endswith("device s") and len(lines) == 3
    row = next(ln for ln in lines if ln.startswith("train_step"))
    assert row.endswith("2.250") and lines[1].startswith("checkpoint")
    assert len(lines[1]) == len(row)  # a section without events: an empty cell


def test_trace_writes_spans_on_the_profilers_clock(tmp_path, recorder):
    a, b = torch.randn(32, 64), torch.randn(16, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.span("host.stage", key=5):
            F.linear(a, b)
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (stage,) = [e for e in events if e.get("name") == "host.stage"]
    mm = next(e for e in events if e.get("name") == "aten::mm")
    assert stage["cat"] == "span" and stage["args"]["key"] == 5 and stage["ph"] == "X"
    assert stage["tid"] == mm["tid"] and stage["pid"] == mm["pid"]
    assert stage["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= stage["ts"] + stage["dur"]


def test_recorder_follows_a_profiler_window():
    RECORDER.stop()
    RECORDER.take()
    with profiling.span("before"):
        pass
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with profiling.span("inside", key=4):
        with profiling.span("child"):
            assert RECORDER.recording()
        with profiling.span("open at the close") as last:
            prof.stop()
    with profiling.span("after"):
        pass
    spans = RECORDER.take()
    assert [s.name for s in spans] == ["child", "open at the close", "inside"]
    child, last_span, inside = spans
    assert child.parent == inside.id == last_span.parent and inside.key == 4
    assert last.cuda == torch.cuda.is_initialized()
    assert not RECORDER.recording() and RECORDER.take() == []


def test_each_recorder_follows_the_profiler_with_its_own_spans():
    RECORDER.stop()
    RECORDER.take()
    rec = profiling.Recorder()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with rec.span("own"):
            with profiling.span("port"):
                pass
    assert [s.name for s in rec.records()] == ["own"]
    (port,) = RECORDER.take()
    assert port.name == "port" and port.parent is None  # stacks are per recorder


# -- the benchmark's readers ------------------------------------------------------


def _reader(name):
    path = REPO / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _dev(name, sid, parent, device_s, thread=1, key=None):
    s = Span(name, 0, 1, sid, parent, thread, key)
    s.device_s = device_s
    return s


def _served_spans():
    # the first traced group's serve.group opened before the window: its stages alone
    return [_dev("predict.upload", 1, None, 0.1), _dev("sample.condition", 2, None, 0.6),
            _dev("vae.encode", 3, 2, 0.5), _dev("sample.search", 4, None, 2.5),
            _dev("sample.loop", 5, None, 5.8), _dev("sample.decode", 6, None, 1.0),
            _dev("vae.decode", 7, 6, 0.5), _dev("serve.finalize", 8, None, 0.01),
            _dev("serve.group", 9, None, 12.0, key=1), _dev("predict.upload", 10, 9, 0.2),
            _dev("sample.condition", 11, 9, 0.5), _dev("sample.search", 12, 9, 3.5),
            _dev("sample.loop", 13, 9, 5.8), _dev("sample.decode", 14, 9, 0.5),
            Span("sample.loop", 0, 1, 15, None, 1)]  # no device times: counts nothing


def _trained_spans():
    return [_dev("train.to_device", 1, None, 0.1), _dev("train.to_device", 2, None, 0.1),
            _dev("train.step", 3, None, 2.3, key=7), _dev("loss.forward", 4, 3, 1.2),
            _dev("vae.encode", 5, 4, 0.3), _dev("vae.encode", 6, 4, 0.2),
            _dev("loss.backward", 7, 3, 1.0)]


READERS = {
    "serve.search_share": (_served_spans, 100.0 * 6.0 / 20.5),
    "serve.vae_share": (_served_spans, 100.0 * 1.0 / 20.5),
    "train.encode_share": (_trained_spans, 100.0 * 0.5 / 2.5),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_programs_spans_and_nothing_without_them(name, monkeypatch):
    read = _reader(name)
    make, want = READERS[name]
    monkeypatch.setattr(RECORDER, "records", make)
    assert read(None) == pytest.approx(want, rel=1e-12)
    monkeypatch.setattr(RECORDER, "records", lambda: [])
    assert read(None) is None
    monkeypatch.delattr(profiling, "RECORDER")  # a program without the recorder
    assert read(None) is None


def test_benchmark_registers_the_readers():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["source"] == "program_counter"
        assert m["workloads"] == (["finetune-b16x4"] if name.startswith("train.")
                                  else ["serve-saturated"])
        assert m["layer"] in {e["layer"] for e in bench["per_layer"] if e["name"] not in READERS}
