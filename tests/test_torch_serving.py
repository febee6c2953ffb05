"""The port's serving layer (udifftext_tpu_torch/serving.py, scripts/serve.py,
scripts/serve_bench.py) on the CPU.

Every contract of tests/test_serving.py (the JAX package's MicroBatcher,
InpaintService and HTTP front end, with stub predictors) runs here against
the port's classes. Three tests show the faults of the JAX batcher that the
port does not carry over: each runs one scenario on both classes, and the
JAX class shows the fault where the port's does not. Then the tiny engine
behind the service, with a group replayed bit for bit from its replay
coordinates, and the benchmark's entry function. Every test that starts
threads runs under its own time limit (`bounded`), and every wait in it has
a timeout.
"""

import base64
import functools
import hashlib
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import CancelledError
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np
import pytest
import torch

import torch_port_util as U
from udifftext_tpu import serving as jax_serving
from udifftext_tpu_torch.scripts import serve, serve_bench
from udifftext_tpu_torch.serving import (
    HostCopy,
    InpaintRequest,
    InpaintService,
    MicroBatcher,
    batch_seed,
)


def bounded(seconds: float):
    """Run the test body in a thread and fail it if it has not ended within
    `seconds` (a hung dispatcher must not hang the suite)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            out = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — re-raised on the test's thread
                    out["error"] = e

            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(seconds)
            assert not t.is_alive(), f"{fn.__name__} did not end within {seconds} s"
            if "error" in out:
                raise out["error"]
        return inner
    return wrap


def _wait_until(cond, timeout: float = 5.0) -> bool:
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.002)
    return True


# -- MicroBatcher ------------------------------------------------------------


@bounded(20)
def test_full_batch_dispatches_before_deadline():
    calls = []

    def run(items):
        calls.append(list(items))
        return [i * 10 for i in items]

    mb = MicroBatcher(run, max_batch=4, max_delay_ms=5000.0)
    t0 = time.monotonic()
    futs = [mb.submit(i) for i in range(4)]
    results = [f.result(timeout=10) for f in futs]
    elapsed = time.monotonic() - t0
    mb.shutdown()
    assert results == [0, 10, 20, 30]
    assert elapsed < 4.0, "a full batch must not wait out the deadline"
    assert [sorted(c) for c in calls] == [[0, 1, 2, 3]]


@bounded(20)
def test_stats_latency_windows():
    def run(items):
        time.sleep(0.05)
        return list(items)

    mb = MicroBatcher(run, max_batch=2, max_delay_ms=1.0)
    futs = [mb.submit(i) for i in range(4)]
    [f.result(timeout=10) for f in futs]
    st = mb.stats()
    mb.shutdown()
    assert st["run"]["p50_s"] >= 0.05
    assert st["run"]["p95_s"] >= st["run"]["p50_s"]
    assert st["queue_wait"]["p95_s"] >= st["queue_wait"]["p50_s"] >= 0.0


@bounded(20)
def test_deadline_flushes_partial_batch():
    sizes = []

    def run(items):
        sizes.append(len(items))
        return items

    mb = MicroBatcher(run, max_batch=8, max_delay_ms=100.0)
    assert mb.submit("only").result(timeout=10) == "only"
    mb.shutdown()
    assert sizes == [1]


@bounded(20)
def test_results_map_to_their_requests():
    mb = MicroBatcher(lambda items: [f"r:{i}" for i in items], max_batch=3, max_delay_ms=50.0)
    futs = {i: mb.submit(i) for i in range(7)}
    for i, f in futs.items():
        assert f.result(timeout=10) == f"r:{i}"
    mb.shutdown()
    st = mb.stats()
    assert st["requests"] == 7
    assert st["batches"] >= 3  # 7 items across max-3 groups


@bounded(20)
def test_error_fails_group_but_keeps_serving():
    state = {"fail": True}

    def run(items):
        if state["fail"]:
            raise RuntimeError("backend down")
        return items

    mb = MicroBatcher(run, max_batch=2, max_delay_ms=30.0)
    f1, f2 = mb.submit(1), mb.submit(2)
    with pytest.raises(RuntimeError, match="backend down"):
        f1.result(timeout=10)
    with pytest.raises(RuntimeError, match="backend down"):
        f2.result(timeout=10)
    state["fail"] = False
    assert mb.submit(3).result(timeout=10) == 3
    assert mb.stats()["errors"] == 2
    mb.shutdown()


@bounded(20)
def test_result_count_mismatch_is_an_error():
    mb = MicroBatcher(lambda items: items[:-1] if len(items) > 1 else items,
                      max_batch=2, max_delay_ms=1000.0)
    f1, f2 = mb.submit(1), mb.submit(2)
    with pytest.raises(RuntimeError, match="returned 1 results"):
        f1.result(timeout=10)
    with pytest.raises(RuntimeError):
        f2.result(timeout=10)
    mb.shutdown()


@bounded(20)
def test_shutdown_rejects_new_requests():
    mb = MicroBatcher(lambda items: items, max_batch=2, max_delay_ms=10.0)
    mb.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        mb.submit(1)


# -- InpaintService ----------------------------------------------------------


def _fake_predictor(max_batch, size, shapes_seen):
    def predict(arr_batch, key):
        shapes_seen.append({k: v.shape for k, v in arr_batch.items()})
        # uint8 wire format: the service ships raw uint8 image/mask
        assert arr_batch["image"].shape == (max_batch, size, size, 3)
        assert arr_batch["image"].dtype == np.uint8
        assert arr_batch["mask"].shape == (max_batch, size, size, 1)
        assert arr_batch["mask"].dtype == np.uint8
        assert arr_batch["seg_mask"].shape == (max_batch, 12)
        assert arr_batch["label_ids"].shape == (max_batch, 12)
        out = np.zeros((max_batch, size, size, 3), np.float32)
        for i in range(max_batch):
            out[i] = i / 255.0  # row i's identifiable constant
        return out

    return predict


def _req(text="ok", hw=8):
    return InpaintRequest(image=np.zeros((hw, hw, 3), np.uint8), mask=np.ones((hw, hw)),
                          text=text)


@bounded(30)
def test_inpaint_service_pads_to_static_shape():
    shapes = []
    svc = InpaintService(_fake_predictor(4, 16, shapes), max_batch=4, max_delay_ms=200.0,
                         size=16)
    reqs = [InpaintRequest(image=np.full((8, 8, 3), 100, np.uint8),
                           mask=np.ones((8, 8), np.uint8), text=f"t{i}") for i in range(3)]
    futs = [svc.submit(r) for r in reqs]
    results = [f.result(timeout=20) for f in futs]
    svc.shutdown()
    assert len(shapes) == 1  # 3 requests -> one batch padded to 4
    for i, res in enumerate(results):
        assert res["row"] == i and res["batch_key"] == 0
        assert np.all(res["image"] == i) and res["image"].dtype == np.uint8


@bounded(30)
def test_inpaint_service_key_counter_advances():
    svc = InpaintService(_fake_predictor(1, 16, []), max_batch=1, max_delay_ms=1.0, size=16)
    a = svc.inpaint(_req("x"), timeout=20)
    b = svc.inpaint(_req("x"), timeout=20)
    svc.shutdown()
    assert (a["batch_key"], b["batch_key"]) == (0, 1)


@bounded(30)
def test_inpaint_service_rejects_bad_text():
    svc = InpaintService(_fake_predictor(1, 16, []), max_batch=1, max_delay_ms=1.0, size=16)
    with pytest.raises(ValueError, match="1..12 characters"):
        svc.inpaint(_req("way-too-long-for-twelve"), timeout=20)
    svc.shutdown()


@bounded(30)
def test_bad_request_does_not_poison_cobatched_group():
    """Rows are built and validated at submit, on the caller's thread."""
    svc = InpaintService(_fake_predictor(2, 16, []), max_batch=2, max_delay_ms=150.0, size=16)
    good = svc.submit(_req("ok"))
    with pytest.raises(ValueError, match="1..12 characters"):
        svc.submit(_req(""))
    res = good.result(timeout=20)
    svc.shutdown()
    assert res["row"] == 0 and np.all(res["image"] == 0)


def _echo_predictor(size, batch_sizes_seen):
    """Bucket-agnostic stub: output matching the presented batch."""
    def predict(arr_batch, key):
        b = arr_batch["image"].shape[0]
        batch_sizes_seen.append(b)
        out = np.zeros((b, size, size, 3), np.float32)
        for i in range(b):
            out[i] = i / 255.0
        return out

    return predict


@bounded(30)
def test_inpaint_service_buckets_pad_to_smallest_fit():
    sizes = []
    svc = InpaintService(_echo_predictor(16, sizes), max_batch=4, max_delay_ms=120.0, size=16,
                         batch_buckets=(1, 4))
    lone = svc.inpaint(_req(), timeout=20)
    futs = [svc.submit(_req()) for _ in range(3)]
    grouped = [f.result(timeout=20) for f in futs]
    svc.shutdown()
    assert sizes == [1, 4]  # lone request at bucket 1, group of 3 padded to 4
    assert lone["batch_size"] == 1 and lone["row"] == 0
    assert all(r["batch_size"] == 4 for r in grouped)
    assert [r["row"] for r in grouped] == [0, 1, 2]


@bounded(30)
def test_inpaint_service_bucket_validation():
    with pytest.raises(ValueError, match="must equal max_batch"):
        InpaintService(_echo_predictor(16, []), max_batch=4, size=16, batch_buckets=(1, 2))
    with pytest.raises(ValueError, match="positive"):
        InpaintService(_echo_predictor(16, []), max_batch=4, size=16, batch_buckets=(0, 4))


@bounded(30)
def test_inpaint_service_dp_divisibility():
    with pytest.raises(ValueError, match="divisible by the data-parallel"):
        InpaintService(_echo_predictor(16, []), max_batch=4, size=16, batch_buckets=(1, 4), dp=2)
    with pytest.raises(ValueError, match="dp must be >= 1"):
        InpaintService(_echo_predictor(16, []), max_batch=4, size=16, dp=0)
    sizes = []
    svc = InpaintService(_echo_predictor(16, sizes), max_batch=4, size=16, max_delay_ms=1.0,
                         batch_buckets=(2, 4), dp=2)
    res = svc.inpaint(_req(), timeout=20)
    svc.shutdown()
    assert sizes == [2] and res["batch_size"] == 2  # a lone request pads to dp


@bounded(30)
def test_inpaint_service_warmup_compiles_each_bucket():
    sizes = []
    svc = InpaintService(_echo_predictor(16, sizes), max_batch=4, max_delay_ms=1.0, size=16,
                         batch_buckets=(1, 2, 4))
    svc.warmup()
    svc.shutdown()
    assert sizes == [1, 2, 4]


@bounded(30)
def test_inpaint_service_default_single_bucket_unchanged():
    sizes = []
    svc = InpaintService(_echo_predictor(16, sizes), max_batch=4, max_delay_ms=1.0, size=16)
    res = svc.inpaint(_req(), timeout=20)
    svc.shutdown()
    assert sizes == [4] and res["batch_size"] == 4


def test_rows_at_the_service_size_need_no_pillow(monkeypatch):
    """A request already at size × size is built without Pillow and equals
    what Pillow's same-size resize gives; any other size needs Pillow and
    says so where it is missing."""
    rs = np.random.RandomState(3)
    image = rs.randint(0, 256, (16, 16, 3)).astype(np.uint8)
    mask = (rs.uniform(size=(16, 16)) > 0.5).astype(np.float32)
    svc_rows = {}
    for pil in (True, False):
        if not pil:
            monkeypatch.setitem(sys.modules, "PIL", None)
        svc = InpaintService(_echo_predictor(16, []), max_batch=1, size=16)
        try:
            svc_rows[pil] = svc.build_row(InpaintRequest(image=image, mask=mask, text="ab"))
            if not pil:
                with pytest.raises(RuntimeError, match="needs Pillow"):
                    svc.build_row(_req(hw=8))
        finally:
            svc.shutdown()
    monkeypatch.delitem(sys.modules, "PIL")
    from PIL import Image

    want_img = np.asarray(Image.fromarray(image).resize((16, 16)), np.uint8)
    want_mask = np.asarray(Image.fromarray((mask > 0).astype(np.uint8) * 255)
                           .resize((16, 16), Image.NEAREST), np.uint8)[..., None]
    for row in svc_rows.values():
        assert np.array_equal(row["image"], want_img) and np.array_equal(row["mask"], want_mask)
        assert row["image"] is not image
    jax_row = jax_serving.InpaintService(_echo_predictor(16, []), max_batch=1, size=16)
    try:
        want = jax_row._build_row(jax_serving.InpaintRequest(image=image, mask=mask, text="ab"))
    finally:
        jax_row.shutdown()
    for k, v in want.items():
        assert np.array_equal(svc_rows[False][k], v) and svc_rows[False][k].dtype == v.dtype, k


def test_host_copy_and_batch_seed():
    """HostCopy passes CPU results through; batch_seed is a fixed function of
    (seed, key) that separates keys and seeds."""
    t = torch.arange(6, dtype=torch.uint8).reshape(1, 2, 3)
    assert np.array_equal(HostCopy(t).numpy(), t.numpy())
    assert np.array_equal(HostCopy(t.numpy()).numpy(), t.numpy())
    seeds = {batch_seed(s, k) for s in range(3) for k in range(50)}
    assert len(seeds) == 150 and all(0 <= x < 2**63 for x in seeds)
    assert batch_seed(0, 7) == int.from_bytes(
        hashlib.sha256(b"0:7").digest()[:8], "little") & (2**63 - 1)


# -- HTTP front-end -----------------------------------------------------------


def _b64_png(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _http(svc, ready):
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(svc, ready))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(base, payload: bytes):
    req = urllib.request.Request(base + "/v1/inpaint", data=payload,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _http_code(fn) -> int:
    try:
        fn()
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def _payload(text="ok"):
    return json.dumps({"image": _b64_png(np.full((8, 8, 3), 128, np.uint8)),
                       "mask": _b64_png(np.full((8, 8), 255, np.uint8)), "text": text}).encode()


@bounded(60)
def test_http_server_roundtrip():
    svc = InpaintService(_fake_predictor(2, 16, []), max_batch=2, max_delay_ms=10.0, size=16)
    ready = threading.Event()
    httpd, base = _http(svc, ready)
    try:
        assert _http_code(lambda: urllib.request.urlopen(base + "/healthz", timeout=10)) == 503
        ready.set()
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.status == 200
        body = _post(base, _payload())
        assert body["row"] == 0 and body["batch_size"] == 2 and body["batch_key"] == 0
        from PIL import Image

        img = Image.open(io.BytesIO(base64.b64decode(body["image"])))
        assert img.size == (16, 16)
        with urllib.request.urlopen(base + "/v1/stats", timeout=10) as r:
            assert json.loads(r.read())["requests"] == 1
        # malformed request -> 400, server stays up
        assert _http_code(lambda: _post(base, b'{"text": "no images"}')) == 400
        assert _http_code(lambda: _post(base, _payload(text=""))) == 400
        assert _http_code(lambda: urllib.request.urlopen(base + "/nope", timeout=10)) == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.shutdown()


@bounded(60)
def test_http_server_reports_model_failure_as_500():
    def broken(arr_batch, key):
        raise RuntimeError("card fell over")

    svc = InpaintService(broken, max_batch=1, max_delay_ms=1.0, size=16)
    ready = threading.Event()
    ready.set()
    httpd, base = _http(svc, ready)
    try:
        assert _http_code(lambda: _post(base, _payload())) == 500
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.shutdown()


def test_serve_stops_when_the_data_parallel_group_breaks():
    """`serve` returns, having shut the service down, once `broken` is set
    (the data-parallel predictor's mark of a failed group). It runs on the
    test's thread, which its SIGTERM handler needs; a SIGTERM after 20 s
    ends it should `broken` not."""
    import os
    import signal

    svc = InpaintService(_echo_predictor(16, []), max_batch=1, size=16)
    broken = threading.Event()
    backstop = threading.Timer(20.0, os.kill, (os.getpid(), signal.SIGTERM))
    old = signal.getsignal(signal.SIGTERM)
    threading.Timer(0.3, broken.set).start()
    backstop.start()
    t0 = time.monotonic()
    try:
        serve.serve(svc, 0, threading.Event(), broken)
    finally:
        backstop.cancel()
        signal.signal(signal.SIGTERM, old)
    assert time.monotonic() - t0 < 15.0
    with pytest.raises(RuntimeError):
        svc.submit(InpaintRequest(image=np.zeros((16, 16, 3), np.uint8),
                                  mask=np.ones((16, 16), np.uint8), text="a"))


def test_build_service_dp_needs_a_process_group(monkeypatch):
    """dp > 1 outside a process group of dp processes raises before any
    engine is built."""
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="needs a process group of 2 processes"):
        serve.build_service({}, U.tiny_model_cfg(), "cpu", dp=2)


def test_build_service_dp_must_equal_world_size(monkeypatch):
    """A dp other than the process group's size is refused, by the service
    (inside a one-process gloo group) and by the CLI (before the group)."""
    import socket

    import torch.distributed as tdist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
                     WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    try:
        with pytest.raises(ValueError, match=r"--dp 2 must equal .*WORLD_SIZE 1"):
            serve.build_service({}, U.tiny_model_cfg(), "cpu", dp=2)
        assert tdist.is_initialized() and tdist.get_world_size() == 1
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    with pytest.raises(SystemExit, match="--dp 2 must equal WORLD_SIZE"):
        serve.main(["--dp", "2", "--device", "cpu"])


# -- pipelined dispatch (launch/finalize split) ------------------------------


@bounded(30)
def test_pipelined_batcher_overlaps_launch_with_finalize():
    """Depth 2 launches group N+1 while group N finalizes; results resolve
    in dispatch order."""
    launches, finals = [], []
    gate = threading.Event()

    def launch(items):
        launches.append((time.monotonic(), list(items)))
        return list(items)

    def finalize(handle):
        if not finals:
            gate.wait(5.0)  # hold group 0 in finalize until group 1 launched
        finals.append(time.monotonic())
        return [f"done-{i}" for i in handle]

    mb = MicroBatcher(launch, max_batch=1, max_delay_ms=0.0, finalize=finalize,
                      pipeline_depth=2)
    f0, f1 = mb.submit(0), mb.submit(1)
    _wait_until(lambda: len(launches) >= 2)
    n_launched_while_finalizing = len(launches)
    gate.set()
    assert f0.result(timeout=10) == "done-0" and f1.result(timeout=10) == "done-1"
    mb.shutdown()
    assert n_launched_while_finalizing == 2
    st = mb.stats()
    assert st["batches"] == 2 and st["errors"] == 0


@bounded(30)
def test_pipelined_depth_one_serializes():
    active, overlap = [], []
    lock = threading.Lock()

    def launch(items):
        with lock:
            active.append(1)
            overlap.append(sum(active))
        return list(items)

    def finalize(handle):
        time.sleep(0.05)
        with lock:
            active.pop()
        return ["ok" for _ in handle]

    mb = MicroBatcher(launch, max_batch=1, max_delay_ms=0.0, finalize=finalize,
                      pipeline_depth=1)
    futs = [mb.submit(i) for i in range(4)]
    assert all(f.result(timeout=10) == "ok" for f in futs)
    mb.shutdown()
    assert max(overlap) == 1  # never two groups in flight


@bounded(30)
def test_pipelined_finalize_error_fails_only_its_group():
    def finalize(handle):
        if handle[0] == "bad":
            raise RuntimeError("boom in finalize")
        return [f"ok-{x}" for x in handle]

    mb = MicroBatcher(lambda items: list(items), max_batch=1, max_delay_ms=0.0,
                      finalize=finalize, pipeline_depth=2)
    good1, bad, good2 = mb.submit("a"), mb.submit("bad"), mb.submit("b")
    assert good1.result(timeout=10) == "ok-a"
    with pytest.raises(RuntimeError, match="boom in finalize"):
        bad.result(timeout=10)
    assert good2.result(timeout=10) == "ok-b"
    mb.shutdown()
    assert mb.stats()["errors"] == 1


@bounded(30)
def test_pipelined_launch_error_fails_only_its_group():
    def launch(items):
        if items[0] == "bad":
            raise RuntimeError("boom in launch")
        return list(items)

    mb = MicroBatcher(launch, max_batch=1, max_delay_ms=0.0,
                      finalize=lambda h: [f"ok-{x}" for x in h], pipeline_depth=2)
    bad, good = mb.submit("bad"), mb.submit("a")
    with pytest.raises(RuntimeError, match="boom in launch"):
        bad.result(timeout=10)
    assert good.result(timeout=10) == "ok-a"
    mb.shutdown()


def _lazy_predictor(calls=None):
    def predict(arr_batch, key):
        b = arr_batch["image"].shape[0]
        if calls is not None:
            calls.append(b)

        class _Lazy:  # materializes only under np.asarray
            shape = (b, 16, 16, 3)

            def __array__(self, dtype=None, copy=None):
                out = np.zeros((b, 16, 16, 3), np.float32)
                for i in range(b):
                    out[i] = i / 255.0
                return out

        return _Lazy()

    return predict


@bounded(30)
def test_inpaint_service_pipelined_end_to_end():
    calls = []
    svc = InpaintService(_lazy_predictor(calls), max_batch=4, max_delay_ms=100.0, size=16,
                         batch_buckets=(1, 4), pipeline_depth=2)
    svc.warmup()
    reqs = [InpaintRequest(image=np.full((8, 8, 3), 50, np.uint8),
                           mask=np.ones((8, 8), np.uint8), text=f"t{i}") for i in range(3)]
    futs = [svc.submit(r) for r in reqs]
    results = [f.result(timeout=20) for f in futs]
    svc.shutdown()
    assert calls == [1, 4, 4]
    for i, res in enumerate(results):
        assert res["row"] == i and res["batch_size"] == 4
        assert np.all(res["image"] == i) and res["image"].dtype == np.uint8


@bounded(60)
def test_http_server_roundtrip_pipelined():
    svc = InpaintService(_lazy_predictor(), max_batch=2, max_delay_ms=10.0, size=16,
                         pipeline_depth=2)
    ready = threading.Event()
    ready.set()
    httpd, base = _http(svc, ready)
    try:
        body = _post(base, _payload())
        assert body["row"] == 0 and body["batch_size"] == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.shutdown()


@bounded(30)
def test_pipelined_run_stat_is_finalize_time_not_queueing():
    """Pipelined, `run` is the finalize stage's wall time, not launch →
    completion (which adds the queueing behind the group ahead). The bounds
    hold on a loaded host: at least the finalize's sleep, and well below
    the launch → completion time measured in the same run."""
    sleep = 0.05
    launched = {}

    def launch(items):
        launched[items[0]] = time.monotonic()
        return list(items)

    def finalize(handle):
        time.sleep(sleep)
        return ["ok" for _ in handle]

    mb = MicroBatcher(launch, max_batch=1, max_delay_ms=0.0, finalize=finalize,
                      pipeline_depth=2)
    futs = [mb.submit(i) for i in range(6)]
    done = {}
    for i, f in enumerate(futs):
        assert f.result(timeout=10) == "ok"
        done[i] = time.monotonic()
    st = mb.stats()
    mb.shutdown()
    assert st["batches"] == 6
    in_flight = sorted(done[i] - launched[i] for i in range(1, 6))
    assert st["run"]["p50_s"] >= sleep * 0.99, st["run"]
    assert st["run"]["p50_s"] < 0.75 * in_flight[len(in_flight) // 2], (st["run"], in_flight)


# -- the JAX batcher's three faults, absent from the port's -------------------


def _cancel_scenario(mb_cls) -> bool:
    """A future cancelled while queued, behind a pipelined group: does a
    request after it still resolve? (JAX: set_result on the cancelled
    future kills the completion thread.)"""
    gate = threading.Event()

    def launch(items):
        if items[0] == "a":
            gate.wait(5.0)
        return list(items)

    mb = mb_cls(launch, max_batch=1, max_delay_ms=0.0, finalize=lambda h: list(h),
                pipeline_depth=2)
    a = mb.submit("a")
    assert _wait_until(lambda: mb._queue.qsize() == 0)  # "a" is launching
    b = mb.submit("b")
    assert b.cancel()
    gate.set()
    assert a.result(timeout=5) == "a"
    with pytest.raises(CancelledError):
        b.result(timeout=1)
    c = mb.submit("c")
    try:
        served = c.result(timeout=1.5) == "c"
    except FutureTimeout:
        served = False
    if served:
        mb.shutdown(timeout=5)
    return served


# the JAX batcher's completion thread dies of its fault: pytest reports it
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@bounded(30)
def test_cancelled_future_does_not_kill_the_completion_thread():
    assert _cancel_scenario(MicroBatcher)
    assert not _cancel_scenario(jax_serving.MicroBatcher)  # the JAX batcher's fault


def _late_group_scenario(mb_cls) -> str:
    """Shutdown whose timeout expires under a full pipeline (depth 1, the
    first group held in finalize, the second waiting for its slot): what
    happens to the second request once the first finishes? "result" (served),
    "failed" (failed explicitly) or "hung" (never resolved)."""
    gate = threading.Event()
    finalizing = threading.Event()

    def finalize(handle):
        if handle[0] == "a":
            finalizing.set()
            gate.wait(5.0)
        return list(handle)

    mb = mb_cls(lambda items: list(items), max_batch=1, max_delay_ms=0.0, finalize=finalize,
                pipeline_depth=1)
    a = mb.submit("a")
    assert finalizing.wait(5)
    b = mb.submit("b")
    assert _wait_until(lambda: mb._queue.qsize() == 0)  # "b" waits for the slot
    mb.shutdown(timeout=0.2)
    gate.set()
    a.exception(timeout=5)  # "a" resolves either way
    try:
        b.result(timeout=1.5)
        return "result"
    except FutureTimeout:
        return "hung"
    except RuntimeError:
        return "failed"


@bounded(30)
def test_shutdown_past_its_timeout_fails_late_groups():
    assert _late_group_scenario(MicroBatcher) == "failed"
    assert _late_group_scenario(jax_serving.MicroBatcher) == "hung"  # the JAX batcher's fault


@bounded(30)
def test_shutdown_under_a_full_pipeline_serves_every_group():
    """With time enough, shutdown drains a full pipeline: the dispatcher's
    stop marker reaches the completion thread after its last launch."""
    gate = threading.Event()

    def finalize(handle):
        gate.wait(5.0)
        return list(handle)

    mb = MicroBatcher(lambda items: list(items), max_batch=1, max_delay_ms=0.0,
                      finalize=finalize, pipeline_depth=2)
    futs = [mb.submit(i) for i in range(4)]
    threading.Timer(0.2, gate.set).start()
    mb.shutdown(timeout=10)
    assert [f.result(timeout=0) for f in futs] == [0, 1, 2, 3]
    assert not mb._thread.is_alive() and not mb._completion_thread.is_alive()


def _top_up_scenario(mb_cls):
    """Group sizes when requests arrive while the pipeline is full (depth 1,
    group 0 held in finalize, one request already waiting): the JAX batcher
    closes the waiting group at its deadline, before it has a slot."""
    gate = threading.Event()
    finalizing = threading.Event()
    sizes = []

    def launch(items):
        sizes.append(len(items))
        return list(items)

    def finalize(handle):
        if handle[0] == "a":
            finalizing.set()
            gate.wait(5.0)
        return list(handle)

    mb = mb_cls(launch, max_batch=4, max_delay_ms=50.0, finalize=finalize, pipeline_depth=1)
    futs = [mb.submit("a")]
    assert finalizing.wait(5)
    futs.append(mb.submit("b"))
    time.sleep(0.5)  # ten times b's deadline: the JAX dispatcher has closed [b]
    futs += [mb.submit(x) for x in "cde"]
    gate.set()
    assert [f.result(timeout=5) for f in futs] == list("abcde")
    mb.shutdown(timeout=5)
    return sizes


@bounded(30)
def test_requests_arriving_under_a_full_pipeline_join_the_waiting_group():
    assert _top_up_scenario(MicroBatcher) == [1, 4]
    assert _top_up_scenario(jax_serving.MicroBatcher) == [1, 1, 3]  # the JAX batcher's fault


# -- the tiny engine behind the service ---------------------------------------


@bounded(240)
def test_tiny_engine_service_replays_bit_exact():
    """The tiny graph (seeded random weights) behind a pipelined service
    with buckets (1, 2): uint8 images of the request size, rows differ, and
    each group replays bit for bit from (contents, batch_key, batch_size);
    the benchmark's entry function runs both phases over the same engine."""
    bench = serve_bench.run(max_batch=2, steps=2, noise_iters=2, batches=2, qps=0.0,
                            latency_requests=2, buckets=(1, 2), pipeline=2,
                            saturated_delay_ms=500.0, noise_search_batched=True,
                            model_cfg=U.tiny_model_cfg(), size=U.IMG, device="cpu")
    rec = bench.record
    assert rec["metric"] == f"torch_cpu_serve_{U.IMG}_2step_samples_per_sec"
    assert rec["value"] > 0 and rec["saturated_batcher_stats"]["mean_batch_size"] == 2.0
    assert rec["saturated_batcher_stats"]["batches"] == 2 and rec["batcher_stats"]["batches"] == 2
    assert rec["overlap"]["groups"] == 2 and 0.0 <= rec["overlap"]["share"] <= 1.0
    assert len(rec["latency_s"]) == 2 and min(rec["latency_s"]) > 0
    assert rec["latency_p50_s"] == np.percentile(rec["latency_s"], 50)
    json.dumps(rec)
    assert [(r["row"], r["batch_size"]) for r in bench.saturated] == [(0, 2), (1, 2)] * 2
    assert [(r["row"], r["batch_size"]) for r in bench.latency] == [(0, 1), (0, 1)]
    for r in bench.saturated + bench.latency:
        assert r["image"].shape == (U.IMG, U.IMG, 3) and r["image"].dtype == np.uint8
    assert not np.array_equal(bench.saturated[0]["image"], bench.saturated[1]["image"])

    svc = bench.make_service(1.0)
    try:
        row = svc.build_row(bench.request)
        for group in (bench.saturated[:2], bench.saturated[2:], bench.latency[:1]):
            key, size = group[0]["batch_key"], group[0]["batch_size"]
            again = bench.predict(svc.batch_of([row] * size), key)
            assert again.dtype == torch.uint8
            for r in group:
                assert np.array_equal(again[r["row"]].numpy(), r["image"]), (key, r["row"])
    finally:
        svc.shutdown()


# -- the predictor's uint8 wire format -----------------------------------------


def test_predictor_uint8_wire_format_matches_the_float_path():
    """A uint8 batch (image, mask with or without its channel axis) equals,
    bit for bit, the float path on the batch that the JAX package's
    device-side preprocessing (udifftext_tpu/predict.py, the uint8 branch of
    JittedPredictor) makes from the same arrays, evaluated here with jnp;
    the images come back through the JAX package's uint8 expression."""
    import jax.numpy as jnp

    from udifftext_tpu_torch.builders import build_engine, randomize_parameters
    from udifftext_tpu_torch.predict import Predictor

    pe = randomize_parameters(build_engine(U.tiny_model_cfg(), torch.float32, "cpu").engine, 3)
    rs = np.random.RandomState(4)
    image = rs.randint(0, 256, (2, U.IMG, U.IMG, 3)).astype(np.uint8)
    mask = np.zeros((2, U.IMG, U.IMG), np.uint8)
    mask[:, 8:24, 6:26] = 255
    mask[1, 0, :5] = 1  # any nonzero value is text
    rest = {k: v for k, v in U.numpy_batch(2).items() if k in ("seg_mask", "label_ids")}
    img = jnp.asarray(image).astype(jnp.float32) / 127.5 - 1.0
    m = (jnp.asarray(mask) > 0).astype(jnp.float32)[..., None]
    float_batch = {"image": np.array(img), "mask": np.array(m),
                   "masked": np.array(img * (1.0 - m)), **rest}
    gen = torch.Generator().manual_seed(1)
    eps = torch.randn(2, U.LAT, U.LAT, 4, generator=gen)
    noise = torch.randn(2, 2, U.LAT, U.LAT, 4, generator=gen)
    pred = Predictor(pe, num_steps=2, noise_iters=2, noise_search_batched=True)
    want, _ = pred(float_batch, posterior_eps=eps, noise=noise)
    want = np.array((jnp.clip(jnp.asarray(want.numpy()), 0.0, 1.0) * 255.0).astype(jnp.uint8))
    assert want.std() > 0
    for m_in in (mask, mask[..., None]):
        got, _ = pred({"image": image, "mask": m_in, **rest}, posterior_eps=eps, noise=noise)
        assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
