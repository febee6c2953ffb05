"""Tracing and profiling (port of `udifftext_tpu/utils/profiling.py`).

- `Recorder`, and the port's one instance `RECORDER` (`span`, `count`):
  spans at the layer boundaries of serving, prediction, sampling, the
  autoencoder and fine-tuning, and counters. Off by default: a span then
  checks two flags (its own and torch.profiler's) and returns a shared
  no-op context manager (no clock read, no allocation, no CUDA call). It
  records while `start()`ed, and also while a torch.profiler window is
  open, whoever opened it, so that every profile of the port holds its
  host stages. Each span records its name, start and end on
  `clock_ns` (the clock of torch.profiler's events, host and device
  alike), its parent on the same thread, the thread and an optional key (a
  served group's batch key, a training step), and on a CUDA device a
  timing event on the current stream at entry and exit, resolved by
  `records()` after the caller has synchronized. Counters always count.
- `SimpleProfiler`: the train CLI's section table (the reference trainer's
  Lightning `profiler: simple`): each section a span of its own recorder,
  folded into seconds and counts by name; where CUDA events were recorded,
  the table adds the device seconds between each section's events.
- `trace`: a `torch.profiler` window (host and, where there is a card,
  device activity) that writes a Chrome trace, with the recorder's spans
  in the window as host tracks, and yields the profiler.
- `flops_of`: the operations (`torch.utils.flop_counter`) and the bytes
  every dispatched op reads and writes, of one call.

Span names: `serve.collect`, `serve.group` (key: the batch key) and its
children `serve.stack`, `serve.predict`, `serve.finalize`; `serve.complete`
(a pipelined group's finalize stage); `serve.request` (one a request, from
its enqueue to its resolution, written at resolution with its group's key;
on no thread's stack); `predict.upload`; `sample.condition`,
`sample.search`, `sample.loop`, `sample.decode`; `vae.encode`,
`vae.decode`; `train.to_device`; `train.step` (key: the step) and its
children `loss.forward`, `loss.backward`, `train.optimizer`. Counter:
`unet.evals`, one a call of `engine.network`'s UNet closure (a CFG eval
counts once).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# torch.profiler stamps its host and device events in Unix-epoch nanoseconds
# (torch 2.11 on an H100: tests/test_torch_tracing_card.py)
clock_ns = time.time_ns


class Span:
    """One recorded span. Times are `clock_ns` nanoseconds; `device_*` come
    from the span's CUDA events (None without them, or before `records()`
    resolved them): `device_s` the seconds between them, `device_start_ns`
    and `device_end_ns` their times put on the host clock through the
    recorder's anchor (None without one). `thread` is the native id of the
    thread whose stack held the span, None for a span written on another's
    behalf (`Recorder.requests`)."""

    __slots__ = ("name", "key", "start_ns", "end_ns", "id", "parent", "thread",
                 "device_s", "device_start_ns", "device_end_ns", "_events")

    def __init__(self, name: str, start_ns: int, end_ns: int, id: int, parent: Optional[int],
                 thread: Optional[int], key: Any = None, events=None):
        self.name, self.key, self.start_ns, self.end_ns = name, key, start_ns, end_ns
        self.id, self.parent, self.thread = id, parent, thread
        self.device_s = self.device_start_ns = self.device_end_ns = None
        self._events = events

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, key={self.key!r}, {self.seconds:.6f} s, id={self.id}, "
                f"parent={self.parent}, thread={self.thread}, device_s={self.device_s})")


class _Off:
    """The span of a recorder that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Open:
    """A span being recorded: pushed on its thread's stack at entry, written
    to the recorder at exit."""

    __slots__ = ("rec", "name", "key", "cuda", "id", "parent", "start", "ev0")

    def __init__(self, rec: "Recorder", name: str, key: Any, cuda: bool):
        self.rec, self.name, self.key, self.cuda = rec, name, key, cuda

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(rec._ids)
        stack.append(self)
        self.ev0 = None
        if self.cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.start = clock_ns()
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        events = None
        if self.ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
            events = (self.ev0, ev1)
        end = clock_ns()
        stack = rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        rec._records.append(Span(self.name, self.start, end, self.id, self.parent,
                                 threading.get_native_id(), self.key, events))
        return False


class Recorder:
    """Spans and counters (see the module's docstring). A span opened while
    the recorder records is written when it closes, even if the recorder
    stopped recording meanwhile. It also records while a torch.profiler
    window is open (CUDA events where CUDA is initialized); those spans
    stay until `start()` or `take()`."""

    def __init__(self):
        self.on = False
        self._cuda = False
        self._records: List[Span] = []
        self._anchor = None  # (clock_ns, the CUDA event recorded then)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._counters: Dict[str, int] = {}
        self._count_lock = threading.Lock()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def recording(self) -> bool:
        """Whether a span opened now is recorded."""
        return self.on or _autograd_profiler._is_profiler_enabled

    def span(self, name: str, key: Any = None):
        """A context manager recording `name` while the recorder records;
        otherwise the shared no-op one (`set_key` names a key known only
        later)."""
        if self.on:
            return _Open(self, name, key, self._cuda)
        if _autograd_profiler._is_profiler_enabled:
            return _Open(self, name, key, torch.cuda.is_initialized())
        return _OFF

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the counter `name` (counters always count)."""
        with self._count_lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        with self._count_lock:
            return dict(self._counters)

    def start(self, cuda: Optional[bool] = None) -> None:
        """Switch on with no records. `cuda` (default: whether CUDA is
        initialized in this process) makes spans record CUDA events; their
        device times go on the host clock once `anchor` has been called."""
        self._records = []
        self._anchor = None
        self._cuda = torch.cuda.is_initialized() if cuda is None else bool(cuda)
        self.on = True

    def stop(self) -> None:
        self.on = False

    def anchor(self) -> None:
        """Tie the CUDA events to the host clock: synchronize, read the
        clock, record an event. Call it where no other thread queues device
        work, so that the event runs at once."""
        if self._cuda:
            torch.cuda.synchronize()
            ev = torch.cuda.Event(enable_timing=True)
            host = clock_ns()
            ev.record()
            self._anchor = (host, ev)

    def set_key(self, key: Any, name: str) -> None:
        """Set the key of the innermost open span named `name` on this
        thread (a group's key is known only once the group is running)."""
        if not self.recording():
            return
        for s in reversed(self._stack()):
            if s.name == name:
                s.key = key
                return

    def requests(self, name: str, enqueued: Sequence[float]) -> None:
        """Write one span `name` a request, from its enqueue time
        (`time.monotonic()` seconds) until now, under the innermost open
        span of this thread and with its key; the spans go on no thread's
        stack."""
        if not self.recording():
            return
        now, mono = clock_ns(), time.monotonic()
        stack = self._stack()
        top = stack[-1] if stack else None
        parent, key = (top.id, top.key) if top is not None else (None, None)
        for t in enqueued:
            self._records.append(Span(name, now - int((mono - t) * 1e9), now, next(self._ids),
                                      parent, None, key))

    def records(self) -> List[Span]:
        """The spans written so far, the device times of those whose events
        have completed resolved (call after synchronizing)."""
        for s in self._records:
            _resolve(s, self._anchor)
        return list(self._records)

    def take(self) -> List[Span]:
        """`records()`, removed from the recorder."""
        out, self._records = self._records, []
        for s in out:
            _resolve(s, self._anchor)
        return out


def _resolve(s: Span, anchor) -> bool:
    """Fill `s`'s device times from its events once they have completed;
    returns whether `s` holds no pending events."""
    ev = s._events
    if ev is None:
        return True
    if not ev[1].query():
        return False
    s.device_s = ev[0].elapsed_time(ev[1]) * 1e-3
    if anchor is not None:
        s.device_start_ns = anchor[0] + round(anchor[1].elapsed_time(ev[0]) * 1e6)
        s.device_end_ns = anchor[0] + round(anchor[1].elapsed_time(ev[1]) * 1e6)
    s._events = None
    return True


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count


class SimpleProfiler:
    """Seconds by named section; prints a summary table. Each section is a
    span of the profiler's own recorder (always on, with CUDA events when
    `cuda`, by default when a card is present), folded into `totals` (host
    seconds), `counts` and, from the events, `device` seconds. The host
    clock times what the host spent in a section: for a section that queues
    device work without waiting for it, the enqueue; the device column
    times the work between its events."""

    def __init__(self, cuda: Optional[bool] = None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.device: Dict[str, float] = defaultdict(float)
        self.recorder = Recorder()
        self.recorder.start(torch.cuda.is_available() if cuda is None else cuda)
        self._pending: List[Span] = []  # folded but for their device seconds

    @contextlib.contextmanager
    def profile(self, name: str):
        with self.recorder.span(name):
            yield
        self._fold()

    def add(self, name: str, seconds: float) -> None:
        """Account `seconds` spent elsewhere (another thread) to `name`."""
        self.totals[name] += seconds
        self.counts[name] += 1

    def _fold(self, wait: bool = False) -> None:
        """Fold the recorder's spans into the table: host seconds at once,
        device seconds once their events have completed (all of them after
        a synchronize, with `wait`)."""
        for s in self.recorder.take():
            self.add(s.name, s.seconds)
            self._pending.append(s)
        if wait and self.recorder._cuda:
            torch.cuda.synchronize()
        pending = []
        for s in self._pending:
            if not _resolve(s, None):
                pending.append(s)
            elif s.device_s is not None:
                self.device[s.name] += s.device_s
        self._pending = pending

    def summary(self) -> str:
        self._fold(wait=True)
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        width = max([len(k) for k, _ in rows] + [8])
        dev = bool(self.device)
        lines = [f"{'section'.ljust(width)}  {'total s':>10}  {'count':>8}  {'mean ms':>10}"
                 + (f"  {'device s':>10}" if dev else "")]
        for name, total in rows:
            n = self.counts[name]
            line = f"{name.ljust(width)}  {total:10.3f}  {n:8d}  {total / n * 1e3:10.2f}"
            if dev:
                line += f"  {self.device[name]:10.3f}" if name in self.device else f"  {'':>10}"
            lines.append(line)
        return "\n".join(lines)

    def print_summary(self) -> None:
        print("\n== profiler summary ==")
        print(self.summary())


@contextlib.contextmanager
def trace(logdir: Optional[str] = "./logs/trace", host: bool = True) -> Iterator[profile]:
    """A torch.profiler window over the host's and, where a card is present,
    the card's activity; with `host` False over the card's alone (a
    breakdown of device time needs nothing else, and a window of a whole
    sample holds a few times fewer events to record and to sum). Yields the
    profiler, whose `key_averages()` the caller may read after the window;
    on leaving it, writes the Chrome trace (chrome://tracing, Perfetto) to
    `logdir/trace_<pid>_<ns>.json`, or nowhere when `logdir` is None. Device
    work still queued when the window closes is synchronized into it.
    chip_smoke.py's device-time breakdown depends on `host` False: with the
    host's events recorded, its profiled samples took a few minutes more.

    `RECORDER` records while the window is open (it follows torch.profiler),
    and the spans it wrote that overlap the window go into the Chrome trace
    as host tracks (one a thread, category "span", on the clock of the
    profiler's events), their key and device seconds in their args; when
    the recorder was `start()`ed before the window, its CUDA events are
    anchored at the window's start."""
    activities = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if not activities:
        raise RuntimeError("trace(host=False): no card to record")
    if RECORDER.on:
        RECORDER.anchor()
    t_open = clock_ns()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    t_close = clock_ns()
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        spans = [s for s in RECORDER.records() if s.end_ns >= t_open and s.start_ns <= t_close]
        if spans:
            _add_spans_to_chrome_trace(path, spans)


def _add_spans_to_chrome_trace(path: str, spans: Sequence[Span]) -> None:
    """Append `spans` to the Chrome trace at `path` as complete events of
    this process, on the track of the thread that held them (spans written
    on another's behalf on a track of their own), named where the trace
    names no such thread."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.setdefault("traceEvents", [])
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    named = {e.get("tid") for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"
             and e.get("pid") == pid}
    for s in spans:
        tid = s.thread if s.thread is not None else 0
        if tid not in named:
            named.add(tid)
            events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                           "args": {"name": f"spans of thread {tid}" if tid else "request spans"}})
        args = {"id": s.id, "parent": s.parent}
        if s.key is not None:
            args["key"] = s.key if isinstance(s.key, (int, float, str)) else repr(s.key)
        if s.device_s is not None:
            args["device_s"] = s.device_s
        events.append({"name": s.name, "cat": "span", "ph": "X", "pid": pid, "tid": tid,
                       "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


def _is_view(func) -> bool:
    """Whether an aten op returns an alias of an input (no bytes move)."""
    return any(a.alias_info is not None and not a.alias_info.is_write
               for a in func._schema.arguments)


class _BytesMode(TorchDispatchMode):
    """Sums, over every dispatched op that is not a view, the bytes of its
    tensor inputs and outputs (an `empty` allocation writes none)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _is_view(func):
            name = func._schema.name
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            outs = ([] if name.startswith(("aten::empty", "aten::new_empty"))
                    else [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)])
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


def flops_of(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """{"flops", "bytes_accessed"} of one call fn(*args, **kwargs).

    "flops" is `torch.utils.flop_counter.FlopCounterMode`'s total: 2 per
    multiply-add of every matmul, batched matmul, convolution and attention
    product, every tap of a padded convolution included (XLA's cost
    analysis leaves the padded taps out); no elementwise op counts.
    "bytes_accessed" sums, over every op dispatched that is not a view, the
    bytes of its tensor inputs and outputs: eager PyTorch fuses nothing, so
    this is the eager traffic, where XLA's figure is the fused program's.

    Count on the plain path. A hand-written kernel launched through ctypes
    (every wrapper in `ops/`) is invisible to the counter, so call `fn` on
    modules and tensors on the meta device (no wrapper launches for a
    non-CUDA tensor; the shapes alone are counted, nothing is computed), or
    on an engine built with `attn_impl="plain"`: the count is then the same
    whatever implements the function. Under `torch.no_grad`, every
    parameter `fn` reaches must have requires_grad False (the counter's
    module tracker hooks the autograd graph of one that does)."""
    counter = FlopCounterMode(display=False)
    moved = _BytesMode()
    with counter, moved:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": float(moved.bytes)}
