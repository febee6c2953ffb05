"""Tracing and profiling (port of `udifftext_tpu/utils/profiling.py`).

- `SimpleProfiler`: wall time by named section with a summary table (the
  reference trainer's Lightning `profiler: simple`). The clock is the
  host's: a section that queues device work and does not wait for it is
  timed as the queueing.
- `trace`: a `torch.profiler` window (host and, where there is a card,
  device activity) that writes a Chrome trace and yields the profiler.
- `flops_of`: the operations (`torch.utils.flop_counter`) and the bytes
  every dispatched op reads and writes, of one call.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


class SimpleProfiler:
    """Accumulates wall time per named section; prints a summary table."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def profile(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Account `seconds` spent elsewhere (another thread) to `name`."""
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        width = max([len(k) for k, _ in rows] + [8])
        lines = [f"{'section'.ljust(width)}  {'total s':>10}  {'count':>8}  {'mean ms':>10}"]
        for name, total in rows:
            n = self.counts[name]
            lines.append(f"{name.ljust(width)}  {total:10.3f}  {n:8d}  {total / n * 1e3:10.2f}")
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
    host's events recorded, its profiled samples took a few minutes more."""
    activities = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if not activities:
        raise RuntimeError("trace(host=False): no card to record")
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
