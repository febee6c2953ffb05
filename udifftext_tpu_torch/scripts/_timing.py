"""The probes' and STR tools' shared helpers: timing, and the device."""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


def time_ms(fn: Callable[[], object], reps: int, runs: int, device: torch.device) -> float:
    """Median over `runs` of the milliseconds per call of `reps` back-to-back
    calls: CUDA events on the GPU, the host clock on the CPU."""
    fn()  # warm-up; the first kernel call also builds the library
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
    else:
        for _ in range(runs):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(times)


def probe_device(name: str, device: str) -> torch.device:
    """`device` as a torch.device; a probe or tool asked for the card fails
    without one."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name}: no CUDA device found (pass device='cpu' or --device cpu to "
                           "run the script on the CPU)")
    return dev
