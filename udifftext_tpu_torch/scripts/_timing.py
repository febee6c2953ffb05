"""The probes' and STR tools' shared helpers: timing, the device, the card
line and the H100 bound."""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Dict, Optional, Tuple

import torch

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W limit):
# HBM bytes a second, and operations a second on the tensor cores for bf16
# and TF32 and on the CUDA cores for fp32.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}


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


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(flops: float, moved: float, dtype: torch.dtype,
             tf32: bool = False) -> Tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time an H100 could take for
    `flops` operations of `dtype` (bf16 on the tensor cores; fp32 at the
    CUDA cores' rate, or at the TF32 tensor-core rate with `tf32`, which
    cuDNN's fp32 convolutions take by PyTorch's default) and `moved` bytes
    (each input read once, each output written once), whichever bounds it."""
    rate = ("bf16" if dtype == torch.bfloat16 else "tf32" if tf32 else "fp32")
    ops = flops / PEAK_FLOPS[rate] * 1e3
    mem = moved / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


class Rows:
    """Times labelled calls with `time_ms` and prints one row each: the ms
    and, where the work is given as (operations, bytes moved once), the
    GFLOP, the rate and the H100 bound. `results` maps label → ms."""

    def __init__(self, device: torch.device, reps: int, runs: int, width: int = 56):
        self.device, self.reps, self.runs, self.width = device, reps, runs, width
        self.results: Dict[str, float] = {}

    def time(self, label: str, fn: Callable[[], object],
             work: Optional[Tuple[float, float]] = None, dtype: torch.dtype = torch.bfloat16,
             tf32: bool = False, note: str = "") -> float:
        ms = self.results[label] = time_ms(fn, self.reps, self.runs, self.device)
        line = f"{label:{self.width}s} {ms:10.3f} ms"
        if work is not None:
            flops, moved = work
            bound, by = bound_ms(flops, moved, dtype, tf32)
            line += (f"  {flops / 1e9:10.1f} GFLOP {flops / ms / 1e9:7.1f} TFLOP/s  "
                     f"bound {bound:.3f} ms by {by} ({bound / ms:.2f} of it)")
        print(line + (f"  {note}" if note else ""), flush=True)
        return ms


def card_line(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints them (raises if it fails); on the CPU a
    line saying that the times are the host's."""
    if device.type != "cuda":
        return "CPU, host clock: no time below is a device time"
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]
