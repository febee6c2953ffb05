"""Reduction of a torch.profiler window of device activity to what the
per-layer metrics and the breakdown read: device time by kernel name, the
device's busy time (the union of its operations' intervals), and the idle
gaps between them, each named by the operation the device waited for, the
one that ended it. The window records no host activity: with the host's
100,000 operations a group recorded, the host paces the device and the
idle share reads several times too high."""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.autograd import DeviceType

TOP = 10
NAME_CHARS = 120


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, float]  # device seconds by operation name
    idle_gaps: List[Tuple[str, float]]  # (the operation waited for, seconds), longest first

    def device_seconds(self, patterns) -> float:
        """Device seconds of the operations whose name contains a pattern."""
        return sum(s for name, s in self.kernels.items() if any(p in name for p in patterns))

    def device_ops(self) -> List[Tuple[str, float]]:
        return sorted(((n[:NAME_CHARS], s) for n, s in self.kernels.items()),
                      key=lambda kv: -kv[1])[:TOP]


def _device_events(prof) -> List[Tuple[int, int, str]]:
    """The device's operations as (start ns, end ns, name), in order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start = e.start_ns()
            out.append((start, start + e.duration_ns(), e.name()))
    return sorted(out)


def summarize(prof: torch.profiler.profile, window_s: float) -> TraceSummary:
    dev = _device_events(prof)
    kernels: Dict[str, float] = defaultdict(float)
    for start, end, name in dev:
        kernels[name] += (end - start) * 1e-9
    busy = 0
    waited: Dict[str, float] = defaultdict(float)
    cur_s = cur_e = None
    for start, end, name in dev:
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                waited["before " + name[:NAME_CHARS]] += (start - cur_e) * 1e-9
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy += cur_e - cur_s
    idle = sorted(waited.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(window_s, busy * 1e-9, dict(kernels), idle)
