"""Wall time by named section with a summary table (port of
`SimpleProfiler` in `udifftext_tpu/utils/profiling.py`; the reference
trainer's Lightning `profiler: simple`). The clock is the host's: a section
that queues device work and does not wait for it is timed as the queueing.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


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
