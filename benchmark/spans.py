"""The program's spans, for the per-layer readers that read them.

The port's recorder (`udifftext_tpu_torch.utils.profiling.RECORDER`)
records while a torch.profiler window is open, so after a traced run it
holds the spans of the groups or steps inside run.Tracer's window, each
with the device seconds between its CUDA events. A program without the
recorder has none, and its readers return None."""

from __future__ import annotations

from typing import Iterable, List


def program_spans() -> List:
    """The spans the program's recorder holds; [] where it has none."""
    try:
        from udifftext_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return []
    return RECORDER.records()


def device_seconds(spans: Iterable, names: Iterable[str]) -> float:
    """The device seconds of the spans named in `names` (those without
    device times count nothing)."""
    names = set(names)
    return sum(s.device_s for s in spans if s.name in names and s.device_s is not None)
