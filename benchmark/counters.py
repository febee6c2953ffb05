"""The program's counters, for the per-layer readers that read them.

The port's recorder (`udifftext_tpu_torch.utils.profiling.RECORDER`)
counts always, from the process's start: after a run its counters hold the
set-up's, the window's and the traced units' calls alike. A program without
the recorder, or without a counter, has nothing to read there, and its
readers return None."""

from __future__ import annotations

from typing import Dict, Optional


def program_counters() -> Dict[str, int]:
    """The counters the program's recorder holds; {} where it has none."""
    try:
        from udifftext_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return {}
    return RECORDER.counters()


def groupnorm_kernel_share(counters: Dict[str, int]) -> Optional[float]:
    """100 × the `GroupNorm32` calls that ran on the fused kernel
    (`groupnorm.kernel`) over all of them (and `groupnorm.plain`); None
    without such calls."""
    kernel, plain = counters.get("groupnorm.kernel", 0), counters.get("groupnorm.plain", 0)
    return 100.0 * kernel / (kernel + plain) if kernel + plain else None
