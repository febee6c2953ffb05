"""The served samples' operations (benchmark/flops.py: a group's count over
its bucket, for each sample completed in the window) over the window, as a
share of one H100's bf16 peak."""

from benchmark.flops import PEAK_FLOPS


def read(r):
    if r.seconds <= 0 or r.flops <= 0:
        return None
    return 100.0 * r.flops / r.seconds / PEAK_FLOPS["bf16"]
