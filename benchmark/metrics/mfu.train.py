"""The trained samples' operations (benchmark/flops.py: two encodes, the
LabelEncoder, the UNet's forward and its backward into the trainable
branches, for each sample of the steps finished in the window) over the
window, as a share of one H100's bf16 peak."""

from benchmark.flops import PEAK_FLOPS


def read(r):
    if r.seconds <= 0 or r.flops <= 0:
        return None
    return 100.0 * r.flops / r.seconds / PEAK_FLOPS["bf16"]
