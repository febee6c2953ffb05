"""The share of a fine-tuning run's `GroupNorm32` calls that ran on the
fused GroupNorm+SiLU kernel: the frozen autoencoder encodes and the UNet's
norms before the first trainable layer; the rest pass gradients and stay on
the plain path."""

from benchmark.counters import groupnorm_kernel_share, program_counters


def read(r):
    return groupnorm_kernel_share(program_counters())
