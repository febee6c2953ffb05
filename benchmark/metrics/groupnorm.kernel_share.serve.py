"""The share of a served run's `GroupNorm32` calls (the UNet's 61 an eval,
the autoencoder's encode and decode) that ran on the fused GroupNorm+SiLU
kernel: sampling runs without autograd, so every call the kernel takes."""

from benchmark.counters import groupnorm_kernel_share, program_counters


def read(r):
    return groupnorm_kernel_share(program_counters())
