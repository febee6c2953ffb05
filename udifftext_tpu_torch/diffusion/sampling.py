"""Euler-EDM sampler (port of `udifftext_tpu/diffusion/sampling.py`), a
Python loop over the steps.

`sigmas` is the descending schedule with a trailing zero; `denoise_fn(x,
sigma_vec)` is the CFG-blended denoiser with sigma_vec of shape (B,).
"""

from __future__ import annotations

from typing import Callable

import torch

from .schedules import append_dims

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def init_latent(randn: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """x0 = randn·sqrt(1 + sigma_max²)."""
    return randn * torch.sqrt(1.0 + sigmas[0] ** 2)


def to_d(x: torch.Tensor, sigma: torch.Tensor, denoised: torch.Tensor) -> torch.Tensor:
    return (x - denoised) / append_dims(sigma, x.ndim)


def sample_euler_edm(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas: torch.Tensor,
                     s_churn: float = 0.0) -> torch.Tensor:
    """Deterministic Euler EDM loop (s_churn = 0)."""
    if s_churn > 0:
        raise NotImplementedError(
            "sample_euler_edm: stochastic churn (s_churn > 0) is not ported yet"
        )
    b = x.shape[0]
    for i in range(sigmas.shape[0] - 1):
        sigma = sigmas[i].expand(b).to(x.dtype)
        next_sigma = sigmas[i + 1].expand(b).to(x.dtype)
        d = to_d(x, sigma, denoise_fn(x, sigma))
        x = x + append_dims(next_sigma - sigma, x.ndim) * d
    return x
