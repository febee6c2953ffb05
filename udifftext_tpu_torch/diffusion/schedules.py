"""Diffusion schedule and scaling (port of `udifftext_tpu/diffusion/schedules.py`).

The sigma tables are built on the host in numpy exactly as in the JAX
build; the per-step functions act on torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def append_dims(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """Right-pad the shape with singleton dims."""
    dims_to_append = target_ndim - x.ndim
    if dims_to_append < 0:
        raise ValueError(f"input has {x.ndim} dims but target_ndim is {target_ndim}")
    return x[(...,) + (None,) * dims_to_append]


def make_beta_schedule(n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2) -> np.ndarray:
    """Linear-in-sqrt beta schedule."""
    return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2


@dataclasses.dataclass(frozen=True)
class LegacyDDPMDiscretization:
    """sigma(i) = sqrt((1 - abar_i) / abar_i) over the 1000-step DDPM table;
    `__call__` returns sigmas descending (ascending with flip=True), with a
    trailing zero when do_append_zero."""

    linear_start: float = 0.00085
    linear_end: float = 0.0120
    num_timesteps: int = 1000

    def get_sigmas(self, n: int) -> np.ndarray:
        betas = make_beta_schedule(self.num_timesteps, self.linear_start, self.linear_end)
        acp = np.cumprod(1.0 - betas, axis=0)
        if n < self.num_timesteps:
            steps = np.linspace(self.num_timesteps - 1, 0, n, endpoint=False).astype(int)[::-1]
            acp = acp[steps]
        elif n != self.num_timesteps:
            raise ValueError(f"n={n} > num_timesteps={self.num_timesteps}")
        sigmas = np.sqrt((1 - acp) / acp).astype(np.float32)
        return sigmas[::-1].copy()

    def __call__(self, n: int, do_append_zero: bool = True, flip: bool = False) -> np.ndarray:
        sigmas = self.get_sigmas(n)
        if do_append_zero:
            sigmas = np.concatenate([sigmas, np.zeros((1,), dtype=sigmas.dtype)])
        return sigmas[::-1].copy() if flip else sigmas


def eps_scaling(sigma: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """EpsScaling: (c_skip, c_out, c_in, c_noise)."""
    return torch.ones_like(sigma), -sigma, 1.0 / torch.sqrt(sigma**2 + 1.0), sigma


def sigma_to_idx(sigma: torch.Tensor, sigmas_table: torch.Tensor) -> torch.Tensor:
    """Index of the nearest table entry (first on ties)."""
    return torch.argmin(torch.abs(sigma[..., None] - sigmas_table), dim=-1)


def quantize_sigma(sigma: torch.Tensor, sigmas_table: torch.Tensor) -> torch.Tensor:
    return sigmas_table[sigma_to_idx(sigma, sigmas_table)]


@dataclasses.dataclass(frozen=True)
class DiscreteSampling:
    """Train-time sigma draw: a uniform index over the ascending num_idx-entry
    DDPM table (index 0 the smallest sigma)."""

    num_idx: int = 1000
    discretization: LegacyDDPMDiscretization = LegacyDDPMDiscretization()

    @property
    def sigmas(self) -> np.ndarray:
        return self.discretization(self.num_idx, do_append_zero=False, flip=True)

    def draw_idx(self, n: int, generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cpu") -> torch.Tensor:
        return torch.randint(0, self.num_idx, (n,), generator=generator, device=device)

    def __call__(self, idx: torch.Tensor) -> torch.Tensor:
        """The table's sigmas at `idx` (fp32, on idx's device)."""
        return torch.as_tensor(self.sigmas, device=idx.device)[idx]
