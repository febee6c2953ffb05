"""Diffusion schedules, scalings, weightings and train-time sigma draws
(port of `udifftext_tpu/diffusion/schedules.py`).

The sigma tables are built on the host in numpy exactly as in the JAX
build; the per-step functions act on torch tensors. `SCALINGS` and
`WEIGHTINGS` map the builder's tags ("eps", "v", "edm", "unit") to the
functions.
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


class Discretization:
    """`__call__(n, do_append_zero, flip)`: the subclass's descending
    `get_sigmas(n)`, with a trailing zero when do_append_zero, ascending
    with flip."""

    def get_sigmas(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, n: int, do_append_zero: bool = True, flip: bool = False) -> np.ndarray:
        sigmas = self.get_sigmas(n)
        if do_append_zero:
            sigmas = np.concatenate([sigmas, np.zeros((1,), dtype=sigmas.dtype)])
        return sigmas[::-1].copy() if flip else sigmas


@dataclasses.dataclass(frozen=True)
class LegacyDDPMDiscretization(Discretization):
    """sigma(i) = sqrt((1 - abar_i) / abar_i) over the 1000-step DDPM table."""

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


@dataclasses.dataclass(frozen=True)
class EDMDiscretization(Discretization):
    """Karras rho-schedule from sigma_max down to sigma_min."""

    sigma_min: float = 0.02
    sigma_max: float = 80.0
    rho: float = 7.0

    def get_sigmas(self, n: int) -> np.ndarray:
        ramp = np.linspace(0, 1, n, dtype=np.float64)
        min_inv_rho = self.sigma_min ** (1 / self.rho)
        max_inv_rho = self.sigma_max ** (1 / self.rho)
        return ((max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** self.rho).astype(np.float32)


def eps_scaling(sigma: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """EpsScaling: (c_skip, c_out, c_in, c_noise)."""
    return torch.ones_like(sigma), -sigma, 1.0 / torch.sqrt(sigma**2 + 1.0), sigma


def v_scaling(sigma: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """VScaling: (c_skip, c_out, c_in, c_noise)."""
    return (1.0 / (sigma**2 + 1.0), -sigma / torch.sqrt(sigma**2 + 1.0),
            1.0 / torch.sqrt(sigma**2 + 1.0), sigma)


def edm_scaling(sigma: torch.Tensor, sigma_data: float = 0.5) -> Tuple[torch.Tensor, ...]:
    """EDMScaling: (c_skip, c_out, c_in, c_noise)."""
    return (sigma_data**2 / (sigma**2 + sigma_data**2),
            sigma * sigma_data / torch.sqrt(sigma**2 + sigma_data**2),
            1.0 / torch.sqrt(sigma**2 + sigma_data**2), 0.25 * torch.log(sigma))


SCALINGS = {"eps": eps_scaling, "v": v_scaling, "edm": edm_scaling}


def unit_weighting(sigma: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(sigma)


def eps_weighting(sigma: torch.Tensor) -> torch.Tensor:
    return sigma**-2.0


def edm_weighting(sigma: torch.Tensor, sigma_data: float = 0.5) -> torch.Tensor:
    return (sigma**2 + sigma_data**2) / (sigma * sigma_data) ** 2


def v_weighting(sigma: torch.Tensor) -> torch.Tensor:
    return edm_weighting(sigma, sigma_data=1.0)


WEIGHTINGS = {"unit": unit_weighting, "eps": eps_weighting, "edm": edm_weighting,
              "v": v_weighting}


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
    discretization: Discretization = LegacyDDPMDiscretization()

    @property
    def sigmas(self) -> np.ndarray:
        return self.discretization(self.num_idx, do_append_zero=False, flip=True)

    def draw_idx(self, n: int, generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cpu") -> torch.Tensor:
        return torch.randint(0, self.num_idx, (n,), generator=generator, device=device)

    def __call__(self, idx: torch.Tensor) -> torch.Tensor:
        """The table's sigmas at `idx` (fp32, on idx's device)."""
        return torch.as_tensor(self.sigmas, device=idx.device)[idx]


@dataclasses.dataclass(frozen=True)
class EDMSampling:
    """Train-time lognormal sigma draw: exp(p_mean + p_std·randn)."""

    p_mean: float = -1.2
    p_std: float = 1.2

    def draw_randn(self, n: int, generator: Optional[torch.Generator] = None,
                   device: torch.device | str = "cpu") -> torch.Tensor:
        return torch.randn((n,), generator=generator, device=device)

    def __call__(self, randn: torch.Tensor) -> torch.Tensor:
        """The sigmas of standard-normal draws `randn` (n,)."""
        return torch.exp(self.p_mean + self.p_std * randn)
