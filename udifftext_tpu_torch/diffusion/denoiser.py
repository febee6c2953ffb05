"""Denoisers (port of `udifftext_tpu/diffusion/denoiser.py`).

D(x; sigma) = network(x·c_in, c_noise, cond)·c_out + x·c_skip, with
(c_skip, c_out, c_in, c_noise) from the scaling and the loss weight w(sigma)
from the weighting (`schedules.SCALINGS` / `WEIGHTINGS`, by tag). `Denoiser`
is continuous; `DiscreteDenoiser` quantizes sigma to the nearest entry of
its discretization's num_idx-entry table and c_noise to that entry's index.
`network(x, c_noise, cond)` returns (out, aux); aux passes through.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .schedules import (SCALINGS, WEIGHTINGS, Discretization, LegacyDDPMDiscretization,
                        append_dims, sigma_to_idx)

NetworkFn = Callable[[torch.Tensor, torch.Tensor, Dict[str, Any]], Tuple[torch.Tensor, Any]]


@dataclasses.dataclass(frozen=True)
class Denoiser:
    """Continuous denoiser: sigma and c_noise go to the network as they are."""

    scaling: str = "eps"
    weighting: str = "eps"

    def w(self, sigma: torch.Tensor) -> torch.Tensor:
        """The diffusion loss's weight at sigma."""
        return WEIGHTINGS[self.weighting](sigma)

    def scale(self, sigma: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return SCALINGS[self.scaling](sigma)

    def quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma

    def quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        return c_noise

    def __call__(self, network: NetworkFn, x: torch.Tensor, sigma: torch.Tensor,
                 cond: Dict[str, Any]) -> Tuple[torch.Tensor, Any]:
        sigma = self.quantize_sigma(sigma)
        c_skip, c_out, c_in, c_noise = self.scale(append_dims(sigma, x.ndim))
        c_noise = self.quantize_c_noise(c_noise.reshape(sigma.shape))
        out, aux = network(x * c_in, c_noise, cond)
        return out * c_out + x * c_skip, aux


@dataclasses.dataclass(frozen=True)
class DiscreteDenoiser(Denoiser):
    """Quantized sigma and c_noise: the table is ascending, so the index is
    the DDPM timestep the UNet expects."""

    num_idx: int = 1000
    discretization: Discretization = LegacyDDPMDiscretization()

    @functools.cached_property
    def sigmas(self) -> np.ndarray:
        """Ascending table: index i is DDPM timestep i."""
        return self.discretization(self.num_idx, do_append_zero=False, flip=True)

    def _table(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.sigmas, device=like.device)

    def quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        table = self._table(sigma)
        return table[sigma_to_idx(sigma, table)]

    def quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        return sigma_to_idx(c_noise, self._table(c_noise))
