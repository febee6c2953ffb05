"""DiscreteDenoiser (port of `udifftext_tpu/diffusion/denoiser.py`), eps
scaling and eps loss weighting.

D(x; sigma) = network(x·c_in, c_noise, cond)·c_out + x·c_skip, with sigma
quantized to the nearest entry of the 1000-step DDPM table and c_noise to
its index. `network(x, c_noise, cond)` returns (out, aux); aux passes
through.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .schedules import LegacyDDPMDiscretization, append_dims, eps_scaling, sigma_to_idx

NetworkFn = Callable[[torch.Tensor, torch.Tensor, Dict[str, Any]], Tuple[torch.Tensor, Any]]


@dataclasses.dataclass(frozen=True)
class DiscreteDenoiser:
    """Eps scaling and weighting, quantized sigma and c_noise."""

    num_idx: int = 1000
    discretization: LegacyDDPMDiscretization = LegacyDDPMDiscretization()

    @functools.cached_property
    def sigmas(self) -> np.ndarray:
        """Ascending table: index i is DDPM timestep i."""
        return self.discretization(self.num_idx, do_append_zero=False, flip=True)

    def w(self, sigma: torch.Tensor) -> torch.Tensor:
        """EpsWeighting of the loss: sigma⁻²."""
        return sigma**-2.0

    def _table(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.sigmas, device=like.device)

    def quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        table = self._table(sigma)
        return table[sigma_to_idx(sigma, table)]

    def quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        return sigma_to_idx(c_noise, self._table(c_noise))

    def __call__(self, network: NetworkFn, x: torch.Tensor, sigma: torch.Tensor,
                 cond: Dict[str, Any]) -> Tuple[torch.Tensor, Any]:
        sigma = self.quantize_sigma(sigma)
        c_skip, c_out, c_in, c_noise = eps_scaling(append_dims(sigma, x.ndim))
        c_noise = self.quantize_c_noise(c_noise.reshape(sigma.shape))
        out, aux = network(x * c_in, c_noise, cond)
        return out * c_out + x * c_skip, aux
