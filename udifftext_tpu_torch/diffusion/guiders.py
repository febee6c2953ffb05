"""Guiders (port of `udifftext_tpu/diffusion/guiders.py`).

`VanillaCFG` doubles the batch as (uc, c) for the four tensor conditioning
keys and blends uc + scale·(c − uc) after the network call;
`IdentityGuider` runs the conditional batch alone and returns it as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

_CFG_KEYS = ("vector", "t_crossattn", "v_crossattn", "concat")


@dataclasses.dataclass(frozen=True)
class VanillaCFG:
    scale: float = 5.0

    def prepare_cond(self, c: Dict[str, Any], uc: Dict[str, Any]) -> Dict[str, Any]:
        """The (uc, c) batch-doubled cond dict. A key outside the CFG keys
        must hold the same object in c and uc: guiding it silently would run
        the unconditional half with conditioning."""
        c_out = {}
        for k in c:
            if k in _CFG_KEYS:
                c_out[k] = torch.cat([uc[k], c[k]], dim=0)
            else:
                if k in uc and uc[k] is not c[k] and isinstance(c[k], torch.Tensor):
                    raise ValueError(
                        f"CFG key {k!r} is outside {_CFG_KEYS} but holds a distinct "
                        "tensor for cond vs uncond — route it via emb_key or extend "
                        "the guider"
                    )
                c_out[k] = c[k]
        return c_out

    def __call__(self, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        x_u, x_c = x.chunk(2, dim=0)
        return x_u + self.scale * (x_c - x_u)


@dataclasses.dataclass(frozen=True)
class IdentityGuider:
    def prepare_cond(self, c: Dict[str, Any], uc: Dict[str, Any]) -> Dict[str, Any]:
        return dict(c)

    def __call__(self, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        return x
