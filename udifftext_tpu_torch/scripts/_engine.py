"""What the UNet stage probes share: the seeded engine or block, its plain
twin on the same tensors, where `work` counts a call's operations and bytes
through `utils.profiling.flops_of` (a kernel launched through ctypes is
invisible to the counter, and the twin reaches no kernel wrapper, so the
count is the function's whatever implements it), the UNet's inputs and a
copy of the VAE in another dtype."""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils._pytree import tree_leaves

from ..builders import TEXTDESIGN_SD_2, EngineBundle, build_engine, randomize_parameters
from ..models.layers import cast_weights, set_norm_impl
from ..utils.profiling import flops_of
from ._timing import nbytes

CTX_LEN = 12  # LabelEncoder tokens (max_len of the shipped graph)
SEED = 0  # every probe's weights and draws


def seeded_engine(device: torch.device, model_cfg: Optional[Dict[str, Any]] = None,
                  dtype: torch.dtype = torch.bfloat16) -> EngineBundle:
    """The engine of `model_cfg` (default: the shipped graph) with its UNet in
    `dtype`, on `device`, with random weights from SEED (never zeros: an
    all-zero operand draws less power than real data)."""
    bundle = build_engine(model_cfg or TEXTDESIGN_SD_2, dtype, device)
    randomize_parameters(bundle.engine, SEED)
    return bundle


def seeded(build: Callable[[], nn.Module], device: torch.device, seed: int,
           dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """The frozen block `build()` makes, made on `device` with seeded random
    parameters, its Linear/Conv weights stored in `dtype`."""
    with torch.device(device):
        module = randomize_parameters(build(), seed)
    return cast_weights(module, dtype).eval().requires_grad_(False)


def plain_twin(module: nn.Module, build_plain: Callable[[], nn.Module]) -> nn.Module:
    """The module `build_plain()` makes (the same one with attn_impl or impl
    "plain"; its GroupNorms on their plain path too), holding `module`'s own parameters and buffers: built on the
    meta device, then given them without a copy."""
    with torch.device("meta"):
        twin = build_plain()
    set_norm_impl(twin, "plain")
    twin.load_state_dict(module.state_dict(keep_vars=True), assign=True)
    for name, buf in module.named_buffers():  # the non-persistent ones too
        owner, _, attr = name.rpartition(".")
        twin.get_submodule(owner)._buffers[attr] = buf
    return twin.eval().requires_grad_(False)


def plain_engine(bundle: EngineBundle, model_cfg: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.bfloat16):
    """`bundle`'s engine with attn_impl="plain" on the same tensors."""
    return plain_twin(bundle.engine, lambda: build_engine(
        model_cfg or TEXTDESIGN_SD_2, dtype, "meta", attn_impl="plain").engine)


def latent_side(bundle: EngineBundle, size: int) -> int:
    return size // bundle.engine.latent_factor


def unet_inputs(bundle: EngineBundle, rows: int, side: int, device: torch.device,
                generator: Optional[torch.Generator] = None):
    """(x (rows, side, side, in_channels), timesteps (rows,), context (rows, 12,
    t_context_dim)) in the UNet's dtype: standard normal, timesteps uniform
    in [0, 1000)."""
    unet = bundle.engine.unet
    dt = unet.dtype

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=device).to(dt)

    x = randn(rows, side, side, unet.in_channels)
    ts = torch.rand(rows, generator=generator, device=device) * 1000.0
    ctx = randn(rows, CTX_LEN, unet.t_context_dim)
    return x, ts, ctx


def vae_in(vae: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of the VAE that computes in `dtype` on the same weights (the
    graph's `first_stage_bf16`); norm statistics stay fp32."""
    out = cast_weights(copy.deepcopy(vae), dtype)
    out.dtype = dtype
    return out


def param_bytes(module: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


def work(fn: Callable[[], Any], inputs=(), modules=()) -> Tuple[float, float, float]:
    """(operations, bytes moved once, eager bytes) of one call fn() on plain
    modules: `flops_of`'s operations and eager traffic, and the least bytes
    the call must move, the parameters of `modules` and the `inputs` read
    once and fn's tensor outputs written once."""
    outs = []
    with torch.no_grad():
        counted = flops_of(lambda: outs.append(fn()))
    moved = (sum(param_bytes(m) for m in modules) + nbytes(*inputs)
             + nbytes(*(t for t in tree_leaves(outs) if isinstance(t, torch.Tensor))))
    return counted["flops"], float(moved), counted["bytes_accessed"]
