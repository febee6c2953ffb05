"""Shared fixtures of the port's parity tests (tests/test_torch_*.py).

Both packages run the repo's tiny model graph (tests/test_cli_scripts.py
TINY_MODEL_YAML: 32-channel UNet with 2 levels, 32² images) with one set of
seeded random weights: every JAX parameter, zero-initialized projections
included, is drawn from a numpy seed and converted to the port with
`udifftext_tpu_torch.utils.convert`. Inputs are numpy arrays from a seed.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from test_cli_scripts import TINY_MODEL_YAML
from udifftext_tpu import charset

IMG, LAT, SEQ = 32, 16, 12

# The suite runs in several pytest-xdist workers at once. torch's default of
# one spinning intra-op thread per core oversubscribes the CPU, and these
# tests' tiny ops then spend most of their time waiting on each other (and
# slow every other worker's tests with them).
torch.set_num_threads(1)


def tiny_model_cfg() -> Dict[str, Any]:
    return yaml.safe_load(TINY_MODEL_YAML)["model"]["params"]


def random_like_flax(shapes, seed: int):
    """A params tree of `shapes` (from jax.eval_shape of an init) filled
    with seeded values: kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1²),
    biases N(0, 0.05²), embeddings N(0, 1)."""
    rs = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        r = rs.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return r / math.sqrt(max(1, int(np.prod(s.shape[:-1]))))
        if name == "scale":
            return 1.0 + 0.1 * r
        if name == "bias":
            return 0.05 * r
        return r

    return jax.tree_util.tree_map_with_path(fill, shapes)


def flax_params(module, seed: int, *init_args):
    """Seeded random params for a flax module, shaped by tracing its init."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)
    return random_like_flax(shapes, seed)


def engine_params(engine, seed: int = 0):
    """{"unet", "vae", "label_encoder"} params of a tiny JAX DiffusionEngine."""
    tdim = engine.unet.t_context_dim
    return {
        "unet": flax_params(engine.unet, seed, jnp.zeros((1, LAT, LAT, engine.unet.in_channels)),
                            jnp.zeros((1,)), jnp.zeros((1, SEQ, tdim))),
        "vae": flax_params(engine.vae, seed + 1, jnp.zeros((1, IMG, IMG, 3))),
        "label_encoder": flax_params(engine.label_encoder, seed + 2,
                                     jnp.zeros((1, SEQ), jnp.int32)),
    }


def load_port(module: torch.nn.Module, state_dict) -> torch.nn.Module:
    """Load a converted state dict strictly: every port parameter is set."""
    module.load_state_dict(state_dict, strict=True)
    return module.eval()


def tiny_unet_pair(seed: int = 9):
    """tests/test_sampling.py's tiny UNet (4 channels in, 8², one attention
    level, context dim 8) in both packages with every parameter seeded
    random, the zero-initialized output conv included (zero, it would make
    any two samplers agree): (JAX module, its params, port module, a (2, 3,
    8) context)."""
    from udifftext_tpu.models.unet import UNetModel as JUNet
    from udifftext_tpu_torch.models.unet import UNetModel as PUNet
    from udifftext_tpu_torch.utils import convert

    kw = dict(in_channels=4, out_channels=4, model_channels=32, num_res_blocks=1,
              attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=8, t_context_dim=8)
    junet = JUNet(**kw, attn_impl="xla")
    params = flax_params(junet, seed, jnp.zeros((2, 8, 8, 4)), jnp.zeros((2,)),
                         jnp.zeros((2, 3, 8)))
    punet = load_port(PUNet(**kw), convert.unet_from_jax(params))
    ctx = np.random.RandomState(seed).standard_normal((2, 3, 8)).astype(np.float32)
    return junet, params, punet, ctx


def numpy_batch(b: int = 1, seed: int = 0) -> Dict[str, np.ndarray]:
    rs = np.random.RandomState(seed)
    mask = np.zeros((b, IMG, IMG, 1), np.float32)
    mask[:, 8:24, 6:26] = 1.0
    seg_mask = np.zeros((b, SEQ), np.float32)
    seg_mask[:, :3] = 1.0
    image = rs.uniform(-1, 1, (b, IMG, IMG, 3)).astype(np.float32)
    return {
        "image": image,
        "masked": image * (1 - mask),
        "mask": mask,
        "seg_mask": seg_mask,
        "label_ids": charset.encode_labels(["abc"] * b, SEQ),
    }


def to_torch(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def to_jax(batch: Dict[str, np.ndarray]):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_close(got, want, rtol: float, atol: float, what: str = "") -> None:
    """Elementwise |got − want| <= atol + rtol·|want|, with the worst
    offender in the message."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    bound = atol + rtol * np.abs(want)
    worst = np.unravel_index(np.argmax(err - bound), err.shape) if err.size else ()
    assert np.all(err <= bound), (
        f"{what}: max abs err {err.max():.3e} (at {worst}: got {got[worst]:.6g}, "
        f"want {want[worst]:.6g}; rtol {rtol}, atol {atol})"
    )


def flat_dict(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested dict's leaves keyed by their dotted paths."""
    out: Dict[str, Any] = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat_dict(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out
