"""YAML configs with attribute access and `{target, params}` instantiation
(the port's copy of `udifftext_tpu/config.py`): `ConfigNode` gives the
dot-access/dict duality the entry points rely on; `instantiate_from_config`
builds a node's `target` with its `params`, the reference's `sgm.*` targets
remapped to the port's classes and builders (`TARGET_REMAP`). PyYAML is
imported inside the function that reads a file, so the package imports where
it is not installed."""

from __future__ import annotations

import importlib
from typing import Any, Dict


class ConfigNode(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return ConfigNode({k: ConfigNode.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigNode.wrap(v) for v in obj]
        return obj


def load_config(path: str) -> ConfigNode:
    """The YAML file at `path` as a `ConfigNode`."""
    import yaml

    with open(path) as f:
        return ConfigNode.wrap(yaml.safe_load(f))


# Reference dotted paths → the port's counterparts (resolved lazily).
TARGET_REMAP: Dict[str, str] = {
    "sgm.models.diffusion.DiffusionEngine": "udifftext_tpu_torch.builders.build_engine",
    "sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization":
        "udifftext_tpu_torch.diffusion.schedules.LegacyDDPMDiscretization",
    "sgm.modules.diffusionmodules.discretizer.EDMDiscretization":
        "udifftext_tpu_torch.diffusion.schedules.EDMDiscretization",
    "sgm.modules.diffusionmodules.sigma_sampling.DiscreteSampling":
        "udifftext_tpu_torch.builders.build_discrete_sampling",
    "sgm.modules.diffusionmodules.sigma_sampling.EDMSampling":
        "udifftext_tpu_torch.diffusion.schedules.EDMSampling",
    "sgm.modules.diffusionmodules.denoiser.DiscreteDenoiser":
        "udifftext_tpu_torch.builders.build_discrete_denoiser",
    "sgm.modules.diffusionmodules.guiders.VanillaCFG":
        "udifftext_tpu_torch.diffusion.guiders.VanillaCFG",
    "sgm.modules.diffusionmodules.guiders.IdentityGuider":
        "udifftext_tpu_torch.diffusion.guiders.IdentityGuider",
    "sgm.modules.autoencoding.regularizers.DiagonalGaussianRegularizer":
        "udifftext_tpu_torch.diffusion.vae_loss.DiagonalGaussianRegularizer",
}


def get_obj_from_str(string: str, reload: bool = False) -> Any:
    """The object a dotted path names, after `TARGET_REMAP`."""
    module, name = TARGET_REMAP.get(string, string).rsplit(".", 1)
    mod = importlib.import_module(module)
    if reload:
        importlib.reload(mod)
    return getattr(mod, name)


def instantiate_from_config(config: Dict[str, Any]) -> Any:
    """`target(**params)` of a config node."""
    if "target" not in config:
        raise KeyError("Expected key `target` to instantiate.")
    return get_obj_from_str(config["target"])(**(config.get("params") or {}))
