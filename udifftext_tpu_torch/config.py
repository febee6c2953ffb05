"""YAML configs with attribute access (the port's copy of the reader in
`udifftext_tpu/config.py`): `ConfigNode` gives the dot-access/dict duality the
entry points rely on. PyYAML is imported inside the function that reads a file, so
the package imports where it is not installed."""

from __future__ import annotations

from typing import Any


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

