"""The modules of the yardstick that serve one configuration, named in its
file: `reference`, the package of its plain reference (its networks and
their precisions, the method: sampling and the fine-tuning step, the
vocabulary; as benchmark/reference/__init__.py exports them), and `flops`,
the count of its operations. A file that names neither takes UDiffText's,
which build and count the SD-2 layout; a configuration that they cannot
build or count brings its own as new files under benchmark/ and names them
here, so no file the benchmark already has changes for it. A named module
lies in the benchmark (`benchmark.` ...): the reference and the count take
nothing of the program."""

from __future__ import annotations

import importlib
from types import ModuleType

DEFAULTS = {"reference": "benchmark.reference", "flops": "benchmark.flops"}


def module(cfg: dict, role: str) -> ModuleType:
    name = cfg.get(role, DEFAULTS[role])
    if not name.startswith("benchmark."):
        raise ValueError(f"the configuration's {role} module {name!r} is not the benchmark's")
    return importlib.import_module(name)


def reference(cfg: dict) -> ModuleType:
    return module(cfg, "reference")


def counts(cfg: dict) -> ModuleType:
    return module(cfg, "flops")
