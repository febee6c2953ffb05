"""The scene-text-recognition hub: a model by name, with a strhub checkpoint
loaded into it (port of `udifftext_tpu/models/str_hub.py`; strhub's
hubconf.py / models/utils.py factories with their published base
configurations).

The port's modules carry strhub's own parameter names, so a checkpoint
loads straight into the module: its `model.` prefix (the Lightning
system's attribute) is stripped where every key has it, and the load is
strict: every missing or unexpected key is reported in the error.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.ckpt import load_state_dict, strip_prefix

_BASE_CONFIGS = {
    "parseq": dict(max_label_length=25, img_size=(32, 128), patch_size=(4, 8),
                   embed_dim=384, enc_depth=12, enc_num_heads=6,
                   dec_depth=1, dec_num_heads=12),
    "parseq-tiny": dict(max_label_length=25, img_size=(32, 128), patch_size=(4, 8),
                        embed_dim=192, enc_depth=12, enc_num_heads=3,
                        dec_depth=1, dec_num_heads=6),
    "vitstr": dict(max_label_length=25, img_size=(32, 128), patch_size=(4, 8),
                   embed_dim=384, depth=12, num_heads=6, num_classes=95),
    "abinet": dict(max_length=26, num_classes=37, iter_size=3, d_model=512, v_num_layers=3),
    "trba": dict(num_class=96, max_label_length=25, img_size=(32, 128)),
    "crnn": dict(num_classes=95),
}


def build_model(name: str, **overrides) -> nn.Module:
    """The hub model `name` (parseq, parseq-tiny, vitstr, abinet, trba,
    crnn; "_" reads as "-") at its base configuration with `overrides`,
    PyTorch's initial weights, on the CPU."""
    key = name.replace("_", "-")
    if key not in _BASE_CONFIGS:
        raise KeyError(name)
    cfg = dict(_BASE_CONFIGS[key], **overrides)
    if key.startswith("parseq"):
        from .parseq import PARSeq as cls
    elif key == "vitstr":
        from .str_models import ViTSTRSystem as cls
    elif key == "abinet":
        from .abinet import ABINet as cls
    elif key == "trba":
        from .trba import TRBA as cls
    else:
        from .str_models import CRNN as cls
    return cls(**cfg)


def create_model(name: str, ckpt_path: Optional[str] = None, *,
                 device: torch.device | str = "cuda", **overrides) -> nn.Module:
    """The hub model `name` in eval mode on `device` (the GPU unless the
    caller asks for "cpu"), with the strhub checkpoint `ckpt_path` loaded
    when given: strictly, RuntimeError naming every missing and unexpected
    key. `overrides` change the base configuration."""
    model = build_model(name, **overrides)
    if ckpt_path:
        sd = load_state_dict(ckpt_path)
        if sd and all(k.startswith("model.") for k in sd):
            sd = strip_prefix(sd, "model.")
        res = model.load_state_dict(sd, strict=False)
        if res.missing_keys or res.unexpected_keys:
            raise RuntimeError(f"{ckpt_path}: {len(res.missing_keys)} missing keys "
                               f"{res.missing_keys}, {len(res.unexpected_keys)} unexpected "
                               f"keys {res.unexpected_keys}")
    return model.to(device).eval()
