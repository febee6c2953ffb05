"""JAX parameter pytrees → the port's state dicts.

The inverse of the reference-checkpoint converters of the JAX build
(`udifftext_tpu/utils/ckpt_torch.py` convert_unet / convert_vae /
convert_label_encoder / convert_vit / convert_parseq / convert_vitstr /
convert_fid_inception / convert_lpips_alex, and the pretraining heads of
`LabelEncoderPretrain`): flax module paths map
back to the reference torch module paths the port's modules carry, HWIO conv
kernels to OIHW, (in, out) dense kernels to (out, in), norm scales to
weights, a packed (d, 3d) `in_proj_kernel` to `in_proj_weight`; other
leaves (`pos_embed`, `pos_queries`, `in_proj_bias`) keep their names. Inputs
are nested dicts of numpy arrays (a flax params tree, with or without its
"params" level).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]
_WRAPPERS = ("Conv_0", "Dense_0", "GroupNorm_0", "LayerNorm_0")
_RES = {"in_norm": "in_layers.0", "in_conv": "in_layers.2", "emb_proj": "emb_layers.1",
        "out_norm": "out_layers.0", "out_conv": "out_layers.3", "skip": "skip_connection"}


def _flatten(tree, prefix: Path = ()) -> Iterator[Tuple[Path, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _tensor(leaf: str, v: np.ndarray) -> Tuple[str, torch.Tensor]:
    """(torch leaf name, value) of a flax leaf."""
    if leaf == "in_proj_kernel":
        return "in_proj_weight", torch.from_numpy(np.ascontiguousarray(v.T, dtype=np.float32))
    if leaf == "kernel":
        if v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)  # HWIO → OIHW
        elif v.ndim == 2:
            v = v.T
        return "weight", torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    name = {"scale": "weight", "embedding": "weight"}.get(leaf, leaf)
    return name, torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))


def _convert(params, module_path: Callable[[List[str]], List[str]]) -> Dict[str, torch.Tensor]:
    tree = params.get("params", params)
    sd = {}
    for path, v in _flatten(tree):
        mods = list(path[:-1])
        if mods and mods[-1] in _WRAPPERS:
            mods.pop()
        leaf, t = _tensor(path[-1], v)
        sd[".".join(module_path(mods) + [leaf])] = t
    return sd


def _unet_path(mods: List[str]) -> List[str]:
    head, rest = mods[0], mods[1:]
    if head in ("time_embed_0", "time_embed_2"):
        return ["time_embed", head[-1]]
    if head == "out_norm":
        return ["out", "0"]
    if head == "out_conv":
        return ["out", "2"]
    m = re.fullmatch(r"(input_blocks|output_blocks)_(\d+)_(\d+)", head)
    if m:
        base = [m.group(1), m.group(2), m.group(3)]
    else:
        m = re.fullmatch(r"middle_block_(\d+)", head)
        if m is None:
            raise KeyError(f"unet_from_jax: unknown module {head!r}")
        base = ["middle_block", m.group(1)]
    if not rest:
        return base
    if rest[0] in _RES and len(rest) == 1:
        return base + [_RES[rest[0]]]
    if rest[0].startswith("blocks_"):
        inner = rest[1:]
        if inner[0] == "ff":
            inner = ["ff", "net", "0", "proj"] if inner[1] == "proj" else ["ff", "net", "2"]
        elif len(inner) == 2 and inner[1] == "to_out":
            inner = [inner[0], "to_out", "0"]
        return base + ["transformer_blocks", rest[0][len("blocks_"):]] + inner
    return base + rest  # op, conv, norm, proj_in, proj_out


def _vae_path(mods: List[str]) -> List[str]:
    out = []
    for name in mods:
        m = re.fullmatch(r"(down|up)_(\d+)_(block|attn)_(\d+)", name)
        if m:
            out += [m.group(1), m.group(2), m.group(3), m.group(4)]
            continue
        m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", name)
        if m:
            out += [m.group(1), m.group(2), m.group(3)]
            continue
        m = re.fullmatch(r"mid_(block_1|attn_1|block_2)", name)
        out += ["mid", m.group(1)] if m else [name]
    return out


def _label_encoder_path(mods: List[str]) -> List[str]:
    m = re.fullmatch(r"layers_(\d+)", mods[0])
    if m is None:
        return mods  # label_embedding
    return ["encoder", "layers", m.group(1)] + mods[1:]


def _vit_path(mods: List[str]) -> List[str]:
    m = re.fullmatch(r"blocks_(\d+)", mods[0]) if mods else None
    return ["blocks", m.group(1)] + mods[1:] if m else mods


def _parseq_path(mods: List[str]) -> List[str]:
    if not mods:
        return mods  # pos_queries
    head, rest = mods[0], mods[1:]
    if head == "encoder":
        return ["encoder"] + _vit_path(rest)
    m = re.fullmatch(r"decoder_layers_(\d+)", head)
    if m:
        return ["decoder", "layers", m.group(1)] + rest
    return {"decoder_norm": ["decoder", "norm"], "text_embed": ["text_embed", "embedding"]}.get(
        head, mods)


def vit_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX ViTEncoder params → `models.vit.ViTEncoder` state dict (timm keys)."""
    return _convert(params, _vit_path)


def parseq_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX PARSeq params → `models.parseq.PARSeq` state dict (strhub keys)."""
    return _convert(params, _parseq_path)


def unet_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX UNetModel params → `udifftext_tpu_torch.models.unet.UNetModel` state dict."""
    return _convert(params, _unet_path)


def vae_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX AutoencoderKL params → `models.vae.AutoencoderKL` state dict."""
    return _convert(params, _vae_path)


def label_encoder_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX LabelEncoder params → `models.label_encoder.LabelEncoder` state
    dict (the packed in-projection becomes `in_proj_weight`/`in_proj_bias`)."""
    sd = _convert(params, _label_encoder_path)
    return {re.sub(r"self_attn\.in_proj\.(weight|bias)$", r"self_attn.in_proj_\1", k): v
            for k, v in sd.items()}


def label_encoder_pretrain_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX LabelEncoderPretrain params → `models.label_encoder.
    LabelEncoderPretrain` state dict: the LabelEncoder under `encoder.`, the
    heads' dense layers by name, the (L, 1) token-mix kernels as the
    reference Conv1d's (1, L, 1) weights."""
    tree = params.get("params", params)
    sd = {f"encoder.{k}": v for k, v in label_encoder_from_jax(tree["encoder"]).items()}
    sd.update(_convert({k: v for k, v in tree.items() if k != "encoder" and isinstance(v, dict)},
                       lambda mods: mods))
    for name, v in tree.items():
        v = np.asarray(v, np.float32) if not isinstance(v, dict) else None
        if v is None:
            continue
        if name.endswith("_mix_kernel"):  # (L, 1) → the Conv1d's (1, L, 1)
            sd[f"{name[:-len('_kernel')]}.weight"] = torch.from_numpy(v.reshape(1, -1, 1).copy())
        elif name.endswith("_mix_bias"):
            sd[f"{name[:-len('_bias')]}.bias"] = torch.from_numpy(v.copy())
        else:  # logit_scale
            sd[name] = torch.from_numpy(v.copy())
    return sd


def vitstr_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX ViTSTREncoder params → `models.vit.ViTSTREncoder` state dict
    (timm keys: the flax `vit` level goes, `cls_token` keeps its name)."""
    return vit_from_jax(params.get("params", params)["vit"])


_BN_LEAVES = {"bn_weight": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
              "bn_var": "running_var"}


def inception_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX FIDInceptionV3 params → `models.inception.FIDInceptionV3` state
    dict (pytorch_fid's keys; `num_batches_tracked` 0)."""
    sd = {}
    for path, v in _flatten(params.get("params", params)):
        if path[-1] in _BN_LEAVES:
            base = ".".join(path[:-1])
            sd[f"{base}.bn.{_BN_LEAVES[path[-1]]}"] = torch.from_numpy(v.astype(np.float32))
            sd[f"{base}.bn.num_batches_tracked"] = torch.tensor(0)
        else:  # {block}/{branch}/conv/kernel
            leaf, t = _tensor(path[-1], v)
            sd[".".join(path[:-1] + (leaf,))] = t
    return sd


def lpips_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX LPIPSAlex params → `models.lpips.LPIPSAlex` state dict (lpips'
    keys: net.conv{I} → net.slice{K}.{I}, lin{i} (C,) → lin{i}.model.1.weight
    (1, C, 1, 1)); the scaling layer's constants are the module's own."""
    from ..models.lpips import ScalingLayer, slice_key

    tree = params.get("params", params)
    sd = {f"scaling_layer.{k}": v for k, v in ScalingLayer().state_dict().items()}
    for name, sub in tree["net"].items():
        for leaf, v in sub.items():
            key, t = _tensor(leaf, np.asarray(v))
            sd[f"{slice_key(int(name[len('conv'):]))}.{key}"] = t
    for name, v in tree.items():
        if name.startswith("lin"):
            sd[f"{name}.model.1.weight"] = torch.from_numpy(
                np.asarray(v, np.float32).reshape(1, -1, 1, 1).copy())
    return sd


def engine_from_jax(params: Dict[str, dict]) -> Dict[str, torch.Tensor]:
    """{"unet", "vae", "label_encoder"[, "parseq"]} JAX params → a
    `DiffusionEngine` state dict."""
    sd = {}
    for name, fn in (("unet", unet_from_jax), ("vae", vae_from_jax),
                     ("label_encoder", label_encoder_from_jax), ("parseq", parseq_from_jax)):
        if name in params:
            sd.update({f"{name}.{k}": v for k, v in fn(params[name]).items()})
    return sd
