"""Checkpoint loading and the entry points' model set-up (port of
`udifftext_tpu/loading.py` and of root util.py's `init_model` /
`init_sampling`).

The boot sequence is the reference's (util.py:7-22, diffusion.py:87-105):
build the graph, load the per-component checkpoints the graph names (VAE,
LabelEncoder and, when the graph has the OCR loss term, PARSeq), then
strict=False load the run's checkpoint: a full UDiffText `.ckpt` (UNet, VAE
and LabelEncoder in one state dict) or the SD2-inpainting bootstrap (the
UNet trunk only: the t_attn branches it lacks keep their zero-output init).
Every load casts into each parameter's dtype on the engine's device: the
bf16 UNet, the fp32 master weights of a `train=True` engine, the VAE's
dtype, fp32 PARSeq. A parseq checkpoint is read only when the engine holds
PARSeq, as the JAX package reads it only when the graph has an OCR
predictor.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from .builders import EngineBundle, SamplerSettings, build_engine, randomize_parameters
from .config import load_config
from .engine import DiffusionEngine
from .utils.ckpt import load_state_dict, merge_state_dict, strip_prefix

Report = Tuple[List[str], List[str], List[str]]  # missing, unexpected, mismatched

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
LABEL_PREFIX = "conditioner.embedders.0."
EMBEDDERS_PREFIX = "conditioner.embedders."


def load_from_torch_ckpt(engine: DiffusionEngine, ckpt_path: str,
                         verbose: bool = True) -> Dict[str, Report]:
    """strict=False load of a UDiffText/SD2 checkpoint into `engine`, in
    place, by the key prefixes of the JAX package's loader: the UNet under
    "model.diffusion_model.", the VAE under "first_stage_model." (or a bare
    VAE file: "encoder.conv_in*" / "quant_conv.weight"), the LabelEncoder
    under "conditioner.embedders.0.label_embedding*" (or bare
    "label_embedding*"), and a GeneralConditioner's embedders that have
    parameters (a ClassEmbedder's table, a remapping SpatialRescaler's conv)
    under "conditioner.embedders.<index>." as "embedders". Returns each
    loaded component's report."""
    sd = load_state_dict(ckpt_path)
    out: Dict[str, Report] = {}
    if any(k.startswith(UNET_PREFIX) for k in sd):
        out["unet"] = merge_state_dict(engine.unet, strip_prefix(sd, UNET_PREFIX), "unet",
                                       verbose)
    if any(k.startswith(VAE_PREFIX) for k in sd):
        out["vae"] = merge_state_dict(engine.vae, strip_prefix(sd, VAE_PREFIX), "vae", verbose)
    elif any(k.startswith("encoder.conv_in") or k == "quant_conv.weight" for k in sd):
        out["vae"] = merge_state_dict(engine.vae, sd, "vae", verbose)
    if any(k.startswith(LABEL_PREFIX + "label_embedding") for k in sd):
        out["label_encoder"] = merge_state_dict(engine.label_encoder,
                                                strip_prefix(sd, LABEL_PREFIX),
                                                "label_encoder", verbose)
    elif any(k.startswith("label_embedding") for k in sd):
        out["label_encoder"] = merge_state_dict(engine.label_encoder, sd, "label_encoder",
                                                verbose)
    gc = engine.general_conditioner
    if gc is not None:  # the embedders with parameters of their own
        own = {k.split(".")[1] for k in gc.state_dict()}
        emb = {k: v for k, v in strip_prefix(sd, EMBEDDERS_PREFIX).items()
               if k.split(".")[0] in own}
        if emb:
            out["embedders"] = merge_state_dict(
                gc, {f"embedders.{k}": v for k, v in emb.items()}, "embedders", verbose)
    return out


def load_component_ckpts(bundle: EngineBundle, verbose: bool = True) -> Dict[str, Report]:
    """Load the VAE, LabelEncoder and PARSeq checkpoint files the model graph
    names (`bundle.ckpt_paths`), those that exist, into the engine in place
    (PARSeq's only when the engine holds it). strhub's PARSeq keys need no
    converter: the port's module carries them."""
    out: Dict[str, Report] = {}
    for name in ("vae", "parseq", "label_encoder"):
        path = bundle.ckpt_paths.get(name)
        if path and os.path.exists(path) and getattr(bundle.engine, name) is not None:
            out[name] = merge_state_dict(getattr(bundle.engine, name), load_state_dict(path),
                                         name, verbose=False)
            if verbose:
                print(f"[{name}] loaded {path}")
    return out


def init_model(cfgs: Mapping[str, Any], device: torch.device | str = "cuda", seed: int = 0,
               model_cfg: Optional[Mapping[str, Any]] = None,
               train: bool = False) -> EngineBundle:
    """The engine of a run config (demo.yaml, train.yaml, ...) with its
    checkpoints loaded. The graph is `model_cfg` (a `model.params` dict) or,
    without it, the file `cfgs.model_cfg_path`; the UNet is bf16 unless
    `cfgs.bf16` is false; `train` goes to `build_engine` (fp32 trainable
    t_attn/t_norm, and the trainable embedders). The engine's initial
    weights, the conditioner embedders' included, are drawn from `seed`, so
    every parameter that no checkpoint sets (the t_attn branches of the
    SD2-inpainting bootstrap) is the same from run to run, as the JAX
    package's `PRNGKey(seed)` init is. When `cfgs.load_ckpt_path` names no
    existing file, the weights are `randomize_parameters(seed)` (the JAX
    package falls back to a fresh init), and the component checkpoints are
    loaded over them."""
    if model_cfg is None:
        model_cfg = load_config(cfgs["model_cfg_path"])["model"]["params"]
    dtype = torch.bfloat16 if cfgs.get("bf16", True) else torch.float32
    dev = torch.device(device)
    cuda = [dev.index if dev.index is not None else torch.cuda.current_device()] \
        if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda):  # the caller's generators are left as they were
        torch.random.default_generator.manual_seed(seed)
        if cuda:
            torch.cuda.default_generators[cuda[0]].manual_seed(seed)
        bundle = build_engine(dict(model_cfg), dtype, dev, train=train)
    ckpt = cfgs.get("load_ckpt_path")
    found = bool(ckpt) and os.path.exists(str(ckpt))
    if not found:
        print(f"[init_model] checkpoint {ckpt} not found: seeded random weights (seed {seed})")
        randomize_parameters(bundle.engine, seed)
    load_component_ckpts(bundle)
    if found:
        load_from_torch_ckpt(bundle.engine, str(ckpt))
    return bundle


def init_sampling(cfgs: Mapping[str, Any]) -> SamplerSettings:
    """Sampler settings of a run config (util.py:24-47): `steps` (default 50)
    and the first entry of `scale` (default 5.0)."""
    scale = cfgs.get("scale", [5.0, 0.0])
    scale = scale[0] if isinstance(scale, (list, tuple)) else scale
    return SamplerSettings(num_steps=int(cfgs.get("steps", 50)), cfg_scale=float(scale))
