"""Model graph → engine (port of `udifftext_tpu/builders.py`).

`build_engine` takes the `model.params` node of a textdesign_sd_2.yaml graph
(as a plain dict; `TEXTDESIGN_SD_2` and `TEXTDESIGN_SD_2_TRAIN` hold the
shipped ones, so no YAML parser is needed) and returns the engine with its
sampler settings. The shipped three-embedder graph conditions through the
fused `Conditioner`; any other embedder list through a `GeneralConditioner`
(`build_general_conditioner`). What the JAX build lacks is refused: a
target it does not know raises ValueError, and the parts it does not
implement (a transformer with conv proj_in/proj_out, a sigma sampler other
than DiscreteSampling, ...) raise NotImplementedError instead of being
dropped.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .conditioning import (EmbedderSpec, GeneralConditioner, LabelEncoderEmbedder,
                           LatentEncoder, SpatialRescaler)
from .diffusion.denoiser import DiscreteDenoiser
from .diffusion.loss import FullLossConfig
from .diffusion.schedules import (SCALINGS, WEIGHTINGS, Discretization, DiscreteSampling,
                                  EDMDiscretization, LegacyDDPMDiscretization)
from .engine import DiffusionEngine
from .models.label_encoder import LabelEncoder
from .models.layers import GroupNorm32, cast_weights, set_norm_impl
from .models.parseq import PARSeq
from .models.unet import UNetModel
from .models.vae import AutoencoderKL, DDConfig
from .parallel.train import trainable_mask

_P = "sgm.modules.diffusionmodules."
_DDPM = {"target": _P + "discretizer.LegacyDDPMDiscretization"}
_DDCONFIG = {
    "attn_type": "vanilla-xformers", "double_z": True, "z_channels": 4, "resolution": 256,
    "in_channels": 3, "out_ch": 3, "ch": 128, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2,
    "attn_resolutions": [], "dropout": 0.0,
}

# `model.params` of configs/test/textdesign_sd_2.yaml, as a dict
# (tests/test_torch_engine.py holds the two equal).
TEXTDESIGN_SD_2: Dict[str, Any] = {
    "opt_keys": ["t_attn", "t_norm"],
    "input_key": "image",
    "scale_factor": 0.18215,
    "disable_first_stage_autocast": True,
    "denoiser_config": {
        "target": _P + "denoiser.DiscreteDenoiser",
        "params": {
            "num_idx": 1000,
            "weighting_config": {"target": _P + "denoiser_weighting.EpsWeighting"},
            "scaling_config": {"target": _P + "denoiser_scaling.EpsScaling"},
            "discretization_config": _DDPM,
        },
    },
    "network_config": {
        "target": _P + "openaimodel.UnifiedUNetModel",
        "params": {
            "in_channels": 9, "out_channels": 4, "ctrl_channels": 0, "model_channels": 320,
            "attention_resolutions": [4, 2, 1], "save_attn_type": ["t_attn"],
            "save_attn_layers": ["output_blocks.6.1"], "num_res_blocks": 2,
            "channel_mult": [1, 2, 4, 4], "num_head_channels": 64,
            "use_linear_in_transformer": True, "transformer_depth": 1, "t_context_dim": 2048,
        },
    },
    "conditioner_config": {
        "target": "sgm.modules.GeneralConditioner",
        "params": {
            "emb_models": [
                {
                    "is_trainable": False, "emb_key": "t_crossattn", "ucg_rate": 0.1,
                    "input_key": "label", "target": "sgm.modules.encoders.modules.LabelEncoder",
                    "params": {
                        "max_len": 12, "emb_dim": 2048, "n_heads": 8, "n_trans_layers": 12,
                        "ckpt_path": "./checkpoints/encoders/LabelEncoder/epoch=19-step=7820.ckpt",
                    },
                },
                {
                    "is_trainable": False, "input_key": "mask",
                    "target": "sgm.modules.encoders.modules.SpatialRescaler",
                    "params": {"in_channels": 1, "multiplier": 0.125},
                },
                {
                    "is_trainable": False, "input_key": "masked",
                    "target": "sgm.modules.encoders.modules.LatentEncoder",
                    "params": {
                        "scale_factor": 0.18215,
                        "config": {
                            "target": "sgm.models.autoencoder.AutoencoderKLInferenceWrapper",
                            "params": {
                                "ckpt_path": "./checkpoints/AEs/AE_inpainting_2.safetensors",
                                "embed_dim": 4, "ddconfig": dict(_DDCONFIG),
                            },
                        },
                    },
                },
            ]
        },
    },
    "first_stage_config": {
        "target": "sgm.models.autoencoder.AutoencoderKLInferenceWrapper",
        "params": {
            "ckpt_path": "./checkpoints/AEs/AE_inpainting_2.safetensors",
            "embed_dim": 4, "ddconfig": dict(_DDCONFIG),
        },
    },
    "loss_fn_config": {
        "target": _P + "loss.FullLoss",
        "params": {
            "seq_len": 12, "kernel_size": 3, "gaussian_sigma": 1.0, "min_attn_size": 16,
            "lambda_local_loss": 0.01, "lambda_ocr_loss": 0.001, "ocr_enabled": False,
            "predictor_config": {
                "target": "sgm.modules.predictors.model.ParseqPredictor",
                "params": {"ckpt_path": "./checkpoints/predictors/parseq-bb5792a6.pt"},
            },
            "sigma_sampler_config": {
                "target": _P + "sigma_sampling.DiscreteSampling",
                "params": {"num_idx": 1000, "discretization_config": _DDPM},
            },
        },
    },
    "sampler_config": {
        "target": _P + "sampling.EulerEDMSampler",
        "params": {
            "num_steps": 50,
            "discretization_config": _DDPM,
            "guider_config": {"target": _P + "guiders.VanillaCFG", "params": {"scale": 5.0}},
        },
    },
}


# `model.params` of configs/train/textdesign_sd_2.yaml, the fine-tuning graph
# (tests/test_torch_train.py holds the two equal). The shipped train and
# test graphs are the same file content.
TEXTDESIGN_SD_2_TRAIN: Dict[str, Any] = copy.deepcopy(TEXTDESIGN_SD_2)


@dataclasses.dataclass(frozen=True)
class SamplerSettings:
    num_steps: int = 50
    cfg_scale: float = 5.0


@dataclasses.dataclass(frozen=True)
class EngineBundle:
    engine: DiffusionEngine
    sampler: SamplerSettings
    # per-component checkpoint files the graph names ("vae", "label_encoder",
    # "parseq" with the OCR loss term; "model" is None here), read by
    # loading.load_component_ckpts
    ckpt_paths: Dict[str, Optional[str]] = dataclasses.field(default_factory=dict)
    # the UNet attention layers whose maps the eval CLI's `detailed` output
    # averages (network_config's save_attn_layers; empty: all of them)
    save_attn_layers: Tuple[str, ...] = ()


def _params(node: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    return ((node or {}).get("params") or {}) if isinstance(node, dict) else {}


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise NotImplementedError(f"model graph: {what} is not ported yet")


def build_discretization(node: Optional[Dict[str, Any]]) -> Discretization:
    """A discretizer node → LegacyDDPMDiscretization (also when the node or
    its target is absent) or EDMDiscretization, with the node's params."""
    target = (node or {}).get("target", "")
    _require(target == "" or target.endswith(("LegacyDDPMDiscretization", "EDMDiscretization")),
             f"discretization {target!r}")
    cls = EDMDiscretization if target.endswith("EDMDiscretization") else LegacyDDPMDiscretization
    return cls(**_params(node))


def _tag(node: Optional[Dict[str, Any]], kind: str, known) -> str:
    """The tag ("eps", "v", "edm", "unit") of a `<Name>Scaling` /
    `<Name>Weighting` node; "eps" when the node is absent."""
    target = (node or {}).get("target", f"Eps{kind}")
    tag = next((name.lower() for name in ("Eps", "V", "EDM", "Unit")
                if target.endswith(f"{name}{kind}")), None)
    _require(tag in known, f"{kind.lower()} {target!r}")
    return tag


def build_discrete_sampling(num_idx: int = 1000, discretization_config=None,
                            **_) -> DiscreteSampling:
    """A DiscreteSampling sigma sampler (`sigma_sampler_config` params)."""
    return DiscreteSampling(num_idx=num_idx,
                            discretization=build_discretization(discretization_config))


def build_discrete_denoiser(num_idx: int = 1000, weighting_config=None, scaling_config=None,
                            discretization_config=None, **_) -> DiscreteDenoiser:
    """A DiscreteDenoiser (`denoiser_config` params): scaling and weighting
    by their targets' tags, "eps" where a node is absent."""
    return DiscreteDenoiser(scaling=_tag(scaling_config, "Scaling", SCALINGS),
                            weighting=_tag(weighting_config, "Weighting", WEIGHTINGS),
                            num_idx=num_idx,
                            discretization=build_discretization(discretization_config))


def _shipped_embedders(emb_models) -> Optional[Dict[str, Any]]:
    """The settings of the shipped three-embedder graph (LabelEncoder →
    t_crossattn, one bilinear SpatialRescaler stage of the mask, the
    LatentEncoder of the masked image, none trainable, no dropout on the
    last two), which the fused Conditioner runs; None for any other list."""
    targets = [e.get("target", "").rsplit(".", 1)[-1] for e in emb_models]
    if targets != ["LabelEncoder", "SpatialRescaler", "LatentEncoder"]:
        return None
    le, sr, lat = emb_models
    sr_p = _params(sr)
    if not (le.get("emb_key") in (None, "t_crossattn")
            and le.get("input_key", "label") in ("label", "label_ids")
            and not sr.get("emb_key") and sr.get("input_key", "mask") == "mask"
            and int(sr_p.get("n_stages", 1)) == 1 and not sr_p.get("out_channels")
            and sr_p.get("method", "bilinear") == "bilinear"
            and not lat.get("emb_key") and lat.get("input_key", "masked") == "masked"
            and not any(e.get("is_trainable") for e in emb_models)
            and not any(float(e.get("ucg_rate", 0.0)) for e in (sr, lat))):
        return None
    return {"label": le, "mask_multiplier": float(sr_p.get("multiplier", 0.5))}


def build_general_conditioner(emb_models, label_encoder: LabelEncoder, vae: AutoencoderKL,
                              scale_factor: float = 0.18215) -> GeneralConditioner:
    """An embedder list (reference GeneralConditioner, modules.py:105-217) →
    GeneralConditioner: each entry becomes an embedder module with its
    EmbedderSpec (input_key, ucg_rate, emb_key, is_trainable). Targets:
    LabelEncoder (the engine's; it reads the tokenized `label_ids`),
    SpatialRescaler (with `out_channels`, the remap conv), LatentEncoder (the
    engine's VAE), ClassEmbedder, ConcatTimestepEmbedderND."""
    from .embedders import ClassEmbedder, ConcatTimestepEmbedderND, SpatialRescalerRemap

    specs, mods = [], []
    for n, emb in enumerate(emb_models):
        target = emb.get("target", "").rsplit(".", 1)[-1]
        p = emb.get("params", {}) or {}
        input_key = emb.get("input_key", "")
        emb_key = emb.get("emb_key")
        if target == "LabelEncoder":
            key = "label_ids" if input_key in ("label", "label_ids", "") else input_key
            mod, emb_key = LabelEncoderEmbedder(label_encoder), emb_key or "t_crossattn"
        elif target == "SpatialRescaler":
            key = input_key or "mask"
            method, n_stages = p.get("method", "bilinear"), int(p.get("n_stages", 1))
            mult = float(p.get("multiplier", 0.5))
            if p.get("out_channels"):
                mod = SpatialRescalerRemap(mult, int(p["out_channels"]), method, n_stages,
                                           in_channels=int(p.get("in_channels", 1)))
            else:
                mod, emb_key = SpatialRescaler(mult, method, n_stages), emb_key or "concat"
        elif target == "LatentEncoder":
            key = input_key or "masked"
            mod, emb_key = LatentEncoder(vae, scale_factor), emb_key or "concat"
        elif target == "ClassEmbedder":
            key = input_key or "cls"
            # the conditioner applies the dropout itself, as to every embedder
            mod = ClassEmbedder(int(p.get("embed_dim", 512)), int(p.get("n_classes", 1000)),
                                bool(p.get("add_sequence_dim", False)), ucg_rate=0.0)
        elif target == "ConcatTimestepEmbedderND":
            key = input_key
            mod = ConcatTimestepEmbedderND(int(p.get("outdim", 256)))
        else:
            raise ValueError(
                f"unsupported embedder target {emb.get('target')!r} "
                "(supported: LabelEncoder, SpatialRescaler, LatentEncoder, "
                "ClassEmbedder, ConcatTimestepEmbedderND)"
            )
        specs.append(EmbedderSpec(f"{n}_{target}", key, float(emb.get("ucg_rate", 0.0)),
                                  emb_key, bool(emb.get("is_trainable", False))))
        mods.append(mod)
    return GeneralConditioner(specs, mods)


def build_engine(model_cfg: Dict[str, Any], unet_dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda", train: bool = False,
                 remat: bool = False, attn_impl: str = "auto") -> EngineBundle:
    """`model.params` of a textdesign_sd_2.yaml graph → engine on `device`
    (the GPU unless the caller asks for "cpu"; without a GPU the default fails).

    The UNet computes in `unet_dtype` (weights stored in it), the VAE in fp32
    (bf16 with `first_stage_bf16: true`), the LabelEncoder in fp32. Every
    parameter is frozen (requires_grad False). With the OCR loss term
    (`loss_fn_config.params.ocr_enabled`), the engine also holds PARSeq-base,
    frozen, in fp32. With `train`, the UNet
    parameters whose name matches one of the graph's `opt_keys` (t_attn,
    t_norm) are trainable instead, and kept in fp32 as master weights (their
    layers cast them to the compute dtype at use). `remat` turns on the
    UNet's gradient checkpointing. `attn_impl` ("auto" | "plain" | "flash")
    goes to the UNet and the VAE, and to their GroupNorms (`set_norm_impl`):
    "plain" keeps every hand-written kernel out of the run, for an A/B
    against "auto". Weights are PyTorch's default
    initialization; load a state dict or call `randomize_parameters` next."""
    with torch.device(device):  # parameters are created (and initialized) in place
        return _build_engine(model_cfg, unet_dtype, device, train, remat, attn_impl)


def _build_engine(model_cfg, unet_dtype, device, train, remat, attn_impl) -> EngineBundle:
    p = model_cfg
    opt_keys = tuple(p.get("opt_keys", ("t_attn", "t_norm")))
    net = _params(p.get("network_config"))
    # the JAX build's SpatialTransformer is Dense-only
    _require(net.get("use_linear_in_transformer", True), "conv proj_in/proj_out")
    unet = UNetModel(
        in_channels=net.get("in_channels", 9),
        ctrl_channels=net.get("ctrl_channels", 0),
        model_channels=net.get("model_channels", 320),
        out_channels=net.get("out_channels", 4),
        num_res_blocks=net.get("num_res_blocks", 2),
        attention_resolutions=tuple(net.get("attention_resolutions", (4, 2, 1))),
        channel_mult=tuple(net.get("channel_mult", (1, 2, 4, 4))),
        num_head_channels=net.get("num_head_channels", 64),
        num_heads=net.get("num_heads", -1),
        transformer_depth=net.get("transformer_depth", 1),
        t_context_dim=net.get("t_context_dim"),
        v_context_dim=net.get("v_context_dim"),
        adm_in_channels=net.get("adm_in_channels"),
        use_label=net.get("use_label"),
        use_scale_shift_norm=net.get("use_scale_shift_norm", False),
        dtype=unet_dtype,
        remat=remat,
        attn_impl=attn_impl,
    )

    vae_p = _params(p.get("first_stage_config"))
    dd = vae_p.get("ddconfig", {})
    vae_dtype = torch.bfloat16 if p.get("first_stage_bf16", False) else torch.float32
    vae = AutoencoderKL(
        DDConfig(
            ch=dd.get("ch", 128), out_ch=dd.get("out_ch", 3),
            ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
            num_res_blocks=dd.get("num_res_blocks", 2),
            attn_resolutions=tuple(dd.get("attn_resolutions", ()) or ()),
            in_channels=dd.get("in_channels", 3), resolution=dd.get("resolution", 256),
            z_channels=dd.get("z_channels", 4), double_z=dd.get("double_z", True),
        ),
        embed_dim=vae_p.get("embed_dim", 4), dtype=vae_dtype, attn_impl=attn_impl,
    )

    emb_models = _params(p.get("conditioner_config")).get("emb_models", []) or []
    emb = (_shipped_embedders(emb_models) if emb_models
           else {"label": {}, "mask_multiplier": 0.5})  # the JAX build's defaults
    # a general graph's LabelEncoder settings (the JAX builder reads the
    # first LabelEncoder entry; the dropout belongs to its EmbedderSpec)
    label_node = emb["label"] if emb else next(
        (e for e in emb_models if "LabelEncoder" in e.get("target", "")), {})
    le_p = _params(label_node)
    label_encoder = LabelEncoder(
        max_len=le_p.get("max_len", 12), emb_dim=le_p.get("emb_dim", 2048),
        n_heads=le_p.get("n_heads", 8), n_trans_layers=le_p.get("n_trans_layers", 12),
    )

    denoiser = build_discrete_denoiser(**_params(p.get("denoiser_config")))
    loss_p = _params(p.get("loss_fn_config"))
    ocr_enabled = bool(loss_p.get("ocr_enabled", False))
    pred_node = loss_p.get("predictor_config") or {}
    _require(not ocr_enabled or "ParseqPredictor" in pred_node.get("target", "ParseqPredictor"),
             "an OCR predictor other than ParseqPredictor")
    sig_p = _params(loss_p.get("sigma_sampler_config"))
    _require("DiscreteSampling" in (loss_p.get("sigma_sampler_config") or {}).get(
        "target", "DiscreteSampling"), "a sigma sampler other than DiscreteSampling")
    samp_p = _params(p.get("sampler_config"))
    general = None if emb else build_general_conditioner(
        emb_models, label_encoder, vae, p.get("scale_factor", 0.18215))

    engine = DiffusionEngine(
        unet=cast_weights(unet, unet_dtype, keep_fp32=opt_keys if train else ()),
        vae=cast_weights(vae, vae_dtype),
        label_encoder=label_encoder,
        denoiser=denoiser,
        discretization=build_discretization(samp_p.get("discretization_config")),
        sigma_sampler=build_discrete_sampling(**sig_p),
        loss_cfg=FullLossConfig(
            kernel_size=loss_p.get("kernel_size", 3),
            gaussian_sigma=loss_p.get("gaussian_sigma", 1.0),
            min_attn_size=loss_p.get("min_attn_size", 16),
            lambda_local_loss=loss_p.get("lambda_local_loss", 0.01),
            lambda_ocr_loss=loss_p.get("lambda_ocr_loss", 0.001),
            ocr_enabled=ocr_enabled,
        ),
        scale_factor=p.get("scale_factor", 0.18215),
        ucg_rate_label=float(label_node.get("ucg_rate", 0.0)) if emb else 0.0,
        mask_multiplier=emb["mask_multiplier"] if emb else 0.5,
        latent_factor=2 ** (len(vae.cfg.ch_mult) - 1),
        parseq=PARSeq() if ocr_enabled else None,
        general_conditioner=general,
    )
    # convs read NHWC activations through an NCHW view, which is
    # channels_last in memory: keep their weights channels_last too
    engine.to(device=device, memory_format=torch.channels_last)
    set_norm_impl(engine, attn_impl)
    embedders = general.trainable_embedders if general is not None else ()
    trainable = trainable_mask(engine.named_parameters(), opt_keys, embedders) if train else {}
    for name, prm in engine.named_parameters():
        prm.requires_grad_(trainable.get(name, False))
    sampler = SamplerSettings(
        num_steps=samp_p.get("num_steps", 50),
        cfg_scale=_params(samp_p.get("guider_config")).get("scale", 5.0),
    )
    ckpt_paths = {"model": None, "vae": vae_p.get("ckpt_path"),
                  "label_encoder": le_p.get("ckpt_path"),
                  "parseq": _params(pred_node).get("ckpt_path") if ocr_enabled else None}
    return EngineBundle(engine, sampler, ckpt_paths,
                        tuple(net.get("save_attn_layers", ()) or ()))


@torch.no_grad()
def randomize_parameters(module: nn.Module, seed: int, keep: Tuple[str, ...] = ()) -> nn.Module:
    """Fill every parameter with seeded random values (none left zero, so
    zero-initialized output projections do not hide the network): weights
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1²) and shifts N(0, 0.1²),
    biases N(0, 0.02²), embeddings N(0, 1); BatchNorm's running means
    N(0, 0.1²) and variances 1 + |N(0, 0.5²)|. A parameter whose qualified
    name ends with an entry of `keep` stays as the module set it (TRBA's
    `localization_fc2.bias`, the TPS fiducial points). Values are drawn on
    each parameter's device."""
    gens: Dict[torch.device, torch.Generator] = {}

    def randn(t: torch.Tensor) -> torch.Tensor:
        g = gens.get(t.device)
        if g is None:
            g = gens[t.device] = torch.Generator(t.device).manual_seed(seed)
        return torch.randn(t.shape, generator=g, device=t.device, dtype=torch.float32)

    norms = (GroupNorm32, nn.LayerNorm, nn.modules.batchnorm._BatchNorm)
    for mname, m in module.named_modules():
        for name, prm in m.named_parameters(recurse=False):
            if keep and f"{mname}.{name}".endswith(keep):
                continue
            r = randn(prm)
            if isinstance(m, nn.Embedding):
                v = r
            elif isinstance(m, norms):
                v = 1.0 + 0.1 * r if name == "weight" else 0.1 * r
            elif name.endswith("bias") or name.startswith("bias_"):  # nn.LSTM's bias_ih_l0
                v = 0.02 * r
            else:  # Linear/Conv/LSTM weights and the packed in-projection
                fan_in = math.prod(prm.shape[1:]) if prm.ndim > 1 else 1
                v = r / math.sqrt(fan_in)
            prm.copy_(v.to(prm.dtype))
        if isinstance(m, nn.modules.batchnorm._BatchNorm) and m.track_running_stats:
            m.running_mean.copy_(0.1 * randn(m.running_mean))
            m.running_var.copy_(1.0 + 0.5 * randn(m.running_var).abs())
    return module

