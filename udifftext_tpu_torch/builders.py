"""Model graph → engine (port of `udifftext_tpu/builders.py` for the shipped
graph).

`build_engine` takes the `model.params` node of a textdesign_sd_2.yaml graph
(as a plain dict; `TEXTDESIGN_SD_2` and `TEXTDESIGN_SD_2_TRAIN` hold the
shipped ones, so no YAML parser is needed) and returns the engine with its
sampler settings. Parts of the graph the port does not run yet raise
NotImplementedError instead of being dropped.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from .diffusion.denoiser import DiscreteDenoiser
from .diffusion.loss import FullLossConfig
from .diffusion.schedules import DiscreteSampling, LegacyDDPMDiscretization
from .engine import DiffusionEngine
from .models.label_encoder import LabelEncoder
from .models.layers import GroupNorm32, cast_weights
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
    # per-component checkpoint files the graph names ("vae", "label_encoder";
    # "model" and "parseq" are None here), read by loading.load_component_ckpts
    ckpt_paths: Dict[str, Optional[str]] = dataclasses.field(default_factory=dict)


def _params(node: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    return ((node or {}).get("params") or {}) if isinstance(node, dict) else {}


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise NotImplementedError(f"model graph: {what} is not ported yet")


def _check_embedders(emb_models) -> Dict[str, Any]:
    """The shipped three-embedder graph (LabelEncoder → t_crossattn,
    SpatialRescaler(mask), LatentEncoder(masked)); returns its settings."""
    targets = [e.get("target", "").rsplit(".", 1)[-1] for e in emb_models]
    _require(targets == ["LabelEncoder", "SpatialRescaler", "LatentEncoder"],
             f"embedder graph {targets}")
    le, sr, lat = emb_models
    _require(le.get("emb_key") in (None, "t_crossattn")
             and le.get("input_key", "label") in ("label", "label_ids"),
             "LabelEncoder routing other than label → t_crossattn")
    _require(not sr.get("emb_key") and sr.get("input_key", "mask") == "mask"
             and int(_params(sr).get("n_stages", 1)) == 1 and not _params(sr).get("out_channels"),
             "SpatialRescaler other than one bilinear stage of the mask")
    _require(not lat.get("emb_key") and lat.get("input_key", "masked") == "masked",
             "LatentEncoder other than the masked image")
    _require(not any(e.get("is_trainable") for e in emb_models), "trainable embedders")
    return {"label": le, "mask_multiplier": float(_params(sr).get("multiplier", 0.5))}


def build_engine(model_cfg: Dict[str, Any], unet_dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda", train: bool = False,
                 remat: bool = False, attn_impl: str = "auto") -> EngineBundle:
    """`model.params` of a textdesign_sd_2.yaml graph → engine on `device`
    (the GPU unless the caller asks for "cpu"; without a GPU the default fails).

    The UNet computes in `unet_dtype` (weights stored in it), the VAE in fp32
    (bf16 with `first_stage_bf16: true`), the LabelEncoder in fp32. Every
    parameter is frozen (requires_grad False). With `train`, the UNet
    parameters whose name matches one of the graph's `opt_keys` (t_attn,
    t_norm) are trainable instead, and kept in fp32 as master weights (their
    layers cast them to the compute dtype at use). `remat` turns on the
    UNet's gradient checkpointing. `attn_impl` ("auto" | "plain" | "flash")
    goes to the UNet and the VAE: "plain" keeps every hand-written kernel out
    of the run, for an A/B against "auto". Weights are PyTorch's default
    initialization; load a state dict or call `randomize_parameters` next."""
    with torch.device(device):  # parameters are created (and initialized) in place
        return _build_engine(model_cfg, unet_dtype, device, train, remat, attn_impl)


def _build_engine(model_cfg, unet_dtype, device, train, remat, attn_impl) -> EngineBundle:
    p = model_cfg
    opt_keys = tuple(p.get("opt_keys", ("t_attn", "t_norm")))
    net = _params(p.get("network_config"))
    _require(int(net.get("ctrl_channels", 0)) == 0, "the ctrl block")
    _require(net.get("use_label") is None and net.get("adm_in_channels") is None,
             "label/class embedding")
    _require(not net.get("use_scale_shift_norm", False), "scale-shift norm")
    _require(net.get("use_linear_in_transformer", True), "conv proj_in/proj_out")
    unet = UNetModel(
        in_channels=net.get("in_channels", 9),
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

    emb = _check_embedders(_params(p.get("conditioner_config")).get("emb_models", []) or [])
    le_p = _params(emb["label"])
    label_encoder = LabelEncoder(
        max_len=le_p.get("max_len", 12), emb_dim=le_p.get("emb_dim", 2048),
        n_heads=le_p.get("n_heads", 8), n_trans_layers=le_p.get("n_trans_layers", 12),
    )

    den_p = _params(p.get("denoiser_config"))
    for key in ("scaling_config", "weighting_config"):
        _require("Eps" in (den_p.get(key) or {}).get("target", "Eps"), f"non-eps {key}")
    for node in (den_p.get("discretization_config"),
                 _params(p.get("sampler_config")).get("discretization_config")):
        _require("LegacyDDPM" in (node or {}).get("target", "LegacyDDPM"),
                 "a discretization other than LegacyDDPM")
    loss_p = _params(p.get("loss_fn_config"))
    _require(not loss_p.get("ocr_enabled", False), "the OCR loss term (ocr_enabled: true)")
    sig_p = _params(loss_p.get("sigma_sampler_config"))
    _require("DiscreteSampling" in (loss_p.get("sigma_sampler_config") or {}).get(
        "target", "DiscreteSampling"), "a sigma sampler other than DiscreteSampling")
    _require("LegacyDDPM" in (sig_p.get("discretization_config") or {}).get(
        "target", "LegacyDDPM"), "a discretization other than LegacyDDPM")
    samp_p = _params(p.get("sampler_config"))

    engine = DiffusionEngine(
        unet=cast_weights(unet, unet_dtype, keep_fp32=opt_keys if train else ()),
        vae=cast_weights(vae, vae_dtype),
        label_encoder=label_encoder,
        denoiser=DiscreteDenoiser(num_idx=den_p.get("num_idx", 1000)),
        sigma_sampler=DiscreteSampling(num_idx=sig_p.get("num_idx", 1000)),
        loss_cfg=FullLossConfig(
            kernel_size=loss_p.get("kernel_size", 3),
            gaussian_sigma=loss_p.get("gaussian_sigma", 1.0),
            min_attn_size=loss_p.get("min_attn_size", 16),
            lambda_local_loss=loss_p.get("lambda_local_loss", 0.01),
        ),
        scale_factor=p.get("scale_factor", 0.18215),
        ucg_rate_label=float(emb["label"].get("ucg_rate", 0.0)),
        mask_multiplier=emb["mask_multiplier"],
        latent_factor=2 ** (len(vae.cfg.ch_mult) - 1),
    )
    # convs read NHWC activations through an NCHW view, which is
    # channels_last in memory: keep their weights channels_last too
    engine.to(device=device, memory_format=torch.channels_last)
    trainable = trainable_mask(engine.named_parameters(), opt_keys) if train else {}
    for name, prm in engine.named_parameters():
        prm.requires_grad_(trainable.get(name, False))
    sampler = SamplerSettings(
        num_steps=samp_p.get("num_steps", 50),
        cfg_scale=_params(samp_p.get("guider_config")).get("scale", 5.0),
    )
    # the parseq checkpoint comes with the OCR loss term, which is refused above
    ckpt_paths = {"model": None, "vae": vae_p.get("ckpt_path"),
                  "label_encoder": le_p.get("ckpt_path"), "parseq": None}
    return EngineBundle(engine, sampler, ckpt_paths)


@torch.no_grad()
def randomize_parameters(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter with seeded random values (none left zero, so
    zero-initialized output projections do not hide the network): weights
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), biases N(0, 0.02²),
    embeddings N(0, 1). Values are drawn on each parameter's device."""
    gens: Dict[torch.device, torch.Generator] = {}

    def randn(t: torch.Tensor) -> torch.Tensor:
        g = gens.get(t.device)
        if g is None:
            g = gens[t.device] = torch.Generator(t.device).manual_seed(seed)
        return torch.randn(t.shape, generator=g, device=t.device, dtype=torch.float32)

    for m in module.modules():
        for name, prm in m.named_parameters(recurse=False):
            r = randn(prm)
            if isinstance(m, nn.Embedding):
                v = r
            elif isinstance(m, (GroupNorm32, nn.LayerNorm)):
                v = 1.0 + 0.1 * r if name == "weight" else 0.1 * r
            elif name.endswith("bias"):
                v = 0.02 * r
            else:  # Linear/Conv weights and the packed in-projection
                fan_in = math.prod(prm.shape[1:]) if prm.ndim > 1 else 1
                v = r / math.sqrt(fan_in)
            prm.copy_(v.to(prm.dtype))
    return module

