"""Weight layout: a seeded port state dict, converted to flax params by the
JAX build's reference-checkpoint converters (ckpt_torch.convert_*), comes
back through `udifftext_tpu_torch.utils.convert` as the same tensors. This
holds the port's module names to the reference checkpoint's keys. The UNet
and VAE run at the tiny graph's shape and at the shipped graph's topology
with narrow widths (4 levels, attention at ds 4/2/1, depth 2)."""

import numpy as np
import pytest
import torch

from udifftext_tpu.utils import ckpt_torch
from udifftext_tpu_torch.builders import randomize_parameters
from udifftext_tpu_torch.models.label_encoder import LabelEncoder
from udifftext_tpu_torch.models.unet import UNetModel
from udifftext_tpu_torch.models.vae import AutoencoderKL, DDConfig
from udifftext_tpu_torch.utils import convert

UNETS = {
    "tiny": dict(model_channels=32, attention_resolutions=(2, 1), num_res_blocks=1,
                 channel_mult=(1, 2), num_head_channels=8, t_context_dim=32),
    "shipped_topology": dict(model_channels=32, attention_resolutions=(4, 2, 1),
                             num_res_blocks=2, channel_mult=(1, 2, 4, 4), num_head_channels=8,
                             transformer_depth=2, t_context_dim=16),
}
VAES = {
    "tiny": DDConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=32),
    "shipped_topology_with_attn": DDConfig(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                                           attn_resolutions=(64,), resolution=256),
}


def _round_trip(module, to_flax, from_jax):
    randomize_parameters(module, 0)
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    flax = to_flax(sd)
    assert flax["unknown"] == []
    back = from_jax(flax["params"])
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape and np.array_equal(back[k].numpy(), v), k
    module.load_state_dict(back, strict=True)


@pytest.mark.parametrize("name", sorted(UNETS))
def test_unet_round_trip(name):
    _round_trip(UNetModel(**UNETS[name]), lambda sd: ckpt_torch.convert_unet(sd, prefix=""),
                convert.unet_from_jax)


@pytest.mark.parametrize("name", sorted(VAES))
def test_vae_round_trip(name):
    _round_trip(AutoencoderKL(VAES[name]), ckpt_torch.convert_vae, convert.vae_from_jax)


def test_label_encoder_round_trip():
    _round_trip(LabelEncoder(emb_dim=32, n_heads=4, n_trans_layers=2, dim_feedforward=64),
                ckpt_torch.convert_label_encoder, convert.label_encoder_from_jax)


def test_unet_state_dict_uses_reference_keys():
    keys = set(UNetModel(**UNETS["tiny"]).state_dict())
    for k in ("time_embed.0.weight", "input_blocks.0.0.weight",
              "input_blocks.1.0.in_layers.0.weight", "input_blocks.1.0.emb_layers.1.bias",
              "input_blocks.1.0.out_layers.3.weight", "input_blocks.2.0.op.weight",
              "input_blocks.3.0.skip_connection.weight",
              "input_blocks.1.1.transformer_blocks.0.attn1.to_out.0.weight",
              "input_blocks.1.1.transformer_blocks.0.ff.net.0.proj.weight",
              "input_blocks.1.1.transformer_blocks.0.ff.net.2.bias",
              "middle_block.1.transformer_blocks.0.t_attn.to_k.weight",
              "output_blocks.1.2.conv.weight", "out.0.weight", "out.2.bias"):
        assert k in keys, k
    assert all(v.dtype == torch.float32 for v in UNetModel(**UNETS["tiny"]).state_dict().values())
