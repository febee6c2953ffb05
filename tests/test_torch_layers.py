"""The port's layers and transformer blocks against the JAX build's flax
modules: timestep embedding, GroupNorm32, convs, dense, upsampling,
LayerNormF32, the GEGLU feed-forward module and a SpatialTransformer with
attention-map capture (softmax and single-token sigmoid contexts, inline
and hoisted K/V). Every parameter is seeded random. fp32; tolerance 1e-5
relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import assert_close, flax_params
from udifftext_tpu.models import attention as JA
from udifftext_tpu.models import layers as JLy
from udifftext_tpu_torch.models import attention as PA
from udifftext_tpu_torch.models import layers as PLy
from udifftext_tpu_torch.utils.convert import unet_from_jax

RTOL, ATOL = 1e-5, 1e-5
T = torch.from_numpy


def _x(shape, seed=0, offset=0.0):
    return (np.random.RandomState(seed).standard_normal(shape) + offset).astype(np.float32)


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 499, 999], np.float32)
    # the frequencies may differ by an ulp between the two exp()s; at t=999
    # that moves the argument by ~1e-4 rad
    assert_close(PLy.timestep_embedding(T(t), dim), JLy.timestep_embedding(jnp.asarray(t), dim),
                 RTOL, 2e-4, "temb")


@pytest.mark.parametrize("eps,offset", [(1e-5, 0.0), (1e-6, 40.0)])
def test_group_norm32(eps, offset):
    x = _x((2, 6, 5, 64), 1, offset)
    jm = JLy.GroupNorm32(eps=eps)
    p = flax_params(jm, 3, jnp.asarray(x))
    pm = PLy.GroupNorm32(64, eps=eps)
    pm.load_state_dict({"weight": T(np.asarray(p["params"]["GroupNorm_0"]["scale"])),
                        "bias": T(np.asarray(p["params"]["GroupNorm_0"]["bias"]))})
    # centering cancels |mean|: the error scales with ulp(offset)
    assert_close(pm(T(x)), jm.apply(p, jnp.asarray(x)), RTOL, ATOL + 1e-6 * offset, "gn")
    assert pm(T(x).bfloat16()).dtype == torch.bfloat16


def _conv_sd(p):
    k = np.asarray(p["params"]["Conv_0"]["kernel"]).transpose(3, 2, 0, 1).copy()
    return {"weight": T(k), "bias": T(np.asarray(p["params"]["Conv_0"]["bias"]))}


@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3(stride):
    x = _x((2, 8, 8, 6), 2)
    jm = JLy.Conv3x3(10, stride=stride)
    p = flax_params(jm, 4, jnp.asarray(x))
    pm = PLy.Conv3x3(6, 10, stride=stride)
    pm.load_state_dict(_conv_sd(p))
    assert_close(pm(T(x)), jm.apply(p, jnp.asarray(x)), RTOL, ATOL, "conv3x3")


def test_conv1x1_dense_upsample_layernorm():
    x = _x((2, 5, 7, 6), 3)
    jm = JLy.Conv1x1(4)
    p = flax_params(jm, 5, jnp.asarray(x))
    pm = PLy.Conv1x1(6, 4)
    pm.load_state_dict(_conv_sd(p))
    assert_close(pm(T(x)), jm.apply(p, jnp.asarray(x)), RTOL, ATOL, "conv1x1")

    jd = JLy.Dense(9)
    pd_ = flax_params(jd, 6, jnp.asarray(x))
    d = PLy.Dense(6, 9)
    d.load_state_dict({"weight": T(np.asarray(pd_["params"]["Dense_0"]["kernel"]).T.copy()),
                       "bias": T(np.asarray(pd_["params"]["Dense_0"]["bias"]))})
    assert_close(d(T(x)), jd.apply(pd_, jnp.asarray(x)), RTOL, ATOL, "dense")

    assert np.array_equal(PLy.upsample_nearest_2x(T(x)).numpy(),
                          np.asarray(JLy.upsample_nearest_2x(jnp.asarray(x))))

    xs = _x((2, 7, 6), 4, 3.0)
    jl = JA.LayerNormF32()
    pl_ = flax_params(jl, 7, jnp.asarray(xs))
    ln = PLy.LayerNormF32(6)
    ln.load_state_dict({"weight": T(np.asarray(pl_["params"]["LayerNorm_0"]["scale"])),
                        "bias": T(np.asarray(pl_["params"]["LayerNorm_0"]["bias"]))})
    assert_close(ln(T(xs)), jl.apply(pl_, jnp.asarray(xs)), RTOL, ATOL, "layernorm")


def test_geglu_module_plain_path():
    x = _x((2, 24, 16), 5)
    jm = JA.GEGLUFeedForward(impl="xla")
    p = flax_params(jm, 8, jnp.asarray(x))
    pm = PA.GEGLUFeedForward(16)
    sd = unet_from_jax({"input_blocks_1_1": {"blocks_0": {"ff": p["params"]}}})
    pm.load_state_dict({k.split(".ff.", 1)[1]: v for k, v in sd.items()}, strict=True)
    assert_close(pm(T(x)), jm.apply(p, jnp.asarray(x)), RTOL, ATOL, "geglu module")


def _spatial_transformer(context_len, seed):
    heads, dh, c, tdim = 4, 8, 32, 12
    x = _x((2, 8, 8, c), seed)
    ctx = _x((2, context_len, tdim), seed + 1)
    jm = JA.SpatialTransformer(heads, dh, t_context_dim=tdim, attn_impl="xla")
    p = flax_params(jm, seed + 2, jnp.asarray(x), jnp.asarray(ctx))
    sd = unet_from_jax({"input_blocks_1_1": p["params"]})
    pm = PA.SpatialTransformer(c, heads, dh, t_context_dim=tdim)
    pm.load_state_dict({k[len("input_blocks.1.1."):]: v for k, v in sd.items()}, strict=True)
    return x, ctx, jm, p, pm


@pytest.mark.parametrize("context_len", [12, 1])
@pytest.mark.parametrize("hoist", [False, True])
def test_spatial_transformer_with_map_capture(context_len, hoist):
    x, ctx, jm, p, pm = _spatial_transformer(context_len, 10 + context_len)
    want, jmaps = jm.apply(p, jnp.asarray(x), jnp.asarray(ctx), None, True)
    kv = pm.precompute_kv(T(ctx), None) if hoist else None
    got, pmaps = pm(T(x), T(ctx), None, True, kv)
    assert_close(got, want, RTOL, ATOL, "spatial transformer")
    assert pmaps[0].dtype == torch.float32 and pmaps[0].shape == (2, 4, 64, context_len)
    assert_close(pmaps[0], jmaps[0], RTOL, 1e-6, "t_attn map")
    if context_len == 1:  # sigmoid, not a softmax that would be all ones
        assert float(pmaps[0].min()) < 0.99
    _, no_maps = pm(T(x), T(ctx), None, False, kv)
    assert no_maps == [None]
