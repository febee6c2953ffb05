"""The port's diffusion math against the JAX build: schedules, the discrete
denoiser, classifier-free guidance (with its raise), the Euler-EDM loop
(with churn) and the min-local attention loss. fp32; tolerance 1e-5
relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import assert_close
from udifftext_tpu.diffusion import loss as JL
from udifftext_tpu.diffusion import sampling as JS
from udifftext_tpu.diffusion import schedules as JSch
from udifftext_tpu.diffusion.denoiser import DiscreteDenoiser as JDenoiser
from udifftext_tpu.diffusion.guiders import VanillaCFG as JCFG
from udifftext_tpu_torch.diffusion import loss as PL
from udifftext_tpu_torch.diffusion import sampling as PS
from udifftext_tpu_torch.diffusion import schedules as PSch
from udifftext_tpu_torch.diffusion.denoiser import DiscreteDenoiser as PDenoiser
from udifftext_tpu_torch.diffusion.guiders import VanillaCFG as PCFG

RTOL, ATOL = 1e-5, 1e-6
T = torch.from_numpy


@pytest.mark.parametrize("n,append,flip", [(50, True, False), (2, True, False),
                                           (1000, False, True), (7, False, False)])
def test_legacy_ddpm_sigmas_equal(n, append, flip):
    want = JSch.LegacyDDPMDiscretization()(n, do_append_zero=append, flip=flip)
    got = PSch.LegacyDDPMDiscretization()(n, do_append_zero=append, flip=flip)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_eps_scaling_and_sigma_quantization():
    rs = np.random.RandomState(0)
    sigma = rs.uniform(0.03, 14.0, (6,)).astype(np.float32)
    for g, w in zip(PSch.eps_scaling(T(sigma)), JSch.eps_scaling(jnp.asarray(sigma))):
        assert_close(g, w, RTOL, ATOL, "eps_scaling")
    table = JDenoiser().sigmas
    want_idx = JSch.sigma_to_idx(jnp.asarray(sigma), jnp.asarray(table))
    assert np.array_equal(PSch.sigma_to_idx(T(sigma), T(table)).numpy(), np.asarray(want_idx))
    assert_close(PSch.quantize_sigma(T(sigma), T(table)),
                 JSch.quantize_sigma(jnp.asarray(sigma), jnp.asarray(table)), 0, 0, "quantize")
    x = torch.zeros(2, 3)
    assert PSch.append_dims(x, 4).shape == (2, 3, 1, 1)
    with pytest.raises(ValueError):
        PSch.append_dims(x, 1)


def test_discrete_denoiser_matches():
    """D(x; sigma) with a network that mixes x, c_noise and the cond."""
    rs = np.random.RandomState(1)
    x = rs.standard_normal((3, 4, 4, 2)).astype(np.float32)
    sigma = np.array([14.6, 0.5, 3.3], np.float32)
    cond = rs.standard_normal((3, 4, 4, 2)).astype(np.float32)

    def jnet(xx, c_noise, cd):
        return xx * 0.7 + cd["concat"] + c_noise[:, None, None, None] * 1e-3, {"c_noise": c_noise}

    def pnet(xx, c_noise, cd):
        return xx * 0.7 + cd["concat"] + c_noise[:, None, None, None] * 1e-3, {"c_noise": c_noise}

    want, jaux = JDenoiser()(jnet, jnp.asarray(x), jnp.asarray(sigma), {"concat": jnp.asarray(cond)})
    got, paux = PDenoiser()(pnet, T(x), T(sigma), {"concat": T(cond)})
    assert_close(got, want, RTOL, ATOL, "denoiser")
    assert np.array_equal(paux["c_noise"].numpy(), np.asarray(jaux["c_noise"]))


def test_vanilla_cfg_matches_and_raises():
    rs = np.random.RandomState(2)
    c = {k: rs.standard_normal((2, 3, 4)).astype(np.float32) for k in ("t_crossattn", "concat")}
    uc = {"t_crossattn": np.zeros((2, 3, 4), np.float32), "concat": c["concat"]}
    jc = JCFG(4.0).prepare_cond({k: jnp.asarray(v) for k, v in c.items()},
                                {k: jnp.asarray(v) for k, v in uc.items()})
    pc = PCFG(4.0).prepare_cond({k: T(v) for k, v in c.items()}, {k: T(v) for k, v in uc.items()})
    for k in jc:
        assert_close(pc[k], jc[k], 0, 0, k)
    d = rs.standard_normal((4, 5)).astype(np.float32)
    assert_close(PCFG(4.0)(T(d), None), JCFG(4.0)(jnp.asarray(d), None), RTOL, ATOL, "blend")

    shared = torch.ones(2)
    ok = PCFG(4.0).prepare_cond({"extra": shared}, {"extra": shared})
    assert ok["extra"] is shared
    with pytest.raises(ValueError, match="distinct tensor"):
        PCFG(4.0).prepare_cond({"extra": torch.ones(2)}, {"extra": torch.ones(2)})


def test_sample_euler_edm_matches():
    rs = np.random.RandomState(3)
    x = rs.standard_normal((2, 4, 4, 3)).astype(np.float32)
    sigmas = PSch.LegacyDDPMDiscretization()(6)
    target = rs.standard_normal((2, 4, 4, 3)).astype(np.float32)

    def jden(xx, s):
        return jnp.tanh(xx) * 0.5 + jnp.asarray(target) * (1.0 / (1.0 + s[:, None, None, None]))

    def pden(xx, s):
        return torch.tanh(xx) * 0.5 + T(target) * (1.0 / (1.0 + s[:, None, None, None]))

    want = JS.sample_euler_edm(jden, JS.init_latent(jnp.asarray(x), jnp.asarray(sigmas)),
                               jnp.asarray(sigmas))
    got = PS.sample_euler_edm(pden, PS.init_latent(T(x), T(sigmas)), T(sigmas))
    assert_close(got, want, RTOL, 1e-5, "euler")
    assert_close(PS.to_d(T(x), T(sigmas[:2]), T(target)),
                 JS.to_d(jnp.asarray(x), jnp.asarray(sigmas[:2]), jnp.asarray(target)),
                 RTOL, ATOL, "to_d")
    # stochastic churn on the JAX sampler's own draws (one split a step)
    params = JS.EDMStochasticParams(s_churn=1.0, s_noise=1.1)
    key = jax.random.PRNGKey(7)
    draws = []
    for _ in range(len(sigmas) - 1):
        key, sub = jax.random.split(key)
        draws.append(T(np.asarray(jax.random.normal(sub, x.shape))))
    x0 = JS.init_latent(jnp.asarray(x), jnp.asarray(sigmas))
    want = JS.sample_euler_edm(jden, x0, jnp.asarray(sigmas), params, jax.random.PRNGKey(7))
    got = PS.sample_euler_edm(pden, PS.init_latent(T(x), T(sigmas)), T(sigmas),
                              PS.EDMStochasticParams(s_churn=1.0, s_noise=1.1), noise=draws)
    assert_close(got, want, RTOL, 1e-5, "euler with churn")
    assert not np.allclose(np.asarray(want), np.asarray(JS.sample_euler_edm(jden, x0,
                                                                             jnp.asarray(sigmas))))


def _maps(b, seq, seed):
    rs = np.random.RandomState(seed)
    maps = {}
    for name, n in (("input_blocks.1.1.t_attn", 256), ("output_blocks.3.1.t_attn", 64),
                    ("output_blocks.4.1.t_attn", 256), ("middle_block.1.t_attn", 16)):
        m = rs.uniform(0, 1, (b, 2, n, seq)).astype(np.float32)
        maps[name] = m / m.sum(-1, keepdims=True)
    return maps


@pytest.mark.parametrize("min_attn_size", [16, 8, 64])
def test_min_local_loss_matches(min_attn_size):
    b, seq = 3, 12
    maps = _maps(b, seq, 4)
    mask = np.zeros((b, 32, 32, 1), np.float32)
    mask[:, 5:20, 9:30] = 1.0
    seg_mask = np.zeros((b, seq), np.float32)
    seg_mask[0, :2] = seg_mask[1, :5] = seg_mask[2, :1] = 1.0
    kernel = JL.get_gaussian_kernel(3, 1.0)
    assert np.array_equal(PL.get_gaussian_kernel(3, 1.0), kernel)
    want = JL.min_local_loss({k: jnp.asarray(v) for k, v in maps.items()}, jnp.asarray(mask),
                             jnp.asarray(seg_mask), jnp.asarray(kernel), min_attn_size)
    got = PL.min_local_loss({k: T(v) for k, v in maps.items()}, T(mask), T(seg_mask),
                            T(kernel), min_attn_size)
    assert got.shape == (b,)
    assert_close(got, want, RTOL, ATOL, "min_local_loss")


def test_loss_helpers_match():
    rs = np.random.RandomState(5)
    x = rs.standard_normal((2, 8, 8, 3)).astype(np.float32)
    kernel = JL.get_gaussian_kernel(3, 1.0)
    assert_close(PL.gaussian_blur_depthwise(T(x), T(kernel)),
                 JL.gaussian_blur_depthwise(jnp.asarray(x), jnp.asarray(kernel)),
                 RTOL, ATOL, "blur")
    for size in ((4, 4), (3, 5), (16, 8)):
        assert_close(PL.interpolate_nearest_torch(T(x), size),
                     JL.interpolate_nearest_torch(jnp.asarray(x), size), 0, 0, "nearest")
    for n, h, w in ((256, 32, 32), (128, 32, 64), (60, 30, 50)):
        assert PL._attn_hw(n, h, w) == JL._attn_hw(n, h, w)
