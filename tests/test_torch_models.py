"""The port's UNet, VAE and LabelEncoder against the JAX build, on the
tiny model graph with seeded random weights (zero-initialized projections
included) converted by `udifftext_tpu_torch.utils.convert`. fp32;
tolerance 1e-5 relative, 1e-5 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from udifftext_tpu.builders import build_diffusion_engine
from udifftext_tpu.models.unet import precompute_context_kv
from udifftext_tpu.models.vae import AutoencoderKL as JVAE
from udifftext_tpu_torch.builders import build_engine
from udifftext_tpu_torch.utils import convert

RTOL, ATOL = 1e-5, 1e-5
T = torch.from_numpy


@pytest.fixture(scope="module")
def models():
    cfg = U.tiny_model_cfg()
    je = build_diffusion_engine(cfg, unet_dtype=jnp.float32).engine
    params = U.engine_params(je, seed=3)
    pe = U.load_port(build_engine(cfg, torch.float32, "cpu").engine,
                     convert.engine_from_jax(params))
    return je, params, pe


def test_every_parameter_is_random(models):
    _, _, pe = models
    for name, p in pe.named_parameters():
        assert not torch.all(p == 0), name


@pytest.mark.parametrize("hoist", [False, True])
def test_unet_matches_with_map_capture(models, hoist):
    je, params, pe = models
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, U.LAT, U.LAT, 9)).astype(np.float32)
    t = np.array([999, 17], np.int32)
    ctx = rs.standard_normal((2, U.SEQ, 32)).astype(np.float32)
    jkv = precompute_context_kv(je.unet, params["unet"], jnp.asarray(ctx)) if hoist else None
    want, jmaps = je.unet.apply(params["unet"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                capture_attn=True, ctx_kv=jkv)
    pkv = pe.unet.precompute_context_kv(T(ctx)) if hoist else None
    with torch.no_grad():
        got, pmaps = pe.unet(T(x), T(t), T(ctx), capture_attn=True, ctx_kv=pkv)
    assert got.dtype == torch.float32
    U.assert_close(got, want, RTOL, ATOL, "unet out")
    assert sorted(pmaps) == sorted(jmaps)
    for k in jmaps:
        U.assert_close(pmaps[k], jmaps[k], RTOL, 1e-6, k)
    if hoist:
        for k, entries in jkv.items():
            for d, e in enumerate(entries):
                for j in range(2):
                    U.assert_close(pkv[k][d]["t"][j], e["t"][j], RTOL, ATOL, f"kv {k}")


def test_unet_without_capture_returns_no_maps(models):
    _, _, pe = models
    with torch.no_grad():
        out, maps = pe.unet(torch.zeros(1, U.LAT, U.LAT, 9), torch.tensor([5]),
                            torch.zeros(1, U.SEQ, 32))
    assert maps == {} and out.shape == (1, U.LAT, U.LAT, 4)


def test_vae_encode_decode_match(models):
    je, params, pe = models
    rs = np.random.RandomState(1)
    img = rs.uniform(-1, 1, (2, U.IMG, U.IMG, 3)).astype(np.float32)
    want = je.vae.apply(params["vae"], jnp.asarray(img), method=JVAE.encode_moments)
    with torch.no_grad():
        got = pe.vae.encode_moments(T(img))
    U.assert_close(got, want, RTOL, ATOL, "encode_moments")
    z = rs.standard_normal((2, U.LAT, U.LAT, 4)).astype(np.float32)
    want = je.vae.apply(params["vae"], jnp.asarray(z), method=JVAE.decode)
    with torch.no_grad():
        got = pe.vae.decode(T(z))
    U.assert_close(got, want, RTOL, ATOL, "decode")


def test_diagonal_gaussian_sample(models):
    from udifftext_tpu.models.vae import DiagonalGaussian as JDG
    from udifftext_tpu_torch.models.vae import DiagonalGaussian as PDG

    rs = np.random.RandomState(2)
    moments = (3 * rs.standard_normal((2, 4, 4, 8))).astype(np.float32)
    eps_key = jax.random.PRNGKey(4)
    want = JDG(jnp.asarray(moments)).sample(eps_key)
    eps = jax.random.normal(eps_key, (2, 4, 4, 4))
    got = PDG(T(moments)).sample(T(np.asarray(eps)))
    U.assert_close(got, want, RTOL, 1e-6, "posterior sample")
    U.assert_close(PDG(T(moments)).mode(), moments[..., :4], 0, 0, "mode")


def test_label_encoder_matches(models):
    je, params, pe = models
    from udifftext_tpu import charset

    ids = charset.encode_labels(["HELLO", "a", ""], U.SEQ)
    want = je.label_encoder.apply(params["label_encoder"], jnp.asarray(ids))
    with torch.no_grad():
        got = pe.label_encoder(T(ids))
    U.assert_close(got, want, RTOL, ATOL, "label encoder")
