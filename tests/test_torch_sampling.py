"""The port's sampling options against the JAX build: the EDM discretization,
the V/EDM/unit scalings and weightings, the EDM sigma draw, the continuous
and the discrete denoiser, the identity guider, and the six samplers
(Euler-EDM with churn, Heun, Euler-ancestral, DPM++(2S) ancestral,
DPM++(2M), LMS) on a smooth analytic denoiser and on a tiny UNet of seeded
random weights, the stochastic ones on the JAX samplers' own draws. fp32;
tolerance 1e-5 relative. Then the builder: a tiny graph with the EDM
discretization and V scaling/weighting samples like the JAX builder's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from udifftext_tpu import builders as JB
from udifftext_tpu.builders import build_diffusion_engine
from udifftext_tpu.diffusion import sampling as JS
from udifftext_tpu.diffusion import schedules as JSch
from udifftext_tpu.diffusion.denoiser import Denoiser as JDen
from udifftext_tpu.diffusion.denoiser import DiscreteDenoiser as JDDen
from udifftext_tpu.diffusion.guiders import IdentityGuider as JIdentity
from udifftext_tpu_torch import builders as PB
from udifftext_tpu_torch.builders import build_engine
from udifftext_tpu_torch.diffusion import sampling as PS
from udifftext_tpu_torch.diffusion import schedules as PSch
from udifftext_tpu_torch.diffusion.denoiser import Denoiser as PDen
from udifftext_tpu_torch.diffusion.denoiser import DiscreteDenoiser as PDDen
from udifftext_tpu_torch.diffusion.guiders import IdentityGuider as PIdentity
from udifftext_tpu_torch.utils import convert

RTOL, ATOL = 1e-5, 1e-6
T = torch.from_numpy
SHAPE = (2, 4, 4, 3)


@pytest.mark.parametrize("params", [{}, {"sigma_min": 0.002, "sigma_max": 14.6, "rho": 5.0}])
@pytest.mark.parametrize("n,append,flip", [(50, True, False), (5, True, False), (1000, False, True)])
def test_edm_discretization_equal(params, n, append, flip):
    want = JSch.EDMDiscretization(**params)(n, do_append_zero=append, flip=flip)
    got = PSch.EDMDiscretization(**params)(n, do_append_zero=append, flip=flip)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_scalings_weightings_and_edm_sampling():
    assert set(PSch.SCALINGS) == set(JSch.SCALINGS)
    assert set(PSch.WEIGHTINGS) == set(JSch.WEIGHTINGS)
    sigma = np.random.RandomState(0).uniform(0.02, 80.0, (7,)).astype(np.float32)
    for name, fn in PSch.SCALINGS.items():
        for g, w in zip(fn(T(sigma)), JSch.SCALINGS[name](jnp.asarray(sigma))):
            U.assert_close(g, w, RTOL, ATOL, f"{name} scaling")
    for name, fn in PSch.WEIGHTINGS.items():
        U.assert_close(fn(T(sigma)), JSch.WEIGHTINGS[name](jnp.asarray(sigma)), RTOL, ATOL,
                       f"{name} weighting")
    key = jax.random.PRNGKey(3)
    want = JSch.EDMSampling(p_mean=-1.0, p_std=1.4)(key, 6)
    randn = T(np.array(jax.random.normal(key, (6,))))
    U.assert_close(PSch.EDMSampling(p_mean=-1.0, p_std=1.4)(randn), want, RTOL, ATOL, "EDMSampling")
    drawn = PSch.EDMSampling().draw_randn(5, torch.Generator().manual_seed(0))
    assert drawn.shape == (5,) and bool((PSch.EDMSampling()(drawn) > 0).all())


def _net(xx, c_noise, cd):
    """A network that mixes x, c_noise and the cond (same code on both sides:
    jnp and torch arrays share these operators)."""
    return xx * 0.7 + cd["concat"] + c_noise[:, None, None, None] * 1e-3, {"c_noise": c_noise}


@pytest.mark.parametrize("scaling", ["eps", "v", "edm"])
@pytest.mark.parametrize("kind", ["continuous", "discrete_edm", "discrete_ddpm_500"])
def test_denoisers_match(scaling, kind):
    rs = np.random.RandomState(1)
    x = rs.standard_normal((3, 4, 4, 2)).astype(np.float32)
    sigma = np.array([14.6, 0.5, 3.3], np.float32)
    cond = rs.standard_normal((3, 4, 4, 2)).astype(np.float32)
    weighting = {"eps": "unit", "v": "v", "edm": "edm"}[scaling]
    if kind == "continuous":
        jd, pd = JDen(scaling, weighting), PDen(scaling, weighting)
    elif kind == "discrete_edm":
        jd = JDDen(scaling, weighting, discretization=JSch.EDMDiscretization())
        pd = PDDen(scaling, weighting, discretization=PSch.EDMDiscretization())
    else:
        jd = JDDen(scaling, weighting, num_idx=500)
        pd = PDDen(scaling, weighting, num_idx=500)
    want, jaux = jd(_net, jnp.asarray(x), jnp.asarray(sigma), {"concat": jnp.asarray(cond)})
    got, paux = pd(_net, T(x), T(sigma), {"concat": T(cond)})
    U.assert_close(got, want, RTOL, ATOL, "denoised")
    U.assert_close(paux["c_noise"], jaux["c_noise"], RTOL, ATOL, "c_noise")
    U.assert_close(pd.w(T(sigma)), jd.w(jnp.asarray(sigma)), RTOL, ATOL, "w")
    for g, w in zip(pd.scale(T(sigma)), jd.scale(jnp.asarray(sigma))):
        U.assert_close(g, w, RTOL, ATOL, "scale")


def test_identity_guider_and_ancestral_step():
    c = {"t_crossattn": np.ones((2, 3), np.float32)}
    got = PIdentity().prepare_cond({k: T(v) for k, v in c.items()}, {})
    want = JIdentity().prepare_inputs(None, None, {k: jnp.asarray(v) for k, v in c.items()}, {})[2]
    assert set(got) == set(want) and np.array_equal(got["t_crossattn"].numpy(),
                                                    np.asarray(want["t_crossattn"]))
    d = np.random.RandomState(2).standard_normal((4, 5)).astype(np.float32)
    assert torch.equal(PIdentity()(T(d), None), T(d))
    frm, to = np.array([14.6, 3.0, 0.5], np.float32), np.array([9.0, 0.0, 0.4], np.float32)
    for eta in (0.0, 0.5, 1.0, 1.7):
        for g, w in zip(PS.get_ancestral_step(T(frm), T(to), eta),
                        JS.get_ancestral_step(jnp.asarray(frm), jnp.asarray(to), eta)):
            U.assert_close(g, w, RTOL, ATOL, f"ancestral step eta {eta}")


def _jax_step_draws(key, n, shape):
    """The JAX samplers' draws: `rng, sub = split(rng)` then normal(sub) each step."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(T(np.array(jax.random.normal(sub, shape))))
    return out


def _run_both(name, jden, pden, x, sigmas, churn=None):
    """The named sampler on both sides from x (already scaled), the JAX one
    with its rng and the port on the replayed draws."""
    key = jax.random.PRNGKey(5)
    draws = _jax_step_draws(key, len(sigmas) - 1, x.shape)
    jx, js, px, ps = jnp.asarray(x), jnp.asarray(sigmas), T(x), T(sigmas)
    if name in ("euler_edm", "heun_edm"):
        jp = JS.EDMStochasticParams(**(churn or {}))
        pp = PS.EDMStochasticParams(**(churn or {}))
        want = JS.SAMPLERS[name](jden, jx, js, jp, key if churn else None)
        # the callable form of injected noise: step i's draw of a shape
        got = PS.SAMPLERS[name](pden, px, ps, pp,
                                noise=(lambda i, shape: draws[i]) if churn else None)
    elif name in ("euler_ancestral", "dpmpp2s_ancestral"):
        want = JS.SAMPLERS[name](jden, jx, js, key, eta=0.9, s_noise=1.05)
        got = PS.SAMPLERS[name](pden, px, ps, noise=draws, eta=0.9, s_noise=1.05)
    else:
        want = JS.SAMPLERS[name](jden, jx, js)
        got = PS.SAMPLERS[name](pden, px, ps)
    return got, want


SCHEDULES = {"ddpm6": lambda: PSch.LegacyDDPMDiscretization()(6),
             "edm5": lambda: PSch.EDMDiscretization(sigma_max=14.6)(5)}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("name", sorted(PS.SAMPLERS))
def test_samplers_match_on_an_analytic_denoiser(name, schedule):
    rs = np.random.RandomState(3)
    sigmas = SCHEDULES[schedule]()
    x = np.array(JS.init_latent(jnp.asarray(rs.standard_normal(SHAPE).astype(np.float32)),
                                  jnp.asarray(sigmas)))
    target = rs.standard_normal(SHAPE).astype(np.float32)

    def jden(xx, s):
        return jnp.tanh(xx) * 0.5 + jnp.asarray(target) * (1.0 / (1.0 + s[:, None, None, None]))

    def pden(xx, s):
        return torch.tanh(xx) * 0.5 + T(target) * (1.0 / (1.0 + s[:, None, None, None]))

    got, want = _run_both(name, jden, pden, x, sigmas)
    assert bool(torch.isfinite(got).all())
    U.assert_close(got, want, RTOL, 1e-5, name)


@pytest.mark.parametrize("churn", [{"s_churn": 2.0}, {"s_churn": 1.0, "s_tmin": 0.3, "s_tmax": 5.0,
                                                      "s_noise": 1.003}],
                         ids=["churn", "churn_tmin_tmax"])
@pytest.mark.parametrize("name", ["euler_edm", "heun_edm"])
def test_churn_matches(name, churn):
    """Churn on every step, and with s_tmin/s_tmax binding (the DDPM
    schedule's first step above s_tmax, its last below s_tmin)."""
    rs = np.random.RandomState(4)
    sigmas = PSch.LegacyDDPMDiscretization()(6)
    assert sigmas[0] > churn.get("s_tmax", np.inf) or "s_tmax" not in churn
    x = np.array(JS.init_latent(jnp.asarray(rs.standard_normal(SHAPE).astype(np.float32)),
                                  jnp.asarray(sigmas)))

    def jden(xx, s):
        return jnp.sin(xx) * 0.3 + 1.0 / (1.0 + s[:, None, None, None])

    def pden(xx, s):
        return torch.sin(xx) * 0.3 + 1.0 / (1.0 + s[:, None, None, None])

    got, want = _run_both(name, jden, pden, x, sigmas, churn)
    U.assert_close(got, want, RTOL, 1e-5, f"{name} {churn}")
    plain, _ = _run_both(name, jden, pden, x, sigmas)
    assert not torch.allclose(got, plain)  # the churn changed the result


@pytest.fixture(scope="module")
def tiny_unet():
    return U.tiny_unet_pair()


@pytest.mark.parametrize("name", sorted(PS.SAMPLERS))
def test_samplers_match_on_a_tiny_unet(tiny_unet, name):
    junet, params, punet, ctx = tiny_unet
    sigmas = PSch.LegacyDDPMDiscretization()(5)
    x = np.array(JS.init_latent(jax.random.normal(jax.random.PRNGKey(2), (2, 8, 8, 4)),
                                  jnp.asarray(sigmas)))
    den = JDen("eps", "eps")
    pden_ = PDen("eps", "eps")

    def jden(xx, s):
        return den(lambda a, t, c: junet.apply(params, a, t, c), xx, s, jnp.asarray(ctx))[0]

    def pden(xx, s):
        with torch.no_grad():
            return pden_(lambda a, t, c: punet(a, t, c), xx, s, T(ctx))[0]

    churn = {"s_churn": 1.0} if name in ("euler_edm", "heun_edm") else None
    got, want = _run_both(name, jden, pden, x, sigmas, churn)
    # one UNet eval agrees to 1e-5 (tests/test_torch_models.py); eps scaling
    # multiplies its error by sigma, and the steps add it up over the
    # schedule's span: 1e-5·sigma_max
    U.assert_close(got, want, RTOL, 1e-5 * float(sigmas[0]), name)


def _edm_v_graph():
    cfg = U.tiny_model_cfg()
    P = "sgm.modules.diffusionmodules."
    edm = {"target": P + "discretizer.EDMDiscretization",
           "params": {"sigma_min": 0.03, "sigma_max": 14.6}}
    den = cfg["denoiser_config"]["params"]
    den["scaling_config"] = {"target": P + "denoiser_scaling.VScaling"}
    den["weighting_config"] = {"target": P + "denoiser_weighting.VWeighting"}
    den["discretization_config"] = edm
    cfg["sampler_config"]["params"]["discretization_config"] = edm
    return cfg


def test_builder_edm_v_graph_samples_like_jax():
    cfg = _edm_v_graph()
    je = build_diffusion_engine(cfg, unet_dtype=jnp.float32).engine
    params = U.engine_params(je, seed=13)
    pe = U.load_port(build_engine(cfg, torch.float32, "cpu").engine, convert.engine_from_jax(params))
    assert (pe.denoiser.scaling, pe.denoiser.weighting) == (je.denoiser.scaling,
                                                            je.denoiser.weighting) == ("v", "v")
    assert np.array_equal(pe.denoiser.sigmas, je.denoiser.sigmas)
    assert np.array_equal(pe.discretization(4), je.discretization(4))
    sigma = np.array([0.05, 2.0, 14.0], np.float32)
    U.assert_close(pe.denoiser.w(T(sigma)), je.denoiser.w(jnp.asarray(sigma)), RTOL, ATOL, "w")

    nb = U.numpy_batch(1, seed=3)
    key = jax.random.PRNGKey(4)
    rng_cond, rng_noise = jax.random.split(key)
    shape = (1, U.LAT, U.LAT, 4)
    eps = np.asarray(jax.random.normal(jax.random.split(rng_cond, 6)[4], shape))
    x0 = np.asarray(jax.random.normal(rng_noise, shape))
    want, _ = je.sample(params, U.to_jax(nb), key, num_steps=3, cfg_scale=5.0, noise_iters=0,
                        return_latents=True)
    got, _ = pe.sample(U.to_torch(nb), num_steps=3, cfg_scale=5.0, noise_iters=0,
                       posterior_eps=T(eps), noise=T(x0)[None], return_latents=True)
    U.assert_close(got, want, 1e-3, 1e-3, "EDM/V latent")


def test_builder_refuses_what_jax_does_not_know():
    P = "sgm.modules.diffusionmodules."
    for path, node in ((("denoiser_config", "scaling_config"), P + "denoiser_scaling.UnitScaling"),
                       (("denoiser_config", "weighting_config"), P + "denoiser_weighting.Foo"),
                       (("denoiser_config", "discretization_config"), P + "discretizer.Cosine"),
                       (("sampler_config", "discretization_config"), P + "discretizer.Cosine")):
        cfg = U.tiny_model_cfg()
        cfg[path[0]]["params"][path[1]] = {"target": node}
        with pytest.raises(NotImplementedError, match=node.rsplit(".", 1)[-1]):
            build_engine(cfg, torch.float32, "cpu")
    # every tag the JAX builder maps a weighting to is built
    for name in ("Eps", "V", "EDM", "Unit"):
        cfg = U.tiny_model_cfg()
        cfg["denoiser_config"]["params"]["weighting_config"] = {
            "target": P + f"denoiser_weighting.{name}Weighting"}
        assert build_engine(cfg, torch.float32, "cpu").engine.denoiser.weighting == name.lower()
    assert PB.SamplerSettings() == PB.SamplerSettings(**{
        f: getattr(JB.SamplerSettings(), f) for f in ("num_steps", "cfg_scale")})
