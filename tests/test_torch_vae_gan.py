"""The VAE's adversarial training path on the port (`models/discriminator.py`,
`diffusion/vae_loss.py`, `DiagonalGaussian.nll`) and `config.
instantiate_from_config`, against the JAX package on the CPU.

The setup is tests/test_vae_train.py's: a VAE of ch 32, ch_mult (1, 2) at
32², a discriminator of ndf 16 with 2 layers. The JAX weights go across
through `vae_from_jax` and `discriminator_from_jax`; the posterior's noise is
the JAX key's own draw. Tolerances: 1e-4 for the losses, the adaptive weight
and the parameters after a step of each optimizer; 1e-5 for the functions.
The port's BatchNorm keeps PyTorch's running-variance update (unbiased batch
variance, n/(n−1) times the JAX build's biased one, n = B·H·W per channel):
the running means match and the variances stand in exactly that relation.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_util as U
from udifftext_tpu.diffusion import vae_loss as JV
from udifftext_tpu.models.discriminator import NLayerDiscriminator as JDisc
from udifftext_tpu.models.vae import AutoencoderKL as JVAE
from udifftext_tpu.models.vae import DDConfig as JDD
from udifftext_tpu.models.vae import DiagonalGaussian as JGauss
from udifftext_tpu_torch.diffusion import vae_loss as PV
from udifftext_tpu_torch.models.discriminator import NLayerDiscriminator as PDisc
from udifftext_tpu_torch.models.vae import AutoencoderKL as PVAE
from udifftext_tpu_torch.models.vae import DDConfig as PDD
from udifftext_tpu_torch.models.vae import DiagonalGaussian as PGauss
from udifftext_tpu_torch.utils import convert

IMG = 32
DD = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
          in_channels=3, resolution=IMG, z_channels=4)


def mse(a, b):
    """An LPIPS-shaped perceptual stand-in: (B,) from NHWC pairs."""
    return ((a - b) ** 2).mean(axis=(1, 2, 3)) if isinstance(a, jax.Array) else \
        ((a - b) ** 2).mean(dim=(1, 2, 3))


@pytest.fixture(scope="module")
def nets():
    """(JAX vae, disc, vae params, disc vars, port vae, port disc, x, rng, eps)."""
    jvae, jdisc = JVAE(JDD(**DD), embed_dim=4), JDisc(ndf=16, n_layers=2)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    vae_params = jvae.init(k1, jnp.zeros((1, IMG, IMG, 3)))
    shapes = jax.eval_shape(lambda k, v: jdisc.init(k, v, train=False), k2,
                            jnp.zeros((1, IMG, IMG, 3)))
    rs = np.random.RandomState(5)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, s: (0.1 * rs.standard_normal(s.shape) if path[-1].key == "mean" else
                         1.0 + 0.5 * np.abs(rs.standard_normal(s.shape))).astype(np.float32),
        shapes["batch_stats"])
    # seeded weights of unit-scale activations, so the batch statistics (and
    # the running variances' n/(n−1)) are far from the rounding level
    disc_vars = {"params": U.random_like_flax(shapes["params"], 4), "batch_stats": stats}
    pvae = U.load_port(PVAE(PDD(**DD), embed_dim=4), convert.vae_from_jax(vae_params))
    pdisc = PDisc(ndf=16, n_layers=2)
    pdisc.load_state_dict(convert.discriminator_from_jax(disc_vars["params"],
                                                         disc_vars["batch_stats"]), strict=True)
    x = np.random.RandomState(0).randn(2, IMG, IMG, 3).clip(-1, 1).astype(np.float32)
    rng = jax.random.PRNGKey(1)
    moments = jvae.apply(vae_params, jnp.asarray(x), method=JVAE.encode_moments)
    eps = np.asarray(jax.random.normal(rng, JGauss(moments).mean.shape))
    return jvae, jdisc, vae_params, disc_vars, pvae, pdisc, x, rng, torch.from_numpy(eps)


def _disc_state(disc):
    return {k: v.clone() for k, v in disc.state_dict().items()}


def test_discriminator_layout_and_forward(nets):
    """taming's keys, and the logits on batch and on running statistics."""
    _, jdisc, _, disc_vars, _, pdisc, x, _, _ = nets
    keys = set(pdisc.state_dict())
    assert {"main.0.weight", "main.0.bias", "main.2.weight", "main.3.running_var",
            "main.5.weight", "main.6.num_batches_tracked", "main.8.weight",
            "main.8.bias"} <= keys
    assert not any(k.startswith("main.2.bias") or k.startswith("main.5.bias") for k in keys)
    before = _disc_state(pdisc)
    want, _ = jdisc.apply(disc_vars, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = PV.on_batch_statistics(pdisc, torch.from_numpy(x))
    U.assert_close(got, want, 1e-4, 1e-5, "train-mode logits")
    assert all(torch.equal(before[k], v) for k, v in pdisc.state_dict().items())
    pdisc.eval()
    U.assert_close(pdisc(torch.from_numpy(x)),
                   jdisc.apply(disc_vars, jnp.asarray(x), train=False), 1e-4, 1e-5,
                   "eval-mode logits")
    fresh = PDisc()
    assert fresh(torch.zeros(1, 64, 64, 3)).shape == (1, 6, 6, 1)
    convs = [m for m in fresh.main if isinstance(m, torch.nn.Conv2d)]
    assert all(abs(float(c.weight.std()) - 0.02) < 0.004 for c in convs[1:])


@pytest.mark.parametrize("disc_loss", ["hinge", "vanilla"])
@pytest.mark.parametrize("perceptual", [False, True], ids=["no_lpips", "lpips"])
@pytest.mark.parametrize("step", [0, 5], ids=["before_disc_start", "disc_on"])
def test_losses_match_jax(nets, disc_loss, perceptual, step):
    """generator_loss (every log entry, the adaptive weight) and
    discriminator_loss on the same weights, x and noise."""
    jvae, jdisc, vae_params, disc_vars, pvae, pdisc, x, rng, eps = nets
    cfg = dict(disc_start=3, perceptual_weight=1.0 if perceptual else 0.0, disc_loss=disc_loss,
               logvar_init=0.0)
    pfn = mse if perceptual else None
    want, wlog = JV.generator_loss(JV.VAEGanLossConfig(**cfg), jvae, jdisc, vae_params,
                                   disc_vars, jnp.asarray(0.1), jnp.asarray(x), rng,
                                   jnp.asarray(step), pfn)
    before = _disc_state(pdisc)
    got, glog = PV.generator_loss(PV.VAEGanLossConfig(**cfg), pvae, pdisc, torch.tensor(0.1),
                                  torch.from_numpy(x), eps, step, pfn)
    assert set(glog) == set(wlog)
    U.assert_close(got, want, 1e-4, 1e-6, "generator loss")
    for k in wlog:
        U.assert_close(glog[k], wlog[k], 1e-4, 1e-6, k)
    assert float(glog["loss/d_weight"]) > 0
    assert all(torch.equal(before[k], v) for k, v in pdisc.state_dict().items())

    dwant, dwlog, _ = JV.discriminator_loss(JV.VAEGanLossConfig(**cfg), jvae, jdisc,
                                            vae_params, disc_vars, jnp.asarray(x), rng,
                                            jnp.asarray(step))
    pdisc_copy = PDisc(ndf=16, n_layers=2)
    pdisc_copy.load_state_dict(before)
    dgot, dglog = PV.discriminator_loss(PV.VAEGanLossConfig(**cfg), pvae, pdisc_copy,
                                        torch.from_numpy(x), eps, step)
    U.assert_close(dgot, dwant, 1e-4, 1e-6, "discriminator loss")
    for k in dwlog:
        U.assert_close(dglog[k], dwlog[k], 1e-4, 1e-6, k)
    if step < 3:
        assert float(dgot) == 0.0


def test_discriminator_loss_on_running_stats(nets):
    jvae, jdisc, vae_params, disc_vars, pvae, pdisc, x, rng, eps = nets
    cfg = dict(disc_start=0)
    dwant, _, upd = JV.discriminator_loss(JV.VAEGanLossConfig(**cfg), jvae, jdisc, vae_params,
                                          disc_vars, jnp.asarray(x), rng, jnp.asarray(0),
                                          train_bn=False)
    before = _disc_state(pdisc)
    dgot, _ = PV.discriminator_loss(PV.VAEGanLossConfig(**cfg), pvae, pdisc,
                                    torch.from_numpy(x), eps, 0, train_bn=False)
    U.assert_close(dgot, dwant, 1e-4, 1e-6, "discriminator loss, running statistics")
    assert upd == {} and all(torch.equal(before[k], v) for k, v in pdisc.state_dict().items())


def _check_grads(got, want) -> float:
    """Gradients within 1e-4 of each tensor's largest (a tensor whose
    gradient is zero in exact arithmetic, such as a key projection's bias,
    within 1e-6 of the largest of all); returns that largest."""
    scale = max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        U.assert_close(got[k], g.numpy(), 0, 1e-4 * float(g.abs().max()) + 1e-6 * scale, k)
    return scale


def _check_adam_step(after, start, want, jgrads, scale) -> None:
    """Adam's first step is −lr·g/(|g| + 1e-8), ±lr wherever the two
    gradients agree on the sign: every such parameter within 1e-4 of the
    JAX step's. An element whose gradient is below 1e-3 of its tensor's
    largest, or at the rounding level, may take the other sign on one side;
    it still moves by at most lr. Such elements stay under 1 %, and every
    tensor moves."""
    undecided = 0
    for k, g in jgrads.items():
        g, v = g.abs(), after[k]
        decided = (g > 1e-3 * float(g.max())) & (g > 1e-6 * scale)
        U.assert_close(v[decided], want[k][decided].numpy(), 1e-4, 1e-6, k)
        assert bool(((v - start[k])[~decided].abs() <= 1e-4 * (1 + 1e-3)).all()), k
        assert not torch.equal(v, start[k]), f"{k} did not move"
        undecided += int((~decided).sum())
    assert undecided < 0.01 * sum(g.numel() for g in jgrads.values()), undecided


def test_train_steps_match_jax(nets):
    """One ae_step then one disc_step with Adam(1e-4) on both sides: the VAE
    after ae_step, the discriminator after disc_step, the running means
    equal and the running variances n/(n−1) apart; the discriminator's
    parameters and buffers bit-identical across ae_step, the VAE's across
    disc_step."""
    jvae, jdisc, vae_params, disc_vars, _, _, x, rng, eps = nets
    cfg = dict(disc_start=0, perceptual_weight=1.0)
    ae_opt, d_opt = optax.adam(1e-4), optax.adam(1e-4)
    ae_step, disc_step = JV.make_vae_train_steps(JV.VAEGanLossConfig(**cfg), jvae, jdisc,
                                                 ae_opt, d_opt, mse)
    ae_state = {"params": vae_params, "logvar": jnp.zeros(()),
                "opt_state": ae_opt.init(vae_params), "step": jnp.asarray(0)}
    disc_state = {"vars": disc_vars, "opt_state": d_opt.init(disc_vars["params"])}
    ae_state2, jloss, jlog = ae_step(ae_state, disc_state, jnp.asarray(x), rng)
    disc_state2, jdloss, _ = disc_step(ae_state2, disc_state, jnp.asarray(x), rng)

    pvae = U.load_port(PVAE(PDD(**DD), embed_dim=4), convert.vae_from_jax(vae_params))
    pdisc = PDisc(ndf=16, n_layers=2)
    pdisc.load_state_dict(convert.discriminator_from_jax(disc_vars["params"],
                                                         disc_vars["batch_stats"]))
    p_ae_step, p_disc_step = PV.make_vae_train_steps(
        PV.VAEGanLossConfig(**cfg), pvae, pdisc, torch.optim.Adam(pvae.parameters(), lr=1e-4),
        torch.optim.Adam(pdisc.parameters(), lr=1e-4), mse)
    state = {"logvar": torch.zeros(()), "step": 0}
    d0 = _disc_state(pdisc)
    params = dict(pvae.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(PV.generator_loss(
        PV.VAEGanLossConfig(**cfg), pvae, pdisc, state["logvar"], torch.from_numpy(x), eps, 0,
        mse)[0], list(params.values()))))
    jgrads = convert.vae_from_jax(jax.grad(lambda p_: JV.generator_loss(
        JV.VAEGanLossConfig(**cfg), jvae, jdisc, p_, disc_vars, jnp.zeros(()), jnp.asarray(x),
        rng, jnp.asarray(0), mse)[0])(vae_params))
    scale = _check_grads(grads, jgrads)
    loss, log = p_ae_step(state, torch.from_numpy(x), eps)
    assert state["step"] == 1 and int(ae_state2["step"]) == 1
    U.assert_close(loss, jloss, 1e-4, 1e-6, "ae_step loss")
    U.assert_close(log["loss/d_weight"], jlog["loss/d_weight"], 1e-4, 1e-6, "d_weight")
    d1 = _disc_state(pdisc)
    assert all(torch.equal(d0[k], d1[k]) for k in d0), "ae_step changed the discriminator"
    want_vae = convert.vae_from_jax(ae_state2["params"])
    start = convert.vae_from_jax(vae_params)
    _check_adam_step(pvae.state_dict(), start, want_vae, jgrads, scale)

    vae_before = {k: v.clone() for k, v in pvae.state_dict().items()}
    probe = PDisc(ndf=16, n_layers=2)
    probe.load_state_dict(d0)
    params = dict(probe.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(PV.discriminator_loss(
        PV.VAEGanLossConfig(**cfg), pvae, probe, torch.from_numpy(x), eps, 1)[0],
        list(params.values()))))
    jgrads = convert.discriminator_from_jax(jax.grad(lambda p_: JV.discriminator_loss(
        JV.VAEGanLossConfig(**cfg), jvae, jdisc, ae_state2["params"], {**disc_vars, "params": p_},
        jnp.asarray(x), rng, jnp.asarray(1))[0])(disc_vars["params"]), disc_vars["batch_stats"])
    jgrads = {k: v for k, v in jgrads.items() if k in grads}
    scale = _check_grads(grads, jgrads)
    dloss, _ = p_disc_step(state, torch.from_numpy(x), eps)
    U.assert_close(dloss, jdloss, 1e-4, 1e-6, "disc_step loss")
    assert all(torch.equal(vae_before[k], v) for k, v in pvae.state_dict().items())
    want = convert.discriminator_from_jax(disc_state2["vars"]["params"],
                                          disc_state2["vars"]["batch_stats"])
    got = pdisc.state_dict()
    b = x.shape[0]
    for k, v in want.items():
        if k.endswith("running_var"):
            # n = B·H·W of the BatchNorm's input; both passes (real, fake) share it
            idx = int(k.split(".")[1])
            h = pdisc.main[:idx](torch.from_numpy(x).permute(0, 3, 1, 2)).shape[-1]
            n = b * h * h
            v0 = d0[k]
            U.assert_close(got[k] - 0.81 * v0, (n / (n - 1) * (v - 0.81 * v0)).numpy(),
                           1e-4, 1e-6, f"{k}: (torch − 0.81·v0) = n/(n−1)·(jax − 0.81·v0)")
            assert float((got[k] - v).abs().max()) > 1e-4, "the two updates are told apart"
        elif k.endswith("num_batches_tracked"):
            assert int(got[k]) == 2
        elif k.endswith("running_mean"):
            U.assert_close(got[k], v.numpy(), 1e-4, 1e-6, k)
    _check_adam_step({k: got[k] for k in jgrads}, d0, want, jgrads, scale)


def test_functions_match_jax():
    """adopt_weight, the two discriminator losses, the regularizer (both
    forms), measure_perplexity and DiagonalGaussian.nll."""
    rs = np.random.RandomState(3)
    real, fake = rs.randn(2, 4, 4, 1).astype(np.float32), rs.randn(2, 4, 4, 1).astype(np.float32)
    for name in ("hinge_d_loss", "vanilla_d_loss"):
        U.assert_close(getattr(PV, name)(torch.from_numpy(real), torch.from_numpy(fake)),
                       getattr(JV, name)(jnp.asarray(real), jnp.asarray(fake)), 1e-5, 1e-7, name)
    for step in (0, 9, 10, 11):
        assert PV.adopt_weight(2.0, step, 10) == float(JV.adopt_weight(2.0, jnp.asarray(step), 10))
    z = rs.randn(4, 8, 8, 8).astype(np.float32)
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 8, 8, 4)))
    for sample in (False, True):
        want, wlog = JV.diagonal_gaussian_regularizer(jnp.asarray(z), rng=jax.random.PRNGKey(1),
                                                      sample=sample)
        got, glog = PV.DiagonalGaussianRegularizer(sample)(torch.from_numpy(z),
                                                           torch.from_numpy(eps))
        U.assert_close(got, want, 1e-5, 1e-6, f"regularizer sample={sample}")
        U.assert_close(glog["kl_loss"], wlog["kl_loss"], 1e-5, 1e-6, "kl_loss")
    with pytest.raises(ValueError, match="requires the posterior noise"):
        PV.diagonal_gaussian_regularizer(torch.from_numpy(z), sample=True)
    sample = rs.randn(4, 8, 8, 4).astype(np.float32)
    U.assert_close(PGauss(torch.from_numpy(z)).nll(torch.from_numpy(sample)),
                   JGauss(jnp.asarray(z)).nll(jnp.asarray(sample)), 1e-5, 1e-4, "nll")
    for ids in (np.tile(np.arange(4), 8), np.zeros(32, np.int32), rs.randint(0, 7, (3, 5))):
        p, used = PV.measure_perplexity(torch.from_numpy(ids), 8)
        wp, wused = JV.measure_perplexity(jnp.asarray(ids), 8)
        U.assert_close(p, wp, 1e-5, 1e-6, "perplexity")
        assert int(used) == int(wused)


@pytest.mark.parametrize("resize", ["none", "input_to_tgt", "tgt_to_input"])
def test_latent_lpips_loss_matches_jax(resize):
    """Latent L2 and perceptual terms; the bicubic resizes are jax.image's
    (antialiased when shrinking); with perceptual_weight 0 the elementwise L2
    stays."""
    rs = np.random.RandomState(0)
    li, lp = (rs.randn(2, 4, 4, 3).astype(np.float32) for _ in range(2))
    size = {"none": 8, "input_to_tgt": 12, "tgt_to_input": 6}[resize]
    img = rs.randn(2, size, size, 3).astype(np.float32)

    def jdecode(z):
        return jnp.repeat(jnp.repeat(z, 2, axis=1), 2, axis=2)

    def pdecode(z):
        return z.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    for weights in (dict(perceptual_weight=2.0, latent_weight=0.5),
                    dict(perceptual_weight=0.0, perceptual_weight_on_inputs=1.0),
                    dict(perceptual_weight=1.0, perceptual_weight_on_inputs=0.25)):
        kw = dict(weights, split="val", scale_input_to_tgt_size=resize == "input_to_tgt",
                  scale_tgt_to_input_size=resize == "tgt_to_input")
        want, wlog = JV.latent_lpips_loss(jdecode, mse, jnp.asarray(li), jnp.asarray(lp),
                                          image_inputs=jnp.asarray(img), **kw)
        got, glog = PV.latent_lpips_loss(pdecode, mse, torch.from_numpy(li), torch.from_numpy(lp),
                                         image_inputs=torch.from_numpy(img), **kw)
        U.assert_close(got, want, 1e-5, 1e-6, f"loss {weights}")
        assert set(glog) == set(wlog)
        for k in wlog:
            U.assert_close(glog[k], wlog[k], 1e-5, 1e-6, k)


def test_instantiate_from_config_matches_jax():
    """Every reference target of the JAX TARGET_REMAP resolves in the port
    to the counterpart of the same role, and builds the same object."""
    from udifftext_tpu import config as jc
    from udifftext_tpu_torch import builders, config as pc

    assert set(pc.TARGET_REMAP) == set(jc.TARGET_REMAP)
    for target in jc.TARGET_REMAP:
        assert pc.get_obj_from_str(target).__name__ == jc.get_obj_from_str(target).__name__ or \
            target.endswith("DiffusionEngine")
    assert pc.get_obj_from_str("sgm.models.diffusion.DiffusionEngine") is builders.build_engine
    p = "sgm.modules.diffusionmodules."
    edm = {"target": p + "discretizer.EDMDiscretization", "params": {"sigma_max": 10.0}}
    for node in ({"target": p + "discretizer.LegacyDDPMDiscretization"}, edm):
        np.testing.assert_allclose(pc.instantiate_from_config(node)(7),
                                   jc.instantiate_from_config(node)(7), rtol=1e-6)
    node = {"target": p + "sigma_sampling.DiscreteSampling",
            "params": {"num_idx": 100, "discretization_config": edm}}
    np.testing.assert_allclose(pc.instantiate_from_config(node).sigmas,
                               jc.instantiate_from_config(node).sigmas, rtol=1e-6)
    node = {"target": p + "sigma_sampling.EDMSampling", "params": {"p_mean": -1.0}}
    got, want = pc.instantiate_from_config(node), jc.instantiate_from_config(node)
    assert (got.p_mean, got.p_std) == (want.p_mean, want.p_std)
    node = {"target": p + "denoiser.DiscreteDenoiser", "params": {
        "num_idx": 1000, "scaling_config": {"target": p + "denoiser_scaling.VScaling"},
        "weighting_config": {"target": p + "denoiser_weighting.EpsWeighting"}}}
    got, want = pc.instantiate_from_config(node), jc.instantiate_from_config(node)
    assert (got.scaling, got.weighting) == (want.scaling, want.weighting) == ("v", "eps")
    np.testing.assert_allclose(got.sigmas, want.sigmas, rtol=1e-6)
    got = pc.instantiate_from_config({"target": p + "guiders.VanillaCFG",
                                      "params": {"scale": 3.0}})
    assert type(got).__name__ == "VanillaCFG" and got.scale == 3.0
    assert type(pc.instantiate_from_config({"target": p + "guiders.IdentityGuider"})).__name__ \
        == "IdentityGuider"
    z = np.random.RandomState(0).randn(2, 4, 4, 8).astype(np.float32)
    node = {"target": "sgm.modules.autoencoding.regularizers.DiagonalGaussianRegularizer",
            "params": {"sample": False}}
    U.assert_close(pc.instantiate_from_config(node)(torch.from_numpy(z))[0],
                   jc.instantiate_from_config(node)(jnp.asarray(z))[0], 1e-6, 1e-7, "mode")
    bundle = pc.instantiate_from_config({"target": "sgm.models.diffusion.DiffusionEngine",
                                         "params": {"model_cfg": U.tiny_model_cfg(),
                                                    "unet_dtype": torch.float32,
                                                    "device": "cpu"}})
    jb = jc.instantiate_from_config({"target": "sgm.models.diffusion.DiffusionEngine",
                                     "params": {"model_cfg": U.tiny_model_cfg()}})
    assert (bundle.sampler.num_steps, bundle.sampler.cfg_scale) == \
        (jb.sampler.num_steps, jb.sampler.cfg_scale)
    assert type(bundle.engine.denoiser).__name__ == type(jb.engine.denoiser).__name__
    with pytest.raises(KeyError, match="target"):
        pc.instantiate_from_config({"params": {}})
