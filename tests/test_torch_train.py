"""The port's gradient path against the JAX package on the CPU, fp32 on the
tiny model graph: the training pieces (sigma sampling, loss weighting,
local/diffusion/full losses), `engine.loss` and its t_attn/t_norm gradients
with the JAX key's draws injected, the accumulating AdamW step with EMA
against `make_train_step`, the LR schedule, trainable mask and EMA rule,
remat gradients, attend-and-excite sampling with map capture, the train
graph dict and the fine-tuning loop.

Tolerances: 1e-5 relative for single functions (summation order); 1e-4 of
each quantity's magnitude for the loss and gradients of the whole UNet
(fp32 through ~40 layers); 1e-3 for AAE sampling, as for the inference
slice (the initial latent is ~14.6·randn and each AAE update moves it by
up to 20× a gradient).
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_port_util as U
from udifftext_tpu.builders import build_diffusion_engine
from udifftext_tpu.diffusion import loss as JL
from udifftext_tpu.diffusion.denoiser import DiscreteDenoiser as JDenoiser
from udifftext_tpu.diffusion.schedules import DiscreteSampling as JSampling
from udifftext_tpu.parallel import train as JT
from udifftext_tpu_torch.builders import TEXTDESIGN_SD_2_TRAIN, build_engine, randomize_parameters
from udifftext_tpu_torch.diffusion import loss as PL
from udifftext_tpu_torch.diffusion.denoiser import DiscreteDenoiser
from udifftext_tpu_torch.diffusion.schedules import DiscreteSampling
from udifftext_tpu_torch.models.unet import UNetModel
from udifftext_tpu_torch.parallel import train as PT
from udifftext_tpu_torch.train import train
from udifftext_tpu_torch.utils import convert

REPO = Path(__file__).resolve().parent.parent
T = torch.from_numpy


def _seg_batch(b: int, seed: int):
    """numpy_batch plus per-character segmentation maps inside the mask."""
    nb = U.numpy_batch(b, seed=seed)
    rs = np.random.RandomState(seed + 100)
    seg = np.zeros((b, U.IMG, U.IMG, U.SEQ), np.float32)
    for i in range(b):
        for ch in range(3):
            x0 = 7 + 6 * ch + rs.randint(0, 2)
            seg[i, 9 + rs.randint(0, 3):22, x0:x0 + 5, ch] = 1.0
    nb["seg"] = seg
    return nb


# --- training pieces -------------------------------------------------------


def test_discrete_sampling_and_weighting():
    key = jax.random.PRNGKey(3)
    want = np.asarray(JSampling()(key, 64))
    idx = T(np.asarray(jax.random.randint(key, (64,), 0, 1000)).astype(np.int64))
    sampler = DiscreteSampling()
    np.testing.assert_array_equal(sampler(idx).numpy(), want)
    drawn = sampler.draw_idx(4096, torch.Generator().manual_seed(0))
    assert int(drawn.min()) >= 0 and int(drawn.max()) == 999 and len(set(drawn.tolist())) > 900
    sig = sampler(idx)
    U.assert_close(DiscreteDenoiser().w(sig), JDenoiser().w(jnp.asarray(want)), 1e-5, 0, "w")


def _maps(rs, b, l, sizes):
    """Softmax attention maps {name: (B, heads, N, L)} at the given (h, w)."""
    out = {}
    for i, (h, w) in enumerate(sizes):
        logits = rs.standard_normal((b, 2, h * w, l)).astype(np.float32) * 2
        p = np.exp(logits - logits.max(-1, keepdims=True))
        out[f"input_blocks.{i}.1.t_attn"] = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    out["input_blocks.9.1.v_attn"] = out["input_blocks.0.1.t_attn"] * 0  # not a t_attn map
    return out


@pytest.mark.parametrize("img_hw,sizes", [((32, 32), [(16, 16), (8, 8), (4, 4)]),
                                          ((32, 64), [(8, 16), (4, 8)])],
                         ids=["square", "rectangular"])
def test_local_loss_matches_jax(img_hw, sizes):
    rs = np.random.RandomState(7)
    b, l = 2, U.SEQ
    maps = _maps(rs, b, l, sizes)
    seg = (rs.uniform(size=(b,) + img_hw + (l,)) > 0.7).astype(np.float32)
    seg_mask = np.zeros((b, l), np.float32)
    seg_mask[0, :3] = seg_mask[1, :5] = 1.0
    kernel = PL.get_gaussian_kernel(3, 1.0)
    want = JL.local_loss({k: jnp.asarray(v) for k, v in maps.items()}, jnp.asarray(seg),
                         jnp.asarray(seg_mask), jnp.asarray(kernel), 8)
    got = PL.local_loss({k: T(v) for k, v in maps.items()}, T(seg), T(seg_mask), T(kernel), 8)
    U.assert_close(got, want, 1e-5, 1e-6, "local_loss")


def test_diff_loss_matches_jax():
    rs = np.random.RandomState(8)
    out, tgt = (rs.standard_normal((3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    w = rs.uniform(0.5, 2, (3, 1, 1, 1)).astype(np.float32)
    want = JL.diff_loss(jnp.asarray(out), jnp.asarray(tgt), jnp.asarray(w))
    U.assert_close(PL.diff_loss(T(out), T(tgt), T(w)), want, 1e-5, 1e-7, "diff_loss")


def test_full_loss_matches_jax():
    """full_loss through a stand-in network (tanh of the input, fixed maps),
    with the JAX function's own sigma and noise draws injected."""
    rs = np.random.RandomState(9)
    b = 2
    x = rs.standard_normal((b, U.LAT, U.LAT, 4)).astype(np.float32)
    maps = _maps(rs, b, U.SEQ, [(16, 16), (8, 8)])
    nb = _seg_batch(b, 1)
    cfg = JL.FullLossConfig(min_attn_size=8, lambda_local_loss=0.5)
    key = jax.random.PRNGKey(5)
    rng_sigma, rng_noise = jax.random.split(key)
    idx = np.asarray(jax.random.randint(rng_sigma, (b,), 0, 1000)).astype(np.int64)
    noise = np.asarray(jax.random.normal(rng_noise, x.shape))

    def jnet(xx, c_noise, cond):
        return jnp.tanh(xx) + 1e-3 * c_noise[:, None, None, None], {
            k: jnp.asarray(v) for k, v in maps.items()}

    def pnet(xx, c_noise, cond):
        return torch.tanh(xx) + 1e-3 * c_noise[:, None, None, None], {
            k: T(v) for k, v in maps.items()}

    want_loss, want = JL.full_loss(cfg, JDenoiser(), jnet, JSampling(), {}, jnp.asarray(x),
                                   U.to_jax(nb), key)
    pcfg = PL.FullLossConfig(min_attn_size=8, lambda_local_loss=0.5)
    got_loss, got = PL.full_loss(pcfg, DiscreteDenoiser(), pnet, {}, T(x), U.to_torch(nb),
                                 DiscreteSampling()(T(idx)), T(noise))
    assert set(got) == set(want)
    for k in want:
        U.assert_close(got[k], want[k], 1e-5, 1e-7, k)
    U.assert_close(got_loss, want_loss, 1e-5, 1e-7, "loss")


# --- engine.loss against the JAX engine --------------------------------------


@pytest.fixture(scope="module")
def engines():
    cfg = U.tiny_model_cfg()
    je = build_diffusion_engine(cfg, unet_dtype=jnp.float32).engine
    params = U.engine_params(je, seed=13)
    pe = U.load_port(build_engine(cfg, torch.float32, "cpu", train=True).engine,
                     convert.engine_from_jax(params))
    return je, params, pe


def _jax_loss_draws(key, b):
    """engine.loss(key)'s draws on the tiny graph (GeneralConditioner): the
    image posterior from split(key, 3)[0]; the label keep mask from embedder
    0's ucg key folded with 0 and the masked posterior from embedder 2's
    apply key, both split from rng_cond; sigma indices and noise from
    split(rng_loss)."""
    rng_enc, rng_cond, rng_loss = jax.random.split(key, 3)
    shape = (b, U.LAT, U.LAT, 4)
    keys = jax.random.split(rng_cond, 6)
    rng_sigma, rng_noise = jax.random.split(rng_loss)
    return {
        "image_eps": np.asarray(jax.random.normal(rng_enc, shape)),
        "masked_eps": np.asarray(jax.random.normal(keys[4], shape)),
        "ucg_keep": np.asarray(jax.random.bernoulli(jax.random.fold_in(keys[1], 0), 0.9, (b,)),
                               np.float32),
        "sigma_idx": np.asarray(jax.random.randint(rng_sigma, (b,), 0, 1000)).astype(np.int64),
        "noise": np.asarray(jax.random.normal(rng_noise, shape)),
    }


def _assert_no_ties(attn_maps, seg, seg_mask, kernel, min_attn_size):
    """Each valid character's in-seg and out-of-seg maximum over positions
    is reached at one position only, so the local loss's gradient has one
    argmax to go to in both frameworks."""
    seg_l = seg_mask.shape[1]
    for blurred, hw in PL._layer_maps(attn_maps, seg_l, seg.shape[1:3], kernel, min_attn_size):
        s = PL.interpolate_nearest_torch(seg, hw).float().reshape(seg.shape[0], -1, seg_l)
        for v in (s * blurred, (1.0 - s) * blurred):
            ties = (v == v.amax(dim=1, keepdim=True)).sum(dim=1)
            assert bool((ties[seg_mask > 0] == 1).all()), ties


@pytest.mark.parametrize("key_seed", [2, 11])
def test_engine_loss_and_grads_match_jax(engines, key_seed, monkeypatch):
    je, params, pe = engines
    b = 3
    nb = _seg_batch(b, key_seed)
    key = jax.random.PRNGKey(key_seed)
    (want_loss, want), grads = jax.value_and_grad(
        lambda p: je.loss(p, U.to_jax(nb), key), has_aux=True)(params)
    draws = _jax_loss_draws(key, b)

    checked = []

    def checked_local_loss(*args):
        checked.append(True)
        _assert_no_ties(*(a.detach() if isinstance(a, torch.Tensor) else
                          {k: v.detach() for k, v in a.items()} if isinstance(a, dict) else a
                          for a in args))
        return local_loss(*args)

    local_loss = PL.local_loss
    monkeypatch.setattr(PL, "local_loss", checked_local_loss)
    pe.zero_grad(set_to_none=True)
    loss, got = pe.loss(U.to_torch(nb), **{k: T(v) for k, v in draws.items()})
    loss.backward()
    assert checked
    for k in want:
        U.assert_close(got[k], want[k], 1e-4, 1e-4 * abs(float(want[k])), k)
    U.assert_close(loss, want_loss, 1e-4, 0, "loss")

    want_g = convert.unet_from_jax(jax.tree.map(np.asarray, grads["unet"]))
    trained = {n: p for n, p in pe.unet.named_parameters() if p.requires_grad}
    assert trained and all(("t_attn" in n or "t_norm" in n) for n in trained)
    assert all(p.grad is None for p in pe.parameters() if not p.requires_grad)
    for name, p in trained.items():
        w = want_g[name].numpy()
        U.assert_close(p.grad, w, 1e-4, 1e-4 * float(np.abs(w).max()), f"grad {name}")


def test_conditioner_label_dropout(engines):
    _, _, pe = engines
    pb = U.to_torch(_seg_batch(2, 0))
    cond = pe.conditioner
    full = cond(pb)["t_crossattn"]
    dropped = cond(pb, ucg_keep=torch.tensor([1.0, 0.0]))["t_crossattn"]
    assert torch.equal(dropped[0], full[0]) and not dropped[1].any()
    keep = cond.draw_ucg_keep(20000, torch.Generator().manual_seed(0))
    assert abs(float(keep.mean()) - 0.9) < 0.01 and set(keep.unique().tolist()) == {0.0, 1.0}


# --- the optimizer step ----------------------------------------------------


def _named_tree(flat):
    """{"a/b/c": array} → nested dict."""
    out = {}
    for path, v in flat.items():
        node = out
        for seg in path.split("/")[:-1]:
            node = node.setdefault(seg, {})
        node[path.split("/")[-1]] = v
    return out


_LEAVES = ("unet/blocks_0/t_attn/to_q/kernel", "unet/blocks_0/t_norm/scale",
           "unet/blocks_0/attn1/to_q/kernel", "vae/conv/kernel")


class _StandIn(torch.nn.Module):
    """The parameter tree of tests/test_parallel.py's stand-in loss as a
    module, parameters named unet.blocks_0.t_attn.to_q.kernel etc."""

    def __init__(self, values):
        super().__init__()
        for path, v in values.items():
            mod = self
            for seg in path.split("/")[:-1]:
                if not hasattr(mod, seg):
                    mod.add_module(seg, torch.nn.Module())
                mod = getattr(mod, seg)
            mod.register_parameter(path.split("/")[-1], torch.nn.Parameter(T(v.copy())))

    def param(self, path):
        return self.get_parameter(path.replace("/", "."))


def _standin_loss(p, x, y):
    h = x @ p("unet/blocks_0/t_attn/to_q/kernel")
    h = h * p("unet/blocks_0/t_norm/scale")
    h = h @ p("unet/blocks_0/attn1/to_q/kernel")
    h = h @ p("vae/conv/kernel")
    loss = ((h - y) ** 2).mean()
    return loss, {"loss/diff_loss": loss * 0.5, "loss/full_loss": loss}


def test_accumulating_steps_with_ema_match_jax():
    """Two optimizer updates of two micro-batches each, EMA on, LR decaying
    after the first update (steps_per_epoch 1)."""
    rs = np.random.RandomState(0)
    values = {path: (rs.standard_normal((4,) if path.endswith("scale") else (4, 4)) * 0.5 + (
        1.0 if path.endswith("scale") else 0.0)).astype(np.float32) for path in _LEAVES}
    x = rs.standard_normal((8, 4)).astype(np.float32)
    y = rs.standard_normal((8, 4)).astype(np.float32)

    jparams = _named_tree({k: jnp.asarray(v) for k, v in values.items()})

    def jloss(prm, batch, rng):
        def get(path):
            node = prm
            for seg in path.split("/"):
                node = node[seg]
            return node
        return _standin_loss(get, batch["x"], batch["y"])

    opt = JT.make_optimizer(jparams, base_lr=1e-2, steps_per_epoch=1)
    step = JT.make_train_step(jloss, opt, accum_steps=2, use_ema=True, donate=False)
    state = JT.TrainState.create(jparams, opt, use_ema=True)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    jlosses = []
    for _ in range(2):
        state, loss, aux = step(state, batch, jax.random.PRNGKey(0))
        jlosses.append((float(loss), {k: float(v) for k, v in aux.items()}))

    model = _StandIn(values)
    for name, prm in model.named_parameters():
        prm.requires_grad_(PT.trainable_mask([(name, prm)], ("t_attn", "t_norm"))[name])
    pstate = PT.TrainState.create(model, base_lr=1e-2, steps_per_epoch=1, use_ema=True)
    micro = [(T(x[:4]), T(y[:4])), (T(x[4:]), T(y[4:]))]
    for want_loss, want_aux in jlosses:
        loss, aux = PT.train_step(pstate, micro, lambda mb: _standin_loss(model.param, *mb))
        U.assert_close(loss, want_loss, 1e-5, 1e-7, "loss")
        for k, v in want_aux.items():
            U.assert_close(aux[k], v, 1e-5, 1e-7, k)
    assert pstate.step == int(state.step) == 2

    for path in _LEAVES:
        node, ema = state.params, state.ema_params
        for seg in path.split("/"):
            node, ema = node[seg], ema[seg]
        name = path.replace("/", ".")
        got = model.param(path).detach()
        if name in pstate.params:
            U.assert_close(got, node, 1e-5, 1e-6, name)
            U.assert_close(pstate.ema[name], ema, 1e-5, 1e-6, f"ema {name}")
            assert not np.array_equal(got.numpy(), values[path]), f"{name} did not move"
        else:  # frozen: bit-identical, with no gradient and no optimizer state
            np.testing.assert_array_equal(got.numpy(), values[path])
            np.testing.assert_array_equal(np.asarray(node), values[path])
            assert model.param(path).grad is None
    assert set(pstate.params) == {"unet.blocks_0.t_attn.to_q.kernel",
                                  "unet.blocks_0.t_norm.scale"}


def test_trainable_mask_lr_and_ema_match_jax():
    tree = _named_tree({k: jnp.zeros(()) for k in _LEAVES})
    want = JT.trainable_mask(tree, ("t_attn", "t_norm"))
    got = PT.trainable_mask([(k.replace("/", "."), None) for k in _LEAVES], ("t_attn", "t_norm"))
    for path in _LEAVES:
        node = want
        for seg in path.split("/"):
            node = node[seg]
        assert got[path.replace("/", ".")] is bool(node), path

    for spe, steps in ((10, (0, 9, 10, 25)), (3, (0, 2, 3, 7, 100))):
        jsched = JT.epoch_decay_schedule(5e-5, spe)
        psched = PT.epoch_decay_schedule(5e-5, spe)
        for s in steps:
            assert math.isclose(psched(s), float(jsched(s)), rel_tol=1e-6), (spe, s)

    rs = np.random.RandomState(1)
    e, p = (rs.standard_normal((3, 5)).astype(np.float32) for _ in range(2))
    for step, decay in ((0, 0.9999), (7, 0.9999), (100000, 0.999)):
        want = JT.ema_update({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)}, jnp.asarray(step),
                             decay)["w"]
        got = PT.ema_update({"w": T(e.copy())}, {"w": T(p)}, step, decay)["w"]
        U.assert_close(got, want, 1e-6, 1e-7, f"ema step {step}")


# --- remat -----------------------------------------------------------------


def test_unet_remat_grads_equal():
    """Gradient checkpointing recomputes the same forward: the gradients of
    every parameter, and of the input, equal those without it."""
    kw = dict(in_channels=4, out_channels=4, model_channels=32, num_res_blocks=1,
              attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=8,
              t_context_dim=16)
    # seeded random weights: the zero-initialized output convs would zero most gradients
    m0 = randomize_parameters(UNetModel(**kw), 0)
    m1 = UNetModel(remat=True, **kw)
    m1.load_state_dict(m0.state_dict())
    rs = np.random.RandomState(2)
    x = T(rs.standard_normal((2, 16, 16, 4)).astype(np.float32))
    t = torch.tensor([3.0, 500.0])
    tc = T(rs.standard_normal((2, 12, 16)).astype(np.float32))
    grads = []
    for m in (m0, m1):
        xx = x.clone().requires_grad_(True)
        out, maps = m(xx, t, tc, capture_attn=True)
        (out.square().sum() + sum(v.square().sum() for v in maps.values())).backward()
        grads.append([xx.grad] + [p.grad for p in m.parameters()])
    for a, b in zip(*grads):
        U.assert_close(a, b.numpy(), 1e-6, 1e-7, "remat grad")


# --- attend-and-excite -------------------------------------------------------


@pytest.mark.parametrize("steps", [3, 6], ids=["mandatory_updates", "iterating_step_5"])
def test_sample_aae_detailed_matches_jax(engines, steps):
    """sample(aae_enabled, detailed) against the JAX engine with its own
    draws: the image, every step's decoded intermediate, the per-step local
    losses and the middle step's maps. At 6 steps, step 5 iterates (its
    loss stays above −0.5 with random weights, so 20 more updates)."""
    je, params, pe = engines
    nb = _seg_batch(1, 4)
    key = jax.random.PRNGKey(31)
    want_img, want = je.sample(params, U.to_jax(nb), key, num_steps=steps, cfg_scale=5.0,
                               noise_iters=0, aae_enabled=True, detailed=True)
    rng_cond, rng_noise = jax.random.split(key)
    shape = (1, U.LAT, U.LAT, 4)
    eps = np.asarray(jax.random.normal(jax.random.split(rng_cond, 6)[4], shape))
    x0 = np.asarray(jax.random.normal(rng_noise, shape))[None]

    pe.zero_grad(set_to_none=True)
    before = pe.unet.input_blocks[1][1].transformer_blocks[0].t_attn.to_q.weight.clone()
    img, aux = pe.sample(U.to_torch(nb), num_steps=steps, cfg_scale=5.0, noise_iters=0,
                         aae_enabled=True, detailed=True, posterior_eps=T(eps), noise=T(x0))
    assert torch.equal(before, pe.unet.input_blocks[1][1].transformer_blocks[0].t_attn.to_q.weight)
    assert all(p.grad is None for p in pe.parameters())
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(aux) == set(want)
    assert aux["inters"].shape == (steps, U.IMG, U.IMG, 3)
    assert aux["local_losses"].shape == (steps, 1)
    assert sum(k.endswith("t_attn") for k in aux) == 7  # every attention layer
    for k, v in want.items():
        U.assert_close(aux[k], v, 1e-3, 1e-3, k)
    U.assert_close(img, want_img, 1e-3, 1e-3, "image")


def test_aae_iteration_count(engines, monkeypatch):
    """One mandatory update per step; at an enabled step, more while the
    loss before the last update is above the threshold, at most 20."""
    _, _, pe = engines
    nb = U.to_torch(_seg_batch(1, 4))
    c, _ = pe.conditionings(nb, torch.zeros(1, U.LAT, U.LAT, 4))
    kv = pe.unet.precompute_context_kv(c["t_crossattn"])
    calls = []
    orig = PL.min_local_loss

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    import udifftext_tpu_torch.engine as E
    monkeypatch.setattr(E, "min_local_loss", counted)
    x = torch.randn(1, U.LAT, U.LAT, 4, generator=torch.Generator().manual_seed(0))
    sigma = torch.tensor([5.0])
    for enabled, thres, want in ((False, -9.0, 1), (True, 9.0, 1), (True, -9.0, 21)):
        calls.clear()
        with torch.no_grad():
            out = pe._aae_update(c, nb, x, sigma, 2.0, enabled, thres, kv)
        assert len(calls) == want, (enabled, thres)
        assert not out.requires_grad and not torch.equal(out, x)


# --- the train graph and the loop ---------------------------------------------


def test_train_graph_dict_equals_yaml():
    with open(REPO / "configs" / "train" / "textdesign_sd_2.yaml") as f:
        assert yaml.safe_load(f)["model"]["params"] == TEXTDESIGN_SD_2_TRAIN


def test_build_engine_train_weights():
    cfg = U.tiny_model_cfg()
    pe = build_engine(cfg, torch.bfloat16, "cpu", train=True).engine
    for name, p in pe.named_parameters():
        trains = name.startswith("unet.") and ("t_attn" in name or "t_norm" in name)
        assert p.requires_grad is trains, name
        if trains:
            assert p.dtype == torch.float32, name
    assert pe.unet.input_blocks[1][1].transformer_blocks[0].attn1.to_q.weight.dtype == \
        torch.bfloat16
    frozen = build_engine(cfg, torch.bfloat16, "cpu").engine
    assert not any(p.requires_grad for p in frozen.parameters())
    assert pe.ucg_rate_label == 0.1 and pe.loss_cfg.lambda_local_loss == 0.01
    assert pe.loss_cfg.min_attn_size == 8 and pe.sigma_sampler.num_idx == 1000


def test_train_loop(tmp_path, capsys):
    """The loop groups micro-batches by accumulate_grad_batches, logs every
    component, drops the incomplete group at each epoch's end, stops after
    max_epochs, and trains only t_attn/t_norm."""
    cfg = U.tiny_model_cfg()
    bundle = build_engine(cfg, torch.float32, "cpu", train=True)
    randomize_parameters(bundle.engine, 0)
    before = {n: p.detach().clone() for n, p in bundle.engine.named_parameters()}
    batches = [{**_seg_batch(2, i), "label": np.array(["abc"] * 2, dtype=object)}
               for i in range(5)]
    cfgs = {"base_learning_rate": 1e-3, "use_ema": True, "log_dir": str(tmp_path),
            "lightning": {"accumulate_grad_batches": 2, "max_epochs": 2}}
    state = train(cfgs, batches, bundle, seed=7, log_every=1)
    out = capsys.readouterr().out
    assert "seed: 7" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("epoch ")]
    assert [ln.split()[:4] for ln in lines] == [["epoch", "0", "step", "1"],
                                               ["epoch", "0", "step", "2"],
                                               ["epoch", "1", "step", "3"],
                                               ["epoch", "1", "step", "4"]]
    for comp in ("diff_loss", "local_loss", "full_loss"):
        assert comp in lines[0]
    assert state.step == 4 and state.schedule(2) == pytest.approx(1e-3 * 0.95)
    assert (tmp_path / "train_metrics.csv").exists()
    assert len((tmp_path / "train_metrics.jsonl").read_text().splitlines()) == 4
    for n, p in bundle.engine.named_parameters():
        if p.requires_grad:
            assert not torch.equal(p, before[n]), n
        else:
            assert torch.equal(p, before[n]) and p.grad is None, n
