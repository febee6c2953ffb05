"""The port's conditioning surface against the JAX package on the CPU, fp32:
the UNet's ctrl block, label embedding and scale-shift norm; the
GeneralConditioner on an option graph (the tiny model graph of
tests/test_cli_scripts.py with use_label, a trainable ClassEmbedder, a
ConcatTimestepEmbedderND, a trainable remapping SpatialRescaler of three
stages feeding the ctrl block, and scale-shift norm); every function of
embedders.py; `engine.sample`, `engine.loss` and its gradients on that
graph with the JAX key's draws injected; the trainable mask and one
training step; `build_engine`'s refusals.

Tolerances: 1e-5 relative for single modules and the conditioner (fp32,
summation order); 1e-4 of each quantity's magnitude for the loss and the
gradients through the whole UNet; 1e-3 for sampling, as for the inference
slice (tests/test_torch_engine.py).
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from test_torch_train import _assert_no_ties, _seg_batch
from udifftext_tpu import conditioning as JC
from udifftext_tpu import embedders as JE
from udifftext_tpu.builders import build_diffusion_engine
from udifftext_tpu.models.unet import UNetModel as JUNet
from udifftext_tpu.parallel import train as JT
from udifftext_tpu_torch import conditioning as PC
from udifftext_tpu_torch import embedders as PE
from udifftext_tpu_torch import loading
from udifftext_tpu_torch.builders import build_engine
from udifftext_tpu_torch.diffusion import loss as PL
from udifftext_tpu_torch.models.unet import UNetModel as PUNet
from udifftext_tpu_torch.parallel import train as PT
from udifftext_tpu_torch.predict import Predictor
from udifftext_tpu_torch.train import batch_keys
from udifftext_tpu_torch.utils import convert

T = torch.from_numpy
_M = "sgm.modules.encoders.modules."
HINT = 128  # three halvings of the hint reach the 16² latent
N_EMB = 6


def options_cfg(method: str = "bilinear"):
    """The option graph: vector 16 + 2·8 = 32 = adm_in_channels; concat
    mask (1) + latent (4) + hint (3), so the UNet reads 9 + 3 channels."""
    cfg = U.tiny_model_cfg()
    cfg["network_config"]["params"].update(ctrl_channels=3, use_label=1, adm_in_channels=32,
                                           use_scale_shift_norm=True)
    cfg["conditioner_config"]["params"]["emb_models"] += [
        {"is_trainable": True, "ucg_rate": 0.1, "input_key": "cls",
         "target": _M + "ClassEmbedder", "params": {"embed_dim": 16, "n_classes": 10}},
        {"ucg_rate": 0.5, "input_key": "size", "target": _M + "ConcatTimestepEmbedderND",
         "params": {"outdim": 8}},
        {"is_trainable": True, "input_key": "hint", "target": _M + "SpatialRescaler",
         "params": {"in_channels": 3, "multiplier": 0.5, "n_stages": 3, "out_channels": 3,
                    "method": method}},
    ]
    return cfg


def options_batch(b: int, seed: int):
    nb = _seg_batch(b, seed)
    rs = np.random.RandomState(seed + 7)
    nb["cls"] = rs.randint(0, 9, (b,)).astype(np.int32)
    nb["size"] = rs.choice([256.0, 384.0, 512.0], (b, 2)).astype(np.float32)
    nb["hint"] = rs.uniform(-1, 1, (b, HINT, HINT, 3)).astype(np.float32)
    return nb


def jax_params(je, seed: int):
    """Seeded random params of every collection of the option graph's JAX
    engine, the conditioner's embedders included."""
    u = je.unet
    params = {
        "unet": U.flax_params(u, seed,
                              jnp.zeros((1, U.LAT, U.LAT, u.in_channels + u.ctrl_channels)),
                              jnp.zeros((1,)), jnp.zeros((1, U.SEQ, u.t_context_dim)), None,
                              jnp.zeros((1, u.adm_in_channels))),
        "vae": U.flax_params(je.vae, seed + 1, jnp.zeros((1, U.IMG, U.IMG, 3))),
        "label_encoder": U.flax_params(je.label_encoder, seed + 2,
                                       jnp.zeros((1, U.SEQ), jnp.int32)),
    }
    params["embedders"] = U.random_like_flax(
        jax.eval_shape(je.general_conditioner.init_params, jax.random.PRNGKey(0)), seed + 3)
    return params


def make_engines(method: str = "bilinear", seed: int = 21, train: bool = False):
    cfg = options_cfg(method)
    je = build_diffusion_engine(cfg, unet_dtype=jnp.float32).engine
    params = jax_params(je, seed)
    pe = U.load_port(build_engine(cfg, torch.float32, "cpu", train=train).engine,
                     convert.engine_from_jax(params))
    return je, params, pe


@pytest.fixture(scope="module")
def engines():
    return make_engines(train=True)


def cond_draws(rng_cond, b: int, train: bool):
    """The GeneralConditioner's draws for rng_cond: split(rng_cond, 2n);
    embedder i applies with key 2i (the LatentEncoder, embedder 2, samples
    its posterior with it) and drops output j with fold_in(key 2i + 1, j)."""
    keys = jax.random.split(rng_cond, 2 * N_EMB)
    eps = np.asarray(jax.random.normal(keys[4], (b, U.LAT, U.LAT, 4)))
    keep = {}
    if train:
        for i, rate in ((0, 0.1), (3, 0.1), (4, 0.5)):
            keep[(i, 0)] = T(np.asarray(jax.random.bernoulli(
                jax.random.fold_in(keys[2 * i + 1], 0), 1.0 - rate, (b,)), np.float32))
    return T(eps), keep


# --- the UNet options -------------------------------------------------------


def test_unet_ctrl_label_scale_shift_match_jax():
    """tests/test_engine.py:263's UNet with the scale-shift norm too."""
    kw = dict(in_channels=4, ctrl_channels=3, out_channels=4, model_channels=32,
              num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
              num_head_channels=8, t_context_dim=16, use_label=1, adm_in_channels=8,
              use_scale_shift_norm=True)
    jm = JUNet(**kw, attn_impl="xla")
    params = U.flax_params(jm, 5, jnp.zeros((1, 16, 16, 7)), jnp.zeros((1,)),
                           jnp.zeros((1, 12, 16)), None, jnp.zeros((1, 8)))
    sd = convert.unet_from_jax(params)
    assert {"label_emb.0.0.weight", "label_emb.0.2.bias", "ctrl_block.0.weight",
            "ctrl_block.12.weight", "ctrl_block.14.weight"} <= set(sd)
    pm = U.load_port(PUNet(**kw), sd)
    assert tuple(pm.input_blocks[1][0].emb_layers[1].weight.shape) == (64, 128)
    rs = np.random.RandomState(6)
    x = rs.standard_normal((2, 16, 16, 7)).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    tc = rs.standard_normal((2, 12, 16)).astype(np.float32)
    y = rs.standard_normal((2, 8)).astype(np.float32)
    want, _ = jm.apply(params, x, t, tc, None, y)
    with torch.no_grad():
        got, _ = pm(T(x), T(t), T(tc), None, T(y))
    U.assert_close(got, want, 1e-5, 1e-5 * float(np.abs(want).max()), "unet")
    # the hint moves the output; y is required
    with torch.no_grad():
        x2 = x.copy()
        x2[..., 4:] = 0
        assert not torch.allclose(pm(T(x2), T(t), T(tc), None, T(y))[0], got)
        with pytest.raises(ValueError, match="pass y"):
            pm(T(x), T(t), T(tc))
        # encoder propagation refuses the ctrl block, as JAX asserts
        with pytest.raises(NotImplementedError, match="ctrl"):
            pm.forward_cached(T(x), T(t), T(tc), None, T(y))
        with pytest.raises(NotImplementedError, match="ctrl"):
            pm.decode_cached((), T(t), T(tc), None, T(y))


# --- resizing and the embedders ----------------------------------------------


@pytest.mark.parametrize("method", ["bilinear", "nearest", "bicubic"])
@pytest.mark.parametrize("mult", [0.125, 0.5, 0.3, 2.0])
def test_spatial_rescale_matches_jax(method, mult):
    x = np.random.RandomState(1).standard_normal((2, 40, 24, 3)).astype(np.float32)
    want = JC.spatial_rescale(jnp.asarray(x), mult, method=method)
    U.assert_close(PC.spatial_rescale(T(x), mult, method), want, 1e-5, 1e-5, method)


def _embedder_params(module, seed, *args):
    return U.flax_params(module, seed, *args)


def test_class_embedder_matches_jax():
    jm = JE.ClassEmbedder(embed_dim=16, n_classes=10, ucg_rate=0.3)
    params = _embedder_params(jm, 1, jnp.zeros((1,), jnp.int32))
    pm = PE.ClassEmbedder(16, 10, ucg_rate=0.3)
    pm.load_state_dict({k.split(".", 2)[2]: v for k, v in
                        convert.embedders_from_jax({"0_ClassEmbedder": params}).items()})
    c = np.array([1, 2, 5, 7, 0, 3], np.int32)
    U.assert_close(pm(T(c)), jm.apply(params, jnp.asarray(c)), 1e-6, 0, "plain")
    key = jax.random.PRNGKey(4)
    keep = np.asarray(jax.random.bernoulli(key, 0.7, c.shape))
    assert 0 < keep.sum() < len(c)
    U.assert_close(pm(T(c), keep=T(keep)), jm.apply(params, jnp.asarray(c), rng=key), 1e-6, 0,
                   "dropped ids take the last class")
    # from a generator: the dropped rows equal the last class's
    out = pm(T(c), torch.Generator().manual_seed(0))
    last = pm.embedding.weight[9]
    dropped = (out == last).all(dim=1)
    assert bool(dropped.any()) and out.shape == (6, 16)
    seq = PE.ClassEmbedder(8, 4, add_sequence_dim=True)
    assert tuple(seq(torch.zeros(3, dtype=torch.int64)).shape) == (3, 1, 8)


@pytest.mark.parametrize("shape", [(3,), (3, 2), (2, 4)])
def test_concat_timestep_embedder_matches_jax(shape):
    x = np.random.RandomState(2).uniform(0, 1000, shape).astype(np.float32)
    want = JE.concat_timestep_embedder_nd(jnp.asarray(x), 8)
    U.assert_close(PE.concat_timestep_embedder_nd(T(x), 8), want, 1e-5, 1e-5, "nd")
    U.assert_close(PE.ConcatTimestepEmbedderND(8)(T(x)), want, 1e-5, 1e-5, "module")


@pytest.mark.parametrize("flatten", [True, False])
def test_gaussian_encode_matches_jax(flatten):
    rs = np.random.RandomState(3)
    moments = rs.standard_normal((2, 4, 4, 6)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    eps = np.asarray(jax.random.normal(key, (2, 4, 4, 3)))
    for rng, e in ((None, None), (key, eps)):
        wz, wkl = JE.gaussian_encode(jnp.asarray(moments), rng=rng, flatten=flatten)
        gz, gkl = PE.gaussian_encode(T(moments), None if e is None else T(e), flatten=flatten)
        U.assert_close(gz, wz, 1e-5, 1e-6, "z")
        U.assert_close(gkl, wkl, 1e-5, 1e-5, "kl")


@pytest.mark.parametrize("method,n_stages,kernel_size",
                         [("bilinear", 1, 1), ("nearest", 2, 1), ("bicubic", 3, 3),
                          ("bicubic", 1, 1)])
def test_spatial_rescaler_remap_matches_jax(method, n_stages, kernel_size):
    jm = JE.SpatialRescalerRemap(multiplier=0.5, out_channels=4, method=method,
                                 n_stages=n_stages, kernel_size=kernel_size)
    params = _embedder_params(jm, 2, jnp.zeros((1, 16, 16, 3)))
    pm = PE.SpatialRescalerRemap(0.5, 4, method, n_stages, kernel_size, in_channels=3)
    pm.load_state_dict({k.split(".", 2)[2]: v for k, v in
                        convert.embedders_from_jax({"0_S": params}).items()}, strict=True)
    x = np.random.RandomState(4).standard_normal((2, 40, 32, 3)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        U.assert_close(pm(T(x)), want, 1e-5, 1e-5, method)
    # without out_channels it only resizes
    plain = JE.SpatialRescalerRemap(multiplier=0.5, method=method, n_stages=n_stages)
    U.assert_close(PE.SpatialRescalerRemap(0.5, None, method, n_stages)(T(x)),
                   plain.apply({}, jnp.asarray(x)), 1e-5, 1e-5, method + " no remap")


def test_low_scale_encoder_matches_jax():
    enc_j = JE.LowScaleEncoder(scale_factor=0.5, max_noise_level=10, out_size=8)
    enc_p = PE.LowScaleEncoder(scale_factor=0.5, max_noise_level=10, out_size=8)
    z = np.random.RandomState(5).standard_normal((3, 16, 12, 4)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want_z, want_t = enc_j(key, jnp.asarray(z))
    rng_t, rng_n = jax.random.split(key)
    t = np.asarray(jax.random.randint(rng_t, (3,), 0, 10))
    noise = np.asarray(jax.random.normal(rng_n, z.shape))
    got_z, got_t = enc_p(T(z), t=T(t), noise=T(noise))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    U.assert_close(got_z, want_z, 1e-5, 1e-6, "z")
    z2, t2 = enc_p(T(z), torch.Generator().manual_seed(0))
    assert tuple(z2.shape) == (3, 8, 8, 4) and int(t2.max()) < 10


def test_identity_stages():
    x = torch.ones(2, 3)
    fs, enc = PE.IdentityFirstStage(), PE.IdentityEncoder()
    assert fs.encode(x) is x and fs.decode(x) is x and enc(x) is x and enc.encode(x) is x


def test_inception_embedder_matches_jax(tmp_path):
    from udifftext_tpu.models.inception import FIDInceptionV3 as JInception

    tree = U.flax_params(JInception(resize_input=False), 4, jnp.zeros((1, 75, 75, 3)))["params"]
    tree = jax.tree_util.tree_map_with_path(
        lambda p, v: np.abs(v) + 0.5 if p[-1].key == "bn_var" else v, tree)
    jemb = JE.InceptionV3Embedder()
    jemb.params = {"params": tree}
    path = tmp_path / "fid.pt"
    torch.save(convert.inception_from_jax(tree), path)
    pemb = PE.InceptionV3Embedder(weights_path=str(path), device="cpu")
    x = np.random.RandomState(7).uniform(-1, 1, (2, 64, 48, 3)).astype(np.float32)
    want = np.asarray(jemb(jnp.asarray(x)))
    with torch.no_grad():
        got = pemb(T(x))
    assert got.shape == (2, 2048)
    U.assert_close(got, want, 0, 1e-4 * float(np.abs(want).max()), "pool3")


class _Out:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _stub_transformers(calls):
    """A stand-in `transformers` whose classes record how they were loaded:
    token ids are the texts' lengths, hidden states their ids as floats."""

    class Tok:
        @classmethod
        def from_pretrained(cls, version, **kw):
            calls.append((cls.__name__, version, kw))
            return cls()

        def __call__(self, texts, truncation, max_length, padding, return_tensors):
            assert truncation and padding == "max_length" and return_tensors == "pt"
            ids = torch.tensor([[len(t)] * max_length for t in texts])
            return {"input_ids": ids}

    class Model(torch.nn.Module):
        @classmethod
        def from_pretrained(cls, version, **kw):
            calls.append((cls.__name__, version, kw))
            return cls()

        def forward(self, input_ids, output_hidden_states=False):
            h = input_ids.float()[..., None].expand(-1, -1, 3)
            return _Out(last_hidden_state=h, pooler_output=h[:, 0] + 1,
                        hidden_states=(h - 2, h - 1, h))

    mod = types.ModuleType("transformers")
    for name in ("CLIPTokenizer", "T5Tokenizer", "ByT5Tokenizer"):
        setattr(mod, name, type(name, (Tok,), {}))
    for name in ("CLIPTextModel", "T5EncoderModel"):
        setattr(mod, name, type(name, (Model,), {}))
    return mod


def test_frozen_text_encoders(monkeypatch):
    """Without transformers every loader raises RuntimeError, as the JAX
    ones do; with it, models and tokenizers load from local files only."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    for load in (PE.load_frozen_clip_text_embedder, PE.load_frozen_t5_embedder,
                 PE.load_frozen_byt5_embedder, JE.load_frozen_clip_text_embedder,
                 JE.load_frozen_t5_embedder, JE.load_frozen_byt5_embedder):
        with pytest.raises(RuntimeError, match="transformers"):
            load()
    calls = []
    monkeypatch.setitem(sys.modules, "transformers", _stub_transformers(calls))
    texts = ["ab", "abcd"]
    last = PE.load_frozen_clip_text_embedder(max_length=5, device="cpu")(texts)
    assert tuple(last.shape) == (2, 5, 3) and float(last[1, 0, 0]) == 4
    assert float(PE.load_frozen_clip_text_embedder(layer="pooled", device="cpu")(texts)[0, 0, 0]) == 3
    assert float(PE.load_frozen_clip_text_embedder(layer="penultimate", device="cpu")(texts)[0, 0, 0]) == 1
    assert tuple(PE.load_frozen_t5_embedder(max_length=4, device="cpu")(texts).shape) == (2, 4, 3)
    assert tuple(PE.load_frozen_byt5_embedder(max_length=6, device="cpu")(texts).shape) == (2, 6, 3)
    assert calls and all(kw == {"local_files_only": True} for _, _, kw in calls)


# --- the GeneralConditioner -------------------------------------------------


@pytest.mark.parametrize("method", ["bilinear", "nearest", "bicubic"])
def test_general_conditioner_matches_jax(method):
    je, params, pe = make_engines(method, seed=30)
    jgc, pgc = je.general_conditioner, pe.general_conditioner
    assert [s.name for s in pgc.specs] == [s.name for s in jgc.embedders]
    assert pgc.trainable_embedders == jgc.trainable_embedders == ("3_ClassEmbedder",
                                                                   "5_SpatialRescaler")
    b = 3
    nb = options_batch(b, 2)
    key = jax.random.PRNGKey(9)
    for train in (True, False):
        want = jgc(params, U.to_jax(nb), rng=key, train=train)
        eps, keep = cond_draws(key, b, train)
        with torch.no_grad():
            got = pgc(U.to_torch(nb), eps, train=train, ucg_keep=keep)
        assert set(got) == set(want) == {"t_crossattn", "concat", "vector"}
        assert tuple(got["vector"].shape) == (b, 32) and tuple(got["concat"].shape) == (
            b, U.LAT, U.LAT, 8)
        for k in want:
            U.assert_close(got[k], want[k], 1e-5, 1e-5 * float(np.abs(want[k]).max()),
                           f"{k} train={train}")
    # (c, uc): the label embedding zeroed in uc, one posterior draw for both
    jc, juc = jgc.get_unconditional_conditioning(params, U.to_jax(nb), rng=key)
    eps, _ = cond_draws(key, b, False)
    with torch.no_grad():
        pc_, puc = pe.conditionings(U.to_torch(nb), eps)
        pc2, puc2 = pgc.get_unconditional_conditioning(U.to_torch(nb), eps,
                                                       batch_uc=U.to_torch(nb))
    for want, got in ((jc, pc_), (juc, puc), (jc, pc2), (juc, puc2)):
        for k in want:
            U.assert_close(got[k], want[k], 1e-5, 1e-5 * float(np.abs(want[k]).max()), k)
    assert float(puc["t_crossattn"].abs().max()) == 0.0
    # draws from a generator: the keep masks in list order, then the same call
    keep = pgc.draw_ucg_keep(b, torch.Generator().manual_seed(0))
    assert sorted(keep) == [(0, 0), (3, 0), (4, 0)]
    with torch.no_grad():
        a = pgc(U.to_torch(nb), generator=torch.Generator().manual_seed(1), train=True)
        c = pgc(U.to_torch(nb), generator=torch.Generator().manual_seed(1), train=True)
    assert all(torch.equal(a[k], c[k]) for k in a)


def test_init_params_and_keys(engines):
    _, _, pe = engines
    gc = pe.general_conditioner
    before = {k: v.clone() for k, v in gc.state_dict().items()}
    saved = {k: v.clone() for k, v in pe.state_dict().items()}
    try:
        first = gc.init_params(3)
        again = gc.init_params(3)
        assert sorted(first) == ["3_ClassEmbedder", "5_SpatialRescaler"]
        assert all(torch.equal(first[n][k], again[n][k]) for n in first for k in first[n])
        assert any(not torch.equal(v, gc.state_dict()[k]) for k, v in before.items())
    finally:
        pe.load_state_dict(saved)
    assert set(gc.state_dict()) == {"embedders.3.embedding.weight",
                                    "embedders.5.channel_mapper.weight"}
    assert gc.input_keys == ("label_ids", "mask", "masked", "cls", "size", "hint")
    assert set(batch_keys(pe)) >= {"cls", "size", "hint", "image", "seg"}


# --- the engine on the option graph -------------------------------------------


def test_engine_sample_matches_jax(engines, tmp_path, monkeypatch):
    """Batched init-noise search (2 candidates) and 3 CFG steps through the
    Predictor, which keeps the embedders' keys; the JAX engine's draws."""
    je, params, pe = engines
    b, k, steps = 2, 2, 3
    nb = options_batch(b, 4)
    key = jax.random.PRNGKey(12)
    want, _ = je.sample(params, U.to_jax(nb), key, num_steps=steps, cfg_scale=5.0,
                        noise_iters=k, noise_search_batched=True)
    rng_cond, rng_noise = jax.random.split(key)
    eps, _ = cond_draws(rng_cond, b, False)
    shape = (b, U.LAT, U.LAT, 4)
    noise = np.stack([np.asarray(jax.random.normal(kk, shape))
                      for kk in jax.random.split(rng_noise, k)])
    pred = Predictor(pe, num_steps=steps, cfg_scale=5.0, noise_iters=k,
                     noise_search_batched=True)
    assert {"cls", "size", "hint"} <= set(pred.array_batch(nb))
    got, aux = pred(nb, posterior_eps=eps, noise=T(noise))
    U.assert_close(got, want, 1e-3, 1e-3, "images")
    # encoder propagation refuses the ctrl graph before any work
    monkeypatch.setenv("UDIFFTEXT_ENCPROP_REPORTS", str(tmp_path))
    with pytest.raises(NotImplementedError, match="ctrl"):
        Predictor(pe, num_steps=steps, noise_iters=k, encprop_interval=2)(nb)


@pytest.mark.parametrize("key_seed", [3])
def test_engine_loss_and_grads_match_jax(engines, key_seed, monkeypatch):
    """engine.loss and its gradients (UNet t_attn/t_norm and both trainable
    embedders) with the JAX key's draws injected."""
    je, params, pe = engines
    b = 3
    nb = options_batch(b, key_seed)
    key = jax.random.PRNGKey(key_seed)
    (want_loss, want), grads = jax.jit(jax.value_and_grad(
        lambda p: je.loss(p, U.to_jax(nb), key), has_aux=True))(params)
    rng_enc, rng_cond, rng_loss = jax.random.split(key, 3)
    shape = (b, U.LAT, U.LAT, 4)
    masked_eps, keep = cond_draws(rng_cond, b, True)
    rng_sigma, rng_noise = jax.random.split(rng_loss)
    draws = dict(image_eps=T(np.asarray(jax.random.normal(rng_enc, shape))),
                 masked_eps=masked_eps, ucg_keep=keep,
                 sigma_idx=T(np.asarray(jax.random.randint(rng_sigma, (b,), 0, 1000)
                                        ).astype(np.int64)),
                 noise=T(np.asarray(jax.random.normal(rng_noise, shape))))
    checked = []
    local_loss = PL.local_loss

    def checked_local_loss(*args):
        checked.append(True)
        _assert_no_ties(*(a.detach() if isinstance(a, torch.Tensor) else
                          {k: v.detach() for k, v in a.items()} if isinstance(a, dict) else a
                          for a in args))
        return local_loss(*args)

    monkeypatch.setattr(PL, "local_loss", checked_local_loss)
    pe.zero_grad(set_to_none=True)
    loss, got = pe.loss(U.to_torch(nb), **draws)
    loss.backward()
    assert checked
    for k in want:
        U.assert_close(got[k], want[k], 1e-4, 1e-4 * abs(float(want[k])), k)
    U.assert_close(loss, want_loss, 1e-4, 0, "loss")
    want_g = {f"unet.{k}": v for k, v in
              convert.unet_from_jax(jax.tree.map(np.asarray, grads["unet"])).items()}
    want_g.update({f"general_conditioner.{k}": v for k, v in convert.embedders_from_jax(
        jax.tree.map(np.asarray, grads["embedders"])).items()})
    trained = {n: p for n, p in pe.named_parameters() if p.requires_grad}
    assert {"general_conditioner.embedders.3.embedding.weight",
            "general_conditioner.embedders.5.channel_mapper.weight"} <= set(trained)
    assert all(p.grad is None for p in pe.parameters() if not p.requires_grad)
    for name, p in trained.items():
        w = want_g[name].numpy()
        U.assert_close(p.grad, w, 1e-4, 1e-4 * float(np.abs(w).max()), f"grad {name}")


def test_trainable_mask_and_step(engines):
    """The trainable parameters are JAX's trainable_mask with the graph's
    trainable_embedders; one AdamW step moves them (every row of the class
    table: decoupled weight decay) and nothing else."""
    je, params, pe = engines
    mask = JT.trainable_mask(params, ("t_attn", "t_norm"),
                             trainable_embedders=je.general_conditioner.trainable_embedders)
    want = {k for k, v in convert.engine_from_jax(
        jax.tree.map(lambda m: np.float32(m), mask)).items() if float(v) == 1.0}
    got = {n for n, p in pe.named_parameters() if p.requires_grad}
    # JAX's substring match also takes "t_norm" inside flax's "out_norm" (every
    # ResBlock's second GroupNorm and the UNet's last one); the reference names
    # them out_layers.0 / out.0 and trains neither, nor does the port
    jax_only = want - got
    assert jax_only and all(n.endswith(("out_layers.0.weight", "out_layers.0.bias"))
                            or n in ("unet.out.0.weight", "unet.out.0.bias") for n in jax_only)
    assert got <= want and any(n.startswith("general_conditioner.") for n in got)
    assert PT.trainable_mask([("general_conditioner.embedders.3.embedding.weight", None),
                              ("general_conditioner.embedders.35.x", None)], (),
                             ("3_ClassEmbedder",)) == {
        "general_conditioner.embedders.3.embedding.weight": True,
        "general_conditioner.embedders.35.x": False}
    saved = {k: v.clone() for k, v in pe.state_dict().items()}
    try:
        state = PT.TrainState.create(pe, base_lr=1e-2)
        nb = options_batch(2, 8)
        batch = {k: T(v) for k, v in nb.items()}
        PT.train_step(state, [batch], lambda mb: pe.loss(mb, torch.Generator().manual_seed(0)))
        after = pe.state_dict()
        moved = {k for k in saved if not torch.equal(saved[k], after[k])}
        assert moved == got
        table = "general_conditioner.embedders.3.embedding.weight"
        assert bool((saved[table] != after[table]).any(dim=1).all())
    finally:
        pe.load_state_dict(saved)


def test_trainable_embedders_need_every_self_attention_backward(monkeypatch):
    """The shipped graph trains nothing upstream of the first self-attention,
    so its backward is skipped there; the option graph's trainable
    embedders feed the time embedding and the ctrl block, so every
    self-attention of the loss needs its backward (chip_smoke.py phase 16
    counts the flash backward 10 a micro-batch against phase 6's 9)."""
    import udifftext_tpu_torch.models.attention as PA

    seen = []
    sdpa = PA.sdpa

    def spy(q, k, v, *args, **kw):
        if q.shape[1] == k.shape[1]:  # a self-attention
            seen.append(q.requires_grad or k.requires_grad or v.requires_grad)
        return sdpa(q, k, v, *args, **kw)

    monkeypatch.setattr(PA, "sdpa", spy)
    got = {}
    for name, cfg in (("shipped", U.tiny_model_cfg()), ("options", options_cfg())):
        engine = build_engine(cfg, torch.float32, "cpu", train=True).engine
        seen.clear()
        engine.loss(U.to_torch(options_batch(1, 0)), torch.Generator().manual_seed(0))
        got[name] = (sum(seen), len(seen))
    assert got == {"shipped": (6, 7), "options": (7, 7)}


# --- the builder --------------------------------------------------------------


def test_builder_routes_and_refusals_match_jax():
    cfg = options_cfg()
    cfg["conditioner_config"]["params"]["emb_models"].append(
        {"input_key": "x", "target": _M + "FrozenT5Embedder"})
    with pytest.raises(ValueError) as jerr:
        build_diffusion_engine(cfg, unet_dtype=jnp.float32)
    with pytest.raises(ValueError) as perr:
        build_engine(cfg, torch.float32, "cpu")
    assert str(perr.value) == str(jerr.value)
    # the JAX transformer is Dense-only: the conv projection does not exist there
    cfg = U.tiny_model_cfg()
    cfg["network_config"]["params"]["use_linear_in_transformer"] = False
    with pytest.raises(NotImplementedError, match="proj_in"):
        build_engine(cfg, torch.float32, "cpu")
    # the shipped list keeps the fused Conditioner; any change goes general
    assert build_engine(U.tiny_model_cfg(), torch.float32, "cpu").engine.general_conditioner \
        is None
    for edit in (lambda e: e[0].update(is_trainable=True), lambda e: e[1].update(ucg_rate=0.1),
                 lambda e: e[1]["params"].update(method="nearest"), lambda e: e.pop(1)):
        cfg = U.tiny_model_cfg()
        edit(cfg["conditioner_config"]["params"]["emb_models"])
        if len(cfg["conditioner_config"]["params"]["emb_models"]) == 2:
            cfg["network_config"]["params"]["in_channels"] = 8
        pe = build_engine(cfg, torch.float32, "cpu", train=True).engine
        je = build_diffusion_engine(cfg, unet_dtype=jnp.float32).engine
        assert pe.general_conditioner is not None and je.general_conditioner is not None
        # a trainable LabelEncoder stays frozen in both: its parameters are not an embedder's
        assert not any(p.requires_grad for p in pe.label_encoder.parameters())


def test_loader_merges_embedder_keys(engines, tmp_path, capsys):
    _, _, pe = engines
    saved = {k: v.clone() for k, v in pe.state_dict().items()}
    sd = {f"conditioner.embedders.{i}.{k}": torch.randn_like(v)
          for i, k, v in (("3", "embedding.weight",
                           saved["general_conditioner.embedders.3.embedding.weight"]),
                          ("5", "channel_mapper.weight",
                           saved["general_conditioner.embedders.5.channel_mapper.weight"]))}
    sd["conditioner.embedders.1.weight"] = torch.zeros(3)  # the mask rescaler has no parameter
    path = tmp_path / "run.ckpt"
    torch.save({"state_dict": sd}, path)
    try:
        reports = loading.load_from_torch_ckpt(pe, str(path))
        assert set(reports) == {"embedders"} and reports["embedders"] == ([], [], [])
        assert "[embedders] merged with 0 missing" in capsys.readouterr().out
        gsd = pe.general_conditioner.state_dict()
        assert torch.equal(gsd["embedders.3.embedding.weight"],
                           sd["conditioner.embedders.3.embedding.weight"])
    finally:
        pe.load_state_dict(saved)
