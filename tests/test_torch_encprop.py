"""Encoder-propagation sampling on the port against the JAX build:
`UNetModel.forward_cached` / `decode_cached`, `sample_euler_edm_encprop`
(all-key, interval 2 and 3 masks; the short mask's ValueError),
`engine.sample(encprop_interval=2)` and `Predictor(encprop_interval=3)` on
the tiny engine with the JAX engine's own draws (tolerance 1e-3, as
tests/test_torch_engine.py), encprop ignored under attend-and-excite and
map capture; the quality gate (every case of tests/test_encprop_gate.py on
the port's module, reports and checkpoint ids shared by both packages, the
port's quality script); and the demo CLI, the eval CLI's `make_predictor`
and the server's `build_predict_fn` passing the interval and the
checkpoint's id to the predictor."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_port_util as U
from udifftext_tpu.builders import build_diffusion_engine
from udifftext_tpu.diffusion import sampling as JS
from udifftext_tpu.models.unet import UNetModel as JUNet
from udifftext_tpu.utils import encprop_gate as JG
from udifftext_tpu_torch.builders import build_engine
from udifftext_tpu_torch.diffusion import sampling as PS
from udifftext_tpu_torch.diffusion.schedules import LegacyDDPMDiscretization
from udifftext_tpu_torch.predict import Predictor
from udifftext_tpu_torch.utils import convert
from udifftext_tpu_torch.utils import encprop_gate as G

T = torch.from_numpy
K, STEPS, CFG = 3, 4, 5.0


@pytest.fixture(autouse=True)
def _reports_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("UDIFFTEXT_ENCPROP_REPORTS", str(tmp_path / "reports"))
    monkeypatch.delenv("UDIFFTEXT_ENCPROP_UNGATED", raising=False)
    G._WARNED.clear()
    JG._WARNED.clear()
    yield


# --- the UNet's cached entry points and the sampler ------------------------


@pytest.fixture(scope="module")
def tiny_unet():
    return U.tiny_unet_pair()


def test_forward_cached_and_decode_cached_match(tiny_unet):
    junet, params, punet, ctx = tiny_unet
    x = np.random.RandomState(1).standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([3.0, 7.0], np.float32)
    jout, jhs = junet.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                            method=JUNet.forward_cached)
    t2 = np.array([5.0, 1.0], np.float32)  # a later step's timestep on the cached stack
    jre = junet.apply(params, jhs, jnp.asarray(t2), jnp.asarray(ctx), method=JUNet.decode_cached)
    with torch.no_grad():
        ref, _ = punet(T(x), T(t), T(ctx))
        out, hs = punet.forward_cached(T(x), T(t), T(ctx))
        same = punet.decode_cached(hs, T(t), T(ctx))
        re = punet.decode_cached(hs, T(t2), T(ctx))
    assert torch.equal(out, ref) and torch.equal(same, ref)
    assert isinstance(hs, tuple) and len(hs) == len(jhs)
    for g, w in zip(hs, jhs):
        U.assert_close(g, w, 1e-5, 1e-5, "skip stack")
    U.assert_close(out, jout, 1e-5, 1e-5, "forward_cached")
    U.assert_close(re, jre, 1e-5, 1e-5, "decode_cached at another timestep")
    assert not torch.allclose(re, ref)


@pytest.mark.parametrize("interval", [1, 2, 3])
def test_encprop_sampler_matches(tiny_unet, interval):
    junet, params, punet, ctx = tiny_unet
    sigmas = LegacyDDPMDiscretization()(6)
    x = np.array(JS.init_latent(jax.random.normal(jax.random.PRNGKey(2), (2, 8, 8, 4)),
                                jnp.asarray(sigmas)))
    jc = jnp.asarray(ctx)
    mask = PS.uniform_key_mask(6, interval)
    assert np.array_equal(mask, JS.uniform_key_mask(6, interval))
    want = JS.sample_euler_edm_encprop(
        lambda a, s: junet.apply(params, a, s, jc, method=JUNet.forward_cached),
        lambda a, s, hs: junet.apply(params, hs, s, jc, method=JUNet.decode_cached),
        jnp.asarray(x), jnp.asarray(sigmas), mask)
    with torch.no_grad():
        got = PS.sample_euler_edm_encprop(
            lambda a, s: punet.forward_cached(a, s, T(ctx)),
            lambda a, s, hs: punet.decode_cached(hs, s, T(ctx)), T(x), T(sigmas), mask)
        exact = PS.sample_euler_edm(lambda a, s: punet(a, s, T(ctx))[0], T(x), T(sigmas))
    # one UNet eval agrees to 1e-5; the steps carry it over sigma_max
    U.assert_close(got, want, 1e-5, 1e-5 * float(sigmas[0]), f"encprop interval {interval}")
    if interval == 1:
        assert torch.equal(got, exact)
    else:
        assert not torch.allclose(got, exact)  # the reuse steps consumed the cache


def test_encprop_sampler_rejects_a_short_mask():
    sigmas = T(LegacyDDPMDiscretization()(4))
    with pytest.raises(ValueError, match="3 entries for 4 steps"):
        PS.sample_euler_edm_encprop(None, None, torch.zeros(1, 2, 2, 4), sigmas, [True] * 3)
    with pytest.raises(ValueError, match="3 entries for 4 steps"):
        JS.sample_euler_edm_encprop(None, None, jnp.zeros((1, 2, 2, 4)), jnp.asarray(sigmas),
                                    [True] * 3)
    # the first step is key whatever the mask says
    calls = []

    def full(x, s):
        calls.append("full")
        return x * 0.5, "stack"

    def reuse(x, s, hs):
        assert hs == "stack"
        calls.append("reuse")
        return x * 0.5

    PS.sample_euler_edm_encprop(full, reuse, torch.ones(1, 2, 2, 4), sigmas, [False, True] * 2)
    assert calls == ["full", "full", "reuse", "full"]


# --- the whole slice on the tiny engine ------------------------------------


@pytest.fixture(scope="module")
def engines():
    cfg = U.tiny_model_cfg()
    je = build_diffusion_engine(cfg, unet_dtype=jnp.float32).engine
    params = U.engine_params(je, seed=11)
    pe = U.load_port(build_engine(cfg, torch.float32, "cpu").engine,
                     convert.engine_from_jax(params))
    return je, params, pe


def _jax_draws(key, b):
    """The JAX engine's draws for sample(key) on the tiny graph (see
    tests/test_torch_engine.py `_jax_draws`)."""
    rng_cond, rng_noise = jax.random.split(key)
    shape = (b, U.LAT, U.LAT, 4)
    eps = jax.random.normal(jax.random.split(rng_cond, 6)[4], shape)
    cands = jnp.stack([jax.random.normal(k, shape) for k in jax.random.split(rng_noise, K)])
    return T(np.array(eps)), T(np.array(cands))


def test_engine_sample_and_predictor_encprop_match_jax(engines):
    """engine.sample(encprop_interval=2) and Predictor(encprop_interval=3)
    against the JAX engine's sample (which JittedPredictor jits with the
    gate passed at construction), the batched search on both sides."""
    je, params, pe = engines
    nb = U.numpy_batch(1, seed=5)
    key = jax.random.PRNGKey(21)
    eps, cands = _jax_draws(key, 1)
    exact, _ = je.sample(params, U.to_jax(nb), key, num_steps=STEPS, cfg_scale=CFG,
                         noise_iters=K, noise_search_batched=True, return_latents=True)
    for interval in (2, 3):
        want, _ = je.sample(params, U.to_jax(nb), key, num_steps=STEPS, cfg_scale=CFG,
                            noise_iters=K, noise_search_batched=True, return_latents=True,
                            encprop_interval=interval, encprop_pregated=True)
        assert not np.allclose(np.asarray(want), np.asarray(exact), atol=1e-3)
        kw = dict(num_steps=STEPS, cfg_scale=CFG, noise_iters=K, noise_search_batched=True,
                  posterior_eps=eps, noise=cands)
        if interval == 2:
            got, _ = pe.sample(U.to_torch(nb), return_latents=True, encprop_interval=2, **kw)
            U.assert_close(got, want, 1e-3, 1e-3, "engine.sample encprop 2")
            continue
        img, _ = Predictor(pe, num_steps=STEPS, cfg_scale=CFG, noise_iters=K,
                           encprop_interval=3, noise_search_batched=True)(
            nb, posterior_eps=eps, noise=cands)
        want_img = jnp.clip((je.decode_first_stage(params, want) + 1.0) / 2.0, 0.0, 1.0)
        U.assert_close(img, want_img, 1e-3, 1e-3, "Predictor encprop 3")


def test_encprop_is_ignored_under_aae_and_detailed(engines):
    """Attend-and-excite and map capture need every step's maps: the engine
    ignores the interval, as the JAX engine does. The engine never consults
    the gate; `Predictor` gates at construction whatever the options, as
    JAX's does, so a checkpoint id with no report is refused there."""
    _, _, pe = engines
    pb = U.to_torch(U.numpy_batch(1, seed=2))
    gen = torch.Generator().manual_seed(0)
    kw = dict(num_steps=2, cfg_scale=CFG, noise_iters=1, posterior_eps=torch.randn(
        1, U.LAT, U.LAT, 4, generator=gen), noise=torch.randn(1, 1, U.LAT, U.LAT, 4, generator=gen),
        return_latents=True)
    for opts in ({"detailed": True}, {"aae_enabled": True}):
        want, _ = pe.sample(pb, **opts, **kw)
        got, _ = pe.sample(pb, **opts, encprop_interval=2, **kw)
        assert torch.equal(got, want)
    approx, _ = pe.sample(pb, encprop_interval=2, **kw)
    assert torch.isfinite(approx).all()
    for opts in ({}, {"detailed": True}, {"aae_enabled": True}):
        with pytest.raises(RuntimeError, match="no quality report"):
            Predictor(pe, num_steps=2, encprop_interval=2, ckpt_id="no-report", **opts)


# --- the quality gate -------------------------------------------------------


def test_report_roundtrip_and_ckpt_id(tmp_path):
    ck = tmp_path / "model.ckpt"
    ck.write_bytes(b"weights" * 1000)
    cid = G.ckpt_file_id(str(ck))
    assert cid and len(cid) == 16
    assert G.ckpt_file_id(str(ck)) == cid
    assert G.ckpt_file_id(str(tmp_path / "missing.ckpt")) is None
    path = G.write_report(cid, {"intervals": {"2": {"psnr": 41.5}}})
    assert os.path.exists(path)
    rep = G.load_report(cid)
    assert rep["ckpt_id"] == cid and rep["intervals"]["2"]["psnr"] == 41.5


def test_gate_refuses_without_report():
    with pytest.raises(RuntimeError, match="no quality report"):
        G.gate_encprop("abc123", 2)


def test_gate_refuses_low_psnr_and_missing_interval():
    G.write_report("abc123", {"intervals": {"2": {"psnr": 12.0}}})
    with pytest.raises(RuntimeError, match="below the"):
        G.gate_encprop("abc123", 2)
    with pytest.raises(RuntimeError, match="no measurement for interval 5"):
        G.gate_encprop("abc123", 5)
    G.gate_encprop("abc123", 2, min_psnr=10.0)


def test_gate_passes_good_report(capsys):
    G.write_report("good1", {"intervals": {"3": {"psnr": 44.0}}})
    G.gate_encprop("good1", 3)
    assert "quality gate passed" in capsys.readouterr().out


def test_gate_warns_once_without_ckpt_id(capsys):
    G.gate_encprop(None, 2)
    G.gate_encprop(None, 2)
    assert capsys.readouterr().err.count("UNVALIDATED") == 1


def test_gate_env_bypass(monkeypatch):
    monkeypatch.setenv("UDIFFTEXT_ENCPROP_UNGATED", "1")
    G.gate_encprop("abc123", 2)


def test_predictor_enforces_gate():
    eng = types.SimpleNamespace(sample=lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="refused"):
        Predictor(eng, encprop_interval=2, ckpt_id="deadbeef")
    G.write_report("deadbeef", {"intervals": {"2": {"psnr": 39.0}}})
    assert Predictor(eng, encprop_interval=2, ckpt_id="deadbeef").encprop_interval == 2
    with pytest.raises(RuntimeError, match="below the 40.0 dB gate"):
        Predictor(eng, encprop_interval=2, ckpt_id="deadbeef", min_quality_psnr=40.0)
    assert Predictor(eng, encprop_interval=0, ckpt_id=None).encprop_interval == 0
    # the predictor's own settings must match the report's
    G.write_report("steps4", {"steps": 4, "scale": 5.0, "intervals": {"2": {"psnr": 45.0}}})
    with pytest.raises(RuntimeError, match="different sampler settings"):
        Predictor(eng, num_steps=50, encprop_interval=2, ckpt_id="steps4")
    Predictor(eng, num_steps=4, encprop_interval=2, ckpt_id="steps4")


def test_gate_refuses_settings_mismatch():
    G.write_report("cfg1", {"steps": 4, "scale": 5.0, "intervals": {"2": {"psnr": 45.0}}})
    with pytest.raises(RuntimeError, match="different sampler settings"):
        G.gate_encprop("cfg1", 2, settings={"steps": 50, "scale": 5.0})
    G.gate_encprop("cfg1", 2, settings={"steps": 4, "scale": 5.0})
    G.write_report("cfg2", {"intervals": {"2": {"psnr": 45.0}}})
    G.gate_encprop("cfg2", 2, settings={"steps": 50, "scale": 5.0})


def test_write_report_merges_matching_settings():
    base = {"steps": 50, "scale": 5.0, "size": 512}
    G.write_report("m1", {**base, "intervals": {"2": {"psnr": 40.0}}})
    G.write_report("m1", {**base, "intervals": {"3": {"psnr": 36.0}}})
    assert set(G.load_report("m1")["intervals"]) == {"2", "3"}
    G.write_report("m1", {"steps": 4, "scale": 5.0, "size": 512,
                          "intervals": {"2": {"psnr": 48.0}}})
    rep = G.load_report("m1")
    assert set(rep["intervals"]) == {"2"} and rep["steps"] == 4


def _checkpoint_dirs(tmp_path):
    for name, fill in (("ck_a", b"\x01"), ("ck_b", b"\x02")):
        d = tmp_path / name / "array_store"
        d.mkdir(parents=True)
        (d / "chunk_0").write_bytes(fill * 4096)
        (tmp_path / name / "manifest.json").write_text('{"v": 1}')
    return tmp_path / "ck_a", tmp_path / "ck_b"


def test_ckpt_dir_id_distinguishes_same_layout(tmp_path):
    a, b = _checkpoint_dirs(tmp_path)
    assert G.ckpt_file_id(str(a)) != G.ckpt_file_id(str(b))
    big = a / "array_store" / "big"
    big.write_bytes(b"\x03" * (1 << 18))
    id_1 = G.ckpt_file_id(str(a))
    data = bytearray(b"\x03" * (1 << 18))
    data[-1] = 0x04
    big.write_bytes(bytes(data))
    assert G.ckpt_file_id(str(a)) != id_1


def test_ckpt_ids_and_reports_are_shared_with_the_jax_package(tmp_path, capsys):
    ck = tmp_path / "model.ckpt"
    ck.write_bytes(bytes(range(256)) * 700)
    a, _ = _checkpoint_dirs(tmp_path)
    (a / "array_store" / "big").write_bytes(b"\x05" * (1 << 18))
    for path in (ck, a, tmp_path / "missing"):
        assert G.ckpt_file_id(str(path)) == JG.ckpt_file_id(str(path))
    settings = {"steps": 50, "scale": 5.0}
    # a report by the JAX module gates the port, and the reverse
    JG.write_report("from_jax", {**settings, "intervals": {"2": {"psnr": 35.0}}})
    G.gate_encprop("from_jax", 2, settings=settings)
    G.write_report("from_port", {**settings, "intervals": {"3": {"psnr": 33.0}}})
    JG.gate_encprop("from_port", 3, settings=settings)
    assert G.report_path("x/y") == JG.report_path("x/y")
    with open(G.report_path("from_port")) as f:
        assert json.load(f) == JG.load_report("from_port")
    for gate in (G.gate_encprop, JG.gate_encprop):
        with pytest.raises(RuntimeError, match="below the"):
            gate("from_jax", 2, min_psnr=36.0)
    assert capsys.readouterr().out.count("quality gate passed") == 2


def test_quality_script_writes_a_report_its_gate_accepts(capsys):
    from udifftext_tpu_torch.scripts import encprop_quality

    res = encprop_quality.run(U.tiny_model_cfg(), steps=3, intervals=(2, 3), size=32,
                              report_id="tiny", device="cpu")
    assert set(res["intervals"]) == {"2", "3"} and res["mode"].startswith("RANDOM-INIT")
    rep = G.load_report("tiny")
    assert (rep["steps"], rep["scale"], rep["size"]) == (3, 5.0, 32)
    assert rep["intervals"] == res["intervals"]
    psnr = min(v["psnr"] for v in res["intervals"].values())
    assert np.isfinite(psnr)
    G.gate_encprop("tiny", 2, min_psnr=psnr, settings={"steps": 3, "scale": 5.0})
    JG.gate_encprop("tiny", 3, min_psnr=psnr, settings={"steps": 3, "scale": 5.0})
    # no report without a checkpoint or a forced key
    assert encprop_quality.run(U.tiny_model_cfg(), steps=2, intervals=(2,), size=32,
                               device="cpu")["report_path"] is None
    assert "report NOT written" in capsys.readouterr().out


# --- the callers: demo CLI, eval CLI, server --------------------------------


def _ckpt(tmp_path):
    """A checkpoint file the loaders read (an empty state dict)."""
    path = tmp_path / "run.ckpt"
    torch.save({"state_dict": {}}, str(path))
    return str(path)


class _Spy:
    """Stands in for `Predictor` in a caller's module and keeps its kwargs."""

    def __init__(self, monkeypatch, module):
        self.kwargs = None
        real = Predictor

        def make(*a, **kw):
            self.kwargs = kw
            return real(*a, **kw)

        monkeypatch.setattr(module, "Predictor", make)


def test_demo_cli_passes_encprop_and_ckpt_id(tmp_path, monkeypatch):
    from PIL import Image

    from udifftext_tpu_torch import demo

    ckpt = _ckpt(tmp_path)
    monkeypatch.chdir(tmp_path)
    os.makedirs("configs")
    with open("configs/tiny.yaml", "w") as f:
        yaml.safe_dump({"model": {"params": U.tiny_model_cfg()}}, f)
    with open("configs/demo.yaml", "w") as f:
        yaml.safe_dump({"model_cfg_path": "./configs/tiny.yaml", "load_ckpt_path": ckpt,
                        "H": 32, "W": 32, "noise_iters": 1, "steps": 2, "bf16": False,
                        "encprop_interval": 2}, f)
    Image.fromarray(np.zeros((40, 40, 3), np.uint8)).save("in.png")
    Image.fromarray(np.full((40, 40), 255, np.uint8)).save("mask.png")
    argv = ["--image", "in.png", "--mask", "mask.png", "--text", "ab", "--out", "out.png",
            "--device", "cpu"]
    spy = _Spy(monkeypatch, demo)
    with pytest.raises(RuntimeError, match="no quality report"):
        demo.main(argv)
    cid = G.ckpt_file_id(ckpt)
    assert (spy.kwargs["encprop_interval"], spy.kwargs["ckpt_id"]) == (2, cid)
    G.write_report(cid, {"steps": 2, "scale": 5.0, "intervals": {"2": {"psnr": 31.0}}})
    demo.main(argv)
    assert os.path.exists("out.png")


def test_eval_cli_make_predictor_passes_encprop_and_ckpt_id(tmp_path, monkeypatch):
    from udifftext_tpu_torch import test as eval_cli
    from udifftext_tpu_torch.builders import SamplerSettings

    ckpt = _ckpt(tmp_path)
    eng = types.SimpleNamespace(sample=lambda *a, **k: None)
    bundle = types.SimpleNamespace(engine=eng)
    spy = _Spy(monkeypatch, eval_cli)
    cfgs = {"encprop_interval": 3, "load_ckpt_path": ckpt}
    with pytest.raises(RuntimeError, match="no quality report"):
        eval_cli.make_predictor(cfgs, bundle, SamplerSettings(num_steps=4))
    assert (spy.kwargs["encprop_interval"], spy.kwargs["ckpt_id"]) == (3, G.ckpt_file_id(ckpt))
    # the checkpoint is hashed only when encprop is asked for
    eval_cli.make_predictor({"load_ckpt_path": ckpt}, bundle, SamplerSettings())
    assert spy.kwargs["ckpt_id"] is None


def test_build_predict_fn_passes_encprop_and_ckpt_id(tmp_path, monkeypatch):
    from udifftext_tpu_torch.scripts import serve

    ckpt = _ckpt(tmp_path)
    spy = _Spy(monkeypatch, serve)
    cfgs = {"load_ckpt_path": ckpt, "bf16": False, "steps": 2, "noise_iters": 1,
            "encprop_interval": 2}
    with pytest.raises(RuntimeError, match="no quality report"):
        serve.build_predict_fn(cfgs, U.tiny_model_cfg(), device="cpu")
    cid = G.ckpt_file_id(ckpt)
    assert (spy.kwargs["encprop_interval"], spy.kwargs["ckpt_id"]) == (2, cid)
    G.write_report(cid, {"steps": 2, "scale": 5.0, "intervals": {"2": {"psnr": 31.0}}})
    run = serve.build_predict_fn(cfgs, U.tiny_model_cfg(), device="cpu")
    assert run.predictor.encprop_interval == 2
    nb = U.numpy_batch(1)
    out = run({"image": ((nb["image"] + 1) * 127.5).astype(np.uint8),
               "mask": nb["mask"][..., 0].astype(np.uint8), "seg_mask": nb["seg_mask"],
               "label_ids": nb["label_ids"]}, 0)
    assert out.dtype == torch.uint8 and out.shape == (1, U.IMG, U.IMG, 3)

