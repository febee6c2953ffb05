"""The port's whole inference slice against the JAX engine on the tiny
model graph: `engine.sample` with the candidate-batched and the sequential
init-noise search (noise_iters=3, 4 CFG steps), both fed the JAX engine's
own random draws. Compared: the candidates' scores, the chosen candidate,
the final latent and the decoded image (fp32; tolerance 1e-3 relative and
absolute: the initial latent is ~14.6·randn and CFG 5 amplifies the
per-eval differences of ~1e-6 over 4 steps). Also the predictor,
the builder's shipped-graph dict, and that the port never imports JAX or
the JAX package."""

import json
import os
import re
import subprocess
import sys
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
from udifftext_tpu.diffusion import sampling as JS
from udifftext_tpu.diffusion.schedules import append_dims
from udifftext_tpu_torch.builders import TEXTDESIGN_SD_2, build_engine
from udifftext_tpu_torch.predict import Predictor
from udifftext_tpu_torch.utils import convert

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-3, 1e-3
K, STEPS, CFG = 3, 4, 5.0
T = torch.from_numpy


@pytest.fixture(scope="module")
def engines():
    cfg = U.tiny_model_cfg()
    je = build_diffusion_engine(cfg, unet_dtype=jnp.float32).engine
    params = U.engine_params(je, seed=11)
    pe = U.load_port(build_engine(cfg, torch.float32, "cpu").engine,
                     convert.engine_from_jax(params))
    return je, params, pe


def _jax_draws(key, b):
    """The JAX engine's draws for sample(key): the tiny graph conditions
    through GeneralConditioner, whose LatentEncoder (embedder 2) samples the
    posterior with split(rng_cond, 6)[4]; the search splits rng_noise."""
    rng_cond, rng_noise = jax.random.split(key)
    shape = (b, U.LAT, U.LAT, 4)
    eps = jax.random.normal(jax.random.split(rng_cond, 6)[4], shape)
    cands = jnp.stack([jax.random.normal(k, shape) for k in jax.random.split(rng_noise, K)])
    return rng_cond, rng_noise, np.asarray(eps), np.asarray(cands)


def _jax_scores(je, params, c, uc, batch, cands):
    """Each candidate's summed min-local loss after the 2-step rollout, from
    the JAX engine's own pieces (get_init_noise returns only the winner)."""
    k, b = cands.shape[:2]
    tile = lambda t: jnp.concatenate([t] * k, axis=0)  # noqa: E731
    denoise = je.make_denoise_fn(params, jax.tree.map(tile, c), jax.tree.map(tile, uc), CFG,
                                 capture_attn=True)
    sigmas = jnp.asarray(je.discretization(2, do_append_zero=True))
    x = JS.init_latent(jnp.asarray(cands).reshape((k * b,) + cands.shape[2:]), sigmas)
    for i in range(2):
        sigma = jnp.full((k * b,), sigmas[i])
        denoised, aux = denoise(x, sigma)
        loss = JL.min_local_loss(aux, tile(batch["mask"]), tile(batch["seg_mask"]),
                                 jnp.asarray(je.loss_cfg.kernel), je.loss_cfg.min_attn_size)
        x = x + append_dims(sigmas[i + 1] - sigma, x.ndim) * JS.to_d(x, sigma, denoised)
    return np.asarray(loss.reshape(k, b).sum(axis=1))


@pytest.mark.parametrize("batched", [True, False], ids=["batched_search", "sequential_search"])
def test_sample_matches_jax_engine(engines, batched):
    je, params, pe = engines
    b = 1 if batched else 2
    nb = U.numpy_batch(b, seed=5)
    jb = U.to_jax(nb)
    key = jax.random.PRNGKey(21)
    rng_cond, rng_noise, eps, cands = _jax_draws(key, b)

    c, uc = je.conditionings(params, jb, rng=rng_cond)
    want_scores = _jax_scores(je, params, c, uc, jb, cands)
    want_x0 = je.get_init_noise(params, c, uc, jb, rng_noise, (b, U.LAT, U.LAT, 4), CFG, K,
                                candidate_batched=batched)
    want_z, _ = je.sample(params, jb, key, num_steps=STEPS, cfg_scale=CFG, noise_iters=K,
                          noise_search_batched=batched, return_latents=True)
    want_img = jnp.clip((je.decode_first_stage(params, want_z) + 1.0) / 2.0, 0.0, 1.0)

    pb = U.to_torch(nb)
    pc, puc = pe.conditionings(pb, T(eps))
    for name in ("t_crossattn", "concat"):
        U.assert_close(pc[name], c[name], 1e-5, 1e-5, f"c[{name}]")
        U.assert_close(puc[name], uc[name], 1e-5, 1e-5, f"uc[{name}]")
    with torch.no_grad():
        x0, scores = pe.get_init_noise(pc, puc, pb, T(cands), CFG, candidate_batched=batched)
    U.assert_close(scores, want_scores, RTOL, 1e-5, "candidate scores")
    assert int(np.argmin(scores.numpy())) == int(np.argmin(want_scores))
    assert np.array_equal(x0.numpy(), np.asarray(want_x0)), "chosen candidate"

    kw = dict(num_steps=STEPS, cfg_scale=CFG, noise_iters=K, noise_search_batched=batched,
              posterior_eps=T(eps), noise=T(cands))
    z, aux = pe.sample(pb, return_latents=True, **kw)
    U.assert_close(aux["noise_scores"], want_scores, RTOL, 1e-5, "sample's scores")
    U.assert_close(z, want_z, RTOL, ATOL, "final latent")
    img, _ = pe.sample(pb, **kw)
    assert img.shape == (b, U.IMG, U.IMG, 3)
    U.assert_close(img, want_img, RTOL, ATOL, "decoded image")


class _RecordingEngine:
    """An engine stand-in that records the search mode of each sample call."""

    device = torch.device("cpu")

    def __init__(self):
        self.seen = []

    def sample(self, arr, generator=None, **kw):
        self.seen.append((arr["seg_mask"].shape[0], kw["noise_search_batched"]))
        return None, {}


@pytest.mark.parametrize("b,batched", [(1, True), (16, True), (17, False), (32, False)])
def test_predictor_default_search_boundary(b, batched):
    """10 candidates a sample: batched up to 160 rows (B = 16), the card's
    cap; sequential beyond (320 rows ran out of memory on an 80 GB card)."""
    engine = _RecordingEngine()
    pred = Predictor(engine, noise_iters=10, noise_search_batched=True)
    assert pred.noise_search_max_rows == 160
    pred({"seg_mask": np.zeros((b, 12), np.float32)})
    assert engine.seen == [(b, batched)]


def test_predictor_float_batch_and_search_choice(engines, monkeypatch):
    _, _, pe = engines
    nb = U.numpy_batch(2, seed=6)
    nb["label"] = np.array(["abc", "abc"], dtype=object)  # host-only fields are skipped
    gen = torch.Generator().manual_seed(0)
    eps = torch.randn(2, U.LAT, U.LAT, 4, generator=gen)
    noise = torch.randn(K, 2, U.LAT, U.LAT, 4, generator=gen)
    pred = Predictor(pe, num_steps=2, cfg_scale=CFG, noise_iters=K, noise_search_batched=True,
                     noise_search_max_rows=K * 2)
    img, aux = pred(nb, posterior_eps=eps, noise=noise)
    want, _ = pe.sample(U.to_torch({k: v for k, v in nb.items() if k != "label"}), num_steps=2,
                        cfg_scale=CFG, noise_iters=K, posterior_eps=eps, noise=noise)
    assert torch.equal(img, want)

    seen = []
    orig = pe.sample
    monkeypatch.setattr(pe, "sample", lambda *a, **k: (seen.append(k["noise_search_batched"]),
                                                       orig(*a, **k))[1])
    pred(nb, posterior_eps=eps, noise=noise)
    Predictor(pe, num_steps=1, noise_iters=K, noise_search_batched=True,
              noise_search_max_rows=K * 2 - 1)(nb, posterior_eps=eps, noise=noise)
    assert seen == [True, False]


def test_unported_options_raise(engines, tmp_path, monkeypatch):
    _, _, pe = engines
    nb = U.numpy_batch(1)
    # encoder propagation is ported: it builds, and the quality gate refuses
    # a checkpoint that has no report
    monkeypatch.setenv("UDIFFTEXT_ENCPROP_REPORTS", str(tmp_path / "reports"))
    monkeypatch.delenv("UDIFFTEXT_ENCPROP_UNGATED", raising=False)
    assert Predictor(pe, encprop_interval=2).encprop_interval == 2
    with pytest.raises(RuntimeError, match="no quality report"):
        Predictor(pe, encprop_interval=2, ckpt_id="0123456789abcdef")
    # the uint8 wire format's contract: a mask and no masked
    u8 = {**nb, "image": (nb["image"] * 0).astype(np.uint8)}
    with pytest.raises(ValueError, match="requires a 'mask'"):
        Predictor(pe)({k: v for k, v in u8.items() if k not in ("mask", "masked")})
    with pytest.raises(ValueError, match="synthesizes 'masked'"):
        Predictor(pe)(u8)
    # the ctrl block and any embedder list are built (tests/test_torch_conditioning.py);
    # what the JAX build lacks is refused: the conv proj_in/proj_out of
    # use_linear_in_transformer false, and an embedder target it does not know
    cfg = U.tiny_model_cfg()
    cfg["network_config"]["params"]["use_linear_in_transformer"] = False
    with pytest.raises(NotImplementedError, match="conv proj_in/proj_out"):
        build_engine(cfg, torch.float32, "cpu")
    cfg = U.tiny_model_cfg()
    cfg["conditioner_config"]["params"]["emb_models"][1]["target"] = "sgm.modules.Unknown"
    with pytest.raises(ValueError, match="unsupported embedder target"):
        build_engine(cfg, torch.float32, "cpu")
    # the OCR loss term is ported (tests/test_torch_ocr_train.py); an OCR
    # predictor other than PARSeq is not
    cfg = U.tiny_model_cfg()
    cfg["loss_fn_config"]["params"].update(ocr_enabled=True, predictor_config={
        "target": "sgm.modules.predictors.model.CRNNPredictor"})
    with pytest.raises(NotImplementedError, match="OCR predictor other than ParseqPredictor"):
        build_engine(cfg, torch.float32, "cpu", train=True)


def test_shipped_graph_dict_equals_yaml():
    with open(REPO / "configs" / "test" / "textdesign_sd_2.yaml") as f:
        assert yaml.safe_load(f)["model"]["params"] == TEXTDESIGN_SD_2


_NO_JAX_SCRIPT = r"""
import json, os, sys
import numpy as np, torch, yaml
from PIL import Image
import udifftext_tpu_torch
from udifftext_tpu_torch import config, demo, loading, predict, serving, train
from udifftext_tpu_torch.builders import build_engine, randomize_parameters
from udifftext_tpu_torch.scripts import serve, serve_bench
from udifftext_tpu_torch.utils import ckpt
from udifftext_tpu_torch.parallel import train as parallel_train
from udifftext_tpu_torch.ops import flash_variants as fv_ops, groupnorm as gn_ops
from udifftext_tpu_torch.scripts import flash_variants, glue_fusion_probe, resblock_probe
from udifftext_tpu_torch.utils import convert, logger, png, profiling, train_ckpt, viz
from udifftext_tpu_torch import test as eval_cli, util
from udifftext_tpu_torch.parallel import dist
bundle = build_engine(json.loads(sys.argv[1]), torch.float32, "cpu", train=True)
randomize_parameters(bundle.engine, 0)
batch = demo.build_batch(np.zeros((40, 40, 3), np.uint8), np.full((40, 40), 255, np.uint8),
                         "ab", 32, 32)
for batched in (True, False):
    img, _ = predict.Predictor(bundle.engine, num_steps=2, noise_iters=2,
                               noise_search_batched=batched)(batch, torch.Generator().manual_seed(0))
    assert img.shape == (1, 32, 32, 3) and bool(torch.isfinite(img).all())
img, aux = predict.Predictor(bundle.engine, num_steps=2, noise_iters=0, aae_enabled=True,
                             detailed=True)(batch, torch.Generator().manual_seed(0))
assert bool(torch.isfinite(aux["local_losses"]).all())
# encoder propagation through the predictor, and the quality script writing its report
from udifftext_tpu_torch.scripts import encprop_quality
os.environ["UDIFFTEXT_ENCPROP_REPORTS"] = os.path.join(sys.argv[2], "reports")
img, _ = predict.Predictor(bundle.engine, num_steps=3, noise_iters=1, encprop_interval=2)(
    batch, torch.Generator().manual_seed(0))
assert bool(torch.isfinite(img).all())
assert encprop_quality.run(json.loads(sys.argv[1]), steps=2, intervals=(2,), size=32,
                           report_id="tiny", device="cpu")["report_path"]
batch["seg"] = np.zeros((1, 32, 32, 12), np.float32)
state = train.train({"lightning": {"max_epochs": 1}, "log_dir": sys.argv[2]}, [batch], bundle,
                    seed=0)
assert state.step == 1
state = train.main({"lightning": {"max_epochs": 1}, "log_dir": sys.argv[2],
                    "save_ckpt_dir": sys.argv[2], "load_ckpt_path": None, "bf16": False},
                   [batch], device="cpu", model_cfg=json.loads(sys.argv[1]), seed=0)
assert train_ckpt.latest_checkpoint(os.path.join(sys.argv[2], "udifftext_tpu_torch"))
res = eval_cli.test(bundle, bundle.sampler, [dict(batch, name=["x"])],
                    {"output_dir": sys.argv[2] + "/out", "temp_dir": sys.argv[2] + "/tmp",
                     "noise_iters": 0, "steps": 1}, seed=0)
assert res["names"] == ["x"]
# a pretraining step and the metrics over the eval CLI's files
from udifftext_tpu_torch import metrics, pretrain
from udifftext_tpu_torch.data.synthetic import SyntheticLabelBatches
pcfgs = {"model": {"params": {"max_len": 4, "emb_dim": 16, "n_heads": 2, "n_trans_layers": 1,
                              "visual_config": {"params": {"size": 16, "patch_size": 8,
                                                           "embed_dim": 8, "depth": 1,
                                                           "num_heads": 2}}}},
         "lightning": {"max_epochs": 1}, "ckpt_dir": sys.argv[2] + "/pre"}
pstate = pretrain.main(pcfgs, SyntheticLabelBatches(1, 2, size=16, max_len=4), device="cpu",
                       seed=0, log_every=1)
assert pstate.step == 1 and np.isfinite(pstate.history[0]["loss/full_loss"])
for i in range(3):  # the eval CLI's one sample, and two more pairs
    for d in ("fake", "real"):
        png.write_png(f"{sys.argv[2]}/out/{d}/{i}.png", np.full((32, 32, 3), 40 * i, np.uint8))
feature_fn = lambda x: x.reshape(x.shape[0], -1)[:, :8] + np.arange(8)
assert metrics.calc_fid(sys.argv[2] + "/out/fake", sys.argv[2] + "/out/real",
                        feature_fn=feature_fn) is not None
assert metrics.load_lpips_distance_fn(sys.argv[2] + "/none.pth", device="cpu") is None
glue_fusion_probe.run(batch=1, reps=1, device="cpu", shapes=(("tiny", 8, 64),), ctx_dim=16,
                      dim_head=32, dtype=torch.float32, runs=1)
assert len(resblock_probe.run(batch=1, channels=32, hw=4, reps=1, runs=1, device="cpu",
                              dtype=torch.float32)) == 6
assert len(flash_variants.run(reps=1, batch=1, heads=1, n=64, runs=1, device="cpu",
                              dtype=torch.float32)) == 6
# the demo CLI end to end: it reads its YAML through the port's own config module
os.chdir(sys.argv[2])
os.makedirs("configs")
with open("configs/tiny.yaml", "w") as f:
    yaml.safe_dump({"model": {"params": json.loads(sys.argv[1])}}, f)
with open("configs/demo.yaml", "w") as f:
    yaml.safe_dump({"model_cfg_path": "./configs/tiny.yaml", "load_ckpt_path": "./none.ckpt",
                    "H": 32, "W": 32, "noise_iters": 2, "steps": 2, "bf16": False}, f)
assert config.load_config("configs/demo.yaml").steps == 2
Image.fromarray(np.zeros((40, 40, 3), np.uint8)).save("in.png")
Image.fromarray(np.full((40, 40), 255, np.uint8)).save("mask.png")
demo.main(["--image", "in.png", "--mask", "mask.png", "--text", "ab", "--out", "out.png",
           "--device", "cpu"])
assert os.path.exists("out.png")
# a checkpoint through the run config, and the serving benchmark's entry
torch.save({"state_dict": {"model.diffusion_model." + k: v
                           for k, v in bundle.engine.unet.state_dict().items()}}, "run.ckpt")
loading.init_model({"load_ckpt_path": "run.ckpt", "bf16": False}, "cpu",
                   model_cfg=json.loads(sys.argv[1]))
bench = serve_bench.run(max_batch=1, steps=1, noise_iters=1, batches=1, qps=0.0,
                        latency_requests=1, pipeline=2, model_cfg=json.loads(sys.argv[1]),
                        size=32, device="cpu")
assert bench.saturated[0]["image"].shape == (32, 32, 3)
# the VAE's adversarial steps, the STR hub (each model, PARSeq's permuted
# loss), the STR metrics and config instantiation
from udifftext_tpu_torch import config as pconfig, str_eval
from udifftext_tpu_torch.diffusion import vae_loss
from udifftext_tpu_torch.models import discriminator, parseq, str_hub
vae = bundle.engine.vae.requires_grad_(True)
disc = discriminator.NLayerDiscriminator(ndf=8, n_layers=2)
ae_step, disc_step = vae_loss.make_vae_train_steps(
    vae_loss.VAEGanLossConfig(), vae, disc, torch.optim.Adam(vae.parameters(), 1e-4),
    torch.optim.Adam(disc.parameters(), 1e-4), lambda a, b: (a - b).square().mean((1, 2, 3)))
x = torch.zeros(1, 32, 32, 3)
eps = torch.randn(vae.encode_moments(x).shape[:-1] + (4,))
ae_state = {"logvar": torch.zeros(()), "step": 0}
assert all(bool(torch.isfinite(s(ae_state, x, eps)[0])) for s in (ae_step, disc_step))
tiny_parseq = {"embed_dim": 16, "enc_depth": 1, "enc_num_heads": 2, "dec_num_heads": 2,
               "max_label_length": 4}
for name, kw in (("parseq", tiny_parseq), ("vitstr", {"embed_dim": 16, "depth": 1, "num_heads": 2}),
                 ("abinet", {"d_model": 32, "d_inner": 32, "v_num_layers": 1,
                             "l_num_layers": 1, "iter_size": 1}),
                 ("trba", {"hidden": 16, "output_channel": 32}), ("crnn", {"hidden": 16})):
    m = str_hub.create_model(name, device="cpu", **kw)
    with torch.no_grad():
        assert bool(torch.isfinite(m(torch.zeros(1, 32, 128, 3))).all())
ids = torch.from_numpy(parseq.ParseqTokenizer().encode(["ab"], 4))
assert bool(torch.isfinite(parseq.parseq_training_loss(
    str_hub.create_model("parseq", device="cpu", **tiny_parseq), torch.zeros(1, 32, 128, 3), ids,
    parseq.gen_tgt_perms(np.random.default_rng(0), 4))))
assert str_eval.evaluate_predictions(["ab"], ["AB"], [0.5]).correct == 1
assert pconfig.instantiate_from_config(
    {"target": "sgm.modules.diffusionmodules.guiders.VanillaCFG"}).scale == 5.0
# the STR data path and tools: an LMDB through open_lmdb, a trainer step with
# SWA, str_test's evaluate_set
from udifftext_tpu_torch.data.lmdb import open_lmdb, write_lmdb
from udifftext_tpu_torch.ocr import ParseqPredictor
from udifftext_tpu_torch.scripts import str_test, str_train
db_dir = os.path.join(sys.argv[2], "str_lmdb")
write_lmdb(db_dir, {b"num-samples": b"2", b"image-000000001": png.encode_png(
    np.zeros((20, 50, 3), np.uint8)), b"label-000000001": b"ab",
    b"image-000000002": png.encode_png(np.full((16, 40, 3), 200, np.uint8)),
    b"label-000000002": b"c1"})
with open_lmdb(db_dir) as db:
    assert db.get(b"num-samples") == b"2"
items = str_test.load_folder(db_dir)
str_parseq = dict(tiny_parseq, max_label_length=25)  # the trainer's labels are 25 wide
res = str_train.train(items, str_hub.create_model("parseq", device="cpu", **str_parseq),
                      torch.device("cpu"), np.random.default_rng(0), steps=2, batch=2,
                      warmup_pct=0.5, swa=True, swa_start_pct=0.5, log=lambda s: None)
assert res.swa_n == 1 and all(np.isfinite(res.losses))
reader = ParseqPredictor(str_hub.create_model("parseq", device="cpu", **str_parseq))
assert str_test.evaluate_set(reader, items, 2, 90, "abc1").num_samples == 2
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "udifftext_tpu", "scripts")
             or m.startswith("str_"))
print(json.dumps(bad))
"""


def test_port_never_imports_jax(tmp_path):
    """Sampling (plain, AAE and encoder propagation), the encprop quality
    script, one training step, the train and eval CLIs' entry functions, a
    LabelEncoder pretraining step, the FID of the eval CLI's files, the
    three probes, the demo CLI, a checkpoint load, the serving benchmark, a
    step of each VAE GAN optimizer, every STR hub model, PARSeq's permuted
    loss, the STR metrics, a config instantiation, an LMDB read through
    open_lmdb, two STR trainer steps with SWA and str_test's evaluate_set in
    a fresh process leave jax, flax, optax, the JAX package and the root
    `scripts` package out of sys.modules."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT, json.dumps(U.tiny_model_cfg()), str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_port_sources_name_no_jax_package():
    """No source of the port, nor the GPU smoke script, imports jax, flax,
    optax, the JAX package `udifftext_tpu` (the port's own package name starts with
    it, so the match ends at a word boundary), the root `scripts` package or a
    root script by its bare name (`from str_test import`, as the JAX STR tools do)."""
    pat = re.compile(r"^\s*(?:import|from)\s+(?:udifftext_tpu|jax|jaxlib|flax|optax|scripts|"
                     r"str_\w+)\b(?!_)", re.M)
    files = sorted((REPO / "udifftext_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in pat.finditer(f.read_text())]
    assert hits == []
    assert pat.search("from udifftext_tpu.config import load_config")
    assert pat.search("    import jax.numpy as jnp") and pat.search("import udifftext_tpu")
    assert pat.search("import optax")
    assert pat.search("from scripts.str_test import load_folder")
    assert pat.search("    from str_test import TEST_BENCHMARK") and pat.search("import scripts")
    assert not pat.search("from udifftext_tpu_torch.config import load_config")
    assert not pat.search("from .str_test import load_folder")
    assert not pat.search("from udifftext_tpu_torch.scripts import str_test")


def test_config_reader_matches_the_jax_package():
    from udifftext_tpu import config as jax_config
    from udifftext_tpu_torch import config

    path = str(REPO / "configs" / "demo.yaml")
    got, want = config.load_config(path), jax_config.load_config(path)
    assert got == want and isinstance(got, config.ConfigNode)
    node = config.ConfigNode.wrap({"a": {"b": [1, {"c": 2}]}, "d": "x"})
    assert node.a.b[1].c == 2 and node.d == "x" and node.get("e", 3) == 3
    node.e = 4
    assert node["e"] == 4
    with pytest.raises(AttributeError):
        node.missing


def test_build_engine_defaults_to_the_gpu():
    """No silent CPU engine: the default device is the card, and without one
    the default fails; the tests ask for "cpu"."""
    import inspect

    assert inspect.signature(build_engine).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            build_engine(U.tiny_model_cfg(), torch.float32)
