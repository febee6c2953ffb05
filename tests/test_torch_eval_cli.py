"""The port's evaluation CLI (`udifftext_tpu_torch.test`) and the pieces it
adds, against the JAX package on the CPU, on the tiny model graph
(tests/test_cli_scripts.py TINY_MODEL_YAML, 32² images) with shared seeded
weights and the JAX engine's own draws injected:

- the conditioner's `batch_uc` and `force_uc_zero_label`, and
  `prepare_batch`, against the JAX functions (1e-5; the batch helpers exact);
- `engine.sample(latent_hw=...)` on a rectangular latent through the search,
  the middle-step maps and the decode, and `engine.log_images`, against the
  JAX engine (1e-3, as sampling is held in tests/test_torch_engine.py);
- `average_attn_maps` on the same arrays (1e-6);
- the PNG writer read back by Pillow (bit-equal, RGB and L);
- the port's `test()` and the JAX `test()` on one ICDAR13 fixture: the same
  file names, the same real/ pixels; the OCR lines with a random PARSeq file;
  attend-and-excite and map capture writing the GIF, the map grid and the
  segment map; quan_test without weights; the options that raise; the CLI
  needing `--device cpu` without a GPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import torch_port_util as U
from test_cli_scripts import workspace  # noqa: F401 (fixture)
from udifftext_tpu.builders import build_diffusion_engine
from udifftext_tpu.conditioning import Conditioner as JConditioner
from udifftext_tpu.utils import viz as jviz
from udifftext_tpu_torch import test as port_test
from udifftext_tpu_torch import util as port_util
from udifftext_tpu_torch.builders import build_engine, randomize_parameters
from udifftext_tpu_torch.conditioning import Conditioner
from udifftext_tpu_torch.models.parseq import PARSeq
from udifftext_tpu_torch.utils import convert, png, viz

REPO = Path(__file__).resolve().parent.parent
T = torch.from_numpy
RTOL = ATOL = 1e-3


@pytest.fixture(scope="module")
def engines():
    cfg = U.tiny_model_cfg()
    je = build_diffusion_engine(cfg, unet_dtype=jnp.float32).engine
    params = U.engine_params(je, seed=11)
    pe = U.load_port(build_engine(cfg, torch.float32, "cpu").engine,
                     convert.engine_from_jax(params))
    return je, params, pe


def _rect_batch(b: int, h: int, w: int, seed: int):
    """numpy_batch's fields at an h×w image size."""
    rs = np.random.RandomState(seed)
    mask = np.zeros((b, h, w, 1), np.float32)
    mask[:, h // 4:3 * h // 4, w // 5:4 * w // 5] = 1.0
    seg_mask = np.zeros((b, U.SEQ), np.float32)
    seg_mask[:, :3] = 1.0
    image = rs.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    from udifftext_tpu import charset

    return {"image": image, "masked": image * (1 - mask), "mask": mask, "seg_mask": seg_mask,
            "label_ids": charset.encode_labels(["abc"] * b, U.SEQ)}


# --- conditioning and batch helpers ---------------------------------------------


@pytest.mark.parametrize("with_uc", [False, True], ids=["no_batch_uc", "batch_uc"])
@pytest.mark.parametrize("force", [True, False], ids=["force_zero", "no_force"])
def test_batch_uc_conditioning_matches_jax(engines, with_uc, force):
    je, params, pe = engines
    nb = U.numpy_batch(2, seed=3)
    nb_uc = dict(nb, label_ids=np.zeros_like(nb["label_ids"]),
                 masked=nb["masked"] * 0.5)  # an uncond batch that differs in its concat too
    rng = jax.random.PRNGKey(4)
    jc = JConditioner(je.label_encoder, je.vae, je.scale_factor, 0.1, mask_multiplier=0.5)
    want_c, want_uc = jc.get_unconditional_conditioning(
        params["label_encoder"], params["vae"], U.to_jax(nb),
        batch_uc=U.to_jax(nb_uc) if with_uc else None, rng=rng, force_uc_zero_label=force)
    # the posterior sample's draw: the conditioner splits rng into (ucg, vae)
    eps = np.array(jax.random.normal(jax.random.split(rng)[1], (2, U.LAT, U.LAT, 4)))
    pc = Conditioner(pe.label_encoder, pe.vae, pe.scale_factor, mask_multiplier=0.5)
    got_c, got_uc = pc.get_unconditional_conditioning(
        U.to_torch(nb), T(eps), force_uc_zero_label=force,
        batch_uc=U.to_torch(nb_uc) if with_uc else None)
    for name in ("t_crossattn", "concat"):
        U.assert_close(got_c[name], want_c[name], 1e-5, 1e-5, f"c[{name}]")
        U.assert_close(got_uc[name], want_uc[name], 1e-5, 1e-5, f"uc[{name}]")
    assert bool((got_uc["t_crossattn"] == 0).all()) == force
    # the engine's entry: without batch_uc, as the sampler calls it
    ec, euc = pe.conditionings(U.to_torch(nb), T(eps), force_uc_zero_label=force)
    if not with_uc:
        for name in ("t_crossattn", "concat"):
            assert torch.equal(ec[name], got_c[name]) and torch.equal(euc[name], got_uc[name])


def test_prepare_batch_matches_jax():
    import util as jutil

    nb = U.numpy_batch(2, seed=1)
    nb.update(label=["abc", "de"], name=["a", "b"], txt=["x", "y"])
    for batch in (nb, dict(nb, ntxt=["n1", "n2"])):
        want_b, want_uc = jutil.prepare_batch({}, batch)
        got_b, got_uc = port_util.prepare_batch({}, batch, "cpu")
        for got, want in ((got_b, want_b), (got_uc, want_uc)):
            assert set(got) == set(want)
            for k, w in want.items():
                if isinstance(w, jax.Array):
                    assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
                    U.assert_close(got[k], np.asarray(w), 1e-5, 1e-5, k)
                else:
                    assert got[k] == w, k
    assert port_util.init_model.__module__ == "udifftext_tpu_torch.loading"
    obj = np.array(["a"], dtype=object)
    assert port_util.numpy_batch_to_device({"s": obj}, "cpu")["s"] is obj


# --- sampling -------------------------------------------------------------------


def _sample_draws(key, shape, k):
    """The tiny graph's draws for JAX sample(key): the GeneralConditioner's
    LatentEncoder samples with split(rng_cond, 6)[4]; the sequential search
    splits rng_noise into k candidates (noise_iters=0: normal(rng_noise))."""
    rng_cond, rng_noise = jax.random.split(key)
    eps = np.array(jax.random.normal(jax.random.split(rng_cond, 6)[4], shape))
    if k == 0:
        return eps, np.array(jax.random.normal(rng_noise, shape))[None]
    return eps, np.stack([np.asarray(jax.random.normal(kk, shape))
                          for kk in jax.random.split(rng_noise, k)])


def test_sample_rectangular_latent_matches_jax(engines):
    """A 32×64 image, latent (16, 32): the sequential search (2 candidates),
    3 CFG steps with the middle step's maps captured, the decode."""
    je, params, pe = engines
    h, w, k, steps = 32, 64, 2, 3
    nb = _rect_batch(1, h, w, seed=8)
    key = jax.random.PRNGKey(5)
    latent_hw = (h // 2, w // 2)
    want_img, want_aux = je.sample(params, U.to_jax(nb), key, num_steps=steps, cfg_scale=5.0,
                                   noise_iters=k, detailed=True, latent_hw=latent_hw)
    eps, cands = _sample_draws(key, (1,) + latent_hw + (4,), k)
    img, aux = pe.sample(U.to_torch(nb), num_steps=steps, cfg_scale=5.0, noise_iters=k,
                         detailed=True, posterior_eps=T(eps), noise=T(cands), latent_hw=latent_hw)
    assert img.shape == (1, h, w, 3)
    U.assert_close(img, np.asarray(want_img), RTOL, ATOL, "decoded image")
    maps = {n: v for n, v in aux.items() if n.endswith("t_attn")}
    assert set(maps) == set(want_aux) and len(maps) == 7  # attention at ds 1 and 2
    for n, v in maps.items():
        U.assert_close(v, np.asarray(want_aux[n]), RTOL, ATOL, n)
    with pytest.raises(ValueError, match="noise must be"):
        pe.sample(U.to_torch(nb), num_steps=1, noise_iters=k, posterior_eps=T(eps),
                  noise=T(cands), latent_hw=(8, 8))


def test_log_images_matches_jax(engines):
    je, params, pe = engines
    nb = U.numpy_batch(3, seed=6)
    key = jax.random.PRNGKey(9)
    want = je.log_images(params, U.to_jax(nb), key, n=2, num_steps=2, cfg_scale=5.0)
    rng_enc, rng_samp = jax.random.split(key)
    shape = (2, U.LAT, U.LAT, 4)
    image_eps = np.array(jax.random.normal(rng_enc, shape))
    eps, noise = _sample_draws(rng_samp, shape, 0)
    got = pe.log_images(U.to_torch(nb), n=2, num_steps=2, cfg_scale=5.0, image_eps=T(image_eps),
                        posterior_eps=T(eps), noise=T(noise))
    assert set(got) == set(want) == {"inputs", "reconstructions", "samples"}
    for name, v in got.items():
        assert v.shape == (2, U.IMG, U.IMG, 3), name
        U.assert_close(v, np.asarray(want[name]), RTOL, ATOL, name)
    drawn = pe.log_images(U.to_torch(nb), torch.Generator().manual_seed(0), n=1, num_steps=1,
                          sample=False)
    assert set(drawn) == {"inputs", "reconstructions"}


# --- viz and png ----------------------------------------------------------------


@pytest.mark.parametrize("case", ["square", "mixed", "layers", "rect"])
def test_average_attn_maps_matches_jax(case):
    rs = np.random.RandomState(0)
    n_of = {"square": (64, 64), "mixed": (64, 16), "layers": (64, 16), "rect": (32, 32)}[case]
    maps = {f"output_blocks.{i}.1.t_attn": rs.rand(2, 4, n, 12).astype(np.float32)
            for i, n in enumerate(n_of)}
    maps["output_blocks.0.1.v_attn"] = rs.rand(2, 4, 64, 12).astype(np.float32)
    layers = ["output_blocks.1"] if case == "layers" else None
    got = viz.average_attn_maps(maps, layers=layers)
    want = jviz.average_attn_maps(maps, layers=layers)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="no attention maps"):
        viz.average_attn_maps(maps, layers=["input_blocks"])


def test_segment_map_matches_jax(tmp_path):
    maps = np.random.RandomState(1).rand(2, 12, 8, 8).astype(np.float32)
    for tokens in ("abc", ""):
        viz.save_segment_map(maps, tokens, str(tmp_path / "p" / "seg.npy"))
        jviz.save_segment_map(maps, tokens, str(tmp_path / "j" / "seg.npy"))
        np.testing.assert_array_equal(np.load(tmp_path / "p" / "seg.npy"),
                                      np.load(tmp_path / "j" / "seg.npy"))


@pytest.mark.parametrize("shape", [(7, 13, 3), (5, 9), (4, 6, 1)], ids=["rgb", "l", "l1"])
def test_png_writer_read_back_by_pillow(tmp_path, shape):
    arr = np.random.RandomState(2).randint(0, 256, shape).astype(np.uint8)
    path = png.write_png(str(tmp_path / "x.png"), arr)
    with Image.open(path) as im:
        assert im.mode == ("RGB" if len(shape) == 3 and shape[2] == 3 else "L")
        back = np.asarray(im)
    flat = arr if arr.ndim == 2 or arr.shape[2] == 3 else arr[..., 0]
    assert back.dtype == np.uint8 and np.array_equal(back, flat)
    assert np.array_equal(png.read_png(path), flat)


def test_png_writer_and_reader_refuse(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(np.zeros((2, 2, 3), np.float32))
    with pytest.raises(ValueError, match="H, W"):
        png.encode_png(np.zeros((2, 2, 4), np.uint8))
    good = png.encode_png(np.full((3, 3, 3), 7, np.uint8))
    (tmp_path / "bad.png").write_bytes(good[:-5] + b"\x00" + good[-4:])
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(str(tmp_path / "bad.png"))
    Image.fromarray(np.random.RandomState(0).randint(0, 256, (16, 16, 3)).astype(np.uint8)).save(
        tmp_path / "pil.png")  # Pillow picks its own row filters
    with pytest.raises(ValueError, match="filter"):
        png.read_png(str(tmp_path / "pil.png"))


# --- the CLI --------------------------------------------------------------------


def _cfgs(ws, out, **over):
    cfgs = {"model_cfg_path": str(ws / "model.yaml"), "dataset_cfg_path": str(ws / "dataset.yaml"),
            "load_ckpt_path": None, "output_dir": str(ws / out / "outputs"),
            "temp_dir": str(ws / out / "temp"), "scale": [5.0, 0.0], "noise_iters": 0,
            "force_uc_zero_embeddings": ["label"], "aae_enabled": False, "detailed": False,
            "bf16": False, "steps": 1, "batch_size": 1, "max_iter": 1, "shuffle": False,
            "quan_test": False, "ocr_enabled": False}
    cfgs.update(over)
    return cfgs


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def parseq_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("parseq") / "parseq.pt"
    torch.save(randomize_parameters(PARSeq(), 3).state_dict(), path)
    return str(path)


def test_eval_cli_matches_jax_test(workspace, parseq_file, capsys):  # noqa: F811
    """Both test() flows on the ICDAR13 fixture write the same files, and the
    same real/ pixels; the port's reads the box with a random PARSeq."""
    import test as jax_test
    from udifftext_tpu.config import ConfigNode
    from udifftext_tpu.data import get_dataloader as jax_loader
    from udifftext_tpu_torch.data.loader import get_dataloader
    from udifftext_tpu_torch.loading import init_model, init_sampling
    from util import init_model as jax_init_model, init_sampling as jax_init_sampling

    jcfgs = ConfigNode.wrap(_cfgs(workspace, "jax"))
    bundle, params = jax_init_model(jcfgs, image_size=32)
    jax_test.test(bundle, params, jax_init_sampling(jcfgs), jax_loader(jcfgs, "val"), jcfgs)

    cfgs = _cfgs(workspace, "port", ocr_enabled=True,
                 predictor_config={"params": {"ckpt_path": parseq_file}})
    pbundle = init_model(cfgs, "cpu", seed=0)
    capsys.readouterr()
    res = port_test.test(pbundle, init_sampling(cfgs), get_dataloader(cfgs, "val"), cfgs, seed=3)
    out = capsys.readouterr().out
    assert "seed: 3" in out and f"[parseq] loaded {parseq_file}" in out
    assert "Expected text: ['ab']" in out and "OCR Result:" in out
    assert "OCR test completed. Mean accuracy:" in out
    assert res["total"] == 1 and res["names"] == ["0"] and len(res["seconds"]) == 1

    jout, pout = workspace / "jax" / "outputs", workspace / "port" / "outputs"
    assert _files(pout) == _files(jout) == ["0.png", "fake/0.png", "real/0.png"]
    for name in _files(jout):
        with Image.open(jout / name) as a, Image.open(pout / name) as b:
            assert a.size == b.size and a.mode == b.mode == "RGB", name
            if name.startswith("real"):
                assert np.array_equal(np.asarray(a), np.asarray(b))
    assert png.read_png(str(pout / "0.png")).shape == (32 * 4, 32, 3)
    assert _files(workspace / "port" / "temp") == []


def test_eval_cli_aae_detailed_and_options(workspace, capsys, tmp_path,  # noqa: F811
                                           monkeypatch):
    """Attend-and-excite and map capture write the GIF, the map grid and the
    segment map; a missing PARSeq file disables OCR with the JAX message;
    quan_test without weights files prints the JAX "skipped" lines;
    eval_data_parallel without a process group raises, and encprop is
    refused for a checkpoint with no quality report; a second run wipes the
    first one's files."""
    monkeypatch.setenv("UDIFFTEXT_ENCPROP_REPORTS", str(tmp_path / "reports"))
    monkeypatch.delenv("UDIFFTEXT_ENCPROP_UNGATED", raising=False)
    from udifftext_tpu_torch.data.loader import get_dataloader
    from udifftext_tpu_torch.loading import init_model, init_sampling

    cfgs = _cfgs(workspace, "aae", aae_enabled=True, detailed=True, steps=2, noise_iters=1,
                 ocr_enabled=True, predictor_config={"params": {"ckpt_path": "./none.pt"}})
    bundle = init_model(cfgs, "cpu", seed=0)
    sampler = init_sampling(cfgs)
    stale = workspace / "aae" / "outputs" / "stale.png"
    stale.parent.mkdir(parents=True, exist_ok=True)
    stale.write_bytes(b"x")
    res = port_test.test(bundle, sampler, get_dataloader(cfgs, "val"), cfgs)
    out = capsys.readouterr().out
    assert "[parseq] checkpoint ./none.pt not found — OCR eval disabled" in out
    assert "Local losses: [" in out and "OCR Result" not in out and res["total"] == 0
    assert not stale.exists()
    temp = workspace / "aae" / "temp"
    assert _files(temp) == ["attn_map/attn_map_0.png", "inters/0.gif", "seg_map/seg_0.npy"]
    assert np.load(temp / "seg_map" / "seg_0.npy").shape == (2, 16, 16)  # "ab", the 16² layer
    # quan_test without the metrics' weights: each metric skipped with the JAX message
    for name in ("UDIFFTEXT_FID_WEIGHTS", "UDIFFTEXT_LPIPS_WEIGHTS"):
        monkeypatch.setenv(name, str(tmp_path / "absent.pth"))
    res = port_test.test(bundle, sampler, [], dict(cfgs, quan_test=True))
    out = capsys.readouterr().out
    assert res["fid"] is None and res["lpips"] is None
    assert "FID skipped" in out and "LPIPS skipped" in out
    with pytest.raises(RuntimeError, match="torchrun"):
        port_test.test(bundle, sampler, [], dict(cfgs, eval_data_parallel=True))
    # encprop: the interval reaches the predictor, gated on load_ckpt_path's
    # checkpoint, which has no quality report
    ckpt = tmp_path / "fake.ckpt"
    ckpt.write_bytes(b"weights")
    pred = port_test.make_predictor(dict(cfgs, encprop_interval=2, load_ckpt_path=None), bundle,
                                    sampler)
    assert pred.encprop_interval == 2
    with pytest.raises(RuntimeError, match="no quality report"):
        port_test.make_predictor(dict(cfgs, encprop_interval=2, load_ckpt_path=str(ckpt)), bundle,
                                 sampler)


def test_eval_cli_entry(workspace, tmp_path):  # noqa: F811
    """`python -m udifftext_tpu_torch.test` runs with --device cpu; without a
    GPU and without the flag it stops with a message, before building."""
    cfg_path = tmp_path / "test.yaml"
    cfg_path.write_text(yaml.safe_dump(_cfgs(workspace, "entry")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "udifftext_tpu_torch.test", "--config", str(cfg_path)]
    res = subprocess.run(cmd + ["--device", "cpu"], capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert (workspace / "entry" / "outputs" / "fake" / "0.png").exists()
    if not torch.cuda.is_available():
        res = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=str(tmp_path),
                             timeout=120)
        assert res.returncode != 0 and "--device cpu" in res.stderr


def test_smoke_run_config_is_test_yaml():
    """chip_smoke.py's configs/test.yaml (the card's machine has no PyYAML)
    equals the file, and its phase 12 changes only the keys it lists."""
    import chip_smoke

    with open(REPO / "configs" / "test.yaml") as f:
        assert chip_smoke.TEST_RUN == yaml.safe_load(f)
    got = U.flat_dict(chip_smoke.eval_run_config("/work", "/work/parseq.pt"))
    want = U.flat_dict(chip_smoke.TEST_RUN)
    assert set(got) == set(want)
    assert sorted(k for k in got if got[k] != want[k]) == sorted(chip_smoke.EVAL_OVERRIDES)
