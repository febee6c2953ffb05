"""FID and LPIPS on the port (`udifftext_tpu_torch.metrics`,
`models/inception.py`, `models/lpips.py`) against the JAX package on the
CPU:

- `FIDInceptionV3` on a 75² input without the resize (the body; fp32, 1e-4
  relative to the features' scale), its 299² bilinear resize alone on
  64² and 384×512 inputs (1e-5), and `LPIPSAlex` on 64² pairs (1e-5): the
  weights either as state dicts in pytorch_fid's and lpips' own key layouts
  (tests/test_metrics.py's torch re-statements of those networks), which the
  port loads without a converter and the JAX package through
  `convert_fid_inception` / `convert_lpips_alex` (both lpips layouts: the
  full dump, and the lin-only file with torchvision AlexNet's weights), or
  as seeded JAX params carried across by `utils/convert.py`;
- the Frechet distance and statistics against the JAX functions;
- `calc_fid` / `calc_lpips` with overrides over PNGs written by
  `utils/png.write_png` (the JAX functions' values on the same files), the
  "skipped" path without weights, the image reader with and without Pillow;
- the eval CLI's `quan_test` on the tiny engine with the environment
  variables pointing at random-weight dumps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_port_util as U
from test_metrics import TLPIPS, TFIDInception, _randomize_bn
from udifftext_tpu.models.inception import FIDInceptionV3 as JInception
from udifftext_tpu.models.lpips import LPIPSAlex as JLPIPS
from udifftext_tpu.utils.ckpt_torch import convert_fid_inception, convert_lpips_alex
from udifftext_tpu_torch import metrics
from udifftext_tpu_torch import test as eval_cli
from udifftext_tpu_torch.builders import build_engine, randomize_parameters
from udifftext_tpu_torch.data.synthetic import SyntheticBatches
from udifftext_tpu_torch.models.inception import (FIDInceptionV3, fid_inception_features,
                                                  fid_resize)
from udifftext_tpu_torch.models.lpips import LPIPSAlex, lpips_alex_state_dict
from udifftext_tpu_torch.utils import convert, png

T = torch.from_numpy
ENV = ("UDIFFTEXT_FID_WEIGHTS", "UDIFFTEXT_LPIPS_WEIGHTS", "UDIFFTEXT_ALEXNET_WEIGHTS")


def _jparams(tree):
    return {"params": jax.tree.map(jnp.asarray, tree)}


def _nchw(x: np.ndarray) -> torch.Tensor:
    return T(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def fid_state_dict(seed: int = 0):
    """A pytorch_fid-layout InceptionV3 state dict of seeded random weights
    (BN statistics included), with an auxiliary head and fc as the
    published file has. The convolutions are He-scaled, so that the pool3
    features still depend on the input (at torch's default scale, the BN
    shifts swamp the shrinking activations and every input gives the same
    features)."""
    torch.manual_seed(seed)
    model = TFIDInception().eval()
    gen = torch.Generator().manual_seed(seed)
    _randomize_bn(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * (2 / fan_in) ** 0.5)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sd.update({"AuxLogits.fc.weight": torch.zeros(1000, 768), "fc.weight": torch.zeros(1000, 2048),
               "fc.bias": torch.zeros(1000)})
    return sd


def lpips_state_dicts(seed: int = 0):
    """(full lpips.LPIPS(net='alex') dump, lin-only dump, torchvision AlexNet
    dump) of seeded random weights, non-negative lin weights as lpips'."""
    torch.manual_seed(seed)
    model = TLPIPS().eval()
    with torch.no_grad():
        for i in range(5):
            getattr(model, f"lin{i}")[1].weight.abs_()
    sd = {(k.replace(".1.weight", ".model.1.weight") if k.startswith("lin") else k):
          v.detach().clone() for k, v in model.state_dict().items()}
    full = dict(sd, **{"scaling_layer.shift": model.shift.clone(),
                       "scaling_layer.scale": model.scale.clone()})
    lin_only = {k: v for k, v in sd.items() if k.startswith("lin")}
    alexnet = {f"features.{k.split('.')[2]}.{k.split('.')[3]}": v for k, v in sd.items()
               if k.startswith("net.")}
    alexnet.update({"classifier.1.weight": torch.zeros(4096, 9216),
                    "classifier.1.bias": torch.zeros(4096)})
    return full, lin_only, alexnet


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _rel_close(got, want, rtol, what):
    """|got − want| <= rtol·max|want| elementwise."""
    want = np.asarray(want)
    U.assert_close(got, want, 0, rtol * float(np.abs(want).max()), what)


def test_fid_inception_loads_pytorch_fid_layout_and_matches_jax():
    sd = fid_state_dict(0)
    port = FIDInceptionV3(resize_input=False)
    port.load_state_dict(fid_inception_features(sd), strict=True)
    conv = convert_fid_inception(_np(sd))
    assert not conv["unknown"]
    x = np.random.RandomState(1).rand(2, 75, 75, 3).astype(np.float32)
    want = np.asarray(JInception(resize_input=False).apply(_jparams(conv["params"]),
                                                           jnp.asarray(x)))
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    assert got.shape == (2, 2048) and np.abs(want[0] - want[1]).max() > 0.01 * np.abs(want).max()
    _rel_close(got, want, 1e-4, "pool3")
    # BatchNorm keeps its running statistics in train mode too
    with torch.no_grad():
        assert torch.equal(port.train()(_nchw(x)), got)


def test_fid_inception_from_jax_params():
    jm = JInception(resize_input=False)
    tree = U.flax_params(jm, 4, jnp.zeros((1, 75, 75, 3)))["params"]

    def fix(path, v):  # positive variances, as BN statistics are
        return np.abs(v) + 0.5 if path[-1].key == "bn_var" else v

    tree = jax.tree_util.tree_map_with_path(fix, tree)
    port = U.load_port(FIDInceptionV3(resize_input=False), convert.inception_from_jax(tree))
    x = np.random.RandomState(2).rand(1, 75, 75, 3).astype(np.float32)
    want = np.asarray(jm.apply(_jparams(tree), jnp.asarray(x)))
    with torch.no_grad():
        got = port(_nchw(x))
    _rel_close(got, want, 1e-4, "pool3")


@pytest.mark.parametrize("hw", [(64, 64), (384, 512)], ids=["up_64", "down_384x512"])
def test_fid_resize_matches_jax(hw):
    x = np.random.RandomState(3).rand(2, *hw, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear",
                                       antialias=False))
    got = fid_resize(_nchw(x)).permute(0, 2, 3, 1)
    U.assert_close(got, want, 1e-5, 1e-5, "resize")


@pytest.mark.parametrize("layout", ["full", "lin_only"])
def test_lpips_loads_lpips_layouts_and_matches_jax(layout):
    full, lin_only, alexnet = lpips_state_dicts(5)
    port = LPIPSAlex().eval()
    if layout == "full":
        port.load_state_dict(full, strict=True)  # the lpips dump itself
        conv = convert_lpips_alex(_np(full))
    else:
        port.load_state_dict(lpips_alex_state_dict(lin_only, alexnet), strict=True)
        conv = convert_lpips_alex(_np(lin_only), _np(alexnet))
    assert not conv["unknown"]
    rs = np.random.RandomState(6)
    a, b = (rs.rand(2, 64, 64, 3).astype(np.float32) * 2 - 1 for _ in range(2))
    want = np.asarray(JLPIPS().apply(_jparams(conv["params"]), jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = port(_nchw(a), _nchw(b))
    assert got.shape == (2,)
    U.assert_close(got, want, 1e-5, 1e-6, "lpips")


def test_lpips_from_jax_params():
    jm = JLPIPS()
    tree = U.flax_params(jm, 7, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 3)))["params"]
    port = U.load_port(LPIPSAlex(), convert.lpips_from_jax(tree))
    rs = np.random.RandomState(8)
    a, b = (rs.rand(1, 64, 96, 3).astype(np.float32) * 2 - 1 for _ in range(2))
    want = np.asarray(jm.apply(_jparams(tree), jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = port(_nchw(a), _nchw(b))
    U.assert_close(got, want, 1e-5, 1e-6, "lpips")


def test_frechet_distance_matches_jax():
    import metrics as jmetrics

    f = np.random.RandomState(0).randn(64, 8)
    mu, sig = metrics.activation_statistics(f)
    assert abs(metrics.frechet_distance(mu, sig, mu, sig)) < 1e-6
    g = np.random.RandomState(1).randn(40, 8) * 1.5 + 0.3
    mu2, sig2 = metrics.activation_statistics(g)
    want = jmetrics.frechet_distance(*jmetrics.activation_statistics(f),
                                     *jmetrics.activation_statistics(g))
    assert metrics.frechet_distance(mu, sig, mu2, sig2) == pytest.approx(want, rel=1e-12)


def _write_dirs(root, n=3, hw=(32, 32)):
    for d in ("real", "fake"):
        (root / d).mkdir()
        for i in range(n):
            rs = np.random.RandomState(i + (0 if d == "real" else 10))
            png.write_png(str(root / d / f"{i}.png"), (rs.rand(*hw, 3) * 255).astype(np.uint8))


def test_calc_fid_and_lpips_with_overrides_match_jax(tmp_path):
    import metrics as jmetrics

    _write_dirs(tmp_path)
    fake, real = str(tmp_path / "fake"), str(tmp_path / "real")

    def feature_fn(x):
        return x.reshape(x.shape[0], -1)[:, :16]

    def distance_fn(a, b):
        return float(np.mean((a - b) ** 2))

    fid = metrics.calc_fid(fake, real, feature_fn=feature_fn, batch_size=2)
    assert np.isfinite(fid)
    assert fid == pytest.approx(jmetrics.calc_fid(fake, real, feature_fn=feature_fn), rel=1e-6)
    lp = metrics.calc_lpips(fake, real, distance_fn=distance_fn)
    assert lp == pytest.approx(jmetrics.calc_lpips(fake, real, distance_fn=distance_fn),
                               rel=1e-6)


def test_calc_skips_cleanly_without_weights(tmp_path, capsys, monkeypatch):
    for name in ENV:
        monkeypatch.setenv(name, str(tmp_path / "absent.pth"))
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    assert metrics.calc_fid(str(tmp_path / "a"), str(tmp_path / "b")) is None
    assert metrics.calc_lpips(str(tmp_path / "a"), str(tmp_path / "b")) is None
    out = capsys.readouterr().out
    assert "FID skipped" in out and "LPIPS skipped" in out and str(tmp_path / "absent.pth") in out
    # lin-only LPIPS weights without the AlexNet file
    _, lin_only, _ = lpips_state_dicts(0)
    torch.save(lin_only, tmp_path / "lin.pth")
    assert metrics.load_lpips_distance_fn(str(tmp_path / "lin.pth"), device="cpu") is None
    assert "has only lin weights" in capsys.readouterr().out


def test_read_rgb_png_and_pillow(tmp_path, monkeypatch):
    gray = (np.arange(12, dtype=np.uint8) * 20).reshape(3, 4)
    png.write_png(str(tmp_path / "g.png"), gray)
    np.testing.assert_array_equal(metrics.read_rgb(str(tmp_path / "g.png")),
                                  np.repeat(gray[..., None], 3, -1) / np.float32(255))
    rgb = np.random.RandomState(0).randint(0, 255, (5, 6, 3)).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "pil.png")  # Pillow's row filters
    Image.fromarray(rgb).save(tmp_path / "x.bmp")
    for name in ("pil.png", "x.bmp"):
        np.testing.assert_array_equal(metrics.read_rgb(str(tmp_path / name)),
                                      rgb / np.float32(255))
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ValueError, match="needs Pillow"):
        metrics.read_rgb(str(tmp_path / "x.bmp"))


def test_extractors_from_files_on_the_callers_device(tmp_path):
    sd = fid_state_dict(1)
    torch.save(sd, tmp_path / "fid.pth")
    _, lin_only, alexnet = lpips_state_dicts(2)
    torch.save(lin_only, tmp_path / "lin.pth")
    torch.save(alexnet, tmp_path / "alex.pth")
    features = metrics.load_inception_feature_fn(str(tmp_path / "fid.pth"), device="cpu")
    distance = metrics.load_lpips_distance_fn(str(tmp_path / "lin.pth"),
                                              str(tmp_path / "alex.pth"), device="cpu")
    rs = np.random.RandomState(3)
    x = rs.rand(2, 40, 48, 3).astype(np.float32)
    ref = FIDInceptionV3()
    ref.load_state_dict(fid_inception_features(sd))
    with torch.no_grad():  # features() convolves the channels-last view: another summation order
        _rel_close(features(x), ref.eval()(_nchw(x)).numpy(), 1e-5, "pool3")
    lp = LPIPSAlex()
    lp.load_state_dict(lpips_alex_state_dict(lin_only, alexnet))
    with torch.no_grad():
        want = float(lp.eval()(_nchw(x[:1]) * 2 - 1, _nchw(x[1:]) * 2 - 1)[0])
    assert distance(x[0], x[1]) == pytest.approx(want, rel=1e-5)


def test_eval_cli_quan_test(tmp_path, capsys, monkeypatch):
    """quan_test on the tiny engine: FID and LPIPS of fake/ against real/
    through the files the variables name; without them, the skipped lines."""
    torch.save(fid_state_dict(4), tmp_path / "fid.pth")
    _, lin_only, alexnet = lpips_state_dicts(5)
    torch.save(lin_only, tmp_path / "lin.pth")
    torch.save(alexnet, tmp_path / "alex.pth")
    for name, file in zip(ENV, ("fid.pth", "lin.pth", "alex.pth")):
        monkeypatch.setenv(name, str(tmp_path / file))
    bundle = build_engine(U.tiny_model_cfg(), torch.float32, "cpu")
    randomize_parameters(bundle.engine, 0)
    batches = SyntheticBatches(3, 1, size=32, seed=4).batches
    for i, b in enumerate(batches):
        b["name"] = [f"s{i}"]
    cfgs = {"output_dir": str(tmp_path / "out"), "temp_dir": str(tmp_path / "temp"),
            "noise_iters": 0, "quan_test": True}
    res = eval_cli.test(bundle, bundle.sampler, batches, cfgs, seed=0)
    out = capsys.readouterr().out
    assert "FID: " in out and "lpips score: " in out
    assert np.isfinite(res["fid"]) and np.isfinite(res["lpips"]) and res["lpips"] > 0
    monkeypatch.setenv(ENV[0], str(tmp_path / "absent.pth"))
    monkeypatch.setenv(ENV[1], str(tmp_path / "absent.pth"))
    res = eval_cli.test(bundle, bundle.sampler, batches[:1], cfgs, seed=0)
    out = capsys.readouterr().out
    assert res["fid"] is None and res["lpips"] is None
    assert "FID skipped" in out and "LPIPS skipped" in out
    assert os.path.exists(tmp_path / "out" / "fake" / "s0.png")
