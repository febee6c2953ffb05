"""The port's demo entry point on the CPU: its charset and float batch
against the JAX build's (`udifftext_tpu.charset`, the root demo.py's
`build_batch`), and `python -m udifftext_tpu_torch.demo` as a one-shot on
the tiny model graph, with seeded random weights and with a checkpoint."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from test_cli_scripts import TINY_MODEL_YAML
from udifftext_tpu import charset as jax_charset
from udifftext_tpu_torch import charset, demo

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("labels", [["HELLO"], ["a b", "Zz9!~"], ["", "é\t?"]])
def test_charset_matches_jax(labels):
    assert charset.NUM_CLASSES == jax_charset.NUM_CLASSES
    np.testing.assert_array_equal(charset.encode_labels(labels, 12),
                                  jax_charset.encode_labels(labels, 12))
    with pytest.raises(ValueError):
        charset.encode_label("x" * 13, 12)


@pytest.fixture(scope="module")
def jax_demo():
    """The root demo.py, loaded under another name than the port's module."""
    spec = importlib.util.spec_from_file_location("jax_root_demo", REPO / "demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("src_hw", [(32, 40), (16, 20)], ids=["same_size", "upscale_2x"])
def test_build_batch_matches_jax_demo(jax_demo, src_hw):
    """Same fields as the JAX demo's batch. The JAX build resizes uint8 with
    cv2 (rounded to uint8); the port resizes in float with the same bilinear
    rule, so the image agrees within one uint8 level (2/255 in [-1, 1])."""
    h, w = src_hw
    rs = np.random.RandomState(0)
    image = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[h // 4: 3 * h // 4, w // 5: 4 * w // 5] = 255
    got = demo.build_batch(image, mask, "Hi!", 32, 40, 12)
    want = jax_demo.build_batch(image, mask, "Hi!", 32, 40, 12)
    for key in ("mask", "seg_mask", "label_ids"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("image", "masked"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2 / 255 + 1e-6,
                                   err_msg=key)
    if (h, w) == (32, 40):
        np.testing.assert_array_equal(got["image"], want["image"])


@pytest.fixture
def demo_dir(tmp_path, monkeypatch):
    """A working directory with ./configs/demo.yaml naming the tiny graph."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "tiny.yaml").write_text(TINY_MODEL_YAML)
    with open(REPO / "configs" / "demo.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg.update(model_cfg_path="./configs/tiny.yaml", load_ckpt_path="./ckpt/model.ckpt",
               H=32, W=32, noise_iters=2, steps=2)
    (tmp_path / "configs" / "demo.yaml").write_text(yaml.safe_dump(cfg))
    rs = np.random.RandomState(1)
    Image.fromarray(rs.randint(0, 256, (48, 40, 3)).astype(np.uint8)).save(tmp_path / "in.png")
    mask = np.zeros((48, 40), np.uint8)
    mask[12:36, 8:32] = 255
    Image.fromarray(mask).save(tmp_path / "mask.png")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_demo_cli_one_shot(demo_dir, capsys):
    args = ["--image", "in.png", "--mask", "mask.png", "--text", "ab", "--out", "out.png"]
    if not torch.cuda.is_available():  # the default device is the GPU: no silent CPU run
        with pytest.raises(SystemExit, match="no CUDA device"):
            demo.main(args)
        assert not (demo_dir / "out.png").exists()
    args += ["--device", "cpu"]
    demo.main(args)
    out = np.asarray(Image.open(demo_dir / "out.png"))
    assert out.shape == (32, 32, 3) and out.dtype == np.uint8 and out.std() > 0

    # with a checkpoint at load_ckpt_path, the demo loads it and samples with it
    from udifftext_tpu_torch.builders import build_engine, randomize_parameters

    src = randomize_parameters(build_engine(yaml.safe_load(TINY_MODEL_YAML)["model"]["params"],
                                            torch.float32, "cpu").engine, 9)
    sd = {f"{prefix}{k}": v for name, prefix in (("unet", "model.diffusion_model."),
                                                 ("vae", "first_stage_model."),
                                                 ("label_encoder", "conditioner.embedders.0."))
          for k, v in getattr(src, name).state_dict().items()}
    (demo_dir / "ckpt").mkdir()
    torch.save({"state_dict": sd}, demo_dir / "ckpt" / "model.ckpt")
    capsys.readouterr()
    demo.main(args[:-2] + ["--out", "loaded.png", "--device", "cpu"])
    printed = capsys.readouterr().out
    for name in ("unet", "vae", "label_encoder"):
        assert f"[{name}] merged with 0 missing, 0 unexpected, 0 mismatched keys" in printed
    loaded = np.asarray(Image.open(demo_dir / "loaded.png"))
    assert loaded.shape == (32, 32, 3) and not np.array_equal(loaded, out)
