"""The port's Gradio editor (`udifftext_tpu_torch.demo.run_gradio`) and the
demo's dispatch, on the CPU with a stand-in `gradio` module (the real one is
not installed): its Interface records the function and the widgets record
their arguments. The function runs on synthetic editor values of PIL images
through the tiny model graph with seeded random weights."""

import sys
import types

import numpy as np
import pytest
from PIL import Image

from test_cli_scripts import TINY_MODEL_YAML
from udifftext_tpu_torch import config, demo


def _stub_gradio():
    gr = types.ModuleType("gradio")

    class Widget:
        def __init__(self, *args, **kwargs):
            self.args, self.kwargs = args, kwargs
            self.value = kwargs.get("value")

    class Interface:
        def __init__(self, fn, inputs, outputs, title=None):
            self.fn, self.inputs, self.outputs, self.title = fn, inputs, outputs, title
            self.launched = False

        def launch(self):
            self.launched = True

    for name in ("ImageEditor", "Textbox", "Slider", "Number", "Checkbox", "Image"):
        setattr(gr, name, type(name, (Widget,), {}))
    gr.Interface = Interface
    return gr


@pytest.fixture
def gradio(monkeypatch):
    gr = _stub_gradio()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    return gr


@pytest.fixture
def cfgs(tmp_path):
    (tmp_path / "tiny.yaml").write_text(TINY_MODEL_YAML)
    return config.ConfigNode.wrap({
        "model_cfg_path": str(tmp_path / "tiny.yaml"), "load_ckpt_path": str(tmp_path / "none"),
        "H": 32, "W": 32, "seq_len": 12, "noise_iters": 2, "steps": 3, "scale": [4.0, 0.0]})


def _editor(layer=None):
    rs = np.random.RandomState(0)
    bg = Image.fromarray(rs.randint(0, 256, (40, 48, 3)).astype(np.uint8))
    return {"background": bg, "layers": [] if layer is None else [layer], "composite": bg}


def test_editor_mask_from_alpha_and_predictor_cache(gradio, cfgs, monkeypatch):
    """The mask is the first layer's alpha (a dark brush gives a full
    mask), no layer gives none; the batch is the CLI's build_batch of that
    mask; one Predictor serves repeated calls of one setting."""
    built, batches = [], []

    class CountingPredictor(demo.Predictor):
        def __init__(self, *a, **kw):
            built.append(kw)
            super().__init__(*a, **kw)

    real_predict = demo.demo_predict

    def spy(cfgs_, bundle, batch, *a, **kw):
        batches.append(batch)
        return real_predict(cfgs_, bundle, batch, *a, **kw)

    monkeypatch.setattr(demo, "Predictor", CountingPredictor)
    monkeypatch.setattr(demo, "demo_predict", spy)
    monkeypatch.setattr(demo, "_PREDICTORS", {})
    ui = demo.run_gradio(cfgs, device="cpu")
    assert isinstance(ui, gradio.Interface) and ui.launched
    kinds = [type(w).__name__ for w in ui.inputs]
    assert kinds == ["ImageEditor", "Textbox", "Slider", "Slider", "Number", "Checkbox"]
    assert ui.inputs[2].value == 3 and ui.inputs[3].value == 4.0
    assert type(ui.outputs).__name__ == "Image"

    brush = Image.new("RGBA", (48, 40), (0, 0, 0, 255))  # a dark brush over everything
    out = ui.fn(_editor(brush), "ab", 2, 4.0, 0, False)
    assert isinstance(out, Image.Image) and out.size == (32, 32)
    assert batches[-1]["mask"].min() == 1.0
    ui.fn(_editor(brush), "ab", 2, 4.0, 1, False)
    assert len(built) == 1, "one setting, one Predictor"
    ui.fn(_editor(), "ab", 2, 4.0, 0, False)
    assert batches[-1]["mask"].max() == 0.0
    assert len(built) == 1

    half = np.zeros((40, 48, 4), np.uint8)
    half[:, :24, 3] = 255
    ed = _editor(Image.fromarray(half, "RGBA"))
    ui.fn(ed, "xyz", 3, 2.0, 0, False)
    assert len(built) == 2 and built[-1]["num_steps"] == 3 and built[-1]["cfg_scale"] == 2.0
    want = demo.build_batch(np.asarray(ed["background"]), half[..., 3], "xyz", 32, 32, 12)
    assert set(batches[-1]) == set(want)
    for k in want:
        np.testing.assert_array_equal(batches[-1][k], want[k], err_msg=k)
    assert 0 < batches[-1]["mask"].mean() < 1


def test_dispatch(gradio, monkeypatch):
    """The UI when gradio imports and no one-shot argument is given; the
    command line when one is, or when gradio is missing."""
    calls = []
    monkeypatch.setattr(demo, "run_gradio", lambda c, d, s: calls.append(("ui", str(d), s)))
    monkeypatch.setattr(demo, "run_cli", lambda argv: calls.append(("cli", argv)))
    monkeypatch.setattr(demo, "load_config", lambda path: {"path": path})
    demo.main(["--device", "cpu", "--seed", "3"])
    demo.main(["--image", "a.png", "--mask", "m.png", "--text", "x", "--device", "cpu"])
    demo.main(["--text=x"])
    monkeypatch.setitem(sys.modules, "gradio", None)  # import gradio raises ImportError
    demo.main(["--device", "cpu"])
    assert calls == [("ui", "cpu", 3),
                     ("cli", ["--image", "a.png", "--mask", "m.png", "--text", "x",
                              "--device", "cpu"]),
                     ("cli", ["--text=x"]), ("cli", ["--device", "cpu"])]


def test_predictor_cache_key(cfgs, monkeypatch):
    """Each of steps, scale, aae, detailed and the batched search keys its
    own Predictor; the engine too; the seed does not."""
    built = []
    monkeypatch.setattr(demo, "_PREDICTORS", {})

    class Fake:
        def __init__(self, engine, **kw):
            built.append(kw)

        def __call__(self, batch, gen):
            import torch

            return torch.zeros(1, 4, 4, 3), {}

    monkeypatch.setattr(demo, "Predictor", Fake)
    bundle = types.SimpleNamespace(engine=object())
    settings = [(2, 4.0, False, False), (2, 4.0, False, False), (3, 4.0, False, False),
                (2, 5.0, False, False), (2, 4.0, True, False), (2, 4.0, False, True)]
    for steps, scale, aae, detailed in settings:
        demo.demo_predict(cfgs, bundle, {}, steps, scale, 0, aae, detailed, "cpu")
    assert len(built) == 5
    demo.demo_predict(dict(cfgs, noise_search_batched=False), bundle, {}, 2, 4.0, 0,
                      device="cpu")
    demo.demo_predict(cfgs, types.SimpleNamespace(engine=object()), {}, 2, 4.0, 0,
                      device="cpu")
    assert len(built) == 7 and built[5]["noise_search_batched"] is False
