"""Scene-text editing demo on the port: a Gradio editor, or a command-line
one-shot:

    python -m udifftext_tpu_torch.demo [--device cuda|cpu]        # the Gradio UI
    python -m udifftext_tpu_torch.demo --image in.png --mask mask.png \
        --text HELLO --out out.png [--steps N --scale S --seed K] [--aae] [--detailed] \
        [--device cuda|cpu]

Reads ./configs/demo.yaml (and the model graph it names) like the JAX
build's demo.py. The UI serves when `gradio` imports and no one-shot
argument (--image, --mask, --text) is given; otherwise the command line
runs. The editor's background is the image and its first sketch layer's
alpha (paint coverage, not luminance) the mask. Image and mask are resized
to H×W and the predictor runs with the candidate-batched init-noise search
(and, with the config's `encprop_interval` > 1, encoder-propagation
sampling, gated on the quality report of `load_ckpt_path`'s checkpoint);
one predictor is kept for each sampler setting. --aae turns on
attend-and-excite, prints the per-step local losses and writes the
intermediate steps to ./temp/inters/demo.gif; --detailed saves the middle
step's t_attn maps as .npy files under ./temp/attn_map/. The model comes from
`loading.init_model`: the graph's component checkpoints and the config's
`load_ckpt_path` are loaded where the files exist; with no checkpoint file
the weights are seeded random (--seed), as the JAX demo falls back to a
fresh init. Needs PyYAML and Pillow. Runs on the GPU (`--device cuda`, the default) and
stops with a message when there is none; `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .charset import encode_labels
from .config import load_config
from .loading import init_model, init_sampling
from .predict import Predictor
from .utils.encprop_gate import ckpt_id_if_encprop
from .utils.viz import save_intermediates_gif


def _resize(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize (H, W, C) without antialiasing, cv2.INTER_LINEAR's rule."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).permute(2, 0, 1)[None]
    return F.interpolate(t, size=(h, w), mode="bilinear", align_corners=False)[0].permute(1, 2, 0).numpy()


def build_batch(image: np.ndarray, mask: np.ndarray, text: str, H: int = 512, W: int = 512,
                seq_len: int = 12) -> Dict[str, np.ndarray]:
    """image (h, w, 3) uint8, mask (h, w) → the float batch of one sample:
    image in [-1, 1], binary mask, masked = image·(1 − mask), seg_mask by
    len(text)."""
    image = _resize(image, H, W) / 127.5 - 1.0
    mask = (_resize(mask[..., None], H, W) > 0.5).astype(np.float32)
    seg_mask = np.zeros(seq_len, np.float32)
    seg_mask[: len(text)] = 1.0
    return {
        "image": image[None], "mask": mask[None], "masked": (image * (1 - mask))[None],
        "seg_mask": seg_mask[None], "label_ids": encode_labels([text], seq_len),
    }


_PREDICTORS: Dict[Tuple, Predictor] = {}


def demo_predict(cfgs, bundle, batch: Dict[str, Any], steps: int, scale: float, seed: int,
                 aae: bool = False, detailed: bool = False,
                 device: torch.device | str = "cuda") -> Tuple[np.ndarray, Dict[str, Any]]:
    """One sample of `batch` → ((H, W, 3) uint8, aux), through the predictor
    cached for this engine and sampler setting (steps, scale, aae,
    detailed, encprop interval, batched search)."""
    encprop = int(cfgs.get("encprop_interval", 0))
    batched = bool(cfgs.get("noise_search_batched", True))
    key = (id(bundle.engine), int(steps), float(scale), bool(aae), bool(detailed), encprop,
           batched)
    predictor = _PREDICTORS.get(key)
    if predictor is None:
        predictor = _PREDICTORS[key] = Predictor(
            bundle.engine, num_steps=int(steps), cfg_scale=float(scale),
            noise_iters=int(cfgs.get("noise_iters", 10)), aae_enabled=aae, detailed=detailed,
            encprop_interval=encprop, ckpt_id=ckpt_id_if_encprop(cfgs),
            noise_search_batched=batched)
    images, aux = predictor(batch, torch.Generator(device).manual_seed(int(seed)))
    return (images[0].float().cpu().numpy() * 255).astype(np.uint8), aux


def editor_mask(editor: Dict[str, Any], image: np.ndarray) -> np.ndarray:
    """The mask of a Gradio ImageEditor value: its first sketch layer's
    alpha (a dark brush paints (0, 0, 0, 255), which luminance would read
    as unpainted); all zero when there is no layer."""
    layers = editor.get("layers") or []
    if not layers:
        return np.zeros(image.shape[:2], np.float32)
    return np.asarray(layers[0].convert("RGBA"))[..., 3]


def run_gradio(cfgs, device: torch.device | str = "cuda", seed: int = 0):
    """The Gradio editor: an image with a sketched mask, the text, steps,
    CFG scale, seed and `detailed` → the edited image. Launches the
    Interface and returns it."""
    import gradio as gr
    from PIL import Image

    bundle = init_model(cfgs, device, seed=seed)
    sampling = init_sampling(cfgs)

    def fn(editor, text, steps, scale, seed, detailed):
        image = np.asarray(editor["background"].convert("RGB"))
        batch = build_batch(image, editor_mask(editor, image), text, cfgs.get("H", 512),
                            cfgs.get("W", 512), cfgs.get("seq_len", 12))
        out, _ = demo_predict(cfgs, bundle, batch, int(steps), float(scale), int(seed),
                              detailed=bool(detailed), device=device)
        return Image.fromarray(out)

    ui = gr.Interface(
        fn,
        [
            gr.ImageEditor(type="pil", label="image + sketch mask"),
            gr.Textbox(label="text"),
            gr.Slider(10, 100, value=sampling.num_steps, step=1, label="steps"),
            gr.Slider(0, 10, value=sampling.cfg_scale, label="cfg scale"),
            gr.Number(value=0, label="seed"),
            gr.Checkbox(label="detailed"),
        ],
        gr.Image(label="result"),
        title="UDiffText demo",
    )
    ui.launch()
    return ui


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("demo: no CUDA device found; run on a machine with a GPU, or pass "
                         "--device cpu to run (slowly) on the CPU")
    return device


def run_cli(argv=None) -> None:
    from PIL import Image

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image", required=True)
    p.add_argument("--mask", required=True)
    p.add_argument("--text", required=True)
    p.add_argument("--out", default="demo_out.png")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--scale", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--aae", action="store_true")
    p.add_argument("--detailed", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = _device(args.device)

    cfgs = load_config("./configs/demo.yaml")
    bundle = init_model(cfgs, device, seed=args.seed)
    sampling = init_sampling(cfgs)
    steps = args.steps if args.steps is not None else sampling.num_steps
    scale = args.scale if args.scale is not None else sampling.cfg_scale
    image = np.asarray(Image.open(args.image).convert("RGB"))
    mask = np.asarray(Image.open(args.mask).convert("L"))
    batch = build_batch(image, mask, args.text, cfgs.get("H", 512), cfgs.get("W", 512),
                        cfgs.get("seq_len", 12))
    out, aux = demo_predict(cfgs, bundle, batch, steps, scale, args.seed, args.aae,
                            args.detailed, device)
    Image.fromarray(out).save(args.out)
    print(f"saved {args.out}")
    aux.pop("noise_scores", None)
    if "local_losses" in aux:
        losses = aux.pop("local_losses").float().mean(dim=-1).cpu().numpy()
        print(f"Local losses: {[round(float(v), 4) for v in losses]}")
        save_intermediates_gif(list(aux.pop("inters").float().cpu().numpy()),
                               "./temp/inters/demo.gif")
    if args.detailed:
        os.makedirs("./temp/attn_map", exist_ok=True)
        for k, v in aux.items():
            np.save(f"./temp/attn_map/{k.replace('.', '_')}.npy", v.float().cpu().numpy())
        print("saved attention maps under ./temp/attn_map/")


_ONE_SHOT = ("--image", "--mask", "--text")


def main(argv=None) -> None:
    """The Gradio UI when gradio imports and no one-shot argument is given,
    else the command line."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not any(a.split("=", 1)[0] in _ONE_SHOT for a in argv):
        try:
            import gradio  # noqa: F401
        except ImportError:
            pass
        else:
            p = argparse.ArgumentParser(description="the Gradio editor")
            p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
            p.add_argument("--seed", type=int, default=0)
            args = p.parse_args(argv)
            run_gradio(load_config("./configs/demo.yaml"), _device(args.device), args.seed)
            return
    run_cli(argv)


if __name__ == "__main__":
    main()
