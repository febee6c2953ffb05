"""Quality check of the APPROXIMATE encoder-propagation sampling mode on the
port (port of `scripts/encprop_quality.py`).

Runs the same fixed-seed sample through the exact Euler-EDM loop and
through encoder propagation at each --intervals value, prints the PSNR and
max |Δ| between the decoded images, and writes the report the quality gate
reads (`utils/encprop_gate.py`; a report written here gates the JAX package
too, and the reverse). Run it before trusting `encprop_interval` with a
checkpoint: the mode's quality cost depends on the weights.

Without --ckpt the weights are seeded random (`randomize_parameters`): the
run checks the mechanism only, says so, and writes no report unless
--report-id forces a key (for testing the gate). With the published
UDiffText checkpoint it measures the real degradation.

  python -m udifftext_tpu_torch.scripts.encprop_quality [--ckpt CKPT]
      [--model_cfg configs/test/textdesign_sd_2.yaml] [--image in.png --mask
      mask.png] [--text WORD] [--steps 50] [--intervals 2,3] [--size 512]
      [--scale 5.0] [--report-id ID] [--device cuda|cpu]

The default graph is `builders.TEXTDESIGN_SD_2` and the default batch a
synthetic image (seeded uniform noise, a centered square mask), so the
script needs neither PyYAML nor Pillow; --model_cfg needs PyYAML and
--image/--mask need Pillow. `run(...)` is the entry function.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..builders import TEXTDESIGN_SD_2, build_engine, randomize_parameters
from ..charset import encode_labels
from ..utils.encprop_gate import ckpt_file_id, write_report


def build_batch(size: int, text: str, image: Optional[str] = None,
                mask: Optional[str] = None) -> Dict[str, np.ndarray]:
    """One sample: the image and mask files resized to size², or seeded
    uniform noise with a centered square mask."""
    if image and mask:
        from PIL import Image

        img = np.asarray(Image.open(image).convert("RGB").resize((size, size)),
                         np.float32) / 127.5 - 1.0
        m = (np.asarray(Image.open(mask).convert("L").resize((size, size)), np.float32)
             [..., None] > 127).astype(np.float32)
    else:
        img = np.random.RandomState(0).uniform(-1, 1, (size, size, 3)).astype(np.float32)
        m = np.zeros((size, size, 1), np.float32)
        m[size // 4: 3 * size // 4, size // 4: 3 * size // 4] = 1.0
    seg_mask = np.zeros((12,), np.float32)
    seg_mask[: len(text)] = 1.0
    return {"image": img[None], "masked": (img * (1.0 - m))[None], "mask": m[None],
            "seg_mask": seg_mask[None], "label_ids": encode_labels([text], 12)}


def run(model_cfg: Optional[Mapping[str, Any]] = None, ckpt: Optional[str] = None,
        image: Optional[str] = None, mask: Optional[str] = None, text: str = "hello",
        steps: int = 50, intervals: Sequence[int] = (2, 3), size: int = 512,
        scale: float = 5.0, report_id: Optional[str] = None,
        device: str = "cuda") -> Dict[str, Any]:
    """Exact against encprop at each interval on one seeded sample →
    {"mode", "intervals": {str(k): {"psnr", "max_abs"}}, "report_path" (None
    when no report was written)}; {"skipped": path} when `ckpt` names no
    file."""
    from ..loading import init_model

    seed = 0
    dev = torch.device(device)
    model_cfg = dict(TEXTDESIGN_SD_2 if model_cfg is None else model_cfg)
    if ckpt and not os.path.exists(ckpt):
        print(f"SKIPPED: checkpoint not found at {ckpt}")
        return {"skipped": ckpt}
    if ckpt:
        engine = init_model({"load_ckpt_path": ckpt}, dev, seed, model_cfg=model_cfg).engine
        mode = f"checkpoint {ckpt}"
    else:
        engine = randomize_parameters(build_engine(model_cfg, torch.bfloat16, dev).engine, seed)
        mode = "RANDOM-INIT (mechanism smoke only — not a quality statement)"

    batch = {k: torch.as_tensor(v, device=dev) for k, v in build_batch(size, text, image,
                                                                         mask).items()}
    lat = size // engine.latent_factor
    gen = torch.Generator(dev).manual_seed(seed)
    eps = torch.randn((1, lat, lat, 4), generator=gen, device=dev)
    noise = torch.randn((1, 1, lat, lat, 4), generator=gen, device=dev)

    def sample(interval: int) -> torch.Tensor:
        # the same posterior and initial noise every time; this run is the
        # measurement, so it goes to the engine, which does not consult the gate
        img, _ = engine.sample(batch, num_steps=steps, cfg_scale=scale, noise_iters=0,
                               posterior_eps=eps, noise=noise, encprop_interval=interval)
        return img.float().cpu()

    print(f"encprop quality vs exact — {mode}; steps={steps}")
    exact = sample(0)
    results = {}
    for k in intervals:
        diff = exact - sample(int(k))
        mse = float((diff**2).mean())
        psnr = float(10 * np.log10(1.0 / max(mse, 1e-12)))
        max_abs = float(diff.abs().max())
        print(f"interval {k}: PSNR {psnr:6.2f} dB  max|Δ| {max_abs:.4f}"
              f"  mean|Δ| {float(diff.abs().mean()):.5f}")
        results[str(k)] = {"psnr": round(psnr, 3), "max_abs": round(max_abs, 5)}

    # random-init results say nothing about real quality: no report unless
    # report_id forces a key (gate tests)
    if report_id is None and ckpt:
        report_id = ckpt_file_id(ckpt)
    path = None
    if report_id:
        path = write_report(report_id, {"mode": mode, "steps": steps, "scale": scale,
                                        "size": size, "text": text, "intervals": results})
        print(f"report written: {path}")
    else:
        print("report NOT written (random-init run — pass --ckpt for a real report, or "
              "--report-id to force a key for gate tests)")
    return {"mode": mode, "intervals": results, "report_path": path}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--model_cfg", default=None,
                    help="a model YAML (default: builders.TEXTDESIGN_SD_2)")
    ap.add_argument("--image", default=None)
    ap.add_argument("--mask", default=None)
    ap.add_argument("--text", default="hello")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--intervals", default="2,3")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--scale", type=float, default=5.0)
    ap.add_argument("--report-id", default=None,
                    help="override the quality-report key (testing the gate only; normally "
                    "the key is the checkpoint's content hash)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("encprop_quality: no CUDA device found; pass --device cpu to run "
                         "(slowly) on the CPU")
    model_cfg = None
    if args.model_cfg:
        from ..config import load_config

        model_cfg = load_config(args.model_cfg)["model"]["params"]
    run(model_cfg, args.ckpt, args.image, args.mask, args.text, args.steps,
        [int(v) for v in args.intervals.split(",") if v], args.size, args.scale,
        args.report_id, args.device)


if __name__ == "__main__":
    main()
