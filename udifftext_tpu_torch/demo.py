"""Scene-text editing demo on the port, as a command-line one-shot:

    python -m udifftext_tpu_torch.demo --image in.png --mask mask.png \
        --text HELLO --out out.png [--steps N --scale S --seed K] [--aae] [--detailed] \
        [--device cuda|cpu]

Reads ./configs/demo.yaml (and the model graph it names) like the JAX
build's demo.py, resizes image and mask to H×W, and runs the predictor with
the candidate-batched init-noise search (and, with the config's
`encprop_interval` > 1, encoder-propagation sampling, gated on the quality
report of `load_ckpt_path`'s checkpoint). --aae turns on attend-and-excite
and prints the per-step local losses; --detailed saves the middle step's
t_attn maps as .npy files under ./temp/attn_map/. The model comes from
`loading.init_model`: the graph's component checkpoints and the config's
`load_ckpt_path` are loaded where the files exist; with no checkpoint file
the weights are seeded random (--seed), as the JAX demo falls back to a
fresh init. Needs PyYAML and Pillow. Runs on the GPU (`--device cuda`, the default) and
stops with a message when there is none; `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .charset import encode_labels
from .config import load_config
from .loading import init_model, init_sampling
from .predict import Predictor
from .utils.encprop_gate import ckpt_id_if_encprop


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


def main(argv=None) -> None:
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
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("demo: no CUDA device found; run on a machine with a GPU, or pass "
                         "--device cpu to run (slowly) on the CPU")

    cfgs = load_config("./configs/demo.yaml")
    bundle = init_model(cfgs, device, seed=args.seed)
    sampling = init_sampling(cfgs)
    steps = args.steps if args.steps is not None else sampling.num_steps
    scale = args.scale if args.scale is not None else sampling.cfg_scale
    predictor = Predictor(bundle.engine, num_steps=steps, cfg_scale=scale,
                          noise_iters=int(cfgs.get("noise_iters", 10)),
                          aae_enabled=args.aae, detailed=args.detailed,
                          encprop_interval=int(cfgs.get("encprop_interval", 0)),
                          ckpt_id=ckpt_id_if_encprop(cfgs),
                          noise_search_batched=bool(cfgs.get("noise_search_batched", True)))
    image = np.asarray(Image.open(args.image).convert("RGB"))
    mask = np.asarray(Image.open(args.mask).convert("L"))
    batch = build_batch(image, mask, args.text, cfgs.get("H", 512), cfgs.get("W", 512),
                        cfgs.get("seq_len", 12))
    gen = torch.Generator(device).manual_seed(args.seed)
    images, aux = predictor(batch, gen)
    Image.fromarray((images[0].float().cpu().numpy() * 255).astype(np.uint8)).save(args.out)
    print(f"saved {args.out}")
    aux.pop("noise_scores", None)
    aux.pop("inters", None)
    if "local_losses" in aux:
        losses = aux.pop("local_losses").float().mean(dim=-1).cpu().numpy()
        print(f"Local losses: {[round(float(v), 4) for v in losses]}")
    if args.detailed:
        os.makedirs("./temp/attn_map", exist_ok=True)
        for k, v in aux.items():
            np.save(f"./temp/attn_map/{k.replace('.', '_')}.npy", v.float().cpu().numpy())
        print("saved attention maps under ./temp/attn_map/")


if __name__ == "__main__":
    main()
