"""Single-image STR inference (port of `scripts/str_read.py`;
src/parseq/read.py parity): each image decoded on the host, resized to
32×128 on the device (cv2's INTER_CUBIC, clipped to [0, 1]) and read
greedily as one batch.

Usage: python -m udifftext_tpu_torch.scripts.str_read <image.png> ...
       [--model parseq] [--ckpt path] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np

from ..ocr import ParseqPredictor
from ._timing import probe_device
from .str_test import read_image_file, load_model


def main(argv=None) -> List[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("images", nargs="+")
    ap.add_argument("--model", default="parseq")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = probe_device("str_read", args.device)

    predictor = ParseqPredictor(load_model(args.model, args.ckpt, device))
    crops = [read_image_file(p).astype(np.float32) / 255.0 for p in args.images]
    texts = predictor.img2txt_ragged(crops)
    for path, text in zip(args.images, texts):
        print(f"{path}: {text!r}")
    return texts


if __name__ == "__main__":
    main()
