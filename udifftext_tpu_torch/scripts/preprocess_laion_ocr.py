"""LAION-OCR preprocessing: re-layout a mario-laion download into the
{train,val}/{idx}/(image.jpg, ocr.txt, charseg.npy) structure the
LAIONOCRDataset expects (port of `scripts/preprocess_laion_ocr.py`; the
same files). Host only: no device.

Parity: scripts/preprocess/laion_ocr_pre.ipynb in the reference (cells 2-7).
The download step there uses img2dataset over URLs; in a zero-egress
environment this script only performs the re-layout/validation of an already
downloaded tree.

Usage:
  python -m udifftext_tpu_torch.scripts.preprocess_laion_ocr --src <downloaded_root> \
      --dst <data_root>/LAION-OCR --val-frac 0.01
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path


def relayout(src: Path, dst: Path, val_frac: float = 0.01):
    entries = []
    for d in sorted(src.iterdir()):
        if not d.is_dir():
            continue
        img = d / "image.jpg"
        ocr = d / "ocr.txt"
        seg = d / "charseg.npy"
        if img.exists() and ocr.exists() and seg.exists():
            entries.append(d)
    n_val = max(1, int(len(entries) * val_frac)) if entries else 0
    splits = {"val": entries[:n_val], "train": entries[n_val:]}
    for split, items in splits.items():
        for i, d in enumerate(items):
            out = dst / split / f"{i:08d}"
            out.mkdir(parents=True, exist_ok=True)
            for name in ("image.jpg", "ocr.txt", "charseg.npy"):
                target = out / name
                if not target.exists():
                    shutil.copy2(d / name, target)
    print({k: len(v) for k, v in splits.items()})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--val-frac", type=float, default=0.01)
    args = ap.parse_args(argv)
    relayout(Path(args.src), Path(args.dst), args.val_frac)


if __name__ == "__main__":
    main()
