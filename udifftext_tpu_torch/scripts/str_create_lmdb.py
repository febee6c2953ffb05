"""Convert a folder STR dataset to the parseq LMDB layout (port of
`scripts/str_create_lmdb.py`; the same bytes on disk).

Parity: src/parseq/tools/create_lmdb_dataset.py — same on-disk result
(b'num-samples', b'image-%09d' raw encoded bytes, b'label-%09d' utf-8,
1-based indices) written through `data.lmdb.write_lmdb` instead of the
`lmdb` C library. Host only: no device.

Input forms:
  - `--gt_file <path>`: lines of `<imagePath> <label>` (paths relative to
    --input), the reference tool's format; or
  - a folder containing `labels.txt` in the same format (the str_test.py
    folder layout) when only --input is given.

Usage:
  python -m udifftext_tpu_torch.scripts.str_create_lmdb --input <dir> [--gt_file gt.txt] --output <lmdb_dir>
"""

from __future__ import annotations

import argparse
import os
from os.path import join as ospj

from ..data.lmdb import decode_image, write_lmdb


def valid_image(data: bytes) -> bool:
    """Whether `data` decodes (`decode_image`) to a non-empty image. Without
    Pillow, bytes that are not a PNG of `encode_png`'s kind raise instead."""
    try:
        img = decode_image(data)
    except (OSError, ValueError):
        return False
    return img.size > 0


def create_lmdb(input_dir: str, gt_file: str, output: str, check_valid: bool = True) -> int:
    with open(gt_file, encoding="utf-8") as f:
        lines = [l.rstrip("\n") for l in f if l.strip()]

    items = {}
    cnt = 1
    for i, line in enumerate(lines):
        parts = line.split(maxsplit=1)
        if len(parts) != 2:
            continue
        rel, label = parts
        path = ospj(input_dir, rel)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            print(f"{i}-th image read error: {path}: {e}")
            continue
        if check_valid and not valid_image(data):
            print(f"{path} is not a valid image")
            continue
        items[b"image-%09d" % cnt] = data
        items[b"label-%09d" % cnt] = label.encode("utf-8")
        cnt += 1
    n = cnt - 1
    items[b"num-samples"] = str(n).encode()
    write_lmdb(output, items)
    print(f"Created LMDB dataset with {n} samples at {output}")
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True, help="image root folder")
    ap.add_argument("--gt_file", default=None,
                    help="'<imagePath> <label>' lines; default <input>/labels.txt")
    ap.add_argument("--output", required=True, help="output LMDB directory")
    ap.add_argument("--no_check", action="store_true")
    args = ap.parse_args(argv)
    gt = args.gt_file or ospj(args.input, "labels.txt")
    if not os.path.exists(gt):
        raise SystemExit(f"ground-truth file not found: {gt}")
    create_lmdb(args.input, gt, args.output, check_valid=not args.no_check)


if __name__ == "__main__":
    main()
