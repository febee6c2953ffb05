"""Merge + filter parseq-layout LMDB datasets into one LMDB (port of
`scripts/str_filter_lmdb.py`; the same bytes on disk).

Parity: src/parseq/tools/filter_lmdb.py — same semantics (concatenate the
input databases in order, drop samples whose decoded image has a width or
height below --min_image_dim, renumber surviving samples 1-based, write
b'num-samples' at the end) through `data.lmdb`'s reader and writer instead
of the `lmdb` C library. Host only: no device.

Usage:
  python -m udifftext_tpu_torch.scripts.str_filter_lmdb <in_lmdb> [<in_lmdb> ...] --output <out_lmdb> \
      [--min_image_dim 8]
"""

from __future__ import annotations

import argparse

from ..data.lmdb import decode_image, open_lmdb, write_lmdb


def filter_lmdb(inputs, output: str, min_image_dim: int = 8) -> int:
    items = {}
    in_samples = 0
    out_samples = 0
    for lmdb_in in inputs:
        with open_lmdb(lmdb_in) as db:
            raw = db.get(b"num-samples")
            if raw is None:
                raise SystemExit(f"{lmdb_in}: no b'num-samples' key (not a parseq-layout LMDB)")
            num_samples = int(raw)
            in_samples += num_samples
            for index in range(1, num_samples + 1):
                image_bin = db.get(b"image-%09d" % index)
                if image_bin is None:
                    print(f"Skipping: {index} in {lmdb_in} (missing image record)")
                    continue
                h, w = decode_image(image_bin).shape[:2]
                if w < min_image_dim or h < min_image_dim:
                    print(f"Skipping: {index}, w = {w}, h = {h}")
                    continue
                out_samples += 1  # 1-based renumbering, matching the reference tool
                items[b"image-%09d" % out_samples] = image_bin
                items[b"label-%09d" % out_samples] = db.get(b"label-%09d" % index) or b""
    items[b"num-samples"] = str(out_samples).encode()
    write_lmdb(output, items)
    print(f"Written {out_samples} samples to {output} out of {in_samples} input samples.")
    return out_samples


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("inputs", nargs="+", help="paths to input LMDBs")
    ap.add_argument("--output", required=True, help="path to output LMDB")
    ap.add_argument("--min_image_dim", type=int, default=8)
    args = ap.parse_args(argv)
    filter_lmdb(args.inputs, args.output, args.min_image_dim)


if __name__ == "__main__":
    main()
