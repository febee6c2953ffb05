"""STR benchmark-table evaluation (port of `scripts/str_test.py`;
src/parseq/test.py parity).

Evaluates word accuracy / 1-NED / confidence / label length per dataset and
prints the grouped markdown summary tables (Benchmark (Subset) / Benchmark /
New, test.py:92-130) with a weighted Combined row per group. Flags mirror the
reference: --cased / --punctuation extend the test charset (:80-84), --new
adds the ArT/COCOv1.4/Uber sets (:93-94), --rotation rotates inputs
counter-clockwise before resize (strhub/data/module.py:60-61). With --ckpt
(a strhub-layout torch file, as `str_train` writes) the tables are also
written to `<ckpt>.log.txt` (:126).

Each benchmark directory may be either an LMDB database (the parseq
distribution format, read through `data.lmdb.open_lmdb`) or an image folder
with a `labels.txt` (`<filename> <label>` per line). Crops are resized to
32×128 on the device by `ocr.bicubic_resize` (cv2's INTER_CUBIC).

Usage: python -m udifftext_tpu_torch.scripts.str_test --data_root <root>
       [--model parseq --ckpt p] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import string
import sys
from os.path import join as ospj
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.lmdb import LmdbStrDataset, decode_image, prep_label
from ..ocr import ParseqPredictor, bicubic_resize
from ..str_eval import CharsetAdapter, STRResult, evaluate_predictions
from ._timing import probe_device

# strhub/data/module.py:27-30
TEST_BENCHMARK_SUB = ("IIIT5k", "SVT", "IC13_857", "IC15_1811", "SVTP", "CUTE80")
TEST_BENCHMARK = ("IIIT5k", "SVT", "IC13_1015", "IC15_2077", "SVTP", "CUTE80")
TEST_NEW = ("ArT", "COCOv1.4", "Uber")
ROTATIONS = (0, 90, 180, 270)

Item = Tuple[Callable[[], np.ndarray], str]


def read_image_file(path: str) -> np.ndarray:
    """The image file at `path` as uint8 (H, W, 3) RGB (`decode_image`)."""
    with open(path, "rb") as f:
        return decode_image(f.read())


def load_folder(d: str, charset: Optional[str] = None) -> List[Item]:
    """Items as (open_fn → uint8 (H, W, 3) RGB, label) from an LMDB database
    dir (the parseq distribution format) or a labels.txt image folder, with
    the reference datamodule's label filtering so evaluated populations (and
    the tables' #samples) match parseq's."""
    if os.path.exists(ospj(d, "data.mdb")):
        ds = LmdbStrDataset(d, charset=charset)
        return [(lambda i=i: ds[i][0], ds.labels[i]) for i in range(len(ds))]
    labels_path = ospj(d, "labels.txt")
    items: List[Item] = []
    if not os.path.exists(labels_path):
        return items
    adapter = CharsetAdapter(charset) if charset is not None else None
    with open(labels_path) as f:
        for line in f:
            parts = line.rstrip("\n").split(" ", 1)
            if len(parts) == 2:
                label = prep_label(parts[1], adapter)
                if label is None:
                    continue
                p = ospj(d, parts[0])
                items.append((lambda p=p: read_image_file(p), label))
    return items


def load_crop(image: np.ndarray, out_hw: Tuple[int, int], device: torch.device,
              rotation: int = 0) -> torch.Tensor:
    """A uint8 (H, W, 3) image, rotated counter-clockwise by `rotation`
    degrees (a multiple of 90: Pillow's rotate(r, expand=True), exact), as
    fp32 [0, 1] resized to `out_hw` on `device` (cv2's INTER_CUBIC, not
    clipped)."""
    if rotation % 90:
        raise ValueError(f"rotation {rotation}: only multiples of 90 degrees")
    if rotation:
        image = np.rot90(image, rotation // 90)
    x = torch.from_numpy(np.require(image, np.uint8, ["C", "W"])).to(device).float() / 255.0
    return bicubic_resize(x, out_hw)


def print_results_table(rows: Sequence[Tuple[str, STRResult]], file=None) -> None:
    """test.py:40-61 table: per-set rows + sample-weighted Combined row."""
    names = [name for name, _ in rows]
    w = max(map(len, names + ["Dataset", "Combined"]))
    print("| {:<{w}} | # samples | Accuracy | 1 - NED | Confidence | Label Length |".format(
        "Dataset", w=w), file=file)
    print("|:{:-<{w}}:|----------:|---------:|--------:|-----------:|-------------:|".format(
        "----", w=w), file=file)
    tot_n = tot_acc = tot_ned = tot_conf = tot_len = 0
    for name, r in rows:
        n = r.num_samples
        mean_len = r.label_length / max(n, 1)
        print(f"| {name:<{w}} | {n:>9} | {r.accuracy:>8.2f} | {r.mean_1_minus_ned:>7.2f} "
              f"| {r.mean_confidence:>10.2f} | {mean_len:>12.2f} |", file=file)
        tot_n += n
        tot_acc += n * r.accuracy
        tot_ned += n * r.mean_1_minus_ned
        tot_conf += n * r.mean_confidence
        tot_len += n * mean_len
    d = max(tot_n, 1)
    print("|-{:-<{w}}-|-----------|----------|---------|------------|--------------|".format(
        "----", w=w), file=file)
    print(f"| {'Combined':<{w}} | {tot_n:>9} | {tot_acc / d:>8.2f} | {tot_ned / d:>7.2f} "
          f"| {tot_conf / d:>10.2f} | {tot_len / d:>12.2f} |", file=file)


@torch.no_grad()
def evaluate_set(predictor: ParseqPredictor, items: Sequence[Item], batch: int, rotation: int,
                 charset_test: str) -> STRResult:
    """Read `items` in batches of `batch` on the predictor's device: the
    reader's greedy strings and sequence confidences, scored against the
    labels."""
    preds, gts, confs = [], [], []
    for i in range(0, len(items), batch):
        chunk = items[i:i + batch]
        crops = torch.stack([load_crop(open_fn(), predictor.img_hw, predictor.device, rotation)
                             for open_fn, _ in chunk])
        texts, conf = predictor.decode(predictor.read_logits(crops).float().cpu().numpy())
        preds += texts
        confs += conf
        gts += [g for _, g in chunk]
    return evaluate_predictions(preds, gts, confs, charset_test=charset_test)


def load_model(name: str, ckpt: Optional[str], device: torch.device) -> torch.nn.Module:
    """The hub model `name` with `ckpt` loaded strictly, or PyTorch's initial
    weights from seed 0 (with a warning) when there is none."""
    from ..models.str_hub import create_model

    if not ckpt:
        print("warning: random weights")
        torch.manual_seed(0)
    return create_model(name, ckpt, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--model", default="parseq")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--cased", action="store_true", help="Cased comparison")
    ap.add_argument("--punctuation", action="store_true", help="Check punctuation")
    ap.add_argument("--new", action="store_true", help="Evaluate on new benchmark datasets")
    ap.add_argument("--rotation", type=int, default=0, choices=ROTATIONS,
                    help="Angle of rotation (counter clockwise) in degrees")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = probe_device("str_test", args.device)

    charset_test = string.digits + string.ascii_lowercase
    if args.cased:
        charset_test += string.ascii_uppercase
    if args.punctuation:
        charset_test += string.punctuation

    predictor = ParseqPredictor(load_model(args.model, args.ckpt, device))

    test_set = TEST_BENCHMARK_SUB + TEST_BENCHMARK
    if args.new:
        test_set += TEST_NEW
    test_set = sorted(set(test_set))

    results = {}
    for name in test_set:
        items = load_folder(ospj(args.data_root, name), charset=charset_test)
        if not items:
            print(f"skipping {name} (no data)")
            continue
        results[name] = evaluate_set(predictor, items, args.batch, args.rotation, charset_test)

    result_groups = {
        "Benchmark (Subset)": TEST_BENCHMARK_SUB,
        "Benchmark": TEST_BENCHMARK,
    }
    if args.new:
        result_groups["New"] = TEST_NEW
    outs = [sys.stdout]
    log = open(args.ckpt + ".log.txt", "w") if args.ckpt else None
    try:
        if log:
            outs.append(log)
        for out in outs:
            for group, subset in result_groups.items():
                rows = [(s, results[s]) for s in subset if s in results]
                if not rows:
                    continue
                print(f"{group} set:", file=out)
                print_results_table(rows, file=out)
                print("\n", file=out)
    finally:
        if log:
            log.close()
    return results


if __name__ == "__main__":
    main()
