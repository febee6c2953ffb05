"""Raw STR dataset → gt.txt converters (port of
`scripts/str_convert_datasets.py`, the same files; src/parseq/tools parity).

One subcommand per upstream converter script; each parses the dataset's native
annotation format, applies the same label filters, optionally crops word boxes
out of the scene images, and writes a `<imagePath>\t<label>` ground-truth file
consumable by `str_create_lmdb` (and, for the crop-based ones, by
`str_test`'s folder loader). Host only: no device; Pillow is imported inside
the converters that crop.

Usage: python -m udifftext_tpu_torch.scripts.str_convert_datasets <name> <root>

Parity map (all under the reference's src/parseq/tools/):
  art            art_converter.py              (ArT train_task2 JSON)
  case-sensitive case_sensitive_str_datasets_converter.py (IMG/ + label/ dirs)
  coco-text      coco_text_converter.py        ({train,val}_words_gt.txt)
  mlt19          mlt19_converter.py            (gt.txt img,script,label)
  lsvt           lsvt_converter.py             (train_full_labels.json + crops)
  textocr        textocr_converter.py          (TextOCR_0.1_*.json + crops)
  coco2          coco_2_converter.py           (cocotext.v2.json + crops)
  openvino       openvino_converter.py         (OpenImages v5 JSONs + crops)

The upstream crop-based tools parallelize through mmcv/mmocr; here the crops
run sequentially with plain json/PIL/numpy — the on-disk result is identical.
"""

from __future__ import annotations

import argparse
import html
import json
import math
import os
import re
from os.path import join as ospj

_CJK = re.compile(r"[一-鿿]+")


def _write_gt(path: str, rows, sep: str = "\t", strip_label: bool = True) -> int:
    """strip_label=False for the crop-based converters: upstream writes their
    transcriptions raw through mmocr's list_to_file (label-file-only
    converters strip explicitly)."""
    with open(path, "w", encoding="utf-8") as f:
        for fname, label in rows:
            f.write(sep.join([fname.strip(), label.strip() if strip_label else label]) + "\n")
    print(f"{path}: {len(rows)} samples")
    return len(rows)


def _save_jpeg(img, src_img, dst_path: str) -> None:
    """Save preserving the source's JPEG quantization tables when it has them
    (tools/*_converter.py pass qtables=src.quantization unconditionally;
    non-JPEG sources need the fallback)."""
    qt = getattr(src_img, "quantization", None)
    if qt:
        img.save(dst_path, qtables=qt)
    else:
        img.save(dst_path, quality=95)


def _save_crop(src_img, box, dst_path: str) -> None:
    _save_jpeg(src_img.crop(box), src_img, dst_path)


# --------------------------------------------------------------------------
# Label-file-only converters
# --------------------------------------------------------------------------

def convert_art(root: str) -> int:
    """art_converter.py: ArT train_task2_labels.json → gt.txt."""
    with open(ospj(root, "train_task2_labels.json"), encoding="utf8") as f:
        d = json.load(f)
    rows = []
    for k, v in d.items():
        if len(v) != 1:
            print("error", v)
        v = v[0]
        if v["language"].lower() != "latin" or v["illegibility"]:
            continue
        label = v["transcription"].strip()
        if not label:
            continue
        # upstream keeps the one known-good label containing '#'
        if "#" in label and label != "LocaL#3":
            continue
        rows.append((f"train_task2_images/{k}.jpg", label))
    return _write_gt(ospj(root, "gt.txt"), rows)


def convert_case_sensitive(root: str) -> int:
    """case_sensitive_str_datasets_converter.py: IMG/{i}.{jpg,png} +
    label/{i}.txt (1-based) → lmdb.txt."""
    num = len([n for n in os.listdir(ospj(root, "label")) if n.endswith(".txt")])
    ext = "jpg" if os.path.isfile(ospj(root, "IMG", "1.jpg")) else "png"
    rows = []
    for i in range(1, num + 1):
        with open(ospj(root, "label", f"{i}.txt"), encoding="utf-8") as f:
            label = f.readline()
        rows.append((ospj("IMG", f"{i}.{ext}"), label))
    return _write_gt(ospj(root, "lmdb.txt"), rows)


def convert_coco_text(root: str) -> int:
    """coco_text_converter.py: {train,val}_words_gt.txt (fname,label csv) →
    {train,val}_lmdb.txt; labels stripped of '|' padding."""
    n = 0
    for s in ("train", "val"):
        with open(ospj(root, f"{s}_words_gt.txt"), encoding="utf8") as f:
            lines = f.readlines()
        rows = []
        for line in lines:
            try:
                fname, label = line.split(",", maxsplit=1)
            except ValueError:
                continue
            rows.append((f"{s}_words/{fname.strip()}.jpg", label.strip().strip("|")))
        n += _write_gt(ospj(root, f"{s}_lmdb.txt"), rows)
    return n


def convert_mlt19(root: str) -> int:
    """mlt19_converter.py: gt.txt `img,script,label` → lmdb.txt keeping
    Latin/Symbols scripts only."""
    with open(ospj(root, "gt.txt"), encoding="utf-8") as f:
        lines = f.readlines()
    rows = []
    for line in lines:
        img, script, label = line.split(",", maxsplit=2)
        label = label.strip()
        if label and script in ("Latin", "Symbols"):
            rows.append((img, label))
    return _write_gt(ospj(root, "lmdb.txt"), rows)


# --------------------------------------------------------------------------
# Crop-based converters (scene image + word boxes → cropped word images)
# --------------------------------------------------------------------------

def convert_lsvt(root: str) -> int:
    """lsvt_converter.py: crop axis-aligned hulls of the polygon annotations
    in train_full_labels.json into image_train/, emit train_label.txt."""
    import numpy as np
    from PIL import Image

    with open(ospj(root, "train_full_labels.json"), encoding="utf-8") as f:
        annotation = json.load(f)
    dst_root = ospj(root, "image_train")
    os.makedirs(dst_root, exist_ok=True)
    blacklist = {"LOFTINESS*"}
    whitelist = {"#Find YOUR Fun#", "Story #", "*0#"}
    rows = []
    for img_idx, (img_info, anns) in enumerate(annotation.items()):
        try:
            src = Image.open(ospj(root, f"train_full_images_0/{img_info}.jpg"))
        except OSError:
            src = Image.open(ospj(root, f"train_full_images_1/{img_info}.jpg"))
        for ann_idx, ann in enumerate(anns):
            label = ann["transcription"]
            if (ann["illegibility"] or _CJK.findall(label) or label in blacklist
                    or ("#" in label and label not in whitelist)):
                continue
            pts = np.asarray(ann["points"])
            x1, y1 = pts.min(axis=0)
            x2, y2 = pts.max(axis=0)
            name = f"img_{img_idx}_{ann_idx}.jpg"
            _save_crop(src, (x1, y1, x2, y2), ospj(dst_root, name))
            rows.append((f"image_train/{name}", label))
        src.close()
    _write_gt(ospj(root, "train_label.txt"), rows, sep=" ", strip_label=False)
    return len(annotation)


def _rectify_pose(image, top_left, points):
    """textocr_converter.py:29-49 — orient rotated word crops horizontal via
    the corner-point heuristic."""
    import numpy as np

    points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    dist = ((points - np.asarray(top_left)) ** 2).sum(axis=1)
    left_midpoint = (points[0] + points[-1]) / 2
    right_corner_points = ((points - left_midpoint) ** 2).sum(axis=1).argsort()[-2:]
    right_midpoint = points[right_corner_points].sum(axis=0) / 2
    d_x, d_y = abs(right_midpoint - left_midpoint)
    if dist[0] + dist[-1] <= dist[right_corner_points].sum():
        rot = 0 if d_x >= d_y else 90
    else:
        rot = 180 if d_x >= d_y else -90
    return image.rotate(rot, expand=True) if rot else image


def convert_textocr(root: str, rectify_pose: bool = False) -> int:
    """textocr_converter.py: TextOCR_0.1_{train,val}.json → crops in image/
    + {train,val}_label.txt (val image indices continue after train's)."""
    from PIL import Image

    dst_root = ospj(root, "image")
    os.makedirs(dst_root, exist_ok=True)
    start = 0
    for split in ("train", "val"):
        with open(ospj(root, f"TextOCR_0.1_{split}.json"), encoding="utf-8") as f:
            annotation = json.load(f)
        rows = []
        for img_idx, img_info in enumerate(annotation["imgs"].values()):
            src = Image.open(ospj(root, img_info["file_name"]))
            anns = [annotation["anns"][a] for a in annotation["imgToAnns"][img_info["id"]]]
            for ann_idx, ann in enumerate(anns):
                label = ann["utf8_string"]
                if label == ".":  # TextOCR's illegible marker
                    continue
                x, y, w, h = ann["bbox"]
                x, y = max(0, math.floor(x)), max(0, math.floor(y))
                w, h = math.ceil(w), math.ceil(h)
                dst = src.crop((x, y, x + w, y + h))
                if rectify_pose:
                    dst = _rectify_pose(dst, (x, y), ann["points"])
                name = f"img_{img_idx + start}_{ann_idx}.jpg"
                _save_jpeg(dst, src, ospj(dst_root, name))
                rows.append((f"image/{name}", label))
            src.close()
        _write_gt(ospj(root, f"{split}_label.txt"), rows, sep=" ", strip_label=False)
        start += len(annotation["imgs"])
    return start


def convert_coco2(root: str) -> int:
    """coco_2_converter.py: COCO-Text v2 (cocotext.v2.json) → padded crops of
    legible machine-printed english words, train→image/ val→image_val/."""
    from PIL import Image

    with open(ospj(root, "cocotext.v2.json"), encoding="utf-8") as f:
        annotation = json.load(f)
    start = 0
    for split, dst_name, label_file in (
        ("train", "image", "train_label.txt"),
        ("val", "image_val", "val_label.txt"),
    ):
        dst_root = ospj(root, dst_name)
        os.makedirs(dst_root, exist_ok=True)
        rows = []
        for img_idx, img_info in enumerate(annotation["imgs"].values()):
            if img_info["set"] != split:
                continue
            src = Image.open(ospj(root, "train2014", img_info["file_name"]))
            src_w, src_h = src.size
            anns = [annotation["anns"][str(a)] for a in annotation["imgToAnns"][str(img_info["id"])]]
            for ann_idx, ann in enumerate(anns):
                label = html.unescape(ann["utf8_string"].strip())
                if (not label or ann["class"] != "machine printed"
                        or ann["language"] != "english" or ann["legibility"] != "legible"):
                    continue
                # '#' marks partial transcriptions; leading/trailing '*'
                # marks unreadable characters (upstream comments)
                if label != "#" and "#" in label:
                    continue
                if label.startswith("*") or label.endswith("*"):
                    continue
                pad = 2
                x, y, w, h = ann["bbox"]
                x, y = max(0, math.floor(x) - pad), max(0, math.floor(y) - pad)
                w, h = math.ceil(w), math.ceil(h)
                x2, y2 = min(src_w, x + w + 2 * pad), min(src_h, y + h + 2 * pad)
                name = f"img_{img_idx + start}_{ann_idx}.jpg"
                _save_crop(src, (x, y, x2, y2), ospj(dst_root, name))
                rows.append((f"{dst_name}/{name}", label))
            src.close()
        _write_gt(ospj(root, label_file), rows, sep=" ", strip_label=False)
        start += len(annotation["imgs"])
    return start


def convert_openvino(root: str) -> int:
    """openvino_converter.py: OpenVINO OpenImages-v5 text-spotting JSONs →
    crops of legible english words, one image_{s}/ dir per train shard."""
    from PIL import Image

    start = 0
    shards = [(s, f"image_{s}", f"train_{s}_label.txt",
               f"text_spotting_openimages_v5_train_{s}.json") for s in "125f"]
    shards.append(("val", "image_val", "val_label.txt",
                   "text_spotting_openimages_v5_validation.json"))
    for _s, dst_name, label_file, ann_file in shards:
        ann_path = ospj(root, ann_file)
        if not os.path.exists(ann_path):
            print(f"skipping {ann_file} (not found)")
            continue
        with open(ann_path, encoding="utf-8") as f:
            annotation = json.load(f)
        dst_root = ospj(root, dst_name)
        os.makedirs(dst_root, exist_ok=True)
        anns_by_img = {}
        for ann in annotation["annotations"]:
            anns_by_img.setdefault(ann["image_id"], []).append(ann)
        rows = []
        for img_idx, img_info in enumerate(annotation["images"]):
            src = Image.open(ospj(root, img_info["file_name"]))
            for ann_idx, ann in enumerate(anns_by_img.get(img_info["id"], ())):
                attrs = ann["attributes"]
                if not attrs["legible"] or attrs["language"] != "english":
                    continue
                x, y, w, h = ann["bbox"]
                x, y = max(0, math.floor(x)), max(0, math.floor(y))
                w, h = math.ceil(w), math.ceil(h)
                name = f"img_{img_idx + start}_{ann_idx}.jpg"
                _save_crop(src, (x, y, x + w, y + h), ospj(dst_root, name))
                rows.append((f"{dst_name}/{name}", attrs["transcription"]))
            src.close()
        _write_gt(ospj(root, label_file), rows, sep=" ", strip_label=False)
        # upstream main() REASSIGNS num_train_imgs to each shard's own image
        # count (not cumulative), so shard N+1 starts at len(shard N) —
        # mirror that for filename-identical output
        start = len(annotation["images"])
    return start


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("art", "case-sensitive", "coco-text", "mlt19", "lsvt",
                 "coco2", "openvino"):
        p = sub.add_parser(name)
        p.add_argument("root", help="dataset root directory")
    p = sub.add_parser("textocr")
    p.add_argument("root")
    p.add_argument("--rectify_pose", action="store_true",
                   help="rotate rotated-text crops horizontal")
    args = ap.parse_args(argv)
    fn = {
        "art": convert_art,
        "case-sensitive": convert_case_sensitive,
        "coco-text": convert_coco_text,
        "mlt19": convert_mlt19,
        "lsvt": convert_lsvt,
        "coco2": convert_coco2,
        "openvino": convert_openvino,
    }
    if args.cmd == "textocr":
        convert_textocr(args.root, rectify_pose=args.rectify_pose)
    else:
        fn[args.cmd](args.root)
    print("Finish")


if __name__ == "__main__":
    main()
