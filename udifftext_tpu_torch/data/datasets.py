"""Datasets: LAION-OCR, TextSeg, SynthText, ICDAR13, LabelDataset (port of
`udifftext_tpu/data/datasets.py`, the same numpy/cv2/PIL code).

Behavior parity: dataset/dataloader.py:63-922. Each dataset yields a sample
dict with the reference's keys (image/mask/masked/seg/seg_mask/r_bbox/label/
txt/sizes/name — dataloader.py:905-921) in **NHWC numpy** (images in [-1, 1],
HWC; seg as (H, W, seq_len)); the loader adds `label_ids` for the
LabelEncoder. Word-substitution augmentation uses the same length-bucketed
words.txt dictionary (:46-60).

These are plain-Python indexables (no torch.utils.data): batching and
prefetching live in loader.py. Each dataset draws from its own
`random.Random(cfgs["seed"])`, so one seed gives the same samples as the
JAX package's datasets. cv2 and PIL are imported inside the functions that
use them, so the package imports where neither is installed.
"""

from __future__ import annotations

import glob
import json
import os
import random
from os.path import join as ospj
from typing import Dict, List, Optional

import numpy as np

from ..charset import CHARSET
from . import augment as A

# Rejection-resampling bound for __getitem__: items are pre-filtered at scan
# time, so a single retry is already rare — 100 consecutive rejections means
# the dataset is degenerate (e.g. every seg below seg_min_ratio) and MUST
# raise instead of spinning forever.
MAX_RESAMPLE_ATTEMPTS = 100


def initialize_word_dict(words_path: str) -> Dict[int, List[str]]:
    """Length-bucketed substitution dictionary (dataloader.py:46-60)."""
    with open(words_path, "r") as f:
        word_list = f.readlines()
    words: List[str] = []
    for line in word_list:
        words += line.rstrip("\n").split(" ")
    words.sort(key=len)
    word_dict: Dict[int, List[str]] = {
        l: [] for l in range(len(words[0]), len(words[-1]) + 1)
    }
    for w in words:
        word_dict[len(w)].append(w)
    return word_dict


def region_draw_text(
    H: int, W: int, r_bbox, text: str, font_path: str
) -> np.ndarray:
    """Render `text` into the bbox region on white (dataloader.py:21-43).
    Returns (H, W, 3) float32 in [0, 1]."""
    from PIL import Image, ImageDraw, ImageFont

    m_top, m_bottom, m_left, m_right = [int(v) for v in r_bbox]
    m_h, m_w = m_bottom - m_top, m_right - m_left
    font = ImageFont.truetype(font_path, 128)
    l, t, r, b = font.getbbox(text)
    std_h, std_w = b - t, r - l
    img = Image.new("RGB", (max(std_w, 1), max(std_h, 1)), color=(255, 255, 255))
    ImageDraw.Draw(img).text((0, 0), text, fill=(0, 0, 0), font=font, anchor="lt")
    img = img.resize((max(m_w, 1), max(m_h, 1)), Image.BICUBIC)
    out = np.ones((H, W, 3), np.float32)
    out[m_top:m_bottom, m_left:m_right] = np.asarray(img, np.float32) / 255.0
    return out


def resolve_font_path(font_path: Optional[str] = None) -> Optional[str]:
    """Resolve a usable TTF path: the explicit `font_path` if it exists
    (a missing explicit path RAISES — silently substituting another font
    would change the rendered glyph distribution behind the user's back),
    else a user-dropped assets/arial.ttf (the reference ships
    dataset/utils/arial.ttf), else the BUNDLED DejaVuSans.ttf
    (assets/DejaVuSans.ttf + LICENSE_DEJAVU: a base install runs
    out of the box, matching the reference's in-tree arial.ttf), else
    matplotlib's DejaVu Sans. Returns None only when nothing is found."""
    if font_path:
        if not os.path.exists(str(font_path)):
            raise FileNotFoundError(
                f"font_path {font_path!r} does not exist — fix the config "
                "or set font_path: null to use the bundled/DejaVu fallback"
            )
        return str(font_path)
    assets = ospj(os.path.dirname(__file__), "assets")
    candidates = [ospj(assets, "arial.ttf"), ospj(assets, "DejaVuSans.ttf")]
    for p in candidates:
        if p and os.path.exists(p):
            return p
    try:
        import matplotlib.font_manager as fm

        p = fm.findfont("DejaVu Sans")
        return p if p and os.path.exists(p) else None
    except Exception:
        return None


def _resolve_font(cfgs) -> Optional[str]:
    """font_path from config, else bundled, else DejaVu Sans — so `rendered`
    is present consistently across datasets (the reference emits it from
    ICDAR13 and TextSeg, dataloader.py:266,467; a missing font silently
    dropped the key here)."""
    return resolve_font_path(cfgs.get("font_path"))


def _finalize(
    image: np.ndarray,
    mask: np.ndarray,
    r_bbox,
    text: str,
    seq_len: int,
    name: str,
    orig_hw,
    H: int,
    W: int,
    seg_lhw: Optional[np.ndarray] = None,
    ref: Optional[np.ndarray] = None,
    rendered: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Common sample assembly (dataloader.py:255-287 etc.), NHWC layout."""
    image_f = image.astype(np.float32) / 127.5 - 1.0
    keep = mask.astype(np.float32)[..., None]  # 1 = keep region
    masked = image_f * keep
    sample = {
        "image": image_f,
        "mask": (1.0 - keep).astype(np.float32),
        "masked": masked.astype(np.float32),
        "seg_mask": np.concatenate(
            [np.ones(len(text), np.float32), np.zeros(seq_len - len(text), np.float32)]
        ),
        "r_bbox": np.asarray(r_bbox, np.int32),
        "label": text,
        "txt": f'"{text}"',
        "original_size_as_tuple": np.asarray(orig_hw, np.int32),
        "crop_coords_top_left": np.zeros(2, np.int32),
        "target_size_as_tuple": np.asarray((H, W), np.int32),
        "name": name,
    }
    if seg_lhw is not None:
        sample["seg"] = seg_lhw.transpose(1, 2, 0).astype(np.float32)  # (H, W, L)
    if ref is not None:
        sample["ref"] = ref
    if rendered is not None:
        sample["rendered"] = rendered
    return sample


class _SceneTextDataset:
    """Common config surface for the four scene-text datasets."""

    def __init__(self, cfgs, datype: str):
        self.type = datype
        self.cfgs = cfgs
        self.H = cfgs["H"]
        self.W = cfgs["W"]
        self.word_len = tuple(cfgs["word_len"])
        self.seq_len = cfgs.get("seq_len", self.word_len[1])
        self.mask_min_ratio = cfgs["mask_min_ratio"]
        self.seg_min_ratio = cfgs.get("seg_min_ratio", 0.0)
        self.aug_text_enabled = cfgs.get("aug_text_enabled", False)
        self.aug_text_ratio = cfgs.get("aug_text_ratio", 0.0)
        self.count = -1
        words_path = cfgs.get(
            "words_path", ospj(os.path.dirname(__file__), "assets", "words.txt")
        )
        self.word_dict = (
            initialize_word_dict(words_path) if os.path.exists(words_path) else {}
        )
        self.rng = random.Random(cfgs.get("seed"))

    def _maybe_substitute(self, text: str) -> str:
        if (
            self.aug_text_enabled
            and self.word_dict.get(len(text))
            and self.rng.uniform(0, 1) <= self.aug_text_ratio
        ):
            return self.rng.choice(self.word_dict[len(text)])
        return text


class ICDAR13Dataset(_SceneTextDataset):
    """dataloader.py:123-289 — axis-aligned word boxes, no char segmentation
    (evaluation only)."""

    def __init__(self, cfgs, datype="val"):
        super().__init__(cfgs, datype)
        data_root = ospj(cfgs["data_root"], "ICDAR13", datype)
        self.image_root = ospj(data_root, "images")
        anno_paths = sorted(glob.glob(ospj(data_root, "annos", "*.txt")))
        self.items = []
        for anno_path in anno_paths:
            name = os.path.basename(anno_path).split(".")[0].replace("gt_", "")
            with open(anno_path) as fp:
                for anno in fp.readlines():
                    try:
                        text = anno.split('"')[1]
                        left, top, right, bottom = [int(s) for s in anno.split(", ")[:4]]
                    except (IndexError, ValueError):
                        continue
                    area = (bottom - top) * (right - left)
                    if not (self.word_len[0] <= len(text) <= self.word_len[1]):
                        continue
                    if not all(c in CHARSET for c in text):
                        continue
                    if area / (self.H * self.W) < self.mask_min_ratio:
                        continue
                    self.items.append(
                        {
                            "image_path": ospj(self.image_root, f"{name}.jpg"),
                            "text": text,
                            "bbox": (top, bottom, left, right),
                        }
                    )

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        from PIL import Image

        self.count += 1
        item = self.items[index]
        text = self._maybe_substitute(item["text"]) if self.aug_text_enabled else item["text"]

        image = np.asarray(Image.open(item["image_path"]).convert("RGB"))
        h, w = image.shape[:2]
        m_top, m_bottom, m_left, m_right = item["bbox"]
        mask = np.ones((h, w), np.uint8)
        mask[m_top:m_bottom, m_left:m_right] = 0

        image, mask, _, bbox = A.square_pad(image, mask, item["bbox"])
        area = (bbox[1] - bbox[0]) * (bbox[3] - bbox[2])
        image, mask, _, bbox = A.zoom_to_mask(image, mask, bbox, area, self.mask_min_ratio)
        image, mask, r_bbox, _ = A.resize_all(image, mask, bbox, self.H, self.W)

        font_path = _resolve_font(self.cfgs)
        rendered = (
            region_draw_text(self.H, self.W, r_bbox, text, font_path)
            if font_path
            else None
        )
        return _finalize(
            image, mask, r_bbox, text, self.seq_len, str(self.count), (h, w),
            self.H, self.W, rendered=rendered,
        )


class TextSegDataset(_SceneTextDataset):
    """dataloader.py:292-491 — quad bboxes + per-character mask values."""

    def __init__(self, cfgs, datype="train"):
        import cv2

        super().__init__(cfgs, datype)
        data_root = ospj(cfgs["data_root"], "TextSeg", datype)
        image_paths = sorted(glob.glob(ospj(data_root, "image", "*.jpg")))
        anno_paths = sorted(glob.glob(ospj(data_root, "annotation", "*.json")))
        seg_paths = sorted(
            [p for p in glob.glob(ospj(data_root, "annotation", "*.png")) if "eff" not in p]
        )
        self.items = []
        for image_path, anno_path, seg_path in zip(image_paths, anno_paths, seg_paths):
            with open(anno_path, "rb") as fp:
                annos = json.load(fp)
            for anno in annos.values():
                text = anno["text"]
                chars = [anno["char"][key]["text"] for key in anno["char"]]
                bbox = np.array(anno["bbox"]).reshape((4, 2))
                seg_values = [c["mask_value"] for c in anno["char"].values()]
                if "".join(chars) != text or "#" in text:
                    continue
                if not (self.word_len[0] <= len(text) <= self.word_len[1]):
                    continue
                if not all(c in CHARSET for c in text):
                    continue
                if cv2.contourArea(bbox.astype(np.int32)) / (self.H * self.W) < self.mask_min_ratio:
                    continue
                self.items.append(
                    {
                        "image_path": image_path,
                        "seg_path": seg_path,
                        "text": text,
                        "bbox": bbox,
                        "seg_values": seg_values,
                    }
                )

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        import cv2
        from PIL import Image

        self.count += 1
        item = self.items[index]
        text = item["text"]
        sub_text = self._maybe_substitute(text)
        bbox_quad = item["bbox"].astype(np.int32)

        image = np.asarray(Image.open(item["image_path"]).convert("RGB"))
        seg_rgb = np.asarray(Image.open(item["seg_path"]).convert("RGB"))
        h, w = image.shape[:2]

        m_top, m_bottom = int(bbox_quad[:, 1].min()), int(bbox_quad[:, 1].max())
        m_left, m_right = int(bbox_quad[:, 0].min()), int(bbox_quad[:, 0].max())
        mask = np.ones((h, w), np.uint8)
        mask = cv2.fillConvexPoly(mask, bbox_quad, 0)

        image, mask, seg_rgb, bbox = A.square_pad(
            image, mask, (m_top, m_bottom, m_left, m_right), seg=seg_rgb
        )
        area = cv2.contourArea(bbox_quad)
        image, mask, seg_rgb, bbox = A.zoom_to_mask(
            image, mask, bbox, area, self.mask_min_ratio, seg=seg_rgb, seg_layout="hwc"
        )
        seg_lhw = A.charseg_from_values(seg_rgb, text, item["seg_values"], self.seq_len)
        image, mask, r_bbox, seg_lhw = A.resize_all(
            image, mask, bbox, self.H, self.W, seg_lhw=seg_lhw
        )
        font_path = _resolve_font(self.cfgs)
        rendered = (
            region_draw_text(self.H, self.W, r_bbox, sub_text, font_path)
            if font_path
            else None
        )
        return _finalize(
            image, mask, r_bbox, sub_text, self.seq_len, str(self.count), (h, w),
            self.H, self.W, seg_lhw=seg_lhw, rendered=rendered,
        )


class SynthTextDataset(_SceneTextDataset):
    """dataloader.py:494-694 — gt.mat word/char quads on synthetic images."""

    def __init__(self, cfgs, datype="train"):
        import cv2
        import scipy.io

        super().__init__(cfgs, datype)
        self.length = cfgs.get("length", 100000)
        data_root = ospj(cfgs["data_root"], "SynthText")
        cache = ospj(data_root, "items.json")
        if cfgs.get("use_cached") and os.path.exists(cache):
            with open(cache) as fp:
                self.items = json.load(fp)
        else:
            anno = scipy.io.loadmat(ospj(data_root, "gt.mat"))
            self.items = []
            for image_name, word_bbox, char_bbox, txt in zip(
                anno["imnames"][0], anno["wordBB"][0], anno["charBB"][0], anno["txt"][0]
            ):
                image_path = ospj(data_root, image_name[0])
                txt_list = []
                for frag in txt:
                    txt_list += [s for s in frag.replace("\n", " ").split(" ") if s]
                if word_bbox.ndim < 3:
                    word_bbox = word_bbox[..., None]
                word_bbox = word_bbox.transpose(2, 1, 0).astype(np.int32)
                char_bbox = char_bbox.transpose(2, 1, 0).astype(np.int32)
                pointer = 0
                for bbox, text in zip(word_bbox, txt_list):
                    seg_bboxes = char_bbox[pointer : pointer + len(text)]
                    pointer += len(text)
                    if not (self.word_len[0] <= len(text) <= self.word_len[1]):
                        continue
                    if cv2.contourArea(bbox) / (self.H * self.W) < self.mask_min_ratio:
                        continue
                    self.items.append(
                        {
                            "image_path": image_path,
                            "text": text,
                            "bbox": bbox.tolist(),
                            "seg_bboxs": seg_bboxes.tolist(),
                        }
                    )
            try:
                with open(cache, "w") as fp:
                    json.dump(self.items, fp)
            except OSError:
                pass

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        import cv2
        from PIL import Image

        self.count += 1
        for _attempt in range(MAX_RESAMPLE_ATTEMPTS):
            item = self.rng.choice(self.items)
            text = item["text"]
            bbox = np.array(item["bbox"], np.int32)
            seg_bboxes = np.array(item["seg_bboxs"], np.int32)

            image = np.asarray(Image.open(item["image_path"]).convert("RGB"))
            h, w = image.shape[:2]
            m_top = max(0, int(bbox[:, 1].min()))
            m_bottom = min(h, int(bbox[:, 1].max()))
            m_left = max(0, int(bbox[:, 0].min()))
            m_right = min(w, int(bbox[:, 0].max()))
            mask = np.ones((h, w), np.uint8)
            mask = cv2.fillConvexPoly(mask, bbox, 0)

            seg_lhw, seg_ratio = A.charseg_from_boxes(
                (h, w), seg_bboxes, len(text), self.seq_len
            )
            if seg_ratio < self.seg_min_ratio:
                continue

            seg_hwc = seg_lhw.transpose(1, 2, 0)
            image, mask, seg_hwc, bb = A.square_pad(
                image, mask, (m_top, m_bottom, m_left, m_right), seg=seg_hwc
            )
            area = cv2.contourArea(bbox)
            image, mask, seg_hwc, bb = A.zoom_to_mask(
                image, mask, bb, area, self.mask_min_ratio, seg=seg_hwc, seg_layout="hwc"
            )
            image, mask, r_bbox, seg_lhw = A.resize_all(
                image, mask, bb, self.H, self.W, seg_lhw=seg_hwc.transpose(2, 0, 1)
            )
            return _finalize(
                image, mask, r_bbox, text, self.seq_len, str(self.count), (h, w),
                self.H, self.W, seg_lhw=seg_lhw,
            )
        raise RuntimeError(
            f"{type(self).__name__}: {MAX_RESAMPLE_ATTEMPTS} consecutive items "
            f"rejected at __getitem__({index}) (last: {item['image_path']!r}) — "
            "every sampled seg fell below seg_min_ratio "
            f"({self.seg_min_ratio}); the dataset is degenerate or the "
            "filter thresholds are wrong"
        )


class LAIONOCRDataset(_SceneTextDataset):
    """dataloader.py:697-922 — LAION-OCR with charseg.npy id maps."""

    def __init__(self, cfgs, datype="train"):
        import cv2

        super().__init__(cfgs, datype)
        # reference disables word substitution for the train split (:718)
        if datype == "train":
            self.aug_text_enabled = False
        self.H_std = self.W_std = 512
        self.length = cfgs.get("length", 100000)
        root = ospj(cfgs["data_root"], "LAION-OCR")
        self.data_root = ospj(root, datype)
        cache = ospj(root, f"{datype}_items.json")
        if cfgs.get("use_cached") and os.path.exists(cache):
            with open(cache) as fp:
                self.items = json.load(fp)
        else:
            self.items = []
            for data_dir in sorted(glob.glob(ospj(self.data_root, "*"))):
                image_path = ospj(data_dir, "image.jpg")
                ocr_path = ospj(data_dir, "ocr.txt")
                seg_path = ospj(data_dir, "charseg.npy")
                if not os.path.exists(ocr_path):
                    continue
                with open(ocr_path) as fp:
                    for ocr in fp.readlines():
                        try:
                            text, bbox_str, _ = ocr.strip("\n").split(" ")
                        except ValueError:
                            continue
                        bbox = np.array([int(v) for v in bbox_str.split(",")]).reshape(4, 2)
                        if not (self.word_len[0] <= len(text) <= self.word_len[1]):
                            continue
                        if not all(c in CHARSET for c in text):
                            continue
                        if cv2.contourArea(bbox) / (self.W_std * self.H_std) < self.mask_min_ratio:
                            continue
                        self.items.append(
                            {
                                "image_path": image_path,
                                "seg_path": seg_path,
                                "text": text,
                                "bbox_str": bbox_str,
                            }
                        )
            try:
                with open(cache, "w") as fp:
                    json.dump(self.items, fp)
            except OSError:
                pass

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        import cv2
        from PIL import Image

        self.count += 1
        for _attempt in range(MAX_RESAMPLE_ATTEMPTS):
            item = self.rng.choice(self.items)
            text = item["text"]
            sub_text = self._maybe_substitute(text)
            bbox = np.array([int(v) for v in item["bbox_str"].split(",")]).reshape(4, 2)

            image = np.asarray(Image.open(item["image_path"]).convert("RGB"))
            h, w = image.shape[:2]
            seg_ids = np.load(item["seg_path"])

            image = cv2.resize(image, (self.W_std, self.H_std))
            seg_ids = cv2.resize(seg_ids.astype(np.uint8), (self.W_std, self.H_std))
            mask = np.ones((self.H_std, self.W_std), np.uint8)
            mask = cv2.fillConvexPoly(mask, bbox, 0)

            m_top = max(0, int(bbox[:, 1].min()))
            m_bottom = min(self.H_std, int(bbox[:, 1].max()))
            m_left = max(0, int(bbox[:, 0].min()))
            m_right = min(self.W_std, int(bbox[:, 0].max()))

            area = cv2.contourArea(bbox)
            image, mask, seg_ids, bb = A.zoom_to_mask(
                image, mask, (m_top, m_bottom, m_left, m_right), area,
                self.mask_min_ratio, seg=seg_ids, seg_layout="hw",
            )
            seg_ids = seg_ids * (1 - mask)
            seg_lhw = A.charseg_from_ids(seg_ids, text, self.seq_len)
            if seg_lhw is None:
                continue
            image, mask, r_bbox, seg_lhw = A.resize_all(
                image, mask, bb, self.H, self.W, seg_lhw=seg_lhw
            )

            m_top, m_bottom, m_left, m_right = r_bbox
            img_f = image.astype(np.float32) / 127.5 - 1.0
            crop = img_f[m_top:m_bottom, m_left:m_right]
            if crop.size == 0:
                continue
            ref = cv2.resize(crop, (128, 128), interpolation=cv2.INTER_NEAREST)
            return _finalize(
                image, mask, r_bbox, sub_text, self.seq_len, str(self.count), (h, w),
                self.H, self.W, seg_lhw=seg_lhw, ref=ref,
            )
        raise RuntimeError(
            f"{type(self).__name__}: {MAX_RESAMPLE_ATTEMPTS} consecutive items "
            f"rejected at __getitem__({index}) (last: {item['image_path']!r}) — "
            "charseg id-matching or the crop kept failing; the dataset is "
            "degenerate (charseg.npy ids must be CHARSET.find(c)+1)"
        )


class LabelDataset:
    """Random rendered strings for LabelEncoder pretraining (dataloader.py:
    63-120): grayscale 224², text white-on-black."""

    def __init__(self, size=224, length=100000, font_path=None, min_len=1, max_len=12, seed=None):
        from PIL import ImageFont

        self.size = size
        self.length = length
        self.font_path = resolve_font_path(font_path)
        if self.font_path is None:
            raise FileNotFoundError(
                "LabelDataset needs a TTF font but none was found: "
                f"font_path={font_path!r} does not exist and the bundled "
                "assets/DejaVuSans.ttf is missing (broken install — it ships "
                "in the package). Pass font_path= explicitly (any .ttf on "
                "this machine) or set dataset.params.font_path in the "
                "pretrain config."
            )
        # Load once, eagerly: an unloadable font must raise here with a clear
        # message, never be swallowed per-item (a silent retry loop would hang
        # pretraining forever — the reference's dataloader.py:84 assumes the
        # bundled arial.ttf always loads).
        self._font = ImageFont.truetype(self.font_path, 128)
        self.min_len = min_len
        self.max_len = max_len
        self.rng = random.Random(seed)

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        from PIL import Image, ImageDraw

        font = self._font
        for _attempt in range(MAX_RESAMPLE_ATTEMPTS):
            text_len = self.rng.randint(self.min_len, self.max_len)
            text = "".join(self.rng.choice(CHARSET) for _ in range(text_len))
            l, t, r, b = font.getbbox(text)
            std_h, std_w = b - t, r - l
            if std_h == 0 or std_w == 0:
                continue  # degenerate glyph run; new random text next round
            img = Image.new("RGB", (std_w, std_h), color=(0, 0, 0))
            ImageDraw.Draw(img).text((0, 0), text, fill=(255, 255, 255), font=font, anchor="lt")
            img = img.convert("L").resize((self.size, self.size), Image.BICUBIC)
            arr = np.asarray(img, np.float32)[..., None] / 255.0  # (S, S, 1)
            return {"image": arr, "text": text}
        raise RuntimeError(
            f"LabelDataset: {MAX_RESAMPLE_ATTEMPTS} consecutive glyph runs "
            f"from font {self.font_path!r} had zero extent — the font cannot "
            "render the charset; pass a different font_path"
        )
