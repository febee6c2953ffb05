"""The port's data pipeline (udifftext_tpu_torch/data/) against the JAX
package's on synthetic fixtures, on the CPU: every dataset class gives the
same samples as `udifftext_tpu.data` under the same seed (exact: the same
numpy/cv2/PIL code and the same `random.Random` draws), `collate` the same
batches with `label_ids` and `parseq_label_ids` (exact), and the loader the
same epochs, in order, at any worker count. Fixtures are built as
tests/test_data.py builds them.
"""

import json
import os

import numpy as np
import pytest
import scipy.io
import yaml
from PIL import Image, ImageDraw, ImageFont

import udifftext_tpu.data.datasets as JD
import udifftext_tpu.data.loader as JL
import udifftext_tpu_torch.data.datasets as PD
import udifftext_tpu_torch.data.loader as PL
from udifftext_tpu.charset import CHARSET
from udifftext_tpu_torch.data import augment as PA

FONT = os.path.join(os.path.dirname(__import__("matplotlib").__file__),
                    "mpl-data/fonts/ttf/DejaVuSans.ttf")
WORDS = os.path.join(os.path.dirname(JD.__file__), "assets", "words.txt")


def _cfg(root, **over):
    cfg = {
        "data_root": str(root), "H": 128, "W": 128, "word_len": [1, 12], "seq_len": 12,
        "mask_min_ratio": 0.01, "seg_min_ratio": 0.001, "aug_text_enabled": True,
        "aug_text_ratio": 0.5, "use_cached": False, "length": 6, "words_path": WORDS,
        "font_path": FONT, "seed": 4,
    }
    cfg.update(over)
    return cfg


def _assert_same_sample(got, want, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")
        else:
            assert g == w, (what, k, g, w)


def _same_samples(make, n, what):
    """make(module) → dataset; n samples of each, drawn in turn, equal."""
    jds, pds = make(JD), make(PD)
    assert len(jds) == len(pds)
    for i in range(n):
        _assert_same_sample(pds[i % len(pds)], jds[i % len(jds)], f"{what}[{i}]")
    return pds


# --- fixtures ------------------------------------------------------------------


def _icdar13(root):
    d = root / "ICDAR13" / "val"
    (d / "images").mkdir(parents=True)
    (d / "annos").mkdir()
    for n, (word, xy) in enumerate([("cat", (50, 60)), ("Dog7", (20, 30))]):
        img = Image.new("RGB", (200, 150), (120, 110 + 20 * n, 100))
        ImageDraw.Draw(img).text(xy, word, fill=(255, 255, 255),
                                 font=ImageFont.truetype(FONT, 24))
        img.save(d / "images" / f"img{n}.jpg")
        x, y = xy
        with open(d / "annos" / f"gt_img{n}.txt", "w") as f:
            f.write(f'{x - 2}, {y - 5}, {x + 20 * len(word)}, {y + 30}, "{word}"\n')


def _textseg(root):
    d = root / "TextSeg" / "train"
    (d / "image").mkdir(parents=True)
    (d / "annotation").mkdir()
    rs = np.random.RandomState(1)
    for n in range(2):
        img = (rs.uniform(0, 255, (160, 220, 3))).astype(np.uint8)
        Image.fromarray(img).save(d / "image" / f"{n:04d}.jpg")
        seg = np.zeros((160, 220, 3), np.uint8)
        words = {}
        for w, (text, x0, y0) in enumerate([("ab", 20, 30), ("Hi5", 100, 90)]):
            chars = {}
            for c, ch in enumerate(text):
                v = 40 + 30 * (3 * w + c)
                seg[y0:y0 + 40, x0 + 25 * c:x0 + 25 * c + 20] = v
                chars[str(c)] = {"text": ch, "mask_value": v}
            x1, y1 = x0 + 25 * len(text), y0 + 40
            words[f"{w:04d}"] = {"text": text, "bbox": [x0, y0, x1, y0, x1, y1, x0, y1],
                                 "char": chars}
        Image.fromarray(seg).save(d / "annotation" / f"{n:04d}_mask.png")
        with open(d / "annotation" / f"{n:04d}_anno.json", "w") as f:
            json.dump(words, f)


def _synthtext(root):
    d = root / "SynthText"
    d.mkdir(parents=True)
    rs = np.random.RandomState(2)
    names, wbbs, cbbs, txts = [], [], [], []
    for n in range(2):
        Image.fromarray(rs.uniform(0, 255, (200, 260, 3)).astype(np.uint8)).save(d / f"s{n}.jpg")
        words = [("Tree", 30, 40), ("go", 120, 120)]
        wbb, cbb = [], []
        for text, x0, y0 in words:
            x1, y1 = x0 + 22 * len(text), y0 + 36
            wbb.append([[x0, x1, x1, x0], [y0, y0, y1, y1]])
            for c in range(len(text)):
                cx = x0 + 22 * c
                cbb.append([[cx, cx + 20, cx + 20, cx], [y0, y0, y1, y1]])
        names.append(np.array([f"s{n}.jpg"]))
        wbbs.append(np.asarray(wbb, np.float64).transpose(1, 2, 0))  # (2, 4, words)
        cbbs.append(np.asarray(cbb, np.float64).transpose(1, 2, 0))  # (2, 4, chars)
        txts.append(np.array([" ".join(t for t, _, _ in words)]))

    def cell(items):
        out = np.empty((1, len(items)), dtype=object)
        for i, v in enumerate(items):
            out[0, i] = v
        return out

    scipy.io.savemat(d / "gt.mat", {"imnames": cell(names), "wordBB": cell(wbbs),
                                    "charBB": cell(cbbs), "txt": cell(txts)})


def _laion(root):
    for n, (text, val) in enumerate([("ab", 100), ("cab", 90)]):
        d = root / "LAION-OCR" / "train" / f"{n:05d}"
        d.mkdir(parents=True)
        Image.new("RGB", (512, 512), (val, 100, 100)).save(d / "image.jpg")
        seg = np.zeros((512, 512), np.uint8)
        for c, ch in enumerate(text):
            seg[200:260, 100 + 90 * c:160 + 90 * c] = CHARSET.find(ch) + 1
        np.save(d / "charseg.npy", seg)
        right = 100 + 90 * len(text)
        with open(d / "ocr.txt", "w") as f:
            f.write(f"{text} 90,190,{right},190,{right},270,90,270 0.9\n")


# --- the datasets --------------------------------------------------------------


def test_icdar13_same_samples(tmp_path):
    _icdar13(tmp_path)
    ds = _same_samples(lambda m: m.ICDAR13Dataset(_cfg(tmp_path), "val"), 6, "icdar13")
    s = ds[0]
    assert s["image"].shape == (128, 128, 3) and s["rendered"].shape == (128, 128, 3)


def test_textseg_same_samples(tmp_path):
    _textseg(tmp_path)
    ds = _same_samples(lambda m: m.TextSegDataset(_cfg(tmp_path), "train"), 6, "textseg")
    s = ds[1]
    assert len(ds) == 4 and s["seg"].shape == (128, 128, 12) and s["seg"].dtype == np.float32
    assert s["seg"][..., :len(s["label"])].sum() > 0


def test_synthtext_same_samples(tmp_path):
    _synthtext(tmp_path)
    ds = _same_samples(lambda m: m.SynthTextDataset(_cfg(tmp_path), "train"), 6, "synthtext")
    s = ds[2]
    assert s["seg"].shape == (128, 128, 12) and s["r_bbox"].dtype == np.int32
    assert s["seg"][..., :len(s["label"])].sum() > 0


def test_laion_ocr_same_samples(tmp_path):
    _laion(tmp_path)
    ds = _same_samples(lambda m: m.LAIONOCRDataset(_cfg(tmp_path), "train"), 6, "laion")
    s = ds[3]
    assert s["ref"].shape == (128, 128, 3) and s["seg_mask"].dtype == np.float32
    assert s["mask"].shape == (128, 128, 1) and s["seg"].shape == (128, 128, 12)


@pytest.mark.parametrize("font", [FONT, None])
def test_label_dataset_same_samples(font):
    _same_samples(lambda m: m.LabelDataset(size=48, length=5, font_path=font, seed=9), 5,
                  "label")


def test_assets_and_font_resolution():
    """The port carries its own words.txt, DejaVuSans.ttf and license, byte
    for byte the JAX package's, and resolves them by itself."""
    for name in ("words.txt", "DejaVuSans.ttf", "LICENSE_DEJAVU"):
        with open(os.path.join(os.path.dirname(PD.__file__), "assets", name), "rb") as f, \
                open(os.path.join(os.path.dirname(JD.__file__), "assets", name), "rb") as g:
            assert f.read() == g.read(), name
    p = PD.resolve_font_path(None)
    assert p == os.path.join(os.path.dirname(PD.__file__), "assets", "DejaVuSans.ttf")
    port_words = os.path.join(os.path.dirname(PD.__file__), "assets", "words.txt")
    assert PD.initialize_word_dict(port_words) == JD.initialize_word_dict(WORDS)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        PD.resolve_font_path("/nonexistent/font.ttf")


def test_degenerate_laion_raises(tmp_path):
    d = tmp_path / "LAION-OCR" / "train" / "00001"
    d.mkdir(parents=True)
    Image.new("RGB", (512, 512), (100, 100, 100)).save(d / "image.jpg")
    np.save(d / "charseg.npy", np.zeros((512, 512), np.uint8))
    with open(d / "ocr.txt", "w") as f:
        f.write("ab 90,190,270,190,270,270,90,270 0.9\n")
    with pytest.raises(RuntimeError, match="consecutive items rejected"):
        PD.LAIONOCRDataset(_cfg(tmp_path), "train")[0]


def test_charseg_helpers_match():
    seg = np.zeros((256, 256), np.uint8)
    ida = CHARSET.find("a") + 1
    seg[100:130, 40:70] = ida
    seg[100:130, 120:150] = ida
    from udifftext_tpu.data import augment as JA

    np.testing.assert_array_equal(PA.charseg_from_ids(seg, "aa", 12),
                                  JA.charseg_from_ids(seg, "aa", 12))
    boxes = np.array([[[10, 10], [40, 10], [40, 50], [10, 50]]], np.int32)
    got, want = PA.charseg_from_boxes((64, 64), boxes, 1, 12), JA.charseg_from_boxes(
        (64, 64), boxes, 1, 12)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


# --- collate and the loader ------------------------------------------------------


def test_collate_same_batches(tmp_path):
    _laion(tmp_path)
    samples = [PD.LAIONOCRDataset(_cfg(tmp_path), "train")[i] for i in range(3)]
    want, got = JL.collate(samples), PL.collate(samples)
    assert got["parseq_label_ids"].shape == (3, 27) and got["label_ids"].shape == (3, 12)
    _assert_same_sample(got, want, "collate")
    texts = [{"image": np.zeros((4, 4, 1), np.float32), "text": t} for t in ("ab", "xyz")]
    _assert_same_sample(PL.collate(texts, 8), JL.collate(texts, 8), "collate text")


class _IndexDataset:
    """__getitem__ mixes the index with the ambient np.random stream,
    standing in for the augmentation's randomness."""

    def __init__(self, n=16):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((4, 4, 1), i, np.float32),
                "noise": np.random.rand(3).astype(np.float32), "label": "ab"}


def _epoch(module, ds, **kw):
    return [{k: v.copy() if isinstance(v, np.ndarray) else v for k, v in b.items()}
            for b in module.DataLoader(ds, **kw)]


@pytest.mark.parametrize("workers", [0, 1, 3])
def test_loader_epochs_match_jax(workers):
    """Shuffled epochs of the same loader seed: the port's batches equal the
    JAX package's, in order, with the workers' per-batch seeding."""
    kw = dict(batch_size=3, shuffle=True, seed=7, num_workers=workers, prefetch=2)
    got, want = _epoch(PL, _IndexDataset(12), **kw), _epoch(JL, _IndexDataset(12), **kw)
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        if workers == 0:  # in process, the ambient stream is not seeded per batch
            g.pop("noise"), w.pop("noise")
        _assert_same_sample(g, w, f"batch {i}")


def test_loader_worker_count_invariance_and_order():
    """The same loader seed gives bit-identical epochs at any num_workers >=
    1, and with shuffle off the workers yield the in-process order."""
    ds = _IndexDataset(12)
    a = _epoch(PL, ds, batch_size=3, shuffle=True, seed=7, num_workers=1)
    b = _epoch(PL, ds, batch_size=3, shuffle=True, seed=7, num_workers=3)
    for x, y in zip(a, b):
        _assert_same_sample(x, y, "workers 1 vs 3")
    inline = [b_["image"][:, 0, 0, 0] for b_ in PL.DataLoader(ds, batch_size=4, shuffle=False)]
    pooled = [b_["image"][:, 0, 0, 0] for b_ in PL.DataLoader(ds, batch_size=4, shuffle=False,
                                                              num_workers=2)]
    assert len(inline) == len(pooled) == 3
    for x, y in zip(inline, pooled):
        np.testing.assert_array_equal(x, y)


def test_loader_worker_error_propagates():
    class Bad(_IndexDataset):
        def __getitem__(self, i):
            if i == 5:
                raise ValueError("corrupt sample 5")
            return super().__getitem__(i)

    with pytest.raises(RuntimeError, match="corrupt sample 5"):
        list(PL.DataLoader(Bad(8), batch_size=4, shuffle=False, num_workers=2))


def _dataset_yaml(tmp_path):
    path = tmp_path / "label_ds.yaml"
    path.write_text(yaml.safe_dump({"target": "dataset.dataloader.LabelDataset",
                                    "params": {"size": 32, "length": 12, "font_path": FONT,
                                               "seed": 3}}))
    return str(path)


def test_get_dataloader_matches_jax(tmp_path):
    cfgs = {"dataset_cfg_path": _dataset_yaml(tmp_path), "batch_size": 4, "shuffle": False}
    got, want = list(PL.get_dataloader(cfgs)), list(JL.get_dataloader(cfgs))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_same_sample(g, w, "get_dataloader")
    assert PL.process_rank_and_count() == (0, 1)


def test_get_dataloader_shards_by_rank(tmp_path, monkeypatch):
    """Under torch.distributed (rank, world) the global batch is split, each
    rank reads a disjoint strided shard of one shared order, and a batch
    size the world does not divide is refused."""
    cfgs = {"dataset_cfg_path": _dataset_yaml(tmp_path), "batch_size": 4, "data_seed": 5}
    shards = []
    for rank in (0, 1):
        monkeypatch.setattr(PL, "process_rank_and_count", lambda r=rank: (r, 2))
        dl = PL.get_dataloader(cfgs)
        assert dl.batch_size == 2 and dl.process_index == rank and len(dl) == 3
        shards.append([i for idx in dl._index_batches() for i in idx])
    assert not set(shards[0]) & set(shards[1]) and len(shards[0] + shards[1]) == 12
    monkeypatch.setattr(PL, "process_rank_and_count", lambda: (0, 3))
    with pytest.raises(ValueError, match="divisible by the process count 3"):
        PL.get_dataloader(cfgs)
