"""The STR tools and trainer on the port (`udifftext_tpu_torch/scripts/
str_*.py`, `preprocess_laion_ocr.py`) against the JAX package's scripts on
the CPU, at tiny widths and in process.

- The trainer: `str_train.train` draws the JAX script's batch indices and
  permutations from one seeded generator, its resized batch is within 1e-6
  of the script's cv2.resize path, and three steps with SWA on a folder and
  on an LMDB follow the JAX step as `scripts/str_train.py:56-69` composes it
  (optax one-cycle schedule, clip at 20, AdamW) from the same weights: the
  first loss within 1e-4, the later ones within 1e-3, the parameters after
  the first update within 1e-4 where Adam's sign is decided. The averaged
  checkpoint loads strictly through `create_model` and is what
  `str_test --ckpt` reads.
- `str_test`: the same tables and `.log.txt` as the JAX script from one
  strhub checkpoint; --rotation 90/180/270 equal to Pillow's.
- `str_abinet_lm_acc`: `encode_labels` and the tables equal to JAX's.
- The host tools: every converter, `str_create_lmdb`, `str_filter_lmdb` and
  `preprocess_laion_ocr` write the JAX scripts' bytes.
- `str_tune` picks the lr a JAX sweep picks; every device entry point
  refuses to run without a GPU unless it is passed --device cpu.
"""

import filecmp
import importlib.util
import json
import os
import shutil
import sys
from os.path import join as ospj

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import torch_port_util as U
from test_str_tools import save_jpeg
from udifftext_tpu.models import parseq as JPQ
from udifftext_tpu.utils import ckpt_torch
from udifftext_tpu_torch.builders import randomize_parameters
from udifftext_tpu_torch.data.lmdb import write_lmdb
from udifftext_tpu_torch.models import parseq as PPQ
from udifftext_tpu_torch.models.abinet import ABINet
from udifftext_tpu_torch.models.str_hub import build_model, create_model
from udifftext_tpu_torch.scripts import (
    preprocess_laion_ocr,
    str_abinet_lm_acc,
    str_bench,
    str_convert_datasets,
    str_create_lmdb,
    str_filter_lmdb,
    str_read,
    str_test,
    str_train,
    str_tune,
)
from udifftext_tpu_torch.utils import convert
from udifftext_tpu_torch.utils.png import encode_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TINY = dict(embed_dim=32, enc_depth=1, enc_num_heads=2, dec_num_heads=2)
CHARS = list("abcdefghijklmnopqrstuvwxyzABCDEFGH0123456789!?")


def load_jax_script(name):
    """The JAX package's script `scripts/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ospj(REPO, "scripts",
                                                                      f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _word_images(n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        h, w = rs.randint(16, 41), rs.randint(40, 121)
        out.append((rs.randint(0, 256, (h, w, 3)).astype(np.uint8),
                    "".join(rs.choice(CHARS, rs.randint(1, 11)))))
    return out


def _write_folder(d, samples):
    os.makedirs(d, exist_ok=True)
    with open(ospj(d, "labels.txt"), "w") as f:
        for i, (img, label) in enumerate(samples):
            with open(ospj(d, f"w{i}.png"), "wb") as g:
                g.write(encode_png(img))
            f.write(f"w{i}.png {label}\n")


def _write_lmdb(d, samples):
    items = {b"num-samples": str(len(samples)).encode()}
    for i, (img, label) in enumerate(samples, start=1):
        items[b"image-%09d" % i] = encode_png(img)
        items[b"label-%09d" % i] = label.encode()
    write_lmdb(d, items)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """One set of 12 word crops as a labels.txt folder and as an LMDB."""
    root = tmp_path_factory.mktemp("str_data")
    samples = _word_images(12, 0)
    _write_folder(str(root / "folder"), samples)
    _write_lmdb(str(root / "lmdb"), samples)
    return root


@pytest.fixture(scope="module")
def jax_side():
    """The JAX script module and a tiny PARSeq with seeded weights, its
    loss-and-gradient jitted once for the module."""
    jtest = load_jax_script("str_test")
    model = JPQ.PARSeq(**TINY)
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 32, 128, 3)), 1),
                            jax.random.PRNGKey(0))
    params = U.random_like_flax(shapes, 3)

    @jax.jit
    def value_and_grad(p, images, ids, cms, qms):
        return jax.value_and_grad(lambda p_: JPQ.parseq_training_loss(
            model, p_, images, ids, content_masks=cms, query_masks=qms))(p)

    return jtest, jax.tree.map(np.asarray, params), value_and_grad


def _jax_batch(items, idx):
    """scripts/str_train.py:84-90: PIL → float → cv2 INTER_CUBIC → [-1, 1]."""
    imgs, labels = [], []
    for j in idx:
        open_fn, label = items[j]
        im = np.asarray(open_fn().convert("RGB"), np.float32) / 255.0
        imgs.append(cv2.resize(im, (128, 32), interpolation=cv2.INTER_CUBIC))
        labels.append(label)
    return (np.stack(imgs) - 0.5) / 0.5, labels


def _jax_train(jax_side, items, steps, batch, lr, warmup_pct, swa_start_pct):
    """The JAX script's loop (scripts/str_train.py:56-99) on the tiny model:
    each step's indices, permutations, batch, loss, the gradients of the
    first step, the parameters after each step, and the SWA average."""
    from udifftext_tpu.parallel.train import swa_update

    _, params, value_and_grad = jax_side
    tok = JPQ.ParseqTokenizer()
    sched = optax.cosine_onecycle_schedule(steps, lr, pct_start=warmup_pct)
    opt = optax.chain(optax.clip_by_global_norm(20.0), optax.adamw(sched))
    opt_state = opt.init(params)
    rng = np.random.default_rng(0)
    swa_from = int(steps * swa_start_pct)
    rec = {"idx": [], "perms": [], "images": [], "loss": [], "params": []}
    avg, n = None, 0
    for i in range(steps):
        idx = rng.choice(len(items), batch)
        images, labels = _jax_batch(items, idx)
        ids = tok.encode(labels)
        perms = JPQ.gen_tgt_perms(rng, ids.shape[1] - 2, perm_num=6)
        cms, qms = JPQ.perm_attn_masks(perms)
        loss, grads = value_and_grad(params, jnp.asarray(images), jnp.asarray(ids),
                                     jnp.asarray(cms), jnp.asarray(qms))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if i == 0:
            rec["grads"] = grads
        if i >= swa_from:
            avg = params if avg is None else swa_update(avg, params, jnp.asarray(n, jnp.float32))
            n += 1
        for k, v in (("idx", idx), ("perms", perms), ("images", images), ("loss", float(loss)),
                     ("params", params)):
            rec[k].append(v)
    rec["swa"] = avg
    return rec


@pytest.mark.parametrize("layout", ["folder", "lmdb"])
def test_str_train_three_steps_match_jax(layout, data, jax_side, monkeypatch, tmp_path):
    jtest, params, _ = jax_side
    steps, batch, lr, warmup, swa_pct = 3, 8, 7e-4, 0.34, 0.34
    want = _jax_train(jax_side, jtest.load_folder(str(data / layout)), steps, batch, lr, warmup,
                      swa_pct)
    items = str_test.load_folder(str(data / layout))
    model = U.load_port(PPQ.PARSeq(**TINY), convert.parseq_from_jax(params))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    rec = {"idx": [], "perms": [], "images": [], "params": []}

    def load_batch(items_, idx, hw, device):
        rec["idx"].append(np.array(idx))
        images, labels = real_load_batch(items_, idx, hw, device)
        rec["images"].append(images.clone())
        return images, labels

    def perms_fn(rng, n, perm_num):
        rec["perms"].append(real_perms(rng, n, perm_num=perm_num))
        return rec["perms"][-1]

    real_load_batch, real_perms = str_train.load_batch, str_train.gen_tgt_perms
    monkeypatch.setattr(str_train, "load_batch", load_batch)
    monkeypatch.setattr(str_train, "gen_tgt_perms", perms_fn)
    logs = []
    res = str_train.train(items, model, CPU, np.random.default_rng(0), steps=steps, batch=batch,
                          lr=lr, warmup_pct=warmup, swa=True, swa_start_pct=swa_pct,
                          log=logs.append,
                          on_step=lambda i, m: rec["params"].append(
                              {k: v.detach().clone() for k, v in m.state_dict().items()}))
    for i in range(steps):
        np.testing.assert_array_equal(rec["idx"][i], want["idx"][i])
        np.testing.assert_array_equal(rec["perms"][i], want["perms"][i])
        # the resized crops (x − 0.5 = half the normalized batch) within 1e-6
        U.assert_close(0.5 * rec["images"][i], 0.5 * want["images"][i], 0, 1e-6, f"batch {i}")
    U.assert_close(res.losses[0], want["loss"][0], 1e-4, 0, "step 1 loss")
    U.assert_close(res.losses[1:], want["loss"][1:], 1e-3, 0, "steps 2-3 losses")
    assert len(res.host_s) == len(res.step_s) == steps

    # after the first update: within 1e-4 where Adam's sign is decided or the
    # gradient is zero (embeddings of characters not drawn: weight decay
    # alone); the other elements move by at most the step's lr either side
    first = convert.parseq_from_jax(want["params"][0])
    jgrads = convert.parseq_from_jax(want["grads"])
    scale = max(float(g.abs().max()) for g in jgrads.values())
    lr0 = str_train.onecycle_cosine_schedule(steps, lr, warmup)(0)
    undecided = 0
    for k, g in jgrads.items():
        got, g = rec["params"][0][k], g.abs()
        decided = ((g > 1e-3 * float(g.max())) & (g > 1e-6 * scale)) | (g == 0)
        U.assert_close(got[decided], first[k][decided].numpy(), 1e-4, 1e-6, k)
        assert bool(((got - start[k])[~decided].abs() <= lr0 * (1 + 1e-3)).all()), k
        assert not torch.equal(got, start[k]), f"{k} did not move"
        undecided += int((~decided).sum())
    # a tiny random model's gradients have a long low tail (and the key
    # biases, zero in exact arithmetic): the undecided stay under 2 %
    assert undecided < 0.02 * sum(g.numel() for g in jgrads.values()), undecided

    # SWA over steps 2-3: the mean of the snapshots, near JAX's average
    assert (res.swa_n, res.swa_from) == (2, 1)
    assert logs[-1] == "swa: averaged 2 snapshots from step 2"
    jswa = convert.parseq_from_jax(want["swa"])
    bound = 2 * sum(str_train.onecycle_cosine_schedule(steps, lr, warmup)(i) for i in range(3))
    for k, v in res.state_dict.items():
        mean = (rec["params"][1][k] + rec["params"][2][k]) / 2
        U.assert_close(v, mean.numpy(), 0, 1e-6, f"swa {k}")
        U.assert_close(v, jswa[k].numpy(), 0, bound, f"swa against JAX {k}")
        assert v.data_ptr() != model.state_dict()[k].data_ptr()
    path = str_train.save_checkpoint(res.state_dict, str(tmp_path), steps)
    loaded = create_model("parseq", path, device="cpu", **TINY)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, res.state_dict[k]), k


def test_str_train_cli_checkpoint_is_what_str_test_reads(data, tmp_path, capsys):
    """str_train's main at PARSeq-base width (2 steps of 2, SWA from step 2)
    saves a strhub-layout file that create_model loads strictly and that
    str_test --ckpt evaluates, writing its tables to <ckpt>.log.txt."""
    path = str_train.main(["--data_root", str(data / "lmdb"), "--steps", "2", "--batch", "2",
                           "--warmup_pct", "0.5", "--swa", "--swa_start_pct", "0.5",
                           "--ckpt_dir", str(tmp_path / "ck"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "swa: averaged 1 snapshots from step 2" in out and f"saved {path}" in out
    sd = torch.load(path, map_location="cpu")
    assert sd and all(k.startswith("model.") for k in sd)
    create_model("parseq", path, device="cpu")
    root = tmp_path / "bench"
    _write_lmdb(str(root / "IIIT5k"), _word_images(3, 5))
    str_test.main(["--data_root", str(root), "--ckpt", path, "--device", "cpu"])
    out = capsys.readouterr().out
    log = open(path + ".log.txt").read()
    assert "warning" not in out and "| IIIT5k" in log and "skipping SVT (no data)" in out
    assert out.endswith(log)


def _bench_root(root):
    for name, seed in (("IIIT5k", 1), ("SVT", 2), ("ArT", 3)):
        _write_folder(str(root / name), _word_images(5, seed))


def test_str_test_tables_and_log_match_jax(tmp_path, capsys):
    """One seeded ViTSTR strhub file read by both scripts' main at --new
    --cased --rotation 90: the same stdout and the same .log.txt. (The JAX
    script decodes a CTC reader as if it were EOS-first, so CRNN is held to
    strhub's CTC decode below instead.)"""
    _bench_root(tmp_path / "data")
    src = randomize_parameters(build_model("vitstr"), 11)
    path = str(tmp_path / "vitstr.pt")
    torch.save({f"model.{k}": v for k, v in src.state_dict().items()}, path)
    args = ["--data_root", str(tmp_path / "data"), "--model", "vitstr", "--ckpt", path, "--new",
            "--cased", "--rotation", "90", "--batch", "8"]
    load_jax_script("str_test").main(args)
    want_out, want_log = capsys.readouterr().out, open(path + ".log.txt").read()
    os.remove(path + ".log.txt")
    str_test.main(args + ["--device", "cpu"])
    got_out, got_log = capsys.readouterr().out, open(path + ".log.txt").read()
    assert got_out == want_out and got_log == want_log
    assert "| ArT" in got_out and "New set:" in got_out


def test_predictor_decodes_each_reader_as_strhub():
    """CTC (CRNN): repeats merged, blanks dropped, every frame scored;
    EOS-first (the others): ids up to the first 0, scored up to it."""
    from udifftext_tpu_torch.ocr import ParseqPredictor

    frames = [1, 1, 0, 1, 2, 2, 0, 3]
    logits = np.full((1, len(frames), 95), -4.0)
    logits[0, np.arange(len(frames)), frames] = np.linspace(1.0, 3.0, len(frames))
    p = np.exp(logits[0]) / np.exp(logits[0]).sum(-1, keepdims=True)
    top = p.max(-1)
    ctc = ParseqPredictor(build_model("crnn"))
    texts, conf = ctc.decode(logits)
    assert ctc.ctc and not ctc.takes_refine and texts == ["0012"]
    assert conf[0] == pytest.approx(float(np.prod(top)), rel=1e-12)
    eos = ParseqPredictor(PPQ.PARSeq(**TINY))
    texts, conf = eos.decode(logits)
    assert not eos.ctc and eos.takes_refine and texts == ["00"]
    assert conf[0] == pytest.approx(float(np.prod(top[:3])), rel=1e-12)


def test_str_test_reads_crnn_with_the_ctc_decode(tmp_path, capsys):
    """str_test --model crnn scores each crop's best path, repeats merged and
    blanks dropped, against the labels: its tables equal those of the
    decode written out here from the model's own logits."""
    import itertools

    from udifftext_tpu_torch.str_eval import evaluate_predictions

    _bench_root(tmp_path / "data")
    src = randomize_parameters(build_model("crnn"), 11)
    path = str(tmp_path / "crnn.pt")
    torch.save({f"model.{k}": v for k, v in src.state_dict().items()}, path)
    got = str_test.main(["--data_root", str(tmp_path / "data"), "--model", "crnn", "--ckpt",
                         path, "--device", "cpu", "--batch", "4"])
    charset = "0123456789abcdefghijklmnopqrstuvwxyz"
    assert set(got) == {"IIIT5k", "SVT"}
    with torch.no_grad():
        for name, r in got.items():
            items = str_test.load_folder(str(tmp_path / "data" / name), charset=charset)
            crops = torch.stack([str_test.load_crop(f(), (32, 128), CPU) for f, _ in items])
            logits = src.eval()((crops - 0.5) / 0.5).numpy()
            preds, confs = [], []
            for row in logits:
                best = [k for k, _ in itertools.groupby(row.argmax(-1).tolist()) if k != 0]
                preds.append("".join(PPQ.PARSEQ_CHARSET[k - 1] for k in best))
                p = np.exp(row - row.max(-1, keepdims=True))
                confs.append(float(np.prod((p / p.sum(-1, keepdims=True)).max(-1))))
            # the EOS-first decode reads these logits otherwise
            assert preds != PPQ.ParseqTokenizer().decode_ids(logits.argmax(-1))
            want = evaluate_predictions(preds, [g for _, g in items], confs, charset)
            assert (r.num_samples, r.correct, r.label_length) == (
                want.num_samples, want.correct, want.label_length)
            assert r.ned == pytest.approx(want.ned, abs=1e-12)
            assert r.confidence == pytest.approx(want.confidence, rel=1e-6)
    assert "| IIIT5k" in capsys.readouterr().out


@pytest.mark.parametrize("rotation", [90, 180, 270])
def test_rotation_matches_pillow(rotation):
    """load_crop's np.rot90 against Pillow's rotate(r, expand=True) then
    cv2's INTER_CUBIC, the JAX script's path."""
    img = np.random.RandomState(rotation).randint(0, 256, (21, 57, 3)).astype(np.uint8)
    rot = np.asarray(Image.fromarray(img).rotate(rotation, expand=True))
    np.testing.assert_array_equal(np.rot90(img, rotation // 90), rot)
    want = cv2.resize(rot.astype(np.float32) / 255.0, (128, 32), interpolation=cv2.INTER_CUBIC)
    U.assert_close(str_test.load_crop(img, (32, 128), CPU, rotation), want, 0, 1e-6, "rotated")
    with pytest.raises(ValueError):
        str_test.load_crop(img, (32, 128), CPU, 45)


def test_abinet_lm_acc_matches_jax(tmp_path, capsys, monkeypatch):
    """encode_labels equal; one seeded tiny ABINet's language model in both
    scripts' main gives the same tables (the JAX script pads its last batch
    to the full width, the port does not)."""
    jlm = load_jax_script("str_abinet_lm_acc")
    labels = ["ab1", "z", "hello", "", "x" * 25]
    for g, w in zip(str_abinet_lm_acc.encode_labels(labels), jlm.encode_labels(labels)):
        np.testing.assert_array_equal(g, w)
    for name, words in (("IIIT5k", ["cat", "dog42", "Sign", "x1y", "moon"]),
                        ("ArT", ["sign", "abc"])):
        _write_folder(str(tmp_path / name), [(np.zeros((8, 16, 3), np.uint8), w) for w in words])
    kw = dict(d_model=64, d_inner=128, v_num_layers=1, l_num_layers=1)
    net = randomize_parameters(ABINet(**kw), 13).eval()
    conv = ckpt_torch.convert_abinet({f"model.{k}": v.numpy()
                                      for k, v in net.state_dict().items()})
    from udifftext_tpu.models.abinet import BCNLanguage

    jmodel = BCNLanguage(max_length=26, num_classes=37, d_model=64, d_inner=128, num_layers=1)
    monkeypatch.setattr(jlm, "language_model_params",
                        lambda ckpt: (jmodel, {"params": conv["params"]["language"]}))
    monkeypatch.setattr(str_abinet_lm_acc, "language_model", lambda ckpt, device: net.language)
    args = ["--data_root", str(tmp_path), "--batch", "3", "--new"]
    jlm.main(args)
    want = capsys.readouterr().out
    str_abinet_lm_acc.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and "|         5 |" in got and "New set:" in got


# -- the host tools -----------------------------------------------------------


def _fx_art(root):
    with open(ospj(root, "train_task2_labels.json"), "w") as f:
        json.dump({"gt_1": [{"language": "Latin", "illegibility": False, "transcription": " s "}],
                   "gt_2": [{"language": "Chinese", "illegibility": False, "transcription": "x"}],
                   "gt_3": [{"language": "Latin", "illegibility": False,
                             "transcription": "LocaL#3"}],
                   "gt_4": [{"language": "Latin", "illegibility": False, "transcription": "a#b"}]},
                  f)


def _fx_case_sensitive(root):
    os.makedirs(ospj(root, "label"))
    for i, label in enumerate(["Cat ", "DoG"], start=1):
        save_jpeg(ospj(root, "IMG", f"{i}.jpg"), seed=i)
        with open(ospj(root, "label", f"{i}.txt"), "w") as f:
            f.write(label + "\n")


def _fx_coco_text(root):
    with open(ospj(root, "train_words_gt.txt"), "w") as f:
        f.write("1001,hello\nmalformed-line\n1002,|piped|\n")
    with open(ospj(root, "val_words_gt.txt"), "w") as f:
        f.write("2001,with,comma\n")


def _fx_mlt19(root):
    with open(ospj(root, "gt.txt"), "w") as f:
        f.write("a.jpg,Latin,word\nb.jpg,Arabic,word\nc.jpg,Symbols,!!,x\nd.jpg,Latin,\n")


def _fx_lsvt(root):
    save_jpeg(ospj(root, "train_full_images_0", "img0.jpg"), h=40, w=80, seed=1)
    save_jpeg(ospj(root, "train_full_images_1", "img1.jpg"), h=40, w=80, seed=2)
    pts = [[10, 5], [30, 5], [30, 20], [10, 20]]
    ann = {"img0": [{"transcription": "good", "illegibility": False, "points": pts},
                    {"transcription": "中文", "illegibility": False, "points": pts},
                    {"transcription": "Story #", "illegibility": False, "points": pts}],
           "img1": [{"transcription": "skip#this", "illegibility": False, "points": pts},
                    {"transcription": "ok ", "illegibility": False,
                     "points": [[4, 4], [24, 4], [24, 14], [4, 14]]}]}
    with open(ospj(root, "train_full_labels.json"), "w") as f:
        json.dump(ann, f)


def _fx_textocr(root):
    for split, seed in (("train", 3), ("val", 4)):
        save_jpeg(ospj(root, f"{split}_imgs", "i.jpg"), h=50, w=100, seed=seed)
        anns = [{"utf8_string": "word", "bbox": [10.2, 5.7, 19.5, 9.1],
                 "points": [10, 5, 30, 5, 30, 15, 10, 15]},
                {"utf8_string": ".", "bbox": [0, 0, 5, 5], "points": [0, 0, 5, 0, 5, 5, 0, 5]},
                {"utf8_string": "tall", "bbox": [20, 10, 8, 24],
                 "points": [20, 10, 28, 10, 28, 34, 20, 34]}]
        with open(ospj(root, f"TextOCR_0.1_{split}.json"), "w") as f:
            json.dump({"imgs": {"i1": {"id": "i1", "file_name": f"{split}_imgs/i.jpg"}},
                       "imgToAnns": {"i1": [f"a{k}" for k in range(len(anns))]},
                       "anns": {f"a{k}": a for k, a in enumerate(anns)}}, f)


def _fx_coco2(root):
    save_jpeg(ospj(root, "train2014", "c0.jpg"), h=30, w=60, seed=5)
    save_jpeg(ospj(root, "train2014", "c1.jpg"), h=30, w=60, seed=6)
    base = {"class": "machine printed", "language": "english", "legibility": "legible"}
    anns = {"1": dict(base, utf8_string="A&amp;W", bbox=[4, 4, 10, 8]),
            "2": dict(base, utf8_string="hand", bbox=[0, 0, 5, 5], **{"class": "handwritten"}),
            "3": dict(base, utf8_string="par#tial", bbox=[0, 0, 5, 5]),
            "4": dict(base, utf8_string="*bad", bbox=[0, 0, 5, 5]),
            "5": dict(base, utf8_string="edge", bbox=[55, 25, 10, 10])}
    with open(ospj(root, "cocotext.v2.json"), "w") as f:
        json.dump({"imgs": {"10": {"id": 10, "set": "train", "file_name": "c0.jpg"},
                            "11": {"id": 11, "set": "val", "file_name": "c1.jpg"}},
                   "imgToAnns": {"10": [1, 2, 3, 4, 5], "11": [1]}, "anns": anns}, f)


def _fx_openvino(root):
    save_jpeg(ospj(root, "o0.jpg"), h=40, w=40, seed=6)
    data = {"images": [{"id": 7, "file_name": "o0.jpg"}],
            "annotations": [
                {"image_id": 7, "bbox": [2, 2, 10, 10], "attributes": {
                    "legible": True, "language": "english", "transcription": "sign"}},
                {"image_id": 7, "bbox": [0, 0, 5, 5], "attributes": {
                    "legible": False, "language": "english", "transcription": "x"}}]}
    for shard in ("train_1", "validation"):
        with open(ospj(root, f"text_spotting_openimages_v5_{shard}.json"), "w") as f:
            json.dump(data, f)


CONVERTERS = {"art": _fx_art, "case-sensitive": _fx_case_sensitive, "coco-text": _fx_coco_text,
              "mlt19": _fx_mlt19, "lsvt": _fx_lsvt, "textocr": _fx_textocr, "coco2": _fx_coco2,
              "openvino": _fx_openvino}


def _same_tree(a, b):
    """Every file under a and b by relative path, byte for byte."""
    def files(root):
        return sorted(os.path.relpath(ospj(d, f), root) for d, _, fs in os.walk(root) for f in fs)

    assert files(a) == files(b)
    for rel in files(a):
        assert filecmp.cmp(ospj(a, rel), ospj(b, rel), shallow=False), rel
    return files(a)


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_converters_write_the_jax_bytes(name, tmp_path, capsys):
    """Each converter's subcommand through main on a copy of one fixture:
    the same files, crops included, and the same stdout."""
    fixture = str(tmp_path / "fixture")
    os.makedirs(fixture)
    CONVERTERS[name](fixture)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(fixture, jax_dir)
    shutil.copytree(fixture, port_dir)
    flags = ["--rectify_pose"] if name == "textocr" else []
    load_jax_script("str_convert_datasets").main([name, jax_dir] + flags)
    want = capsys.readouterr().out.replace(jax_dir, "<root>")
    str_convert_datasets.main([name, port_dir] + flags)
    got = capsys.readouterr().out.replace(port_dir, "<root>")
    assert got == want and got.endswith("Finish\n")
    assert len(_same_tree(jax_dir, port_dir)) > len(os.listdir(fixture))


def test_create_and_filter_lmdb_write_the_jax_bytes(tmp_path, capsys):
    """str_create_lmdb (a gt file with a missing and an invalid image) then
    str_filter_lmdb over it and a second LMDB (images under 8 pixels
    dropped, renumbered): the same data.mdb bytes and the same report."""
    src = tmp_path / "src"
    src.mkdir()
    rows = []
    for i, (h, w) in enumerate([(20, 40), (6, 30), (30, 5), (16, 16)]):
        save_jpeg(str(src / f"{i}.jpg"), h=h, w=w, seed=i)
        rows.append(f"{i}.jpg word{i}")
    (src / "bad.jpg").write_bytes(b"not an image")
    (src / "gt.txt").write_text("\n".join(rows + ["bad.jpg x", "missing.jpg y", "lonely"]) + "\n")
    jcreate, jfilter = load_jax_script("str_create_lmdb"), load_jax_script("str_filter_lmdb")
    other = str(tmp_path / "other")
    write_lmdb(other, {b"num-samples": b"2", b"image-000000001": encode_png(
        np.zeros((9, 9, 3), np.uint8)), b"label-000000001": b"nine",
        b"image-000000002": encode_png(np.zeros((9, 7, 3), np.uint8)),
        b"label-000000002": b"seven"})
    outs = {}
    for side, create, filt in (("jax", jcreate.create_lmdb, jfilter.filter_lmdb),
                               ("port", str_create_lmdb.create_lmdb, str_filter_lmdb.filter_lmdb)):
        created, filtered = str(tmp_path / f"{side}_c"), str(tmp_path / f"{side}_f")
        assert create(str(src), str(src / "gt.txt"), created) == 4
        assert filt([created, other], filtered, 8) == 3
        outs[side] = capsys.readouterr().out.replace(created, "<c>").replace(filtered, "<f>")
    assert outs["port"] == outs["jax"]
    for sub in ("c", "f"):
        _same_tree(str(tmp_path / f"jax_{sub}"), str(tmp_path / f"port_{sub}"))
    str_create_lmdb.main(["--input", str(src), "--gt_file", str(src / "gt.txt"), "--output",
                          str(tmp_path / "cli")])
    _same_tree(str(tmp_path / "cli"), str(tmp_path / "jax_c"))


def test_preprocess_laion_ocr_writes_the_jax_files(tmp_path, capsys):
    src = tmp_path / "src"
    for i in range(5):
        d = src / f"sample{i}"
        d.mkdir(parents=True)
        if i != 2:  # one incomplete sample is skipped
            save_jpeg(str(d / "image.jpg"), seed=i)
        (d / "ocr.txt").write_text(f"w{i} 0,0,1,0,1,1,0,1 0.9\n")
        np.save(d / "charseg.npy", np.full((4, 4), i, np.uint8))
    (src / "stray.txt").write_text("not a sample")
    jax_mod = load_jax_script("preprocess_laion_ocr")
    jax_mod.relayout(src, tmp_path / "jax", 0.3)
    preprocess_laion_ocr.main(["--src", str(src), "--dst", str(tmp_path / "port"),
                               "--val-frac", "0.3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == str({"val": 1, "train": 3})
    assert len(_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))) == 12


# -- the tuner, the reader, the benchmark, and the device ---------------------


def test_str_tune_picks_the_jax_lr(data, jax_side, capsys):
    """Three lrs, two steps of 8 each from the same weights: the final
    losses within 1e-3 of a JAX sweep as scripts/str_tune.py:56-80 composes
    it (adamw at a constant lr, no clip, default permutations), and the same
    pick."""
    jtest, params, value_and_grad = jax_side
    lrs = np.exp(np.linspace(np.log(1e-4), np.log(3e-2), 3))
    jitems = jtest.load_folder(str(data / "folder"))
    tok = JPQ.ParseqTokenizer()
    want = []
    for lr in lrs:
        opt = optax.adamw(float(lr))
        p, state, rng = params, opt.init(params), np.random.default_rng(0)
        for _ in range(2):
            images, labels = _jax_batch(jitems, rng.choice(len(jitems), 8))
            ids = tok.encode(labels)
            cms, qms = JPQ.perm_attn_masks(JPQ.gen_tgt_perms(rng, ids.shape[1] - 2))
            loss, grads = value_and_grad(p, jnp.asarray(images), jnp.asarray(ids),
                                         jnp.asarray(cms), jnp.asarray(qms))
            updates, state = opt.update(grads, state, p)
            p = optax.apply_updates(p, updates)
        want.append((float(loss), lr))
    model = U.load_port(PPQ.PARSeq(**TINY), convert.parseq_from_jax(params))
    got = str_tune.sweep(str_test.load_folder(str(data / "folder")), model, CPU, lrs, 2, 8)
    U.assert_close([g[0] for g in got], [w[0] for w in want], 1e-3, 0, "final losses")
    assert min(got)[1] == min(want)[1]
    assert capsys.readouterr().out.count("final loss") == 3


def test_str_read_and_str_bench_on_the_cpu(data, tmp_path, capsys, monkeypatch):
    """str_read at PARSeq-base width reads two files with one seeded
    checkpoint as ParseqPredictor.img2txt_ragged does; str_bench reports
    the parameters, the FLOPs flop_counter counts and what its timer
    measured (here one host-clock call) on the CPU."""
    src = randomize_parameters(build_model("parseq"), 4)
    path = str(tmp_path / "parseq.pt")
    torch.save({f"model.{k}": v for k, v in src.state_dict().items()}, path)
    files = [str(data / "folder" / "w0.png"), str(data / "folder" / "w1.png")]
    texts = str_read.main(files + ["--ckpt", path, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out == [f"{f}: {t!r}" for f, t in zip(files, texts)]
    from udifftext_tpu_torch.ocr import ParseqPredictor

    crops = [str_test.read_image_file(f).astype(np.float32) / 255.0 for f in files]
    assert ParseqPredictor(create_model("parseq", path, device="cpu")).img2txt_ragged(
        crops) == texts
    calls = []

    def one_call(fn, reps, runs, device):
        calls.append((reps, runs, device))
        fn()
        return 12.5

    monkeypatch.setattr(str_bench, "time_ms", one_call)
    r = str_bench.main(["crnn", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert calls == [(10, 5, CPU)] and r["ms"] == 12.5 and r["images_per_s"] == 160.0
    assert "CPU, host clock" in out and "12.500 ms" in out
    assert r["gflops"] > 1 and r["gflops"] == pytest.approx(
        2 * str_bench.bench("crnn", 1, CPU)["gflops"], rel=1e-9)  # linear in the batch
    assert r["params_m"] == pytest.approx(sum(p.numel() for p in build_model("crnn")
                                              .parameters()) / 1e6)


ENTRY_POINTS = {
    "str_train": (str_train, ["--data_root", "."]),
    "str_tune": (str_tune, ["--data_root", "."]),
    "str_test": (str_test, ["--data_root", "."]),
    "str_read": (str_read, ["x.png"]),
    "str_bench": (str_bench, ["parseq"]),
    "str_abinet_lm_acc": (str_abinet_lm_acc, ["--data_root", "."]),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_device_entry_points_refuse_without_a_gpu(name, monkeypatch, tmp_path):
    """With no GPU, each tool that touches a model stops before any work
    unless --device cpu asks for the CPU; the host tools take no --device."""
    mod, argv = ENTRY_POINTS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match=f"{name}: no CUDA device found"):
        mod.main(argv)
    with pytest.raises(SystemExit):
        str_create_lmdb.main(["--input", ".", "--output", "o", "--device", "cpu"])


def test_tools_run_as_modules_and_host_tools_touch_no_device():
    """Each tool has a main and runs under `python -m`; the host tools'
    sources name no torch device."""
    import subprocess

    names = [m.__name__.rsplit(".", 1)[1] for m in (
        str_train, str_tune, str_test, str_read, str_bench, str_abinet_lm_acc, str_create_lmdb,
        str_filter_lmdb, str_convert_datasets, preprocess_laion_ocr)]
    for name in names:
        mod = sys.modules[f"udifftext_tpu_torch.scripts.{name}"]
        assert callable(mod.main), name
    for mod in (str_create_lmdb, str_filter_lmdb, str_convert_datasets, preprocess_laion_ocr):
        src = open(mod.__file__).read()
        assert "import torch" not in src and "--device" not in src, mod.__name__
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-m", "udifftext_tpu_torch.scripts.str_bench", "--help"],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0 and "--device" in res.stdout, res.stderr[-2000:]
