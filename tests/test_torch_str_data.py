"""The STR data path on the port (`data/lmdb.py`, `data/lmdb_native.py`
with its own `native/lmdb_reader.cpp`, `utils/png.decode_png`,
`data/str_augment.py`) and the STR trainer's arithmetic
(`parallel/train.py`: the one-cycle schedule, the global-norm clip, AdamW,
SWA) against the JAX package on the CPU.

LMDB files written by either package's writer are byte-identical and read
back the same through either package's readers, the native one included;
`STRAugment` equals JAX's bit for bit at the same seed. The schedule equals
optax's `cosine_onecycle_schedule` at every step of a 1000-step run (1e-12
relative with 64-bit JAX; optax's default float32 within 1e-6 of the
peak); the clip
and one AdamW update on identical gradients within 1e-6 of the optax
chain; `swa_update` within 1e-7 of JAX's.
"""

import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import torch_port_util as U  # noqa: F401  (one intra-op thread)
from udifftext_tpu.data import lmdb as JL
from udifftext_tpu.data import str_augment as JA
from udifftext_tpu.parallel import train as JT
from udifftext_tpu_torch.data import lmdb as PL
from udifftext_tpu_torch.data import lmdb_native as PN
from udifftext_tpu_torch.data import str_augment as PA
from udifftext_tpu_torch.parallel import train as PT
from udifftext_tpu_torch.utils import png


def _cases():
    """tests/test_lmdb.py's three tree shapes: one leaf, overflow values, and
    3000 random keys over branch pages."""
    rng = np.random.RandomState(0)
    big = bytes(range(256)) * 64
    return {
        "small": {f"key-{i:04d}".encode(): f"value {i}".encode() for i in range(500)},
        "overflow": {b"small": b"x", b"big": big, b"big2": big[::-1]},
        "tree": {bytes(rng.randint(97, 123, 24).astype(np.uint8)):
                 bytes(rng.randint(0, 256, 100).astype(np.uint8)) for _ in range(3000)},
    }


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
def test_lmdb_files_cross_read(case, tmp_path):
    """Both writers give the same bytes; every reader of either package
    (the port's native one too) returns every value, None for a missing
    key, and the same in-order scan."""
    items = CASES[case]
    p, j = str(tmp_path / "port"), str(tmp_path / "jax")
    PL.write_lmdb(p, items)
    JL.write_lmdb(j, items)
    assert (tmp_path / "port" / "data.mdb").read_bytes() == \
        (tmp_path / "jax" / "data.mdb").read_bytes()
    assert (tmp_path / "port" / "lock.mdb").exists()
    keys = sorted(items)
    for path in (p, j):
        readers = [PL.LMDBReader(path), JL.LMDBReader(path), PN.NativeLMDBReader(path)]
        for db in readers:
            assert len(db) == len(items)
            for k in (keys[0], keys[len(keys) // 2], keys[-1]):
                assert db.get(k) == items[k]
            assert db.get(b"\x00missing") is None and db.get(b"\xffmissing") is None
            assert list(db.items()) == sorted(items.items())
            db.close()


@pytest.mark.parametrize("case", list(CASES))
def test_native_reader_matches_python_reader(case, tmp_path):
    """The port's C++ reader builds here (g++) into the port's _build/ and
    returns, key by key, the bytes the Python reader returns."""
    assert PN.available(), PN.build_error()
    assert PN.library_path().parent.name == "_build"
    d = str(tmp_path / "db")
    items = CASES[case]
    PL.write_lmdb(d, items)
    with PL.LMDBReader(d) as py, PN.NativeLMDBReader(d) as cc:
        assert len(cc) == len(py) == len(items)
        for k in items:
            assert cc.get(k) == py.get(k) == items[k]
        assert list(cc.items()) == list(py.items())


def test_open_lmdb_backend_selection(tmp_path, monkeypatch):
    """As the JAX package: native by default where it builds, UDIFFTEXT_LMDB=py
    forces Python; when the build fails the default falls back to Python
    and UDIFFTEXT_LMDB=native raises."""
    d = str(tmp_path / "db")
    PL.write_lmdb(d, {b"num-samples": b"0", b"k": b"v"})
    for env, want in (("py", PL.LMDBReader), ("", PN.NativeLMDBReader),
                      ("native", PN.NativeLMDBReader)):
        monkeypatch.setenv("UDIFFTEXT_LMDB", env)
        with PL.open_lmdb(d) as db:
            assert isinstance(db, want) and db.get(b"k") == b"v"
        with JL.open_lmdb(d) as jdb:
            assert type(jdb).__name__ == want.__name__
    monkeypatch.setattr(PN, "_lib", None)
    monkeypatch.setattr(PN, "_build_error", "g++: not found")
    monkeypatch.setenv("UDIFFTEXT_LMDB", "")
    with PL.open_lmdb(d) as db:
        assert isinstance(db, PL.LMDBReader)
    monkeypatch.setenv("UDIFFTEXT_LMDB", "native")
    with pytest.raises(RuntimeError, match="g\\+\\+: not found"):
        PL.open_lmdb(d)


def _str_lmdb(path, labels, fmt="PNG"):
    items = {b"num-samples": str(len(labels)).encode()}
    for i, label in enumerate(labels, start=1):
        rs = np.random.RandomState(i)
        arr = rs.randint(0, 256, (rs.randint(16, 40), rs.randint(30, 90), 3)).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format=fmt)
        items[b"image-%09d" % i] = buf.getvalue()
        items[b"label-%09d" % i] = label.encode()
    PL.write_lmdb(str(path), items)


@pytest.mark.parametrize("charset", [None, "0123456789abcdefghijklmnopqrstuvwxyz", "cat"],
                         ids=["no_adapter", "lowercase", "cat"])
def test_lmdb_str_dataset_labels_and_images_match_jax(charset, tmp_path):
    """strhub's label preprocessing (whitespace, NFKD→ascii, the length
    filter before the adapter, empty labels dropped) gives the JAX
    dataset's labels and indices; images decode to JAX's RGB pixels."""
    labels = ["cat", "Dog 7", "toolongtoolongtoolongtoolong", "café", "!!!", "C a T", "x" * 25]
    _str_lmdb(tmp_path / "set", labels)
    got = PL.LmdbStrDataset(str(tmp_path / "set"), charset=charset)
    want = JL.LmdbStrDataset(str(tmp_path / "set"), charset=charset)
    assert got.labels == want.labels and got.filtered == want.filtered
    assert len(got) == len(want) > 0
    for i in range(len(got)):
        img, label = got[i]
        jimg, jlabel = want[i]
        assert label == jlabel and img.dtype == np.uint8
        np.testing.assert_array_equal(img, np.asarray(jimg))
    got.close()


def test_decode_png_and_decoding_without_pillow(tmp_path, monkeypatch):
    """decode_png round-trips encode_png; without Pillow, decode_image reads
    encode_png's PNGs (greyscale as RGB, as Pillow's convert does) and
    refuses a JPEG or a Pillow-filtered PNG with an error naming Pillow."""
    rs = np.random.RandomState(3)
    rgb = rs.randint(0, 256, (13, 29, 3)).astype(np.uint8)
    grey = rs.randint(0, 256, (7, 11)).astype(np.uint8)
    for arr in (rgb, grey):
        np.testing.assert_array_equal(png.decode_png(png.encode_png(arr)), arr)
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"\xff\xd8 not a png")
    good = png.encode_png(rgb)
    with pytest.raises(ValueError, match="truncated"):
        png.decode_png(good[:40])
    with_pil = [PL.decode_image(png.encode_png(a)) for a in (rgb, grey)]
    jpeg, pil_png = io.BytesIO(), io.BytesIO()
    Image.fromarray(rgb).save(jpeg, format="JPEG")
    Image.fromarray(rgb).save(pil_png, format="PNG")
    assert PL.decode_image(jpeg.getvalue()).shape == (13, 29, 3)
    monkeypatch.setitem(sys.modules, "PIL", None)  # `from PIL import Image` raises ImportError
    with pytest.raises(ImportError):
        from PIL import Image as _  # noqa: F401
    for arr, want in zip((rgb, grey), with_pil):
        got = PL.decode_image(png.encode_png(arr))
        np.testing.assert_array_equal(got, want)
        assert got.shape == arr.shape[:2] + (3,)
    for data in (jpeg.getvalue(), pil_png.getvalue()):
        with pytest.raises(RuntimeError, match="Pillow"):
            PL.decode_image(data)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_str_augment_bit_identical_to_jax(seed):
    img = (np.random.RandomState(seed).rand(32, 100, 3) * 255).astype(np.uint8)
    for n_ops, mag in ((3, 0.5), (11, 1.0)):
        got = PA.STRAugment(n_ops, mag, seed=seed)
        want = JA.STRAugment(n_ops, mag, seed=seed)
        for x in (img, img.astype(np.float32) / 255.0):
            a, b = got(x), want(x)
            assert a.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("steps, pct", [(1000, 0.075), (40, 0.075), (7, 0.3)])
def test_onecycle_schedule_equals_optax(steps, pct):
    """optax.cosine_onecycle_schedule at every step (and past the end):
    1e-12 relative to optax in 64 bits; within 1e-6 of the peak of its
    float32 default (whose cosine rounds in float32)."""
    sched = PT.onecycle_cosine_schedule(steps, 7e-4, pct_start=pct)
    got = np.array([sched(i) for i in range(steps + 3)])
    want32 = np.array([float(optax.cosine_onecycle_schedule(steps, 7e-4, pct)(i))
                       for i in range(steps + 3)])
    with jax.enable_x64(True):
        s64 = optax.cosine_onecycle_schedule(steps, 7e-4, pct)
        want64 = np.array([float(s64(i)) for i in range(steps + 3)])
    np.testing.assert_allclose(got, want64, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got, want32, rtol=0, atol=1e-6 * 7e-4)
    assert int(np.argmax(got)) == int(pct * steps) and got[int(pct * steps)] == 7e-4
    if steps == 1000:
        assert abs(got[999] - 4.82e-9) < 0.01e-9 and got[0] == pytest.approx(7e-4 / 25, 1e-12)


def test_onecycle_schedule_without_warmup_starts_at_the_peak():
    """int(pct·T) = 0: optax gives NaN there; the port starts at the peak."""
    sched = PT.onecycle_cosine_schedule(3, 1e-3, pct_start=0.075)
    with np.errstate(invalid="ignore"):
        assert np.isnan(float(optax.cosine_onecycle_schedule(3, 1e-3, 0.075)(0)))
    assert sched(0) == 1e-3 and sched(1) < 1e-3 and sched(3) == 1e-3 / 25 / 1e4
    with pytest.raises(ValueError):
        PT.onecycle_cosine_schedule(0, 1e-3)


@pytest.mark.parametrize("grad_scale", [100.0, 0.01], ids=["clipped", "unclipped"])
def test_clip_and_adamw_step_match_optax(grad_scale):
    """clip_by_global_norm(20) then adamw(lr) from optax, against
    clip_grad_global_norm_ and make_str_optimizer on the same parameters and
    gradients: the norm, the clipped gradients and two updates within 1e-6."""
    rs = np.random.RandomState(5)
    shapes = {"w": (16, 8), "b": (8,), "e": (3, 4, 5)}
    params = {k: rs.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (grad_scale * rs.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    opt = optax.chain(optax.clip_by_global_norm(20.0), optax.adamw(3e-3))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = PT.make_str_optimizer(tp.values(), 3e-3)
    assert topt.defaults["weight_decay"] == 1e-4
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        upd, state = opt.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = PT.clip_grad_global_norm_([p.grad for p in tp.values()], 20.0)
        U.assert_close(norm, optax.global_norm(jg), 1e-6, 0, "global norm")
        clipped, _ = optax.clip_by_global_norm(20.0).update(jg, None)
        for k, p in tp.items():
            U.assert_close(p.grad, clipped[k], 1e-6, 1e-7, f"clipped {k}")
        topt.step()
        for k, p in tp.items():
            U.assert_close(p, jp[k], 0, 1e-6, f"AdamW {k}")
    assert (float(norm) > 20.0) == (grad_scale > 1)


def test_swa_update_matches_jax():
    """Four snapshots averaged: swa_start's copy then three swa_update calls
    within 1e-7 of JAX's swa_update (the JAX trainer's float32 count), the
    mean of the snapshots, and no aliasing of the live parameters."""
    rs = np.random.RandomState(7)
    snaps = [{"a": rs.standard_normal((5, 3)).astype(np.float32),
              "b": rs.standard_normal((4,)).astype(np.float32)} for _ in range(4)]
    live = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in snaps[0].items()}
    avg = PT.swa_start(live)
    javg = {k: jnp.asarray(v) for k, v in snaps[0].items()}
    for n, s in enumerate(snaps[1:], start=1):
        with torch.no_grad():
            for k, p in live.items():
                p.copy_(torch.from_numpy(s[k]))
        PT.swa_update(avg, live, n)
        javg = JT.swa_update(javg, {k: jnp.asarray(v) for k, v in s.items()},
                             jnp.asarray(n, jnp.float32))
    for k in avg:
        U.assert_close(avg[k], javg[k], 0, 1e-7, k)
        U.assert_close(avg[k], np.mean([s[k] for s in snaps], axis=0), 0, 1e-6, k)
        assert avg[k].data_ptr() != live[k].data_ptr()
