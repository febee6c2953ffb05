"""The port's OCR path (udifftext_tpu_torch/models/{vit,parseq}.py, ocr.py)
against the JAX package on the CPU, fp32, at a tiny width (dim 64, encoder
depth 2; the decoder layer and the 32×128 geometry as shipped), on seeded
weights converted with `utils/convert.py`.

Tolerances: the tokenizer, the crop resampler's arithmetic and the weight
conversions are exact; the ViT encoder and the teacher-forced logits 1e-5
of the output's magnitude (fp32 summation order); the full read (26 greedy
steps and the refinement) 1e-4, its greedy ids equal wherever the top two
logits are more than 1e-3 apart; `crop_resize_bbox` 1e-5; `calc_loss` and
its gradient with respect to the images 1e-4; the port's bicubic resize
against `cv2.resize(INTER_CUBIC)` 1e-6 absolute on [0, 1] images (a few
fp32 roundings: cv2 sums the four taps in another order).
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from udifftext_tpu import ocr as JO
from udifftext_tpu.models import parseq as JPQ
from udifftext_tpu.models.vit import ViTEncoder as JViT
from udifftext_tpu.utils import ckpt_torch
from udifftext_tpu_torch import ocr as PO
from udifftext_tpu_torch.models import parseq as PPQ
from udifftext_tpu_torch.models.vit import ViTEncoder as PViT
from udifftext_tpu_torch.utils import convert

REPO = Path(__file__).resolve().parent.parent
T = torch.from_numpy
TINY = dict(embed_dim=64, enc_depth=2, enc_num_heads=2, dec_num_heads=4)
TOK = JPQ.ParseqTokenizer()


def parseq_params(module, seed: int, eos_bias: float = 0.0, char_bias=None):
    """Seeded PARSeq params of a realistic scale: dense and packed in-proj
    kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), biases N(0, 0.05²),
    position tables N(0, 0.02²), embeddings N(0, 1). `eos_bias` and
    `char_bias` ({char: offset}) shift the head's bias so that the greedy
    read ends early or favors a character."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 128, 3)))
    rs = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        r = rs.standard_normal(s.shape).astype(np.float32)
        if name in ("kernel", "in_proj_kernel"):
            return r / math.sqrt(max(1, int(np.prod(s.shape[:-1]))))
        if name == "scale":
            return 1.0 + 0.1 * r
        if name in ("bias", "in_proj_bias"):
            return 0.05 * r
        if name in ("pos_embed", "pos_queries"):
            return 0.02 * r
        return r

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    bias = params["params"]["head"]["Dense_0"]["bias"]
    bias[TOK.eos_id] += eos_bias
    for ch, off in (char_bias or {}).items():
        bias[TOK.stoi[ch]] += off
    return params


def port_parseq(params, **kw) -> PPQ.PARSeq:
    return U.load_port(PPQ.PARSeq(**kw), convert.parseq_from_jax(params))


@pytest.fixture(scope="module")
def tiny():
    jm = JPQ.PARSeq(**TINY)
    params = parseq_params(jm, 3, eos_bias=1.0)
    return jm, params, port_parseq(params, **TINY)


def _crops(b: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).uniform(-1, 1, (b, 32, 128, 3)).astype(np.float32)


def _close_to_scale(got, want, rtol: float, what: str) -> None:
    """|got − want| <= rtol · max|want| everywhere."""
    U.assert_close(got, want, 0.0, rtol * float(np.abs(np.asarray(want)).max()), what)


# --- the tokenizer -----------------------------------------------------------


@pytest.mark.parametrize("labels", [["abc", "HELLO", "a1!?"], ["", "x" * 30, "é-ok ~"]])
def test_tokenizer_encode_decode_exact(labels):
    want = TOK.encode(labels)
    got = PPQ.ParseqTokenizer().encode(labels)
    assert got.dtype == want.dtype == np.int32 and got.shape == (len(labels), 27)
    np.testing.assert_array_equal(got, want)
    assert PPQ.ParseqTokenizer().itos == TOK.itos and PPQ.PARSEQ_CHARSET == JPQ.PARSEQ_CHARSET
    ids = np.random.RandomState(0).randint(0, 97, (6, 26))
    ids[:, 4] = 0
    assert PPQ.ParseqTokenizer().decode_ids(ids) == TOK.decode_ids(ids)
    assert PPQ.ParseqTokenizer().decode_ids(torch.from_numpy(ids)) == TOK.decode_ids(ids)


# --- the model ---------------------------------------------------------------


def test_vit_encoder_matches_jax():
    jm = JViT(embed_dim=64, depth=2, num_heads=2)
    params = U.flax_params(jm, 5, jnp.zeros((1, 32, 128, 3)))
    pm = U.load_port(PViT(embed_dim=64, depth=2, num_heads=2),
                     convert.vit_from_jax(jax.tree.map(np.asarray, params)))
    x = _crops(3, 1)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = pm(T(x))
    assert got.shape == (3, 128, 64)
    _close_to_scale(got, want, 1e-5, "vit")


def test_forward_logits_matches_jax(tiny):
    jm, params, pm = tiny
    x = _crops(3, 2)
    tgt = np.random.RandomState(2).randint(0, 97, (3, 12))
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(tgt),
                               method=JPQ.PARSeq.forward_logits))
    got = pm.forward_logits(T(x), T(tgt))
    assert got.shape == (3, 12, 95) and got.dtype == torch.float32
    _close_to_scale(got, want, 1e-5, "forward_logits")


@pytest.mark.parametrize("refine_iters", [1, 0])
def test_full_read_matches_jax(tiny, refine_iters):
    """The fixed-context AR read plus the cloze refinement (or the AR read
    alone): logits at 1e-4; greedy ids equal wherever the top-2 gap exceeds
    1e-3. The EOS bias makes some reads end early, so the padding mask
    from the first EOS is exercised."""
    jm, params, pm = tiny
    x = _crops(6, 3)
    want = np.asarray(jm.apply(params, jnp.asarray(x), refine_iters))
    got = pm(T(x), refine_iters)
    assert got.shape == (6, 26, 95) and got.dtype == torch.float32
    _close_to_scale(got, want, 1e-4, "full read")
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-3
    ids = got.argmax(-1).numpy()
    np.testing.assert_array_equal(ids[clear], want.argmax(-1)[clear])
    eos_first = (want.argmax(-1) == 0).argmax(-1)
    assert ((want.argmax(-1) == 0).any(-1)).sum() >= 2 and len(set(eos_first.tolist())) > 1


def test_full_read_grad_mode_does_not_change_logits(tiny):
    """With a refinement the AR steps run without autograd: the logits are
    the same with gradients on and off, and the gradient reaches the images."""
    _, _, pm = tiny
    x = T(_crops(2, 4)).requires_grad_(True)
    with torch.no_grad():
        ref = pm(x)
    out = pm(x)
    assert torch.equal(out.detach(), ref)
    out.square().sum().backward()
    assert x.grad is not None and float(x.grad.abs().sum()) > 0


# --- the resamplers ------------------------------------------------------------

# (top, bottom, left, right) in a 96×320 image: each bbox downscales along
# both axes to 32×128 (the antialias widening binds), upscales along both,
# or one of each
BBOXES = {
    "down": [[0, 96, 0, 320], [4, 90, 10, 300]],
    "up": [[10, 20, 5, 40], [30, 31, 50, 52]],
    "mixed": [[3, 80, 10, 90], [20, 24, 0, 320]],
}


@pytest.mark.parametrize("kind", sorted(BBOXES))
def test_crop_resize_bbox_matches_scale_and_translate(kind):
    img = np.random.RandomState(5).uniform(-1.5, 1.5, (2, 96, 320, 3)).astype(np.float32)
    bb = np.asarray(BBOXES[kind], np.int32)
    want = np.asarray(jax.vmap(lambda im, b: JO.crop_resize_bbox(im, b, (32, 128)))(
        jnp.asarray(img), jnp.asarray(bb)))
    got = PO.crop_resize_bbox(T(img), T(bb), (32, 128))
    assert got.shape == (2, 32, 128, 3)
    U.assert_close(got, want, 1e-5, 1e-5, f"crop_resize_bbox {kind}")


@pytest.mark.parametrize("shape", [(20, 50, 3), (100, 300, 3), (32, 128, 3), (7, 9, 3),
                                   (64, 500, 3)])
def test_bicubic_resize_matches_cv2(shape):
    im = np.random.RandomState(sum(shape)).uniform(0, 1, shape).astype(np.float32)
    want = cv2.resize(im, (128, 32), interpolation=cv2.INTER_CUBIC)
    got = PO.bicubic_resize(T(im), (32, 128))
    U.assert_close(got, want, 0.0, 1e-6, f"bicubic {shape}")


# --- the predictor -----------------------------------------------------------


def test_img2txt_and_ragged_match_jax(tiny):
    jm, params, pm = tiny
    jp, pp = JO.ParseqPredictor(model=jm), PO.ParseqPredictor(pm)
    rs = np.random.RandomState(6)
    crops = rs.uniform(0, 1, (4, 32, 128, 3)).astype(np.float32)
    assert pp.img2txt(T(crops)) == jp.img2txt(params, jnp.asarray(crops))
    ragged = [rs.uniform(0, 1, s).astype(np.float32) for s in ((20, 70, 3), (48, 300, 3),
                                                                (32, 128, 3))]
    assert pp.img2txt_ragged(ragged) == jp.img2txt_ragged(params, ragged)


def test_calc_loss_and_image_grad_match_jax():
    """Value and d(sum of the loss)/d(images) against jax.grad at 1e-4. The
    head favors 'a', so the first sample ("aaa") scores below the 1.0 clamp
    and carries a gradient, the second ("xyz!") is clamped."""
    jm = JPQ.PARSeq(**TINY)
    params = parseq_params(jm, 7, char_bias={"a": 6.0})
    pp = PO.ParseqPredictor(port_parseq(params, **TINY))
    jp = JO.ParseqPredictor(model=jm)
    rs = np.random.RandomState(8)
    images = rs.uniform(-1.2, 1.2, (2, 64, 64, 3)).astype(np.float32)
    bbox = np.array([[10, 30, 4, 60], [0, 64, 20, 28]], np.int32)
    labels = TOK.encode(["aaa", "xyz!"])

    def jloss(im):
        return jp.calc_loss(params, im, jnp.asarray(bbox), jnp.asarray(labels))

    want = np.asarray(jax.jit(jloss)(jnp.asarray(images)))
    want_g = np.asarray(jax.jit(jax.grad(lambda im: jloss(im).sum()))(jnp.asarray(images)))
    x = T(images).requires_grad_(True)
    got = pp.calc_loss(x, T(bbox), T(labels))
    got.sum().backward()
    assert want[0] < 1.0 and want[1] == 1.0
    U.assert_close(got, want, 1e-4, 1e-6, "calc_loss")
    _close_to_scale(x.grad, want_g, 1e-4, "calc_loss image grad")
    assert float(np.abs(want_g).max()) > 0


# --- the weights both ways ------------------------------------------------------


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_weights_cross_both_ways(tiny):
    """JAX → port through utils/convert.py, and the port's state dict (strhub
    keys) → JAX through ckpt_torch.convert_parseq / convert_vit: the trees
    come back equal and no key is left over."""
    _, params, pm = tiny
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    back = ckpt_torch.convert_parseq(sd)
    assert back["unknown"] == []
    want = dict(_flat(params["params"]))
    got = dict(_flat(back["params"]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    enc = ckpt_torch.convert_vit({k[len("encoder."):]: v for k, v in sd.items()
                                  if k.startswith("encoder.")})
    assert enc["unknown"] == []
    sd_enc = convert.vit_from_jax(enc["params"])
    assert all(torch.equal(sd_enc[k], pm.encoder.state_dict()[k]) for k in sd_enc)
    assert set(sd_enc) == set(pm.encoder.state_dict())


def test_full_width_parseq_shapes():
    """PARSeq-base as the engine builds it: the strhub key set of
    parseq-bb5792a6.pt (encoder depth 12, one decoder layer, 95-way head,
    26 position queries), fp32."""
    pm = PPQ.PARSeq()
    sd = pm.state_dict()
    assert sd["pos_queries"].shape == (1, 26, 384)
    assert sd["encoder.pos_embed"].shape == (1, 128, 384)
    assert sd["encoder.patch_embed.proj.weight"].shape == (384, 3, 4, 8)
    assert sd["decoder.layers.0.self_attn.in_proj_weight"].shape == (1152, 384)
    assert sd["decoder.layers.0.cross_attn.out_proj.weight"].shape == (384, 384)
    assert sd["text_embed.embedding.weight"].shape == (97, 384)
    assert sd["head.weight"].shape == (95, 384)
    assert not any(k.startswith("decoder.layers.1") for k in sd)
    assert sum(k.startswith("encoder.blocks.") and k.endswith("norm1.weight") for k in sd) == 12
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_ocr_and_loader_import_without_cv2_pil_or_jax():
    """In a fresh process with cv2 and PIL blocked, the port's OCR module and
    data loader import and a calc_loss runs; jax, flax and the JAX package
    stay out of sys.modules."""
    script = """
import sys
sys.modules["cv2"] = None
sys.modules["PIL"] = None
import torch
from udifftext_tpu_torch.data import loader
from udifftext_tpu_torch.data import datasets, augment
from udifftext_tpu_torch import ocr
from udifftext_tpu_torch.models.parseq import PARSeq
torch.manual_seed(0)
pred = ocr.ParseqPredictor(PARSeq(embed_dim=32, enc_depth=1, enc_num_heads=2, dec_num_heads=2))
tok = pred.tokenizer
loss = pred.calc_loss(torch.rand(2, 64, 64, 3), torch.tensor([[0, 32, 0, 64], [8, 40, 4, 60]]),
                      torch.as_tensor(tok.encode(["ab", "c"])))
batch = loader.collate([{"image": torch.zeros(2).numpy(), "label": "ab"}])
assert loss.shape == (2,) and batch["parseq_label_ids"].shape == (1, 27)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "udifftext_tpu")]
print(bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=str(REPO), timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
