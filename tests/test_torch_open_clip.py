"""The port's OpenCLIP towers, wrappers, tokenizer and loaders against
`udifftext_tpu/models/open_clip.py` on the CPU, fp32, at the small widths of
tests/test_open_clip.py: the text tower in every layer/legacy/pooled mode,
the vision tower with and without its patch tokens, `clip_preprocess`
(native size and both resize directions, with and without antialiasing),
both sgm wrappers in every output mode, `SimpleTokenizer` ids on a
synthetic merges file, and the weight-gated loaders (a file in open_clip's
own key layout loads without a converter). Tolerance 1e-5 relative.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from udifftext_tpu.embedders import load_frozen_open_clip_text_embedder as jload_text
from udifftext_tpu.models import open_clip as JO
from udifftext_tpu_torch import embedders as PE
from udifftext_tpu_torch.models import open_clip as PO
from udifftext_tpu_torch.utils import convert

T = torch.from_numpy
TEXT_CFG = dict(vocab_size=50, width=32, heads=2, layers=3, context_length=10, embed_dim=16)
VIS_CFG = dict(image_size=16, patch_size=8, width=32, heads=2, layers=2, output_dim=16)


def _close(got, want, what):
    want = np.asarray(want)
    U.assert_close(got, want, 1e-5, 1e-5 * float(np.abs(want).max()), what)


@pytest.fixture(scope="module")
def text_pair():
    jm = JO.OpenClipTextTransformer(**TEXT_CFG)
    params = U.flax_params(jm, 3, jnp.zeros((1, TEXT_CFG["context_length"]), jnp.int32))
    pm = U.load_port(PO.OpenClipTextTransformer(**TEXT_CFG), convert.open_clip_from_jax(params))
    return jm, params, pm


@pytest.fixture(scope="module")
def vis_pair():
    jm = JO.OpenClipVisionTransformer(**VIS_CFG)
    s = VIS_CFG["image_size"]
    params = U.flax_params(jm, 4, jnp.zeros((1, s, s, 3)))
    pm = U.load_port(PO.OpenClipVisionTransformer(**VIS_CFG), convert.open_clip_from_jax(params))
    return jm, params, pm


def _ids(n=2):
    rng = np.random.RandomState(0)
    ids = rng.randint(1, TEXT_CFG["vocab_size"] - 1,
                      (n, TEXT_CFG["context_length"])).astype(np.int32)
    ids[:, 0] = 1
    ids[0, 6:] = 0  # padding after the "eot" (argmax picks position 5)
    ids[0, 5] = TEXT_CFG["vocab_size"] - 1
    ids[1, -1] = TEXT_CFG["vocab_size"] - 1
    return ids


def test_key_layout_is_open_clip(text_pair, vis_pair):
    _, _, pt = text_pair
    _, _, pv = vis_pair
    assert {"token_embedding.weight", "positional_embedding", "text_projection",
            "ln_final.weight", "transformer.resblocks.0.attn.in_proj_weight",
            "transformer.resblocks.2.attn.out_proj.bias", "transformer.resblocks.1.mlp.c_fc.weight",
            "transformer.resblocks.1.mlp.c_proj.bias", "transformer.resblocks.0.ln_2.weight",
            } <= set(pt.state_dict())
    assert {"conv1.weight", "class_embedding", "positional_embedding", "ln_pre.weight",
            "ln_post.bias", "proj", "transformer.resblocks.1.ln_1.bias"} <= set(pv.state_dict())


@pytest.mark.parametrize("layer,legacy,pooled", [("last", True, False),
                                                 ("penultimate", True, False),
                                                 ("last", False, False),
                                                 ("penultimate", False, True),
                                                 ("last", False, True)])
def test_text_tower_matches_jax(text_pair, layer, legacy, pooled):
    jm, params, pm = text_pair
    ids = _ids()
    want = jm.apply(params, jnp.asarray(ids), layer=layer, legacy=legacy, return_pooled=pooled)
    with torch.no_grad():
        got = pm(T(ids), layer=layer, legacy=legacy, return_pooled=pooled)
    if pooled:
        _close(got[0], want[0], "states")
        _close(got[1], want[1], "pooled")
    else:
        _close(got, want, layer)


@pytest.mark.parametrize("output_tokens", [False, True])
def test_vision_tower_matches_jax(vis_pair, output_tokens):
    jm, params, pm = vis_pair
    s = VIS_CFG["image_size"]
    x = np.random.RandomState(1).standard_normal((2, s, s, 3)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x), output_tokens=output_tokens)
    with torch.no_grad():
        got = pm(T(x), output_tokens=output_tokens)
    if output_tokens:
        _close(got[0], want[0], "pooled")
        _close(got[1], want[1], "tokens")
    else:
        _close(got, want, "pooled")


@pytest.mark.parametrize("hw,antialias", [((16, 16), True), ((40, 24), True), ((40, 24), False),
                                          ((9, 12), True)])
def test_clip_preprocess_matches_jax(hw, antialias):
    x = np.random.RandomState(2).uniform(-1, 1, (2,) + hw + (3,)).astype(np.float32)
    want = JO.clip_preprocess(jnp.asarray(x), antialias=antialias, size=16)
    _close(PO.clip_preprocess(T(x), antialias=antialias, size=16), want, str(hw))


@pytest.mark.parametrize("mode", [{}, {"unsqueeze_dim": True},
                                  {"repeat_to_max_len": True, "max_length": 7},
                                  {"unsqueeze_dim": True, "repeat_to_max_len": True,
                                   "max_length": 5},
                                  {"output_tokens": True}, {"antialias": False}])
def test_image_embedder_modes_match_jax(vis_pair, mode):
    jm, params, pm = vis_pair
    x = np.random.RandomState(3).uniform(-1, 1, (2, 24, 20, 3)).astype(np.float32)
    want = JO.FrozenOpenCLIPImageEmbedder(model=jm, params=params, **mode)(jnp.asarray(x))
    got = PO.FrozenOpenCLIPImageEmbedder(pm, **mode)(T(x))
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, str(mode))
    else:
        _close(got, want, str(mode))


def _vocab(tmp_path):
    path = tmp_path / "bpe.txt.gz"
    with gzip.open(path, "wt") as f:
        f.write("#version: 0.2\n")
        for merge in ("a b</w>", "h e", "l l", "he ll", "hell o</w>", "t h", "th e</w>"):
            f.write(merge + "\n")
    return str(path)


TEXTS = ["ab", "ba", "Hello the world!", "  HELLO\tthe  &amp; 42 ", "héllo ünïcode", "it's 3.5",
         "a" * 30]


def test_simple_tokenizer_matches_jax(tmp_path):
    path = _vocab(tmp_path)
    jt, pt = JO.SimpleTokenizer(path, context_length=12), PO.SimpleTokenizer(path, context_length=12)
    np.testing.assert_array_equal(pt.tokenize(TEXTS), jt.tokenize(TEXTS))
    np.testing.assert_array_equal(pt.tokenize(TEXTS, 6), jt.tokenize(TEXTS, 6))
    ids = pt.tokenize(["ab", "hello"])
    assert ids[0, 1] == pt.encoder["ab</w>"] and ids[0, 2] == pt.eot
    assert ids[1, 1] == pt.encoder["hello</w>"]
    with pytest.raises(FileNotFoundError):
        PO.SimpleTokenizer(str(tmp_path / "absent.gz"))


def test_text_embedder_with_tokenizer_matches_jax(text_pair, tmp_path):
    jm, params, pm = text_pair
    path = _vocab(tmp_path)
    n = TEXT_CFG["context_length"]
    jtok, ptok = JO.SimpleTokenizer(path, n), PO.SimpleTokenizer(path, n)
    # the synthetic vocabulary's ids run past the tiny table: fold them in
    texts = ["ab", "hello the"]
    ids = jtok.tokenize(texts) % TEXT_CFG["vocab_size"]
    for layer, legacy, pooled in (("penultimate", True, False), ("last", False, True)):
        jemb = JO.FrozenOpenCLIPTextEmbedder(model=jm, max_length=n, layer=layer, legacy=legacy,
                                             always_return_pooled=pooled, params=params)
        pemb = PO.FrozenOpenCLIPTextEmbedder(pm, max_length=n, layer=layer, legacy=legacy,
                                             always_return_pooled=pooled)
        want, got = jemb(ids), pemb(ids)
        for g, w in zip(got if pooled else (got,), want if pooled else (want,)):
            _close(g, w, layer)
    pemb = PO.FrozenOpenCLIPTextEmbedder(pm, max_length=n, tokenizer=ptok)
    np.testing.assert_array_equal(ptok.tokenize(texts), jtok.tokenize(texts))
    with pytest.raises(ValueError, match="BPE"):
        PO.FrozenOpenCLIPTextEmbedder(pm, max_length=n)(texts)


def test_loaders_read_open_clip_files(text_pair, vis_pair, tmp_path):
    jm, params, pt = text_pair
    _, vparams, pv = vis_pair
    for load in (PE.load_frozen_open_clip_text_embedder, PE.load_frozen_open_clip_image_embedder,
                 jload_text):
        with pytest.raises(RuntimeError, match="open_clip weights not found"):
            load(weights_path=str(tmp_path / "nope.bin"))
    # one CLIP state dict: the text tower at the top level, the vision tower
    # under visual., the contrastive head's logit_scale beside them
    sd = {**pt.state_dict(), **{f"visual.{k}": v for k, v in pv.state_dict().items()},
          "logit_scale": torch.tensor(4.6)}
    path = tmp_path / "open_clip_pytorch_model.bin"
    torch.save(sd, path)
    temb = PE.load_frozen_open_clip_text_embedder(
        max_length=TEXT_CFG["context_length"], layer="penultimate", weights_path=str(path),
        device="cpu", **TEXT_CFG)
    ids = _ids()
    jemb = jload_text(max_length=TEXT_CFG["context_length"], layer="penultimate",
                      weights_path=str(path), **TEXT_CFG)
    _close(temb(ids), jemb(ids), "text loader")
    vemb = PE.load_frozen_open_clip_image_embedder(weights_path=str(path), device="cpu",
                                                   output_tokens=True, **VIS_CFG)
    s = VIS_CFG["image_size"]
    x = np.random.RandomState(5).uniform(-1, 1, (2, s, s, 3)).astype(np.float32)
    want = JO.FrozenOpenCLIPImageEmbedder(model=JO.OpenClipVisionTransformer(**VIS_CFG),
                                          params=vparams, output_tokens=True)(jnp.asarray(x))
    for g, w in zip(vemb(T(x)), want):
        _close(g, w, "image loader")
    text_only = tmp_path / "text_only.bin"
    torch.save(dict(pt.state_dict()), text_only)
    with pytest.raises(RuntimeError, match="carries no visual tower"):
        PE.load_frozen_open_clip_image_embedder(weights_path=str(text_only), device="cpu",
                                                **VIS_CFG)
