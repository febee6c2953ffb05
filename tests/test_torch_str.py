"""The scene-text-recognition hub on the port (`models/str_hub.py`,
`str_models.py`, `trba.py`, `abinet.py`, PARSeq's training half,
`ops/image.py`, `str_eval.py`) against the JAX package on the CPU.

The weights cross in strhub's own layout: a port module is seeded (by
`builders.randomize_parameters`, as phase 18 of chip_smoke.py seeds), its
state dict saved with `torch.save` under the `model.` prefix (PARSeq's
release files have none, and the JAX loader reads them without one), and
both packages' `create_model(name, path, ...)` read that one file: the JAX
package through its own converters (`convert_parseq`, `convert_vit`,
`convert_abinet`, `convert_trba`, `convert_crnn`), which must find no key
they do not know. Outputs agree within 1e-4 of their scale on the same
seeded images, greedy ids and ABINet's lengths exactly; the functions
within 1e-5; the permutations and masks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from udifftext_tpu import str_eval as JE
from udifftext_tpu.models import abinet as JA
from udifftext_tpu.models import parseq as JPQ
from udifftext_tpu.models import str_hub as JH
from udifftext_tpu.models import str_models as JS
from udifftext_tpu.models import trba as JT
from udifftext_tpu.ops.image import grid_sample_bilinear as j_grid_sample
from udifftext_tpu.utils import ckpt_torch
from udifftext_tpu_torch import str_eval as PE
from udifftext_tpu_torch.builders import randomize_parameters
from udifftext_tpu_torch.models import abinet as PA
from udifftext_tpu_torch.models import parseq as PPQ
from udifftext_tpu_torch.models import str_hub as PH
from udifftext_tpu_torch.models import str_models as PS
from udifftext_tpu_torch.models import trba as PT
from udifftext_tpu_torch.ops.image import grid_sample_bilinear
from udifftext_tpu_torch.utils import convert

TINY = {
    "parseq": dict(embed_dim=32, enc_depth=1, enc_num_heads=2, dec_num_heads=2),
    "parseq-tiny": dict(embed_dim=32, enc_depth=1, enc_num_heads=2, dec_num_heads=2,
                        max_label_length=7),
    "vitstr": dict(embed_dim=32, depth=1, num_heads=2),
    "abinet": dict(d_model=64, d_inner=128, v_num_layers=1, l_num_layers=1),
    "trba": dict(hidden=32, output_channel=64),
    "crnn": dict(hidden=32),
}
CONVERTERS = {"parseq": ckpt_torch.convert_parseq, "parseq-tiny": ckpt_torch.convert_parseq,
              "abinet": ckpt_torch.convert_abinet, "trba": ckpt_torch.convert_trba,
              "crnn": ckpt_torch.convert_crnn,
              "vitstr": lambda sd: ckpt_torch.convert_vit(sd, prefix="model.")}


def seed_str_model(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded weights and BatchNorm statistics; TRBA keeps its fiducial bias."""
    return randomize_parameters(model, seed, keep=("localization_fc2.bias",))


def _images(b: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).uniform(-1, 1, (b, 32, 128, 3)).astype(np.float32)


def _close_to_scale(got, want, rtol: float, what: str) -> None:
    U.assert_close(got, want, 0.0, rtol * float(np.abs(np.asarray(want)).max()), what)


def _save(module: torch.nn.Module, path, prefix: str = "model.") -> str:
    torch.save({prefix + k: v for k, v in module.state_dict().items()}, path)
    return str(path)


@pytest.mark.parametrize("name", list(TINY))
def test_hub_model_matches_jax_loader(name, tmp_path):
    """One strhub-layout file, read by both hubs: same logits, same greedy ids."""
    src = seed_str_model(PH.build_model(name, **TINY[name]), 7)
    prefix = "" if name.startswith("parseq") else "model."
    path = _save(src, tmp_path / "ckpt.pt", prefix)
    sd = ckpt_torch.load_torch_state_dict(path)
    # the JAX hub carries ViTSTR's classifier by hand, past convert_vit
    assert CONVERTERS[name](sd)["unknown"] == (["head.weight", "head.bias"]
                                               if name == "vitstr" else [])
    pm = PH.create_model(name, path, device="cpu", **TINY[name])
    assert not pm.training
    jm, params = JH.create_model(name, path, **TINY[name])
    x = _images(3, 1)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    assert got.shape == want.shape
    _close_to_scale(got, want, 1e-4, name)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    if name == "abinet":
        np.testing.assert_array_equal(PA._pt_lengths(got).numpy(),
                                      np.asarray(JA._pt_lengths(jnp.asarray(want))))
    if name == "crnn":
        assert PS.ctc_collapse(PS.ctc_greedy_decode(got)) == \
            JS.ctc_collapse(np.asarray(JS.ctc_greedy_decode(jnp.asarray(want))))


def test_create_model_loads_strictly(tmp_path):
    """The `model.` prefix is optional; a missing or unexpected key fails
    the load, and the error names every one."""
    src = seed_str_model(PH.build_model("parseq", **TINY["parseq"]), 3)
    with_prefix = PH.create_model("parseq", _save(src, tmp_path / "a.pt"), device="cpu",
                                  **TINY["parseq"])
    bare = PH.create_model("parseq", _save(src, tmp_path / "b.pt", ""), device="cpu",
                           **TINY["parseq"])
    for a, b in zip(with_prefix.state_dict().values(), bare.state_dict().values()):
        assert torch.equal(a, b)
    sd = {f"model.{k}": v for k, v in src.state_dict().items()}
    sd.pop("model.head.bias")
    sd["model.extra.weight"] = torch.zeros(1)
    torch.save(sd, tmp_path / "c.pt")
    with pytest.raises(RuntimeError, match=r"1 missing keys \['head.bias'\].*1 unexpected keys "
                                           r"\['extra.weight'\]"):
        PH.create_model("parseq", str(tmp_path / "c.pt"), device="cpu", **TINY["parseq"])
    with pytest.raises(KeyError):
        PH.create_model("nope", device="cpu")
    assert PH.build_model("parseq_tiny").embed_dim == 192


def test_trba_teacher_forced_and_ctc_head():
    """TRBA's teacher-forced decode against JAX's; the CTC head option with
    the head's weights carried by hand (the JAX converter reads the
    attention decoder only)."""
    kw = dict(TINY["trba"], num_class=38, max_label_length=5, img_size=(32, 64))
    pm = seed_str_model(PT.TRBA(**kw), 11).eval()
    conv = ckpt_torch.convert_trba({f"model.{k}": v.numpy() for k, v in pm.state_dict().items()})
    assert conv["unknown"] == []
    variables = {"params": conv["params"], "batch_stats": conv["batch_stats"]}
    x = np.random.RandomState(2).uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    text = np.random.RandomState(3).randint(0, 38, (2, 6))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(text))
    want = np.asarray(JT.TRBA(**kw).apply(variables, jnp.asarray(x), jnp.asarray(text)))
    _close_to_scale(got, want, 1e-4, "teacher-forced")

    pc = seed_str_model(PT.TRBA(**kw, use_ctc=True), 11).eval()
    sd = {f"model.{k}": v.numpy() for k, v in pc.state_dict().items()
          if not k.startswith("Prediction.")}
    conv = ckpt_torch.convert_trba(sd)
    conv["params"]["ctc_head"] = {"Dense_0": {"kernel": pc.Prediction.weight.detach().numpy().T,
                                              "bias": pc.Prediction.bias.detach().numpy()}}
    with torch.no_grad():
        got = pc(torch.from_numpy(x))
    want = np.asarray(JT.TRBA(**kw, use_ctc=True).apply(
        {"params": conv["params"], "batch_stats": conv["batch_stats"]}, jnp.asarray(x)))
    assert got.shape == (2, 17, 38)
    _close_to_scale(got, want, 1e-4, "ctc head")


@pytest.mark.parametrize("F, hw", [(20, (32, 100)), (20, (16, 48)), (10, (8, 8))])
def test_tps_constants_equal(F, hw):
    for got, want in zip(PT.build_tps_constants(F, *hw), JT.build_tps_constants(F, *hw)):
        np.testing.assert_array_equal(got, want)
    grid = PT.GridGenerator(F, hw)
    assert grid.P_hat.shape == (hw[0] * hw[1], F + 3)


@pytest.mark.parametrize("shape", [(2, 8, 10, 3), (1, 5, 7, 4)])
def test_grid_sample_matches_jax(shape):
    """Bilinear, align_corners=True, border padding, points off every edge."""
    rs = np.random.RandomState(shape[1])
    img = rs.rand(*shape).astype(np.float32)
    grid = rs.uniform(-1.6, 1.6, (shape[0], 6, 9, 2)).astype(np.float32)
    grid[0, 0, :4] = [[-1, -1], [1, 1], [-3, 0.2], [2.5, -2.5]]
    want = np.asarray(j_grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    U.assert_close(grid_sample_bilinear(torch.from_numpy(img), torch.from_numpy(grid)), want,
                   1e-5, 1e-6, "grid sample")
    ys, xs = np.meshgrid(np.linspace(-1, 1, shape[1]), np.linspace(-1, 1, shape[2]),
                         indexing="ij")
    ident = np.broadcast_to(np.stack([xs, ys], -1)[None], shape[:3] + (2,)).astype(np.float32)
    U.assert_close(grid_sample_bilinear(torch.from_numpy(img), torch.from_numpy(ident)), img,
                   0, 1e-5, "identity grid")


def test_ctc_decode_and_collapse_match_jax():
    logits = np.random.RandomState(0).randn(4, 20, 6).astype(np.float32)
    ids = PS.ctc_greedy_decode(torch.from_numpy(logits))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(JS.ctc_greedy_decode(
        jnp.asarray(logits))))
    for blank in (0, 3):
        assert PS.ctc_collapse(ids, blank) == JS.ctc_collapse(ids.numpy(), blank)
    assert PS.ctc_collapse(np.array([[0, 1, 1, 0, 2, 2, 2, 3]])) == [[1, 2, 3]]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 25])
@pytest.mark.parametrize("flags", [dict(), dict(perm_num=2), dict(perm_forward=False),
                                   dict(perm_mirrored=False, perm_num=4)],
                         ids=["default", "two", "no_forward", "not_mirrored"])
def test_permutations_and_masks_equal(n, flags):
    if 1 < n < 5 and not flags.get("perm_forward", True):
        # strhub's own pool path stacks an empty list here; both packages raise
        for fn in (PPQ.gen_tgt_perms, JPQ.gen_tgt_perms):
            with pytest.raises(ValueError):
                fn(np.random.default_rng(5), n, **flags)
        return
    got = PPQ.gen_tgt_perms(np.random.default_rng(5), n, **flags)
    want = JPQ.gen_tgt_perms(np.random.default_rng(5), n, **flags)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for g, w in zip(PPQ.perm_attn_masks(got), JPQ.perm_attn_masks(want)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(PPQ.attn_masks_from_perm(got[0]), JPQ.attn_masks_from_perm(want[0])):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("flags", [dict(perm_num=6), dict(perm_num=4, perm_mirrored=False)],
                         ids=["perms", "not_mirrored"])
def test_parseq_training_loss_and_decoder_grads_match_jax(flags):
    """The permuted CE and its gradient with respect to the decoder (every
    decoder parameter, the head, the embeddings and the position queries),
    on weights from `parseq_from_jax`; each gradient within 1e-4 of its own
    largest element."""
    kw = dict(max_label_length=7, embed_dim=32, enc_depth=1, enc_num_heads=2, dec_num_heads=2)
    jm = JPQ.PARSeq(**kw)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 32, 128, 3)), 1),
                            jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, U.random_like_flax(shapes, 4))
    pm = U.load_port(PPQ.PARSeq(**kw), convert.parseq_from_jax(params))
    x = _images(3, 6)
    ids = PPQ.ParseqTokenizer().encode(["abc", "de", "Hello!"], max_length=7)
    perms = PPQ.gen_tgt_perms(np.random.default_rng(1), 7, **flags)

    def jloss(p):
        return JPQ.parseq_training_loss(jm, p, jnp.asarray(x), jnp.asarray(ids), perms)

    want, jgrads = jax.value_and_grad(jloss)(params)
    loss = PPQ.parseq_training_loss(pm, torch.from_numpy(x), torch.from_numpy(ids), perms)
    U.assert_close(loss, want, 1e-4, 1e-6, "loss")
    names = [k for k, _ in pm.named_parameters() if not k.startswith("encoder.")]
    grads = torch.autograd.grad(loss, [dict(pm.named_parameters())[k] for k in names])
    want_g = convert.parseq_from_jax(jax.tree.map(np.asarray, jgrads))
    scale = max(float(want_g[k].abs().max()) for k in names)
    for k, g in zip(names, grads):
        U.assert_close(g, want_g[k].numpy(), 0,
                       1e-4 * float(want_g[k].abs().max()) + 1e-6 * scale, k)
    assert scale > 0 and len(names) > 10


def test_str_eval_matches_jax():
    preds = ["hello", "worl", "ABC", "", "x1y"]
    gts = ["Hello", "world", "abd", "q", "X1Y!"]
    confs = [0.9, 0.8, 0.5, 0.1, 0.7]
    for charset in ("0123456789abcdefghijklmnopqrstuvwxyz", "ABCXY1", "aB1!"):
        got = PE.evaluate_predictions(preds, gts, confs, charset)
        want = JE.evaluate_predictions(preds, gts, confs, charset)
        assert vars(got) == vars(want)
        assert (got.accuracy, got.mean_1_minus_ned, got.mean_confidence) == \
            (want.accuracy, want.mean_1_minus_ned, want.mean_confidence)
        assert PE.CharsetAdapter(charset)("Hi! x1") == JE.CharsetAdapter(charset)("Hi! x1")
    for a, b in (("kitten", "sitting"), ("", "abc"), ("abc", ""), ("flaw", "lawn")):
        assert PE.edit_distance(a, b) == JE.edit_distance(a, b)
    logits = np.random.RandomState(0).randn(3, 6, 5).astype(np.float32)
    logits[1, 2, 0] = 9.0  # an EOS at step 2
    assert PE.sequence_confidence(logits) == JE.sequence_confidence(logits)
