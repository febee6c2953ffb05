"""Checkpoint loading on the port (udifftext_tpu_torch/utils/ckpt.py,
udifftext_tpu_torch/loading.py) against the JAX package's loader, on the
tiny model graph, with checkpoint files the tests write themselves.

- The `.safetensors` reader against the `safetensors` package, and its
  refusals (unknown dtype, a file shorter than its header says).
- The zero-initialized output projections (the reference's zero_module):
  every weight `init_engine_params` leaves all-zero is all-zero in a freshly
  built port engine, and no other.
- One synthetic UDiffText checkpoint (UNet, VAE and LabelEncoder under the
  reference prefixes, with one unexpected, one missing and one mis-shaped
  UNet key), as a Lightning `.ckpt` and as `.safetensors`; the component
  files the graph names (a bare VAE `.safetensors`, a bare LabelEncoder
  `.ckpt`); and a trunk-only checkpoint (no t_attn/t_norm keys, as the
  SD2-inpainting bootstrap). Each is loaded by both packages: the port's
  parameters, converted by `ckpt_torch.convert_*`, equal the JAX package's
  exactly (fp32), a UNet eval agrees at 1e-5, and the printed reports count
  what the test wrote.
"""

import argparse
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

import torch_port_util as U
from udifftext_tpu import loading as jax_loading
from udifftext_tpu.builders import build_diffusion_engine
from udifftext_tpu.utils import ckpt_torch
from udifftext_tpu_torch import loading
from udifftext_tpu_torch.builders import build_engine, randomize_parameters
from udifftext_tpu_torch.utils import ckpt

RTOL, ATOL = 1e-5, 1e-5
EXTRA = "model.diffusion_model.label_emb.0.0.weight"  # SD's class embedding: not in this UNet
DROPPED = "model.diffusion_model.out.2.bias"
RESHAPED = "model.diffusion_model.input_blocks.1.0.out_layers.3.bias"
# the modules the reference zero-initializes, by the port's key names
ZERO_INIT = re.compile(r"(\.t_attn\.to_out\.0|\.v_attn\.to_out\.0|\.proj_out|\.out_layers\.3"
                       r"|^out\.2)\.(weight|bias)$")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _cfg(vae_path=None, le_path=None):
    cfg = U.tiny_model_cfg()
    if vae_path:
        cfg["first_stage_config"]["params"]["ckpt_path"] = str(vae_path)
    if le_path:
        cfg["conditioner_config"]["params"]["emb_models"][0]["params"]["ckpt_path"] = str(le_path)
    return cfg


def _jax_init(cfg):
    bundle = build_diffusion_engine(cfg, unet_dtype=jnp.float32)
    return bundle, jax_loading.init_engine_params(bundle, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def source():
    """The weights every checkpoint here is cut from: a port engine with
    seeded random parameters, as numpy state dicts per component."""
    eng = randomize_parameters(build_engine(U.tiny_model_cfg(), torch.float32, "cpu").engine, 7)
    return {name: {k: v.numpy().copy() for k, v in getattr(eng, name).state_dict().items()}
            for name in ("unet", "vae", "label_encoder")}


def _full_state_dict(source):
    sd = {"model.diffusion_model." + k: v for k, v in source["unet"].items()}
    sd.update({"first_stage_model." + k: v for k, v in source["vae"].items()})
    sd.update({"conditioner.embedders.0." + k: v for k, v in source["label_encoder"].items()})
    # the reference LabelEncoder's fixed positional buffer: the port recomputes it
    sd["conditioner.embedders.0.pos_embedding.pe"] = np.zeros((1, 12, 32), np.float32)
    sd[EXTRA] = np.ones((128, 32), np.float32)
    del sd[DROPPED]
    sd[RESHAPED] = np.ones(source["unet"][RESHAPED.split(".", 2)[2]].shape[0] + 1, np.float32)
    return sd


def _save(sd, path):
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    if str(path).endswith(".safetensors"):
        safetensors.torch.save_file(tensors, str(path))
    else:
        torch.save({"state_dict": tensors, "global_step": 3}, str(path))
    return str(path)


def _port_vs_jax(pe, jparams, names=("unet", "vae", "label_encoder")):
    """Every leaf of the JAX params equals the port's converted parameters."""
    conv = {"unet": lambda sd: ckpt_torch.convert_unet(sd, prefix=""),
            "vae": ckpt_torch.convert_vae, "label_encoder": ckpt_torch.convert_label_encoder}
    for name in names:
        sd = {k: v.detach().numpy() for k, v in getattr(pe, name).state_dict().items()}
        got = dict(_flat(conv[name](sd)["params"]))
        want = dict(_flat(jparams[name]["params"]))
        assert sorted(got) == sorted(want), name
        for k, v in want.items():
            assert got[k].dtype == v.dtype == np.float32 and np.array_equal(got[k], v), (name, k)


def _unet_eval_agrees(pe, je, jparams):
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, U.LAT, U.LAT, 9)).astype(np.float32)
    t = np.array([999, 17], np.int32)
    ctx = rs.standard_normal((2, U.SEQ, 32)).astype(np.float32)
    want, _ = je.unet.apply(jparams["unet"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got, _ = pe.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    U.assert_close(got, np.asarray(want), RTOL, ATOL, "unet out")
    return np.asarray(want)


def _reports(text):
    return re.findall(r"^\[(\w+)\] merged with (\d+) missing, (\d+) unexpected, (\d+) mismatched"
                      r" keys$", text, re.M)


# -- the .safetensors reader ---------------------------------------------------


def test_safetensors_reader_matches_the_package(tmp_path):
    rs = np.random.RandomState(1)
    arrays = {"a.weight": rs.standard_normal((3, 4)).astype(np.float32),
              "b": rs.standard_normal((5,)).astype(np.float16),
              "idx": rs.randint(-9, 9, (2, 3)).astype(np.int64),
              "scalar": np.array(2.5, np.float32), "empty": np.zeros((0, 3), np.float32)}
    path = str(tmp_path / "x.safetensors")
    safetensors.numpy.save_file(arrays, path, metadata={"format": "pt"})
    got = ckpt.load_safetensors(path)
    want = safetensors.numpy.load_file(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype and np.array_equal(got[k].numpy(), v), k
    # numpy has no bf16: the torch loader is the reference there
    bf = {"w": torch.randn(4, 6, generator=torch.Generator().manual_seed(2)).bfloat16(),
          "v": torch.arange(3, dtype=torch.float32)}
    path = str(tmp_path / "bf.safetensors")
    safetensors.torch.save_file(bf, path)
    got, want = ckpt.load_safetensors(path), safetensors.torch.load_file(path)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert ckpt.load_state_dict(path).keys() == want.keys()


def test_safetensors_reader_refuses_what_it_cannot_read(tmp_path):
    path = str(tmp_path / "f64.safetensors")
    safetensors.numpy.save_file({"x": np.zeros(3, np.float64)}, path)
    with pytest.raises(ValueError, match="dtype 'F64'"):
        ckpt.load_safetensors(path)
    path = str(tmp_path / "ok.safetensors")
    safetensors.numpy.save_file({"x": np.arange(64, dtype=np.float32)}, path)
    data = open(path, "rb").read()
    for cut, what in ((len(data) - 4, "data section"), (20, "past the end"), (5, "too short")):
        bad = tmp_path / f"cut{cut}.safetensors"
        bad.write_bytes(data[:cut])
        with pytest.raises(ValueError, match=what):
            ckpt.load_safetensors(str(bad))


def test_torch_pickles_load_as_tensors(tmp_path, capsys):
    """Zip and legacy torch files, a bare state dict and a Lightning one whose
    hyper-parameters need the full unpickler; non-tensor entries are dropped."""
    sd = {"w": torch.arange(6.0).reshape(2, 3), "step": 4}
    for name, obj, kw in (("zip.ckpt", {"state_dict": sd}, {}),
                          ("legacy.pt", sd, {"_use_new_zipfile_serialization": False}),
                          ("hparams.ckpt", {"state_dict": sd,
                                            "hyper_parameters": argparse.Namespace(lr=1e-4)}, {})):
        torch.save(obj, str(tmp_path / name), **kw)
        got = ckpt.load_state_dict(str(tmp_path / name))
        assert list(got) == ["w"] and torch.equal(got["w"], sd["w"]), name
    assert "weights_only=False" in capsys.readouterr().out


def test_merge_reports_and_casts(capsys):
    m = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.LayerNorm(2)).to(torch.bfloat16)
    before = m[0].bias.detach().clone()
    sd = {"0.weight": torch.ones(2, 3), "0.bias": torch.ones(5), "9.weight": torch.ones(1)}
    missing, unexpected, mismatched = ckpt.merge_state_dict(m, sd, "toy")
    assert missing == ["1.weight", "1.bias"] and unexpected == ["9.weight"]
    assert mismatched == ["0.bias: ckpt(5,) vs init(2,)"]
    assert m[0].weight.dtype == torch.bfloat16 and torch.equal(m[0].weight, torch.ones(2, 3,
                                                                                   dtype=torch.bfloat16))
    assert torch.equal(m[0].bias, before)
    out = capsys.readouterr().out.splitlines()
    assert out == ["[toy] merged with 2 missing, 1 unexpected, 1 mismatched keys",
                   "  mismatch: 0.bias: ckpt(5,) vs init(2,)"]


# -- zero-initialized output projections ---------------------------------------


def test_fresh_engine_zero_inits_the_projections_the_jax_package_does():
    cfg = U.tiny_model_cfg()
    _, jparams = _jax_init(cfg)
    pe = build_engine(cfg, torch.float32, "cpu").engine
    from udifftext_tpu_torch.utils import convert

    jsd = convert.unet_from_jax(jparams["unet"])
    psd = pe.unet.state_dict()
    assert sorted(jsd) == sorted(psd)
    zero_in_jax = {k for k, v in jsd.items() if ZERO_INIT.search(k) and not v.any()}
    assert zero_in_jax == {k for k in psd if ZERO_INIT.search(k)} and len(zero_in_jax) >= 10
    zero_in_port = {k for k, v in psd.items() if not v.any()}
    assert zero_in_jax <= zero_in_port
    # every other weight is random in both (the JAX biases all start at zero)
    assert {k for k in zero_in_port if k.endswith("weight")} == \
        {k for k, v in jsd.items() if k.endswith("weight") and not v.any()}


# -- loading checkpoints, both packages ----------------------------------------


@pytest.mark.parametrize("fmt", ["ckpt", "safetensors"])
def test_full_checkpoint_loads_as_in_the_jax_package(tmp_path, source, fmt, capsys):
    path = _save(_full_state_dict(source), tmp_path / f"udifftext.{fmt}")
    jb, jparams = _jax_init(U.tiny_model_cfg())
    jparams = jax_loading.load_from_torch_ckpt(jparams, path)
    jax_out = capsys.readouterr().out
    pe = build_engine(U.tiny_model_cfg(), torch.float32, "cpu").engine
    reports = loading.load_from_torch_ckpt(pe, path)
    out = capsys.readouterr().out
    assert _reports(out) == [("unet", "1", "1", "1"), ("vae", "0", "0", "0"),
                             ("label_encoder", "0", "1", "0")]
    shape = source["unet"][RESHAPED.split(".", 2)[2]].shape[0]
    assert f"  mismatch: input_blocks.1.0.out_layers.3.bias: ckpt({shape + 1},) vs " \
           f"init({shape},)" in out
    assert reports["unet"][:2] == (["out.2.bias"], ["label_emb.0.0.weight"])
    assert reports["label_encoder"][1] == ["pos_embedding.pe"]
    # the JAX package counts flax subtrees and skips keys its converters drop
    assert _reports(jax_out) == [("unet", "1", "1", "1"), ("vae", "0", "0", "0"),
                                 ("label_encoder", "0", "0", "0")]
    _port_vs_jax(pe, jparams)
    _unet_eval_agrees(pe, jb.engine, jparams)
    for k, v in source["unet"].items():  # what the file held, the port took
        if "model.diffusion_model." + k not in (DROPPED, RESHAPED):
            assert np.array_equal(pe.unet.state_dict()[k].numpy(), v), k


def test_component_checkpoints_load_as_in_the_jax_package(tmp_path, source, capsys):
    vae = _save(source["vae"], tmp_path / "ae.safetensors")
    le = _save({**source["label_encoder"], "pos_embedding.pe": np.zeros((1, 12, 32), np.float32)},
               tmp_path / "le.ckpt")
    jb, jparams = _jax_init(_cfg(vae, le))
    jparams = jax_loading.load_component_ckpts(jparams, jb)
    bundle = build_engine(_cfg(vae, le), torch.float32, "cpu")
    assert bundle.ckpt_paths == {"model": None, "vae": vae, "label_encoder": le, "parseq": None}
    reports = loading.load_component_ckpts(bundle)
    assert f"[vae] loaded {vae}" in capsys.readouterr().out
    assert reports["vae"] == ([], [], []) and reports["label_encoder"][1] == ["pos_embedding.pe"]
    _port_vs_jax(bundle.engine, jparams, ("vae", "label_encoder"))
    # the bare VAE layout and the bare LabelEncoder layout, as a run checkpoint
    for path, name in ((vae, "vae"), (le, "label_encoder")):
        pe = build_engine(U.tiny_model_cfg(), torch.float32, "cpu").engine
        assert list(loading.load_from_torch_ckpt(pe, path)) == [name]


def test_trunk_only_checkpoint_gives_the_jax_unet(tmp_path, source, capsys):
    """The SD2-inpainting bootstrap has no t_attn/t_norm keys: the branches
    keep their zero-output init, so both packages compute the same UNet."""
    trunk = {"model.diffusion_model." + k: v for k, v in source["unet"].items()
             if ".t_attn." not in k and ".t_norm." not in k}
    path = _save(trunk, tmp_path / "512-inpainting-ema.ckpt")
    jb, jparams = _jax_init(U.tiny_model_cfg())
    jparams = jax_loading.load_from_torch_ckpt(jparams, path)
    bundle = build_engine(U.tiny_model_cfg(), torch.float32, "cpu")
    capsys.readouterr()
    loading.load_from_torch_ckpt(bundle.engine, path)
    n_branch = sum(".t_attn." in k or ".t_norm." in k for k in source["unet"])
    assert _reports(capsys.readouterr().out) == [("unet", str(n_branch), "0", "0")]
    want = _unet_eval_agrees(bundle.engine, jb.engine, jparams)
    assert np.abs(want).max() > 0
    # the same file through the run config, the demo's and the trainer's way in
    cfgs = {"load_ckpt_path": path, "bf16": False}
    pe = loading.init_model(cfgs, "cpu", model_cfg=U.tiny_model_cfg()).engine
    ref = bundle.engine.unet.state_dict()
    for k, v in pe.unet.state_dict().items():  # t_attn's q/k/v are the init's draws
        assert re.search(r"\.t_attn\.to_[qkv]\.", k) or torch.equal(v, ref[k]), k


def test_init_model_seed_fixes_what_the_checkpoint_lacks(tmp_path, source):
    """With a trunk-only file, the t_attn/t_norm parameters come from the
    init: one seed gives the same values every time, another seed others,
    and the caller's global generator is left as it was."""
    trunk = {"model.diffusion_model." + k: v for k, v in source["unet"].items()
             if ".t_attn." not in k and ".t_norm." not in k}
    cfgs = {"load_ckpt_path": _save(trunk, tmp_path / "trunk.ckpt"), "bf16": False}
    torch.manual_seed(123)
    state = torch.random.get_rng_state()
    a, b, c = (loading.init_model(cfgs, "cpu", seed=s, model_cfg=U.tiny_model_cfg()).engine.unet
               for s in (5, 5, 6))
    assert torch.equal(torch.random.get_rng_state(), state)
    branch = [k for k in a.state_dict() if ".t_attn.to_" in k and "weight" in k]
    assert branch
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    for k in branch:
        assert torch.equal(sa[k], sb[k]), k
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not any(torch.equal(sa[k], sc[k]) for k in branch if ".to_out." not in k)


def test_dense_and_conv_init_is_lecun_normal():
    """Dense and conv weights start as flax's lecun_normal draws (variance
    1/fan_in, truncated at 2 of its normal's standard deviations), biases at
    zero, as the JAX modules' kernels and biases do."""
    import jax
    import jax.numpy as jnp

    from udifftext_tpu_torch.models.layers import Conv3x3, Dense

    torch.manual_seed(0)
    for m, fan_in in ((Dense(256, 512), 256), (Conv3x3(64, 512), 64 * 9)):
        w = m.weight.detach().double().numpy()
        j = np.asarray(jax.nn.initializers.lecun_normal()(
            jax.random.PRNGKey(0), (fan_in, 512), jnp.float32), np.float64)
        bound = 2.0 / np.sqrt(fan_in) / 0.87962566103423978
        assert abs(w.std() * np.sqrt(fan_in) - 1.0) < 0.03
        assert abs(j.std() * np.sqrt(fan_in) - 1.0) < 0.03
        assert np.abs(w).max() <= bound and np.abs(j).max() <= bound * (1 + 1e-6)
        assert not m.bias.any()


def test_init_model_without_a_checkpoint_is_seeded(capsys):
    cfgs = {"load_ckpt_path": "./no/such.ckpt", "bf16": True, "steps": 7, "scale": [3.5, 0.0]}
    a = loading.init_model(cfgs, "cpu", seed=4, model_cfg=U.tiny_model_cfg()).engine
    b = randomize_parameters(build_engine(U.tiny_model_cfg(), torch.bfloat16, "cpu").engine, 4)
    assert "not found" in capsys.readouterr().out
    assert a.unet.input_blocks[0][0].weight.dtype == torch.bfloat16
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    s = loading.init_sampling(cfgs)
    assert (s.num_steps, s.cfg_scale) == (7, 3.5)


def test_train_loads_the_run_checkpoint(tmp_path, source):
    """init_model(train=True) loads cfgs' load_ckpt_path and train() starts
    from it: the frozen parameters then hold the file's values cast to their
    dtype (bf16 weights, fp32 norms), and the fp32 master weights of
    t_attn/t_norm the file's values moved by one update."""
    from udifftext_tpu_torch.train import train

    path = _save({"model.diffusion_model." + k: v for k, v in source["unet"].items()},
                 tmp_path / "run.ckpt")
    cfgs = {"load_ckpt_path": path, "log_dir": str(tmp_path), "lightning": {"max_epochs": 1}}
    bundle = loading.init_model(cfgs, "cpu", model_cfg=U.tiny_model_cfg(), train=True)
    b = U.numpy_batch(2, seed=3)
    b["seg"] = np.zeros((2, U.IMG, U.IMG, U.SEQ), np.float32)
    b["seg"][:, 8:24, 6:26, 0] = 1.0
    train(cfgs, [b], bundle, seed=0)
    sd = bundle.engine.unet.state_dict()
    for k, v in source["unet"].items():
        if ".t_attn." in k or ".t_norm." in k:
            assert sd[k].dtype == torch.float32 and not torch.equal(sd[k], torch.from_numpy(v))
        else:  # bf16 weights, fp32 norms
            assert torch.equal(sd[k], torch.from_numpy(v).to(sd[k].dtype)), k
    assert sd["input_blocks.0.0.weight"].dtype == torch.bfloat16
