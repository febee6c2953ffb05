"""LabelEncoder pretraining on the port (`udifftext_tpu_torch.pretrain`)
against the JAX package on the CPU, at tests/test_parallel.py's tiny sizes
(LabelEncoderPretrain max_len 4, emb 16, 2 heads, 1 layer; ViTSTR 16²,
patch 8, dim 8, depth 1, so visual_len 5), with one set of seeded random
weights carried across by `utils/convert.py` and numpy inputs from a seed:

- `ViTSTREncoder`, `InstanceNorm`, `LabelEncoderPretrain`'s outputs and
  `clip_contrastive_loss` with its seven entries against the JAX modules
  (fp32; 1e-5 relative);
- one whole step against root pretrain.py's `make_pretrain_step(...,
  mesh=None)` with `optax.adamw(lr)`: the loss and its entries (1e-5
  relative) and every updated parameter (1e-6 absolute; weight decay 1e-4 on
  both sides);
- two gloo processes, each with half of a global batch of 8, against one
  process with all 8: the same loss and parameters after a step, so the
  contrastive matrix spans the whole batch;
- `pretrain.main` on synthetic batches writing a checkpoint that
  `train_ckpt.restore_checkpoint` reads back, and the CLI on `LabelDataset`
  for 2 steps.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import torch_port_util as U
from udifftext_tpu.diffusion.loss import clip_contrastive_loss as j_clip_loss
from udifftext_tpu.models.label_encoder import InstanceNorm as JInstanceNorm
from udifftext_tpu.models.label_encoder import LabelEncoderPretrain as JPretrain
from udifftext_tpu.models.vit import ViTSTREncoder as JViTSTR
from udifftext_tpu.parallel.train import TrainState as JTrainState
from udifftext_tpu_torch import pretrain
from udifftext_tpu_torch.data.synthetic import SyntheticLabelBatches, glyph_table
from udifftext_tpu_torch.diffusion.loss import clip_contrastive_loss
from udifftext_tpu_torch.models.label_encoder import InstanceNorm, LabelEncoderPretrain
from udifftext_tpu_torch.models.vit import ViTSTREncoder, vitstr_features
from udifftext_tpu_torch.utils import convert, train_ckpt

REPO = Path(__file__).resolve().parent.parent
T = torch.from_numpy
MAX_LEN, VIS = 4, dict(size=16, patch_size=8, embed_dim=8, depth=1, num_heads=2, in_chans=1)
LE = dict(max_len=MAX_LEN, emb_dim=16, n_heads=2, n_trans_layers=1, visual_len=5, visual_dim=8)
LR = 1e-5  # configs/pretrain.yaml's
TINY_CFGS = {"model": {"params": {"max_len": MAX_LEN, "emb_dim": 16, "n_heads": 2,
                                  "n_trans_layers": 1, "lr": LR, "lambda_cls": 0.1,
                                  "lambda_pos": 0.1, "visual_config": {"params": dict(VIS)}}},
             "batch_size": 4, "check_freq": 1, "lightning": {"max_epochs": 1}}


def _inputs(b: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    images = rs.rand(b, 16, 16, 1).astype(np.float32)
    ids = rs.randint(0, 95, (b, MAX_LEN)).astype(np.int32)
    return images, ids


@pytest.fixture(scope="module")
def models():
    """(JAX model, its params, JAX ViTSTR, its params, port model, port ViTSTR)."""
    jm, jv = JPretrain(**LE), JViTSTR(**VIS)
    params = U.flax_params(jm, 1, jnp.zeros((1, MAX_LEN), jnp.int32), jnp.zeros((1, 5, 8)))
    vparams = U.flax_params(jv, 2, jnp.zeros((1, 16, 16, 1)))
    pm = U.load_port(LabelEncoderPretrain(**LE), convert.label_encoder_pretrain_from_jax(params))
    pv = U.load_port(ViTSTREncoder(**VIS), convert.vitstr_from_jax(vparams))
    return jm, params, jv, vparams, pm, pv


def test_vitstr_matches_jax(models):
    _, _, jv, vparams, _, pv = models
    images, _ = _inputs(3)
    want = np.asarray(jv.apply(vparams, jnp.asarray(images)))
    with torch.no_grad():
        got = pv(T(images))
    assert want.shape == (3, 5, 8)  # the class token and (16/8)² patches
    U.assert_close(got, want, 1e-5, 1e-6, "vitstr")
    # a timm ViTSTR file: the classifier's entries dropped, the rest loads strictly
    sd = dict(pv.state_dict(), **{"head.weight": torch.zeros(96, 8), "head.bias": torch.zeros(96),
                                  "dist_token": torch.zeros(1, 1, 8)})
    ViTSTREncoder(**VIS).load_state_dict(vitstr_features(sd), strict=True)


def test_instance_norm_matches_jax():
    x = np.random.RandomState(3).standard_normal((2, 4, 16)).astype(np.float32) * 3 + 1
    want = np.asarray(JInstanceNorm().apply({}, jnp.asarray(x)))
    U.assert_close(InstanceNorm()(T(x)), want, 1e-5, 1e-6, "instance norm")


def test_label_encoder_pretrain_matches_jax(models):
    jm, params, _, _, pm, _ = models
    _, ids = _inputs(3)
    visual_emb = np.random.RandomState(4).standard_normal((3, 5, 8)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(ids), jnp.asarray(visual_emb))
    with torch.no_grad():
        got = pm(T(ids), T(visual_emb))
    assert set(got) == set(want)
    for k in want:
        U.assert_close(got[k], np.asarray(want[k]), 1e-5, 1e-5, k)
    assert "visual_out" not in pm(T(ids))
    # the module's own init: the logit scale and the token mixes' biases
    fresh = LabelEncoderPretrain(**LE)
    assert fresh.logit_scale.item() == pytest.approx(np.log(1 / 0.07))
    assert fresh.text_mix.weight.shape == (1, MAX_LEN, 1) and float(fresh.visual_mix.bias) == 0


@pytest.mark.parametrize("lambdas", [(0.1, 0.1), (0.5, 0.0)], ids=["default", "cls_only"])
def test_clip_contrastive_loss_matches_jax(lambdas):
    rs = np.random.RandomState(5)
    b = 6
    text, visual = (rs.standard_normal((b, 32)).astype(np.float32) for _ in range(2))
    cls_out = rs.standard_normal((b, MAX_LEN, 95)).astype(np.float32)
    pos_out = rs.standard_normal((b, MAX_LEN, MAX_LEN)).astype(np.float32)
    target = rs.randint(0, 95, (b, MAX_LEN)).astype(np.int32)
    scale = np.float32(np.log(1 / 0.07))
    want_loss, want = j_clip_loss(*(jnp.asarray(a) for a in (text, visual, scale, cls_out,
                                                               pos_out, target)), *lambdas)
    loss, got = clip_contrastive_loss(T(text), T(visual), torch.tensor(scale), T(cls_out),
                                      T(pos_out), T(target), *lambdas)
    assert set(got) == set(want) and len(got) == 7
    U.assert_close(loss, np.asarray(want_loss), 1e-5, 1e-6, "loss")
    for k in want:
        U.assert_close(got[k], np.asarray(want[k]), 1e-5, 1e-6, k)


def assert_params_close(got_sd, want_sd) -> None:
    """Every parameter within 1e-6 absolute, but the key projection's bias
    (rows emb..2·emb of each in_proj_bias) within 2·lr: its gradient is 0
    in exact arithmetic (the softmax over keys ignores a shift common to
    all of them), so each side's first Adam update lr·g/(|g| + 1e-8) follows
    the sign and size of its own rounding noise, anywhere inside ±lr."""
    assert set(got_sd) == set(want_sd)
    emb = LE["emb_dim"]
    for k, want in want_sd.items():
        got, want = got_sd[k].detach(), torch.as_tensor(want)
        if k.endswith("in_proj_bias"):
            U.assert_close(got[emb:2 * emb], want[emb:2 * emb].numpy(), 0, 2 * LR,
                           k + " (keys)")
            got, want = torch.cat([got[:emb], got[2 * emb:]]), torch.cat([want[:emb],
                                                                          want[2 * emb:]])
        U.assert_close(got, want.numpy(), 0, 1e-6, k)


def _jax_step(params, vparams, images, ids):
    from pretrain import make_pretrain_step

    opt = optax.adamw(LR)
    step = make_pretrain_step(JPretrain(**LE), JViTSTR(**VIS), vparams, opt, 0.1, 0.1,
                              mesh=None)
    state, loss, parts = step(JTrainState.create(params, opt), jnp.asarray(images),
                              jnp.asarray(ids))
    return state.params, float(loss), {k: float(v) for k, v in parts.items()}


def test_pretrain_step_matches_jax(models):
    _, params, _, vparams, _, _ = models
    images, ids = _inputs(8, seed=6)
    new_params, want_loss, want = _jax_step(params, vparams, images, ids)
    pm = U.load_port(LabelEncoderPretrain(**LE), convert.label_encoder_pretrain_from_jax(params))
    pv = U.load_port(ViTSTREncoder(**VIS), convert.vitstr_from_jax(vparams))
    opt = pretrain.make_optimizer(pm.train(), LR)
    assert opt.defaults["weight_decay"] == 1e-4
    loss, got = pretrain.make_pretrain_step(pm, pv, opt)(T(images), T(ids))
    U.assert_close(loss, want_loss, 1e-5, 1e-7, "loss")
    for k, v in want.items():
        U.assert_close(got[k], v, 1e-5, 1e-7, k)
    want_sd = convert.label_encoder_pretrain_from_jax(new_params)
    got_sd = pm.state_dict()
    assert_params_close(got_sd, want_sd)
    before = convert.label_encoder_pretrain_from_jax(params)
    # every parameter updated (weight decay included)
    assert all(not torch.equal(got_sd[k], before[k]) for k in want_sd)


_CHILD = r"""
import json, os, sys
import numpy as np, torch
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
from test_torch_pretrain import one_step
from udifftext_tpu_torch.parallel import dist

torch.set_num_threads(1)
dev = dist.maybe_init_distributed("cpu")
rank, world = dist.rank_and_world()
assert world == 2
loss, parts, sd = one_step(rank, world)
if rank == 0:
    torch.save({"loss": loss, "parts": parts, "sd": sd}, sys.argv[2])
torch.distributed.destroy_process_group()
"""


def one_step(rank: int, world: int):
    """One pretraining step of the port on this process's rows of the
    global batch of 8 (seeded weights: `build_models` with seed 0)."""
    model, visual = pretrain.build_models(TINY_CFGS, "cpu", seed=0)
    images, ids = _inputs(8, seed=7)
    per = 8 // world
    rows = slice(rank * per, (rank + 1) * per)
    step = pretrain.make_pretrain_step(model, visual, pretrain.make_optimizer(model, LR))
    loss, parts = step(T(images[rows]), T(ids[rows]))
    return float(loss), {k: float(v) for k, v in parts.items()}, model.state_dict()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_match_one(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2")
    out = tmp_path / "rank0.pt"
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(REPO), str(out)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        results = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    got = torch.load(out, weights_only=True)
    loss, parts, sd = one_step(0, 1)
    assert got["loss"] == pytest.approx(loss, rel=1e-6)
    for k, v in parts.items():
        assert got["parts"][k] == pytest.approx(v, rel=1e-6, abs=1e-7), k
    assert_params_close(got["sd"], sd)
    # a matrix over each process's 4 rows alone would be another loss
    half, _, _ = one_step(0, 2)
    assert abs(half - loss) > 1e-3


def test_synthetic_label_batches():
    a, b = SyntheticLabelBatches(2, 3, size=16, max_len=MAX_LEN, seed=1), \
        SyntheticLabelBatches(2, 3, size=16, max_len=MAX_LEN, seed=1)
    assert len(a) == 2 and len(list(a)) == 2
    x = a.batches[0]
    assert x["image"].shape == (3, 16, 16, 1) and x["image"].dtype == np.float32
    assert x["label_ids"].shape == (3, MAX_LEN) and 0 <= x["image"].min() <= x["image"].max() <= 1
    assert all(1 <= len(t) <= MAX_LEN for t in x["text"])
    assert np.array_equal(x["image"], b.batches[0]["image"]) and x["text"] == b.batches[0]["text"]
    assert glyph_table().shape == (94, 7, 6)


def test_pretrain_main_writes_a_checkpoint_it_restores(tmp_path, capsys):
    cfgs = dict(TINY_CFGS, ckpt_dir=str(tmp_path / "ckpt"))
    batches = SyntheticLabelBatches(2, 4, size=16, max_len=MAX_LEN, seed=2)
    state = pretrain.main(cfgs, batches, device="cpu", seed=3, log_every=1)
    out = capsys.readouterr().out
    assert state.step == 2 and "seed: 3" in out and "epoch 0 step 2 loss" in out
    assert [r["step"] for r in state.history] == [1, 2]
    assert all(np.isfinite(r["loss/full_loss"]) for r in state.history)
    path = train_ckpt.latest_checkpoint(str(tmp_path / "ckpt" / pretrain.CKPT_SUBDIR))
    assert path and path.endswith("step_00000002.pt")
    model, visual = pretrain.build_models(cfgs, "cpu", seed=3)
    fresh = pretrain.PretrainState(model, visual, pretrain.make_optimizer(model, LR))
    assert train_ckpt.restore_checkpoint(path, model, fresh) == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    saved = fresh.optimizer.state_dict()["state"]
    for i, st in state.optimizer.state_dict()["state"].items():
        assert all(torch.equal(v, saved[i][k]) for k, v in st.items())
    # the frozen ViTSTR: the same seed's weights, no gradient
    assert all(torch.equal(a, b) for a, b in zip(visual.parameters(), state.visual.parameters()))
    assert not any(p.requires_grad for p in state.visual.parameters())


def test_pretrain_cli_on_label_dataset(tmp_path):
    """`python -m udifftext_tpu_torch.pretrain --steps 2 --device cpu` on the
    config's LabelDataset (Pillow, the bundled font) writes its checkpoint;
    without a GPU and without the flag it stops with a message."""
    cfgs = dict(TINY_CFGS, ckpt_dir=str(tmp_path / "ckpt"), check_freq=5,
                dataset={"params": {"size": 16, "length": 40, "min_len": 1,
                                    "max_len": MAX_LEN}})
    cfg_path = tmp_path / "pretrain.yaml"
    cfg_path.write_text(yaml.safe_dump(json.loads(json.dumps(cfgs))))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "udifftext_tpu_torch.pretrain", "--config", str(cfg_path)]
    res = subprocess.run(cmd + ["--steps", "2", "--device", "cpu"], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=180)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "saved " in res.stdout and "seed: " in res.stdout
    path = train_ckpt.latest_checkpoint(str(tmp_path / "ckpt" / pretrain.CKPT_SUBDIR))
    assert path and path.endswith("step_00000002.pt")
    if not torch.cuda.is_available():
        res = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=str(tmp_path),
                             timeout=120)
        assert res.returncode != 0 and "--device cpu" in res.stderr


def test_pretrain_defaults_to_the_gpu():
    import inspect

    for fn in (pretrain.build_models, pretrain.main):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            pretrain.build_models(TINY_CFGS)


def test_smoke_run_config_is_pretrain_yaml():
    """chip_smoke.py's configs/pretrain.yaml (the card's machine has no
    PyYAML) equals the file, and the port's `build_models` reads it as the
    JAX package's does (built on the meta device: full width)."""
    import chip_smoke
    from pretrain import build_models as j_build_models

    with open(REPO / "configs" / "pretrain.yaml") as f:
        assert chip_smoke.PRETRAIN_RUN == yaml.safe_load(f)
    jm, jv, _, _ = j_build_models(chip_smoke.PRETRAIN_RUN)
    model, visual = pretrain.build_models(chip_smoke.PRETRAIN_RUN, "meta")
    assert model.encoder.label_embedding.weight.shape == (95, jm.emb_dim)
    assert len(model.encoder.encoder.layers) == jm.n_trans_layers == 12
    assert model.encoder.encoder.layers[0].self_attn.num_heads == jm.n_heads
    assert model.text_fc.out_features == jm.clip_dim and model.pos_fc.out_features == jm.max_len
    assert model.visual_mix.weight.shape == (1, jm.visual_len, 1) and jm.visual_len == 197
    assert model.visual_fc.in_features == jm.visual_dim == jv.embed_dim
    assert visual.pos_embed.shape == (1, jm.visual_len, jv.embed_dim)
    assert visual.patch_embed.proj.weight.shape == (jv.embed_dim, jv.in_chans, jv.patch_size,
                                                    jv.patch_size)
    assert len(visual.blocks) == jv.depth and visual.blocks[0].attn.num_heads == jv.num_heads
