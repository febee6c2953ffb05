"""The OCR loss term of fine-tuning on the port, on the CPU, fp32, on the
tiny model graph with `ocr_enabled: true` and a tiny PARSeq (dim 64,
encoder depth 2, 9 greedy steps): `engine.loss` and its UNet gradients
against the JAX engine's on shared weights with the JAX key's draws
injected; `build_engine` accepting the term and freezing PARSeq; the PARSeq
checkpoint read by name through `loading`; the loop on batches collated by
the port's `data.loader.collate`.

Tolerances: the loss components 1e-4 relative, the gradients 1e-4 of each
tensor's largest entry, as `tests/test_torch_train.py` holds `engine.loss`
(fp32 through the UNet, here also through the VAE decoder and PARSeq).
`lambda_ocr_loss` is 0.5 in these tests (0.001 as shipped), so that the
OCR term's share of the UNet gradient is well above that tolerance.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from test_torch_ocr import parseq_params
from test_torch_train import _jax_loss_draws, _seg_batch
from udifftext_tpu import loading as jax_loading
from udifftext_tpu.builders import build_diffusion_engine
from udifftext_tpu.models.parseq import PARSeq as JPARSeq
from udifftext_tpu.models.parseq import ParseqTokenizer
from udifftext_tpu.ocr import ParseqPredictor as JPredictor
from udifftext_tpu_torch import loading
from udifftext_tpu_torch.builders import (
    TEXTDESIGN_SD_2_TRAIN,
    EngineBundle,
    SamplerSettings,
    build_engine,
    randomize_parameters,
)
from udifftext_tpu_torch.data.loader import collate
from udifftext_tpu_torch.diffusion.loss import FullLossConfig
from udifftext_tpu_torch.models.parseq import PARSeq
from udifftext_tpu_torch.parallel.train import TrainState, trainable_mask
from udifftext_tpu_torch.train import train
from udifftext_tpu_torch.utils import convert

T = torch.from_numpy
TINY_PQ = dict(embed_dim=64, enc_depth=2, enc_num_heads=2, dec_num_heads=4, max_label_length=8)
LAMBDA_OCR = 0.5
PARSEQ_CKPT = "./checkpoints/predictors/parseq-bb5792a6.pt"


def ocr_cfg(ckpt_path=PARSEQ_CKPT):
    cfg = U.tiny_model_cfg()
    loss_p = cfg["loss_fn_config"]["params"]
    loss_p.update(ocr_enabled=True, lambda_ocr_loss=LAMBDA_OCR, predictor_config={
        "target": "sgm.modules.predictors.model.ParseqPredictor",
        "params": {"ckpt_path": str(ckpt_path)}})
    return cfg


def _ocr_batch(b: int, seed: int):
    """_seg_batch plus bbox rows and PARSeq ids of words of 'a', which the
    tiny PARSeq's head favors, so the per-sample loss stays below the 1.0
    clamp and the term carries a gradient."""
    nb = _seg_batch(b, seed)
    nb["r_bbox"] = np.array([[8, 24, 6, 26], [4, 30, 2, 31], [0, 32, 0, 32]][:b], np.int32)
    nb["parseq_label_ids"] = ParseqTokenizer().encode(["aaa", "aa", "a"][:b])
    return nb


@pytest.fixture(scope="module")
def engines():
    cfg = ocr_cfg()
    jb = build_diffusion_engine(cfg, unet_dtype=jnp.float32)
    je = dataclasses.replace(jb.engine, ocr_predictor=JPredictor(model=JPARSeq(**TINY_PQ)))
    params = U.engine_params(je, seed=13)
    params["parseq"] = parseq_params(JPARSeq(**TINY_PQ), 3, char_bias={"a": 6.0})
    pe = build_engine(cfg, torch.float32, "cpu", train=True).engine
    pe.parseq = PARSeq(**TINY_PQ).requires_grad_(False)
    U.load_port(pe, convert.engine_from_jax(params))
    return je, params, pe


def _port_grads(pe, nb, draws):
    pe.zero_grad(set_to_none=True)
    loss, parts = pe.loss(U.to_torch(nb), **{k: T(v) for k, v in draws.items()})
    loss.backward()
    return loss, parts, {n: p.grad.clone() for n, p in pe.unet.named_parameters()
                         if p.requires_grad}


def test_engine_loss_with_ocr_matches_jax(engines):
    je, params, pe = engines
    b, key = 2, jax.random.PRNGKey(2)
    nb = _ocr_batch(b, 2)
    (want_loss, want), grads = jax.jit(jax.value_and_grad(
        lambda p: je.loss(p, U.to_jax(nb), key), has_aux=True))(params)
    draws = _jax_loss_draws(key, b)
    loss, got, got_g = _port_grads(pe, nb, draws)
    assert set(got) == set(want) == {"loss/diff_loss", "loss/local_loss", "loss/ocr_loss",
                                     "loss/full_loss"}
    assert 0.0 < float(want["loss/ocr_loss"]) < 1.0
    for k in want:
        U.assert_close(got[k], want[k], 1e-4, 1e-4 * abs(float(want[k])), k)
    U.assert_close(loss, want_loss, 1e-4, 0, "loss")
    want_g = convert.unet_from_jax(jax.tree.map(np.asarray, grads["unet"]))
    for name, g in got_g.items():
        w = want_g[name].numpy()
        U.assert_close(g, w, 1e-4, 1e-4 * float(np.abs(w).max()), f"grad {name}")
    # nothing frozen got a gradient: the VAE decode and PARSeq ran under
    # autograd with their parameters frozen
    assert all(p.grad is None for n, p in pe.named_parameters() if not p.requires_grad)
    frozen_modules = list(pe.vae.parameters()) + list(pe.parseq.parameters())
    assert all(not p.requires_grad for p in frozen_modules)

    # the OCR term moved the gradient: without it the UNet gradient differs
    plain = dataclasses.replace(pe.loss_cfg, ocr_enabled=False)
    pe.loss_cfg, cfg = plain, pe.loss_cfg
    try:
        _, parts, no_ocr = _port_grads(pe, nb, draws)
    finally:
        pe.loss_cfg = cfg
    assert "loss/ocr_loss" not in parts
    rel = max(float((got_g[n] - no_ocr[n]).abs().max() / got_g[n].abs().max()) for n in got_g)
    assert rel > 1e-2, rel


def test_build_engine_accepts_the_ocr_term():
    """The shipped graph's loss node with ocr_enabled true builds (it was
    refused before): the engine holds PARSeq-base, frozen, fp32, outside
    the trainable set; the parseq checkpoint path comes from
    predictor_config."""
    bundle = build_engine(ocr_cfg(), torch.float32, "cpu", train=True)
    eng = bundle.engine
    assert isinstance(eng.parseq, PARSeq) and eng.parseq.embed_dim == 384
    assert len(eng.parseq.encoder.blocks) == 12 and eng.parseq.max_label_length == 25
    assert eng.loss_cfg == FullLossConfig(min_attn_size=8, lambda_ocr_loss=LAMBDA_OCR,
                                          ocr_enabled=True)
    assert bundle.ckpt_paths["parseq"] == PARSEQ_CKPT
    assert all(p.dtype == torch.float32 and not p.requires_grad for p in eng.parseq.parameters())
    mask = trainable_mask(eng.named_parameters(), ("t_attn", "t_norm"))
    assert any(mask.values())
    assert not any(v for n, v in mask.items() if n.startswith(("parseq.", "vae.")))
    state = TrainState.create(eng, use_ema=True)
    assert state.params and all(n.startswith("unet.") for n in state.params)
    assert set(state.ema) == set(state.params)
    assert eng.ocr_predictor.model is eng.parseq

    off = build_engine(U.tiny_model_cfg(), torch.float32, "cpu")
    assert off.engine.parseq is None and off.engine.ocr_predictor is None
    assert off.ckpt_paths["parseq"] is None
    other = ocr_cfg()
    other["loss_fn_config"]["params"]["predictor_config"]["target"] = "some.Other"
    with pytest.raises(NotImplementedError, match="ParseqPredictor"):
        build_engine(other, torch.float32, "cpu")


def test_shipped_train_graph_with_ocr_builds_its_loss_config():
    cfg = copy.deepcopy(TEXTDESIGN_SD_2_TRAIN)
    cfg["loss_fn_config"]["params"]["ocr_enabled"] = True
    # only the loss node matters here: shrink the UNet so the CPU build is quick
    net = cfg["network_config"]["params"]
    net.update(model_channels=32, channel_mult=[1], attention_resolutions=[1], num_res_blocks=1,
               num_head_channels=8, t_context_dim=32)
    cfg["conditioner_config"]["params"]["emb_models"][0]["params"].update(
        emb_dim=32, n_trans_layers=1)
    bundle = build_engine(cfg, torch.float32, "cpu", train=True)
    assert bundle.engine.loss_cfg.ocr_enabled and bundle.engine.loss_cfg.lambda_ocr_loss == 0.001
    assert bundle.ckpt_paths["parseq"] == PARSEQ_CKPT


def test_parseq_checkpoint_loads_by_name(tmp_path, capsys):
    """A parseq .pt written with torch.save (strhub's keys) loads into the
    engine's PARSeq bit-equal through loading.load_component_ckpts, matches
    what the JAX package's loader reads from the same file, and is not read
    when the graph has no OCR term."""
    src = randomize_parameters(PARSeq(), 5)
    path = tmp_path / "parseq.pt"
    torch.save(src.state_dict(), path)
    bundle = build_engine(ocr_cfg(path), torch.float32, "cpu")
    reports = loading.load_component_ckpts(bundle)
    assert "[parseq] loaded" in capsys.readouterr().out
    missing, unexpected, mismatched = reports["parseq"]
    assert missing == unexpected == mismatched == []
    got = bundle.engine.parseq.state_dict()
    assert all(torch.equal(got[k], v) for k, v in src.state_dict().items())

    jb = build_diffusion_engine(ocr_cfg(path), unet_dtype=jnp.float32)
    jparams = jax_loading.load_component_ckpts({}, jb, verbose=False)
    want = convert.parseq_from_jax(jax.tree.map(np.asarray, jparams["parseq"]))
    assert set(want) == set(got) and all(torch.equal(got[k], want[k]) for k in want)

    off_cfg = U.tiny_model_cfg()
    off_cfg["loss_fn_config"]["params"]["predictor_config"] = {"params": {"ckpt_path": str(path)}}
    assert "parseq" not in loading.load_component_ckpts(build_engine(off_cfg, torch.float32,
                                                                     "cpu"))


def test_train_loop_with_ocr_on_collated_batches(engines, tmp_path):
    """Two optimizer steps of the loop on batches made by the port's collate
    (label_ids, parseq_label_ids, r_bbox from the samples): the OCR term is
    logged and finite, PARSeq and the VAE stay bit-identical without a
    gradient, the trainable parameters move."""
    _, _, pe = engines
    samples = []
    for i in range(4):
        s = {k: v[0] for k, v in _seg_batch(1, 20 + i).items() if k != "label_ids"}
        s.update(label=["aaa", "aa", "a", "aab"][i], r_bbox=np.array([8, 24, 6, 26], np.int32))
        samples.append(s)
    batches = [collate(samples[:2]), collate(samples[2:])]
    assert batches[0]["parseq_label_ids"].shape == (2, 27)
    frozen = {n: p.detach().clone() for n, p in pe.named_parameters() if not p.requires_grad}
    before = {n: p.detach().clone() for n, p in pe.named_parameters() if p.requires_grad}
    cfgs = {"batch_size": 2, "base_learning_rate": 1e-3, "log_dir": str(tmp_path),
            "lightning": {"accumulate_grad_batches": 1, "max_epochs": 1}}
    state = train(cfgs, batches, EngineBundle(pe, SamplerSettings()), seed=0, log_every=1)
    assert state.step == 2
    rows = [json.loads(line) for line in open(tmp_path / "train_metrics.jsonl")]
    assert len(rows) == 2 and all(np.isfinite(r["loss/ocr_loss"]) and r["loss/ocr_loss"] > 0
                                  for r in rows)
    assert all(torch.equal(p, frozen[n]) for n, p in pe.named_parameters() if n in frozen)
    assert all(p.grad is None for n, p in pe.named_parameters() if n in frozen)
    assert all(not torch.equal(p, before[n]) for n, p in pe.named_parameters() if n in before)
    with torch.no_grad():
        for n, p in pe.named_parameters():
            if n in before:
                p.copy_(before[n])
