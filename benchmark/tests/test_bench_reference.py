"""The plain reference held to the program at the tiny graph on the CPU, both
in float32 on the same seeded weights: the networks, a served group's search
scores and images, and a fine-tuning micro-batch's loss and gradients."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from benchmark.judge import train_numbers
from benchmark.reference.engine import CHARSET, Reference, train_steps
from benchmark.run import (group_draws, load_program_weights, seeded_weights, serve_batch,
                           train_feed)
from benchmark.tests.tiny import tiny_cell
from benchmark import traffic

SEED = 2**31 + 99
CPU = torch.device("cpu")


def _pair(name: str, train: bool = False):
    from udifftext_tpu_torch.builders import build_engine
    cell = tiny_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["unet_dtype"] = "float32"
    torch.manual_seed(0)
    engine = build_engine(cfg["graph"], torch.float32, CPU, train=train, attn_impl="plain").engine
    load_program_weights(engine, cfg, SEED, CPU, train)
    ref = Reference(cfg, CPU, seeded_weights(cfg, SEED, CPU, train))
    return cell, cfg, engine, ref


def test_networks_agree():
    _, cfg, engine, ref = _pair("serve-saturated")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 16, 9, generator=g)
    t = torch.tensor([3.0, 801.0])
    ctx = torch.randn(2, 12, 32, generator=g)
    with torch.no_grad():
        out, maps = engine.unet(x, t, ctx, capture_attn=True)
        r_out, r_maps = ref.nets.unet(x.permute(0, 3, 1, 2), t, ctx)
        assert torch.allclose(out, r_out.permute(0, 2, 3, 1), atol=1e-4, rtol=1e-4)
        assert sorted(maps) == sorted(r_maps)
        for k in maps:
            assert torch.allclose(maps[k], r_maps[k], atol=1e-5)
        img = torch.rand(2, 32, 32, 3, generator=g) * 2 - 1
        mom = engine.vae.encode_moments(img)
        mean, std = ref.nets.vae.encode(img.permute(0, 3, 1, 2))
        assert torch.allclose(mom[..., :4], mean.permute(0, 2, 3, 1), atol=1e-4, rtol=1e-4)
        assert torch.allclose(torch.exp(0.5 * mom[..., 4:].clamp(-30, 20)), std.permute(0, 2, 3, 1),
                              atol=1e-4, rtol=1e-4)
        z = torch.randn(2, 16, 16, 4, generator=g)
        assert torch.allclose(engine.vae.decode(z), ref.nets.vae.decode(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
                              atol=1e-4, rtol=1e-4)
        ids = torch.randint(0, 95, (2, 12), generator=g)
        assert torch.allclose(engine.label_encoder(ids), ref.nets.label_encoder(ids), atol=1e-4, rtol=1e-4)


def test_served_group_agrees():
    from udifftext_tpu_torch.predict import Predictor
    from udifftext_tpu_torch.serving import InpaintRequest, InpaintService
    cell, cfg, engine, ref = _pair("serve-saturated")
    smp = cfg["sampler"]
    reqs = traffic.requests(cell.traffic, SEED, cfg["image_size"], CHARSET)[:2]
    service = InpaintService(lambda b, k: None, max_batch=2, size=32, seq_len=12)
    rows = [service.build_row(InpaintRequest(r.image, r.mask, r.text)) for r in reqs]
    service.shutdown()
    arr = service.batch_of(rows)
    post, noise = group_draws(SEED, 3, 2, 16, smp["noise_iters"], CPU)
    pred = Predictor(engine, num_steps=smp["num_steps"], cfg_scale=smp["cfg_scale"],
                     noise_iters=smp["noise_iters"])
    images, aux = pred(arr, posterior_eps=post, noise=noise)
    batch = serve_batch(cfg, reqs, 2, CPU)
    for k in ("image", "label_ids", "seg_mask"):
        assert np.array_equal(np.asarray(arr[k]), batch[k].numpy().astype(np.asarray(arr[k]).dtype))
    r_scores = ref.search_scores(batch, post, noise, smp["cfg_scale"])
    assert torch.allclose(aux["noise_scores"], r_scores, atol=1e-5)
    choice = int(torch.argmin(aux["noise_scores"]))
    r_images = ref.sample_rows(batch, post, noise[choice], smp["num_steps"], smp["cfg_scale"])
    assert (images.int() - r_images.int()).abs().max() <= 1


def test_fine_tuning_agrees():
    from udifftext_tpu_torch.parallel.train import TrainState, train_step
    from udifftext_tpu_torch.train import batch_keys
    cell, cfg, engine, ref = _pair("finetune-b16x4", train=True)
    keys = batch_keys(engine)
    feeds = [train_feed(cell, SEED, s, CPU) for s in range(2)]
    state = TrainState.create(engine, base_lr=5e-5)
    losses, grad1 = [], None
    start = {n: p.detach().clone() for n, p in state.params.items()}
    for micro in feeds:
        loss, _ = train_step(state, micro, lambda mb: engine.loss(
            {k: mb[k] for k in keys if k in mb}, image_eps=mb["image_eps"], masked_eps=mb["masked_eps"],
            ucg_keep=mb["ucg_keep"], sigma_idx=mb["sigma_idx"], noise=mb["noise"]))
        losses.append(float(loss))
        if grad1 is None:
            grad1 = {n: state.optimizer.state[p]["exp_avg"] / 0.1 for n, p in state.params.items()}
    out = train_steps(ref, feeds, ("t_attn", "t_norm"), 5e-5)
    assert losses == pytest.approx(out["losses"], rel=1e-5)
    assert sorted(grad1) == sorted(out["grad1"])
    for n, g in grad1.items():
        assert torch.allclose(g, out["grad1"][n], atol=1e-6, rtol=1e-3), n
    # Adam moves an element with a near-zero gradient by ±lr on its sign,
    # so the leaves' changes are compared by their norms
    prog = {"losses": losses, "grad1": grad1, "start": start,
            "end": {n: p.detach() for n, p in state.params.items()}}
    numbers = train_numbers(prog, out)
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-3
    assert numbers["change_gap"] < 1e-2
