"""The yardstick's operation counts tied to the program's own count
(`utils.profiling.flops_of`, torch's flop counter on the meta device): one
UNet row at 64² is 0.7987 TFLOP and a 512² decode 2.515 TFLOP at the
shipped widths; the tiny graph's counts agree too."""

from __future__ import annotations

import pytest
import torch

from benchmark import flops
from benchmark.tests.tiny import ROOT, tiny_cell
from benchmark.run import load_cell


def _program_counts(graph: dict, size: int):
    from udifftext_tpu_torch.builders import build_engine
    from udifftext_tpu_torch.utils.profiling import flops_of
    e = build_engine(graph, torch.bfloat16, "meta").engine
    net, vae, le = flops.graph_parts(graph)
    lat = size // 2 ** (len(vae["ddconfig"]["ch_mult"]) - 1)
    meta = {"device": "meta"}
    with torch.no_grad():
        x = torch.zeros(1, lat, lat, net["in_channels"], dtype=torch.bfloat16, **meta)
        ctx = torch.zeros(1, le["max_len"], net["t_context_dim"], **meta)
        return {
            "unet": flops_of(lambda: e.unet(x, torch.zeros(1, **meta), ctx))["flops"],
            "decode": flops_of(lambda: e.vae.decode(torch.zeros(1, lat, lat, 4, **meta)))["flops"],
            "encode": flops_of(lambda: e.vae.encode_moments(torch.zeros(1, size, size, 3, **meta)))["flops"],
            "label": flops_of(lambda: e.label_encoder(
                torch.zeros(1, le["max_len"], dtype=torch.long, **meta)))["flops"],
        }


def _counts(graph: dict, size: int):
    net, vae, le = flops.graph_parts(graph)
    lat = size // 2 ** (len(vae["ddconfig"]["ch_mult"]) - 1)
    return {
        "unet": flops.forward(flops.unet_ops(net, 1, lat, lat, le["max_len"])),
        "decode": flops.vae_decode(vae["ddconfig"], vae["embed_dim"], 1, lat, lat),
        "encode": flops.vae_encode(vae["ddconfig"], vae["embed_dim"], 1, size, size),
        "label": flops.label_encoder(le, 1),
    }


@pytest.mark.parametrize("which", ["shipped", "tiny"])
def test_counts_tie_to_the_programs_flop_counter(which):
    cell = load_cell(ROOT, "serve-saturated") if which == "shipped" else tiny_cell("serve-saturated")
    cfg = cell.config
    assert _counts(cfg["graph"], cfg["image_size"]) == _program_counts(cfg["graph"], cfg["image_size"])


def test_published_sizes():
    cfg = load_cell(ROOT, "serve-saturated").config
    c = _counts(cfg["graph"], 512)
    assert round(c["unet"] / 1e12, 4) == 0.7987
    assert round(c["decode"] / 1e12, 3) == 2.515


def test_group_and_step_totals():
    cfg = load_cell(ROOT, "serve-saturated").config
    g = cfg["graph"]
    c = _counts(g, 512)
    net = g["network_config"]["params"]
    kv = flops.forward(flops.unet_ops(net, 16, 64, 64, 12)) - flops.forward(
        flops.unet_ops(net, 16, 64, 64, 12, with_kv=False))
    group = flops.serve_group(g, 8, 512, 50, 10)
    # 70 UNet evals of 16 rows, the context K/V twice, conditioning and decode of 8
    expect = 70 * (16 * c["unet"] - kv) + 2 * kv + 8 * (c["label"] + c["encode"] + c["decode"])
    assert group == pytest.approx(expect, rel=1e-12)
    step = flops.train_micro_batch(g, 16, 512)
    ops = flops.unet_ops(net, 16, 64, 64, 12)
    assert flops.forward(ops) == pytest.approx(16 * c["unet"], rel=1e-12)
    # the backward of the trainable branches costs less than twice the forward
    assert flops.forward(ops) < flops.backward(ops) < 2 * flops.forward(ops)
    assert step == pytest.approx(16 * (2 * c["encode"] + c["label"]) + flops.forward(ops)
                                 + flops.backward(ops), rel=1e-12)


def test_kernel_work():
    f, b = flops.flash_fwd_work(2, 5, 4096, 64)
    assert f == 4 * 2 * 5 * 4096 * 4096 * 64 and b > 0
    assert flops.flash_bwd_work(2, 5, 4096, 64)[0] == 2.5 * f
    f, _ = flops.geglu_work(8192, 320)
    assert f == 24 * 8192 * 320 * 320
    assert flops.least_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert flops.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
