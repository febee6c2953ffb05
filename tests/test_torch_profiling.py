"""The port's profiling surface against the JAX package, on the CPU.

`udifftext_tpu_torch.utils.profiling.flops_of` is held to the JAX
`flops_of` (XLA's cost analysis) exactly on a lone matmul and on a 3×3
convolution with VALID padding, in operations and in bytes. With SAME
padding XLA leaves the padded taps out of its count and the port counts every
tap (a difference by design), so there the bytes are compared and the
operations against the full-tap count. On the tiny UNet (the meta device,
where no kernel wrapper launches) the count equals, as an integer, 2 × the
multiply-adds of every `dot_general` and `conv_general_dilated` in the jaxpr
of the JAX UNet's forward of the same config. The step-floor probe's layer
list, read from the port's UNet plan, is held to the JAX UNet's transformer
layers (their outputs' resolution and width, from `capture_intermediates`
under `jax.eval_shape`) at the tiny and (marked slow: a trace of the whole
graph) the shipped config. `trace` must write a Chrome trace that names the
matmul it saw; asked for the card's activity alone, it needs a card.
"""

import glob
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_port_util  # noqa: F401  (one intra-op thread)
from udifftext_tpu.models.attention import SpatialTransformer as JaxSpatialTransformer
from udifftext_tpu.models.unet import UNetModel as JaxUNet
from udifftext_tpu.utils import profiling as jax_profiling
from udifftext_tpu_torch.models.unet import UNetModel
from udifftext_tpu_torch.scripts.step_floor_probe import layer_list
from udifftext_tpu_torch.utils.profiling import flops_of, trace

TINY = dict(model_channels=32, attention_resolutions=(2, 1), num_res_blocks=1,
            channel_mult=(1, 2), num_head_channels=8, t_context_dim=32)
SHIPPED = {}  # every field at its default: the shipped graph's UNet


def _arrays(seed, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(s).astype(np.float32) for s in shapes]


def test_flops_of_lone_matmul_equals_jax():
    a, b = _arrays(0, (64, 128), (128, 32))
    want = jax_profiling.flops_of(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    got = flops_of(F.linear, torch.from_numpy(a), torch.from_numpy(b).t().contiguous())
    assert want == {"flops": 524288.0, "bytes_accessed": 57344.0}
    assert got == want


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_flops_of_conv3x3_against_jax(padding):
    x, w = _arrays(1, (2, 16, 16, 8), (3, 3, 8, 4))  # NHWC, HWIO
    want = jax_profiling.flops_of(
        lambda a, k: jax.lax.conv_general_dilated(a, k, (1, 1), padding,
                                                  dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    pad = 0 if padding == "VALID" else 1
    # the port's NHWC convolution: a channels-last view into F.conv2d and back
    got = flops_of(lambda: F.conv2d(xt.permute(0, 3, 1, 2), wt, None, 1, pad).permute(0, 2, 3, 1))
    assert got["bytes_accessed"] == want["bytes_accessed"]
    if padding == "VALID":
        assert got["flops"] == want["flops"] == 2 * 2 * 14 * 14 * 4 * 3 * 3 * 8
    else:  # every tap of the padded input, where XLA counts only the real ones
        assert got["flops"] == 2 * 2 * 16 * 16 * 4 * 3 * 3 * 8 == 294912
        assert want["flops"] == 270848


def _jaxpr_macs(jaxpr) -> int:
    """Multiply-adds of every dot_general and conv_general_dilated in a
    jaxpr, sub-jaxprs included (a scan's body times its length)."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        out = eqn.outvars[0].aval.shape
        if name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += math.prod(out) * math.prod(lhs[i] for i in lc)
        elif name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            o_dim = eqn.params["dimension_numbers"].rhs_spec[0]
            total += math.prod(out) * math.prod(rhs) // rhs[o_dim]
        times = eqn.params.get("length", 1) if name == "scan" else 1
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    total += times * _jaxpr_macs(inner)
    return total


def test_flops_of_tiny_unet_equals_jaxpr_macs():
    b, side, ctx_len = 2, 16, 12
    jm = JaxUNet(**TINY)
    args = (jnp.zeros((b, side, side, 9)), jnp.zeros((b,)), jnp.zeros((b, ctx_len, 32)))
    # init runs the forward once; drawing the parameters takes no product
    jaxpr = jax.make_jaxpr(lambda *a: jm.init_with_output(jax.random.PRNGKey(0), *a))(*args)
    want = 2 * _jaxpr_macs(jaxpr.jaxpr)

    with torch.device("meta"):
        unet = UNetModel(**TINY, attn_impl="plain").requires_grad_(False)
    x, ts, ctx = (torch.empty(s, device="meta") for s in ((b, side, side, 9), (b,),
                                                          (b, ctx_len, 32)))
    with torch.no_grad():
        got = flops_of(unet, x, ts, ctx)
    assert want > 0 and got["flops"] == want


def _jax_transformer_layers(kwargs, side):
    """(side, width) of every SpatialTransformer output of the JAX UNet."""
    jm = JaxUNet(**kwargs)
    args = (jnp.zeros((1, side, side, 9)), jnp.zeros((1,)),
            jnp.zeros((1, 12, jm.t_context_dim)))

    def layers():
        _, state = jm.init_with_output(jax.random.PRNGKey(0), *args,
                                       capture_intermediates=lambda m, _: isinstance(
                                           m, JaxSpatialTransformer))
        return state["intermediates"]

    found = []
    for leaf in jax.tree_util.tree_leaves(jax.eval_shape(layers)):
        if len(leaf.shape) == 4:
            found.append((leaf.shape[1], leaf.shape[3]))
    return sorted(found)


@pytest.mark.parametrize("name,kwargs,side", [
    ("tiny", TINY, 16),
    # a trace of the shipped graph (abstract, ~6 s): kept out of the quick run
    pytest.param("shipped", SHIPPED, 64, marks=pytest.mark.slow)])
def test_step_floor_layer_list_matches_jax_unet(name, kwargs, side):
    with torch.device("meta"):
        unet = UNetModel(**kwargs)
    layers = layer_list(unet, side)
    got = sorted((lay.side, lay.channels) for lay in layers for _ in range(lay.count))
    assert got == _jax_transformer_layers(kwargs, side)
    if name == "shipped":  # the JAX probe's hand-written LAYERS
        assert [(lay.name, lay.count, lay.side, lay.channels) for lay in layers] == [
            ("ds1", 5, 64, 320), ("ds2", 5, 32, 640), ("ds4", 5, 16, 1280), ("mid", 1, 8, 1280)]


def test_trace_writes_a_chrome_trace_naming_the_matmul(tmp_path):
    a, b = torch.randn(32, 64), torch.randn(16, 64)
    with trace(str(tmp_path)) as prof:
        F.linear(a, b)
    names = {e.key for e in prof.key_averages()}
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert "aten::mm" in names
    assert any(e.get("name") == "aten::mm" for e in events)


def test_trace_of_the_card_alone_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        with trace(None, host=False):
            pass
