"""`GroupNorm32` on the fused GroupNorm+SiLU kernel (`ops/groupnorm`), on the
CPU: the gate as a pure function of device, dtype, shape, contiguity and
grad state; `GroupNorm32`'s plain path bit for bit the eager version the
models ran before, SiLU folded in or not; the models' call sites (which
fold the SiLU in, which do not) with the gate forced open and the kernel
replaced by its plain version; `groupnorm_plan` at every GroupNorm shape of
the served and fine-tuned graphs; the "stream" route's order of operations
against the plain version; the counters and the benchmark's two readers of
them. The kernel itself is held on the card by
`tests/test_torch_groupnorm_card.py`."""

import collections
import importlib.util
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from udifftext_tpu_torch.builders import TEXTDESIGN_SD_2, build_engine
from udifftext_tpu_torch.models import layers
from udifftext_tpu_torch.models.attention import SpatialTransformer
from udifftext_tpu_torch.models.layers import GroupNorm32, set_norm_impl
from udifftext_tpu_torch.models.unet import ResBlock
from udifftext_tpu_torch.models.vae import DDConfig, Decoder, Encoder, VAEResnetBlock
from udifftext_tpu_torch.ops import groupnorm as GN
from udifftext_tpu_torch.scripts._engine import plain_twin
from udifftext_tpu_torch.utils import profiling
from udifftext_tpu_torch.utils.profiling import RECORDER

REPO = Path(__file__).resolve().parents[1]


# -- the gate ------------------------------------------------------------------------

BASE = dict(is_cuda=True, dtype=torch.bfloat16, shape=(16, 64, 64, 320), contiguous=True,
            aligned=True, records_grad=False, num_groups=32)


@pytest.mark.parametrize("change,want", [
    ({}, True),
    ({"dtype": torch.float32, "shape": (16, 512, 512, 128)}, True),
    ({"shape": (2, 4096, 320)}, True),                 # (B, N, C)
    ({"is_cuda": False}, False),                        # the CPU: plain
    ({"dtype": torch.float16}, False),
    ({"shape": (16, 320)}, False),
    ({"shape": (16, 0, 64, 320)}, False),               # no rows
    ({"shape": (16, 64, 64, 100)}, False),              # C % 32 != 0
    ({"shape": (16, 64, 64, 36), "num_groups": 4}, False),  # C % 8 != 0
    ({"shape": (2, 64, 8192)}, False),                  # C > 4096
    ({"shape": (70000, 4, 320)}, False),                # B > 65535
    ({"num_groups": 512, "shape": (2, 4, 512)}, False),
    ({"contiguous": False}, False),
    ({"aligned": False}, False),
    ({"records_grad": True}, False),                    # autograd would record the call
])
def test_gate_is_a_pure_function_of_the_call(change, want):
    assert GN.groupnorm_gate(**{**BASE, **change}) is want


def test_kernel_takes_no_cpu_tensor_and_agrees_with_the_kernels_limits():
    gn = GroupNorm32(320)
    for x in (torch.zeros(2, 8, 8, 320), torch.zeros(2, 8, 8, 320).bfloat16()):
        assert GN.groupnorm_silu_supported(x) and not GN.kernel_takes(x, gn.weight, gn.bias)
    with torch.device("meta"):  # no storage: the gate decides from the device alone
        x = torch.zeros(16, 64, 64, 320)
    assert not GN.kernel_takes(x, gn.weight.to("meta"), gn.bias.to("meta"))
    rs = torch.Generator().manual_seed(5)
    for _ in range(200):  # where the gate opens on shape, the kernel's own check agrees
        c = 8 * int(torch.randint(1, 600, (1,), generator=rs))
        g = int(torch.tensor([1, 4, 8, 16, 32, 64])[torch.randint(0, 6, (1,), generator=rs)])
        shape = (int(torch.randint(1, 5, (1,), generator=rs)), 3, c)
        dtype = (torch.float32, torch.bfloat16)[int(torch.randint(0, 2, (1,), generator=rs))]
        assert GN.groupnorm_gate(**{**BASE, "shape": shape, "dtype": dtype, "num_groups": g}) == \
            GN.groupnorm_silu_supported(torch.zeros(shape, dtype=dtype), g)


# -- GroupNorm32's plain path: the eager version, bit for bit ----------------------------


def _eager(gn: GroupNorm32, x: torch.Tensor) -> torch.Tensor:
    """`GroupNorm32.forward` as the models ran it before the kernel's gate."""
    c = x.shape[-1]
    g = gn.num_groups
    xf = x.reshape(x.shape[0], -1, g, c // g).float()
    mean = xf.mean(dim=(1, 3), keepdim=True)
    xc = xf - mean
    var = xc.square().mean(dim=(1, 3), keepdim=True)
    y = (xc * torch.rsqrt(var + gn.eps)).reshape(x.shape)
    return (y * gn.weight.float() + gn.bias.float()).to(x.dtype)


def _seeded_norm(c, eps=1e-5, seed=0):
    gen = torch.Generator().manual_seed(seed)
    gn = GroupNorm32(c, eps=eps)
    with torch.no_grad():
        gn.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=gen))
        gn.bias.copy_(0.1 * torch.randn(c, generator=gen))
    return gn, gen


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,dtype", [((2, 8, 8, 64), torch.float32),
                                         ((2, 8, 8, 64), torch.bfloat16),
                                         ((3, 50, 96), torch.float32)])
def test_groupnorm32_on_the_cpu_is_the_eager_version_bit_for_bit(shape, dtype, silu):
    gn, gen = _seeded_norm(shape[-1], eps=1e-6)
    x = (3.0 * torch.randn(*shape, generator=gen) + 1.0).to(dtype)
    want = F.silu(_eager(gn, x)) if silu else _eager(gn, x)
    before = RECORDER.counters()
    with torch.no_grad():
        assert torch.equal(gn(x, silu=silu), want)
    got = gn(x.requires_grad_(True), silu=silu)  # under autograd: the same, and differentiable
    assert torch.equal(got, want) and got.grad_fn is not None
    got.float().sum().backward()
    after = RECORDER.counters()
    assert after.get("groupnorm.plain", 0) == before.get("groupnorm.plain", 0) + 2
    assert after.get("groupnorm.kernel", 0) == before.get("groupnorm.kernel", 0)


def test_models_call_sites_unchanged_on_the_cpu():
    """The blocks whose SiLU folded into the norm compute what they did."""
    torch.manual_seed(0)
    blk = VAEResnetBlock(32, 64)
    x = torch.randn(2, 8, 8, 32)
    want = blk.conv2(F.silu(_eager(blk.norm2, blk.conv1(F.silu(_eager(blk.norm1, x))))))
    assert torch.equal(blk(x), blk.nin_shortcut(x) + want)
    res = ResBlock(32, 64, 16)
    with torch.no_grad():
        for p in res.parameters():
            p.normal_(0.0, 0.1)
    emb = torch.randn(2, 16)
    h = res.in_layers[2](F.silu(_eager(res.in_layers[0], x)))
    h = h + res.emb_layers[1](F.silu(emb))[:, None, None, :]
    h = res.out_layers[3](F.silu(_eager(res.out_layers[0], h)))
    assert torch.equal(res(x, emb), res.skip_connection(x) + h)


# -- the call sites with the gate forced open ---------------------------------------------


VAE_CFG = DDConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                   resolution=16, z_channels=4)


def test_call_sites_fold_the_silu_into_the_kernel(monkeypatch):
    """With the gate open (as for a CUDA tensor without autograd) every norm
    calls the kernel once, with SiLU where the model has one after it: the
    autoencoder's resnet norms and norm_out, the ResBlock's two norms, not
    the attention blocks' norms; the output is the plain path's."""
    calls = []

    def kernel(x, scale, bias, num_groups, eps, with_silu):
        calls.append(with_silu)
        return GN.fused_groupnorm_silu_ref(x, scale, bias, num_groups, eps, with_silu)

    torch.manual_seed(1)
    enc, dec = Encoder(VAE_CFG), Decoder(VAE_CFG)
    res = ResBlock(32, 32, 16)
    st = SpatialTransformer(32, 2, 16, t_context_dim=24)
    x, emb, ctx = torch.randn(2, 16, 16, 3), torch.randn(2, 16), torch.randn(2, 5, 24)
    with torch.no_grad():
        for p in list(res.parameters()) + list(st.parameters()):
            p.normal_(0.0, 0.1)
        plain = (enc(x), dec(torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(2))),
                 res(x.new_zeros(2, 8, 8, 32) + 0.5, emb), st(x.new_ones(2, 4, 4, 32), ctx)[0])
        monkeypatch.setattr(layers, "kernel_takes", lambda *a: True)
        monkeypatch.setattr(layers, "launch", kernel)
        before = RECORDER.counters().get("groupnorm.kernel", 0)
        fused = (enc(x), dec(torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(2))),
                 res(x.new_zeros(2, 8, 8, 32) + 0.5, emb), st(x.new_ones(2, 4, 4, 32), ctx)[0])
    # encoder: 2 resnet norms a block (3 blocks with mid), the attention norms of
    # level 1 and mid, norm_out; decoder: 2 levels of 2 blocks, mid, norm_out
    enc_n = sum(isinstance(m, GroupNorm32) for m in enc.modules())
    dec_n = sum(isinstance(m, GroupNorm32) for m in dec.modules())
    enc_attn = sum(m.__class__.__name__ == "VAEAttnBlock" for m in enc.modules())
    dec_attn = sum(m.__class__.__name__ == "VAEAttnBlock" for m in dec.modules())
    assert len(calls) == enc_n + dec_n + 2 + 1
    assert RECORDER.counters().get("groupnorm.kernel", 0) == before + len(calls)
    # no SiLU after the autoencoder's attention norms and the transformer's
    assert calls.count(False) == enc_attn + dec_attn + 1
    assert calls[enc_n + dec_n:] == [True, True, False]
    for got, want in zip(fused, plain):
        assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


def test_plain_impl_keeps_every_norm_off_the_kernel(monkeypatch):
    monkeypatch.setattr(layers, "kernel_takes", lambda *a: True)
    monkeypatch.setattr(layers, "launch", None)  # would raise if called
    enc = set_norm_impl(Encoder(VAE_CFG), "plain")
    with torch.no_grad():
        enc(torch.randn(1, 16, 16, 3))
    assert set_norm_impl(enc, "auto") is enc
    assert all(m.impl == "auto" for m in enc.modules() if isinstance(m, GroupNorm32))
    assert Decoder(VAE_CFG).norm_out.impl == "auto"

    def impls(module):
        return collections.Counter(m.impl for m in module.modules() if isinstance(m, GroupNorm32))

    # build_engine sets every norm of an engine built for attn_impl="plain" (the
    # UNet's 61, the autoencoder's 22 + 30), and a probe's plain twin is plain
    assert impls(build_engine(TEXTDESIGN_SD_2, torch.bfloat16, "meta",
                              attn_impl="plain").engine) == {"plain": 113}
    assert impls(build_engine(TEXTDESIGN_SD_2, torch.bfloat16, "meta").engine) == {"auto": 113}
    st = SpatialTransformer(32, 2, 16, t_context_dim=24)
    assert impls(plain_twin(st, lambda: SpatialTransformer(32, 2, 16, t_context_dim=24,
                                                           attn_impl="plain"))) == {"plain": 1}


# -- the plan at every GroupNorm shape of the served and fine-tuned graphs ------------------


def _shipped_norm_shapes():
    """(H·W or N, C, dtype) → calls of every GroupNorm32 in a UNet eval, an
    encode and a decode of the shipped graph, from a meta-device forward."""
    bundle = build_engine(TEXTDESIGN_SD_2, torch.bfloat16, "meta")
    e = bundle.engine
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(
        (tuple(a[0].shape[1:-1]), a[0].shape[-1], a[0].dtype)))
        for m in e.modules() if isinstance(m, GroupNorm32)]
    out = {}
    with torch.no_grad(), torch.device("meta"):
        unet = e.unet
        unet(torch.zeros(1, 64, 64, unet.in_channels, dtype=unet.dtype), torch.zeros(1),
             torch.zeros(1, 12, unet.t_context_dim, dtype=unet.dtype), None)
        out["unet"], seen[:] = collections.Counter(seen), []
        e.vae.encoder(torch.zeros(1, 512, 512, 3))
        out["encode"], seen[:] = collections.Counter(seen), []
        e.vae.decoder(torch.zeros(1, 64, 64, 4))
        out["decode"] = collections.Counter(seen)
    for h in hooks:
        h.remove()
    return out


# (H, W, C) → route, at the cells' rows: the UNet's 16 (served CFG-doubled
# groups of 8, fine-tuning micro-batches of 16), the autoencoder's 8 (served
# encode and decode) and 16 (fine-tuning encodes), and 1 (the demo)
UNET_STREAM = {(64, 64, 960)}  # C/G = 30: a 240-byte slice of 131-205 KB CTAs, one an SM
VAE_CLUSTER = {(64, 64, 512), (128, 128, 256)}  # 64- and 32-byte slices, three CTAs an SM


def test_plan_at_every_groupnorm_shape_of_both_configurations():
    shapes = _shipped_norm_shapes()
    assert sum(shapes["unet"].values()) == 61
    assert sum(shapes["encode"].values()) == 22 and sum(shapes["decode"].values()) == 30
    for part, rows in (("unet", (16, 20, 2)), ("encode", (16, 8, 1)), ("decode", (8, 1))):
        for (hw, c, dtype), _ in shapes[part].items():
            n = hw[0] * hw[1]
            for b in rows:
                plan = GN.groupnorm_plan(dtype, b, n, c)
                if part == "unet":
                    want = "stream" if hw + (c,) in UNET_STREAM else "cluster"
                else:
                    want = "cluster" if hw + (c,) in VAE_CLUSTER else "stream"
                assert plan.route == want, (part, hw, c, b, plan)
                assert plan.launches == (1 if want == "cluster" else 2)
                bound = GN.MAX_CLUSTER if want == "cluster" else GN.MAX_CHUNKS
                assert 1 <= plan.partials <= bound
                assert plan.rows * (plan.partials - 1) < n <= plan.rows * plan.partials
                if want == "stream":  # the grid fills the card: two blocks an SM or more
                    assert b * (32 // plan.slice_groups) * plan.partials >= 2 * GN.SMS - 8


# -- the "stream" route's order of operations ----------------------------------------------


@pytest.mark.parametrize("shape,groups,plan,offset", [
    ((2, 777, 64), 32, None, 0.0),                                          # ragged last chunk
    ((1, 4096, 128), 32, None, 0.0),                                        # 8-group slabs
    ((2, 300, 320), 32, GN.GroupNormPlan("stream", 4, 0, 97, 0, 2, 4), 0.0),  # cg = 10
    ((2, 40, 2048), 32, GN.GroupNormPlan("stream", 32, 0, 7, 0, 2, 6), 0.0),  # > 256 vectors a row
    ((2, 16, 16, 96), 4, None, 0.0),
    ((2, 16, 16, 64), 32, None, 1000.0),                                    # a large common offset
])
def test_stream_order_matches_the_plain_version_in_fp32(shape, groups, plan, offset):
    gen = torch.Generator().manual_seed(6)
    c = shape[-1]
    x = 2.0 * torch.randn(*shape, generator=gen) + offset
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen)
    bias = 0.1 * torch.randn(c, generator=gen)
    got = GN.fused_groupnorm_silu_stream_ref(x, scale, bias, groups, 1e-6, True, plan)
    want = GN.fused_groupnorm_silu_ref(x, scale, bias, groups, 1e-6, True)
    tol = 1e-3 if offset else 1e-5
    assert float((got - want).abs().max()) <= tol
    if offset:  # E[x²] − mean² would have lost the variance here
        xg = x.reshape(shape[0], -1, groups, c // groups)
        var = (xg * xg).mean(dim=(1, 3)) - xg.mean(dim=(1, 3)) ** 2
        assert float((var - 4.0).abs().max()) > 0.05


# -- the counters and the benchmark's readers ------------------------------------------------


def _reader(name):
    path = REPO / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", ["groupnorm.kernel_share.serve", "groupnorm.kernel_share.train"])
def test_kernel_share_readers_on_fabricated_counters(name, monkeypatch):
    read = _reader(name)
    monkeypatch.setattr(RECORDER, "counters", lambda: {"groupnorm.kernel": 188,
                                                       "groupnorm.plain": 232, "unet.evals": 4})
    assert read(None) == pytest.approx(100.0 * 188 / 420, rel=1e-12)
    monkeypatch.setattr(RECORDER, "counters", lambda: {"groupnorm.kernel": 3050})
    assert read(None) == 100.0
    monkeypatch.setattr(RECORDER, "counters", lambda: {"groupnorm.plain": 5})
    assert read(None) == 0.0
    monkeypatch.setattr(RECORDER, "counters", lambda: {"unet.evals": 4})  # the parent's program
    assert read(None) is None
    monkeypatch.delattr(profiling, "RECORDER")  # a program without the recorder
    assert read(None) is None


def test_benchmark_registers_the_kernel_share_readers():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for cell, moves in (("serve", ("serve-saturated", "serve_samples_per_s")),
                        ("train", ("finetune-b16x4", "train_samples_per_s"))):
        m = entries[f"groupnorm.kernel_share.{cell}"]
        assert (m["source"], m["layer"], m["unit"], m["better"]) == (
            "program_counter", "ops/groupnorm", "%", "higher")
        assert (m["workloads"], m["moves"]) == ([moves[0]], moves[1])
