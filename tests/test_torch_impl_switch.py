"""The port's implementation switch (`impl` / `attn_impl`), on the CPU.

The JAX build has `sdpa(..., impl="auto"|"xla"|"flash")`,
`GEGLUFeedForward.impl` ("auto"|"fused"|"xla") and `attn_impl` on its
attention modules, the UNet and the VAE; the port carries the same switch
with "xla" spelled "plain". On the CPU every value gives the same function
(the kernel wrappers take their plain versions there), so the outputs agree
to fp32 summation order (1e-5) and no launch is counted; an unknown value
raises; the tiny UNet under "plain" still matches the JAX UNet built with
`attn_impl="xla"` on the same numpy weights at tests/test_torch_models.py's
tolerance (1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from udifftext_tpu.builders import build_diffusion_engine
from udifftext_tpu_torch.builders import build_engine
from udifftext_tpu_torch.models.attention import (
    BasicTransformerBlock,
    GEGLUFeedForward,
    SelfAttention,
    SpatialTransformer,
    geglu_auto_ok,
)
from udifftext_tpu_torch.models.unet import UNetModel
from udifftext_tpu_torch.models.vae import AutoencoderKL, VAEAttnBlock
from udifftext_tpu_torch.ops import sdpa
from udifftext_tpu_torch.ops.cross_attention import fused_cross_attention
from udifftext_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
from udifftext_tpu_torch.ops.geglu import geglu_ff, geglu_ff_ln
from udifftext_tpu_torch.ops.ln_gemm import ln_gemm, ln_gemm3
from udifftext_tpu_torch.utils import convert

RTOL, ATOL = 1e-5, 1e-5
T = torch.from_numpy
KERNELS = (flash_attention, flash_attention_bwd, geglu_ff, geglu_ff_ln, ln_gemm, ln_gemm3,
           fused_cross_attention)
ATTN_IMPLS = ("auto", "plain", "flash")


@pytest.fixture
def no_launches():
    """Nothing in the test may count a kernel launch."""
    before = [f.launches for f in KERNELS]
    yield
    assert [f.launches for f in KERNELS] == before


def _randn(seed, *shape):
    return T(np.random.RandomState(seed).standard_normal(shape).astype(np.float32))


def _same_weights(make, impls):
    """One module per impl, all with the first one's weights."""
    mods = [make(i).eval() for i in impls]
    for m in mods[1:]:
        assert list(m.state_dict()) == list(mods[0].state_dict())  # the keys do not depend on it
        m.load_state_dict(mods[0].state_dict())
    return mods


@pytest.mark.parametrize("shape", [(2, 128, 128, 2, 64), (1, 24, 40, 3, 16)])
def test_sdpa_impls_agree_on_cpu(no_launches, shape):
    b, nq, nk, h, d = shape
    q, k, v = _randn(0, b, nq, h, d), _randn(1, b, nk, h, d), _randn(2, b, nk, h, d)
    outs = [sdpa(q, k, v, impl=i) for i in ATTN_IMPLS]
    for got in outs[1:]:
        U.assert_close(got, outs[0].numpy(), RTOL, ATOL, "sdpa")
    U.assert_close(sdpa(q, k, v, 0.3, impl="flash"), sdpa(q, k, v, 0.3).numpy(), RTOL, ATOL, "scale")


@pytest.mark.parametrize("call", [
    lambda: sdpa(torch.zeros(1, 8, 1, 8), torch.zeros(1, 8, 1, 8), torch.zeros(1, 8, 1, 8),
                 impl="xla"),
    lambda: GEGLUFeedForward(8, impl="xla"),
    lambda: GEGLUFeedForward(8, impl="flash"),
    lambda: SelfAttention(8, 1, 8, attn_impl="fused"),
    lambda: BasicTransformerBlock(1, 8, attn_impl="xla"),
    lambda: SpatialTransformer(32, 1, 32, attn_impl="cudnn"),
    lambda: VAEAttnBlock(32, attn_impl="xla"),
    lambda: UNetModel(model_channels=32, channel_mult=(1,), attention_resolutions=(1,),
                      num_head_channels=32, t_context_dim=8, attn_impl="xla"),
    lambda: build_engine(U.tiny_model_cfg(), torch.float32, "cpu", attn_impl="xla"),
], ids=["sdpa", "ff-xla", "ff-flash", "self-attn", "block", "transformer", "vae-attn", "unet",
        "engine"])
def test_unknown_impl_raises(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("with_ln", [False, True])
def test_feed_forward_impls_agree_on_cpu(no_launches, with_ln):
    ffs = _same_weights(lambda i: GEGLUFeedForward(16, impl=i), ("auto", "plain", "fused"))
    x = _randn(3, 2, 24, 16)
    ln = (1 + 0.1 * _randn(4, 16), 0.1 * _randn(5, 16)) if with_ln else None
    with torch.no_grad():
        outs = [ff(x, ln=ln) for ff in ffs]
    for got in outs[1:]:
        U.assert_close(got, outs[0].numpy(), RTOL, ATOL, "feed-forward")


def test_auto_gate_keeps_fp32_and_the_cpu_off_the_kernel():
    assert not geglu_auto_ok(torch.zeros(1, 128, 64))
    assert not geglu_auto_ok(torch.zeros(1, 128, 64, dtype=torch.bfloat16))  # a CPU tensor
    meta = torch.zeros(1, 128, 64, dtype=torch.bfloat16, device="meta")
    assert not geglu_auto_ok(meta)


@pytest.mark.parametrize("fuse_glue", ["off", "force"])
def test_block_impls_agree_on_cpu(no_launches, fuse_glue):
    blks = _same_weights(lambda i: BasicTransformerBlock(2, 16, t_context_dim=24, fuse_qkv=True,
                                                         fuse_glue=fuse_glue, attn_impl=i),
                         ATTN_IMPLS)
    x, ctx = _randn(6, 2, 64, 32), _randn(7, 2, 5, 24)
    with torch.no_grad():
        outs = [b(x, ctx, None, True) for b in blks]
    for got, m in outs[1:]:
        U.assert_close(got, outs[0][0].numpy(), RTOL, ATOL, "block out")
        U.assert_close(m, outs[0][1].numpy(), RTOL, 1e-6, "block map")


def test_plain_disables_the_fused_glue_and_the_feed_forward_kernel():
    """`attn_impl="plain"` takes no fused branch under fuse_glue="auto" and
    hands "plain" on, as the JAX block does with "xla"; "force" still fuses."""
    def mk(attn_impl, fuse_glue="auto"):
        return BasicTransformerBlock(2, 16, t_context_dim=24, fuse_qkv=True,
                                     fuse_glue=fuse_glue, attn_impl=attn_impl)

    assert mk("auto").fuses(True, torch.bfloat16, 256)
    assert mk("flash").fuses(True, torch.bfloat16, 256)
    assert not mk("plain").fuses(True, torch.bfloat16, 256)
    assert not mk("auto").fuses(False, torch.bfloat16, 256)
    assert not mk("auto").fuses(True, torch.float32, 256)
    assert not mk("auto").fuses(True, torch.bfloat16, 200)
    assert mk("plain", "force").fuses(False, torch.float32, 7)
    plain, auto = mk("plain"), mk("flash")
    assert (plain.ff.impl, plain.attn1.attn_impl) == ("plain", "plain")
    assert (auto.ff.impl, auto.attn1.attn_impl) == ("auto", "flash")
    st = SpatialTransformer(32, 2, 16, depth=2, t_context_dim=24, attn_impl="plain")
    assert all(b.attn_impl == "plain" and b.ff.impl == "plain" for b in st.transformer_blocks)


@pytest.fixture(scope="module")
def engines():
    cfg = U.tiny_model_cfg()
    je = build_diffusion_engine(cfg, unet_dtype=jnp.float32).engine
    params = U.engine_params(je, seed=3)
    state = convert.engine_from_jax(params)
    pes = {i: U.load_port(build_engine(cfg, torch.float32, "cpu", attn_impl=i).engine, state)
           for i in ATTN_IMPLS}
    return je, params, pes


def test_build_engine_threads_attn_impl(engines):
    _, _, pes = engines
    for impl, pe in pes.items():
        assert pe.unet.attn_impl == impl and pe.vae.attn_impl == impl
        blocks = [m for m in pe.unet.modules() if isinstance(m, BasicTransformerBlock)]
        assert blocks and all(b.attn_impl == impl for b in blocks)
        attns = [m for m in pe.vae.modules() if isinstance(m, VAEAttnBlock)]
        assert attns and all(a.attn_impl == impl for a in attns)
    assert list(pes["plain"].state_dict()) == list(pes["auto"].state_dict())


def test_unet_and_vae_impls_agree_and_plain_matches_jax(no_launches, engines):
    je, params, pes = engines
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, U.LAT, U.LAT, 9)).astype(np.float32)
    t = np.array([999, 17], np.int32)
    ctx = rs.standard_normal((2, U.SEQ, 32)).astype(np.float32)
    img = rs.uniform(-1, 1, (2, U.IMG, U.IMG, 3)).astype(np.float32)
    z = rs.standard_normal((2, U.LAT, U.LAT, 4)).astype(np.float32)
    outs = {}
    with torch.no_grad():
        for impl, pe in pes.items():
            out, maps = pe.unet(T(x), T(t), T(ctx), capture_attn=True)
            outs[impl] = (out, maps, pe.vae.encode_moments(T(img)), pe.vae.decode(T(z)))
    for impl in ("plain", "flash"):
        U.assert_close(outs[impl][0], outs["auto"][0].numpy(), RTOL, ATOL, f"unet {impl}")
        for k, m in outs["auto"][1].items():
            U.assert_close(outs[impl][1][k], m.numpy(), RTOL, 1e-6, f"{impl} map {k}")
        U.assert_close(outs[impl][2], outs["auto"][2].numpy(), RTOL, ATOL, f"encode {impl}")
        U.assert_close(outs[impl][3], outs["auto"][3].numpy(), RTOL, ATOL, f"decode {impl}")
    junet = je.unet.clone(attn_impl="xla")
    want, _ = junet.apply(params["unet"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                          capture_attn=True)
    U.assert_close(outs["plain"][0], want, RTOL, ATOL, "plain UNet vs the JAX UNet under xla")
    jvae = je.vae.clone(attn_impl="xla")
    want = jvae.apply(params["vae"], jnp.asarray(z), method=type(jvae).decode)
    U.assert_close(outs["plain"][3], want, RTOL, ATOL, "plain VAE decode vs JAX under xla")
