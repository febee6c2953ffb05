"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. They build with nvcc from udifftext_tpu_torch/csrc on first use,
so these tests need an NVIDIA GPU (sm_90a) and skip elsewhere:

    python -m pytest tests/test_torch_kernels.py -q -m cuda

Tolerances: fp32 1e-5 relative (summation order); bf16 outputs within two
bf16 ulps of the largest reference value (one rounding of the output).
Gradients through autograd against the plain versions' autograd: bf16
within four ulps of the largest gradient (the kernel's delta reads the
bf16-rounded output, the plain softmax backward the fp32 one), fp32 1e-4
of the largest gradient. The tensor-core flash kernels ("mma" route) against
the tiled references that walk their tiles with their roundings: one bf16
ulp of the largest reference value (2**-8 of it, half the tolerance against
the plain versions: only the final rounding can fall the other way), 1e-5
for lse. The fused GroupNorm under a common offset of
1000: 1e-3 absolute (fp32 values there are 6e-5 apart and the two sides sum
their means in different orders)."""

import math

import pytest
import torch

from udifftext_tpu_torch.ops import attention as A
from udifftext_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_bwd_tiled_ref,
    flash_attention_ref,
    flash_attention_tiled_ref,
)
from udifftext_tpu_torch.models.attention import BasicTransformerBlock
from udifftext_tpu_torch.models.layers import cast_weights
from udifftext_tpu_torch.ops.cross_attention import (
    cross_attention_plan,
    cross_attention_supported,
    fused_cross_attention,
    fused_cross_attention_ref,
)
from udifftext_tpu_torch.ops.flash_variants import (
    CLAMP_EXP,
    CLAMP_V1,
    TILE_MENU,
    VARIANTS,
    flash_v1_with_lse,
    flash_variant,
    flash_variant_ref,
    smem_bytes,
)
from udifftext_tpu_torch.ops.geglu import (
    geglu_ff,
    geglu_ff_ln,
    geglu_ff_ln_ref,
    geglu_ff_ref,
    geglu_ff_tiled_ref,
    geglu_kernel_route,
    geglu_plan,
)
from udifftext_tpu_torch.ops.groupnorm import (
    fused_groupnorm_silu,
    fused_groupnorm_silu_ref,
    groupnorm_plan,
)
from udifftext_tpu_torch.ops.ln_gemm import (
    ln_gemm,
    ln_gemm3,
    ln_gemm3_ref,
    ln_gemm3_supported,
    ln_gemm_plan,
    ln_gemm_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator("cuda").manual_seed(0)


def _tol(ref: torch.Tensor) -> float:
    scale = max(1.0, float(ref.float().abs().max()))
    return 2**-7 * scale if ref.dtype == torch.bfloat16 else 1e-5 * scale


def _check(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert float((got.float() - ref.float()).abs().max()) <= _tol(ref)


@pytest.mark.parametrize("b,n,h,d,dtype", [
    (2, 1024, 10, 64, torch.bfloat16),
    (2, 4096, 5, 64, torch.bfloat16),
    (1, 512, 2, 128, torch.bfloat16),
    (2, 1024, 4, 64, torch.float32),
])
def test_flash_matches_plain(gen, b, n, h, d, dtype):
    q, k, v = (torch.randn(b, n, h, d, generator=gen, device="cuda").to(dtype) for _ in range(3))
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_ref(q, k, v)
    _check(out, ref)
    assert float((lse - ref_lse).abs().max()) <= 1e-4


def test_flash_reads_strided_views(gen):
    qkv = torch.randn(2, 1024, 3, 4, 64, generator=gen, device="cuda").bfloat16()
    q, k, v = qkv.unbind(2)  # (B, N, H, D) views with a token stride of 3·H·D
    out, _ = flash_attention(q, k, v)
    _check(out, flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous())[0])


def test_flash_rejects_what_it_does_not_take(gen):
    q = torch.randn(1, 512, 2, 64, generator=gen, device="cuda")
    with pytest.raises(ValueError):
        flash_attention(q[:, :480], q[:, :480], q[:, :480])  # N % 64 != 0
    with pytest.raises(ValueError):
        flash_attention(q[..., :32], q[..., :32], q[..., :32])  # D = 32
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        flash_attention(q, q.cpu(), q)


def test_sdpa_dispatch_on_cuda(gen):
    for n, launched in ((1024, 1), (256, 0), (576, 0)):
        q = torch.randn(2, n, 2, 64, generator=gen, device="cuda").bfloat16()
        before = flash_attention.launches
        out = A.sdpa(q, q, q)
        assert flash_attention.launches - before == launched
        _check(out, flash_attention_ref(q, q, q)[0] if launched else A.plain_sdpa(q, q, q))


@pytest.mark.parametrize("b,n,h,d,dtype", [
    (2, 1024, 10, 64, torch.bfloat16),
    (1, 4096, 5, 64, torch.bfloat16),
    (1, 512, 2, 128, torch.bfloat16),
    (2, 1024, 4, 64, torch.float32),
])
def test_flash_bwd_matches_plain(gen, b, n, h, d, dtype):
    q, k, v, do = (torch.randn(b, n, h, d, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    out, lse = flash_attention(q, k, v)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    for g, r in zip(got, flash_attention_bwd_ref(q, k, v, out, lse, do)):
        _check(g, r)


def test_flash_bwd_reads_strided_views(gen):
    qkv = torch.randn(2, 1024, 3, 4, 64, generator=gen, device="cuda").bfloat16()
    q, k, v = qkv.unbind(2)
    do = torch.randn(2, 1024, 8, 64, generator=gen, device="cuda").bfloat16()[:, :, ::2]
    out, lse = flash_attention(q, k, v)
    got = flash_attention_bwd(q, k, v, out, lse, do)
    want = flash_attention_bwd_ref(q.contiguous(), k.contiguous(), v.contiguous(), out, lse,
                                   do.contiguous())
    for g, r in zip(got, want):
        _check(g, r)


def test_flash_bwd_rejects_what_it_does_not_take(gen):
    q = torch.randn(1, 512, 2, 64, generator=gen, device="cuda")
    out, lse = flash_attention(q, q, q)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, out, lse[:, :, :256], out)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, out, lse, out.bfloat16())
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, out, lse, out.transpose(-1, -2).contiguous().transpose(-1, -2))
    with pytest.raises(TypeError):
        flash_attention_bwd(q.half(), q.half(), q.half(), out.half(), lse, out.half())


def _mma_case(gen, b, nq, nk, h, scales=(1.0, 1.0, 1.0)):
    """bf16, d = 64 inputs q, k, v, dout: the tensor-core route's."""
    shapes = ((b, nq, h, 64), (b, nk, h, 64), (b, nk, h, 64), (b, nq, h, 64))
    return [(torch.randn(*s, generator=gen, device="cuda") * sc).bfloat16()
            for s, sc in zip(shapes, (*scales, 1.0))]


# (B, Nq, Nk, H, scale, input scales of q, k, v); the last drives logits far beyond ±75
MMA_CASES = [
    (3, 1024, 1024, 5, None, (1.0, 1.0, 1.0)),
    (2, 1024, 512, 4, None, (1.0, 1.0, 1.0)),
    (1, 512, 4096, 5, None, (1.0, 1.0, 1.0)),
    (2, 192, 320, 3, None, (1.0, 1.0, 1.0)),   # N % 128 == 64: the last block's second half idle
    (2, 1024, 1024, 4, 0.3, (1.0, 1.0, 1.0)),
    (1, 512, 512, 2, None, (9.0, 2.4, 0.3)),
]
MMA_IDS = ["B3_H5", "nq1024_nk512", "nq512_nk4096", "nq192_nk320", "scale0.3", "hot"]


@pytest.mark.parametrize("b,nq,nk,h,scale,scales", MMA_CASES, ids=MMA_IDS)
def test_flash_mma_matches_plain_and_tiled(gen, b, nq, nk, h, scale, scales):
    q, k, v, _ = _mma_case(gen, b, nq, nk, h, scales)
    out, lse = flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert flash_attention.last_route == "mma"
    ref, ref_lse = flash_attention_ref(q, k, v, scale)
    _check(out, ref)
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    if scales[0] > 1:  # where a softmax clamped at ±75 would differ
        assert float(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).abs().max()) / 8 > 80
    tiled, tiled_lse = flash_attention_tiled_ref(q, k, v, scale)
    assert float((out.float() - tiled.float()).abs().max()) <= _tol(tiled) / 2
    assert float((lse - tiled_lse).abs().max()) <= 1e-5 * max(1.0, float(tiled_lse.abs().max()))


@pytest.mark.parametrize("b,nq,nk,h,scale,scales", MMA_CASES, ids=MMA_IDS)
def test_flash_bwd_mma_matches_plain_and_tiled(gen, b, nq, nk, h, scale, scales):
    q, k, v, do = _mma_case(gen, b, nq, nk, h, scales)
    out, lse = flash_attention(q, k, v, scale)
    got = flash_attention_bwd(q, k, v, out, lse, do, scale)
    torch.cuda.synchronize()
    assert flash_attention_bwd.last_route == "mma"
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, scale)
    tiled = flash_attention_bwd_tiled_ref(q, k, v, out, lse, do, scale)
    for g, w, t in zip(got, want, tiled):
        assert g.dtype == w.dtype and g.shape == w.shape
        top = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= 2**-7 * top
        assert float((g.float() - t.float()).abs().max()) <= 2**-8 * top


def test_flash_strided_views_take_the_mma_route(gen):
    qkv = torch.randn(2, 1024, 3, 4, 64, generator=gen, device="cuda").bfloat16()
    q, k, v = qkv.unbind(2)
    do = torch.randn(2, 1024, 8, 64, generator=gen, device="cuda").bfloat16()[:, :, ::2]
    out, lse = flash_attention(q, k, v)
    assert flash_attention.last_route == "mma"
    flash_attention_bwd(q, k, v, out, lse, do)
    assert flash_attention_bwd.last_route == "mma"
    q32 = torch.randn(1, 512, 2, 64, generator=gen, device="cuda")
    flash_attention(q32, q32, q32)
    assert flash_attention.last_route == "fma"
    q128 = torch.randn(1, 512, 2, 128, generator=gen, device="cuda").bfloat16()
    flash_attention(q128, q128, q128)
    assert flash_attention.last_route == "fma"


def test_flash_mma_refuses_unaligned_views(gen):
    flat = torch.randn(2 * 512 * 2 * 64 + 8, generator=gen, device="cuda").bfloat16()
    ok = flat[8:].view(2, 512, 2, 64)       # 16 bytes into the buffer
    off8 = flat[4:-4].view(2, 512, 2, 64)   # 8 bytes in: no 16-byte copies
    out, lse = flash_attention(ok, ok, ok)
    _check(out, flash_attention_ref(ok, ok, ok)[0])
    before = (flash_attention.launches, flash_attention_bwd.launches)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(off8, ok, ok)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(ok, ok, off8)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(ok, ok, ok, out, lse, off8)
    narrow = torch.randn(2, 512, 2, 68, generator=gen, device="cuda").bfloat16()[..., :64]
    with pytest.raises(ValueError, match="16-byte"):  # a token stride of 68 elements
        flash_attention(narrow, narrow, narrow)
    assert (flash_attention.launches, flash_attention_bwd.launches) == before
    # the same views in fp32 go to the FMA kernels, which take any alignment
    off8_32 = flat.float()[1:-7].view(2, 512, 2, 64)
    _check(flash_attention(off8_32, off8_32, off8_32)[0],
           flash_attention_ref(off8_32, off8_32, off8_32)[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_is_deterministic(gen, dtype):
    q, k, v, do = (torch.randn(2, 1024, 5, 64, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    out, lse = flash_attention(q, k, v)
    out2, lse2 = flash_attention(q, k, v)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    first = flash_attention_bwd(q, k, v, out, lse, do)
    second = flash_attention_bwd(q, k, v, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_grads_match_plain_autograd(gen, dtype):
    q, k, v = (torch.randn(2, 1024, 4, 64, generator=gen, device="cuda").to(dtype)
               .requires_grad_(True) for _ in range(3))
    do = torch.randn(2, 1024, 4, 64, generator=gen, device="cuda").to(dtype)
    before = flash_attention_bwd.launches
    # "flash": under "auto" fp32 takes the plain path (ops.attention.flash_dtype_ok)
    got = torch.autograd.grad(A.sdpa(q, k, v, impl="flash"), (q, k, v), do)
    assert flash_attention_bwd.launches == before + 1
    want = torch.autograd.grad(flash_attention_ref(q, k, v)[0], (q, k, v), do)
    for g, r in zip(got, want):
        rel = 2**-6 if dtype == torch.bfloat16 else 1e-4
        assert float((g.float() - r.float()).abs().max()) <= rel * float(r.float().abs().max())


def test_geglu_grads_match_plain_autograd(gen):
    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).requires_grad_(True)

    c = 320
    ins = (r(2, 1024, c), r(8 * c, c, scale=c**-0.5), r(8 * c, scale=0.1),
           r(c, 4 * c, scale=(4 * c) ** -0.5), r(c, scale=0.1))
    do = torch.randn(2, 1024, c, generator=gen, device="cuda")
    before = geglu_ff.launches
    got = torch.autograd.grad(geglu_ff(*ins), ins, do)
    assert geglu_ff.launches == before + 1
    want = torch.autograd.grad(geglu_ff_ref(*ins), ins, do)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.parametrize("m,c,dtype", [
    (8192, 320, torch.bfloat16), (2048, 640, torch.bfloat16), (512, 1280, torch.bfloat16),
    (100, 96, torch.bfloat16),  # ragged row block, hidden split in two
    (100, 96, torch.float32),
])
def test_geglu_matches_plain(gen, m, c, dtype):
    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).to(dtype)

    x = r(m, c)
    w1, b1 = r(8 * c, c, scale=c**-0.5), r(8 * c, scale=0.1)
    w2, b2 = r(c, 4 * c, scale=(4 * c) ** -0.5), r(c, scale=0.1)
    before = geglu_ff.launches
    out = geglu_ff(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert geglu_ff.launches == before + 1
    _check(out, geglu_ff_ref(x, w1, b1, w2, b2))


def test_geglu_rejects_what_it_does_not_take(gen):
    x = torch.randn(4, 64, generator=gen, device="cuda")
    w1, b1 = torch.zeros(512, 64, device="cuda"), torch.zeros(512, device="cuda")
    w2, b2 = torch.zeros(64, 256, device="cuda"), torch.zeros(64, device="cuda")
    with pytest.raises(TypeError):
        geglu_ff(x.bfloat16(), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        geglu_ff(x, w1[:, :32], b1, w2, b2)
    with pytest.raises(ValueError):
        geglu_ff(x, w1[:500], b1[:500], w2[:, :250], b2)  # I % 32 != 0
    xb, w1b, b1b, w2b, b2b = (t[:480].bfloat16() if t.ndim else t for t in (x, w1, b1, w2, b2))
    with pytest.raises(ValueError):  # bf16: I % 64 != 0
        geglu_ff(xb, w1b[:480], b1b[:480], w2b[:, :240].contiguous(), b2b)


def _geglu_case(gen, m, c, dtype):
    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).to(dtype)

    return (r(m, c), r(8 * c, c, scale=c**-0.5), r(8 * c, scale=0.1),
            r(c, 4 * c, scale=(4 * c) ** -0.5), r(c, scale=0.1))


@pytest.mark.parametrize("m,c,dtype,route", [
    (2 * 4096, 320, torch.bfloat16, "mma"), (20 * 4096, 320, torch.bfloat16, "mma"),
    (2 * 1024, 640, torch.bfloat16, "mma"), (20 * 1024, 640, torch.bfloat16, "mma"),
    (2 * 256, 1280, torch.bfloat16, "mma"), (20 * 256, 1280, torch.bfloat16, "mma"),
    (2 * 4096 - 37, 320, torch.bfloat16, "mma"),  # ragged: the last block's rows end early
    (1000, 640, torch.bfloat16, "mma"), (300, 1280, torch.bfloat16, "mma"),
    (700, 64, torch.bfloat16, "mma"), (700, 192, torch.bfloat16, "mma"),
    (700, 512, torch.bfloat16, "mma"), (700, 768, torch.bfloat16, "mma"),
    (700, 48, torch.bfloat16, "wmma"), (700, 448, torch.bfloat16, "wmma"),
    (700, 64, torch.float32, "fma"),
])
@pytest.mark.parametrize("with_ln", [False, True])
def test_geglu_routes_match_plain(gen, m, c, dtype, route, with_ln):
    """Every route of the kernel, with and without its LayerNorm prologue,
    against the plain version, and for "mma" against the model of its order
    of operations (one bf16 ulp of the largest value: only the last rounding
    can fall the other way); the route and the plan are the ones the pure functions name."""
    x, w1, b1, w2, b2 = _geglu_case(gen, m, c, dtype)
    assert geglu_kernel_route(dtype, c) == route
    if with_ln:
        scale = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        wrapper, args, ref_fn = geglu_ff_ln, (x, scale, bias, w1, b1, w2, b2), geglu_ff_ln_ref
    else:
        wrapper, args, ref_fn = geglu_ff, (x, w1, b1, w2, b2), geglu_ff_ref
    before = wrapper.launches
    out = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and wrapper.last_route == route
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = geglu_plan(dtype, m, c, 4 * c, sms)
    assert wrapper.last_plan == plan and (plan.launches == 1) == (plan.partial_bytes == 0)
    _check(out, ref_fn(*args))
    if route == "mma":
        tiled = geglu_ff_tiled_ref(x, w1, b1, w2, b2, plan.splits, 128 if c > 640 else 64,
                                   ln=(scale, bias) if with_ln else None)
        top = max(1.0, float(tiled.float().abs().max()))
        assert float((out.float() - tiled.float()).abs().max()) <= 2.0 ** (
            math.floor(math.log2(top)) - 7)
    again = wrapper(*args)
    assert torch.equal(out, again)  # fixed-order sums: the same bits every time


def test_geglu_mma_rejects_misaligned(gen):
    x, w1, b1, w2, b2 = _geglu_case(gen, 256, 320, torch.bfloat16)
    with pytest.raises(ValueError):
        geglu_ff(x, w1, torch.cat([b1[:1], b1])[1:], w2, b2)  # b1 off the 32-byte boundary
    with pytest.raises(ValueError):
        geglu_ff(x, w1[:, :256], b1, w2, b2)


def test_unet_auto_matches_plain(gen):
    """One UNet eval at the demo's shapes under attn_impl "auto" and "plain":
    kernels only in the first, outputs within 5e-2 relative L2 (16 blocks
    whose bf16 roundings differ between the kernels and the plain path)."""
    from udifftext_tpu_torch.builders import TEXTDESIGN_SD_2, build_engine, randomize_parameters

    x = torch.randn(2, 64, 64, 9, generator=gen, device="cuda").bfloat16()
    t = torch.tensor([0.3, 0.3], device="cuda")
    ctx = torch.randn(2, 12, 2048, generator=gen, device="cuda").bfloat16()
    outs = {}
    for impl in ("auto", "plain"):
        unet = build_engine(TEXTDESIGN_SD_2, torch.bfloat16, "cuda", attn_impl=impl).engine.unet
        randomize_parameters(unet, 0)
        before = geglu_ff.launches, flash_attention.launches
        with torch.no_grad():
            outs[impl] = unet(x, t, ctx, None)[0]
        torch.cuda.synchronize()
        moved = geglu_ff.launches - before[0], flash_attention.launches - before[1]
        assert moved == ((15, 10) if impl == "auto" else (0, 0))
        del unet
    assert geglu_ff.last_route == "mma"
    rel = float((outs["auto"] - outs["plain"]).norm() / outs["plain"].norm())
    assert torch.isfinite(outs["auto"]).all() and rel <= 5e-2


# -- the LayerNorm-fused kernels ---------------------------------------------


def _ln_case(gen, b, n, c, dtype, grad=False):
    """x, the LayerNorm's fp32 (scale, bias) and three (C, C) weights."""
    def r(*s, scale=1.0, dt=dtype):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).to(dt).requires_grad_(grad)

    x = r(b, n, c)
    scale = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).requires_grad_(grad)
    bias = r(c, scale=0.1, dt=torch.float32)
    return x, scale, bias, [r(c, c, scale=c**-0.5) for _ in range(3)]


def _grads_close(got, want, dtype):
    """Both sides differentiate the plain version; the forward values they
    start from differ by the kernel's rounding only."""
    rel = 2**-6 if dtype == torch.bfloat16 else 1e-4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) <= rel * float(w.float().abs().max())


LN_SHAPES = [
    (2, 4096, 320, torch.bfloat16), (2, 1024, 640, torch.bfloat16),
    (2, 128, 1280, torch.bfloat16), (1, 64, 96, torch.bfloat16),
    (2, 1024, 640, torch.float32), (1, 64, 96, torch.float32),
]


@pytest.mark.parametrize("b,n,c,dtype", LN_SHAPES)
def test_ln_gemm_matches_plain(gen, b, n, c, dtype):
    x, scale, bias, ws = _ln_case(gen, b, n, c, dtype)
    w3 = torch.cat(ws, dim=0)
    before = ln_gemm.launches, ln_gemm3.launches
    out = ln_gemm(x, scale, bias, w3)
    q, k, v = ln_gemm3(x, scale, bias, *ws)
    torch.cuda.synchronize()
    assert (ln_gemm.launches, ln_gemm3.launches) == (before[0] + 1, before[1] + 1)
    _check(out, ln_gemm_ref(x, scale, bias, w3))
    for got, ref in zip((q, k, v), ln_gemm3_ref(x, scale, bias, *ws)):
        assert got.is_contiguous()
        _check(got, ref)
    assert torch.equal(out, torch.cat([q, k, v], dim=-1))  # one kernel, two output layouts


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_gemm_grads_match_plain_autograd(gen, dtype):
    x, scale, bias, ws = _ln_case(gen, 2, 256, 320, dtype, grad=True)
    ins = (x, scale, bias, *ws)
    dos = [torch.randn(2, 256, 320, generator=gen, device="cuda").to(dtype) for _ in range(3)]
    _grads_close(torch.autograd.grad(ln_gemm3(*ins), ins, dos),
                 torch.autograd.grad(ln_gemm3_ref(*ins), ins, dos), dtype)
    ins = (x, scale, bias, ws[0])
    _grads_close(torch.autograd.grad(ln_gemm(*ins), ins, dos[0]),
                 torch.autograd.grad(ln_gemm_ref(*ins), ins, dos[0]), dtype)


def test_ln_gemm_rejects_what_it_does_not_take(gen):
    x, scale, bias, ws = _ln_case(gen, 1, 128, 64, torch.bfloat16)
    with pytest.raises(ValueError):  # ragged: 100 rows are not a multiple of the 64-row tile
        ln_gemm(x[:, :100].contiguous(), scale, bias, ws[0])
    assert not ln_gemm3_supported(x[:, :100], 64)
    with pytest.raises(ValueError):
        ln_gemm(x[..., ::2], scale[::2].contiguous(), bias[::2].contiguous(), ws[0][:, :32])
    with pytest.raises(TypeError):
        ln_gemm(x, scale, bias, ws[0].float())
    with pytest.raises(TypeError):
        ln_gemm(x, scale.bfloat16(), bias, ws[0])
    with pytest.raises(ValueError):
        ln_gemm3(x, scale, bias, ws[0], ws[1][:48], ws[2])
    with pytest.raises(ValueError):
        ln_gemm(x, scale.cpu(), bias, ws[0])
    with pytest.raises(TypeError):
        ln_gemm(x.half(), scale, bias, ws[0].half())


# route "mma" (wgmma, weights through a TMA ring): the glue probe's shapes,
# the demo's CFG batch, (2, 128, 1280) -> 3840, F = 336 (ragged last tiles,
# column groups across the q/k boundary) and a ring wrapped 10 times
LN_MMA_SHAPES = [
    (32, 4096, 320, 320), (32, 1024, 640, 640), (2, 4096, 320, 320), (2, 1024, 640, 640),
    (2, 128, 1280, 1280), (2, 4096, 320, 336), (2, 1024, 1280, 1280),
]


@pytest.mark.parametrize("b,n,c,f", LN_MMA_SHAPES)
def test_ln_gemm_mma_matches_plain(gen, b, n, c, f):
    """Both wrappers on route "mma" with the plan `ln_gemm_plan` names,
    against the plain versions (two bf16 ulps of the largest value: one
    rounding each side); ln_gemm of the three weights stacked gives the
    three ln_gemm3 outputs side by side, bit for bit."""
    x, scale, bias, _ = _ln_case(gen, b, n, c, torch.bfloat16)
    ws = [(torch.randn(f, c, generator=gen, device="cuda") * c**-0.5).bfloat16() for _ in range(3)]
    w3 = torch.cat(ws, dim=0)
    q, k, v = ln_gemm3(x, scale, bias, *ws)
    out = ln_gemm(x, scale, bias, w3)
    torch.cuda.synchronize()
    for fn, f_, n_w in ((ln_gemm3, f, 3), (ln_gemm, 3 * f, 1)):
        assert fn.last_route == "mma"
        assert fn.last_plan == ln_gemm_plan(torch.bfloat16, b * n, c, f_, n_w)
    for got, ref in zip((q, k, v), ln_gemm3_ref(x, scale, bias, *ws)):
        assert got.is_contiguous()
        _check(got, ref)
    _check(out, ln_gemm_ref(x, scale, bias, w3))
    assert torch.equal(out, torch.cat([q, k, v], dim=-1))
    if (b, n, c) == (2, 1024, 1280):
        plan = ln_gemm.last_plan
        assert plan.steps >= 10 * plan.stages  # the busiest block wraps its ring 10 times


def test_ln_gemm_mma_grads_match_plain_autograd(gen):
    x, scale, bias, ws = _ln_case(gen, 2, 1024, 640, torch.bfloat16, grad=True)
    ins = (x, scale, bias, *ws)
    dos = [torch.randn(2, 1024, 640, generator=gen, device="cuda").bfloat16() for _ in range(3)]
    _grads_close(torch.autograd.grad(ln_gemm3(*ins), ins, dos),
                 torch.autograd.grad(ln_gemm3_ref(*ins), ins, dos), torch.bfloat16)
    assert ln_gemm3.last_route == "mma"
    ins = (x, scale, bias, ws[0])
    _grads_close(torch.autograd.grad(ln_gemm(*ins), ins, dos[0]),
                 torch.autograd.grad(ln_gemm_ref(*ins), ins, dos[0]), torch.bfloat16)
    assert ln_gemm.last_route == "mma"


def _cross_case(gen, b, n, c, l, dtype, grad=False):
    x, scale, bias, ws = _ln_case(gen, b, n, c, dtype, grad)
    heads = c // 64

    def r(*s, scale=1.0):
        t = (torch.randn(*s, generator=gen, device="cuda") * scale).to(dtype)
        return t.requires_grad_(grad)

    return (x, scale, bias, ws[0], r(b, l, heads, 64), r(b, l, heads, 64), ws[1],
            r(c, scale=0.1)), heads


@pytest.mark.parametrize("b,n,c,l,dtype", [
    (2, 4096, 320, 12, torch.bfloat16), (2, 1024, 640, 12, torch.bfloat16),
    (2, 256, 1280, 12, torch.bfloat16), (2, 1024, 320, 64, torch.bfloat16),
    (2, 1024, 640, 2, torch.bfloat16), (2, 1024, 640, 12, torch.float32),
    (1, 64, 128, 64, torch.float32), (1, 64, 128, 2, torch.float32),
    # route "mma" at the ds1/ds2 widths (5 and 10 heads) for every kind of L:
    # the least, the UNet's 12, one key tile's 16, one past it, the most
    *[(2, 1024, c_, l_, torch.bfloat16) for c_ in (320, 640) for l_ in (2, 12, 16, 17, 64)],
    (32, 4096, 320, 12, torch.bfloat16),  # 128 rows a block
    (2, 64, 1280, 64, torch.bfloat16), (1, 64, 128, 16, torch.bfloat16),
])
def test_fused_cross_attention_matches_plain(gen, b, n, c, l, dtype):
    ins, heads = _cross_case(gen, b, n, c, l, dtype)
    assert cross_attention_supported(ins[0], ins[4], heads)
    before = fused_cross_attention.launches
    out = fused_cross_attention(*ins, heads)
    torch.cuda.synchronize()
    assert fused_cross_attention.launches == before + 1
    want = "fma" if dtype == torch.float32 else "wmma" if c == 1280 else "mma"
    assert fused_cross_attention.last_route == want
    assert fused_cross_attention.last_plan == cross_attention_plan(dtype, b, n, c, c)
    _check(out, fused_cross_attention_ref(*ins, heads))


def test_fused_cross_attention_mma_when_the_max_binds(gen):
    """Logits of ±100 and more: the softmax rests on the max subtraction."""
    ins, heads = _cross_case(gen, 2, 1024, 320, 12, torch.bfloat16)
    x, scale, bias, wq, k, v, wo, bo = ins
    k = (k.float() * 40).bfloat16()
    ins = (x, scale, bias, wq, k, v, wo, bo)
    out = fused_cross_attention(*ins, heads)
    torch.cuda.synchronize()
    assert fused_cross_attention.last_route == "mma"
    ref = fused_cross_attention_ref(*ins, heads)
    assert torch.isfinite(out.float()).all()
    _check(out, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_cross_attention_grads_match_plain_autograd(gen, dtype):
    ins, heads = _cross_case(gen, 2, 256, 320, 12, dtype, grad=True)
    do = torch.randn(2, 256, 320, generator=gen, device="cuda").to(dtype)
    _grads_close(torch.autograd.grad(fused_cross_attention(*ins, heads), ins, do),
                 torch.autograd.grad(fused_cross_attention_ref(*ins, heads), ins, do), dtype)


def test_fused_cross_attention_rejects_what_it_does_not_take(gen):
    ins, heads = _cross_case(gen, 2, 128, 128, 12, torch.bfloat16)
    x, scale, bias, wq, k, v, wo, bo = ins
    with pytest.raises(ValueError):  # ragged: N = 96 is not a multiple of the 64-row tile
        fused_cross_attention(x[:, :96].contiguous(), scale, bias, wq, k, v, wo, bo, heads)
    with pytest.raises(ValueError):  # L == 1 is the sigmoid branch
        fused_cross_attention(x, scale, bias, wq, k[:, :1].contiguous(), v[:, :1].contiguous(),
                              wo, bo, heads)
    with pytest.raises(ValueError):  # heads of 32, not 64
        fused_cross_attention(x, scale, bias, wq, k.reshape(2, 12, 4, 32), v.reshape(2, 12, 4, 32),
                              wo, bo, 4)
    with pytest.raises(TypeError):
        fused_cross_attention(x, scale, bias, wq, k.float(), v, wo, bo, heads)
    with pytest.raises(ValueError):
        fused_cross_attention(x, scale, bias, wq, k.transpose(1, 2), v, wo, bo, heads)


@pytest.mark.parametrize("m,c,dtype", [
    (8192, 320, torch.bfloat16), (2048, 640, torch.bfloat16), (512, 1280, torch.bfloat16),
    (100, 96, torch.bfloat16),  # ragged row block, hidden split in two: each split normalizes
    (2048, 640, torch.float32), (100, 96, torch.float32),
])
def test_geglu_ln_matches_plain(gen, m, c, dtype):
    x, scale, bias, _ = _ln_case(gen, 1, m, c, dtype)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).to(dtype)

    w1, b1 = r(8 * c, c, scale=c**-0.5), r(8 * c, scale=0.1)
    w2, b2 = r(c, 4 * c, scale=(4 * c) ** -0.5), r(c, scale=0.1)
    before = geglu_ff_ln.launches, geglu_ff.launches
    out = geglu_ff_ln(x, scale, bias, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert (geglu_ff_ln.launches, geglu_ff.launches) == (before[0] + 1, before[1])
    _check(out, geglu_ff_ln_ref(x, scale, bias, w1, b1, w2, b2))
    with pytest.raises(ValueError):
        geglu_ff_ln(x, scale.bfloat16(), bias, w1, b1, w2, b2)


def test_geglu_ln_grads_match_plain_autograd(gen):
    c = 320
    x, scale, bias, _ = _ln_case(gen, 2, 256, c, torch.float32, grad=True)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).requires_grad_(True)

    ins = (x, scale, bias, r(8 * c, c, scale=c**-0.5), r(8 * c, scale=0.1),
           r(c, 4 * c, scale=(4 * c) ** -0.5), r(c, scale=0.1))
    do = torch.randn(2, 256, c, generator=gen, device="cuda")
    _grads_close(torch.autograd.grad(geglu_ff_ln(*ins), ins, do),
                 torch.autograd.grad(geglu_ff_ln_ref(*ins), ins, do), torch.float32)


def test_fused_block_launches_and_matches_unfused(gen):
    """`fuse_glue="auto"` on the card at a ds2-like shape: one launch of each
    fused kernel and of flash attention per forward, none of the unfused
    GEGLU; output within bf16 rounding of the unfused block's."""
    heads, n, tdim = 10, 1024, 2048
    fused = cast_weights(BasicTransformerBlock(heads, 64, tdim, fuse_qkv=True, fuse_glue="auto"),
                         torch.bfloat16).cuda().eval()
    plain = cast_weights(BasicTransformerBlock(heads, 64, tdim), torch.bfloat16).cuda().eval()
    with torch.no_grad():
        for p in fused.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device="cuda")
                    * (p.shape[-1] ** -0.5 if p.ndim > 1 else 0.1) + (1.0 if p.ndim == 1 else 0.0))
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, n, heads * 64, generator=gen, device="cuda").bfloat16()
    ctx = torch.randn(2, 12, tdim, generator=gen, device="cuda").bfloat16()
    fns = (ln_gemm3, fused_cross_attention, geglu_ff_ln, flash_attention, geglu_ff)
    with torch.no_grad():
        kv = {"t": fused.t_attn.project_kv(ctx)}
        before = [f.launches for f in fns]
        got, _ = fused(x, ctx, None, False, kv)
        assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1, 1, 0]
        before = [f.launches for f in fns]
        _, t_map = fused(x, ctx, None, True, kv)  # the map path launches no fused t_attn
        assert [f.launches - b for f, b in zip(fns, before)] == [1, 0, 1, 1, 0]
        assert t_map.shape == (2, heads, n, 12)
        want, _ = plain(x, ctx, None, False, kv)
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel <= 2e-2, rel


# -- the probe-level kernels: fused GroupNorm+SiLU, the flash variants --------


def _gn_case(gen, shape, dtype, offset=0.0):
    c = shape[-1]
    x = (torch.randn(*shape, generator=gen, device="cuda") + offset).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    return x, scale, bias


# shapes that no cluster holds, or holds only in 16-byte slices or one CTA an SM
GN_STREAM_CASES = {(3, 777, 64), (2, 1000, 64), (2, 64, 64, 960), (1, 256, 256, 256)}


@pytest.mark.parametrize("shape,dtype,with_silu,eps", [
    ((2, 64, 64, 320), torch.bfloat16, True, 1e-5),
    ((32, 64, 64, 320), torch.bfloat16, True, 1e-5),
    ((2, 32, 32, 640), torch.bfloat16, True, 1e-5),
    ((2, 16, 16, 1280), torch.bfloat16, True, 1e-5),
    ((2, 64, 64, 960), torch.bfloat16, True, 1e-5),
    ((2, 32, 32, 1920), torch.bfloat16, True, 1e-5),
    ((2, 8, 8, 2560), torch.bfloat16, True, 1e-5),   # more 16-byte vectors than threads
    ((3, 777, 64), torch.bfloat16, True, 1e-5),      # ragged last chunk
    ((2, 64, 1280), torch.bfloat16, False, 1e-6),
    ((2, 32, 32, 640), torch.float32, True, 1e-5),
    ((2, 1000, 64), torch.float32, False, 1e-6),
    ((1, 1, 4096), torch.float32, True, 1e-5),       # one row, the widest C
    ((2, 4133, 320), torch.bfloat16, True, 1e-5),    # ragged: N not a multiple of a CTA's rows
    ((2, 64, 64, 320), torch.float32, False, 1e-6),
    ((1, 256, 256, 256), torch.float32, True, 1e-5),  # a (sample, group) no cluster holds
])
def test_groupnorm_matches_plain(gen, shape, dtype, with_silu, eps):
    x, scale, bias = _gn_case(gen, shape, dtype)
    before = fused_groupnorm_silu.launches
    out = fused_groupnorm_silu(x, scale, bias, 32, eps, with_silu)
    torch.cuda.synchronize()
    assert fused_groupnorm_silu.launches == before + 1  # a wrapper call, on either route
    plan = groupnorm_plan(dtype, shape[0], x.numel() // (shape[0] * shape[-1]), shape[-1])
    assert fused_groupnorm_silu.last_plan == plan
    assert plan.route == ("stream" if shape in GN_STREAM_CASES else "cluster")
    _check(out, fused_groupnorm_silu_ref(x, scale, bias, 32, eps, with_silu))


def test_groupnorm_other_group_counts_and_offset(gen):
    x, scale, bias = _gn_case(gen, (2, 256, 96), torch.float32)
    for groups in (1, 4, 12):
        _check(fused_groupnorm_silu(x, scale, bias, groups),
               fused_groupnorm_silu_ref(x, scale, bias, groups))
    x, scale, bias = _gn_case(gen, (2, 64, 64, 320), torch.float32, offset=1000.0)
    got, ref = fused_groupnorm_silu(x, scale, bias), fused_groupnorm_silu_ref(x, scale, bias)
    assert fused_groupnorm_silu.last_route == "cluster"
    assert float((got - ref).abs().max()) <= 1e-3
    # what E[x²] − mean² would make of the same data
    xg = x.reshape(2, -1, 32, 10)
    var = (xg * xg).mean(dim=(1, 3)) - xg.mean(dim=(1, 3)) ** 2
    assert float((var - 1).abs().max()) > 0.02


def test_groupnorm_is_deterministic(gen):
    x, scale, bias = _gn_case(gen, (4, 64, 64, 320), torch.bfloat16)
    assert torch.equal(fused_groupnorm_silu(x, scale, bias), fused_groupnorm_silu(x, scale, bias))
    x, scale, bias = _gn_case(gen, (1, 256, 256, 256), torch.float32)  # route "stream"
    assert torch.equal(fused_groupnorm_silu(x, scale, bias), fused_groupnorm_silu(x, scale, bias))


def test_groupnorm_rejects_what_it_does_not_take(gen):
    x, scale, bias = _gn_case(gen, (2, 16, 16, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):  # channels-first memory, NHWC shape
        fused_groupnorm_silu(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        fused_groupnorm_silu(x[:, ::2], scale, bias)
    with pytest.raises(ValueError):  # C % 8 != 0
        fused_groupnorm_silu(x[..., :36].contiguous(), scale[:36].clone(), bias[:36].clone(), 3)
    with pytest.raises(ValueError):  # C % num_groups != 0
        fused_groupnorm_silu(x, scale, bias, 24)
    with pytest.raises(TypeError):
        fused_groupnorm_silu(x.half(), scale, bias)
    with pytest.raises(TypeError):
        fused_groupnorm_silu(x, scale.bfloat16(), bias)
    with pytest.raises(ValueError):
        fused_groupnorm_silu(x, scale[:32].clone(), bias)
    with pytest.raises(ValueError):
        fused_groupnorm_silu(x, scale.cpu(), bias)
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_groupnorm_silu(x.requires_grad_(True), scale, bias)


@pytest.mark.parametrize("bh,n,dtype,hot", [
    (10, 1024, torch.bfloat16, False), (10, 4096, torch.bfloat16, False),
    (3, 512, torch.bfloat16, True), (10, 1024, torch.float32, False),
    (3, 512, torch.float32, True),
])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_flash_variant_matches_plain(gen, variant, bh, n, dtype, hot):
    """Every tile pair of the dtype's menu; `hot` drives the logits past 80,
    where v1 follows the plain version clamped at ±75, v3/v4 the one clamped
    at ±60 and v2 the softmax."""
    scales = (9.0, 2.4, 0.3) if hot else (0.3, 0.3, 0.3)
    q, k, v = ((torch.randn(bh, n, 64, generator=gen, device="cuda") * s).to(dtype)
               for s in scales)
    clamp = VARIANTS[variant][1]
    ref, ref_lse = flash_variant_ref(q, k, v, clamp)
    if hot:
        assert float((q[:1].float() @ k[:1].float().transpose(1, 2)).abs().max()) / 8 > 80
        other, _ = flash_variant_ref(q, k, v, None if clamp else CLAMP_V1)
        assert float((ref.float() - other.float()).abs().max()) > 0.1
    for bq, bk in TILE_MENU[dtype]:
        before = flash_variant.launches[variant]
        out = flash_variant(q, k, v, variant, bq, bk)
        torch.cuda.synchronize()
        assert flash_variant.launches[variant] == before + 1
        assert torch.isfinite(out).all()
        _check(out, ref)
        if variant == "v1":  # log Σp, also where the clamp binds
            _, lse = flash_v1_with_lse(q, k, v, bq, bk)
            assert float((lse - ref_lse).abs().max()) <= 1e-4


def test_flash_variant_v1_lse_and_cross_lengths(gen):
    q = (torch.randn(4, 256, 64, generator=gen, device="cuda") * 0.5).bfloat16()
    k, v = ((torch.randn(4, 1024, 64, generator=gen, device="cuda") * 0.5).bfloat16()
            for _ in range(2))
    out, lse = flash_v1_with_lse(q, k, v, 128, 128)
    ref, ref_lse = flash_variant_ref(q, k, v, CLAMP_V1)
    _check(out, ref)
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    _check(flash_variant(q, k, v, "v4", 64, 128), flash_variant_ref(q, k, v, CLAMP_EXP)[0])


def test_flash_variant_rejects_what_it_does_not_take(gen):
    q = torch.randn(2, 256, 64, generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError):
        flash_variant(q, q, q, "v1", 512, 512)  # a TPU-sized tile pair, not on the menu
    with pytest.raises(ValueError):
        flash_variant(q.float(), q.float(), q.float(), "v2", 128, 64)  # fp32 has (64, 64) only
    with pytest.raises(ValueError):
        flash_variant(q[:, :192].contiguous(), q, q, "v1", 128, 64)  # Nq % bq != 0
    with pytest.raises(ValueError, match="contiguous"):
        flash_variant(q.transpose(0, 1).contiguous().transpose(0, 1), q, q, "v1")
    with pytest.raises(TypeError):
        flash_variant(q.half(), q.half(), q.half(), "v1")
    with pytest.raises(ValueError):
        flash_variant(q, q.cpu(), q, "v1")
    with pytest.raises(ValueError, match="unknown variant"):
        flash_variant(q, q, q, "v9")
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_variant(q.requires_grad_(True), q, q, "v2")
    assert smem_bytes(128, 128, True, torch.bfloat16) <= 232448
    with pytest.raises(ValueError):
        smem_bytes(128, 128, False, torch.float32)
