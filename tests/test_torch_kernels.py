"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. They build with nvcc from udifftext_tpu_torch/csrc on first use,
so these tests need an NVIDIA GPU (sm_90a) and skip elsewhere:

    python -m pytest tests/test_torch_kernels.py -q -m cuda

Tolerances: fp32 1e-5 relative (summation order); bf16 outputs within two
bf16 ulps of the largest reference value (one rounding of the output).
Gradients through autograd against the plain versions' autograd: bf16
within four ulps of the largest gradient (the kernel's delta reads the
bf16-rounded output, the plain softmax backward the fp32 one), fp32 1e-4
of the largest gradient."""

import pytest
import torch

from udifftext_tpu_torch.ops import attention as A
from udifftext_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from udifftext_tpu_torch.ops.geglu import geglu_ff, geglu_ff_ref

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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_grads_match_plain_autograd(gen, dtype):
    q, k, v = (torch.randn(2, 1024, 4, 64, generator=gen, device="cuda").to(dtype)
               .requires_grad_(True) for _ in range(3))
    do = torch.randn(2, 1024, 4, 64, generator=gen, device="cuda").to(dtype)
    before = flash_attention_bwd.launches
    got = torch.autograd.grad(A.sdpa(q, k, v), (q, k, v), do)
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
