"""The numerics of the tensor-core flash kernels, settled on the CPU.

The "mma" kernels (udifftext_tpu_torch/csrc/flash_attention.cu and
flash_attention_bwd.cu, bf16 with D = 64) round p, and in the backward ds,
to bf16 before the second product, where the fp32-FMA kernels keep them in
fp32. `flash_attention_tiled_ref` / `flash_attention_bwd_tiled_ref` walk the
tiles as those kernels do, roundings included. Here they are held

- against the plain versions at the tolerances the card holds the kernels to:
  two bf16 ulps of the largest reference value for bf16 outputs (floor 1),
  1e-4 for lse, two bf16 ulps of each gradient's largest entry; in fp32
  1e-5 relative (summation order only);
- against the JAX package's `_xla_sdpa` and `jax.vjp` of it, in fp32 at
  tests/test_torch_ops.py's tolerances, the plain versions beside them;

and the wrapper's route and alignment rules are checked as pure functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import assert_close
from udifftext_tpu.ops.attention import _xla_sdpa
from udifftext_tpu_torch.ops.flash_attention import (
    BLOCK,
    BLOCK_Q,
    aligned16,
    flash_attention_bwd_ref,
    flash_attention_bwd_tiled_ref,
    flash_attention_ref,
    flash_attention_tiled_ref,
    flash_kernel_route,
)

RTOL, ATOL = 1e-5, 1e-6  # tests/test_torch_ops.py


def _inputs(b, nq, nk, h, d=64, seed=0, scales=(1.0, 1.0, 1.0), dtype=torch.bfloat16):
    """q, k, v, dout from a numpy seed, rounded to `dtype`."""
    rs = np.random.RandomState(seed)
    shapes = ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d), (b, nq, h, d))
    return [torch.from_numpy(rs.standard_normal(s).astype(np.float32) * sc).to(dtype)
            for s, sc in zip(shapes, (*scales, 1.0))]


def _out_tol(ref: torch.Tensor) -> float:
    """chip_smoke.py `bf16_tol`: two bf16 ulps of the largest reference value."""
    return 2**-7 * max(1.0, float(ref.float().abs().max()))


def _grad_tol(ref: torch.Tensor) -> float:
    """chip_smoke.py `grad_tol` for bf16: two ulps of the gradient's largest entry."""
    return 2**-7 * float(ref.float().abs().max())


def _max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


# (id, B, Nq, Nk, H, scale, (q, k, v) input scales); "hot" drives logits far beyond ±75
BF16_CASES = [
    ("512x2", 1, 512, 512, 2, None, (1.0, 1.0, 1.0)),
    ("4096_long_sum", 1, 4096, 4096, 1, None, (1.0, 1.0, 1.0)),
    ("nq512_nk1024", 1, 512, 1024, 2, None, (1.0, 1.0, 1.0)),
    ("nq1024_nk512", 1, 1024, 512, 1, None, (1.0, 1.0, 1.0)),
    ("scale0.3", 1, 512, 512, 2, 0.3, (1.0, 1.0, 1.0)),
    ("hot", 1, 512, 512, 2, None, (9.0, 2.4, 0.3)),
]


@pytest.mark.parametrize("b,nq,nk,h,scale,scales", [c[1:] for c in BF16_CASES],
                         ids=[c[0] for c in BF16_CASES])
def test_tiled_forward_within_card_tolerance_bf16(b, nq, nk, h, scale, scales):
    q, k, v, _ = _inputs(b, nq, nk, h, scales=scales)
    ref, ref_lse = flash_attention_ref(q, k, v, scale)
    out, lse = flash_attention_tiled_ref(q, k, v, scale)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape and lse.dtype == torch.float32
    assert _max_err(out, ref) <= _out_tol(ref)
    assert _max_err(lse, ref_lse) <= 1e-4
    if scales[0] > 1:  # a softmax clamped at ±75 would differ here; the running max does not
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 64**-0.5
        assert float(logits.abs().max()) > 80


@pytest.mark.parametrize("b,nq,nk,h,scale,scales", [c[1:] for c in BF16_CASES],
                         ids=[c[0] for c in BF16_CASES])
def test_tiled_backward_within_card_tolerance_bf16(b, nq, nk, h, scale, scales):
    q, k, v, do = _inputs(b, nq, nk, h, seed=1, scales=scales)
    out, lse = flash_attention_ref(q, k, v, scale)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, scale)
    got = flash_attention_bwd_tiled_ref(q, k, v, out, lse, do, scale)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _max_err(g, w) <= _grad_tol(w), f"d{name}"


@pytest.mark.parametrize("bq,bk", [(BLOCK_Q, BLOCK), (64, 64), (64, 128)])
def test_tiled_versions_match_plain_fp32(bq, bk):
    q, k, v, do = _inputs(2, 256, 384, 2, seed=2, dtype=torch.float32)
    ref, ref_lse = flash_attention_ref(q, k, v)
    out, lse = flash_attention_tiled_ref(q, k, v, None, bq, bk)
    assert_close(out, ref.numpy(), RTOL, ATOL, "tiled out")
    assert_close(lse, ref_lse.numpy(), RTOL, ATOL, "tiled lse")
    want = flash_attention_bwd_ref(q, k, v, ref, ref_lse, do)
    got = flash_attention_bwd_tiled_ref(q, k, v, ref, ref_lse, do, None, 64, bk)
    for name, g, w in zip("qkv", got, want):
        assert_close(g, w.numpy(), RTOL, 1e-5 * float(w.abs().max()), f"tiled d{name}")


@pytest.mark.parametrize("tiled", [False, True], ids=["plain", "tiled"])
@pytest.mark.parametrize("b,nq,nk,h,scale", [(2, 128, 192, 2, None), (1, 256, 128, 3, 0.3)])
def test_forward_and_backward_match_jax(b, nq, nk, h, scale, tiled):
    """Both versions against `_xla_sdpa` and `jax.vjp` of it: the JAX flash
    kernels' function as the CPU suite reaches it (the Pallas kernels run only
    on a TPU). Logits stay far below the TPU kernel's ±75 clamp."""
    q, k, v, g = (t.numpy() for t in _inputs(b, nq, nk, h, seed=3, dtype=torch.float32))
    want, vjp = jax.vjp(lambda q_, k_, v_: _xla_sdpa(q_, k_, v_, scale=scale),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(g))
    fwd = flash_attention_tiled_ref if tiled else flash_attention_ref
    bwd = flash_attention_bwd_tiled_ref if tiled else flash_attention_bwd_ref
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = fwd(tq, tk, tv, scale)
    assert_close(out, want, RTOL, ATOL, "out")
    for name, gt, wt in zip("qkv", bwd(tq, tk, tv, out, lse, tg, scale), want_grads):
        assert_close(gt, wt, RTOL, 1e-5 * float(np.abs(np.asarray(wt)).max()), f"d{name}")


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 128, "fma"),
    (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"),
])
def test_route_of_every_pair_the_wrapper_takes(dtype, d, want):
    assert flash_kernel_route(dtype, d) == want


@pytest.mark.parametrize("dtype,d,error", [
    (torch.float16, 64, TypeError),
    (torch.float64, 64, TypeError),
    (torch.bfloat16, 32, ValueError),
    (torch.float32, 512, ValueError),
])
def test_route_raises_on_what_no_kernel_takes(dtype, d, error):
    with pytest.raises(error):
        flash_kernel_route(dtype, d)


def _address(t: torch.Tensor) -> int:
    """Byte offset of the view's first element in a 16-byte-aligned buffer."""
    return t.storage_offset() * t.element_size()


def test_alignment_predicate():
    base = torch.zeros(2, 256, 3, 4, 64, dtype=torch.bfloat16)  # a fused q/k/v projection
    for t in base.unbind(2):  # (B, N, H, D) views, token stride 3·H·D: taken
        assert aligned16(_address(t), t.stride(), 2)
    flat = torch.zeros(2 * 256 * 4 * 64 + 8, dtype=torch.bfloat16)
    ok = flat[8:].view(2, 256, 4, 64)      # 16 bytes in
    off8 = flat[4:-4].view(2, 256, 4, 64)  # 8 bytes in: refused
    assert aligned16(_address(ok), ok.stride(), 2)
    assert not aligned16(_address(off8), off8.stride(), 2)
    # hand-made cases: (address, strides in elements, itemsize)
    assert aligned16(0, (65536, 256, 64, 1), 2)
    assert aligned16(32, (65536, 768, 64, 1), 2)
    assert not aligned16(0, (65540, 260, 64, 1), 2)     # strides of 4 elements = 8 bytes
    assert not aligned16(0, (65536, 256, 64, 2), 2)     # last dimension not contiguous
    assert not aligned16(2, (65536, 256, 64, 1), 2)
    assert aligned16(0, (1028, 4, 4, 1), 4)             # fp32: 4 elements are 16 bytes
