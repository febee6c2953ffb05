"""The port's kernel modules on the CPU, where their wrappers run the plain
PyTorch versions: flash attention and the sdpa dispatch against the JAX
build's `_xla_sdpa`, the flash backward against `jax.vjp` of `_xla_sdpa`,
the GEGLU feed-forward against `_geglu_ref` and its autograd backward
against `_geglu_bwd`. fp32 throughout; tolerance 1e-5 relative (summation
order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import assert_close
from udifftext_tpu.ops.attention import _xla_sdpa
from udifftext_tpu.ops.geglu import _geglu_bwd, _geglu_ref
from udifftext_tpu_torch.ops import attention as A
from udifftext_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_ref,
)
from udifftext_tpu_torch.ops.geglu import geglu_ff

RTOL, ATOL = 1e-5, 1e-6


def _qkv(b, nq, nk, h, d, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(s).astype(np.float32)
            for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d))]


@pytest.mark.parametrize("b,nq,nk,h,d", [
    (2, 512, 512, 2, 64),    # a flash-gated shape (plain here: CPU tensors)
    (1, 256, 256, 4, 64),    # ds4: N < 512
    (2, 320, 192, 2, 64),    # N % 128 != 0
    (1, 64, 64, 1, 512),     # the VAE's single d=512 head
])
def test_sdpa_matches_xla(b, nq, nk, h, d):
    q, k, v = _qkv(b, nq, nk, h, d)
    want = _xla_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = A.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert_close(got, want, RTOL, ATOL, "sdpa")


@pytest.mark.parametrize("scale", [None, 0.3])
def test_flash_attention_plain_matches_xla_and_lse(scale):
    q, k, v = _qkv(2, 256, 384, 3, 64, seed=1)
    want = _xla_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale)
    out, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               scale)
    assert_close(out, want, RTOL, ATOL, "flash out")
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) * (scale or 64**-0.5)
    m = s.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (2, 3, 256) and lse.dtype == torch.float32
    assert_close(lse, want_lse, RTOL, ATOL, "lse")


@pytest.mark.parametrize("nq,nk,d,want", [
    (4096, 4096, 64, True),   # ds1
    (1024, 1024, 64, True),   # ds2
    (640, 640, 128, True),
    (256, 256, 64, False),    # ds4
    (64, 64, 64, False),      # middle block
    (576, 576, 64, False),    # N % 128 != 0
    (1024, 960, 64, False),
    (4096, 4096, 512, False),  # VAE mid-attention
    (1024, 1024, 32, False),
])
def test_flash_gate(nq, nk, d, want):
    assert A.flash_shape_ok(nq, nk, d) is want
    q = torch.zeros(1, nq, 1, d)
    assert A.flash_ok(q, torch.zeros(1, nk, 1, d)) is False  # CPU tensors stay plain


@pytest.mark.parametrize("dtype,nq,d,want", [
    (torch.bfloat16, 4096, 64, True), (torch.bfloat16, 1024, 64, True),
    (torch.bfloat16, 640, 128, True), (torch.bfloat16, 256, 64, False),
    (torch.float32, 4096, 64, False), (torch.float32, 1024, 64, False),  # the plain path is faster
    (torch.float16, 1024, 64, False),  # no flash kernel takes fp16
])
def test_flash_auto_gate_by_dtype_and_shape(dtype, nq, d, want):
    assert A.flash_dtype_ok(dtype) is (dtype == torch.bfloat16)
    assert A.flash_auto_ok(dtype, nq, nq, d) is want


@pytest.mark.parametrize("b,n,c", [(2, 128, 32), (1, 96, 64)])
def test_geglu_plain_matches_jax_ref(b, n, c):
    rs = np.random.RandomState(2)
    inner = 4 * c
    x = rs.standard_normal((b, n, c)).astype(np.float32)
    w1 = (rs.standard_normal((c, 2 * inner)) / np.sqrt(c)).astype(np.float32)  # JAX (in, out)
    b1 = (0.1 * rs.standard_normal(2 * inner)).astype(np.float32)
    w2 = (rs.standard_normal((inner, c)) / np.sqrt(inner)).astype(np.float32)
    b2 = (0.1 * rs.standard_normal(c)).astype(np.float32)
    want = _geglu_ref(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    t = torch.from_numpy
    got = geglu_ff(t(x), t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2))
    assert_close(got, want, RTOL, ATOL, "geglu")


def _grad_tol(want) -> float:
    """1e-5 of the gradient's largest entry: fp32 summation order only."""
    return 1e-5 * float(np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("b,nq,nk,h,d,scale", [
    (2, 128, 192, 2, 64, None),
    (1, 64, 64, 3, 128, 0.3),
])
def test_flash_bwd_plain_matches_jax_vjp(b, nq, nk, h, d, scale):
    """flash_attention_bwd (plain here) and the autograd Function around the
    forward against jax.vjp of `_xla_sdpa`. Logits stay far below the TPU
    kernel's ±75 clamp (|s·scale| < 10), where the clamp-free p agrees."""
    q, k, v = _qkv(b, nq, nk, h, d, seed=3)
    g = np.random.RandomState(4).standard_normal((b, nq, h, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda q_, k_, v_: _xla_sdpa(q_, k_, v_, scale=scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = flash_attention_ref(tq, tk, tv, scale)
    got = flash_attention_bwd(tq, tk, tv, out, lse, torch.from_numpy(g), scale)
    for name, gt, wt in zip("qkv", got, want):
        assert_close(gt, wt, RTOL, _grad_tol(wt), f"d{name} (flash_attention_bwd)")

    tq, tk, tv = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    out, lse = flash_attention(tq, tk, tv, scale)
    assert not lse.requires_grad
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, gt, wt in zip("qkv", got, want):
        assert_close(gt, wt, RTOL, _grad_tol(wt), f"d{name} (autograd)")


@pytest.mark.parametrize("needs", [(True,) * 5, (True, False, False, False, False)],
                         ids=["all_grads", "input_grad_only"])
def test_geglu_autograd_matches_jax_bwd(needs):
    """The GEGLU Function's backward against the JAX build's `_geglu_bwd`,
    called directly; only the gradients autograd asks for are computed."""
    rs = np.random.RandomState(5)
    b, n, c = 2, 64, 32
    inner = 4 * c
    x = rs.standard_normal((b, n, c)).astype(np.float32)
    w1 = (rs.standard_normal((c, 2 * inner)) / np.sqrt(c)).astype(np.float32)  # JAX (in, out)
    b1 = (0.1 * rs.standard_normal(2 * inner)).astype(np.float32)
    w2 = (rs.standard_normal((inner, c)) / np.sqrt(inner)).astype(np.float32)
    b2 = (0.1 * rs.standard_normal(c)).astype(np.float32)
    g = rs.standard_normal((b, n, c)).astype(np.float32)
    want = _geglu_bwd(None, tuple(jnp.asarray(a) for a in (x, w1, b1, w2, b2)), jnp.asarray(g))
    want = [want[0], want[1].T, want[2], want[3].T, want[4]]  # to PyTorch's Linear layout

    t = torch.from_numpy
    ins = [t(x), t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2)]
    ins = [a.requires_grad_(need) for a, need in zip(ins, needs)]
    out = geglu_ff(*ins)
    got = torch.autograd.grad(out, [a for a in ins if a.requires_grad], t(g))
    wanted = [w for w, need in zip(want, needs) if need]
    for i, (gt, wt) in enumerate(zip(got, wanted)):
        assert_close(gt, wt, RTOL, _grad_tol(wt), f"geglu grad {i}")


def test_plain_paths_count_no_launches():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 128, 128, 1, 64))
    before = (flash_attention.launches, flash_attention_bwd.launches, geglu_ff.launches)
    out, lse = flash_attention(q, k, v)
    flash_attention_bwd(q, k, v, out, lse, torch.ones_like(out))
    geglu_ff(torch.zeros(1, 4, 8), torch.zeros(64, 8), torch.zeros(64), torch.zeros(8, 32),
             torch.zeros(8))
    assert (flash_attention.launches, flash_attention_bwd.launches, geglu_ff.launches) == before
