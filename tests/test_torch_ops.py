"""The port's kernel modules on the CPU, where their wrappers run the plain
PyTorch versions: flash attention and the sdpa dispatch against the JAX
build's `_xla_sdpa`, the GEGLU feed-forward against `_geglu_ref`. fp32
throughout; tolerance 1e-5 relative (summation order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import assert_close
from udifftext_tpu.ops.attention import _xla_sdpa
from udifftext_tpu.ops.geglu import _geglu_ref
from udifftext_tpu_torch.ops import attention as A
from udifftext_tpu_torch.ops.flash_attention import flash_attention
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


def test_plain_paths_count_no_launches():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 128, 128, 1, 64))
    before = (flash_attention.launches, geglu_ff.launches)
    flash_attention(q, k, v)
    geglu_ff(torch.zeros(1, 4, 8), torch.zeros(64, 8), torch.zeros(64), torch.zeros(8, 32),
             torch.zeros(8))
    assert (flash_attention.launches, geglu_ff.launches) == before
