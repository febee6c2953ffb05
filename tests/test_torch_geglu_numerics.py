"""The numerics and the launch plan of the `wgmma` GEGLU kernel, on the CPU.

The "mma" route of udifftext_tpu_torch/csrc/geglu.cu (bf16, C % 64 == 0)
walks the hidden dimension in chunks of 64 (from C = 768 on, 128) units,
rounds act to bf16 per chunk, sums each split of the hidden dimension in
fp32 and adds the splits' sums in order. `geglu_ff_tiled_ref` is that order
of operations in plain PyTorch. Here it is held

- against the plain versions `geglu_ff_ref` / `geglu_ff_ln_ref` at the
  tolerance the card holds the kernel to (chip_smoke.py `bf16_tol`: two bf16
  ulps of the largest reference value, floor 1), for bf16;
- against the JAX package's `_geglu_ref` / `geglu_ff_ln_ref` in fp32 at
  tests/test_torch_ops.py's tolerance (1e-5: summation order only);

and `geglu_plan` and `geglu_kernel_route` are checked as pure functions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import assert_close
from udifftext_tpu.ops import geglu as JG
from udifftext_tpu_torch.ops.geglu import (
    MMA_TILES,
    GegluPlan,
    geglu_ff_ln_ref,
    geglu_ff_ref,
    geglu_ff_tiled_ref,
    geglu_kernel_route,
    geglu_plan,
)

RTOL, ATOL = 1e-5, 1e-6  # tests/test_torch_ops.py
SMS = 132                # an H100's multiprocessors
BF16, F32 = torch.bfloat16, torch.float32


def _inputs(m, c, seed=0, dtype=BF16, x_scale=1.0):
    """x, w1 (2I, C), b1, w2 (C, I), b2 and a LayerNorm's (scale, bias) from a numpy seed."""
    rs = np.random.RandomState(seed)
    i = 4 * c

    def r(*s, scale=1.0):
        return torch.from_numpy(rs.standard_normal(s).astype(np.float32) * scale)

    ff = [r(m, c, scale=x_scale), r(2 * i, c, scale=c**-0.5), r(2 * i, scale=0.1),
          r(c, i, scale=i**-0.5), r(c, scale=0.1)]
    return [t.to(dtype) for t in ff], (1 + 0.1 * r(c), 0.1 * r(c))


def _out_tol(ref):
    """chip_smoke.py `bf16_tol`."""
    return 2**-7 * max(1.0, float(ref.float().abs().max()))


@pytest.mark.parametrize("m,c,splits,chunk", [
    (96, 64, 1, 64), (96, 64, 4, 64), (70, 128, 2, 64), (40, 320, 1, 64), (40, 320, 4, 64),
    (33, 256, 8, 128), (20, 640, 2, 64),
])
@pytest.mark.parametrize("with_ln", [False, True])
def test_tiled_order_within_the_cards_tolerance(m, c, splits, chunk, with_ln):
    ff, ln = _inputs(m, c, seed=c + splits, x_scale=3.0 if with_ln else 1.0)
    if with_ln:
        want = geglu_ff_ln_ref(ff[0], *ln, *ff[1:])
    else:
        want = geglu_ff_ref(*ff)
    got = geglu_ff_tiled_ref(*ff, splits, chunk, ln=ln if with_ln else None)
    assert got.dtype == BF16 and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= 0.5 * _out_tol(want), (err, _out_tol(want))  # one ulp: half the card's tolerance


@pytest.mark.parametrize("splits,chunk", [(1, 64), (2, 64), (4, 32), (1, 128)])
@pytest.mark.parametrize("with_ln", [False, True])
def test_tiled_order_matches_the_jax_reference_in_fp32(splits, chunk, with_ln):
    """In fp32 the chunks and splits only reorder sums: the JAX package's
    plain references, the port's plain versions and the tiled order agree."""
    ff, ln = _inputs(24, 64, seed=7, dtype=F32)
    x, w1, b1, w2, b2 = (t.numpy() for t in ff)
    jargs = [jnp.asarray(a) for a in (w1.T, b1, w2.T, b2)]  # the JAX package's (in, out) layout
    if with_ln:
        want = JG.geglu_ff_ln_ref(jnp.asarray(x), jnp.asarray(ln[0].numpy()),
                                  jnp.asarray(ln[1].numpy()), *jargs)
        plain = geglu_ff_ln_ref(ff[0], *ln, *ff[1:])
    else:
        want = JG._geglu_ref(jnp.asarray(x), *jargs)
        plain = geglu_ff_ref(*ff)
    assert_close(plain, want, RTOL, ATOL, "plain version")
    assert_close(geglu_ff_tiled_ref(*ff, splits, chunk, ln=ln if with_ln else None), want,
                 RTOL, ATOL, "tiled order")


TOKENS = {320: 4096, 640: 1024, 1280: 256}  # the UNet's widths and their latent tokens


@pytest.mark.parametrize("b", [1, 2, 16, 20, 32])
@pytest.mark.parametrize("c", [320, 640, 1280])
def test_plan_at_the_unet_shapes(c, b):
    m, inner = b * TOKENS[c], 4 * c
    plan = geglu_plan(BF16, m, c, inner, SMS)
    assert isinstance(plan, GegluPlan) and plan.route == "mma"
    chunk = 128 if c == 1280 else 64
    ctas = 2 if c == 1280 else 1  # CTAs that share a block's rows
    assert plan.rows in ((64, 128) if c == 320 else (64,))
    assert plan.rows == (128 if c == 320 and m // 64 > SMS else 64)
    assert (inner // chunk) % plan.splits == 0
    blocks = -(-m // plan.rows) * ctas
    if plan.splits > 1:  # a split never pushes the grid past the card
        assert blocks * plan.splits <= SMS
    else:                # and where it would fit twice over, the plan does split
        assert blocks * 2 > SMS
    # one launch unless fp32 partial sums go through device memory, and those
    # stay under the bytes of the weights
    assert (plan.launches == 1) == (plan.partial_bytes == 0)
    assert plan.partial_bytes in (0, plan.splits * m * c * 4)
    assert plan.partial_bytes <= 3 * c * inner * 2
    if plan.splits == 1 or c < 1280:
        assert plan.launches == 1 and plan.partial_bytes == 0
    if b >= 16:
        assert plan.splits == 1 and plan.launches == 1


@pytest.mark.parametrize("m,c,want", [
    (2 * 4096, 320, GegluPlan("mma", 64, 1, 1, 0)),
    (20 * 4096, 320, GegluPlan("mma", 128, 1, 1, 0)),
    (2 * 1024, 640, GegluPlan("mma", 64, 4, 1, 0)),
    (20 * 1024, 640, GegluPlan("mma", 64, 1, 1, 0)),
    (2 * 256, 1280, GegluPlan("mma", 64, 8, 2, 8 * 512 * 1280 * 4)),
    (20 * 256, 1280, GegluPlan("mma", 64, 1, 1, 0)),
    (100, 96, GegluPlan("wmma", 64, 2, 2, 2 * 100 * 96 * 4)),
    (2048, 1296, GegluPlan("wmma", 16, 1, 2, 2048 * 1296 * 4)),  # 81 chunks: no even split
])
def test_plan_cases(m, c, want):
    assert geglu_plan(BF16, m, c, 4 * c, SMS) == want
    assert geglu_plan(F32, m, c, 4 * c, SMS) == GegluPlan("fma", 16, 1, 1, 0)


def test_plan_rejects_a_hidden_width_the_chunks_do_not_divide():
    with pytest.raises(ValueError):
        geglu_plan(BF16, 512, 1280, 5120 - 64, SMS)


@pytest.mark.parametrize("dtype,c,want", [
    (BF16, 320, "mma"), (BF16, 640, "mma"), (BF16, 1280, "mma"), (BF16, 64, "mma"),
    (BF16, 384, "mma"), (BF16, 1024, "mma"),
    (BF16, 448, "wmma"), (BF16, 960, "wmma"), (BF16, 48, "wmma"), (BF16, 1344, "wmma"),
    (F32, 320, "fma"), (F32, 100, "fma"),
])
def test_kernel_route(dtype, c, want):
    assert geglu_kernel_route(dtype, c) == want
    assert (want == "mma") == (dtype == BF16 and c % 64 == 0 and c // 64 in MMA_TILES)


@pytest.mark.parametrize("dtype,c,exc", [
    (BF16, 40, ValueError), (BF16, 4096, ValueError), (F32, 0, ValueError),
    (torch.float16, 320, TypeError),
])
def test_kernel_route_raises(dtype, c, exc):
    with pytest.raises(exc):
        geglu_kernel_route(dtype, c)
