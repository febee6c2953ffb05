"""The port's fused-glue ops and transformer block on the CPU, where the
wrappers run their plain PyTorch versions, against the JAX build.

The JAX side runs its `*_ref` functions (its Pallas bodies run only on a
TPU) and its flax modules with `fuse_glue="force"`, which takes the same
reference compositions off-TPU. Inputs and weights are numpy arrays from a
seed; JAX kernels (C, F) are transposed into PyTorch's Linear layout (F, C).
Tolerances: fp32 functions 1e-5 relative and absolute (summation order only),
gradients 1e-4 of the gradient's largest entry, bf16 blocks 2e-2 relative L2
(the two builds round at different points: per product, and the JAX
reference rounds the t_attn projection before the residual add where the port
adds in fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import assert_close, flax_params
from udifftext_tpu.models import attention as JA
from udifftext_tpu.ops import cross_attention as JX
from udifftext_tpu.ops import geglu as JG
from udifftext_tpu.ops import ln_gemm as JL
from udifftext_tpu_torch.models import attention as PA
from udifftext_tpu_torch.models.layers import cast_weights
from udifftext_tpu_torch.ops import cross_attention as PX
from udifftext_tpu_torch.ops import geglu as PG
from udifftext_tpu_torch.ops import ln_gemm as PL
from udifftext_tpu_torch.scripts import glue_fusion_probe, ln_gemm_probe
from udifftext_tpu_torch.utils.convert import unet_from_jax

RTOL, ATOL = 1e-5, 1e-5
T = torch.from_numpy
# (B, N, C, heads, dim_head): the tiny shape, and one with 64-wide heads
SHAPES = [(2, 128, 32, 4, 8), (1, 128, 128, 2, 64)]
L, TDIM = 12, 16


def _rs(seed):
    return np.random.RandomState(seed)


def _f32(a):
    return np.asarray(a, np.float32)


def _ln_inputs(b, n, c, seed):
    rs = _rs(seed)
    x = _f32(rs.standard_normal((b, n, c)) * 1.5 + 0.3)
    scale = _f32(1.0 + 0.1 * rs.standard_normal(c))
    bias = _f32(0.1 * rs.standard_normal(c))
    return rs, x, scale, bias


def _kernel(rs, fan_in, fan_out):
    """A JAX-layout (in, out) weight."""
    return _f32(rs.standard_normal((fan_in, fan_out)) / np.sqrt(fan_in))


def _lin(w):
    """JAX (in, out) → PyTorch Linear (out, in)."""
    return T(np.ascontiguousarray(w.T))


def _grad_close(got, want, what):
    want = np.asarray(want)
    assert_close(got, want, 0.0, 1e-4 * float(np.abs(want).max()), what)


# -- (a) plain versions against the JAX references, (b) their gradients --------


@pytest.mark.parametrize("b,n,c,heads,dh", SHAPES)
def test_ln_ref_f32_matches_jax(b, n, c, heads, dh):
    _, x, s, bi = _ln_inputs(b, n, c, 0)
    want = JL.ln_ref_f32(jnp.asarray(x), jnp.asarray(s), jnp.asarray(bi))
    assert_close(PL.ln_ref_f32(T(x), T(s), T(bi)), want, RTOL, ATOL, "ln_ref_f32")
    got16 = PL.ln_ref_f32(T(x).bfloat16(), T(s), T(bi))
    assert got16.dtype == torch.bfloat16  # fp32 statistics, output in x's dtype
    want16 = JL.ln_ref_f32(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(s), jnp.asarray(bi))
    # one bf16 ulp: the two fp32 results may round to neighbouring values
    assert_close(got16, want16.astype(jnp.float32), 2**-7, 1e-6, "ln_ref_f32 bf16")


@pytest.mark.parametrize("b,n,c,heads,dh", SHAPES)
def test_ln_gemm_matches_jax_ref_and_grad(b, n, c, heads, dh):
    rs, x, s, bi = _ln_inputs(b, n, c, 1)
    w = _kernel(rs, c, 3 * c)
    g = _f32(rs.standard_normal((b, n, 3 * c)))
    jin = tuple(jnp.asarray(a) for a in (x, s, bi, w))
    want = JL.ln_gemm_ref(*jin)
    pin = [T(x), T(s), T(bi), _lin(w)]
    assert_close(PL.ln_gemm_ref(*pin), want, RTOL, ATOL, "ln_gemm_ref")
    assert_close(PL.ln_gemm(*pin), want, RTOL, ATOL, "ln_gemm (plain on the CPU)")

    jgrads = jax.grad(lambda *a: jnp.sum(JL.ln_gemm_ref(*a) * g), argnums=(0, 1, 2, 3))(*jin)
    pin = [t.requires_grad_(True) for t in pin]
    grads = torch.autograd.grad(PL.ln_gemm(*pin), pin, T(g))
    for name, got, wantg in zip(("dx", "dscale", "dbias", "dw"), grads, jgrads):
        _grad_close(got, wantg.T if name == "dw" else wantg, f"ln_gemm {name}")


@pytest.mark.parametrize("b,n,c,heads,dh", SHAPES)
def test_ln_gemm3_matches_jax_ref_and_grad(b, n, c, heads, dh):
    rs, x, s, bi = _ln_inputs(b, n, c, 2)
    ws = [_kernel(rs, c, c) for _ in range(3)]
    gs = [_f32(rs.standard_normal((b, n, c))) for _ in range(3)]
    jin = tuple(jnp.asarray(a) for a in (x, s, bi, *ws))
    want = JL.ln_gemm3_ref(*jin)
    pin = [T(x), T(s), T(bi)] + [_lin(w) for w in ws]
    for name, got, ref, wt in zip("qkv", PL.ln_gemm3(*pin), PL.ln_gemm3_ref(*pin), want):
        assert_close(ref, wt, RTOL, ATOL, f"ln_gemm3_ref {name}")
        assert_close(got, wt, RTOL, ATOL, f"ln_gemm3 {name} (plain on the CPU)")

    def jloss(*a):
        return sum(jnp.sum(o * g) for o, g in zip(JL.ln_gemm3_ref(*a), gs))

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(*jin)
    pin = [t.requires_grad_(True) for t in pin]
    grads = torch.autograd.grad(PL.ln_gemm3(*pin), pin, [T(g) for g in gs])
    for i, (got, wantg) in enumerate(zip(grads, jgrads)):
        _grad_close(got, wantg.T if i >= 3 else wantg, f"ln_gemm3 grad {i}")


def _cross_inputs(b, n, c, heads, dh, l, seed):
    rs, x, s, bi = _ln_inputs(b, n, c, seed)
    inner = heads * dh
    wq, wo = _kernel(rs, c, inner), _kernel(rs, inner, c)
    k = _f32(rs.standard_normal((b, l, heads, dh)))
    v = _f32(rs.standard_normal((b, l, heads, dh)))
    bo = _f32(0.1 * rs.standard_normal(c))
    jin = tuple(jnp.asarray(a) for a in (x, s, bi, wq, k, v, wo, bo))
    pin = [T(x), T(s), T(bi), _lin(wq), T(k), T(v), _lin(wo), T(bo)]
    return rs, jin, pin


@pytest.mark.parametrize("l", [12, 2, 16, 64])
@pytest.mark.parametrize("b,n,c,heads,dh", SHAPES)
def test_fused_cross_attention_matches_jax_ref_and_grad(b, n, c, heads, dh, l):
    rs, jin, pin = _cross_inputs(b, n, c, heads, dh, l, 3)
    g = _f32(rs.standard_normal((b, n, c)))
    want = JX.fused_cross_attention_ref(*jin, heads)
    assert_close(PX.fused_cross_attention_ref(*pin, heads), want, RTOL, ATOL, "ref")
    assert_close(PX.fused_cross_attention(*pin, heads), want, RTOL, ATOL, "plain on the CPU")

    jgrads = jax.grad(lambda *a: jnp.sum(JX.fused_cross_attention_ref(*a, heads) * g),
                      argnums=tuple(range(8)))(*jin)
    pin = [t.requires_grad_(True) for t in pin]
    grads = torch.autograd.grad(PX.fused_cross_attention(*pin, heads), pin, T(g))
    for i, (got, wantg) in enumerate(zip(grads, jgrads)):
        _grad_close(got, wantg.T if i in (3, 6) else wantg, f"fused_cross_attention grad {i}")


@pytest.mark.parametrize("b,n,c,heads,dh", SHAPES)
def test_geglu_ff_ln_matches_jax_ref_and_grad(b, n, c, heads, dh):
    rs, x, s, bi = _ln_inputs(b, n, c, 4)
    inner = 4 * c
    w1, w2 = _kernel(rs, c, 2 * inner), _kernel(rs, inner, c)
    b1, b2 = _f32(0.1 * rs.standard_normal(2 * inner)), _f32(0.1 * rs.standard_normal(c))
    g = _f32(rs.standard_normal((b, n, c)))
    jin = tuple(jnp.asarray(a) for a in (x, s, bi, w1, b1, w2, b2))
    want = JG.geglu_ff_ln_ref(*jin)
    pin = [T(x), T(s), T(bi), _lin(w1), T(b1), _lin(w2), T(b2)]
    assert_close(PG.geglu_ff_ln_ref(*pin), want, RTOL, ATOL, "geglu_ff_ln_ref")
    assert_close(PG.geglu_ff_ln(*pin), want, RTOL, ATOL, "geglu_ff_ln (plain on the CPU)")

    jgrads = jax.grad(lambda *a: jnp.sum(JG.geglu_ff_ln_ref(*a) * g),
                      argnums=tuple(range(7)))(*jin)
    pin = [t.requires_grad_(True) for t in pin]
    grads = torch.autograd.grad(PG.geglu_ff_ln(*pin), pin, T(g))
    for i, (got, wantg) in enumerate(zip(grads, jgrads)):
        _grad_close(got, wantg.T if i in (3, 5) else wantg, f"geglu_ff_ln grad {i}")


@pytest.mark.parametrize("op", ["ln_gemm", "ln_gemm3", "fused_cross_attention", "geglu_ff_ln"])
def test_backward_computes_only_the_gradients_asked_for(op, monkeypatch):
    """Only x asks for a gradient: the weights' leaves of the recompute do
    not require one, and the result equals the full computation's dx."""
    b, n, c, heads, dh = SHAPES[0]
    rs, x, s, bi = _ln_inputs(b, n, c, 5)
    if op == "ln_gemm":
        fn, rest = PL.ln_gemm, [T(s), T(bi), _lin(_kernel(rs, c, 48))]
    elif op == "ln_gemm3":
        fn, rest = (lambda *a: sum(PL.ln_gemm3(*a))), [T(s), T(bi)] + [
            _lin(_kernel(rs, c, c)) for _ in range(3)]
    elif op == "fused_cross_attention":
        _, _, pin = _cross_inputs(b, n, c, heads, dh, L, 5)
        fn, rest = (lambda *a: PX.fused_cross_attention(*a, heads)), pin[1:]
    else:
        fn, rest = PG.geglu_ff_ln, [T(s), T(bi), _lin(_kernel(rs, c, 8 * c)), torch.zeros(8 * c),
                                    _lin(_kernel(rs, 4 * c, c)), torch.zeros(c)]
    seen = []
    orig = PL.recompute_grads

    def spy(f, inputs, needs, g):
        seen.append(tuple(needs))
        return orig(f, inputs, needs, g)

    for mod in (PL, PX, PG):
        monkeypatch.setattr(mod, "recompute_grads", spy)
    xt = T(x).requires_grad_(True)
    dx, = torch.autograd.grad(fn(xt, *rest).sum(), xt)
    assert seen and all(nd[0] and not any(nd[1:]) for nd in seen), seen
    full = [xt] + [t.clone().requires_grad_(True) for t in rest]
    want = torch.autograd.grad(fn(*full).sum(), full)[0]
    assert torch.allclose(dx, want, rtol=1e-6, atol=1e-6)


def test_plain_paths_count_no_launches_and_gates_state_the_kernel_limits():
    b, n, c, heads, dh = SHAPES[1]
    _, jin, pin = _cross_inputs(b, n, c, heads, dh, L, 6)
    fns = (PL.ln_gemm, PL.ln_gemm3, PX.fused_cross_attention, PG.geglu_ff_ln)
    before = [f.launches for f in fns]
    x, s, bi, wq = pin[:4]
    PL.ln_gemm(x, s, bi, wq)
    PL.ln_gemm3(x, s, bi, wq, wq, wq)
    PX.fused_cross_attention(*pin, heads)
    PG.geglu_ff_ln(x, s, bi, torch.zeros(8 * c, c), torch.zeros(8 * c), torch.zeros(c, 4 * c),
                   torch.zeros(c))
    assert [f.launches for f in fns] == before

    z = torch.zeros
    assert PL.ln_gemm_supported(z(2, 128, 320), z(960, 320))
    assert PL.ln_gemm3_supported(z(2, 128, 1280), 1280)        # the TPU kernel refused C=1280
    assert not PL.ln_gemm3_supported(z(2, 100, 320), 320)      # rows % 64
    assert not PL.ln_gemm3_supported(z(2, 128, 40), 40)        # C % 16
    assert not PL.ln_gemm3_supported(z(2, 128, 2048), 2048)    # C > 1536
    assert not PL.ln_gemm_supported(z(2, 128, 320).half(), z(960, 320).half())
    assert PX.cross_attention_supported(z(2, 128, 320), z(2, 12, 5, 64), 5)
    assert PX.cross_attention_supported(z(2, 64, 1280), z(2, 64, 20, 64), 20)
    assert not PX.cross_attention_supported(z(2, 128, 320), z(2, 1, 5, 64), 5)    # sigmoid
    assert not PX.cross_attention_supported(z(2, 128, 320), z(2, 65, 5, 64), 5)
    assert not PX.cross_attention_supported(z(2, 96, 320), z(2, 12, 5, 64), 5)    # N % 64
    assert not PX.cross_attention_supported(z(2, 128, 32), z(2, 12, 4, 8), 4)     # d != 64


@pytest.mark.parametrize("dtype,b,n,c,want", [
    (torch.bfloat16, 32, 4096, 320, ("mma", 128)),  # glue probe ds1: two warpgroups share each weight tile
    (torch.bfloat16, 2, 4096, 320, ("mma", 64)),    # 64 blocks of 128 rows would leave SMs idle
    (torch.bfloat16, 32, 1024, 640, ("mma", 64)),   # 128 rows of C = 640 exceed shared memory
    (torch.bfloat16, 2, 1024, 640, ("mma", 64)),
    (torch.bfloat16, 1, 64, 128, ("mma", 64)),      # the narrowest "mma" width
    (torch.bfloat16, 2, 1024, 704, ("wmma", 32)),   # past the widest "mma" width, 640
    (torch.bfloat16, 2, 1024, 768, ("wmma", 32)),
    (torch.bfloat16, 2, 256, 1280, ("wmma", 32)),   # ds4
    (torch.bfloat16, 2, 128, 96, ("wmma", 64)),     # C % 64 != 0
    (torch.bfloat16, 2, 128, 64, ("wmma", 64)),     # one x tile cannot stage the fp32 output
    (torch.float32, 32, 4096, 320, ("fma", 16)),
    (torch.float32, 2, 1024, 640, ("fma", 16)),
])
def test_cross_attention_plan_routes(dtype, b, n, c, want):
    plan = PX.cross_attention_plan(dtype, b, n, c, c)
    assert (plan.route, plan.rows) == want
    if plan.route == "mma":
        assert plan.smem_bytes == PX.mma_smem_bytes(plan.rows // 64, c, c) <= PX.SMEM_MAX
        assert n % plan.rows == 0
    else:
        assert plan.smem_bytes == 0


def test_cross_attention_plan_refuses_nothing_the_gate_takes():
    """Every (dtype, shape) the gate takes has a route, and an "mma" plan's
    blocks hold whole row tiles of one batch element within shared memory."""
    z = torch.zeros
    for dtype in (torch.bfloat16, torch.float32):
        for c in range(16, PX.MAX_C + 1, 16):
            for heads in sorted({1, max(1, c // 64), PX.MAX_C // 64}):
                for b, n in ((1, 64), (2, 192), (32, 4096)):
                    if not PX.cross_attention_supported(z(1, 64, c, dtype=dtype),
                                                        z(1, 12, heads, 64), heads):
                        continue
                    plan = PX.cross_attention_plan(dtype, b, n, c, heads * 64)
                    assert plan.route == ("fma" if dtype == torch.float32 else
                                          "mma" if c % 64 == 0 and c >= 128
                                          and PX.mma_smem_bytes(1, c, heads * 64) <= PX.SMEM_MAX
                                          else "wmma")
                    if plan.route == "mma":
                        assert n % plan.rows == 0 and plan.smem_bytes <= PX.SMEM_MAX


# The shapes `ln_gemm` / `ln_gemm3` run at (rows, C, F, n_w): the glue probe
# (ds1 / ds2 at B=32), the demo's CFG batch (B=2), the single-output test
# shape (2, 128, 1280) -> 3840, a ragged F, and a ring wrapped 10 times.
LN_PLAN_SHAPES = [
    (131072, 320, 320, 3), (131072, 320, 960, 1), (32768, 640, 640, 3), (32768, 640, 1920, 1),
    (8192, 320, 320, 3), (8192, 320, 960, 1), (2048, 640, 640, 3), (2048, 640, 1920, 1),
    (256, 1280, 1280, 3), (256, 1280, 3840, 1), (512, 1280, 1280, 3), (8192, 320, 336, 3),
    (2048, 1280, 1280, 1), (64, 64, 48, 1), (192, 1536, 16, 3),
]
LN_B2_SHAPES = [(8192, 320, 320, 3), (8192, 320, 960, 1), (2048, 640, 640, 3),
                (2048, 640, 1920, 1), (256, 1280, 3840, 1), (256, 1280, 1280, 3)]


@pytest.mark.parametrize("dtype,m,c,f,n_w,want", [
    # (route, rows a block, tile width, column tiles a block, blocks, stages)
    (torch.bfloat16, 131072, 320, 320, 3, ("mma", 128, 160, 6, 1024, 4)),  # ds1 B=32: LN once a row
    (torch.bfloat16, 131072, 320, 960, 1, ("mma", 128, 160, 6, 1024, 4)),  # ln_gemm: the same tiles
    (torch.bfloat16, 32768, 640, 640, 3, ("mma", 64, 160, 12, 512, 4)),    # 128 rows of C=640 do not fit
    (torch.bfloat16, 8192, 320, 320, 3, ("mma", 128, 160, 2, 192, 4)),     # B=2: column groups fill the card
    (torch.bfloat16, 2048, 640, 640, 3, ("mma", 64, 160, 2, 192, 4)),
    (torch.bfloat16, 256, 1280, 3840, 1, ("mma", 64, 64, 1, 240, 4)),      # 160-wide tiles: 96 blocks only
    (torch.bfloat16, 2048, 1280, 1280, 1, ("mma", 64, 160, 1, 256, 2)),    # C=1280: a two-stage ring
    (torch.bfloat16, 8192, 320, 336, 3, ("mma", 128, 64, 8, 192, 4)),      # F % 160 != 0: 64-wide, ragged
    (torch.bfloat16, 2048, 96, 96, 3, ("wmma", 64, 0, 18, 32, 0)),         # C % 64 != 0
    (torch.float32, 2048, 640, 640, 3, ("fma", 16, 0, 120, 128, 0)),
])
def test_ln_gemm_plan_routes(dtype, m, c, f, n_w, want):
    plan = PL.ln_gemm_plan(dtype, m, c, f, n_w)
    assert (plan.route, plan.rows, plan.n, plan.group_tiles, plan.blocks, plan.stages) == want
    if plan.route == "mma":
        assert plan.smem_bytes == PL.mma_smem_bytes(plan.rows // 64, c, plan.n, plan.stages)
        assert plan.steps == plan.group_tiles * c // 64
    else:
        assert plan.smem_bytes == 0 and plan.groups == 1


@pytest.mark.parametrize("m,c,f,n_w", LN_PLAN_SHAPES)
def test_ln_gemm_plan_fits_shared_memory_and_covers_the_card(m, c, f, n_w):
    """Every bf16 plan at C % 64 == 0 is on "mma" within 227 KB, with a ring
    of 2-4 stages, 64 rows a block at C = 1280, and a grid of at least 132
    blocks wherever row tiles × column tiles allow one (the B=2 shapes and
    (2, 128, 1280) among them)."""
    plan = PL.ln_gemm_plan(torch.bfloat16, m, c, f, n_w)
    assert plan.route == "mma" and plan.n in PL.MMA_WIDTHS
    assert plan.smem_bytes <= PL.SMEM_MAX and 2 <= plan.stages <= PL.MAX_STAGES
    assert m % plan.rows == 0 and plan.blocks == m // plan.rows * plan.groups
    assert plan.groups == -(-plan.tiles // plan.group_tiles)
    if c == 1280:
        assert plan.rows == 64
    if (m, c, f, n_w) in LN_B2_SHAPES:
        assert plan.blocks >= PL.SMS
    most = max(m // rows * n_w * -(-f // n) for rows in (64, 128) for n in PL.MMA_WIDTHS
               if m % rows == 0)
    assert plan.blocks >= min(PL.SMS, most)


@pytest.mark.parametrize("m,c,f,n_w", LN_PLAN_SHAPES)
def test_ln_gemm_plan_block_columns_cover_every_output_column_once(m, c, f, n_w):
    """The block → (weight, column range) map of the "mma" route (a mirror of
    the kernel's) writes every column of every output once, in tiles that
    never straddle two weights; the blocks of one row tile are adjacent."""
    plan = PL.ln_gemm_plan(torch.bfloat16, m, c, f, n_w)
    seen = np.zeros((n_w, f), np.int64)
    for block in range(plan.groups):  # the column groups of row tile 0; every row tile repeats them
        spans = PL.ln_gemm_block_columns(plan, f, block)
        assert 1 <= len(spans) <= plan.group_tiles
        for wi, c0, c1 in spans:
            assert 0 <= wi < n_w and 0 <= c0 < c1 <= f and c1 - c0 <= plan.n
            seen[wi, c0:c1] += 1
    assert (seen == 1).all()
    assert PL.ln_gemm_block_columns(plan, f, plan.groups) == PL.ln_gemm_block_columns(plan, f, 0)


def test_ln_gemm_plan_refuses_nothing_the_gate_takes():
    """Every bf16 width C % 64 == 0 up to the gate's 1536 has an "mma" plan
    within shared memory at any row count the gate takes; the other widths go
    to "wmma"."""
    for c in range(16, PL.MAX_C + 1, 16):
        for m in (64, 128, 4096):
            for f, n_w in ((16, 3), (c, 3), (3 * c, 1), (336, 1)):
                plan = PL.ln_gemm_plan(torch.bfloat16, m, c, f, n_w)
                assert plan.route == ("mma" if c % 64 == 0 else "wmma")
                if plan.route == "mma":
                    assert plan.smem_bytes <= PL.SMEM_MAX and plan.stages >= 2


@pytest.mark.parametrize("variant", sorted(ln_gemm_probe.VARIANTS))
def test_ln_gemm_probe_variants_match_the_kernel_source(variant):
    """Every edit of the card probe's variants (scripts/ln_gemm_probe.py)
    finds its text once in csrc/ln_gemm.cu, so the probe builds what it says."""
    src = (PL._build.CSRC / "ln_gemm.cu").read_text()
    got = ln_gemm_probe.variant_source(variant)
    assert (got == src + ln_gemm_probe._ENCODE_BENCH) if variant == "as is" else got != src


# -- (c)-(g) the modules ------------------------------------------------------


def _hoist(p_attn, ctx, heads, dh):
    """The JAX build's hoisted (k, v) of a context, from a CrossAttention's params."""
    b, l, _ = ctx.shape
    k = (ctx @ np.asarray(p_attn["to_k"]["Dense_0"]["kernel"])).reshape(b, l, heads, dh)
    v = (ctx @ np.asarray(p_attn["to_v"]["Dense_0"]["kernel"])).reshape(b, l, heads, dh)
    return _f32(k), _f32(v)


def _port_block(params, heads, dh, vdim, **kw):
    sd = unet_from_jax({"input_blocks_1_1": {"blocks_0": params["params"]}})
    prefix = "input_blocks.1.1.transformer_blocks.0."
    blk = PA.BasicTransformerBlock(heads, dh, TDIM, vdim, **kw)
    blk.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return blk.eval()


def _block_case(b, n, c, heads, dh, with_v, seed):
    rs = _rs(seed)
    vdim = 24 if with_v else None
    x = _f32(rs.standard_normal((b, n, c)))
    tctx = _f32(rs.standard_normal((b, L, TDIM)))
    vctx = _f32(rs.standard_normal((b, 5, vdim))) if with_v else None
    jblk = JA.BasicTransformerBlock(heads, dh, TDIM, vdim, attn_impl="xla", fuse_glue="force")
    init = (jnp.asarray(x), jnp.asarray(tctx)) + ((jnp.asarray(vctx),) if with_v else ())
    params = flax_params(jblk, seed + 1, *init)
    kv = {"t": _hoist(params["params"]["t_attn"], tctx, heads, dh)}
    if with_v:
        kv["v"] = _hoist(params["params"]["v_attn"], vctx, heads, dh)
    return x, tctx, vctx, vdim, params, kv


@pytest.mark.parametrize("with_v", [False, True], ids=["t_only", "t_and_v"])
@pytest.mark.parametrize("b,n,c,heads,dh", SHAPES)
def test_fused_block_matches_jax_fp32(b, n, c, heads, dh, with_v):
    x, tctx, vctx, vdim, params, kv = _block_case(b, n, c, heads, dh, with_v, 10)
    jblk = JA.BasicTransformerBlock(heads, dh, TDIM, vdim, attn_impl="xla", fuse_glue="force")
    jkv = {k_: tuple(jnp.asarray(a) for a in pair) for k_, pair in kv.items()}
    want, wmap = jblk.apply(params, jnp.asarray(x), jnp.asarray(tctx),
                            None if vctx is None else jnp.asarray(vctx), False, jkv)
    assert wmap is None
    pkv = {k_: tuple(T(a) for a in pair) for k_, pair in kv.items()}
    pv = None if vctx is None else T(vctx)
    for qkv in (False, True):  # "force" fuses the q/k/v projections either way
        blk = _port_block(params, heads, dh, vdim, fuse_qkv=qkv, fuse_glue="force")
        got, gmap = blk(T(x), T(tctx), pv, False, pkv)
        assert gmap is None
        assert_close(got, want, RTOL, ATOL, f"fused block fuse_qkv={qkv}")
    # "auto" does not fuse on the CPU, and agrees with the unfused block
    off, _ = _port_block(params, heads, dh, vdim)(T(x), T(tctx), pv, False, pkv)
    auto, _ = _port_block(params, heads, dh, vdim, fuse_qkv=True, fuse_glue="auto")(
        T(x), T(tctx), pv, False, pkv)
    assert_close(auto, off.detach().numpy(), RTOL, ATOL, "auto on the CPU")
    assert_close(off, want, 1e-4, 1e-4, "unfused block")


@pytest.mark.parametrize("with_v", [False, True], ids=["t_only", "t_and_v"])
def test_fused_block_matches_jax_bf16(with_v):
    b, n, c, heads, dh = SHAPES[0]
    x, tctx, vctx, vdim, params, kv = _block_case(b, n, c, heads, dh, with_v, 20)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    jblk = JA.BasicTransformerBlock(heads, dh, TDIM, vdim, dtype=jnp.bfloat16, attn_impl="xla",
                                    fuse_glue="force")
    want, _ = jblk.apply(params, bf(x), bf(tctx), None if vctx is None else bf(vctx), False,
                         {k_: tuple(bf(a) for a in pair) for k_, pair in kv.items()})
    want = np.asarray(want.astype(jnp.float32))
    blk = cast_weights(_port_block(params, heads, dh, vdim, fuse_glue="force"), torch.bfloat16)
    t16 = lambda a: T(a).bfloat16()  # noqa: E731
    got, _ = blk(t16(x), t16(tctx), None if vctx is None else t16(vctx), False,
                 {k_: tuple(t16(a) for a in pair) for k_, pair in kv.items()})
    assert got.dtype == torch.bfloat16
    rel = float(np.linalg.norm(got.float().detach().numpy() - want) / np.linalg.norm(want))
    assert rel <= 2e-2, rel


def test_fused_block_capture_map_keeps_the_map_path():
    b, n, c, heads, dh = SHAPES[0]
    x, tctx, _, vdim, params, kv = _block_case(b, n, c, heads, dh, False, 30)
    pkv = {"t": tuple(T(a) for a in kv["t"])}
    fused = _port_block(params, heads, dh, vdim, fuse_glue="force")
    plain = _port_block(params, heads, dh, vdim)
    before = PX.fused_cross_attention.launches
    got, gmap = fused(T(x), T(tctx), None, True, pkv)
    want, wmap = plain(T(x), T(tctx), None, True, pkv)
    assert PX.fused_cross_attention.launches == before
    assert gmap.shape == (b, heads, n, L) and gmap.dtype == torch.float32
    assert_close(gmap, wmap.detach().numpy(), RTOL, 1e-6, "t_attn map")
    assert_close(got, want.detach().numpy(), RTOL, ATOL, "block output with capture")
    jblk = JA.BasicTransformerBlock(heads, dh, TDIM, None, attn_impl="xla", fuse_glue="force")
    _, jmap = jblk.apply(params, jnp.asarray(x), jnp.asarray(tctx), None, True,
                         {"t": tuple(jnp.asarray(a) for a in kv["t"])})
    assert_close(gmap, jmap, RTOL, 1e-6, "t_attn map against JAX")


def test_cross_attention_ln_kv_contract_keeps_single_token_sigmoid():
    """A one-token context uses sigmoid attention; the fused branch is
    softmax-only, so L == 1 keeps the plain path under the ln + kv contract."""
    b, n, c, heads, dh = SHAPES[0]
    rs = _rs(40)
    x = _f32(rs.standard_normal((b, n, c)))
    ctx = _f32(rs.standard_normal((b, 1, TDIM)))
    s, bi = _f32(np.full(c, 1.1)), _f32(np.full(c, 0.05))
    jattn = JA.CrossAttention(heads, dh)
    params = flax_params(jattn, 41, jnp.asarray(x), jnp.asarray(ctx))
    k, v = _hoist(params["params"], ctx, heads, dh)
    want, _ = jattn.apply(params, jnp.asarray(x), jnp.asarray(ctx), False,
                          kv=(jnp.asarray(k), jnp.asarray(v)),
                          ln=(jnp.asarray(s), jnp.asarray(bi)))

    attn = PA.CrossAttention(c, TDIM, heads, dh)
    sd = unet_from_jax({"input_blocks_1_1": {"blocks_0": {"t_attn": params["params"]}}})
    attn.load_state_dict({k_.split(".t_attn.", 1)[1]: v_ for k_, v_ in sd.items()}, strict=True)
    before = PX.fused_cross_attention.launches
    got, m = attn(T(x), T(ctx), False, (T(k), T(v)), ln=(T(s), T(bi)))
    assert m is None and PX.fused_cross_attention.launches == before
    assert_close(got, want, RTOL, ATOL, "L == 1 under ln + kv")
    plain, pmap = attn(PL.ln_ref_f32(T(x), T(s), T(bi)), T(ctx), True, (T(k), T(v)))
    assert_close(got, (T(x) + plain).detach().numpy(), RTOL, ATOL, "x + plain(LN(x))")
    assert float((pmap.detach() - 1.0).abs().max()) > 1e-3  # sigmoid, not a softmax of one token


@pytest.mark.parametrize("c", [32, 40], ids=["kernel_shape", "concat_shape"])
@pytest.mark.parametrize("with_ln", [False, True], ids=["no_ln", "ln"])
def test_self_attention_fuse_qkv_matches_jax(with_ln, c):
    """fuse_qkv with and without `ln`: C=32 is a shape `ln_gemm3` takes (its
    plain version runs here), C=40 is not (the concatenated product)."""
    heads, dh = 4, c // 4
    rs, x, s, bi = _ln_inputs(2, 128, c, 50)
    jsa = JA.SelfAttention(heads, dh, attn_impl="xla", fuse_qkv=True)
    params = flax_params(jsa, 51, jnp.asarray(x))
    ln = (jnp.asarray(s), jnp.asarray(bi)) if with_ln else None
    want = jsa.apply(params, jnp.asarray(x), ln=ln)
    sd = unet_from_jax({"input_blocks_1_1": {"blocks_0": {"attn1": params["params"]}}})
    sd = {k_.split(".attn1.", 1)[1]: v_ for k_, v_ in sd.items()}
    assert PL.ln_gemm3_supported(T(x), c) is (c == 32)
    for fuse in (True, False):  # the same parameters through every branch
        sa = PA.SelfAttention(c, heads, dh, fuse_qkv=fuse)
        sa.load_state_dict(sd, strict=True)
        got = sa(T(x), ln=(T(s), T(bi)) if with_ln else None)
        assert_close(got, want, RTOL, ATOL, f"SelfAttention fuse_qkv={fuse}")


def test_state_dict_keys_equal_with_fusion_on_and_off():
    kw = dict(heads=4, dim_head=8, t_context_dim=TDIM, v_context_dim=24)
    keys = [tuple(PA.BasicTransformerBlock(**kw, fuse_qkv=q, fuse_glue=g).state_dict())
            for q, g in ((False, "off"), (True, "off"), (True, "auto"), (False, "force"))]
    assert all(k_ == keys[0] for k_ in keys)
    assert {"norm1.weight", "t_norm.bias", "norm3.weight", "attn1.to_q.weight"} <= set(keys[0])
    with pytest.raises(ValueError, match="fuse_glue"):
        PA.BasicTransformerBlock(4, 8, fuse_glue="on")


def test_fused_block_gradients_match_unfused():
    """Input and t_attn/t_norm gradients through the fused branches (their
    autograd Functions) against the unfused block's autograd."""
    b, n, c, heads, dh = SHAPES[0]
    x, tctx, _, vdim, params, kv = _block_case(b, n, c, heads, dh, False, 60)
    g = T(_f32(_rs(61).standard_normal((b, n, c))))
    grads = {}
    for name, kw in (("fused", dict(fuse_glue="force")), ("plain", {})):
        blk = _port_block(params, heads, dh, vdim, **kw)
        xt = T(x).clone().requires_grad_(True)
        ctx_kv = {"t": blk.t_attn.project_kv(T(tctx))}
        out, _ = blk(xt, T(tctx), None, False, ctx_kv)
        (out * g).sum().backward()
        grads[name] = {"input": xt.grad, **{k_: p.grad for k_, p in blk.named_parameters()
                                            if "t_attn" in k_ or "t_norm" in k_}}
    assert set(grads["fused"]) == set(grads["plain"]) and len(grads["plain"]) == 8
    for k_, want in grads["plain"].items():
        _grad_close(grads["fused"][k_], want.numpy(), f"block grad {k_}")


# -- (h) the probe ---------------------------------------------------------------


def test_probe_runs_on_the_cpu_and_returns_every_label(capsys):
    res = glue_fusion_probe.run(batch=1, reps=1, device="cpu", shapes=(("tiny", 8, 64),),
                                ctx_dim=16, dim_head=32, dtype=torch.float32, runs=1)
    want = [
        "tiny D. 3x separate (64->64) GEMMs", "tiny D. 1x fused (64->192) GEMM",
        "tiny C. LayerNormF32 (fp32 stats) alone", "tiny F. LN -> fused (64->192) GEMM",
        "tiny F. LN -> 3x separate (64->64) GEMMs", "tiny F. ln_gemm kernel (64->192)",
        "tiny F. ln_gemm3 kernel (3x 64->64 compact)", "tiny A. SelfAttention fuse_qkv=False",
        "tiny A. SelfAttention fuse_qkv=True",
        "tiny E. LN + CrossAttention (hoisted KV) + residual",
        "tiny G. fused t_attn branch kernel (LN+q+attn+out+res)",
        "tiny B. BasicTransformerBlock qkv=False glue=off (hoisted KV)",
        "tiny B. BasicTransformerBlock qkv=True glue=off (hoisted KV)",
        "tiny B. BasicTransformerBlock qkv=True glue=auto (hoisted KV)",
    ]
    assert list(res) == want
    assert all(np.isfinite(v) and v > 0 for v in res.values())
    out = capsys.readouterr().out
    assert "CPU host clock" in out and all(label in out for label in want)
    if not torch.cuda.is_available():  # the default device is the GPU: no silent CPU run
        with pytest.raises(SystemExit, match="no CUDA device"):
            glue_fusion_probe.main([])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            glue_fusion_probe.run(batch=1)
