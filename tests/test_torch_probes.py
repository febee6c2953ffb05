"""The port's probe-level ops and probes against the JAX package, on the CPU.

`fused_groupnorm_silu` (CPU path and plain version) is held to the TPU kernel's
own body, `udifftext_tpu.ops.groupnorm._gn_kernel`, run through
`pl.pallas_call(..., interpret=True)`, and to `silu(GroupNorm32(x))`. The
flash variants' plain versions are held to the bodies of
`scripts/flash_variants.py` (`_kernel_v2`, `_kernel_v3`) and v1 to the
shipped `_flash_kernel` that `v1_fn` runs, run the same way, also where
their clamps bind. Inputs come from numpy seeds and go to
both sides.

Tolerances. GroupNorm fp32: rtol 1e-3, atol 1e-4, the JAX kernel's own
(`tests/test_ops.py`). GroupNorm bf16: two bf16 ulps of the largest value
(the JAX side rounds at other points). Under a common offset of 1000 only a
centered variance stays accurate; there the port is held to `GroupNorm32`
alone, atol 1e-3 (fp32 values near 1000 are 6e-5 apart and both sides subtract
means summed in different orders). Flash variants fp32: 1e-5.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import torch_port_util as U
from udifftext_tpu.models.layers import GroupNorm32, silu
from udifftext_tpu.ops.flash_attention import _flash_kernel
from udifftext_tpu.ops.groupnorm import _gn_kernel
from udifftext_tpu_torch.ops import flash_variants as FV
from udifftext_tpu_torch.ops import groupnorm as GN
from udifftext_tpu_torch.scripts import flash_variants as variants_probe
from udifftext_tpu_torch.scripts import resblock_probe, sizing_probe

REPO = Path(__file__).resolve().parent.parent
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(a).to(TORCH_DTYPE[dtype])


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """`a` rounded to values bf16 holds exactly, so that the JAX wrapper's
    cast of scale and bias to x's dtype changes nothing."""
    return torch.from_numpy(a).bfloat16().float().numpy()


# -- fused GroupNorm + SiLU --------------------------------------------------


def _jax_gn_interpret(x, scale, bias, num_groups=32, eps=1e-5, with_silu=True):
    """The TPU kernel's body in interpret mode, called as
    `udifftext_tpu.ops.groupnorm.fused_groupnorm_silu` calls it."""
    b, c = x.shape[0], x.shape[-1]
    x3 = x.reshape(b, -1, c)
    n, cg = x3.shape[1], c // num_groups
    member = np.zeros((c, num_groups), np.float32)
    member[np.arange(c), np.arange(c) // cg] = 1.0
    precision = jax.lax.Precision.HIGHEST if x.dtype == jnp.float32 else None
    out = pl.pallas_call(
        functools.partial(_gn_kernel, eps=eps, n=n, cg=cg, with_silu=with_silu,
                          precision=precision),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, n, c), lambda i: (i, 0, 0)),
                  pl.BlockSpec((c,), lambda i: (0,)), pl.BlockSpec((c,), lambda i: (0,)),
                  pl.BlockSpec((c, num_groups), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, n, c), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, n, c), x.dtype),
        interpret=True,
    )(x3, scale.astype(x.dtype), bias.astype(x.dtype), jnp.asarray(member, x.dtype))
    return out.reshape(x.shape)


def _jax_groupnorm32(x, scale, bias, eps=1e-5, with_silu=True):
    y = GroupNorm32(eps=eps).apply({"params": {"GroupNorm_0": {"scale": scale, "bias": bias}}}, x)
    return silu(y) if with_silu else y


def _gn_inputs(shape, seed=0, offset=0.0):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = (rs.standard_normal(shape) + offset).astype(np.float32)
    scale = _bf16_exact((1.0 + 0.25 * rs.standard_normal(c)).astype(np.float32))
    bias = _bf16_exact((0.25 * rs.standard_normal(c)).astype(np.float32))
    return x, scale, bias


@pytest.mark.parametrize("shape,with_silu,eps,dtype", [
    ((2, 16, 16, 64), True, 1e-5, "float32"),
    ((2, 16, 16, 320), True, 1e-5, "float32"),
    ((2, 256, 960), True, 1e-5, "float32"),
    ((2, 256, 64), False, 1e-6, "float32"),
    ((2, 16, 16, 320), False, 1e-6, "float32"),
    ((2, 1024, 64), True, 1e-6, "float32"),
    ((2, 16, 16, 320), True, 1e-5, "bfloat16"),
    ((2, 256, 960), True, 1e-6, "bfloat16"),
    ((2, 16, 16, 64), False, 1e-5, "bfloat16"),
])
def test_groupnorm_matches_jax_kernel_body_and_groupnorm32(shape, with_silu, eps, dtype):
    x, scale, bias = _gn_inputs(shape)
    xt = _to_torch(x, dtype)
    args = (xt, torch.from_numpy(scale), torch.from_numpy(bias), 32, eps, with_silu)
    got = GN.fused_groupnorm_silu(*args)  # CPU tensors: the plain version
    assert got.dtype == xt.dtype and got.shape == xt.shape
    assert torch.equal(got, GN.fused_groupnorm_silu_ref(*args))
    xj = jnp.asarray(x, dtype)
    body = _to_numpy(_jax_gn_interpret(xj, jnp.asarray(scale), jnp.asarray(bias), 32, eps,
                                       with_silu))
    model = _to_numpy(_jax_groupnorm32(xj, jnp.asarray(scale), jnp.asarray(bias), eps, with_silu))
    for what, want in (("Pallas body", body), ("GroupNorm32", model)):
        if dtype == "float32":
            U.assert_close(got, want, 1e-3, 1e-4, what)
        else:
            U.assert_close(got, want, 0.0, 2**-7 * max(1.0, float(np.abs(want).max())), what)


def test_groupnorm_stays_centered_under_a_large_offset():
    x, scale, bias = _gn_inputs((2, 16, 16, 64), seed=1, offset=1000.0)
    got = GN.fused_groupnorm_silu(torch.from_numpy(x), torch.from_numpy(scale),
                                  torch.from_numpy(bias))
    xj, sj, bj = jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)
    want = _to_numpy(_jax_groupnorm32(xj, sj, bj))
    U.assert_close(got, want, 0.0, 1e-3, "centered GroupNorm32")
    # the TPU kernel's E[x²] − mean² loses the variance here: a quirk of the
    # reference, which is why the port is not held to it in this case
    one_pass = _to_numpy(_jax_gn_interpret(xj, sj, bj))
    assert float(np.abs(one_pass - want).max()) > 5e-3


def test_groupnorm_counts_the_rows_past_the_last_full_chunk():
    """The TPU kernel leaves rows past n // 512 · 512 out; the port does not."""
    x, scale, bias = _gn_inputs((1, 600, 64), seed=2)
    got = GN.fused_groupnorm_silu(torch.from_numpy(x), torch.from_numpy(scale),
                                  torch.from_numpy(bias))
    want = _to_numpy(_jax_groupnorm32(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    U.assert_close(got, want, 1e-3, 1e-4, "GroupNorm32 at n = 600")


def test_groupnorm_gate_and_chunking():
    ok = GN.groupnorm_silu_supported
    assert ok(torch.zeros(2, 64, 64, 320)) and ok(torch.zeros(2, 64, 2560).bfloat16())
    assert ok(torch.zeros(1, 7, 960)) and ok(torch.zeros(2, 4, 4, 64), num_groups=8)
    assert not ok(torch.zeros(2, 64, 100))               # C % 32 != 0
    assert not ok(torch.zeros(2, 64, 36), num_groups=3)  # C % 8 != 0
    assert not ok(torch.zeros(2, 64, 8192))              # C > 4096
    assert not ok(torch.zeros(2, 64, 320).half())        # fp16
    assert not ok(torch.zeros(64, 320)) and not ok(torch.zeros(2, 0, 320))
    assert not ok(torch.zeros(2, 4, 512), num_groups=512)
    # route "stream": whole rows while the grid reaches two blocks an SM, the
    # chunks the fewest that aim at four, at most 64 a sample; narrower slabs
    # (down to 128 bytes) for one sample
    plan = GN.stream_plan
    assert plan(torch.float32, 16, 262144, 128)[1:] == (32, 0, 7944, 0, 2, 33)
    assert plan(torch.float32, 8, 262144, 128)[1:] == (32, 0, 4096, 0, 2, 64)
    assert plan(torch.float32, 1, 262144, 128)[1:] == (8, 0, 4096, 0, 2, 64)
    assert plan(torch.float32, 1, 65536, 256)[1:] == (4, 0, 1024, 0, 2, 64)
    assert plan(torch.bfloat16, 2, 64, 320)[1:] == (8, 0, 1, 0, 2, 64)  # 160-byte slabs
    assert plan(torch.float32, 1, 3, 4096)[1:] == (1, 0, 1, 0, 2, 3)  # one row a chunk


@pytest.mark.parametrize("shape,dtype,want", [
    # the ResBlock probe's shape: 4-group (80-byte) slices, 7 CTAs of 586 rows, four an SM
    ((32, 4096, 320), torch.bfloat16, ("cluster", 4, 7, 586)),
    # B=2: the narrowest 16-byte slice and clusters of 8 to fill the card
    ((2, 4096, 320), torch.bfloat16, ("cluster", 4, 8, 512)),
    ((2, 1024, 640), torch.bfloat16, ("cluster", 2, 8, 128)),
    ((2, 256, 1280), torch.bfloat16, ("cluster", 1, 5, 52)),
    ((2, 4096, 960), torch.bfloat16, ("stream", 8, 0, 64)),        # C/G = 30: one 131 KB CTA an SM
    ((2, 1024, 640), torch.float32, ("cluster", 1, 5, 205)),
    ((3, 777, 64), torch.bfloat16, ("stream", 32, 0, 13)),         # a 16-byte cluster slice streams
    ((1, 1, 4096), torch.float32, ("cluster", 1, 1, 1)),           # one row: one CTA
    ((1, 262144, 128), torch.float32, ("stream", 8, 0, 4096)),     # the VAE decoder's last norm
    ((1, 65536, 256), torch.float32, ("stream", 4, 0, 1024)),
])
def test_groupnorm_plan_picks_route_slice_and_cluster(shape, dtype, want):
    b, n, c = shape
    plan = GN.groupnorm_plan(dtype, b, n, c)
    assert (plan.route, plan.slice_groups, plan.cluster, plan.rows) == want
    assert plan.launches == (1 if plan.route == "cluster" else 2)
    assert plan.partials == (plan.cluster if plan.route == "cluster" else -(-n // plan.rows))
    if plan.route == "cluster":
        esize = torch.empty((), dtype=dtype).element_size()
        width = plan.slice_groups * c // 32
        assert width * esize % 16 == 0 and width * esize <= GN.MAX_SLICE_BYTES
        assert plan.rows * (plan.cluster - 1) < n <= plan.rows * plan.cluster
        assert plan.smem_bytes == GN.cluster_smem_bytes(plan.rows, width, esize, plan.slice_groups)
        assert plan.smem_bytes <= GN.SMEM_MAX


def test_groupnorm_plan_refuses_nothing_the_gate_takes():
    """Every shape `groupnorm_silu_supported` takes has a route; a cluster
    plan always fits its limits, and "stream" is left to a (sample, group)
    that no 8 CTAs hold, or hold only in slices under 32 bytes or one CTA an
    SM; a stream plan bounds its partials and covers every row."""
    rs = np.random.RandomState(3)
    for _ in range(300):
        dtype = (torch.float32, torch.bfloat16)[rs.randint(2)]
        groups = int(rs.choice([1, 4, 8, 16, 32]))
        c = groups * int(rs.choice([1, 2, 3, 4, 8, 10, 20, 30, 40]))
        if c % 8 or c > GN.MAX_C:
            continue
        b, n = int(rs.randint(1, 40)), int(rs.choice([1, 7, 64, 777, 4096, 16384, 70000]))
        assert GN.groupnorm_silu_supported(torch.zeros(b, 1, c, dtype=dtype), groups)
        plan = GN.groupnorm_plan(dtype, b, n, c, groups)
        esize = torch.empty((), dtype=dtype).element_size()
        if plan.route == "cluster":
            assert 1 <= plan.cluster <= GN.MAX_CLUSTER and groups % plan.slice_groups == 0
            assert plan.rows * (plan.cluster - 1) < n <= plan.rows * plan.cluster
            assert plan.smem_bytes <= GN.SMEM_MAX
        else:
            cluster = GN.cluster_plan(dtype, b, n, c, groups)
            if cluster is None:
                cg = c // groups
                narrowest = min(s * cg for s in range(1, groups + 1)
                                if groups % s == 0 and s * cg * esize % 16 == 0)
                assert GN.cluster_smem_bytes(-(-n // 8), narrowest, esize, 1) > GN.SMEM_MAX
            else:
                width = cluster.slice_groups * (c // groups) * esize
                assert width < GN.MIN_CLUSTER_SLICE_BYTES or GN.blocks_per_sm(
                    cluster.smem_bytes) < 2
            assert plan.launches == 2 and 1 <= plan.partials <= GN.MAX_CHUNKS
            assert groups % plan.slice_groups == 0
            assert plan.rows * (plan.partials - 1) < n <= plan.rows * plan.partials


@pytest.mark.parametrize("shape,dtype,parts,offset", [
    ((2, 16, 16, 64), "float32", 4, 0.0),
    ((2, 777, 64), "float32", 8, 0.0),        # ragged: the last run is shorter
    ((2, 256, 960), "bfloat16", 7, 0.0),
    ((2, 16, 16, 64), "float32", 5, 1000.0),  # runs merged about their own means
])
def test_groupnorm_cluster_order_matches_plain_and_groupnorm32(shape, dtype, parts, offset):
    """The cluster route's partial statistics and rank-order merge, walked in
    plain PyTorch, against the plain version and GroupNorm32."""
    x, scale, bias = _gn_inputs(shape, seed=4, offset=offset)
    args = (_to_torch(x, dtype), torch.from_numpy(scale), torch.from_numpy(bias))
    got = GN.fused_groupnorm_silu_cluster_ref(*args, parts=parts)
    plain = GN.fused_groupnorm_silu_ref(*args)
    want = _to_numpy(_jax_groupnorm32(jnp.asarray(x, dtype), jnp.asarray(scale),
                                      jnp.asarray(bias)))
    if offset:
        U.assert_close(got, want, 0.0, 1e-3, "cluster order under an offset")
    elif dtype == "float32":
        U.assert_close(got, plain.numpy(), 1e-5, 1e-5, "cluster order vs plain")
        U.assert_close(got, want, 1e-3, 1e-4, "cluster order vs GroupNorm32")
    else:
        tol = 2**-7 * max(1.0, float(np.abs(want).max()))
        U.assert_close(got, plain.float().numpy(), 0.0, tol, "cluster order vs plain")
        U.assert_close(got, want, 0.0, tol, "cluster order vs GroupNorm32")


def test_groupnorm_raises_when_a_gradient_is_asked():
    x, scale, bias = (torch.from_numpy(a) for a in _gn_inputs((1, 16, 64)))
    for leaf in (x, scale, bias):
        leaf.requires_grad_(True)
        with pytest.raises(RuntimeError, match="forward-only"):
            GN.fused_groupnorm_silu(x, scale, bias)
        with torch.no_grad():
            assert GN.fused_groupnorm_silu(x, scale, bias).grad_fn is None
        leaf.requires_grad_(False)
    assert GN.fused_groupnorm_silu.launches == 0  # CPU tensors launch nothing


# -- flash variants ----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_script():
    """`scripts/flash_variants.py` of the JAX package, loaded from its path."""
    spec = importlib.util.spec_from_file_location("jax_flash_variants",
                                                  REPO / "scripts" / "flash_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_variant(kernel, q, k, v, bq, bk, n_out=1, **kw):
    """A flash body of the JAX package in interpret mode on (BH, N, d) arrays,
    with the grid and blocks of `run_variant` / `v1_fn`."""
    bh, nq, d = q.shape
    nk = k.shape[1]
    out_specs = [pl.BlockSpec((1, bq, d), lambda i, j: (i, j, 0)),
                 pl.BlockSpec((1, 1, bq), lambda i, j: (i, 0, j))][:n_out]
    out_shape = [jax.ShapeDtypeStruct((bh, nq, d), q.dtype),
                 jax.ShapeDtypeStruct((bh, 1, nq), jnp.float32)][:n_out]
    return pl.pallas_call(
        functools.partial(kernel, scale=d**-0.5, block_k=bk, **kw),
        grid=(bh, nq // bq),
        in_specs=[pl.BlockSpec((1, bq, d), lambda i, j: (i, j, 0)),
                  pl.BlockSpec((1, nk, d), lambda i, j: (i, 0, 0)),
                  pl.BlockSpec((1, nk, d), lambda i, j: (i, 0, 0))],
        out_specs=out_specs, out_shape=out_shape, interpret=True,
    )(q, k, v)


def _qkv(seed, q_scale=1.0, shape=(2, 256, 64)):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.standard_normal(shape).astype(np.float32) for _ in range(3))
    return q * q_scale, k, v


@pytest.mark.parametrize("q_scale", [1.0, 40.0], ids=["inside_clamp", "clamp_active"])
@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v4"])
def test_flash_variant_matches_jax_body(jax_script, variant, q_scale):
    q, k, v = _qkv(3, q_scale)
    logit_max = float(np.abs(np.einsum("bqd,bkd->bqk", q, k)).max()) / 8
    assert (logit_max > FV.CLAMP_V1) == (q_scale > 1)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = FV.flash_variant(tq, tk, tv, variant, 64, 64)  # CPU tensors: the plain version
    transposed, clamp = FV.VARIANTS[variant]
    ref, ref_lse = FV.flash_variant_ref(tq, tk, tv, clamp)
    assert torch.equal(got, ref)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if variant == "v3":
        want, = _jax_variant(jax_script._kernel_v3, jq, jk, jv, 128, 64)
    elif variant == "v1":
        # `v1_fn` runs the shipped TPU forward: max-free, logits clamped at
        # ±75, its denominator `l` saved; v1's second output is log l
        want, l = _jax_variant(_flash_kernel, jq, jk, jv, 128, 64, n_out=2, precision=None)
        U.assert_close(ref_lse, np.log(np.asarray(l))[:, 0], 1e-5, 1e-5, "log of l")
        _, lse = FV.flash_v1_with_lse(tq, tk, tv)
        assert torch.equal(lse, ref_lse)
    else:  # v2 (online max), v4 (clamp 60)
        want, = _jax_variant(jax_script._kernel_v2, jq, jk, jv, 128, 64,
                             clamp_exp=clamp is not None)
    U.assert_close(got, np.asarray(want), 1e-5, 1e-5, variant)
    # past the clamp the two functions part; inside it they are one
    softmax = torch.softmax(torch.einsum("bqd,bkd->bqk", tq, tk) / 8, -1) @ tv
    apart = float((got - softmax).abs().max())
    assert (apart > 0.1) if (clamp and q_scale > 1) else (apart < 1e-5)


def test_flash_variant_clamps_are_the_references():
    """v1 clamps where `_flash_kernel` does, v3/v4 where the JAX probe's
    `clamp_exp` does, v2 not at all; v1 and v3 share the rows layout, v2 and
    v4 the transposed one."""
    from udifftext_tpu.ops import flash_attention as jax_flash

    assert FV.VARIANTS["v1"] == (False, jax_flash._CLAMP)
    assert "jnp.clip(st, -60.0, 60.0)" in (REPO / "scripts" / "flash_variants.py").read_text()
    assert FV.VARIANTS["v3"] == (False, 60.0) and FV.VARIANTS["v4"] == (True, 60.0)
    assert FV.VARIANTS["v2"] == (True, None)
    assert FV.kernel_route(torch.bfloat16) == "mma" and FV.kernel_route(torch.float32) == "fma"


def test_flash_variant_ref_chunks_agree(monkeypatch):
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, shape=(5, 128, 64)))
    whole = FV.flash_variant_ref(q, k, v, FV.CLAMP_EXP)
    monkeypatch.setattr(FV, "_REF_CHUNK_BYTES", 2 * 4 * 128 * 128)  # two batch·heads a chunk
    for got, want in zip(FV.flash_variant_ref(q, k, v, FV.CLAMP_EXP), whole):
        assert torch.equal(got, want)


def test_flash_variant_gate_and_errors():
    q = torch.zeros(4, 256, 64).bfloat16()
    ok = FV.flash_variant_supported
    assert all(ok(q, q, bq, bk) for bq, bk in FV.TILE_MENU[torch.bfloat16])
    assert ok(q.float(), q.float(), 64, 64) and not ok(q.float(), q.float(), 128, 64)
    assert not ok(q, q, 32, 32) and not ok(q, q, 512, 512)       # TPU-sized or off the menu
    assert not ok(q[:, :192], q, 128, 64) and not ok(q, q[:, :192], 64, 128)  # ragged
    assert not ok(q[..., :32], q[..., :32], 64, 64) and not ok(q.half(), q.half(), 64, 64)
    assert not ok(q[0], q[0], 64, 64)
    with pytest.raises(ValueError, match="unknown variant"):
        FV.flash_variant(q, q, q, "v5")
    q.requires_grad_(True)
    for variant in FV.VARIANTS:
        with pytest.raises(RuntimeError, match="forward-only"):
            FV.flash_variant(q.float(), q.float(), q.float(), variant)
    with pytest.raises(RuntimeError, match="forward-only"):
        FV.flash_v1_with_lse(q, q, q)
    with torch.no_grad():
        out, lse = FV.flash_v1_with_lse(q, q, q)
    assert out.grad_fn is None and lse.shape == (4, 256)
    assert set(FV.flash_variant.launches.values()) == {0}  # CPU tensors launch nothing


# -- the probes, at tiny sizes on the CPU ------------------------------------


def test_resblock_probe_returns_every_label(capsys):
    got = resblock_probe.run(batch=2, channels=64, hw=8, reps=1, runs=1, device="cpu",
                             dtype=torch.float32)
    assert list(got) == ["2x conv3x3 only", "ResBlock, eager GroupNorm32+SiLU",
                         "ResBlock, fused GN+SiLU kernel", "GN32+SiLU alone, eager",
                         "GN32+SiLU alone, fused kernel", resblock_probe.DIFF_LABEL]
    assert all(np.isfinite(v) and v >= 0 for v in got.values())
    assert got[resblock_probe.DIFF_LABEL] <= 1e-5  # fp32, the same function twice
    assert "CPU host clock" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_variants_probe_returns_every_label(dtype):
    got = variants_probe.run(reps=1, batch=1, heads=2, n=128, runs=1, device="cpu", dtype=dtype)
    want = [variants_probe.SHIPPED_LABEL]
    want += [variants_probe.variant_label(name, bq, bk, dtype) for name in FV.VARIANTS
             for bq, bk in FV.TILE_MENU[dtype]]
    assert list(got) == want + [variants_probe.LIBRARY_LABEL]
    assert all(ms > 0 and np.isfinite(tf) for ms, tf in got.values())


def test_flash_variants_probe_fails_on_a_wrong_output(monkeypatch):
    monkeypatch.setattr(variants_probe, "flash_variant",
                        lambda q, k, v, variant, bq, bk: v.clone())
    with pytest.raises(RuntimeError, match="from softmax attention"):
        variants_probe.run(reps=1, batch=1, heads=1, n=128, runs=1, device="cpu",
                           dtype=torch.float32)


def test_sizing_probe_checks_its_flows_on_the_cpu():
    """The attention timing runs (the host clock, the plain versions); the
    memory measurement refuses the CPU, which has no device peak."""
    got = sizing_probe.attention_fp32(shapes=(("tiny", 1, 128, 2),), reps=1, runs=1,
                                      device="cpu")
    assert list(got) == ["tiny"] and all(ms > 0 for ms in got["tiny"])
    batch = sizing_probe.synthetic_batch(3, size=32)
    assert batch["image"].shape == (3, 32, 32, 3) and batch["label_ids"].shape == (3, 12)
    assert float(np.abs(batch["masked"] - batch["image"] * (1 - batch["mask"])).max()) == 0
    with pytest.raises(RuntimeError, match="card only"):
        sizing_probe.search_memory(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            sizing_probe.main([])


@pytest.mark.parametrize("probe", [resblock_probe, variants_probe],
                         ids=["resblock_probe", "flash_variants"])
def test_probes_default_to_the_gpu_and_fail_without_one(probe):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would run the full probe")
    with pytest.raises(SystemExit, match="--device cpu"):
        probe.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.run()
