"""`GroupNorm32` on the fused GroupNorm+SiLU kernel, on the card, at every
GroupNorm shape of the UNet (bf16, the served and fine-tuned 16 rows) and
the autoencoder (fp32, the served 8 rows, the fine-tuning encodes' 16 and
the demo's 1), each in both dtypes:

- the kernel against its plain version at the kernel's rounding points,
  on the route `groupnorm_plan` names;
- two calls bit-equal (no atomics: a fixed order of every sum);
- `GroupNorm32(x, silu=True)` against `F.silu(GroupNorm32.plain(x))`, the
  eager path the models ran before, within one rounding of the output's
  dtype (the plain path rounds the norm before its SiLU, the kernel once);
- under autograd the plain path and its counter; the route "stream" within
  its targets at the autoencoder's (16, 512, 512, 128) and (1, 512, 512,
  128) fp32.

Run as `python -m pytest tests/test_torch_groupnorm_card.py --noconftest -q`
(`tests/conftest.py` imports jax, which the card's machine may lack)."""

import statistics

import pytest
import torch
import torch.nn.functional as F

from udifftext_tpu_torch.models.layers import GroupNorm32
from udifftext_tpu_torch.ops import groupnorm as GN
from udifftext_tpu_torch.utils.profiling import RECORDER

pytestmark = pytest.mark.cuda

# (H, W, C) of every GroupNorm the shipped graph runs
UNET = [(64, 64, 320), (64, 64, 640), (64, 64, 960), (32, 32, 320), (32, 32, 640),
        (32, 32, 960), (32, 32, 1280), (32, 32, 1920), (16, 16, 640), (16, 16, 1280),
        (16, 16, 1920), (16, 16, 2560), (8, 8, 1280), (8, 8, 2560)]
VAE = [(64, 64, 512), (128, 128, 256), (128, 128, 512), (256, 256, 128), (256, 256, 256),
       (256, 256, 512), (512, 512, 128), (512, 512, 256)]
CASES = ([(16,) + s for s in UNET] + [(8,) + s for s in VAE]
         + [(16, 512, 512, 128), (16, 256, 256, 256), (1, 512, 512, 128), (1, 256, 256, 256)])
# route "stream" at the autoencoder's largest level, ms (CUDA events, 20 calls back to back)
STREAM_TARGET_MS = {(16, 512, 512, 128): 2.5, (1, 512, 512, 128): 0.25}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _norm(c, card, seed):
    gen = torch.Generator(card).manual_seed(seed)
    gn = GroupNorm32(c, eps=1e-6).to(card).requires_grad_(False)
    gn.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=gen, device=card))
    gn.bias.copy_(0.1 * torch.randn(c, generator=gen, device=card))
    return gn, gen


def _tol(ref: torch.Tensor) -> float:
    scale = max(1.0, float(ref.float().abs().max()))
    return 2**-7 * scale if ref.dtype == torch.bfloat16 else 1e-5 * scale


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CASES)
def test_groupnorm32_on_the_kernel_at_the_models_shapes(card, shape, dtype):
    b, c = shape[0], shape[-1]
    gn, gen = _norm(c, card, seed=c + b)
    x = (2.0 * torch.randn(*shape, generator=gen, device=card) + 0.5).to(dtype)
    plan = GN.groupnorm_plan(dtype, b, x.numel() // (b * c), c)
    with torch.no_grad():
        for silu in (False, True):
            before = RECORDER.counters().get("groupnorm.kernel", 0)
            got = gn(x, silu=silu)
            again = gn(x, silu=silu)
            assert RECORDER.counters().get("groupnorm.kernel", 0) == before + 2
            assert GN.fused_groupnorm_silu.last_plan == plan
            assert plan.partials <= (GN.MAX_CLUSTER if plan.route == "cluster" else GN.MAX_CHUNKS)
            assert torch.equal(got, again)
            ref = GN.fused_groupnorm_silu_ref(x, gn.weight, gn.bias, 32, 1e-6, silu)
            assert got.dtype == dtype and got.shape == x.shape
            assert float((got.float() - ref.float()).abs().max()) <= _tol(ref)
            eager = gn.plain(x, silu=silu)
            # the eager path rounds the norm to bf16 before its SiLU: one more rounding
            assert float((got.float() - eager.float()).abs().max()) <= 2 * _tol(eager)
            del got, again, ref, eager
    torch.cuda.empty_cache()


def test_groupnorm32_under_autograd_stays_plain(card):
    gn, gen = _norm(320, card, seed=1)
    x = torch.randn(2, 16, 16, 320, generator=gen, device=card).bfloat16().requires_grad_(True)
    before = RECORDER.counters()
    launches = GN.fused_groupnorm_silu.launches
    y = gn(x, silu=True)
    y.float().square().sum().backward()
    after = RECORDER.counters()
    assert GN.fused_groupnorm_silu.launches == launches and x.grad is not None
    assert after.get("groupnorm.plain", 0) == before.get("groupnorm.plain", 0) + 1
    assert after.get("groupnorm.kernel", 0) == before.get("groupnorm.kernel", 0)
    assert torch.equal(y, F.silu(gn.plain(x)))
    gn.weight.requires_grad_(True)  # a trainable norm: plain even with x frozen
    assert not GN.kernel_takes(x.detach(), gn.weight, gn.bias)
    with torch.no_grad():
        assert GN.kernel_takes(x, gn.weight, gn.bias)
    # not what the kernel takes: a strided view and a misaligned start
    xd = x.detach()
    assert not GN.kernel_takes(xd[:, ::2], gn.weight, gn.bias)
    misaligned = xd.reshape(-1)[4:4 + 2 * 16 * 320].reshape(2, 16, 320)  # 8 bytes in
    assert misaligned.is_contiguous() and not GN.kernel_takes(misaligned, gn.weight, gn.bias)
    with torch.no_grad():
        launches = GN.fused_groupnorm_silu.launches
        gn(xd[:, ::2], silu=True)
        assert GN.fused_groupnorm_silu.launches == launches  # fell back, did not raise


@pytest.mark.parametrize("shape", sorted(STREAM_TARGET_MS))
def test_stream_route_within_its_target(card, shape):
    b, c = shape[0], shape[-1]
    gn, gen = _norm(c, card, seed=7)
    x = torch.randn(*shape, generator=gen, device=card)
    plan = GN.groupnorm_plan(torch.float32, b, x.numel() // (b * c), c)
    assert plan.route == "stream" and plan.launches == 2
    times = []
    with torch.no_grad():
        gn(x, silu=True)
        torch.cuda.synchronize(card)
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                gn(x, silu=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 20)
    assert statistics.median(times) <= STREAM_TARGET_MS[shape], times
