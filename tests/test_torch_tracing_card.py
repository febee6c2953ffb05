"""The span recorder against torch.profiler on the card: a span around a
synchronized `torch.cuda._sleep` holds the kernel's device interval. The
span's host stamps (`utils.profiling.clock_ns`) and the profiler's device
stamps share the Unix-epoch clock, which the two agree on to within tens of
microseconds: the host interval must hold the kernel to within 0.1 ms (1 %
of the kernel). The span's CUDA events, put on the host clock through the
recorder's anchor, must hold it outright. The port's `RECORDER` records,
with CUDA events, inside a profiler window of device activity alone, as
the benchmark opens one."""

import pytest
import torch
from torch.autograd import DeviceType

from udifftext_tpu_torch.utils.profiling import RECORDER, Recorder

pytestmark = pytest.mark.cuda

SLEEP_CYCLES = 20_000_000  # ~10 ms on an H100
SLACK_NS = 100_000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' events and the profiler's device trace")
    return torch.device("cuda", 0)


def test_span_holds_the_kernel_it_waits_for(card):
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(card)
    rec = Recorder()
    for _ in range(3):
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        rec.start(cuda=True)
        rec.anchor()
        prof.start()
        with rec.span("sleep"):
            torch.cuda._sleep(SLEEP_CYCLES)
            torch.cuda.synchronize(card)
        prof.stop()
        rec.stop()
        (span,) = rec.records()
        (k0, k1), = [(e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA and "spin_kernel" in e.name()]
        assert span.start_ns - SLACK_NS <= k0 < k1 <= span.end_ns + SLACK_NS
        assert span.device_start_ns <= k0 < k1 <= span.device_end_ns
        assert (k1 - k0) * 1e-9 <= span.device_s <= span.seconds + SLACK_NS * 1e-9


def test_recorder_follows_a_device_only_profiler_window(card):
    RECORDER.stop()
    RECORDER.take()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    with RECORDER.span("sleep"):
        torch.cuda._sleep(SLEEP_CYCLES)
    torch.cuda.synchronize(card)
    prof.stop()
    with RECORDER.span("after"):
        pass
    (span,) = RECORDER.take()
    (k0, k1), = [(e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA and "spin_kernel" in e.name()]
    assert span.name == "sleep" and (k1 - k0) * 1e-9 <= span.device_s
