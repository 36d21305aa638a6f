"""An entry call's interval on the card (`profiling.device_ns`) and the
device time by span (`profiling.device_by_span`), on one traced feed of
the chain's stream at the `rschain128.chain_stream` cell's shape.

Needs a CUDA card and skips without one. It imports neither JAX nor the
JAX package, so it runs on the card's machine without the suite's
conftest:

    python -m pytest tests/test_torch_spans_card.py --noconftest -q

The interval opens when the stream reaches the feed's start and closes
when the feed's last work ends, so it holds the union of the feed's
device events (on the profiler's clock, which is not the events': 20 us
of room) and lies inside the feed's host time from issue to synchronize.
"""

from __future__ import annotations

import time

import pytest
import torch

import crlot_tpu_torch as pt
from crlot_tpu_torch import profiling

pytestmark = pytest.mark.card

ROWS, CHUNK = 128, 1_323_000  # the cell's 30 s feeds of 44.1 kHz
B7 = "stft_fp32_window_kernel"
CLOCKS_US = 20.0  # the profiler's clock against the timing events'


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the interval is a pair of CUDA "
                    "events")
    return torch.device("cuda", 0)


def _profiler():
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(activities=[act.CPU, act.CUDA])


def _device_events(prof) -> list:
    cpu = torch.autograd.DeviceType.CPU
    return [(e.name, float(e.time_range.start), float(e.time_range.end))
            for e in prof.events() if e.device_type != cpu
            and not getattr(e, "is_user_annotation", False)]


def _union_us(events) -> float:
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


@pytest.fixture
def traced_feed(dev):
    """(the feed's entry record, its host time issue -> synchronize in
    ns, the finished profile) of the third feed of a chain stream."""
    g = torch.Generator(device=dev).manual_seed(30)
    x = torch.randn((ROWS, 3 * CHUNK), generator=g, device=dev) * 0.1
    chain = pt.ResampledStftStreamer(channels=ROWS, device=dev)
    for k in range(2):
        chain.feed(x[:, k * CHUNK:(k + 1) * CHUNK])
    torch.cuda.synchronize()
    with _profiler():  # the profiler's first start is slow
        torch.cuda.synchronize()
    with _profiler() as prof:
        t0 = time.perf_counter_ns()
        chain.feed(x[:, 2 * CHUNK:])
        torch.cuda.synchronize()
        host_ns = time.perf_counter_ns() - t0
    entry = [r for r in profiling.span_log() if r.parent is None][-1]
    return entry, host_ns, prof


def test_the_feeds_interval_holds_its_device_work(traced_feed):
    entry, host_ns, prof = traced_feed
    assert entry.name == "crlot.resample_stream.feed"
    got = profiling.device_ns(entry)
    events = _device_events(prof)
    assert any(B7 in name for name, _, _ in events)
    assert got >= 1e3 * (_union_us(events) - CLOCKS_US)
    assert got <= host_ns


def test_device_time_by_span_sums_to_the_profiles(traced_feed):
    """Every event is the feed's, each charged to a span; `.stft` holds
    B7, and launches nothing else."""
    _, _, prof = traced_feed
    parts = profiling.device_by_span(prof)
    events = _device_events(prof)
    total = 1e-6 * sum(e - s for _, s, e in events)
    assert sum(parts.values()) == pytest.approx(total, rel=1e-6)
    b7 = 1e-6 * sum(e - s for name, s, e in events if B7 in name)
    assert parts["crlot.resample_stream.stft"] == pytest.approx(b7, rel=0.05)
    assert set(parts) <= {"crlot.resample_stream.feed",
                          "crlot.resample_stream.stage",
                          "crlot.resample_stream.frames",
                          "crlot.resample_stream.stft",
                          "crlot.resample_stream.plan"}
