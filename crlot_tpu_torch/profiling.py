"""Tracing, roofline accounting and the NaN-debug mode, on the card.

Counterpart of `crlot_tpu/profiling.py`: `trace()` is a `torch.profiler`
scope (the reference's is `jax.profiler`), `nan_debug()` raises at the
first op that makes a NaN (the reference's `jax_debug_nans`),
`environment_info()` captures the build and the card, and
`roofline_samples_per_sec()` is the speed-of-light of the round-trip on
the card's published peaks. `PipelineTraffic` and `roundtrip_traffic` are
the reference's traffic model, copied: pure arithmetic.

The program's stages are spans (`span`): while a `torch.profiler` records
(`trace()`, or any profiler of the caller's), each is a range on the
trace's host timeline, on the clock of the card's events, and a record in `span_log()` with its host time and the
counts of its call (an entry call's with the interval it occupied on the
card, `device_ns`); otherwise a span is one flag read. `idle_by_span`
charges the card's idle time in a trace to the program's stages, and
`device_by_span` its device time.

    python -m crlot_tpu_torch.profiling   # environment and roofline, as JSON
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import itertools
import json
import math
import os
import platform
import subprocess
import tempfile
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class DeviceSpecs(NamedTuple):
    """Published peaks of one card: HBM bytes/s and dense FLOP/s by type."""

    hbm_bytes_per_s: float
    tf32_flops: float
    fp32_flops: float
    bf16_flops: float


# By `torch.cuda.get_device_name()` substring. H100: NVIDIA H100 Tensor
# Core GPU datasheet, SXM5 column, dense (no sparsity): 3.35 TB/s HBM3,
# 495 TFLOP/s TF32, 67 TFLOP/s FP32, 989 TFLOP/s BF16, at the 700 W limit.
_DEVICE_SPECS = {
    "H100": DeviceSpecs(3.35e12, 495e12, 67e12, 989e12),
}
_UNKNOWN = DeviceSpecs(100e9, 1e12, 5e11, 2e12)  # conservative fallback


def device_specs(kind: Optional[str] = None) -> DeviceSpecs:
    """The peaks of the card named `kind` (default: card 0's name; raises
    without a card); an unknown card gets conservative figures."""
    if kind is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass the card's "
                               "name as `kind`")
        kind = torch.cuda.get_device_name(0)
    for sub, spec in _DEVICE_SPECS.items():
        if sub in kind:
            return spec
    return _UNKNOWN


@dataclass(frozen=True)
class PipelineTraffic:
    """HBM bytes and FLOPs per INPUT SAMPLE for a round-trip config."""

    bytes_per_sample: float
    flops_per_sample: float


def roundtrip_traffic(
    frame_size: int, hop: int, matmul_fft: bool = True, folded: bool = True,
    formulation: str = "framed", group: int = 2,
) -> PipelineTraffic:
    """Traffic model of the round-trip, per INPUT sample (the reference's).

    "framed": frame -> window -> rFFT -> irFFT -> OLA -> norm with ideal
    fusion: x read once, the [F, N] frame matrix written and read in both
    directions (overlap R = N/H), the spectrum written and read, y written
    once; the folded DFT is N*(N/2+1) MACs a frame a direction, the direct
    basis 2*N*(N+2), an FFT 5*N*log2(N).

    "spectral": the framed nonlinear per-bin path, one more spectrum write
    and read for the fn's output.

    "blocked": the hop-block Toeplitz round-trip: each output sample is one
    kernel row of (R + G - 2)*hop + N MACs, and each of the
    mg = ceil(height / (G*hop)) terms reads the signal once and writes a
    partial that a final add reads, beside the norm read and the output
    write.

    Approximate by construction: a fused kernel can beat the modelled
    passes."""
    if formulation == "blocked":
        r = frame_size // hop
        gh = group * hop
        height = (r + group - 2) * hop + frame_size
        mg = -(-height // gh)
        flops = 2.0 * height + 6  # + normalize epilogue
        b = (
            4.0 * mg      # signal read per matmul term
            + 4.0 * mg    # per-term partial write
            + 4.0 * mg    # final fused add reads the partials
            + 4.0         # norm read
            + 4.0         # output write
        )
        return PipelineTraffic(bytes_per_sample=b, flops_per_sample=flops)
    r = frame_size / hop
    bytes_frames = 2 * 4 * r  # write + read, forward
    bytes_spec = 2 * 4 * r * ((frame_size // 2 + 1) * 2 / frame_size)
    bytes_out_frames = 2 * 4 * r
    b = 4 + bytes_frames + bytes_spec + bytes_out_frames + 4 + 4
    if formulation == "spectral":
        b += bytes_spec  # the fn's output planes: one more write + read
    if matmul_fft and folded and frame_size % 2 == 0:
        # 2 FLOP per MAC x half-size [Re | Im] bases, two directions.
        flops_per_frame = 2 * frame_size * (frame_size // 2 + 1) * 2
    elif matmul_fft:
        flops_per_frame = 2 * frame_size * (frame_size + 2) * 2
    else:
        flops_per_frame = 2 * 5 * frame_size * math.log2(frame_size)
    f = flops_per_frame / hop + 10  # + window/ola/normalize elementwise
    return PipelineTraffic(bytes_per_sample=b, flops_per_sample=f)


def roofline_samples_per_sec(
    frame_size: int, hop: int, matmul_fft: bool = True,
    device_kind: Optional[str] = None, precision: str = "high",
    folded: bool = True, formulation: str = "framed", group: int = 2,
) -> dict:
    """Speed-of-light samples/s of the round-trip on the card: the smaller
    of the HBM-bandwidth bound and the compute bound, both reported.

    precision: "high" runs the DFT products in 3xTF32 (three TF32 products
    each, so the compute peak is TF32 / 3) and "highest" in IEEE fp32 on
    the CUDA cores (the fp32 peak)."""
    spec = device_specs(device_kind)
    t = roundtrip_traffic(frame_size, hop, matmul_fft, folded,
                          formulation, group)
    compute_peak = (spec.tf32_flops / 3.0 if precision == "high"
                    else spec.fp32_flops)
    bw_bound = spec.hbm_bytes_per_s / t.bytes_per_sample
    compute_bound = compute_peak / t.flops_per_sample
    return {
        "bandwidth_bound_samples_per_sec": bw_bound,
        "compute_bound_samples_per_sec": compute_bound,
        "roofline_samples_per_sec": min(bw_bound, compute_bound),
        "bytes_per_sample": t.bytes_per_sample,
        "flops_per_sample": t.flops_per_sample,
        "precision": precision,
        "formulation": formulation,
    }


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """`torch.profiler` scope over the CPU and, with a card, CUDA; on exit
    it writes a Chrome trace (`trace.json`) under `log_dir` (default
    `crlot_trace` in the temporary directory). Yields the profiler."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "crlot_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# --- spans ------------------------------------------------------------------

SPAN_PREFIX = "crlot."  # every span's name starts so
OUTSIDE = "outside the program"  # the *_by_span name for no span
LOG_CALLS = 1024  # span_log keeps the spans of this many entry calls


class SpanRecord(NamedTuple):
    """One closed span. `call` is shared by every span of one entry call
    (the outermost span open on its thread); `parent` is the enclosing
    span's `id`, None for the entry span; `start_ns` and `end_ns` are
    `time.perf_counter_ns()` read inside the profiler's range, so that the
    span's own bookkeeping lies outside them; `attrs` holds the attributes
    given and the change of each count over the span (an entry span's:
    `const_builds`, the design constants built, and `launches`, the
    hand-written kernels launched, by kernel); `device`, on an entry span
    recorded while CUDA is initialised, the (start, end) timing events
    recorded on the stream current at its start, just before `start_ns`
    and just after `end_ns` (`device_ns` reads them), None on every other
    span."""

    call: int
    id: int
    parent: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    attrs: dict
    device: Optional[tuple] = None


@functools.lru_cache(maxsize=None)
def _counters() -> tuple:
    """(const_builds, launch_counts), imported on first use: the modules
    that hold the counts import this one."""
    from .bench.launches import launch_counts
    from .core.consts import const_builds

    return const_builds, launch_counts


def _entry_counts() -> dict:
    const_builds, launch_counts = _counters()
    return {"const_builds": const_builds(), "launches": launch_counts()}


def _change(before: dict, after: dict) -> dict:
    """after - before, count by count; of a table of counts by name, the
    names whose count moved."""
    out = {}
    for key, v in after.items():
        if isinstance(v, dict):
            was = before[key]
            out[key] = {} if v == was else {
                k: c - was.get(k, 0) for k, c in v.items()
                if c != was.get(k, 0)}
        else:
            out[key] = v - before[key]
    return out


class _Interval:
    """An entry call's interval on the card: a timing event recorded on
    the stream current at the call's start, and one more on the same
    stream at `close()`."""

    __slots__ = ("stream", "start")

    def __init__(self, stream) -> None:
        self.stream = stream
        self.start = self._event()

    def _event(self):
        event = torch.cuda.Event(enable_timing=True)
        event.record(self.stream)
        return event

    def close(self) -> tuple:
        """(start, end) events."""
        return self.start, self._event()


def _on_card() -> Optional[_Interval]:
    """The interval an entry call opens on the card now, or None while
    CUDA is not initialised (the CPU)."""
    if not torch.cuda.is_initialized():
        return None
    return _Interval(torch.cuda.current_stream())


class _Off:
    """A span while no profiler records: nothing happens."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self) -> bool:
        return False

    def note(self, **attrs) -> None:
        pass


_OFF = _Off()
_open = threading.local()  # .stack: the spans open on this thread
_ids = itertools.count()
_calls = itertools.count()
_log: deque = deque(maxlen=LOG_CALLS)  # a list of records an entry call


class _Span:
    __slots__ = ("name", "counts", "attrs", "call", "id", "parent",
                 "records", "before", "device", "start", "_range")

    def __init__(self, name: str, counts, attrs: dict) -> None:
        self.name, self.counts, self.attrs = name, counts, attrs

    def _read(self) -> dict:
        out = _entry_counts() if self.parent is None else {}
        if self.counts is not None:
            out.update(self.counts())
        return out

    def __enter__(self):
        # The profiler's own light range, as an operator is recorded:
        # `torch.profiler.record_function` records the same interval as a
        # user annotation, with a copy on the card's timeline, at several
        # times the host time, which a traced step spends with the card
        # waiting.
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        if stack:
            up = stack[-1]
            self.call, self.parent, self.records = up.call, up.id, up.records
        else:
            self.call, self.parent, self.records = next(_calls), None, []
        self.id = next(_ids)
        stack.append(self)
        self.before = self._read()
        # An entry call's interval on the card opens after the range and
        # the counts, so that the tracing's bookkeeping stays outside it,
        # and before `start`, so that the events stay outside every
        # span's host time.
        self.device = _on_card() if self.parent is None else None
        self.start = time.perf_counter_ns()
        return self

    def note(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        device = None if self.device is None else self.device.close()
        self.attrs.update(_change(self.before, self._read()))
        _open.stack.pop()
        self.records.append(SpanRecord(self.call, self.id, self.parent,
                                       self.name, self.start, end,
                                       self.attrs, device))
        if self.parent is None:
            _log.append(self.records)
        self._range.__exit__(*exc)
        return False


def span(name: str, counts: Optional[Callable[[], dict]] = None, **attrs):
    """A stage of the program, as a context manager.

    While a `torch.profiler` records, the stage is a range named `name` on
    the trace's host timeline (the kernels launched inside it are linked
    to it) and, on exit, a `SpanRecord` in `span_log()` with `attrs`
    and the change over the span of each count `counts()` returns (a
    number, or a table of numbers by name). Otherwise it does nothing: one
    flag read, the same shared object every time. The object entered has
    `note(**attrs)` for attributes known only inside the span, and is
    false when off, so that `if call: call.note(...)` builds attributes
    only for a span that records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, counts, attrs)


def span_log() -> list:
    """The `SpanRecord`s of the last `LOG_CALLS` entry calls made while a
    profiler recorded, oldest call first, a call's spans in the order they
    opened."""
    return [r for call in list(_log)
            for r in sorted(call, key=lambda r: r.id)]


def device_ns(record: SpanRecord) -> Optional[float]:
    """The interval in ns that the entry call of `record` occupied on its
    stream, from the stream reaching the call's start to the end of the
    last work the call queued (waited for here); None where the record
    holds no events (a child span, a call on the CPU). With one call in
    flight, all of a call's device work lies inside it, and any idle
    inside it is the program's."""
    if record.device is None:
        return None
    start, end = record.device
    end.synchronize()
    return start.elapsed_time(end) * 1e6


def _union(intervals, lo: float, hi: float) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], merged and
    in order."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def self_ns(records) -> dict:
    """{id: self time in ns} of `SpanRecord`s: each span's duration less
    the part of it that its children cover."""
    kids = defaultdict(list)
    for r in records:
        if r.parent is not None:
            kids[r.parent].append((r.start_ns, r.end_ns))
    return {r.id: r.end_ns - r.start_ns - sum(
        e - s for s, e in _union(kids.get(r.id, ()), r.start_ns, r.end_ns))
        for r in records}


def _innermost(spans: list, lo: float, hi: float) -> list:
    """[lo, hi] cut at every span boundary into (start, end, name): the
    innermost span open over each piece (the latest started; of two that
    started together, the first to end), `OUTSIDE` where none is."""
    order = sorted(spans, key=lambda sp: sp[1])
    points = sorted({lo, hi} | {t for _, s, e in spans for t in (s, e)
                                if lo < t < hi})
    k, out, active = 0, [], []
    for a, b in zip(points, points[1:]):
        while k < len(order) and order[k][1] <= a:
            active.append(order[k])
            k += 1
        active = [sp for sp in active if sp[2] > a]
        name = (max(active, key=lambda sp: (sp[1], -sp[2]))[0]
                if active else OUTSIDE)
        out.append((a, b, name))
    return out


def idle_split(device: list, spans: list, lo: float, hi: float) -> dict:
    """{name: seconds} of [lo, hi] (microseconds) in which no `device`
    event ran, each moment charged to the innermost of `spans` open then,
    or to `OUTSIDE`. Both are lists of (name, start_us, end_us); a gap is
    split over its whole length, wherever its pieces fall."""
    t = lo
    idle = []
    for s, e in _union([(s, e) for _, s, e in device], lo, hi):
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if hi > t:
        idle.append((t, hi))
    pieces = _innermost(spans, lo, hi)
    ends = [p[1] for p in pieces]
    out = defaultdict(float)
    for g0, g1 in idle:
        for s, e, name in pieces[bisect.bisect_right(ends, g0):]:
            if s >= g1:
                break
            out[name] += (min(e, g1) - max(s, g0)) * 1e-6
    return dict(out)


def device_split(events: list, spans: list) -> dict:
    """{name: seconds} of device time: each of `events`, (name, launch_us,
    start_us, end_us), charged whole to the innermost of `spans` ((name,
    start_us, end_us), as `idle_split` takes them) open at its launch, and
    to `OUTSIDE` where none was or its launch is None. The parts sum to
    the events' durations."""
    times = [t for _, t, _, _ in events if t is not None]
    pieces = (_innermost(spans, min(times),
                         max(times + [e for _, _, e in spans]))
              if times else [])
    starts = [p[0] for p in pieces]
    out = defaultdict(float)
    for _, t, s, e in events:
        name = OUTSIDE
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < pieces[i][1]:
                name = pieces[i][2]
        out[name] += (e - s) * 1e-6
    return dict(out)


def _profile(prof) -> tuple:
    """(device events as (name, correlation id, start_us, end_us), program
    spans as (name, start_us, end_us), {correlation id: start_us} of the
    CUDA runtime's and driver's calls, every event's ends) of a finished
    profiler. The card's mirrors of host ranges are not work."""
    cpu = torch.autograd.DeviceType.CPU
    dev, spans, calls, ends = [], [], {}, []
    for e in prof.events():
        s, t = float(e.time_range.start), float(e.time_range.end)
        ends += (s, t)
        if e.device_type == cpu:
            if e.name.startswith(SPAN_PREFIX):
                spans.append((e.name, s, t))
            elif e.name.startswith("cu"):  # cudaLaunchKernel, cuLaunchKernel
                calls[e.id] = s
        elif not getattr(e, "is_user_annotation", False):
            dev.append((e.name, e.id, s, t))
    return dev, spans, calls, ends


def idle_by_span(prof) -> dict:
    """Why the card was idle: {span name: seconds} of the finished
    profiler `prof` in which no operation ran on the card, each moment
    charged to the innermost program span the host was inside then, and
    `OUTSIDE` ("outside the program") where it was in none. Over the
    profile's first event to its last (`idle_split` takes any other
    stretch)."""
    dev, spans, _, ends = _profile(prof)
    if not ends:
        return {}
    return idle_split([(n, s, e) for n, _, s, e in dev], spans, min(ends),
                      max(ends))


def device_by_span(prof) -> dict:
    """Where the card's time went: {span name: seconds} of the finished
    profiler `prof`'s device time, each device event charged to the
    innermost program span open at the host call that issued it (the
    runtime call of its correlation id), `OUTSIDE` where none was or no
    such call was recorded (`device_split`). Sums to the profile's device
    time, its events' durations."""
    dev, spans, calls, _ = _profile(prof)
    return device_split([(n, calls.get(c), s, e) for n, c, s, e in dev],
                        spans)


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor)
                    and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_debug() -> Iterator[None]:
    """Scope in which a torch op whose floating output holds a NaN raises
    `FloatingPointError` (the debugging counterpart of the pipeline's
    finite-scrub contract). Every op's output is checked on the host, so
    each op synchronizes. A hand-written CUDA kernel launched through
    `cuda_build.launch` is not a torch op: a NaN it writes is seen at the
    next torch op that reads its output."""
    with _NanCheck():
        yield


def _git_head() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=Path(__file__).resolve().parent,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _smi() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def environment_info() -> dict:
    """Build, platform, git and card capture (the reference's, with torch,
    CUDA and nvidia-smi's name and power limit in place of jax's
    backend)."""
    cuda = torch.cuda.is_available()
    return {
        "git": _git_head(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_kind": torch.cuda.get_device_name(0) if cuda else None,
        "nvidia_smi": _smi() if cuda else None,
        "num_devices": torch.cuda.device_count() if cuda else 0,
    }


if __name__ == "__main__":
    info = environment_info()
    info["roofline_n1024_h256"] = {
        k: round(v, 2) if isinstance(v, (int, float)) else v
        for k, v in roofline_samples_per_sec(1024, 256).items()
    }
    print(json.dumps(info, indent=1))
