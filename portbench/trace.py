"""Reading a `torch.profiler` trace of a stretch of the window.

The method is `crlot_tpu_torch/profile_paths.py`'s, copied so that the
program cannot move it: device time from the profiler's device-side events
(kernels, copies, fills), the host clock around synchronized calls. Here
the stretch is a run of whole steps, each marked by a `portbench.step`
range that ends after the step's synchronize, so the device work of those
steps lies inside the stretch. Busy time is the union of the device
intervals clipped to the stretch (concurrent kernels count once); an idle
gap is charged to the innermost host operation running when it began.

Pure functions over (name, start_us, end_us) tuples, so that the
arithmetic is tested without a card.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

STEP = "portbench.step"
PYTHON = "python between ops"  # inside a step, outside every traced op


def events(prof) -> tuple:
    """(device events, host events) of a finished profile, each a list of
    (name, start_us, end_us); the device's copies of host ranges (user
    annotations) are left out."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    dev, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == cpu:
            host.append(item)
        elif not (getattr(e, "is_user_annotation", False) or e.name == STEP):
            dev.append(item)  # a range's mirror on the device is no work
    return dev, host


def stretch(host: list, first: int, count: int):
    """(start_us, end_us, steps) spanning the `count` step markers from
    the `first`-th (0-based, in time order), or None without any."""
    marks = sorted((s, e) for name, s, e in host if name == STEP)
    marks = marks[first : first + count]
    if not marks:
        return None
    return marks[0][0], marks[-1][1], len(marks)


def union(intervals: list, lo: float, hi: float) -> list:
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


def gaps(busy: list, lo: float, hi: float) -> list:
    """The idle (start, end) stretches of [lo, hi] outside `busy`."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(host_sorted: list, starts: list, t: float) -> str:
    """The name of the latest-starting host event that covers time t (the
    step itself: Python code between the program's traced ops)."""
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(host_sorted[max(0, i - 400) : i]):
        if s <= t < e:
            return PYTHON if name == STEP else name
    return "(no host op)"


def summarize(dev: list, host: list, first: int, count: int) -> dict:
    """Per-stretch numbers: window_s, busy_s, steps, device seconds by
    event name (clipped to the stretch), and idle seconds by the host op
    at the start of each gap."""
    st = stretch(host, first, count)
    if st is None:
        return {"steps": 0}
    lo, hi, steps = st
    busy = union([(s, e) for _, s, e in dev], lo, hi)
    by_name = defaultdict(float)
    for name, s, e in dev:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            by_name[name] += d * 1e-6
    host_sorted = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host_sorted]
    idle = defaultdict(float)
    for g0, g1 in gaps(busy, lo, hi):
        idle[innermost(host_sorted, starts, g0)] += (g1 - g0) * 1e-6
    return {
        "steps": steps,
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "device_s_by_name": dict(by_name),
        "idle_s_by_host_op": dict(idle),
    }


def seconds_matching(summary: dict, names: tuple) -> float:
    """Device seconds of the events whose name holds any of `names`."""
    return sum(sec for name, sec in summary["device_s_by_name"].items()
               if any(n in name for n in names))


def top(table: dict, k: int = 10, width: int = 100) -> list:
    """The k largest entries of {name: seconds} as [[name, seconds]]."""
    rows = sorted(table.items(), key=lambda r: -r[1])[:k]
    return [[name[:width], sec] for name, sec in rows]
