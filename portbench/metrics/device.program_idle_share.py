"""device.program_idle_share: the share of the traced stretch, in %, in
which the card was idle inside the program's entry calls: the intervals
the stretch's entry calls occupied on the card (the timing events on
their entry spans, `crlot_tpu_torch.profiling.device_ns`), summed, less
the stretch's busy time, over its wall time. The stretch's calls are the
last `steps` entry calls of `profiling.span_log()`, as
`entry.plan_host_ms` takes them; with one call in flight, all the device
work of a step lies inside its call's interval. The rest of
device.idle_share is the harness's: its synchronize, its bookkeeping
between calls. Reported as computed, not clamped. Nothing when the run is
untraced, or where any of those calls lacks an interval (the CPU, or a
program whose spans record none)."""


def program_idle(records: list, steps: int, device_ns, busy_s: float,
                 window_s: float) -> float | None:
    """100 x (the summed intervals of the last `steps` entry calls of
    `records`, in s, - `busy_s`) / `window_s` (`device_ns`: a record ->
    its interval in ns, or None); None unless each of `steps` calls has
    its interval."""
    calls = [r for r in records if r.parent is None][-steps:]
    ns = [device_ns(r) for r in calls]
    if len(ns) < steps or None in ns:
        return None
    return 100.0 * (1e-9 * sum(ns) - busy_s) / window_s


def read(ctx):
    s = ctx["summary"]
    if s is None or not ctx["window_s"]:
        return None
    from crlot_tpu_torch import profiling

    log = getattr(profiling, "span_log", None)
    device_ns = getattr(profiling, "device_ns", None)
    if log is None or device_ns is None:
        return None
    return program_idle(log(), s["steps"], device_ns, ctx["busy_s"],
                        ctx["window_s"])
