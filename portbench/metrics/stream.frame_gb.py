"""stream.frame_gb: the frame-sized traffic a feed writes, in GB: the
mean over the traced stretch's feeds of `frame_bytes` on their
`crlot.sharded.round_trip` spans (the masked route's [rows, F, N]
tensors, counted by the program from the tensors it wrote: the per-shard
route's frames alone, as B1's seeded variant writes no mask), from
`profiling.span_log()`. The
stretch's feeds are the last `steps` entry calls of the log, as
`entry.plan_host_ms` takes them. Nothing when the run is untraced or the
program records no such counter."""

SPAN = "crlot.sharded.round_trip"


def frame_gb(records: list, steps: int) -> float | None:
    """The mean over the last `steps` entry calls of `records` of the
    `frame_bytes` their `SPAN` records carry, in GB; None where none of
    them carries it."""
    calls = [r.call for r in records if r.parent is None][-steps:]
    kept = set(calls)
    counts = [r.attrs["frame_bytes"] for r in records
              if r.call in kept and r.name == SPAN
              and "frame_bytes" in r.attrs]
    if not counts:
        return None
    return 1e-9 * sum(counts) / len(calls)


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    from crlot_tpu_torch import profiling

    log = getattr(profiling, "span_log", None)
    if log is None:
        return None
    return frame_gb(log(), s["steps"])
