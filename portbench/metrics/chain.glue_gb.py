"""chain.glue_gb: the bytes a feed's torch ops write besides B4's outputs
and the returned spectrum, in GB: the mean over the traced stretch's
feeds of `glue_bytes` on their `crlot.resample_stream.feed` spans (each
stage's join of history and input, the 16 kHz tail's join, the windowed
frames, the fold and the products' planes, counted by the program from
the tensors it wrote), from `profiling.span_log()`. The stretch's feeds
are the last `steps` entry calls of the log, as `entry.plan_host_ms`
takes them. Nothing when the run is untraced or the program records no
such counter."""

SPAN = "crlot.resample_stream.feed"


def glue_gb(records: list, steps: int) -> float | None:
    """The mean over the last `steps` entry calls of `records` of the
    `glue_bytes` their `SPAN` records carry, in GB; None where none of
    them carries it."""
    calls = [r.call for r in records if r.parent is None][-steps:]
    kept = set(calls)
    counts = [r.attrs["glue_bytes"] for r in records
              if r.call in kept and r.name == SPAN
              and "glue_bytes" in r.attrs]
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
    return glue_gb(log(), s["steps"])
