"""entry.host_ms: the host's time inside the entry call (`round_trip`, or
`ShardedStreamer.feed`), from issuing it to its return before the
synchronize, by the host clock; the mean over the traced run's steps
outside the profiled stretch (the profiler slows the host)."""


def read(ctx):
    return ctx["entry_host_ms"]
