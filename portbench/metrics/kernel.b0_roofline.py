"""kernel.b0_roofline: B0's share of its roofline, in %: the least time
the card could take for the hop-block products a step needs
(`work.b0_clip` for `round_trip`'s blocked route, `work.b0_stream_step`
for a stream step; operations set the bound there, 3xTF32 counted as three
TF32 products) over B0's device time a step, the `b6_sm90_kernel` launches
of the trace (mode 8 is the only mode these cells run). Nothing when the
trace holds no B0 launch."""

from portbench import trace, work


NAMES = ("b6_sm90_kernel",)


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    t = trace.seconds_matching(s, NAMES) / s["steps"]
    if t <= 0:
        return None
    cell = ctx["cell"]
    c = cell.config
    if cell.traffic["entry"] == "round_trip":
        w = work.b0_clip(c, c["channels"], c["samples"])
    else:
        w = work.b0_stream_step(c, c["channels"],
                                c["chunk_samples_per_card"],
                                cell.traffic["mesh"]["time"])
    bound, _ = work.bound_s(w, ctx["peaks"])
    return 100.0 * bound / t
