"""kernel.b1_roofline: B1's share of its roofline, in %: the least time
the card could take for the OLA and normalize of a clip's frames (the
frames read, the norm read and the output written, once each, at the HBM
bandwidth) over the device time a step of B1's launches in the trace,
`ola_normalized_kernel`. Nothing when the trace holds no B1 launch."""

from portbench import trace, work

NAMES = ("ola_normalized_kernel",)


def b1_clip(config: dict, channels: int, samples: int) -> dict:
    """B1 over a clip: [channels, F, N] frames read, the norm over the
    frames' span read, and [channels, span] written, in float32."""
    n, hop = config["frame_size"], config["hop_size"]
    f = work.frames_of(config, samples)
    span = (f - 1) * hop + n
    data = (channels * f * n + span + channels * span) * work.F32
    return {"ops": 0, "bytes": data}


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    t = trace.seconds_matching(s, NAMES) / s["steps"]
    if t <= 0:
        return None
    c = ctx["cell"].config
    bound, _ = work.bound_s(b1_clip(c, c["channels"], c["samples"]),
                            ctx["peaks"])
    return 100.0 * bound / t
