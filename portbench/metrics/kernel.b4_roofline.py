"""kernel.b4_roofline: B4's share of its roofline, in %: the least time
the card could take for one feed's polyphase sums (`b4_feed`: every
stage, worked out from the configuration alone), over the device time a
step of B4's launches in the trace (`runs_kernel`, `blocks_kernel`,
`windows_kernel`). Nothing when the trace holds no such launch."""

import math

from portbench import trace, work

NAMES = ("runs_kernel", "blocks_kernel", "windows_kernel")


def filter_taps(l: int, m: int, atten_db: float, rolloff: float) -> int:
    """n_h, the filter's length from the Kaiser length formula: 2 *
    max(ceil((atten_db - 7.95) / (2.285 * rolloff * pi / max(L, M))) // 2,
    max(L, M)) + 1."""
    mx = max(l, m)
    n_total = math.ceil((atten_db - 7.95) / (2.285 * rolloff * math.pi / mx))
    return 2 * max(n_total // 2, mx) + 1


def taps_per_output(l: int, m: int, atten_db: float, rolloff: float) -> float:
    """n_h / L: the non-zero taps an output reads, on average over the L
    phases (a phase reads floor or ceil of it)."""
    return filter_taps(l, m, atten_db, rolloff) / l


def b4_feed(config: dict, peaks: dict) -> float:
    """The bound of one feed's B4 work, in seconds: over the stages, the
    larger of the operations time (the outputs a feed times the taps an
    output, 2 flop each, at the fp32 peak) and the bytes time (the input
    read and the output written once, at the HBM bandwidth)."""
    rows, n_in = config["channels"], config["chunk_samples_per_card"]
    rates = config["rates"]
    total = 0.0
    for a, b in zip(rates, rates[1:]):
        g = math.gcd(a, b)
        l, m = b // g, a // g
        n_out = n_in * l / m
        taps = taps_per_output(l, m, config["atten_db"], config["rolloff"])
        ops = 2.0 * rows * n_out * taps
        data = rows * (n_in + n_out) * work.F32
        total += max(ops / peaks["fp32_flops"],
                     data / peaks["hbm_bytes_per_s"])
        n_in = n_out
    return total


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    t = trace.seconds_matching(s, NAMES) / s["steps"]
    if t <= 0:
        return None
    return 100.0 * b4_feed(ctx["cell"].config, ctx["peaks"]) / t
