"""kernel.b7_roofline: B7's share of its roofline, in %: the least time
the card could take for one feed's windowed rFFT (`b7_feed`, worked out
from the configuration alone), over the device time a step of B7's
launches in the trace (`stft_fp32_window_kernel`). Nothing when the trace
holds no such launch."""

import math

from portbench import trace, work

NAMES = ("stft_fp32_window_kernel",)


def frames_per_feed(config: dict) -> int:
    """The frames a feed completes once the filters' delay is fed: the
    feed's samples at the last rate over the hop."""
    rates = config["rates"]
    n_out = config["chunk_samples_per_card"] * rates[-1] // rates[0]
    return n_out // config["hop_size"]


def b7_feed(config: dict, peaks: dict) -> float:
    """The bound of one feed's B7 work, in seconds: the larger of the
    bytes time (the signal at the last rate read and the complex64
    spectrum written once, at the HBM bandwidth) and the operations time
    (a real FFT's 2.5 N log2 N flop a frame, at the fp32 peak). The bytes
    bound it: a DFT as products would count (N/2+1)^2 + (N/2-1)^2
    multiply-adds a frame, which an FFT does not need."""
    rows, n = config["channels"], config["frame_size"]
    rates, h = config["rates"], n // 2
    frames = frames_per_feed(config)
    ops = 2.5 * n * math.log2(n) * rows * frames
    signal = config["chunk_samples_per_card"] * rates[-1] // rates[0]
    data = rows * (signal + 2 * frames * (h + 1)) * work.F32
    return max(ops / peaks["fp32_flops"], data / peaks["hbm_bytes_per_s"])


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    t = trace.seconds_matching(s, NAMES) / s["steps"]
    if t <= 0:
        return None
    return 100.0 * b7_feed(ctx["cell"].config, ctx["peaks"]) / t
