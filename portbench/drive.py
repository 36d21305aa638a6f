"""Drive a cell: the closed-loop window over an entry's loop, the trace
of a stretch of it, and the check of the outputs it produced.

The loops of the two entries there are, `entries/round_trip.py` and
`entries/stream.py`, live here: `pipeline.round_trip` on a clip, or
`ShardedStreamer.feed` on a stream's next chunk. One call is in flight:
each is issued, then synchronized, then the next is issued.
"""

from __future__ import annotations

import contextlib
import random
import statistics
import time

import torch

from . import trace
from .reference import stft64


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def port_config(config: dict):
    from crlot_tpu_torch.core.types import FftPrecision, PadMode, StftConfig

    return StftConfig(
        frame_size=config["frame_size"], hop_size=config["hop_size"],
        center=config["center"], pad_mode=PadMode(config["pad_mode"]),
        eps=float(config["eps"]),
        fft_precision=FftPrecision(config["precision"]),
    )


def port_spectral(spectral: dict, config: dict):
    from crlot_tpu_torch import spectral as sp

    if spectral["kind"] == "band_gain":
        return sp.band_gain(spectral["edges_hz"], spectral["gains"],
                            config["sample_rate"], config["frame_size"])
    if spectral["kind"] == "noise_gate":
        return sp.noise_gate(spectral["threshold_db"],
                             spectral["attenuation_db"])
    raise ValueError(f"unknown spectral function {spectral['kind']!r}")


class Reservoir:
    """A uniform sample of `k` of the items offered, drawn from the seed:
    the same seed and the same number of items keep the same ones."""

    def __init__(self, k: int, seed: int) -> None:
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class ClipLoop:
    """`round_trip` on clip i % ring of a ring of device-resident clips."""

    def __init__(self, cell, ring: list, device, mesh) -> None:
        from crlot_tpu_torch import pipeline

        config, traffic = cell.config, cell.traffic
        self.pipeline = pipeline
        self.config, self.ring = config, ring
        self.cfg = port_config(config)
        self.fn = port_spectral(traffic["spectral"], config)
        route = pipeline.formulation_for(self.cfg, self.fn,
                                         config["samples"])
        if route != traffic["route"]:
            raise RuntimeError(f"round_trip takes route {route!r}, the mix "
                               f"names {traffic['route']!r}")
        self.route = route
        self.samples_per_step = ring[0].numel()

    def step(self, i: int):
        out = self.pipeline.round_trip(self.ring[i % len(self.ring)],
                                       self.cfg, self.fn)
        return out, i % len(self.ring)

    def pieces(self, kept) -> list:
        """[(program output, function of a RoundTrip -> its reference)]."""
        out, k = kept
        center = self.config["center"]
        return [(out, lambda rt, k=k: stft64.clip_round_trip(
            rt, self.ring[k], center))]

    def free(self) -> None:
        pass


class StreamLoop:
    """`ShardedStreamer.feed` of the stream whose chunk j is ring[j % ring];
    each feed returns the chunk before it."""

    def __init__(self, cell, ring: list, device, mesh) -> None:
        from crlot_tpu_torch.distributed.stream import ShardedStreamer

        config, traffic = cell.config, cell.traffic
        self.config, self.ring = config, ring
        self.cfg = port_config(config)
        self.fn = port_spectral(traffic["spectral"], config)
        self.streamer = ShardedStreamer(self.cfg, mesh, self.fn,
                                        device=device)
        self.mode = traffic["stream_mode"]
        self.chunk = ring[0].shape[1]
        self.fed = 0
        self.samples_per_step = ring[0].shape[0] * self.chunk

    def step(self, i: int):
        out = self.streamer.feed(self.ring[self.fed % len(self.ring)],
                                 force=False)
        self.fed += 1
        if self.fed == 1:
            mode = "blocked" if self.streamer.blocked else "masked"
            if mode != self.mode:
                raise RuntimeError(f"the stream runs {mode}, the mix names "
                                   f"{self.mode}")
        return out, self.fed - 2  # the chunk this feed completed

    def pieces(self, kept) -> list:
        """A completed chunk with its reference: the one-shot round-trip
        over the stream at the same positions, context included."""
        out, m = kept
        s = self.chunk
        return [(out, lambda rt, lo=m * s: stft64.stream_round_trip(
            rt, self.ring, s, slice(None), lo, lo + s))]

    def free(self) -> None:
        self.streamer = None


def window(loop, device, seconds: float, seed: int, traffic: dict,
           traced: bool) -> dict:
    """The closed-loop window: steps until `seconds` have passed, with
    each step's latency and host
    time, a reservoir of completed outputs, and, when `traced`, a profile
    of steps [trace_from, trace_from + trace_calls)."""
    res = Reservoir(int(traffic["compare"]), seed)
    lat, untraced_host = [], []
    first, count = int(traffic["trace_from"]), int(traffic["trace_calls"])
    lead = 3  # steps profiled before the stretch, while tracing settles
    prof, finished = None, None
    n = 0
    t0 = time.perf_counter()
    while True:
        if (traced and prof is None and finished is None
                and n == max(0, first - lead)):
            prof = profiler(device)
            prof.__enter__()
        mark = (torch.profiler.record_function(trace.STEP)
                if prof is not None else contextlib.nullcontext())
        ts = time.perf_counter()
        with mark:
            out, done = loop.step(n)
            th = time.perf_counter()
            sync(device)
        te = time.perf_counter()
        lat.append(te - ts)
        if prof is None:
            untraced_host.append(th - ts)
        if done >= 0:
            res.offer((out, done))
        n += 1
        if prof is not None and n >= first + count:
            prof.__exit__(None, None, None)
            finished, prof = prof, None
        if te - t0 >= seconds:
            break
    if prof is not None:  # the window closed inside the stretch
        prof.__exit__(None, None, None)
        finished = prof
    summary = None
    if finished is not None:
        dev, hst = trace.events(finished)
        summary = trace.summarize(dev, hst, min(lead, first), count)
    return {
        "steps": n,
        "window_s": te - t0,
        "latency_s": lat,
        "untraced_host_s": untraced_host,
        "kept": res.items,
        "summary": summary,
        "first_step_t": t0,
    }


def profiler(device):
    act = torch.profiler.ProfilerActivity
    acts = [act.CPU, act.CUDA] if device.type == "cuda" else [act.CPU]
    return torch.profiler.profile(activities=acts)


def check(loop, kept: list, cell, device, reference,
          control: bool = False) -> dict:
    """Compare every kept output with the float64 reference, the entry's
    `reference(cell, device, "float64")`: the worst of each number, the
    pieces compared, and (for a reference that counts bins, as a gate's
    does) the share of bins it gates. With `control`, also the TF32
    control, `reference(cell, device, "tf32")`, in the program's place:
    its worst numbers against the same reference."""
    ref = reference(cell, device, "float64")
    ctl = reference(cell, device, "tf32") if control else None
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {"err_rel": 0.0, "peak_rel": 0.0}
    worst_ctl = {"err_rel": 0.0, "peak_rel": 0.0}
    pieces = 0
    try:
        for item in kept:
            for y, make_ref in loop.pieces(item):
                r = make_ref(ref)
                for key, v in stft64.compare(y, r).items():
                    worst[key] = max(worst[key], v)
                if ctl is not None:
                    for key, v in stft64.compare(make_ref(ctl), r).items():
                        worst_ctl[key] = max(worst_ctl[key], v)
                pieces += 1
                del r
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    out = {"numbers": worst, "pieces": pieces}
    if getattr(ref, "bins", 0):
        out["gated_share"] = ref.gated_bins / ref.bins
    if ctl is not None:
        out["control"] = worst_ctl
    return out


def p95(values: list) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]
