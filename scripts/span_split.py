"""Each benchmark cell's traced stretch split by program span, on the card.

    python scripts/span_split.py [--cells a,b] [--seed N] [--seconds S]
                                 [--out FILE]

First, the host cost of an entry span's two timing events: a traced entry
span around nothing, with and without them, in turns. Then, for each cell
of `BENCHMARK.json` (default: every one), one traced run as `python3 -m
portbench.run --trace 1` makes it, on one CPU core, keeping the window's
profile. One JSON line a cell, printed (and appended to FILE): the result
line's per-layer metrics and busy and window seconds; over the traced
stretch (the last `trace_calls` of the profile's `portbench.step`
markers) the idle by span (`profiling.idle_split`), the share of the
stretch the program's spans hold and the share outside them; the
stretch's entry calls' intervals on the card (`profiling.device_ns`), a
call; the device time a step by span (`profiling.device_by_span` over the
whole profile, over the steps it holds) beside the profile's device time
a step; and how far device events start after the host calls that
launched them (`launch_lag_us`: negative where the profile's device clock
runs ahead of its host clock).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from crlot_tpu_torch import profiling  # noqa: E402
from portbench import drive, result, run, spec, trace  # noqa: E402

def event_cost_us(rounds: int = 5, calls: int = 2000) -> dict:
    """The host us a traced entry span around nothing takes with its two
    timing events and without them, the median of `rounds` turns of
    `calls` spans each; and, with them, the us from entering the span to
    its `start_ns` and from its `end_ns` to the end of its exit."""
    made = profiling._on_card
    took = {"with": [], "without": []}
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]):
        for _ in range(rounds):
            for key, source in (("with", made), ("without", lambda: None)):
                profiling._on_card = source
                try:
                    t = time.perf_counter_ns()
                    for _ in range(calls):
                        with profiling.span("crlot.cost"):
                            pass
                    took[key].append((time.perf_counter_ns() - t)
                                     / calls / 1e3)
                finally:
                    profiling._on_card = made
                torch.cuda.synchronize()
    out = {k: statistics.median(v) for k, v in took.items()}
    out["added"] = out["with"] - out["without"]
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]):
        around = []
        for _ in range(calls):
            t = time.perf_counter_ns()
            with profiling.span("crlot.cost"):
                pass
            around.append((t, time.perf_counter_ns()))
    kept = [r for r in profiling.span_log() if r.name == "crlot.cost"]
    pairs = list(zip(around[-len(kept):], kept))
    out["before_start"] = statistics.median(
        (r.start_ns - t) / 1e3 for (t, _), r in pairs)
    out["after_end"] = statistics.median(
        (t - r.end_ns) / 1e3 for (_, t), r in pairs)
    return out


def launch_lag_us(prof, marks: list) -> dict:
    """Device start - host launch start, in us, over every device event
    whose runtime call the profile holds (the smallest and the median),
    and of the first event launched in each of the steps `marks` (host
    (start, end) of each): the smallest, the median, the largest, the
    first step's and the last's. The stream is empty at a step's first
    launch, so that lag is the launch's own latency where the two clocks
    agree."""
    dev, _, calls, _ = profiling._profile(prof)
    linked = sorted((calls[c], s - calls[c]) for _, c, s, _ in dev
                    if c in calls)
    if not linked:
        return {}
    lags = [lag for _, lag in linked]
    firsts = []
    for lo, hi in marks:
        step = [lag for t, lag in linked if lo <= t < hi]
        if step:
            firsts.append(step[0])
    out = {"min": min(lags), "median": statistics.median(lags),
           "linked": len(lags), "events": len(dev)}
    if firsts:
        out["first_launch"] = {
            "min": min(firsts), "median": statistics.median(firsts),
            "max": max(firsts), "first": firsts[0], "last": firsts[-1]}
    return out


def split(name: str, seed: int, seconds: float) -> dict:
    made = []
    profiler = drive.profiler

    def keep(device):
        made.append(profiler(device))
        return made[-1]

    drive.profiler = keep
    try:
        cell, (rec,) = run.run_cell(name, [seed], seconds, True)
    finally:
        drive.profiler = profiler
    line = result.line(cell, rec, True)
    prof = made[-1]
    dev, host = trace.events(prof)
    marks = sum(1 for n, _, _ in host if n == trace.STEP)
    count = int(cell.traffic["trace_calls"])
    lo, hi, steps = trace.stretch(host, marks - count, count)
    window = (hi - lo) * 1e-6
    spans = [h for h in host if h[0].startswith(profiling.SPAN_PREFIX)]
    idle = profiling.idle_split(dev, spans, lo, hi)
    program = sum(v for k, v in idle.items() if k != profiling.OUTSIDE)
    entries = [r for r in profiling.span_log() if r.parent is None][-steps:]
    ns = [profiling.device_ns(r) for r in entries]
    by_span = profiling.device_by_span(prof)
    device_s = sum(e - s for _, s, e in dev) * 1e-6
    out = {
        "cell": name, "seed": seed, "card": run.card_line(),
        "metrics": {k: v["value"] for k, v in line["metrics"].items()},
        "correct": line["correct"],
        "busy_s": line["device"]["busy_s"],
        "window_s": line["device"]["window_s"],
        "stretch": {"steps": steps, "window_s": window,
                    "idle_pct": {k: 100 * v / window
                                 for k, v in sorted(idle.items(),
                                                    key=lambda kv: -kv[1])},
                    "program_pct": 100 * program / window,
                    "outside_pct": 100 * idle.get(profiling.OUTSIDE, 0.0)
                    / window},
        "entry_interval_ms": (None if None in ns
                              else 1e-6 * sum(ns) / len(ns)),
        "steps_profiled": marks,
        "device_ms_a_step": {k: 1e3 * v / marks
                             for k, v in sorted(by_span.items(),
                                                key=lambda kv: -kv[1])},
        "device_ms_a_step_total": 1e3 * device_s / marks,
        "by_span_sum_rel": (abs(sum(by_span.values()) - device_s) / device_s
                            if device_s else None),
        "device_ms_a_step_by_name": trace.top(
            {n: 1e3 * v / steps for n, v in
             trace.summarize(dev, host, marks - count, count)[
                 "device_s_by_name"].items()}, 12),
        "launch_lag_us": launch_lag_us(
            prof, sorted((s, e) for n, s, e in host if n == trace.STEP)),
    }
    del made, prof, dev, host
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=None)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 30)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_split: needs a CUDA card", file=sys.stderr)
        return 2
    core = run.pin()
    names = (args.cells.split(",") if args.cells
             else [w["name"] for w in spec.benchmark()["workloads"]])

    def emit(line: dict) -> None:
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")

    torch.cuda.init()
    emit({"event_cost_us": event_cost_us(), "core": core,
          "card": run.card_line()})
    for name in names:
        emit(split(name, args.seed, args.seconds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
