"""The result line of one run: the cell's metrics from its record."""

from __future__ import annotations

from . import drive, peaks, spec, trace


def end_to_end(rec: dict) -> dict:
    """samples_per_s, latency_p95_ms and setup_s, by the host clock. A
    metric named `<one of these>.<group>` is that one, in the cells its
    entry lists (`samples_per_s.clip` is samples_per_s)."""
    return {
        "samples_per_s": rec["steps"] * rec["samples_per_step"]
                         / rec["window_s"],
        "latency_p95_ms": 1e3 * drive.p95(rec["latency_s"]),
        "setup_s": rec["setup_s"],
    }


def context(cell, rec: dict, kind: str) -> dict:
    """What a per-layer reader reads: the cell, the trace's summary with
    its busy and traced-window seconds, the entry's host time and the
    card's peaks."""
    s = rec["summary"] if rec["summary"] and rec["summary"].get("steps") \
        else None
    return {
        "cell": cell,
        "summary": s,
        "busy_s": s["busy_s"] if s else None,
        "window_s": s["window_s"] if s else None,
        "entry_host_ms": rec["entry_host_ms"],
        "peaks": peaks.of(kind),
    }


def checks(cell, rec: dict) -> tuple:
    """(correct, {name: {value, limit}}): every number at or under its
    limit, and at least one output compared."""
    nums = rec["check"]["numbers"]
    table = {name: {"value": nums[name], "limit": cell.limits[name]["limit"]}
             for name in sorted(cell.limits) if name in nums}
    ok = (rec["check"]["pieces"] >= 1 and set(cell.limits) <= set(nums)
          and all(v["value"] <= v["limit"] for v in table.values()))
    return ok, table


def line(cell, rec: dict, traced: bool, kind: str | None = None) -> dict:
    """The result line's object (correct, attempted, failed, metrics,
    device, the seconds of `setup_s` that built the kernels, with a trace
    breakdown, and the check last); `kind` is the card's name (default:
    the current card's)."""
    if kind is None:
        import torch

        kind = torch.cuda.get_device_name(0)
    metrics = {}
    ctx = context(cell, rec, kind) if traced else None
    if not traced:
        e2e = end_to_end(rec)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": None, "attempted": rec["steps"], "failed": 0,
           "metrics": metrics, "device": device,
           "setup_build_s": rec["build_s"]}
    if traced:
        device["busy_s"] = ctx["busy_s"]
        device["window_s"] = ctx["window_s"]
        if ctx["summary"] is not None:
            out["breakdown"] = {
                "device_ops": trace.top(ctx["summary"]["device_s_by_name"]),
                "idle_gaps": trace.top(ctx["summary"]["idle_s_by_host_op"]),
            }
    ok, table = checks(cell, rec)
    out["correct"] = ok
    out["check"] = table
    return out
