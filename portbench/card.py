"""A cell on its card: its entry, the stream's mesh, and for each seed
the inputs, the warm-up, the window and the check."""

from __future__ import annotations

import gc
import time

import torch

from . import drive, spec


def _mesh(cell, device):
    m = cell.traffic.get("mesh")
    if m is None:
        return None
    from crlot_tpu_torch.distributed import make_mesh

    return make_mesh(m["channel"], m["time"],
                     devices=[device] * (m["channel"] * m["time"]))


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell, seeds: list, seconds: float, traced: bool, device_kind: str,
        control: bool, t0: float) -> list:
    """One record a seed."""
    torch.set_num_threads(1)
    build_s = 0.0
    if device_kind == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        from crlot_tpu_torch import cuda_build

        cuda_build.load_library()  # nvcc on a checkout's first run
        build_s = cuda_build.build_seconds
    else:
        device = torch.device("cpu")
    entry = spec.entry(cell.traffic["entry"])
    mesh = _mesh(cell, device)
    records = []
    for i, seed in enumerate(seeds):
        marks = [("start", time.perf_counter() - t0)]
        ring = entry.inputs(cell, seed, device)
        drive.sync(device)
        marks.append(("inputs", time.perf_counter() - t0))
        loop = entry.Loop(cell, ring, device, mesh)
        loop.step(0)
        drive.sync(device)
        marks.append(("first call", time.perf_counter() - t0))
        for w in range(1, int(cell.traffic["warmup_calls"])):
            loop.step(w)
        drive.sync(device)
        marks.append(("warm-up", time.perf_counter() - t0))
        if traced:  # the profiler's first start is slow: not in the window
            with drive.profiler(device):
                loop.step(0)
                drive.sync(device)
        win = drive.window(loop, device, seconds, seed, cell.traffic, traced)
        rec = {
            "seed": seed,
            "setup_s": win["first_step_t"] - t0 if i == 0 else None,
            "build_s": build_s if i == 0 else 0.0,
            "setup_marks": marks,
            "steps": win["steps"],
            "window_s": win["window_s"],
            "latency_s": win["latency_s"],
            "entry_host_ms": (1e3 * sum(win["untraced_host_s"])
                              / len(win["untraced_host_s"])
                              if win["untraced_host_s"] else None),
            "samples_per_step": loop.samples_per_step,
            "summary": win["summary"],
            "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else 0),
        }
        kept = win["kept"]
        del win
        loop.free()
        _free(device)
        t_check = time.perf_counter()
        rec["check"] = drive.check(loop, kept, cell, device,
                                   entry.reference, control)
        rec["check_s"] = time.perf_counter() - t_check
        del kept, loop, ring
        _free(device)
        records.append(rec)
    return records
