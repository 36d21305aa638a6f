"""Run one cell of `BENCHMARK.json` once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (`setup_s`) runs from this module's first line to the first timed
call: the imports, the CUDA context, the kernel library (built by nvcc on
a checkout's first run, into the checkout's `build/`; those seconds are
also given apart, as `setup_build_s`), the inputs, the program's constants
and the warm-up calls. Then the closed-loop window of `--seconds`; then,
with the window closed and the peak memory read, the check of the outputs
it produced against the float64 reference. The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error and the last key of that object.

The process runs on one CPU core (`pin`), so that the host's share of a
call is not moved between cores during the window.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "crlot_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the harness must not
    load (compared whole: `crlot_tpu_torch` is not `crlot_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def pin() -> int | None:
    """Keep this process, and every thread it starts from now on, on the
    last CPU core it may use; that core, or None where it may use one."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 2:
        return None
    os.sched_setaffinity(0, {cores[-1]})
    return cores[-1]


def run_cell(workload: str, seeds: list, seconds: float, traced: bool,
             device_kind: str = "cuda", overrides: dict | None = None,
             control: bool = False) -> tuple:
    """(the cell as run, one record a seed): `seeds` in one process, the
    inputs made anew for each; `control` also reads the TF32 control."""
    from . import card, spec

    cell = spec.cell(workload)
    for key, part in (overrides or {}).items():
        getattr(cell, key).update(part)
    return cell, card.run(cell, seeds, seconds, traced, device_kind,
                          control, T0)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def describe(rec: dict) -> str:
    """The run's counts on one line: calls, latency quantiles and their
    sample count, the set-up's marks, the check's pieces and time, calls
    in each second of the window, the trace's stretch."""
    import statistics

    lat = sorted(rec["latency_s"])
    q = statistics.quantiles(lat, n=20, method="inclusive") if len(lat) > 1 \
        else lat * 19
    parts = [f"{rec['steps']} calls in {rec['window_s']:.4f} s",
             f"latency p50 {1e3 * q[9]:.4f} ms p95 {1e3 * q[18]:.4f} ms "
             f"max {1e3 * lat[-1]:.4f} ms over {len(lat)} calls",
             f"setup {rec['setup_s']:.3f} s, the kernels' build "
             f"{rec['build_s']:.3f} s of it ("
             + ", ".join(f"{k} at {v:.3f}" for k, v in rec["setup_marks"])
             + ")",
             f"check {rec['check']['pieces']} pieces in "
             f"{rec['check_s']:.2f} s"]
    t, per_s = 0.0, [0]
    for v in rec["latency_s"]:
        t += v
        if t >= len(per_s):
            per_s.append(0)
        per_s[-1] += 1
    parts.append(f"calls a second {per_s[:-1]}")
    if "gated_share" in rec["check"]:
        parts.append(f"gated share {rec['check']['gated_share']:.4f}")
    s = rec["summary"]
    if s and s.get("steps"):
        parts.append(f"traced {s['steps']} steps over {s['window_s']:.4f} s,"
                     f" busy {s['busy_s']:.4f} s")
    return "; ".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    core = pin()

    import torch

    from . import result, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell, (res,) = run_cell(args.workload, [args.seed], args.seconds,
                            bool(args.trace))
    print(f"portbench: card {card_line()}; CPU core {core}", file=sys.stderr)
    print(f"portbench: {describe(res)}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result", file=sys.stderr)
        return 1
    line = result.line(cell, res, bool(args.trace))
    for name, v in line["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
