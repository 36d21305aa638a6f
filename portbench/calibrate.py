"""Readings for a cell's correctness limits, on the card:

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 [--seconds 2]

For each seed, in one process: the inputs made anew, a short window of
the cell's own traffic, and the check of as many outputs as a run checks,
against the float64 reference, of the program (its sound reading) and of
the control, the reference itself computed in TF32 in the program's place.
One JSON line a seed; the limits in `limits/<cell>.json` are set between
the program's largest reading and the control's smallest.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    _, recs = run.run_cell(args.workload, seeds, args.seconds, False,
                           control=True)
    for rec in recs:
        print(json.dumps({"seed": rec["seed"], "steps": rec["steps"],
                          "program": rec["check"]["numbers"],
                          "control": rec["check"]["control"],
                          "pieces": rec["check"]["pieces"],
                          "gated_share": rec["check"].get("gated_share")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
