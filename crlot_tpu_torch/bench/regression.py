"""Performance-regression guard with saved baselines and tolerance bands.

Counterpart of `crlot_tpu/bench/regression.py` (reference:
bench/regression_test.cc): run the suite (or read a recorded suite JSON),
compare each metric against a saved `name: value` baseline within a +-10 %
band (+-5 % for FFT-1024), SNRs within 0.5 dB absolute, and
`--update-baseline` writes the run as the baseline of its backend. The
port's baselines are its own file, `crlot_tpu_torch/bench/baseline.json`,
keyed by the suite's `_backend`: "cpu", and "cuda:<card name>" from a run
on the card.

On the card the guard also measures `probes.quick_headline_duty` (skip it
with CRLOT_REGRESSION_DUTY=0) and bands the main path's chip-adjusted
roofline share under `headline_roofline_pct_chip_adjusted`; every run
carries an explicit `chip_adjusted_verdict` (pass / fail / not-applicable
with its reason). The reference's regime test (a degraded service window
of its tunnel) has no counterpart: the card serves one rate.

A timing band is a same-machine guard: a baseline written on one H100 and
read on another (another host, another power limit) can leave a band for
reasons that are not a regression. `chip_smoke.py` therefore prints the
timing bands' verdicts without gating on them, and gates on an exception,
on a band that is "armed but not measured" and on a failed SNR band.

Run: python -m crlot_tpu_torch.bench.regression [--update-baseline]
         [--baseline PATH] [--suites a,b] [--current JSON] [--device D]
Exit code 0 = within bands, 1 = a regression.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import os
import sys
from contextlib import redirect_stdout
from typing import Dict, Tuple

DEFAULT_BAND = 0.10  # +-10 % (regression_test.cc:20)
FFT1024_BAND = 0.05  # +-5 % for the FFT-1024 metric (regression_test.cc:173-175)
SNR_ABS_BAND_DB = 0.5  # SNR compares in absolute dB

_BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")


def band_for(name: str) -> float:
    return FFT1024_BAND if "fft" in name and "n1024" in name else DEFAULT_BAND


def is_timing_metric(name: str) -> bool:
    """Only latency-like metrics regress upward; counters (rtf, snr, pct)
    are checked downward."""
    return name.endswith(("_us", "_ms", "_ns_per_elem"))


def is_pct_metric(name: str) -> bool:
    """Roofline-share metrics (`headline_roofline_pct_chip_adjusted`),
    checked downward."""
    return name.endswith("_pct") or "_pct_" in name


def compare(
    current: Dict[str, float], baseline: Dict[str, float]
) -> Tuple[bool, list]:
    """(ok, report): each banded baseline metric against the run."""
    report = []
    ok = True
    for name, base in baseline.items():
        if name.startswith("_"):
            continue
        if name not in current:
            # A band the run did not measure must be visible, not a silent
            # pass: a note, not a regression verdict.
            report.append({"metric": name, "baseline": base, "pass": None,
                           "note": "armed but not measured this run"})
            continue
        cur = current[name]
        if (not isinstance(base, (int, float)) or not math.isfinite(base)
                or base <= 0):
            continue  # a NaN or empty baseline arms nothing
        if not isinstance(cur, (int, float)) or not math.isfinite(cur):
            report.append({"metric": name, "baseline": base, "current": cur,
                           "pass": None, "note": "unmeasurable (NaN) — skipped"})
            continue
        band = band_for(name)
        ratio = cur / base
        if is_timing_metric(name):
            passed = ratio <= 1.0 + band
        elif name.endswith("_snr_db"):
            passed = cur >= base - SNR_ABS_BAND_DB
            band = f"-{SNR_ABS_BAND_DB} dB abs"
        elif name.endswith("_rtf") or is_pct_metric(name):
            passed = ratio >= 1.0 - band
        else:
            continue
        ok &= passed
        report.append({"metric": name, "baseline": base, "current": cur,
                       "ratio": round(ratio, 3), "band": band,
                       "pass": passed})
    return ok, report


def merge_headline(current: Dict[str, float], headline: dict) -> None:
    """Fold a headline record's chip-adjusted share and SNR into a suite
    result under `headline_*` names (raw throughput stays unbanded)."""
    for src, dst in (
        ("roofline_pct_chip_adjusted", "headline_roofline_pct_chip_adjusted"),
        ("snr_db", "headline_snr_db"),
    ):
        if src in headline:
            current[dst] = headline[src]


def _on_card(current: dict) -> bool:
    return str(current.get("_backend", "")).startswith("cuda:")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--update-baseline", action="store_true")
    ap.add_argument("--baseline", default=_BASELINE_PATH)
    ap.add_argument("--suites", default="fft,kernels,ola,e2e")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--current", default=None,
                    help="use a recorded suite JSON instead of running it")
    ap.add_argument("--headline", default=None,
                    help="a headline record to merge (its chip-adjusted "
                    "share and SNR are banded under headline_* names)")
    args = ap.parse_args(argv)

    if args.current:
        with open(args.current) as f:
            current = json.loads(f.read().strip().splitlines()[-1])
    else:
        from . import suite

        buf = io.StringIO()
        with redirect_stdout(buf):
            suite.main(["--suites", args.suites, "--device", args.device])
        current = json.loads(buf.getvalue().strip().splitlines()[-1])

    if args.headline:
        with open(args.headline) as f:
            merge_headline(current, json.loads(f.read().strip()))

    if not _on_card(current):
        chip_verdict = {"status": "not-applicable",
                        "regime": "not a card backend", "probe": None}
    elif "headline_roofline_pct_chip_adjusted" in current:
        chip_verdict = {"status": "banded-from-headline-record"}
    elif os.environ.get("CRLOT_REGRESSION_DUTY", "1") == "0":
        chip_verdict = {"status": "not-applicable",
                        "regime": "probe disabled (CRLOT_REGRESSION_DUTY=0)",
                        "probe": None}
    else:
        from .probes import quick_headline_duty

        duty = quick_headline_duty()
        current["headline_roofline_pct_chip_adjusted"] = duty[
            "roofline_pct_chip_adjusted"]
        current["headline_snr_db"] = duty["snr_db"]
        current["_duty_probe"] = duty
        chip_verdict = {"status": "banded-from-duty-probe"}

    key = current.get("_backend", "unknown")
    baselines = {}
    if os.path.exists(args.baseline):
        with open(args.baseline) as f:
            baselines = json.load(f)

    if args.update_baseline:
        baselines[key] = current
        with open(args.baseline, "w") as f:
            json.dump(baselines, f, indent=1, sort_keys=True)
            f.write("\n")
        print(json.dumps({"updated": args.baseline, "backend": key}))
        return 0

    if key not in baselines:
        print(json.dumps({"error": f"no baseline for backend '{key}'",
                          "hint": "run with --update-baseline first"}))
        return 0  # no baseline yet is not a failure

    ok, report = compare(current, baselines[key])
    if chip_verdict["status"].startswith("banded"):
        hit = [r for r in report
               if r["metric"] == "headline_roofline_pct_chip_adjusted"]
        if hit and hit[0].get("pass") is not None:
            chip_verdict["status"] = "pass" if hit[0]["pass"] else "fail"
            chip_verdict["check"] = hit[0]
        else:
            chip_verdict.update(status="not-applicable",
                                regime="no baseline entry for the band",
                                probe=current.get("_duty_probe"))
    print(json.dumps({"pass": ok, "exit": 0 if ok else 1, "backend": key,
                      "checks": report,
                      "chip_adjusted_verdict": chip_verdict,
                      "duty_probe": current.get("_duty_probe")}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
