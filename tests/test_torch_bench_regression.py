"""The port's regression guard (`crlot_tpu_torch/bench/regression.py`).

Mirrors the 15 cases of `tests/test_regression_guard.py` against the
port: the bands (+-10 %, +-5 % for FFT-1024, downward-only for counters,
SNR within 0.5 dB absolute), NaN handling, the CLI verdict on a synthetic
regression, the headline merge, the checked-in baseline
(`crlot_tpu_torch/bench/baseline.json`, with its "cpu" key and the card's
"cuda:<name>" key) and the chip-adjusted band; plus the bands against the
reference's `compare` on the same data, the chip-adjusted verdict of the
CLI on a card backend, and the JAX package's baseline left without the
port's keys. No tolerance: the verdicts are exact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from crlot_tpu.bench import regression as jreg

from crlot_tpu_torch.bench.regression import (
    _BASELINE_PATH,
    band_for,
    compare,
    merge_headline,
)

REPO = Path(__file__).resolve().parent.parent
CARD_KEY = "cuda:NVIDIA H100 80GB HBM3"

BASE = {
    "fft_roundtrip_n1024_b1_us": 100.0,
    "e2e_1s48k_n1024_h256_ms": 1.0,
    "e2e_1s48k_n1024_h256_rtf": 1000.0,
    "e2e_1s48k_n1024_h256_snr_db": 95.0,
}
CARD_BASE = {
    "headline_roofline_pct_chip_adjusted": 67.4,
    "headline_snr_db": 95.3,
}


def _baselines() -> dict:
    with open(_BASELINE_PATH) as f:
        return json.load(f)


def _cli(tmp_path, baseline: dict, current: dict, *extra):
    (tmp_path / "baseline.json").write_text(json.dumps(baseline))
    (tmp_path / "current.json").write_text(json.dumps(current))
    p = subprocess.run(
        [sys.executable, "-m", "crlot_tpu_torch.bench.regression",
         "--baseline", str(tmp_path / "baseline.json"),
         "--current", str(tmp_path / "current.json"), *extra],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    return p, json.loads(p.stdout.strip().splitlines()[-1])


def test_bands():
    assert band_for("fft_roundtrip_n1024_b1_us") == 0.05
    assert band_for("ola_n1024_h512_f375_us") == 0.10


def test_within_band_passes():
    cur = dict(BASE, e2e_1s48k_n1024_h256_ms=1.05)  # +5 % < 10 %
    ok, report = compare(cur, BASE)
    assert ok, report


def test_twenty_percent_slowdown_fails():
    cur = dict(BASE, e2e_1s48k_n1024_h256_ms=1.20)
    ok, report = compare(cur, BASE)
    assert not ok
    failed = [r for r in report if r.get("pass") is False]
    assert failed and failed[0]["metric"] == "e2e_1s48k_n1024_h256_ms"


def test_fft1024_tight_band():
    ok, _ = compare(dict(BASE, fft_roundtrip_n1024_b1_us=107.0), BASE)
    assert not ok  # +7 % > 5 %


def test_counter_regressions_are_downward():
    ok, _ = compare(dict(BASE, e2e_1s48k_n1024_h256_rtf=850.0), BASE)
    assert not ok  # -15 % throughput
    ok, _ = compare(dict(BASE, e2e_1s48k_n1024_h256_rtf=2000.0), BASE)
    assert ok  # faster is never a regression


def test_nan_is_skipped_not_failed():
    ok, report = compare(dict(BASE, e2e_1s48k_n1024_h256_ms=float("nan")),
                         BASE)
    assert ok
    notes = [r for r in report if "note" in r]
    assert notes and "unmeasurable" in notes[0]["note"]


def test_baseline_checked_in():
    """The port's own baseline exists and holds the "cpu" key (recorded
    with the guard's default suites) and the card's key (from a run on the
    H100); each is armed: a 20 % slowdown of its e2e time fails."""
    assert os.path.exists(_BASELINE_PATH)
    baselines = _baselines()
    assert "cpu" in baselines and CARD_KEY in baselines
    for key in ("cpu", CARD_KEY):
        base = baselines[key]
        assert base["_backend"] == key
        cur = dict(base)
        cur["e2e_1s48k_n1024_h256_ms"] = base["e2e_1s48k_n1024_h256_ms"] * 1.2
        ok, report = compare(cur, base)
        assert not ok, key
        assert [r["metric"] for r in report if r.get("pass") is False] == [
            "e2e_1s48k_n1024_h256_ms"]


def test_cli_verdict_on_synthetic_regression(tmp_path):
    """A 25 % slowdown against a saved baseline exits 1 and reports the
    violation (the regression_test.cc:173-186 contract)."""
    cur = dict(BASE, _backend="cpu", e2e_1s48k_n1024_h256_ms=1.25)
    p, verdict = _cli(tmp_path, {"cpu": BASE}, cur)
    assert p.returncode == 1, p.stdout + p.stderr
    assert verdict["pass"] is False and verdict["exit"] == 1
    assert verdict["chip_adjusted_verdict"]["status"] == "not-applicable"


def test_nan_baseline_is_skipped():
    base = dict(BASE, ola_n1024_h512_f375_us=float("nan"))
    cur = dict(BASE, ola_n1024_h512_f375_us=123.0)
    ok, report = compare(cur, base)
    assert ok
    assert not any(r["metric"] == "ola_n1024_h512_f375_us" for r in report)


def test_card_chip_adjusted_regression_fires():
    """A 20 % drop of the main path's chip-adjusted roofline share fails."""
    cur = dict(CARD_BASE,
               headline_roofline_pct_chip_adjusted=67.4 * 0.80)
    ok, report = compare(cur, CARD_BASE)
    assert not ok
    failed = [r for r in report if r.get("pass") is False]
    assert failed and failed[0]["metric"] == (
        "headline_roofline_pct_chip_adjusted")


def test_card_chip_adjusted_within_band_passes():
    cur = dict(CARD_BASE, headline_roofline_pct_chip_adjusted=67.4 * 0.95)
    ok, report = compare(cur, CARD_BASE)
    assert ok, report


def test_snr_band_is_absolute_half_db():
    ok, _ = compare(dict(CARD_BASE, headline_snr_db=95.3 - 0.4), CARD_BASE)
    assert ok
    ok, _ = compare(dict(CARD_BASE, headline_snr_db=95.3 - 0.6), CARD_BASE)
    assert not ok
    ok, _ = compare(dict(CARD_BASE, headline_snr_db=95.3 * 0.92), CARD_BASE)
    assert not ok  # a relative 10 % band would have let 7.6 dB go


def test_card_baseline_is_armed():
    """The card's key bands the chip-adjusted share: an injected 20 % drop
    against the real file's value fails."""
    card = _baselines()[CARD_KEY]
    assert "headline_roofline_pct_chip_adjusted" in card
    cur = {"headline_roofline_pct_chip_adjusted":
           card["headline_roofline_pct_chip_adjusted"] * 0.8}
    ok, report = compare(cur, card)
    assert not ok, report


def test_headline_merge():
    cur = {"_backend": CARD_KEY}
    merge_headline(cur, {"value": 4.07e9, "roofline_pct": 53.8,
                         "snr_db": 95.3, "roofline_pct_chip_adjusted": 67.4})
    assert cur["headline_roofline_pct_chip_adjusted"] == 67.4
    assert cur["headline_snr_db"] == 95.3
    assert "headline_roofline_pct" not in cur  # the raw share stays unbanded


def test_armed_but_unmeasured_metric_is_reported():
    cur = {k: v for k, v in CARD_BASE.items()
           if k != "headline_roofline_pct_chip_adjusted"}
    ok, report = compare(cur, CARD_BASE)
    assert ok
    notes = [r for r in report
             if r.get("note") == "armed but not measured this run"]
    assert notes and notes[0]["metric"] == (
        "headline_roofline_pct_chip_adjusted")


# --- added ------------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.8, 0.94, 0.96, 1.0, 1.04, 1.06, 1.2,
                                   float("nan")])
def test_compare_equals_the_reference(scale):
    """The port's bands give the reference's verdict and report on the
    same data."""
    base = dict(BASE, **CARD_BASE, ola_n1024_h512_f375_us=50.0,
                kernel_normalize_n1024_ns_per_elem=0.5)
    cur = {k: v * scale for k, v in base.items()}
    del cur["ola_n1024_h512_f375_us"]
    assert compare(cur, base) == jreg.compare(cur, base)


@pytest.mark.parametrize("drop,status", [(0.95, "pass"), (0.8, "fail")])
def test_cli_chip_adjusted_verdict_on_a_card_backend(tmp_path, drop, status):
    """A card run carrying the main path's chip-adjusted share is banded
    and its verdict resolved from the check."""
    cur = dict(CARD_BASE, _backend=CARD_KEY,
               headline_roofline_pct_chip_adjusted=67.4 * drop)
    p, verdict = _cli(tmp_path, {CARD_KEY: CARD_BASE}, cur)
    assert p.returncode == (0 if status == "pass" else 1), p.stderr
    chip = verdict["chip_adjusted_verdict"]
    assert chip["status"] == status
    assert chip["check"]["metric"] == "headline_roofline_pct_chip_adjusted"


def test_cli_duty_probe_can_be_disabled(tmp_path, monkeypatch):
    cur = dict(BASE, _backend=CARD_KEY)
    monkeypatch.setenv("CRLOT_REGRESSION_DUTY", "0")
    p, verdict = _cli(tmp_path, {CARD_KEY: BASE}, cur)
    assert p.returncode == 0, p.stderr
    assert verdict["chip_adjusted_verdict"]["regime"].startswith(
        "probe disabled")


def test_update_baseline_writes_the_backend_key(tmp_path):
    (tmp_path / "baseline.json").write_text(json.dumps({"cpu": BASE}))
    cur = dict(BASE, _backend="cpu", e2e_1s48k_n1024_h256_ms=2.0)
    (tmp_path / "current.json").write_text(json.dumps(cur))
    p = subprocess.run(
        [sys.executable, "-m", "crlot_tpu_torch.bench.regression",
         "--baseline", str(tmp_path / "baseline.json"),
         "--current", str(tmp_path / "current.json"), "--update-baseline"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert p.returncode == 0, p.stderr
    saved = json.loads((tmp_path / "baseline.json").read_text())
    assert saved["cpu"]["e2e_1s48k_n1024_h256_ms"] == 2.0


def test_the_jax_package_baseline_holds_none_of_the_ports_keys():
    with open(REPO / "crlot_tpu" / "bench" / "baseline.json") as f:
        keys = set(json.load(f))
    assert keys == {"cpu", "tpu"}
