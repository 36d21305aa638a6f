"""Whole runs on the CPU at small sizes, with the harness's look for a
card skipped: the result line keeps its fixed keys, nothing of JAX
or the JAX package is loaded, and the check catches the control and each
fault a cell can have."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import result, run, spec
from portbench.reference import stft64
from portbench.tests import faults

ROOT = str(spec.ROOT)
CLIP = {"ring": 2, "compare": 2, "warmup_calls": 2, "trace_from": 2,
        "trace_calls": 3}
SMALL = {
    "main48k.denoise_resident": {"config": {"samples": 24000},
                                 "traffic": CLIP},
    "multich64.eq_resident": {"config": {"channels": 4, "samples": 24000},
                              "traffic": CLIP},
    "multich64.denoise_resident": {"config": {"channels": 4,
                                              "samples": 24000},
                                   "traffic": CLIP},
    "config5.stream_1card": {
        "config": {"channels": 4, "chunk_samples_per_card": 8192},
        "traffic": {"ring": 3, "compare": 2, "warmup_calls": 3,
                    "trace_from": 2, "trace_calls": 3}},
}
KIND = "NVIDIA H100 80GB HBM3"


def _run(workload, traced=False, seed=2**31 + 11):
    cell, (rec,) = run.run_cell(workload, [seed], 0.3, traced,
                                device_kind="cpu",
                                overrides=SMALL[workload])
    return result.line(cell, rec, traced, kind=KIND)


@pytest.mark.parametrize("workload", list(SMALL))
def test_line_keeps_its_keys(workload):
    line = _run(workload)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "setup_build_s", "check"]
    assert line["correct"] is True and line["attempted"] >= 1
    cell = spec.cell(workload)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for name, v in line["check"].items():
        assert v["value"] <= v["limit"], name
    json.dumps(line)


def test_traced_line_has_busy_and_window():
    line = _run("multich64.eq_resident", traced=True)
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert list(line)[-1] == "check"
    assert line["metrics"]["entry.host_ms"]["value"] > 0


@pytest.mark.parametrize("workload", list(SMALL))
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_planted_fault_is_not_correct(workload, fault, monkeypatch):
    faults.plant(fault, spec.cell(workload).traffic["entry"],
                 monkeypatch.setattr)
    line = _run(workload)
    assert line["correct"] is False, line["check"]


@pytest.mark.parametrize("workload", list(SMALL))
def test_the_control_is_not_correct(workload, monkeypatch):
    """The reference in TF32 in the program's place fails the limits."""
    cell = spec.cell(workload)
    for part, over in SMALL[workload].items():
        getattr(cell, part).update(over)
    ctl = stft64.RoundTrip(cell.config, cell.traffic["spectral"], "cpu",
                           "tf32")
    if cell.traffic["entry"] == "round_trip":
        from crlot_tpu_torch import pipeline

        monkeypatch.setattr(pipeline, "round_trip", lambda x, *a, **k:
                            stft64.clip_round_trip(ctl, x, True).float())
    else:
        from crlot_tpu_torch.distributed import sharded_pipeline

        def tf32_blocks(xs, norms, window, cfg, total_len, *a, **k):
            whole = torch.cat(xs, dim=-1)
            out = ctl.segment(whole).float()
            pad = whole.shape[-1] - out.shape[-1]
            out = torch.nn.functional.pad(out, (0, pad))
            return list(out.split(xs[0].shape[-1], dim=-1)), None

        monkeypatch.setattr(sharded_pipeline, "_block_round_trip",
                            tf32_blocks)
    line = _run(workload)
    assert line["correct"] is False, line["check"]


def test_no_jax_is_loaded():
    """Import every module of the harness and run a cell in a fresh
    process: no module named jax, jaxlib, flax or crlot_tpu (by the whole
    top-level name) is loaded."""
    code = (
        "import importlib, pkgutil, sys, portbench\n"
        "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "from portbench import run\n"
        f"run.run_cell('multich64.eq_resident', [3], 0.2, True, 'cpu', "
        f"{SMALL['multich64.eq_resident']!r})\n"
        "print(run.forbidden_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    found, loaded = (eval(s) for s in out.stdout.strip().splitlines()[-2:])
    assert found == []
    assert "crlot_tpu_torch" in loaded and "crlot_tpu" not in loaded


def test_without_a_card_there_is_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "multich64.eq_resident", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "multich64.eq_resident", "--seed", "5", "--seconds", "2",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert 0 < line["metrics"]["kernel.b0_roofline"]["value"] < 105


def test_a_grouped_metric_is_its_base():
    """samples_per_s.clip is samples_per_s, in the cells it lists."""
    cell, (rec,) = run.run_cell("main48k.denoise_resident", [7], 0.2, False,
                                device_kind="cpu",
                                overrides=SMALL["main48k.denoise_resident"])
    line = result.line(cell, rec, False, kind=KIND)
    e2e = result.end_to_end(rec)
    assert set(line["metrics"]) == {"samples_per_s.clip",
                                    "latency_p95_ms.clip", "setup_s"}
    assert line["metrics"]["samples_per_s.clip"]["value"] == \
        e2e["samples_per_s"]


def test_the_run_keeps_to_one_core():
    code = ("import os, portbench.run as r\n"
            "core = r.pin()\n"
            "print(core, sorted(os.sched_getaffinity(0)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    core, cores = out.stdout.split(" ", 1)
    assert cores.strip() == ("[%s]" % core if core != "None"
                             else cores.strip())
