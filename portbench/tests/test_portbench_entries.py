"""A cell's entry found by path (`spec.entry`): a new entry written to a
directory of its own runs as a cell on the CPU and is judged by its own
reference, and the two entries there are give the harness the rings,
shapes, loops and references it has always run."""

import json
import re

import pytest
import torch

from portbench import card, drive, result, run, signals, spec
from portbench.reference import stft64
from portbench.tests.test_portbench_run import CLIP, KIND, SMALL

STREAM = {"ring": 3, "compare": 2, "warmup_calls": 3, "trace_from": 2,
          "trace_calls": 3}
SIX = {
    **SMALL,
    "large4096.gate_tracks": {"config": {"channels": 2, "samples": 44100},
                              "traffic": CLIP},
    "nrstream128.gate_stream": {
        "config": {"channels": 2, "chunk_samples_per_card": 8192},
        "traffic": STREAM},
}
CONTRACT = ("input_shape", "inputs", "Loop", "reference")

# An entry that is in no file of the repository: its loop halves its
# input (and, with HALVE_ROWS, halves the first half of the rows again);
# its reference halves the input in float64, or float32 for the control.
ENTRY = '''
import torch

HALVE_ROWS = {halve_rows}


def input_shape(cell):
    return cell.config["channels"], cell.config["samples"]


def inputs(cell, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [torch.rand(input_shape(cell), generator=g, device=device)
            for _ in range(cell.traffic["ring"])]


class Loop:
    def __init__(self, cell, ring, device, mesh):
        self.ring = ring
        self.samples_per_step = ring[0].numel()

    def step(self, i):
        k = i % len(self.ring)
        out = self.ring[k] * 0.5
        if HALVE_ROWS:
            out[: out.shape[0] // 2] *= 0.5
        return out, k

    def pieces(self, kept):
        out, k = kept
        return [(out, lambda ref, x=self.ring[k]: ref.halve(x))]

    def free(self):
        pass


class Reference:
    def __init__(self, dtype):
        self.dtype = dtype

    def halve(self, x):
        return x.to(self.dtype) * 0.5


def reference(cell, device, precision):
    return Reference(torch.float64 if precision == "float64"
                     else torch.float32)
'''


def _small(workload: str):
    cell = spec.cell(workload)
    for part, over in SIX[workload].items():
        getattr(cell, part).update(over)
    return cell


def _new_cell(root, monkeypatch, halve_rows: bool) -> str:
    """The cell "tiny.halve" from files under `root` alone: its
    configuration, mix, limits and entry; the harness looks there."""
    files = {
        "configs/tiny.json": {"name": "tiny", "sample_rate": 8000,
                              "channels": 4, "samples": 1000},
        "traffic/halve.json": {"entry": "halve", "ring": 3, "compare": 3,
                               "warmup_calls": 2, "trace_from": 2,
                               "trace_calls": 2},
        "limits/tiny.halve.json": {"err_rel": {"limit": 1e-12},
                                   "peak_rel": {"limit": 1e-12}},
    }
    for name, body in files.items():
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        (root / name).write_text(json.dumps(body))
    (root / "entries").mkdir()
    (root / "entries" / "halve.py").write_text(
        ENTRY.format(halve_rows=halve_rows))
    bench = {
        "configs": [{"name": "tiny", "file": str(root / "configs/tiny.json")}],
        "workloads": [{"name": "tiny.halve", "config": "tiny",
                       "traffic": "halve", "chips": 1}],
        "end_to_end": [{"name": "samples_per_s", "unit": "samples/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [],
    }
    monkeypatch.setattr(spec, "benchmark", lambda: bench)
    monkeypatch.setattr(spec, "TRAFFIC", root / "traffic")
    monkeypatch.setattr(spec, "LIMITS", root / "limits")
    monkeypatch.setattr(spec, "ENTRIES", root / "entries")
    return "tiny.halve"


@pytest.mark.parametrize("halve_rows", [False, True])
def test_a_new_entry_runs_as_a_cell(halve_rows, tmp_path, monkeypatch):
    """Sound, the new entry's cell reads correct; with its output halved
    on half its rows, not."""
    workload = _new_cell(tmp_path, monkeypatch, halve_rows)
    cell, (rec,) = run.run_cell(workload, [2**31 + 19], 0.2, False,
                                device_kind="cpu", control=True)
    line = result.line(cell, rec, False, kind=KIND)
    assert line["correct"] is (not halve_rows), line["check"]
    assert rec["check"]["pieces"] == 3 and "gated_share" not in rec["check"]
    assert set(rec["check"]["control"]) == {"err_rel", "peak_rel"}
    assert set(line["metrics"]) == {"samples_per_s", "setup_s"}


def test_an_unknown_entry_names_the_path_it_looked_for(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(spec, "ENTRIES", tmp_path)
    with pytest.raises(FileNotFoundError,
                       match=re.escape(str(tmp_path / "nowhere.py"))):
        spec.entry("nowhere")


@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()
                                  ["workloads"]])
def test_every_cell_finds_its_entry(name):
    entry = spec.entry(spec.cell(name).traffic["entry"])
    assert all(callable(getattr(entry, key)) for key in CONTRACT)


@pytest.mark.parametrize("workload", list(SIX))
def test_an_entry_gives_what_the_harness_gave(workload):
    """The ring, the shape and the references are those the harness made
    itself before entries were modules; the loop is the drive's."""
    cell = _small(workload)
    c, t = cell.config, cell.traffic
    entry = spec.entry(t["entry"])
    shape = ((c["channels"], c["samples"]) if t["entry"] == "round_trip"
             else (c["channels"], c["chunk_samples_per_card"]))
    assert entry.input_shape(cell) == shape
    seed = 2**33 + 5
    ring = entry.inputs(cell, seed, "cpu")
    want = signals.ring(t["signal"], int(t["ring"]), *shape,
                        c["sample_rate"], seed, "cpu")
    assert len(ring) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(ring, want))
    device = torch.device("cpu")
    loop = entry.Loop(cell, ring, device, card._mesh(cell, device))
    assert type(loop) is {"round_trip": drive.ClipLoop,
                          "stream": drive.StreamLoop}[t["entry"]]
    warm = int(t["warmup_calls"])  # as the run warms up: no head chunk
    for i in range(warm):
        loop.step(i)
    kept = [loop.step(warm + i) for i in range(2)]
    assert all(done >= 0 for _, done in kept)
    for precision in ("float64", "tf32"):
        ref = entry.reference(cell, "cpu", precision)
        direct = stft64.RoundTrip(c, t["spectral"], "cpu", precision)
        for item in kept:
            for _, make_ref in loop.pieces(item):
                assert torch.equal(make_ref(ref), make_ref(direct))
        assert (ref.bins, ref.gated_bins) == (direct.bins, direct.gated_bins)
    loop.free()


def test_the_drives_names_still_import():
    from portbench.drive import (ClipLoop, StreamLoop, port_config,  # noqa
                                 port_spectral)
