"""Find a cell's configuration, traffic mix, entry, metrics and limits by
name."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRAFFIC = HERE / "traffic"
LIMITS = HERE / "limits"
ENTRIES = HERE / "entries"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell `name` of `BENCHMARK.json` with its files read."""
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(ROOT / cfg_entry["file"]),
        traffic=load_json(TRAFFIC / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        limits=load_json(LIMITS / f"{name}.json"),
    )


def _module(path: Path, name: str):
    """The Python file at `path`, loaded as a module named `name` (not
    entered in `sys.modules`)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    """`entries/<name>.py`: what a cell whose traffic names the entry
    `name` runs and is checked against (the contract: the package's
    docstring)."""
    path = ENTRIES / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no entry {name!r}: {path} is not a file")
    return _module(path, "portbench_entry_" + name.replace(".", "_"))


def metric_reader(name: str):
    """`metrics/<name>.py`'s `read`: ctx -> a number, or None when the
    trace holds nothing for it."""
    path = HERE / "metrics" / f"{name}.py"
    return _module(path, "portbench_metric_" + name.replace(".", "_")).read
