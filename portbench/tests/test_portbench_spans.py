"""entry.plan_host_ms and its .clip twin: the reader of the program's
plan spans, on synthetic logs and on a traced run on the CPU."""

import importlib.util

import pytest
import torch

from portbench import result, run, spec
from portbench.tests.test_portbench_run import KIND, SMALL

from crlot_tpu_torch import profiling

R = profiling.SpanRecord


def _reader_module():
    path = spec.HERE / "metrics" / "entry.plan_host_ms.py"
    s = importlib.util.spec_from_file_location("plan_host_ms", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def _call(call, base, plan_ns, consts_ns, child_ns):
    """An entry call: a plan span, a consts span holding a child span of
    `child_ns`, and a stage that is neither."""
    i = 10 * call
    return [R(call, i, None, "crlot.round_trip", base, base + 10**6, {}),
            R(call, i + 1, i, "crlot.round_trip.plan", base + 10,
              base + 10 + plan_ns, {}),
            R(call, i + 2, i, "crlot.blocked.consts", base + 20_000,
              base + 20_000 + consts_ns, {}),
            R(call, i + 3, i + 2, "crlot.inner", base + 20_001,
              base + 20_001 + child_ns, {}),
            R(call, i + 4, i, "crlot.blocked.b0", base + 50_000,
              base + 90_000, {})]


def test_the_reader_takes_the_last_calls_self_time():
    mod = _reader_module()
    log = (_call(0, 0, 999_000, 999_000, 0)  # before the stretch
           + _call(1, 10**7, 3_000, 5_000, 1_000)
           + _call(2, 2 * 10**7, 7_000, 2_000, 500))
    got = mod.plan_ms(log, 2, profiling.self_ns)
    assert got == pytest.approx(1e-6 * ((3_000 + 4_000) + (7_000 + 1_500))
                                / 2)
    assert mod.plan_ms(log, 5, profiling.self_ns) == pytest.approx(
        1e-6 * (1_998_000 + 7_000 + 8_500) / 3)
    assert mod.plan_ms([], 2, profiling.self_ns) is None


def test_untraced_reads_nothing():
    mod = _reader_module()
    assert mod.read({"summary": None}) is None


def test_every_per_layer_metric_has_a_reader():
    for m in spec.benchmark()["per_layer"]:
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file(), \
            m["name"]


def test_the_clip_reader_is_its_base():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            with profiling.span("crlot.round_trip"):
                with profiling.span("crlot.round_trip.plan"):
                    sum(range(1000))
    ctx = {"summary": {"steps": 3}}
    base = spec.metric_reader("entry.plan_host_ms")(ctx)
    assert base is not None and base > 0
    assert spec.metric_reader("entry.plan_host_ms.clip")(ctx) == base


@pytest.mark.parametrize("workload,name", [
    ("multich64.eq_resident", "entry.plan_host_ms"),
    ("main48k.denoise_resident", "entry.plan_host_ms.clip"),
])
def test_a_traced_run_reads_the_plan(workload, name):
    cell, (rec,) = run.run_cell(workload, [2**31 + 5], 0.3, True,
                                device_kind="cpu",
                                overrides=SMALL[workload])
    line = result.line(cell, rec, True, kind=KIND)
    assert line["metrics"][name]["value"] > 0
