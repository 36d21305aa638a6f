"""The program's spans (`crlot_tpu_torch.profiling.span`) on the CPU.

Off (no profiler recording) a span opens no range and logs nothing; on,
each is a range of the trace with a record in
`span_log()` in the same tree, every route of `round_trip` and every
stage of the streamer and the sharded round-trip emits its spans, the
counters on the spans read the program's own counts, and the outputs are
the same bits either way. `idle_by_span` splits the card's idle time over
whole gaps.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import crlot_tpu_torch as pt
from crlot_tpu_torch import pipeline, profiling, spectral
from crlot_tpu_torch.core.types import FftBackend, FftPrecision, StftConfig
from crlot_tpu_torch.distributed import halo, sharded_pipeline

SR = 48000
N_SAMPLES = 8192


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _x(seed=0, channels=2, n=N_SAMPLES) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-0.9, 0.9, (channels, n))
                            .astype(np.float32))


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _band_gain(nfft):
    return spectral.band_gain([500, 4000], [0.5, 1.0, 0.25], SR, nfft)


def _without_menu(fn):
    def same(spec):
        return fn(spec)

    same.packed = lambda re, im: fn.packed(re, im)
    return same


# Each route of `formulation_for`: the config and spectral fn that take it.
ROUTES = {
    "fused_rt_frames": (dict(fused_roundtrip=True), lambda n: None),
    "blocked": ({}, _band_gain),
    "composed": (dict(hop_size=480), _band_gain),
    "tiled_i8": (dict(hop_size=480, fft_precision=FftPrecision.INT8X2),
                 lambda n: None),
    "tiled": (dict(hop_size=480), lambda n: None),
    "folded": (dict(frame_size=960, hop_size=240), lambda n: None),
    "fused_rt_ola": ({}, lambda n: spectral.noise_gate(-30.0)),
    "packed_parts": ({}, lambda n: _without_menu(spectral.noise_gate(-30.0))),
    "stft_istft": (dict(fft_backend=FftBackend.XLA), lambda n: None),
}

STAGES = {
    "blocked": ["crlot.blocked.pad", "crlot.blocked.consts",
                "crlot.blocked.b0", "crlot.blocked.edges",
                "crlot.blocked.join"],
    "fused_rt_ola": ["crlot.fused_rt.pad", "crlot.fused_rt.consts",
                     "crlot.fused_rt.consts", "crlot.fused_rt.kernels"],
    "packed_parts": ["crlot.packed.consts", "crlot.packed.fold",
                     "crlot.packed.forward", "crlot.packed.fn",
                     "crlot.packed.inverse", "crlot.packed.ola"],
}


def _route(name):
    kw, make_fn = ROUTES[name]
    cfg = StftConfig(**{"frame_size": 1024, "hop_size": 256,
                        "center": True, **kw})
    fn = make_fn(cfg.frame_size)
    assert pipeline.formulation_for(cfg, fn, N_SAMPLES) == name
    return cfg, fn


def _last_call(records=None):
    """The records of the last entry call in the log."""
    records = profiling.span_log() if records is None else records
    call = records[-1].call
    return [r for r in records if r.call == call]


def test_off_opens_no_range_and_logs_nothing(monkeypatch):
    def refused(name):
        raise AssertionError(f"a range opened with no profiler: {name}")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refused)
    before = profiling.span_log()
    for name in ROUTES:
        cfg, fn = _route(name)
        pt.round_trip(_x(), cfg, fn)
    st = pt.ShardedStreamer(StftConfig(frame_size=1024, hop_size=256),
                            pt.make_mesh(1, 1, devices=["cpu"]),
                            _band_gain(1024), device="cpu")
    for k in range(3):
        st.feed(_x(k, n=8192).numpy())
    st.finish()
    assert profiling.span_log() == before
    assert profiling.span("a", x=1) is profiling.span("b")


def test_log_tree_matches_the_trace():
    cfg, fn = _route("blocked")
    with _cpu_profile() as prof:
        pt.round_trip(_x(), cfg, fn)
    records = _last_call()
    assert len({r.call for r in records}) == 1
    by_id = {r.id: r for r in records}
    logged = [(r.name, by_id[r.parent].name if r.parent is not None
               else None) for r in records]

    def program_parent(e):
        e = e.cpu_parent
        while e is not None and not e.name.startswith(profiling.SPAN_PREFIX):
            e = e.cpu_parent
        return None if e is None else e.name

    ranges = sorted((e for e in prof.events()
                     if e.name.startswith(profiling.SPAN_PREFIX)),
                    key=lambda e: e.time_range.start)
    traced = [(e.name, program_parent(e)) for e in ranges]
    assert traced == logged
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            up = by_id[r.parent]
            assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns


@pytest.mark.parametrize("name", list(ROUTES))
def test_each_route_emits_its_spans(name):
    cfg, fn = _route(name)
    with _cpu_profile():
        pt.round_trip(_x(), cfg, fn)
    records = _last_call()
    entry = records[0]
    assert entry.name == "crlot.round_trip" and entry.parent is None
    assert entry.attrs["route"] == name
    assert entry.attrs["rows"] == 2 and entry.attrs["samples"] == N_SAMPLES
    assert entry.attrs["launches"] == {}  # no kernel runs on the CPU
    names = [r.name for r in records[1:]]
    assert names[0] == "crlot.round_trip.plan"
    assert names[-1] == "crlot.round_trip.crop"
    assert all(r.parent == entry.id for r in records[1:])
    assert names[1:-1] == STAGES.get(name, [])


@pytest.mark.parametrize("name", list(ROUTES))
def test_spans_leave_every_route_output_alone(name):
    cfg, fn = _route(name)
    x = _x(1)
    off = pt.round_trip(x, cfg, fn)
    with _cpu_profile():
        on = pt.round_trip(x, cfg, fn)
    assert torch.equal(off, on)


def test_feed_spans_patch_only_the_head_and_tail_chunks():
    cfg = StftConfig(frame_size=1024, hop_size=256)
    st = pt.ShardedStreamer(cfg, pt.make_mesh(1, 1, devices=["cpu"]),
                            _band_gain(1024), device="cpu")
    x = _x(2, channels=4, n=5 * 8192).numpy()
    with _cpu_profile():
        for k in range(5):
            st.feed(x[:, k * 8192:(k + 1) * 8192])
        st.finish()
    records = profiling.span_log()
    calls = [r for r in records if r.parent is None][-6:]
    assert [r.name for r in calls] == ["crlot.stream.feed"] * 5 + [
        "crlot.stream.finish"]
    for k, entry in enumerate(calls):
        assert entry.attrs["rows"] == 4 and entry.attrs["chunk"] == 8192
        assert entry.attrs["mode"] == "blocked"
        kids = [r for r in records
                if r.call == entry.call and r.parent == entry.id]
        names = [r.name for r in kids]
        if k == 0:  # buffered: the first chunk completes nothing
            assert names == ["crlot.stream.place"]
            continue
        assert names[-1] == "crlot.stream.slice"
        assert "crlot.stream.context" in names
        assert "crlot.sharded.round_trip" in names
        patches = [r.attrs["side"] for r in kids
                   if r.name == "crlot.stream.patch"]
        assert patches == (["head"] if k == 1 else ["tail"] if k == 5
                           else [])


@pytest.mark.parametrize("allow_blocked", [True, False])
def test_halo_span_bytes_are_the_counters(allow_blocked):
    cfg = StftConfig(frame_size=1024, hop_size=256)
    mesh = pt.make_mesh(1, 2, devices=["cpu"] * 2)
    x = _x(3, channels=2, n=2 * 4096)
    c = halo.counter
    before = (c.moved_bytes, c.received_bytes, c.cross_rank_ops)
    with _cpu_profile():
        pt.sharded_round_trip(x, cfg, mesh, _band_gain(1024),
                              allow_blocked=allow_blocked)
    after = (c.moved_bytes, c.received_bytes, c.cross_rank_ops)
    records = _last_call()
    assert records[0].name == "crlot.sharded.round_trip"
    assert records[0].attrs["route"] == ("blocked" if allow_blocked
                                         else "masked")
    spans = [r for r in records if r.name == "crlot.sharded.halo"]
    assert len(spans) == (1 if allow_blocked else 2)
    got = tuple(sum(r.attrs[k] for r in spans)
                for k in ("moved_bytes", "received_bytes", "cross_rank_ops"))
    assert got == tuple(a - b for a, b in zip(after, before))
    assert got[0] > 0
    names = [r.name for r in records if r.parent == records[0].id]
    assert names[0] == "crlot.sharded.plan"
    assert names[-1] == "crlot.sharded.join"
    assert names.count("crlot.sharded.block") == 1


# Each per-shard route of the masked formulation: the spectral fn that
# takes it at N 1024, H 256.
MASKED_ROUTES = {
    "fused_rt_frames": lambda n: spectral.noise_gate(-30.0),
    "composed": _band_gain,
    "packed_parts": lambda n: _without_menu(spectral.noise_gate(-30.0)),
    "stft_istft": lambda n: None,
}


@pytest.mark.parametrize("n_time", [1, 2])
@pytest.mark.parametrize("route", list(MASKED_ROUTES))
def test_the_masked_block_emits_its_stages(route, n_time):
    """Under `crlot.sharded.block`: the right halo's pull, then each
    shard's route, then `crlot.sharded.ola` (B1's seeded variant over the
    tails and, after the tail's push inside it, over the blocks with the
    divide) over each shard's frames that exist globally; the call's
    `frame_bytes` is one [rows, F, N] float32 tensor a shard, the
    route's frames."""
    cfg = StftConfig(frame_size=1024, hop_size=256)
    fn = MASKED_ROUTES[route](1024)
    assert sharded_pipeline.shard_route(cfg, fn) == route
    mesh = pt.make_mesh(1, n_time, devices=["cpu"] * n_time)
    x = _x(5, channels=2, n=2 * 4096)
    with _cpu_profile():
        pt.sharded_round_trip(x, cfg, mesh, fn, allow_blocked=False)
    records = _last_call()
    block = next(r for r in records if r.name == "crlot.sharded.block")
    kids = [r for r in records if r.parent == block.id]
    assert [r.name for r in kids] == (
        ["crlot.sharded.halo"]
        + ["crlot.sharded.frames"] * n_time
        + ["crlot.sharded.ola"])
    frames = x.shape[1] // n_time // cfg.hop_size
    for r in kids:
        if r.name == "crlot.sharded.frames":
            assert r.attrs == {"route": route, "frames": frames}
    ola = next(r for r in kids if r.name == "crlot.sharded.ola")
    # 8192 samples: frames start every 256 up to 8192 - 1024; a shard of
    # 4096 holds 16 starts, of which the last shard's final 3 overhang.
    valid = {1: ((0, 29),), 2: ((0, 16), (0, 13))}[n_time]
    assert ola.attrs == {"path": "plain", "frames": valid}
    assert [r.name for r in records if r.parent == ola.id] == [
        "crlot.sharded.halo"]
    assert records[0].attrs["frame_bytes"] == (
        n_time * 2 * frames * cfg.frame_size * 4)


def test_the_blocked_block_ends_with_the_divide():
    """The blocked route's row is B0's products, then the same divide;
    it writes no frames and records no `frame_bytes`."""
    cfg = StftConfig(frame_size=1024, hop_size=256)
    with _cpu_profile():
        pt.sharded_round_trip(_x(6, channels=2, n=2 * 4096), cfg,
                              pt.make_mesh(1, 1, devices=["cpu"]),
                              _band_gain(1024))
    records = _last_call()
    assert records[0].attrs["route"] == "blocked"
    assert "frame_bytes" not in records[0].attrs
    block = next(r for r in records if r.name == "crlot.sharded.block")
    assert [r.name for r in records if r.parent == block.id] == [
        "crlot.sharded.norm"]


def test_const_builds_counts_a_new_length_once():
    """The blocked route's constants are its plan's: the first call of a
    config builds them, and neither a repeat nor a new length (the plan
    serves every frame count) builds any."""
    _, fn = _route("blocked")
    cfg = StftConfig(frame_size=1024, hop_size=256, center=True, eps=3e-8)
    x = _x(4, n=N_SAMPLES + 31 * 256 + 7)
    with _cpu_profile():
        pt.round_trip(x, cfg, fn)
        first = _last_call()[0].attrs["const_builds"]
        pt.round_trip(x, cfg, fn)
        again = _last_call()[0].attrs["const_builds"]
        pt.round_trip(x[..., : N_SAMPLES + 5 * 256], cfg, fn)
        new_length = _last_call()[0].attrs["const_builds"]
    assert first > 0 and again == 0 and new_length == 0


def test_the_log_keeps_the_last_calls():
    with _cpu_profile():
        for k in range(profiling.LOG_CALLS + 40):
            with profiling.span("crlot.test.call", k=k):
                with profiling.span("crlot.test.inner"):
                    pass
    records = profiling.span_log()
    entries = [r for r in records if r.parent is None]
    assert len(entries) == profiling.LOG_CALLS
    assert [r.attrs["k"] for r in entries] == list(
        range(40, profiling.LOG_CALLS + 40))
    assert len(records) == 2 * profiling.LOG_CALLS


def test_self_time_leaves_out_the_children():
    rec = profiling.SpanRecord
    records = [rec(0, 1, None, "crlot.a", 0, 100, {}),
               rec(0, 2, 1, "crlot.a.plan", 10, 30, {}),
               rec(0, 3, 1, "crlot.a.b", 40, 90, {}),
               rec(0, 4, 3, "crlot.a.b.c", 50, 60, {})]
    assert profiling.self_ns(records) == {1: 30, 2: 20, 3: 40, 4: 10}


def test_idle_is_split_over_each_whole_gap():
    device = [("k1", 0.0, 10.0), ("k2", 50.0, 60.0), ("k3", 55.0, 70.0)]
    spans = [("crlot.call", 5.0, 80.0), ("crlot.call.plan", 20.0, 30.0),
             ("crlot.call.plan.inner", 22.0, 24.0)]
    got = profiling.idle_split(device, spans, 0.0, 100.0)
    want = {"crlot.call": (10 + 20 + 10) * 1e-6,
            "crlot.call.plan": 8 * 1e-6, "crlot.call.plan.inner": 2 * 1e-6,
            profiling.OUTSIDE: 20 * 1e-6}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12)
    assert profiling.idle_split(device, [], 0.0, 100.0) == {
        profiling.OUTSIDE: pytest.approx(70e-6)}


def test_idle_by_span_reads_a_profile():
    cfg, fn = _route("fused_rt_ola")
    with _cpu_profile() as prof:
        pt.round_trip(_x(), cfg, fn)
    got = profiling.idle_by_span(prof)
    assert "crlot.fused_rt.kernels" in got
    ends = [t for e in prof.events()
            for t in (e.time_range.start, e.time_range.end)]
    assert sum(got.values()) == pytest.approx((max(ends) - min(ends)) * 1e-6)


def test_the_chrome_trace_holds_the_stages(tmp_path):
    cfg, fn = _route("blocked")
    with profiling.trace(str(tmp_path)):
        pt.round_trip(_x(), cfg, fn)
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"crlot.round_trip", "crlot.blocked.b0"} <= names


def test_norm_cache_is_bounded_by_its_callers():
    cfg = StftConfig(frame_size=1024, hop_size=256, center=True)
    bound = pipeline._norm_on.cache_info().maxsize
    assert pipeline._norm_np.cache_info().maxsize == bound
    for k in range(20):
        pt.round_trip(_x(k, channels=1, n=4096 + 256 * k + 3), cfg,
                      spectral.noise_gate(-30.0))
    assert pipeline._norm_np.cache_info().currsize <= bound
