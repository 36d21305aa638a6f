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
import math

import numpy as np
import pytest
import torch

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import crlot_tpu_torch as pt
from crlot_tpu_torch import pipeline, profiling, spectral
from crlot_tpu_torch.core.types import FftBackend, FftPrecision, StftConfig
from crlot_tpu_torch.distributed import halo, sharded_pipeline
from portbench import peaks, result, run, spec

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


# --- the resample chain's stream (BASELINE config 3) ------------------------

CHAIN = "rschain128.chain_stream"


class _Writes(TorchDispatchMode):
    """The bytes of every tensor an op writes into new storage, while not
    `paused`."""

    def __init__(self):
        super().__init__()
        self.bytes, self.paused = 0, False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            inputs = {t.untyped_storage().data_ptr()
                      for t in tree_flatten((args, kwargs))[0]
                      if isinstance(t, torch.Tensor)}
            for t in tree_flatten(out)[0]:
                if (isinstance(t, torch.Tensor)
                        and t.untyped_storage().data_ptr() not in inputs):
                    self.bytes += t.numel() * t.element_size()
        return out


def _chain_x(k: int, n: int, rows: int = 2) -> torch.Tensor:
    return _x(k, channels=rows, n=n) * 0.1


@pytest.mark.parametrize("backend", [FftBackend.AUTO, FftBackend.MATMUL])
def test_the_chain_feed_records_its_stages(monkeypatch, backend):
    """A feed is `crlot.resample_stream.feed` over `.plan`, a `.stage` a
    stage with its rate, lengths and tile, `.frames` and `.stft`; one
    resample launch a stage (on the CPU its plain version, counted here as
    the card counts B4); `glue_bytes` is every byte the feed's torch ops
    write, counted op by op, but the stages' outputs and the spectrum."""
    from crlot_tpu_torch.resample import kernel, polyphase

    cfg = StftConfig(frame_size=400, hop_size=160, fft_backend=backend)
    st = pt.ResampledStftStreamer((44100, 48000, 16000), cfg, 2,
                                  device="cpu")
    st.feed(_chain_x(0, 30_000))
    count = _Writes()
    impl = polyphase._resample_impl

    def launched(*a, **k):
        count.paused = True
        try:
            out = impl(*a, **k)
        finally:
            count.paused = False
        kernel.launches += 1
        return out

    monkeypatch.setattr(polyphase, "_resample_impl", launched)
    before = kernel.launches
    x = _chain_x(1, 44100)
    with _cpu_profile():
        with count:
            spec = st.feed(x)
    records = _last_call()
    entry = records[0]
    assert entry.name == "crlot.resample_stream.feed" and entry.parent is None
    assert entry.attrs["rows"] == 2 and entry.attrs["samples"] == 44100
    assert entry.attrs["frames"] == spec.shape[-2] == 100  # 441 * 100
    assert entry.attrs["launches"] == {"B4": 2}
    assert kernel.launches - before == 2
    names = [r.name for r in records[1:]]
    assert names == ["crlot.resample_stream." + s for s in
                     ("plan", "stage", "stage", "frames", "stft")]
    assert all(r.parent == entry.id for r in records[1:])
    stages = [r.attrs for r in records if r.name.endswith(".stage")]
    assert [(a["l"], a["m"], a["kind"]) for a in stages] == [
        (160, 147, "plain"), (1, 3, "plain")]
    assert stages[0]["in"] == 44100 and stages[0]["out"] == 48000
    assert stages[1]["in"] == 48000 and stages[1]["out"] == 16000
    assert entry.attrs["glue_bytes"] == count.bytes - (
        spec.numel() * spec.element_size())


def test_spans_leave_the_chain_alone():
    x = _chain_x(2, 60_000)

    def outs():
        st = pt.ResampledStftStreamer((44100, 48000, 16000), None, 2,
                                      device="cpu")
        return [st.feed(x[:, :25_000]), st.feed(x[:, 25_000:]), st.finish()]

    off = outs()
    with _cpu_profile():
        on = outs()
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert profiling.span_log()[-1].name.startswith(
        "crlot.resample_stream.")


def _chain_reader(name: str):
    return spec.metric_reader(name).__globals__


def _chain_ctx(summary):
    return {"cell": spec.cell(CHAIN), "summary": summary,
            "peaks": peaks.H100}


def test_b4s_count_at_the_cells_shapes():
    """The Kaiser length formula at 120 dB, rolloff 0.1 gives the port's
    filters: 24 975 taps over 160 phases at 160/147 (15 phases read 157,
    145 read 156: 156.09 an output on average) and 469 at 1/3; 128 x
    1 440 000 and 128 x 480 000 outputs a feed: 57.54 + 57.63 GFLOP at 67
    TFLOP/s, operations over bytes in both stages, about 1.719 ms a
    feed."""
    from crlot_tpu_torch.resample.polyphase import design_lowpass

    mod = _chain_reader("kernel.b4_roofline")
    for (l, m), longest in (((160, 147), 157), ((1, 3), 469)):
        h = design_lowpass(l, m)
        per_phase = [int(np.count_nonzero(h[p::l])) for p in range(l)]
        assert mod["filter_taps"](l, m, 120.0, 0.1) == len(h)
        assert mod["taps_per_output"](l, m, 120.0, 0.1) == pytest.approx(
            sum(per_phase) / l)
        assert max(per_phase) == longest
    assert mod["taps_per_output"](160, 147, 120.0, 0.1) == 24975 / 160
    cfg = spec.cell(CHAIN).config
    ops = 2 * 128 * (1_440_000 * 24975 / 160 + 480_000 * 469)
    assert mod["b4_feed"](cfg, peaks.H100) == pytest.approx(ops / 67e12)
    assert mod["b4_feed"](cfg, peaks.H100) == pytest.approx(1.719e-3,
                                                            rel=1e-3)


def test_b4_roofline_reads_b4s_launches():
    read = spec.metric_reader("kernel.b4_roofline")
    names = {"void runs_kernel<8, 2, 4>(...)": 0.006,
             "void runs_kernel<7, 2, 1>(...)": 0.004,
             "void blocks_kernel<2>(...)": 0.002,
             "ampere_sgemm_128x64_nn": 0.5}
    got = read(_chain_ctx({"steps": 4, "device_s_by_name": names}))
    assert got == pytest.approx(100.0 * 1.719001791e-3 / 0.003, rel=1e-6)
    assert read(_chain_ctx({"steps": 4, "device_s_by_name": {
        "ampere_sgemm_128x64_nn": 0.5}})) is None
    assert read(_chain_ctx(None)) is None


def test_b7s_count_at_the_cells_shapes():
    """3000 frames a feed (480 000 samples at 16 kHz over H 160): the
    bytes, the 16 kHz signal read (245.8 MB) and the complex64 spectrum
    written (617.5 MB), 0.258 ms at 3.35 TB/s, over a real FFT's 2.5 N
    log2 N flop a frame (3.32 GFLOP, 0.050 ms at 67 TFLOP/s)."""
    mod = _chain_reader("kernel.b7_roofline")
    cfg = spec.cell(CHAIN).config
    assert mod["frames_per_feed"](cfg) == 3000
    data = 4 * 128 * (480_000 + 2 * 3000 * 201)
    assert data == 863_232_000
    assert mod["b7_feed"](cfg, peaks.H100) == pytest.approx(data / 3.35e12)
    assert mod["b7_feed"](cfg, peaks.H100) == pytest.approx(0.2577e-3,
                                                            rel=1e-3)
    ops = 2.5 * 400 * math.log2(400) * 128 * 3000
    assert ops / 67e12 == pytest.approx(0.0496e-3, rel=1e-2)


def test_b7_roofline_reads_b7s_launches():
    """Only `stft_fp32_window_kernel` counts: B0's `fp32_window_kernel`
    and cuBLAS's SGEMMs do not."""
    read = spec.metric_reader("kernel.b7_roofline")
    names = {"(anonymous namespace)::stft_fp32_window_kernel(...)": 0.006,
             "(anonymous namespace)::fp32_window_kernel(...)": 0.2,
             "cutlass_80_simt_sgemm_128x128_8x4_nn_align1": 0.5}
    got = read(_chain_ctx({"steps": 4, "device_s_by_name": names}))
    data = 4 * 128 * (480_000 + 2 * 3000 * 201)
    assert got == pytest.approx(100.0 * data / 3.35e12 / 0.0015, rel=1e-9)
    assert read(_chain_ctx({"steps": 4, "device_s_by_name": {
        "(anonymous namespace)::fp32_window_kernel(...)": 0.2}})) is None
    assert read(_chain_ctx(None)) is None


def _chain_feed(call: int, base: int, glue=None) -> list:
    R = profiling.SpanRecord
    i = 10 * call
    attrs = {} if glue is None else {"glue_bytes": glue}
    return [R(call, i, None, "crlot.resample_stream.feed", base, base + 100,
              attrs),
            R(call, i + 1, i, "crlot.resample_stream.stage", base + 10,
              base + 90, {})]


def test_glue_gb_reads_the_stretchs_feeds():
    mod = _chain_reader("chain.glue_gb")
    log = (_chain_feed(0, 0, 9 * 10 ** 9) + _chain_feed(1, 1000, 4 * 10 ** 9)
           + _chain_feed(2, 2000, 5 * 10 ** 9))
    assert mod["glue_gb"](log, 2) == pytest.approx(4.5)
    assert mod["glue_gb"](log, 5) == pytest.approx(6.0)
    assert mod["glue_gb"](_chain_feed(0, 0) + _chain_feed(1, 1000), 2) is None
    assert mod["glue_gb"]([], 2) is None
    assert mod["read"](_chain_ctx(None)) is None


def test_the_chain_cell_loads_its_entry():
    cell = spec.cell(CHAIN)
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert cell.config["rates"] == [44100, 48000, 16000]
    entry = spec.entry(cell.traffic["entry"])
    for key in ("input_shape", "inputs", "Loop", "reference"):
        assert callable(getattr(entry, key))
    assert entry.input_shape(cell) == (128, 1_323_000)
    names = {m["name"] for m in cell.per_layer}
    assert {"kernel.b4_roofline", "kernel.b7_roofline", "chain.glue_gb",
            "entry.host_ms", "entry.plan_host_ms", "route.torch_device_ms",
            "device.idle_share"} == names


def test_a_traced_run_of_the_chain_cell_reads_its_glue():
    """The cell at a small size on the CPU, traced: correct, and
    `chain.glue_gb` reads what the feeds wrote; no B4 launch, so no
    roofline."""
    over = {"config": {"channels": 2, "chunk_samples_per_card": 44100},
            "traffic": {"ring": 3, "compare": 2, "warmup_calls": 3,
                        "trace_from": 2, "trace_calls": 3}}
    cell, (rec,) = run.run_cell(CHAIN, [2 ** 31 + 19], 0.3, True,
                                device_kind="cpu", overrides=over)
    line = result.line(cell, rec, True, kind="NVIDIA H100 80GB HBM3")
    assert line["correct"] is True, line["check"]
    glue = [r.attrs["glue_bytes"] for r in profiling.span_log()
            if r.name == "crlot.resample_stream.feed"][-3:]
    assert line["metrics"]["chain.glue_gb"]["value"] == pytest.approx(
        1e-9 * sum(glue) / 3)
    assert "kernel.b4_roofline" not in line["metrics"]
