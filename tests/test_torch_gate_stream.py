"""noisereduce's chunked spectral gating on the CPU: the configuration and
traffic mix of the benchmark cell `nrstream128.gate_stream` (N 1024, hop
256, not centred, `noise_gate(-45, -80)` over the cell's tones) through
`ShardedStreamer` on a (1, 1) mesh, whose masked route runs B3's frames
(on the CPU its plain version), then B1's seeded variant (the seeded
overlap-add of the frames that exist globally, and the divide).

At 2 rows x 6 chunks of 8192 samples: the stream runs masked on the
"fused_rt_frames" route; the interior chunks meet the benchmark's plain
float64 reference (`portbench/reference/stft64.py`, plain PyTorch that
imports neither JAX nor the port) where the TF32 control does not; the
masked branch's stages are spans, in order, with their attributes, and
`frame_bytes` counts every frame-sized tensor the branch writes. Both
per-layer readers of the cell (`kernel.b3_roofline`, `stream.frame_gb`)
on hand-made summaries and span logs, and on a traced run of the cell.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import crlot_tpu_torch as pt
from crlot_tpu_torch import profiling
from crlot_tpu_torch.distributed import sharded_pipeline
from crlot_tpu_torch.distributed import stream as pst
from crlot_tpu_torch.fft import fused_rt
from crlot_tpu_torch.fft import matmul_backend as mb
from portbench import peaks, result, run, signals, spec, work
from portbench.reference import stft64

ROOT = Path(__file__).resolve().parent.parent
CELL = json.loads((ROOT / "portbench/configs/nrstream128.json").read_text())
MIX = json.loads((ROOT / "portbench/traffic/gate_stream.json").read_text())
WORKLOAD = "nrstream128.gate_stream"
SR = CELL["sample_rate"]
N, HOP = CELL["frame_size"], CELL["hop_size"]
ROWS, CHUNK, CHUNKS = 2, 8192, 6
CTX = 1024  # the streamer's context a side on a (1, 1) mesh: N
FRAMES = (CHUNK + 2 * CTX) // HOP  # B3's frames a feed
# An interior feed's frames that exist globally: those inside its
# context-extended chunk, start + N <= CHUNK + 2 * CTX.
VALID = (0, (CHUNK + 2 * CTX - N) // HOP + 1)
SEEDS = [2 ** 33 + 25, 2 ** 31 + 7, 11]

# Tolerances against the float64 reference, on the interior chunks'
# samples that no flipped bin reaches (below). The masked route's products
# on the CPU are IEEE fp32 sums of K = N/2 + 1 terms: the program read
# err_rel 1.95-1.98e-7 and peak_rel 3.06-3.84e-7 over the three seeds. The
# tolerances leave ten times that; the TF32 control (operands rounded to
# TF32, float32 sums) read 2.51-2.73e-4 and 3.77-4.59e-4, a hundred times
# above them.
ERR_REL = 2e-6
PEAK_REL = 4e-6
# A bin whose float32 power and float64 power lie on two sides of the
# gate's threshold is within rounding of it: the two versions may gate it
# differently, which moves its frame by up to |X| (1 - att) 2 / N, a
# hundred times the products' error (ROADMAP C12). Such frames are left
# out. One frame of 378 flipped over the three seeds (it alone reads
# err_rel 8.9e-6); more than 5 % would mean a wrong spectrum, not rounding.
MAX_LEFT_OUT = 0.05


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _route():
    from portbench import drive

    return drive.port_config(CELL), drive.port_spectral(MIX["spectral"], CELL)


def _ring(seed: int) -> list:
    """The stream: chunk k is ring[k], from the cell's signal generator."""
    return signals.ring(MIX["signal"], CHUNKS, ROWS, CHUNK, SR, seed, "cpu")


def _mesh():
    return pt.make_mesh(1, 1, devices=["cpu"])


def _stream(ring: list, cfg, fn) -> tuple:
    """Every chunk of the stream through the streamer: (the outputs, the
    streamer)."""
    st = pt.ShardedStreamer(cfg, _mesh(), fn, device="cpu")
    outs = [st.feed(c, force=False) for c in ring]
    outs.append(st.finish(force=False))
    return [o for o in outs if o is not None], st


def _kept(x: torch.Tensor, cfg) -> torch.Tensor:
    """[rows, samples] bool: the samples of the whole stream `x` that no
    frame with a gate decision flipped by rounding overlap-adds into, on
    the spectrum of B3's plain version."""
    frames = x.unfold(-1, N, HOP)
    re, im = mb.rfft_folded_packed(frames, N, pt.get_window(
        cfg.window, N, cfg.periodic))
    exact = torch.fft.rfft(frames.double() * torch.from_numpy(stft64.hann(N)),
                           dim=-1)
    thresh, _ = stft64.gate_levels(MIX["spectral"])
    flipped = (((exact.real ** 2 + exact.imag ** 2) >= thresh)
               != ((re * re + im * im) >= thresh)).any(-1)
    assert float(flipped.float().mean()) <= MAX_LEFT_OUT
    return ~fused_rt.frames_cover(flipped, HOP, N, x.shape[-1])


def _worst(outs: list, ring: list, rt, keep) -> dict:
    """The worst of each number over the interior chunks (1 .. CHUNKS-2:
    the head chunk holds the stream's start, the last its zero tail),
    each on its kept samples."""
    worst = {"err_rel": 0.0, "peak_rel": 0.0}
    for m in range(1, CHUNKS - 1):
        lo, hi = m * CHUNK, (m + 1) * CHUNK
        want = stft64.stream_round_trip(rt, ring, CHUNK, slice(None), lo, hi)
        k = keep[:, lo:hi]
        assert float(k.float().mean()) > 0.8
        for key, v in stft64.compare(outs[m][k], want[k]).items():
            worst[key] = max(worst[key], v)
    return worst


def test_the_gate_streams_masked_on_b3s_route():
    """At the cell's full shape and at the tests' small one: the gate has
    no fixed per-bin response, so the streamer runs the masked frame
    formulation, each shard on "fused_rt_frames" (B3 on the card)."""
    cfg, fn = _route()
    assert sharded_pipeline.shard_route(cfg, fn) == "fused_rt_frames"
    assert pst._blocked_stream_mode(cfg, _mesh(), fn,
                                    CELL["chunk_samples_per_card"]) is None
    _, st = _stream(_ring(SEEDS[0])[:3], cfg, fn)
    assert st.blocked is False


@pytest.mark.parametrize("seed", SEEDS)
def test_interior_chunks_meet_the_float64_reference(seed):
    cfg, fn = _route()
    ring = _ring(seed)
    outs, _ = _stream(ring, cfg, fn)
    rt = stft64.RoundTrip(CELL, MIX["spectral"], "cpu")
    keep = _kept(torch.cat(ring, dim=-1), cfg)
    got = _worst(outs, ring, rt, keep)
    assert 0.5 < rt.gated_bins / rt.bins < 0.95  # the gate does the work
    assert got["err_rel"] <= ERR_REL and got["peak_rel"] <= PEAK_REL, got


@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_control_fails_the_tolerances(seed):
    """The reference computed one precision below the configuration's
    (TF32 operands, float32 sums), in the program's place, is not within
    the tolerances."""
    cfg, _ = _route()
    ring = _ring(seed)
    ctl = stft64.RoundTrip(CELL, MIX["spectral"], "cpu", "tf32")
    outs = [None] + [stft64.stream_round_trip(
        ctl, ring, CHUNK, slice(None), m * CHUNK, (m + 1) * CHUNK)
        for m in range(1, CHUNKS - 1)]
    rt = stft64.RoundTrip(CELL, MIX["spectral"], "cpu")
    got = _worst(outs, ring, rt, _kept(torch.cat(ring, dim=-1), cfg))
    assert got["err_rel"] > ERR_REL or got["peak_rel"] > PEAK_REL, got
    assert got["err_rel"] > 10 * ERR_REL  # not by a hair


def _feed_records(ring: list, cfg, fn) -> list:
    """The span records of the feed that completes the stream's chunk 1."""
    st = pt.ShardedStreamer(cfg, _mesh(), fn, device="cpu")
    st.feed(ring[0], force=False)
    st.feed(ring[1], force=False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        st.feed(ring[2], force=False)
    records = profiling.span_log()
    return [r for r in records if r.call == records[-1].call]


def test_the_masked_branch_records_its_stages():
    cfg, fn = _route()
    records = _feed_records(_ring(SEEDS[0]), cfg, fn)
    by_name = {r.name: r for r in records}
    assert records[0].name == "crlot.stream.feed"
    assert records[0].attrs["mode"] == "masked"
    call = by_name["crlot.sharded.round_trip"]
    assert call.attrs["route"] == "masked"
    assert call.attrs["frame_bytes"] == ROWS * FRAMES * N * 4
    block = by_name["crlot.sharded.block"]
    assert block.parent == call.id
    kids = [r for r in records if r.parent == block.id]
    assert [r.name for r in kids] == [
        "crlot.sharded.halo", "crlot.sharded.frames", "crlot.sharded.ola"]
    attrs = {r.name: r.attrs for r in kids}
    assert attrs["crlot.sharded.frames"] == {"route": "fused_rt_frames",
                                             "frames": FRAMES}
    assert VALID == (0, 37)
    assert attrs["crlot.sharded.ola"] == {"path": "plain",
                                          "frames": (VALID,)}
    ola = by_name["crlot.sharded.ola"]
    assert [r.name for r in records if r.parent == ola.id] == [
        "crlot.sharded.halo"]  # the tail's exchange, between the launches
    for r in kids:
        assert block.start_ns <= r.start_ns <= r.end_ns <= block.end_ns
    assert [r.start_ns for r in kids] == sorted(r.start_ns for r in kids)


class _FrameWrites(TorchDispatchMode):
    """The bytes of every float32 tensor with `rows` leading entries that
    an op writes (views of an op's inputs, and in-place ops on them, are
    not new tensors), except while `paused`."""

    def __init__(self, rows: int) -> None:
        super().__init__()
        self.rows, self.bytes, self.paused = rows, 0, False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.paused:
            return out
        inputs = {t.untyped_storage().data_ptr()
                  for t in tree_flatten((args, kwargs))[0]
                  if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                    and t.dim() >= 2
                    and math.prod(t.shape[:-1]) == self.rows
                    and t.untyped_storage().data_ptr() not in inputs):
                self.bytes += t.numel() * t.element_size()
        return out


@pytest.mark.parametrize("synthesis", [False, True])
def test_frame_bytes_counts_every_frame_sized_write(monkeypatch, synthesis):
    """`frame_bytes` against the frame-sized writes of a feed counted op
    by op outside the per-shard route's own call (B3's, on the card one
    launch), plus that call's output: that output alone, since the seeded
    overlap-add reads the frames in place; with a synthesis window its
    product is one more."""
    cfg, fn = _route()
    if synthesis:
        cfg = dataclasses.replace(cfg, synthesis_window=True)
    ring = _ring(SEEDS[1])
    count = _FrameWrites(ROWS * FRAMES)
    route = sharded_pipeline._local_frames

    def counted(*a, **k):
        count.paused = True
        try:
            out = route(*a, **k)
        finally:
            count.paused = False
        count.bytes += out.numel() * out.element_size()
        return out

    st = pt.ShardedStreamer(cfg, _mesh(), fn, device="cpu")
    st.feed(ring[0], force=False)
    st.feed(ring[1], force=False)
    monkeypatch.setattr(sharded_pipeline, "_local_frames", counted)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with count:
            st.feed(ring[2], force=False)
    records = profiling.span_log()
    call = [r for r in records if r.call == records[-1].call
            and r.name == "crlot.sharded.round_trip"][0]
    per_tensor = ROWS * FRAMES * N * 4
    assert count.bytes == call.attrs["frame_bytes"]
    assert count.bytes == (2 if synthesis else 1) * per_tensor


@pytest.mark.parametrize("mesh_shape", [(1, 1), (1, 2), (2, 2)])
def test_spans_leave_the_masked_stream_alone(mesh_shape):
    """The masked stream's output is the same bits with the profiler on."""
    cfg, fn = _route()
    ring = _ring(SEEDS[2])
    mesh = pt.make_mesh(*mesh_shape, devices=["cpu"] * math.prod(mesh_shape))

    def outs():
        st = pt.ShardedStreamer(cfg, mesh, fn, device="cpu")
        got = [st.feed(c, force=False) for c in ring[:3]]
        return [o for o in got if o is not None]

    off = outs()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = outs()
    assert all(torch.equal(a, b) for a, b in zip(off, on))


# --- the cell's two per-layer readers ---------------------------------------


def _reader(name: str):
    path = spec.HERE / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def _ctx(summary):
    return {"cell": spec.cell(WORKLOAD), "summary": summary,
            "peaks": peaks.H100}


def test_b3s_count_at_the_cells_shapes():
    """128 channels x 2352 frames (600 064 + 2 x 1024 samples at hop 256)
    x N^2 MACs x 2 x 3 TF32 passes: 1.894e12 operations a step, 3.83 ms at
    495 TFLOP/s; operations, not bytes, set the bound."""
    mod = _reader("kernel.b3_roofline")
    w = mod.b3_stream_step(CELL, CELL["channels"],
                           CELL["chunk_samples_per_card"])
    assert w["ops"] == 2 * 3 * 128 * 2352 * 1024 ** 2
    assert w["ops"] == pytest.approx(1.894e12, rel=5e-4)
    assert w["bytes"] == 4 * 128 * (602112 + 2352 * 1024)
    bound, by = work.bound_s(w, peaks.H100)
    assert by == "ops" and bound == pytest.approx(3.83e-3, rel=1e-3)


def test_b3_roofline_reads_b3s_launches():
    mod = _reader("kernel.b3_roofline")
    names = {"void rt_fold_kernel<4>(...)": 0.004,
             "void rt_gemm_kernel<true>(...)": 0.008,
             "void rt_gemm_kernel<false>(...)": 0.008,
             "Memcpy DtoD (Device -> Device)": 0.5}
    got = mod.read(_ctx({"steps": 2, "device_s_by_name": names}))
    assert got == pytest.approx(100.0 * 1.894e12 / 495e12 / 0.010, rel=5e-4)
    assert mod.read(_ctx({"steps": 2, "device_s_by_name": {
        "Memcpy DtoD (Device -> Device)": 0.5}})) is None
    assert mod.read(_ctx(None)) is None


def _feed(call: int, base: int, frame_bytes=None) -> list:
    """A feed's records: the feed, its mesh program (with `frame_bytes`
    where given) and a stage of it."""
    R = profiling.SpanRecord
    i = 10 * call
    attrs = {} if frame_bytes is None else {"frame_bytes": frame_bytes}
    return [R(call, i, None, "crlot.stream.feed", base, base + 100, {}),
            R(call, i + 1, i, "crlot.sharded.round_trip", base + 10,
              base + 90, attrs),
            R(call, i + 2, i + 1, "crlot.sharded.block", base + 20,
              base + 80, {})]


def test_frame_gb_reads_the_stretchs_feeds():
    mod = _reader("stream.frame_gb")
    log = (_feed(0, 0, 9 * 10 ** 9)  # before the stretch
           + _feed(1, 1000, 2 * 10 ** 9) + _feed(2, 2000, 3 * 10 ** 9))
    assert mod.frame_gb(log, 2) == pytest.approx(2.5)
    assert mod.frame_gb(log, 5) == pytest.approx(14 / 3)
    assert mod.frame_gb(_feed(0, 0) + _feed(1, 1000), 2) is None
    assert mod.frame_gb([], 2) is None
    assert mod.read(_ctx(None)) is None


def test_a_traced_run_of_the_cell_reads_the_frame_traffic():
    """The cell at a small size on the CPU, traced: `stream.frame_gb` is
    the one frame-sized tensor of a feed, B3's frames; no B3 launch, so no
    roofline."""
    over = {"config": {"channels": ROWS, "chunk_samples_per_card": CHUNK},
            "traffic": {"ring": 3, "compare": 2, "warmup_calls": 3,
                        "trace_from": 2, "trace_calls": 3}}
    cell, (rec,) = run.run_cell(WORKLOAD, [2 ** 31 + 19], 0.3, True,
                                device_kind="cpu", overrides=over)
    line = result.line(cell, rec, True, kind="NVIDIA H100 80GB HBM3")
    assert line["correct"] is True, line["check"]
    assert line["metrics"]["stream.frame_gb"]["value"] == pytest.approx(
        ROWS * FRAMES * N * 4 * 1e-9)
    assert "kernel.b3_roofline" not in line["metrics"]
