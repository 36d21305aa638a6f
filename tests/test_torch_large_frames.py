"""The nonlinear gate at large frames on the CPU: BASELINE config 2's
frames (N 2048 and 4096 at hop N/4, the configuration and traffic mix of
the benchmark cell `large4096.gate_tracks`), through `round_trip`'s
"packed_parts" route (folded forward products, `noise_gate.packed`,
folded inverse products, the OLA).

At 2 rows x 3 s of seeded tones at 44.1 kHz: the route is the one the
cell's full shape takes; the output meets the benchmark's plain float64
reference (`portbench/reference/stft64.py`, plain PyTorch that imports
neither JAX nor the port) where the TF32 control does not; the route's
stages are spans, in order, with their attributes, and `frame_bytes`
counts every frame-sized float32 tensor the route writes.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import crlot_tpu_torch as pt
from crlot_tpu_torch import pipeline, profiling
from crlot_tpu_torch.fft import fused_rt
from crlot_tpu_torch.fft import matmul_backend as mb
from portbench import drive, signals
from portbench.reference import stft64

ROOT = Path(__file__).resolve().parent.parent
CELL = json.loads((ROOT / "portbench/configs/large4096.json").read_text())
MIX = json.loads((ROOT / "portbench/traffic/gate_tracks.json").read_text())
SR = CELL["sample_rate"]
ROWS, SAMPLES = 2, 3 * SR
SEED = 2 ** 33 + 21
FRAMES = [2048, 4096]

# Tolerances against the float64 reference, on the samples no flipped bin
# reaches (below). The route's products are IEEE fp32 sums of K = N/2 + 1
# terms: the program read err_rel 2.0-2.3e-7 and peak_rel 2.9-5.7e-7 over
# five seeds at each N. The limits leave ten times that; the TF32 control
# (operands rounded to TF32, float32 sums) read 2.3-2.4e-4 and 3.3-6.6e-4,
# a hundred times above them.
ERR_REL = 2e-6
PEAK_REL = 4e-6
# A bin whose float32 power and float64 power lie on two sides of the
# gate's threshold is within rounding of it: the two versions may gate it
# differently, which moves its frame by up to |X| (1 - att) 2 / N, a
# hundred times the products' error (ROADMAP C12). Such frames are left
# out. At most 2.3 % of the frames flipped over five seeds at each N; more
# than 5 % would mean a wrong spectrum, not rounding.
MAX_LEFT_OUT = 0.05


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _config(nfft: int) -> dict:
    return {**CELL, "frame_size": nfft, "hop_size": nfft // 4}


def _route(nfft: int):
    config = _config(nfft)
    return (config, drive.port_config(config),
            drive.port_spectral(MIX["spectral"], config))


def _tones(seed: int = SEED) -> torch.Tensor:
    g = torch.Generator()
    g.manual_seed(seed)
    return signals.make(MIX["signal"], ROWS, SAMPLES, SR, g, "cpu")


def _kept(x: torch.Tensor, cfg, fn) -> torch.Tensor:
    """[rows, samples] bool: the samples that no frame with a gate
    decision flipped by rounding overlap-adds into."""
    n, hop = cfg.frame_size, cfg.hop_size
    padded = stft64.reflect101(x, n // 2)
    frames = padded.unfold(-1, n, hop)
    re, im = mb.rfft_folded_packed(frames, n, pipeline._window_np(cfg))
    exact = torch.fft.rfft(frames.double() * torch.from_numpy(stft64.hann(n)),
                           dim=-1)
    thresh, _ = stft64.gate_levels(MIX["spectral"])
    flipped = (((exact.real ** 2 + exact.imag ** 2) >= thresh)
               != ((re * re + im * im) >= thresh)).any(-1)
    assert float(flipped.float().mean()) <= MAX_LEFT_OUT
    cover = fused_rt.frames_cover(flipped, hop, n, padded.shape[-1])
    return ~cover[..., n // 2 : n // 2 + x.shape[-1]]


@pytest.mark.parametrize("nfft", FRAMES)
def test_the_gate_takes_packed_parts(nfft):
    """At the cell's full shape and at the tests' small one, no other
    route takes the gate: B2 keeps the reference's N <= 1024, and a gate
    has no fixed per-bin response for the blocked or composed routes."""
    config, cfg, fn = _route(nfft)
    assert not fused_rt.fused_rt_supported(nfft, nfft // 4)
    for samples in (config["samples"], SAMPLES):
        assert pipeline.formulation_for(cfg, fn, samples) == "packed_parts"


@pytest.mark.parametrize("nfft", FRAMES)
def test_round_trip_meets_the_float64_reference(nfft):
    config, cfg, fn = _route(nfft)
    x = _tones()
    ref = stft64.RoundTrip(config, MIX["spectral"], "cpu")
    want = stft64.clip_round_trip(ref, x, config["center"])
    assert 0.5 < ref.gated_bins / ref.bins < 0.95  # the gate does the work
    keep = _kept(x, cfg, fn)
    assert float(keep.float().mean()) > 0.8
    got = stft64.compare(pt.round_trip(x, cfg, fn)[keep], want[keep])
    assert got["err_rel"] <= ERR_REL and got["peak_rel"] <= PEAK_REL, got


@pytest.mark.parametrize("nfft", FRAMES)
def test_the_tf32_control_fails_the_tolerances(nfft):
    """The reference computed one precision below the configuration's
    (TF32 operands, float32 sums) is not within the tolerances."""
    config, cfg, fn = _route(nfft)
    x = _tones()
    want = stft64.clip_round_trip(
        stft64.RoundTrip(config, MIX["spectral"], "cpu"), x, True)
    ctl = stft64.clip_round_trip(
        stft64.RoundTrip(config, MIX["spectral"], "cpu", "tf32"), x, True)
    keep = _kept(x, cfg, fn)
    got = stft64.compare(ctl[keep], want[keep])
    assert got["err_rel"] > ERR_REL or got["peak_rel"] > PEAK_REL, got
    assert got["err_rel"] > 10 * ERR_REL  # not by a hair


@pytest.mark.parametrize("nfft", FRAMES)
def test_the_route_records_its_stages(nfft):
    _, cfg, fn = _route(nfft)
    x = _tones()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = pt.round_trip(x, cfg, fn)
    records = profiling.span_log()
    records = [r for r in records if r.call == records[-1].call]
    entry = records[0]
    assert entry.name == "crlot.round_trip"
    assert entry.attrs["route"] == "packed_parts"
    assert entry.attrs["frame_bytes"] == pipeline.packed_frame_bytes(
        cfg, ROWS, SAMPLES)
    assert [r.name for r in records[1:]] == [
        "crlot.round_trip.plan", "crlot.packed.consts", "crlot.packed.fold",
        "crlot.packed.forward", "crlot.packed.fn", "crlot.packed.inverse",
        "crlot.packed.ola", "crlot.round_trip.crop"]
    assert all(r.parent == entry.id for r in records[1:])
    fwd = next(r for r in records if r.name == "crlot.packed.forward")
    assert fwd.attrs == {"frames": ROWS * cfg.frame_spec.num_frames(SAMPLES),
                         "bins": nfft // 2 + 1}
    assert torch.equal(on, pt.round_trip(x, cfg, fn))


class _FrameWrites(TorchDispatchMode):
    """The bytes of every float32 tensor with `rows` leading entries that
    an op writes (views of an op's inputs are not writes)."""

    def __init__(self, rows: int) -> None:
        super().__init__()
        self.rows, self.bytes = rows, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage().data_ptr()
                  for t in tree_flatten((args, kwargs))[0]
                  if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                    and t.dim() >= 2
                    and math.prod(t.shape[:-1]) == self.rows
                    and t.untyped_storage().data_ptr() not in inputs):
                self.bytes += t.numel() * 4
        return out


@pytest.mark.parametrize("nfft", FRAMES)
@pytest.mark.parametrize("synthesis", [False, True])
def test_frame_bytes_counts_every_frame_sized_write(nfft, synthesis):
    """`packed_frame_bytes` against the writes counted op by op, with a
    spectral fn that writes just its two output planes."""
    cfg = pt.StftConfig(frame_size=nfft, hop_size=nfft // 4, center=True,
                        synthesis_window=synthesis)

    def half(spec):
        return spec * 0.5

    half.packed = lambda re, im: (re * 0.5, im * 0.5)
    assert pipeline.formulation_for(cfg, half, SAMPLES) == "packed_parts"
    frames = ROWS * cfg.frame_spec.num_frames(SAMPLES)
    count = _FrameWrites(frames)
    with count:
        pt.round_trip(_tones(), cfg, half)
    assert count.bytes == pipeline.packed_frame_bytes(cfg, ROWS, SAMPLES)
