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

At HIGH on the card the route runs on B2's kernels launched one by one
(`fused_rt.packed_engine`: the split path). Here: the engine each tier
and device takes, the launches and spans under a fake launch, the bytes
that path writes, and its plain version (3xTF32 as the kernels split it)
through `round_trip` against the float64 reference within the cell's
limits.
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
LIMITS = json.loads(
    (ROOT / "portbench/limits/large4096.gate_tracks.json").read_text())
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


def _split_spectrum(frames: torch.Tensor, n: int, window) -> tuple:
    """The spectrum of the split path's plain version: (Re, Im) [..., K]."""
    k, kp = n // 2 + 1, fused_rt.padded_bins(n)
    e, o = fused_rt.fold_plain(frames, torch.tensor(window))
    bases = fused_rt.kernel_bases_on(n, frames.device)
    re, im = fused_rt.packed_forward_plain(e.reshape(-1, kp),
                                           o.reshape(-1, kp), bases[:4])
    return (re[:, :k].reshape(frames.shape[:-1] + (k,)),
            im[:, :k].reshape(frames.shape[:-1] + (k,)))


def _kept(x: torch.Tensor, cfg, fn, spectrum=None) -> torch.Tensor:
    """[rows, samples] bool: the samples that no frame with a gate
    decision flipped by rounding overlap-adds into, on the spectrum of the
    fp32 route or of `spectrum(frames, N, window)`."""
    n, hop = cfg.frame_size, cfg.hop_size
    padded = stft64.reflect101(x, n // 2)
    frames = padded.unfold(-1, n, hop)
    re, im = (spectrum or mb.rfft_folded_packed)(frames, n,
                                                 pipeline._window_np(cfg))
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
                         "bins": nfft // 2 + 1, "engine": "matmul"}
    inv = next(r for r in records if r.name == "crlot.packed.inverse")
    assert inv.attrs == {"engine": "matmul"}
    assert torch.equal(on, pt.round_trip(x, cfg, fn))


class _FrameWrites(TorchDispatchMode):
    """The bytes of every float32 tensor with `rows` leading entries that
    an op writes (views of an op's inputs are not writes; with `copies`,
    the destination of an in-place copy is)."""

    def __init__(self, rows: int, copies: bool = False) -> None:
        super().__init__()
        self.rows, self.copies, self.bytes = rows, copies, 0

    def _frame_sized(self, t) -> bool:
        return (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                and t.dim() >= 2 and math.prod(t.shape[:-1]) == self.rows)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.copies and func is torch.ops.aten.copy_.default:
            if self._frame_sized(args[0]):
                self.bytes += args[0].numel() * 4
            return out
        inputs = {t.untyped_storage().data_ptr()
                  for t in tree_flatten((args, kwargs))[0]
                  if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if (self._frame_sized(t)
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


# --- the split path: B2's kernels at HIGH on the card -----------------------


@pytest.mark.parametrize("precision,device,engine", [
    (pt.FftPrecision.HIGH, "cuda", "rt_gemm"),
    (pt.FftPrecision.HIGH, "meta", "rt_gemm"),
    (pt.FftPrecision.INT8X2, "cuda:1", "rt_gemm"),
    (pt.FftPrecision.HIGHEST, "cuda", "matmul"),
    (pt.FftPrecision.HIGH, "cpu", "matmul"),
    (pt.FftPrecision.HIGHEST, "cpu", "matmul"),
])
def test_the_engine_follows_the_tier_and_the_device(precision, device,
                                                    engine):
    assert fused_rt.packed_engine(precision, torch.device(device)) == engine


@pytest.fixture
def fake_launch(monkeypatch):
    """Records the library function of every kernel launch, lets CPU and
    meta tensors through the device check, and zeroes the split path's
    and B1's launch counters."""
    from crlot_tpu_torch import cuda_build
    from crlot_tpu_torch.ola import fused

    calls = []
    monkeypatch.setattr(cuda_build, "launch",
                        lambda name, device, *a: calls.append(name))
    monkeypatch.setattr(cuda_build, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(fused_rt, "packed_launches",
                        dict.fromkeys(fused_rt.packed_launches, 0))
    monkeypatch.setattr(fused, "launches", 0)
    return calls


def _traced_call(x, cfg, fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pt.round_trip(x, cfg, fn)
    records = profiling.span_log()
    return [r for r in records if r.call == records[-1].call]


@pytest.mark.parametrize("nfft", FRAMES)
def test_high_off_the_cpu_launches_the_split_path(fake_launch, nfft):
    """One fold, one forward and one inverse launch a call, then B1; the
    spans name the engine and the counters agree with them."""
    _, cfg, fn = _route(nfft)
    records = _traced_call(torch.empty((ROWS, SAMPLES), device="meta"), cfg,
                           fn)
    assert fake_launch == ["crlot_rt_fold", "crlot_rt_forward",
                           "crlot_rt_inverse", "crlot_ola_normalized"]
    assert fused_rt.packed_launches == {"fold": 1, "forward": 1,
                                        "inverse": 1}
    by_name = {r.name: r for r in records}
    assert by_name["crlot.packed.forward"].attrs["engine"] == "rt_gemm"
    assert by_name["crlot.packed.inverse"].attrs == {"engine": "rt_gemm"}
    entry = records[0]
    assert entry.attrs["launches"]["B2_forward"] == 1
    assert entry.attrs["launches"]["B2_inverse"] == 1
    assert entry.attrs["frame_bytes"] == pipeline.packed_frame_bytes(
        cfg, ROWS, SAMPLES, "rt_gemm")
    assert [r.name for r in records[1:]] == [
        "crlot.round_trip.plan", "crlot.packed.consts", "crlot.packed.fold",
        "crlot.packed.forward", "crlot.packed.fn", "crlot.packed.inverse",
        "crlot.packed.ola", "crlot.round_trip.crop"]


@pytest.mark.parametrize("nfft", FRAMES)
def test_highest_keeps_the_fp32_matmuls(fake_launch, nfft):
    config, _, fn = _route(nfft)
    cfg = drive.port_config({**config, "precision": "highest"})
    assert cfg.fft_precision == pt.FftPrecision.HIGHEST
    records = _traced_call(torch.empty((ROWS, SAMPLES), device="meta"), cfg,
                           fn)
    assert fake_launch == ["crlot_ola_normalized"]
    assert set(fused_rt.packed_launches.values()) == {0}
    by_name = {r.name: r for r in records}
    assert by_name["crlot.packed.inverse"].attrs == {"engine": "matmul"}
    assert records[0].attrs["frame_bytes"] == pipeline.packed_frame_bytes(
        cfg, ROWS, SAMPLES)


def test_the_fn_sees_bin_views_and_the_inverse_zero_pads():
    """The fn gets [..., F, K] views of the forward's [rows, Kp] planes
    (row stride Kp); its outputs land in the first K columns of the fold's
    planes, whose pad columns stay zero whatever the pad columns of Re, Im
    hold."""
    nfft, c, f = 2048, 2, 5
    k, kp = nfft // 2 + 1, fused_rt.padded_bins(nfft)
    g = torch.Generator().manual_seed(3)
    padded = torch.randn((c, (f - 1) * (nfft // 4) + nfft), generator=g)
    w = torch.from_numpy(stft64.hann(nfft)).float()
    e, o = fused_rt.packed_fold_plain(padded, nfft, nfft // 4, f, w)
    assert e.shape == o.shape == (c * f, kp)
    assert not e[:, k:].any() and not o[:, k:].any()
    re, im = torch.randn((c * f, kp), generator=g), torch.randn(
        (c * f, kp), generator=g)
    re[:, k:] = im[:, k:] = float("nan")
    seen = []

    def fn(a, b):
        seen.append((a.shape, a.stride(), b.shape, b.stride()))
        return a * 2.0, b - 1.0

    e2, o2 = fused_rt.packed_spectral(fn, re, im, e, o, (c, f), nfft)
    assert seen == [((c, f, k), (f * kp, kp, 1), (c, f, k), (f * kp, kp, 1))]
    assert e2 is e and o2 is o
    assert torch.equal(e[:, :k], re[:, :k] * 2.0)
    assert torch.equal(o[:, :k], im[:, :k] - 1.0)
    assert not e[:, k:].any() and not o[:, k:].any()


def _split_engine(monkeypatch):
    """The split path's engine, "rt_gemm", for every tensor."""
    monkeypatch.setattr(fused_rt, "packed_engine",
                        lambda precision, device: "rt_gemm")


def _plain_split_path(monkeypatch):
    """`round_trip` on the CPU through the split path's plain versions in
    place of its three launches."""
    _split_engine(monkeypatch)
    monkeypatch.setattr(fused_rt, "packed_fold_cuda",
                        fused_rt.packed_fold_plain)
    monkeypatch.setattr(fused_rt, "packed_forward_cuda",
                        lambda e, o, nfft, bases:
                        fused_rt.packed_forward_plain(e, o, bases))
    monkeypatch.setattr(fused_rt, "packed_inverse_cuda",
                        fused_rt.packed_inverse_plain)


@pytest.mark.parametrize("nfft", FRAMES)
def test_the_plain_split_path_meets_the_cells_limits(monkeypatch, nfft):
    """The split path's plain version (3xTF32 as the kernels split it)
    against the float64 reference, over every sample, within the limits
    of `large4096.gate_tracks` (it read 1.7-4.3e-6 and 2.9-6.8e-6 over
    four seeds at each N, as the fp32 route does: most of it gate
    decisions flipped by rounding); and within this file's tolerances
    outside the frames whose decision its own spectrum flips (2.1-2.3e-7
    and 3.0-4.7e-7 over five seeds at each N, as the fp32 route reads)."""
    config, cfg, fn = _route(nfft)
    x = _tones()
    want = stft64.clip_round_trip(
        stft64.RoundTrip(config, MIX["spectral"], "cpu"), x, True)
    fp32 = pt.round_trip(x, cfg, fn)
    _plain_split_path(monkeypatch)
    records = _traced_call(x, cfg, fn)
    assert {r.name: r for r in records}[
        "crlot.packed.forward"].attrs["engine"] == "rt_gemm"
    got = pt.round_trip(x, cfg, fn)
    assert not torch.equal(got, fp32)  # another engine ran
    err = stft64.compare(got, want)
    assert err["err_rel"] <= LIMITS["err_rel"]["limit"], err
    assert err["peak_rel"] <= LIMITS["peak_rel"]["limit"], err
    keep = _kept(x, cfg, fn, _split_spectrum)
    assert float(keep.float().mean()) > 0.8
    near = stft64.compare(got[keep], want[keep])
    assert near["err_rel"] <= ERR_REL and near["peak_rel"] <= PEAK_REL, near


@pytest.mark.parametrize("nfft", FRAMES)
def test_the_plain_split_products_hold_the_kernels_bound(nfft):
    """Each plain product within tf32x3.REL_TOL of sum |a||b| of the
    float64 product of the same operands: the bound `chip_smoke.py` holds
    each launch to against this version."""
    from crlot_tpu_torch.fft import tf32x3

    g = torch.Generator().manual_seed(nfft)
    rows, kp = 64, fused_rt.padded_bins(nfft)
    bases = fused_rt.kernel_bases_on(nfft, torch.device("cpu"))
    e, o = fused_rt.packed_fold_plain(
        torch.randn((1, 63 * (nfft // 4) + nfft), generator=g), nfft,
        nfft // 4, rows, torch.from_numpy(stft64.hann(nfft)).float())
    re, im = fused_rt.packed_forward_plain(e, o, bases[:4])
    for a, (hi, lo), got in ((e, bases[0:2], re), (o, bases[2:4], im)):
        b = (hi.double() + lo.double()).T
        exact = a.double() @ b
        scale = a.double().abs() @ b.abs()
        assert float(((got - exact).abs() / scale.clamp_min(1e-30)).max()) \
            <= tf32x3.REL_TOL
    frames = fused_rt.packed_inverse_plain(re, im, nfft, bases[4:])
    assert frames.shape == (rows, nfft)
    h = nfft // 2
    ci, si = ((hi.double() + lo.double()).T
              for hi, lo in (bases[4:6], bases[6:8]))
    a, b = re.double() @ ci, im.double() @ si
    sa, sb = re.double().abs() @ ci.abs(), im.double().abs() @ si.abs()
    exact = torch.cat([a[:, : h + 1] + b[:, : h + 1],
                       (a[:, 1:h] - b[:, 1:h]).flip(-1)], -1)
    scale = torch.cat([sa[:, : h + 1] + sb[:, : h + 1],
                       (sa[:, 1:h] + sb[:, 1:h]).flip(-1)], -1)
    # Each sample adds two products, each within the bound, in f32.
    bound = tf32x3.REL_TOL * scale + 2.0 ** -24 * exact.abs()
    assert bool(((frames - exact).abs() <= bound).all())


@pytest.mark.parametrize("nfft", FRAMES)
@pytest.mark.parametrize("synthesis", [False, True])
def test_frame_bytes_counts_the_split_paths_writes(monkeypatch, fake_launch,
                                                   nfft, synthesis):
    """`packed_frame_bytes(..., "rt_gemm")` against the writes counted op
    by op under a fake launch on CPU tensors: the kernels' outputs (each
    allocated for the launch to fill), the fn's two planes and their
    copies into the fold's planes. B1 is launched too, so that the plain
    OLA's in-place adds are not counted."""
    from crlot_tpu_torch.ola import fused

    cfg = pt.StftConfig(frame_size=nfft, hop_size=nfft // 4, center=True,
                        synthesis_window=synthesis)

    def half(spec):
        return spec * 0.5

    half.packed = lambda re, im: (re * 0.5, im * 0.5)
    assert pipeline.formulation_for(cfg, half, SAMPLES) == "packed_parts"
    _split_engine(monkeypatch)
    monkeypatch.setattr(pipeline, "ola_normalized_auto",
                        fused.ola_normalized_cuda)
    frames = ROWS * cfg.frame_spec.num_frames(SAMPLES)
    count = _FrameWrites(frames, copies=True)
    with count:
        pt.round_trip(_tones(), cfg, half)
    assert fake_launch == ["crlot_rt_fold", "crlot_rt_forward",
                           "crlot_rt_inverse", "crlot_ola_normalized"]
    assert count.bytes == pipeline.packed_frame_bytes(cfg, ROWS, SAMPLES,
                                                      "rt_gemm")
