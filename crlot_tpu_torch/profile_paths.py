"""Where the time goes: device time, end to end and idle share of the port's
main calls, and the demo's steps.

    python -m crlot_tpu_torch.profile_paths [--seconds 60] [--device cuda]

For each call, end to end is the median host-clock time of 5 synchronized
calls after 3 warm-ups; device time is the sum of the device-side events
(kernels, copies, fills) `torch.profiler` records over 5 more calls,
divided by 5; idle share = 1 - device / end to end. Below each call come
its device events by time per call, with their count per call. The demo
runs first, as a user's first call in a process would, then once more, each
run profiled whole, with each step timed on the host clock and synchronized
after it.

Inputs, made from seed 0: 2 channels x `--seconds` of uniform noise at
48 kHz (round-trip and sharded rows; N=1024, H=256, Hann, centered, the
sharded rows center=False on T rounded down to a multiple of 4*H; the
INT8X2 and tiled rows at H=480, 10 ms, where no blocked kernel applies; the
frames-level rows at N=960, H=240, the identity "folded" and a 3-band EQ
"composed", and the EQ "composed" on 128 clips of 1 200 samples from seed 1
at N=1024, H=256, each beside its stft -> istft) and at 44.1 kHz (resample
rows); the demo reads a 2-ch 44.1 kHz 16-bit WAV of a
997 Hz / 1 kHz sine pair plus noise, as `chip_smoke.py` phase 17 writes it.
The streaming rows run the reference bench's stream (`--stream-chunks`
device-resident chunks of 2 097 152 mono samples, uniform noise in +-0.9
from seed 9, N=1024, H=256, center=False) through `BlockedChunkStreamer`
and, as int16, through both tiers of `I16BlockedStreamer`. The config-5
rows stream `--config5-chunks` chunks of `--config5-channels` (default
128, BASELINE.json config 5's width) x 2^20 samples (uniform noise in
+-0.9 made on the device from seed 5) through `ShardedStreamer` on a (1,
1) mesh, identity (blocked, B0) and noise_gate (masked, B3). The
accumulator row pushes the first 5 s (at most `--seconds`) of the 48 kHz
signal through `Framer` (10 ms interleaved pushes) and `OLAAccumulator`
(N=1024, H=256, Hann inside, one produce a hop; its drain is K6).
The analysis rows run `sosfilt` (an 8th-order Butterworth, the log-depth
scan), `mel_spectrogram` + `pcen` and `griffin_lim` (32 iterations, on the
magnitude of the 48 kHz signal) at 2 x `--seconds`, and the first two on
the first config-5 chunk as well; `hpss` (kernels 31, two B1 launches),
`yin_f0`, `time_stretch` (rate 1.1) and `pitch_shift` (+3 semitones, B1
then B4) at 2 x `--seconds`; and `dtw` of two sequences of random 12-bin
features, one frame a 1024-sample hop of `--seconds` (2 813 frames each at
60 s: a chroma alignment at N = 4096, H = 1024), timed once after one
warm-up, its rows a Python loop of elementwise launches.
On a CPU device the device time is "not measured".
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

WARMUPS, CALLS = 3, 5
STREAM_CHUNK = 2_097_152
OLA_SECONDS = 5.0  # of the 48 kHz signal through the accumulator row


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _activities(dev: torch.device) -> list:
    """Device-side tracing only on a card; on the CPU something to trace."""
    act = torch.profiler.ProfilerActivity
    return [act.CUDA] if dev.type == "cuda" else [act.CPU]


def _device_events(prof) -> dict:
    """{name: [count, microseconds]} of the profile's device-side events."""
    rows = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            rows[e.name][0] += 1
            rows[e.name][1] += e.time_range.elapsed_us()
    return rows


def _report(name: str, e2e_s: float, rows: dict, runs: int, dev) -> str:
    lines = []
    if dev.type != "cuda" or not rows:
        lines.append(f"== {name}: end to end {e2e_s * 1e3:.4f} ms, device "
                     f"not measured")
    else:
        device_ms = sum(us for _, us in rows.values()) / runs / 1e3
        lines.append(f"== {name}: end to end {e2e_s * 1e3:.4f} ms, device "
                     f"{device_ms:.4f} ms, idle share "
                     f"{1 - device_ms / (e2e_s * 1e3):.3f}")
        for key, (count, us) in sorted(rows.items(), key=lambda r: -r[1][1]):
            lines.append(f"   {us / runs / 1e3:.4f} ms  x{count / runs:g}  "
                         f"{key[:120]}")
    return "\n".join(lines)


def profile_call(name: str, fn, dev: torch.device, calls: int = CALLS,
                 warmups: int = WARMUPS) -> str:
    for _ in range(warmups):
        fn()
    _sync(dev)
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    with torch.profiler.profile(activities=_activities(dev)) as prof:
        for _ in range(calls):
            fn()
        _sync(dev)
    return _report(name, statistics.median(times), _device_events(prof),
                   calls, dev)


def profile_demo(label: str, wav: str, out_dir: str, dev) -> str:
    """One profiled run of the demo, with each step's host-clock time."""
    from . import demo

    steps = {}
    names = ("_device_report", "_load_signal", "_peak_analysis", "_tone_write",
             "_resample_demo", "_round_trip_demo", "_kernel_demo")
    originals = {n: getattr(demo, n) for n in names}

    def timed(n, f):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = f(*a, **k)
            _sync(dev)
            steps[n.lstrip("_")] = time.perf_counter() - t0
            return out
        return run

    for n, f in originals.items():
        setattr(demo, n, timed(n, f))
    try:
        with torch.profiler.profile(activities=_activities(dev)) as prof:
            t0 = time.perf_counter()
            rc = demo.main([wav, "--out-dir", out_dir, "--device", str(dev)])
            _sync(dev)
            wall = time.perf_counter() - t0
    finally:
        for n, f in originals.items():
            setattr(demo, n, f)
    if rc != 0:
        raise RuntimeError(f"demo exit code {rc}")
    report = _report(f"demo ({label}, profiled)", wall, _device_events(prof),
                     1, dev).splitlines()[0]
    return (report + "\n   steps: " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in steps.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stream-chunks", type=int, default=13,
                    help=f"chunks of {STREAM_CHUNK} samples in the "
                    f"streaming rows (default 13, the bench's 9.47 min)")
    ap.add_argument("--config5-chunks", type=int, default=4,
                    help="chunks of 128 x 2^20 samples in the config-5 rows")
    ap.add_argument("--config5-channels", type=int, default=128)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: torch sees no CUDA card")

    import crlot_tpu_torch as pt
    from crlot_tpu_torch import cuda_build, spectral

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        cuda_build.load_library()
        print(f"device {torch.cuda.get_device_name(dev)}; torch "
              f"{torch.__version__}", flush=True)
    rng = np.random.default_rng(0)
    n48, n44 = int(48000 * args.seconds), int(44100 * args.seconds)
    x48 = torch.from_numpy(
        rng.uniform(-1, 1, (2, n48)).astype(np.float32)).to(dev)
    noise44 = rng.uniform(-1, 1, (2, n44)).astype(np.float32)
    x44 = torch.from_numpy(noise44).to(dev)

    with tempfile.TemporaryDirectory() as tmp:
        t = np.arange(n44) / 44100.0
        sines = 0.7 * np.sin(2 * np.pi * np.array([[997.0], [1000.0]]) * t)
        wav = os.path.join(tmp, "in.wav")
        pt.write_wav(wav, (0.5 * sines + 0.05 * noise44).astype(np.float32),
                     44100, bits=16)
        print(profile_demo("first run in the process", wav, tmp, dev),
              flush=True)
        print(profile_demo("second run", wav, tmp, dev), flush=True)

    cfg = pt.StftConfig(frame_size=1024, hop_size=256, center=True)
    cfg_frames = dataclasses.replace(cfg, fused_roundtrip=True)
    cfg_nc = pt.StftConfig(frame_size=1024, hop_size=256, center=False)
    cfg_i8 = pt.StftConfig(frame_size=1024, hop_size=480, center=True,
                           fft_precision=pt.FftPrecision.INT8X2)
    cfg_tiled = dataclasses.replace(cfg_i8, fft_precision=pt.FftPrecision.HIGH)
    gate = spectral.noise_gate(-30.0)
    t_sh = n48 // 1024 * 1024
    x_sh = x48[:, :t_sh].contiguous()
    mesh11 = pt.make_mesh(channel=1, time=1, devices=[dev])
    mesh22 = pt.make_mesh(channel=2, time=2, devices=[dev] * 4)
    calls = {
        "round_trip identity": lambda: pt.round_trip(x48, cfg),
        "round_trip noise_gate": lambda: pt.round_trip(x48, cfg, gate),
        "round_trip fused_roundtrip": lambda: pt.round_trip(x48, cfg_frames),
        "istft(stft(x))": lambda: pt.istft(pt.stft(x48, cfg), cfg,
                                           length=n48),
        "round_trip INT8X2 (tiled_i8), H 480": lambda: pt.round_trip(
            x48, cfg_i8),
        "round_trip HIGH (tiled), H 480": lambda: pt.round_trip(
            x48, cfg_tiled),
        "sharded noise_gate (1, 1)": lambda: pt.sharded_round_trip(
            x_sh, cfg_nc, mesh11, gate),
        "sharded noise_gate (2, 2) on one device": lambda: (
            pt.sharded_round_trip(x_sh, cfg_nc, mesh22, gate)),
        "sharded identity (1, 1)": lambda: pt.sharded_round_trip(
            x_sh, cfg_nc, mesh11),
        "sharded identity (2, 2) on one device": lambda: (
            pt.sharded_round_trip(x_sh, cfg_nc, mesh22)),
        "resample chain 44.1 -> 48 -> 16 kHz": lambda: pt.resample(
            pt.resample(x44, 44100, 48000), 48000, 16000),
        "resampled_stft 44.1 -> 48 kHz": lambda: pt.resampled_stft(
            x44, 44100, 48000, cfg_nc),
        "resample_chunked 44.1 -> 48 kHz, chunk 65536": lambda: (
            pt.resample_chunked(x44, 44100, 48000, chunk=65536)),
    }
    # The frames-level routes and the stft -> istft they replace: 20 ms / 5
    # ms frames (no blocked group, N % 256 != 0), and clips too short for
    # the blocked kernel.
    cfg_960 = pt.StftConfig(frame_size=960, hop_size=240, center=True)
    band_960 = spectral.band_gain([500.0, 4000.0], [0.5, 1.0, 0.25], 48000,
                                  960)
    band = spectral.band_gain([500.0, 4000.0], [0.5, 1.0, 0.25], 48000, 1024)
    clips = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (128, 1200)).astype(np.float32)).to(dev)

    def stft_istft(x, c, fn=None):
        spec = pt.stft(x, c)
        return pt.istft(spec if fn is None else fn(spec), c,
                        length=x.shape[-1])

    calls.update({
        "round_trip identity (folded), N 960 H 240": lambda: pt.round_trip(
            x48, cfg_960),
        "istft(stft(x)), N 960 H 240": lambda: stft_istft(x48, cfg_960),
        "round_trip band_gain (composed), N 960 H 240": lambda: (
            pt.round_trip(x48, cfg_960, band_960)),
        "istft(band_gain(stft(x))), N 960 H 240": lambda: stft_istft(
            x48, cfg_960, band_960),
    })
    clip_calls = {
        "round_trip band_gain (composed), 128 clips of 1200": lambda: (
            pt.round_trip(clips, cfg, band)),
        "istft(band_gain(stft(x))), 128 clips of 1200": lambda: stft_istft(
            clips, cfg, band),
    }
    sos8 = pt.butter_sos(8, 1000.0, "lowpass", fs=48000)
    cfg_gl = dataclasses.replace(cfg, synthesis_window=True)
    mag = pt.stft_magnitude(x48, cfg_gl)
    calls.update({
        "sosfilt butter_sos(8, 1 kHz) (the scan)": lambda: pt.sosfilt(
            sos8, x48),
        "mel_spectrogram + pcen": lambda: pt.pcen(
            pt.mel_spectrogram(x48, cfg, 48000), 48000 / 256),
        "griffin_lim, 32 iters": lambda: pt.griffin_lim(
            mag, cfg_gl, iters=32, length=n48),
        "hpss, kernels 31": lambda: pt.hpss(x48, cfg),
        "yin_f0": lambda: pt.yin_f0(x48, cfg, 48000.0),
        "time_stretch, rate 1.1": lambda: pt.time_stretch(x48, cfg, 1.1),
        "pitch_shift, +3 semitones": lambda: pt.pitch_shift(x48, cfg, 3.0),
    })
    for name, fn in calls.items():
        print(profile_call(f"{name}, 2 x {args.seconds:g} s", fn, dev),
              flush=True)
    for name, fn in clip_calls.items():
        print(profile_call(name, fn, dev), flush=True)
    del mag
    frames = int(48000 * args.seconds) // 1024 + 1  # N 4096, H 1024
    feats = torch.rand((2, frames, 12), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    print(profile_call(f"dtw, {frames} x {frames} frames of 12 features",
                       lambda: pt.dtw(feats[0], feats[1]), dev, calls=1,
                       warmups=1), flush=True)
    del feats

    total = args.stream_chunks * STREAM_CHUNK
    xs = torch.from_numpy(np.random.default_rng(9).uniform(
        -0.9, 0.9, total).astype(np.float32)).to(dev)
    x16 = torch.clamp(torch.round(xs * 32768.0), -32768, 32767).to(
        torch.int16)

    def stream(st, chunks):
        ys = [st.feed(c, force=False) for c in chunks]
        return ys + [st.finish(force=False)]

    streams = {
        "BlockedChunkStreamer (f32)": lambda: stream(
            pt.BlockedChunkStreamer(cfg_nc), xs.split(STREAM_CHUNK)),
        "I16BlockedStreamer int8x2": lambda: stream(
            pt.I16BlockedStreamer(cfg_nc, tier="int8x2"),
            x16.split(STREAM_CHUNK)),
        "I16BlockedStreamer int8x1": lambda: stream(
            pt.I16BlockedStreamer(cfg_nc, tier="int8x1"),
            x16.split(STREAM_CHUNK)),
    }
    for name, fn in streams.items():
        print(profile_call(f"{name}, {args.stream_chunks} x {STREAM_CHUNK} "
                           f"mono", fn, dev), flush=True)
    del xs, x16

    g = torch.Generator(device=dev).manual_seed(5)
    chunks5 = [torch.rand((args.config5_channels, 1 << 20), generator=g,
                          device=dev) * 1.8 - 0.9
               for _ in range(args.config5_chunks)]
    for name, fn in (("identity (blocked, B0)", None),
                     ("noise_gate (masked, B3)", gate)):
        print(profile_call(
            f"ShardedStreamer {name}, (1, 1), {args.config5_chunks} x "
            f"{args.config5_channels} ch x 2^20",
            lambda fn=fn: stream(pt.ShardedStreamer(cfg_nc, mesh11, fn),
                                 chunks5), dev), flush=True)
    wide = chunks5[0]
    print(profile_call(
        f"sosfilt butter_sos(8, 1 kHz), {args.config5_channels} ch x 2^20",
        lambda: pt.sosfilt(sos8, wide), dev), flush=True)
    print(profile_call(
        f"mel_spectrogram + pcen, {args.config5_channels} ch x 2^20",
        lambda: pt.pcen(pt.mel_spectrogram(wide, cfg, 48000), 48000 / 256),
        dev), flush=True)
    del chunks5, wide
    ola_s = min(OLA_SECONDS, args.seconds)
    print(profile_call(f"Framer + OLAAccumulator, 2 x {ola_s:g} s",
                       lambda: _ola_stream(x48, ola_s, dev), dev), flush=True)
    return 0


def _ola_stream(x48: torch.Tensor, seconds: float, dev: torch.device):
    """The first `seconds` of x48 pushed through a Framer in interleaved
    10 ms blocks, each frame into an OLAAccumulator at k*hop and one hop
    produced after it, then flushed and drained."""
    import crlot_tpu_torch as pt
    from crlot_tpu_torch.window.windows import get_window

    n, hop = 1024, 256
    cfg = pt.OLAConfig(sample_rate=48000, frame_size=n, hop_size=hop,
                       channels=2)
    fr = pt.Framer(n, hop, 2, device=dev)
    acc = pt.OLAAccumulator(cfg, device=dev)
    acc.set_window(get_window(pt.WindowType.HANN, n, periodic=True))
    aos = x48[:, : int(48000 * seconds)].t().contiguous().cpu().numpy()
    aos = aos.reshape(-1)
    k, outs = 0, []
    for i in range(0, aos.size, 960):
        fr.push(aos[i : i + 960])
        while (f := fr.pop()) is not None:
            acc.add_frame_soa(f, k * hop)
            outs.append(acc.produce(hop))
            k += 1
    acc.flush()
    outs.append(acc.produce(cfg.ring_len))
    return outs


if __name__ == "__main__":
    sys.exit(main())
