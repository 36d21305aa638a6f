#!/usr/bin/env python3
"""Drive the PyTorch port's STFT round-trip path once on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `crlot_tpu_torch/csrc/` (nvcc, sm_90a),
holds each kernel against its plain PyTorch version on the card, then runs
two paths through the public entry points on 2 channels x 60 s at 48 kHz,
N=1024 / H=256, Hann, seed 0, each with the kernels' launch counters reset
just before and read just after: the round-trip path (`round_trip`, `stft`,
`istft`; centered) and the fused-frames and sharded path
(`round_trip` with `fused_roundtrip`, `sharded_round_trip`).

Phases (each prints one line; the script exits 1 if any fails):
  1. B1 (fused OLA + normalize) vs plain on [2, 11251, 1024] frames:
     bit-exact (torch.equal).
  2. B2 (fused nonlinear round-trip + OLA) vs plain for noise_gate(-30),
     spectral_subtraction(noise_mag, 1.0, 0.05) and compose(band_gain,
     noise_gate), over the cropped signal span: max-abs <= 1e-5 and SNR
     between them >= 100 dB, and max-abs <= 1e-5 against the same plain
     version run on the host CPU. (Fp32 products may be summed in another
     order; the center padding divides by the near-zero edge norm, and
     every caller crops it.)
  3. round_trip identity ("blocked"): SNR vs input >= 60 dB.
  4. round_trip with a 3-band band_gain ("blocked"): the first 1 s against
     a float64 numpy STFT * g * iSTFT oracle, SNR >= 80 dB.
  5. istft(stft(x)): SNR >= 60 dB, B1 launched.
  6. round_trip with noise_gate(-30) ("fused_rt_ola"): SNR vs input >=
     60 dB, B2 launched.
  7. B3 (fused round-trip frames) vs plain for the identity and the three
     fns of phase 2, on the centered signal ([2, 11251, 1024] frames):
     max-abs <= 1e-5 against the plain version on the card and on the host
     CPU; prints whether the card's result is bit-identical.
  8. round_trip with cfg.fused_roundtrip ("fused_rt_frames"): SNR vs input
     >= 60 dB, B3 and B1 launched.
  9. sharded_round_trip with noise_gate(-30), center=False, T = 2879488
     (59.99 s: every time block a multiple of 2*hop), on a (channel=2,
     time=2) mesh whose four shards all sit on cuda:0: one B3 launch per
     shard, torch.equal to the (1, 1) mesh, and within max-abs 1e-5 of the
     one-shot round_trip (B2) over [N, T-N) (prints whether bit-identical).
 10. sharded identity (blocked route) on the same mesh and signal: blocked
     engaged, interior SNR vs input >= 60 dB, within rtol 3e-6 of the
     (1, 1) mesh with the first and last N-H samples exact, and the in-mesh
     metrics' SNR within 0.01 dB of the host's SNR of the gathered output.
Then CUDA-event timings (warm-up, median of 10): each kernel vs its plain
version, and end-to-end samples/s of phases 3, 6, 8 and 9 (phase 9 on both
meshes; the (2, 2) mesh runs its four shards one after another on one
card, so it is no scaling figure).

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Without CUDA, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SR = 48000
SECONDS = 60
NFFT, HOP = 1024, 256
SEED = 0
REPS = 10
T_SHARDED = 2_879_488  # 59.99 s; T / 2 is a multiple of 2 * HOP


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import crlot_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: crlot_tpu_torch not found beside the script: {e}",
              file=sys.stderr)
        return 2
    import numpy as np

    import crlot_tpu_torch as pt
    from crlot_tpu_torch import cuda_build, spectral
    from crlot_tpu_torch.core.padding import pad_signal
    from crlot_tpu_torch.fft import fused_rt as b2
    from crlot_tpu_torch.ola import fused as b1
    from crlot_tpu_torch.distributed import sharded_pipeline as spl
    from crlot_tpu_torch.pipeline import _norm_np, _window_f64

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    card = smi()
    log(f"nvidia-smi: {card}")
    log(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    cuda_build.load_library()
    log(f"kernel build: {cuda_build.build_seconds:.2f} s "
        f"({len(cuda_build.sources())} sources, nvcc)")
    kernel = "?"
    for line in cuda_build.build_log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"(\w+_kernel)", line)
            kernel = found.group(1) if found else line.strip()
        if "registers" in line or "spill" in line:
            log(f"  ptxas {kernel}: {line.strip()}")

    cfg = pt.StftConfig(frame_size=NFFT, hop_size=HOP, center=True)
    rng = np.random.default_rng(SEED)
    n = SR * SECONDS
    x_np = rng.uniform(-1.0, 1.0, (2, n)).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    spec_ = cfg.frame_spec
    pad = spec_.pad_amount
    n_frames = spec_.num_frames(n)
    full = (n_frames - 1) * HOP + NFFT
    norm = torch.from_numpy(_norm_np(cfg, n_frames, full).copy()).to(dev)
    w32 = torch.from_numpy(np.asarray(_window_f64(cfg), np.float32)).to(dev)
    padded = pad_signal(x, pad, pad, spec_.pad_mode).contiguous()
    noise_mag = np.full(NFFT // 2 + 1, 5.0, np.float32)
    band = spectral.band_gain([500.0, 4000.0], [0.5, 1.0, 0.25], SR, NFFT)
    fns = {
        "noise_gate(-30)": spectral.noise_gate(-30.0),
        "spectral_subtraction": spectral.spectral_subtraction(
            noise_mag, 1.0, 0.05),
        "compose(band_gain, noise_gate)": spectral.compose(
            spectral.band_gain([500.0, 4000.0], [0.5, 1.0, 0.25], SR, NFFT),
            spectral.noise_gate(-30.0)),
    }
    failures = []
    results = {}

    def phase(name, fn):
        try:
            msg = fn()
            sync()
            log(f"PASS {name}: {msg}")
        except Exception as e:  # report every phase, then exit non-zero
            failures.append(name)
            log(f"FAIL {name}: {type(e).__name__}: {e}")

    def check(cond, what):
        if not cond:
            raise AssertionError(what)

    def finite(t, shape):
        check(tuple(t.shape) == tuple(shape), f"shape {tuple(t.shape)}")
        check(bool(torch.isfinite(t).all()), "non-finite output")

    # 1. B1 vs plain.
    frames = torch.from_numpy(
        rng.standard_normal((2, n_frames, NFFT), dtype=np.float32)).to(dev)

    def p1():
        got = b1.ola_normalized_cuda(frames, norm, HOP, full, cfg.eps)
        sync()
        want = b1.ola_normalized_plain(frames, norm, HOP, full, cfg.eps)
        finite(got, (2, full))
        err = float((got - want).abs().max())
        results["b1_err"] = err
        check(torch.equal(got, want), f"not bit-exact, max-abs {err:.3g}")
        return f"bit-exact on [2, {n_frames}, {NFFT}], max-abs {err}"

    phase("1 B1 vs plain", p1)

    # 2. B2 vs plain.
    def p2():
        worst, lines = 0.0, []
        crop = slice(pad, pad + n)
        for name, fn in fns.items():
            got = b2.roundtrip_signal_cuda(
                padded, NFFT, HOP, n_frames, w32, norm, cfg.eps, full,
                fn.packed)
            sync()
            want = b2.roundtrip_signal_plain(
                padded, NFFT, HOP, n_frames, w32, norm, cfg.eps, full,
                fn.packed)
            finite(got[:, crop], (2, n))
            err = float((got[:, crop] - want[:, crop]).abs().max())
            snr = pt.snr_db(want[:, crop], got[:, crop])
            # The same plain version on the host CPU (other GEMM order): an
            # independent second reference.
            host = b2.roundtrip_signal_plain(
                padded.cpu(), NFFT, HOP, n_frames, w32.cpu(), norm.cpu(),
                cfg.eps, full, fn.packed)
            err_host = float((got[:, crop].cpu() - host[:, crop]).abs().max())
            lines.append(f"{name}: max-abs {err:.3e} snr {snr:.1f} dB "
                         f"(vs plain on the host CPU: max-abs {err_host:.3e})")
            worst = max(worst, err)
            check(err <= 1e-5 and snr >= 100.0 and err_host <= 1e-5,
                  lines[-1])
        results["b2_err"] = worst
        return "; ".join(lines)

    phase("2 B2 vs plain", p2)

    # Main path through the public entry points, counters reset just before.
    b1.launches = 0
    b2.launches = 0

    def p3():
        check(pt.formulation_for(cfg, None, n) == "blocked", "route")
        y = pt.round_trip(x, cfg)
        finite(y, (2, n))
        snr = pt.snr_db(x_np, y)
        check(snr >= 60.0, f"snr {snr:.2f} dB")
        return f"route blocked, snr {snr:.2f} dB"

    def p4():
        check(pt.formulation_for(cfg, band, n) == "blocked", "route")
        y = pt.round_trip(x, cfg, band)
        finite(y, (2, n))
        want = _oracle(x_np, band.per_bin_gains(NFFT), cfg)
        snr = min(pt.snr_db(want[c], y[c, :SR]) for c in range(2))
        check(snr >= 80.0, f"snr vs f64 oracle {snr:.2f} dB")
        return f"route blocked, first 1 s vs f64 oracle {snr:.2f} dB"

    def p5():
        before = b1.launches
        y = pt.istft(pt.stft(x, cfg), cfg, length=n)
        finite(y, (2, n))
        snr = pt.snr_db(x_np, y)
        check(snr >= 60.0, f"snr {snr:.2f} dB")
        check(b1.launches > before, "B1 not launched")
        return f"snr {snr:.2f} dB, B1 launches +{b1.launches - before}"

    def p6():
        gate = fns["noise_gate(-30)"]
        check(pt.formulation_for(cfg, gate, n) == "fused_rt_ola", "route")
        before = b2.launches
        y = pt.round_trip(x, cfg, gate)
        finite(y, (2, n))
        snr = pt.snr_db(x_np, y)
        check(snr >= 60.0, f"snr {snr:.2f} dB")
        check(b2.launches > before, "B2 not launched")
        return (f"route fused_rt_ola, snr {snr:.2f} dB, B2 launches "
                f"+{b2.launches - before}")

    phase("3 round_trip identity", p3)
    phase("4 round_trip band_gain", p4)
    phase("5 istft(stft)", p5)
    phase("6 round_trip noise_gate", p6)
    counts = {"b1": b1.launches, "b2": b2.launches}
    log(f"main-path launches: B1 {counts['b1']}, B2 {counts['b2']}")
    if counts["b1"] == 0 or counts["b2"] == 0:
        failures.append("launch counts")
        log("FAIL launch counts: a kernel of the path was not launched")

    # 7. B3 vs plain.
    frames_fns = {"identity": None, **fns}

    def p7():
        worst, lines = 0.0, []
        for name, fn in frames_fns.items():
            packed = fn.packed if fn is not None else None
            got = b2.roundtrip_frames_cuda(padded, NFFT, HOP, n_frames, w32,
                                           packed)
            sync()
            want = b2.roundtrip_frames_plain(padded, NFFT, HOP, n_frames,
                                             w32, packed)
            finite(got, (2, n_frames, NFFT))
            err = float((got - want).abs().max())
            host = b2.roundtrip_frames_plain(padded.cpu(), NFFT, HOP,
                                             n_frames, w32.cpu(), packed)
            err_host = float((got.cpu() - host).abs().max())
            lines.append(f"{name}: max-abs {err:.3e} (bit-identical "
                         f"{torch.equal(got, want)}; vs plain on the host "
                         f"CPU: max-abs {err_host:.3e})")
            worst = max(worst, err)
            check(err <= 1e-5 and err_host <= 1e-5, lines[-1])
        # A signal shorter than its frames' span: reads past its end are 0.
        short = padded[:, :5000].contiguous()
        got = b2.roundtrip_frames_cuda(short, NFFT, HOP, 30, w32, None)
        host = b2.roundtrip_frames_plain(short.cpu(), NFFT, HOP, 30,
                                         w32.cpu(), None)
        err = float((got.cpu() - host).abs().max())
        lines.append(f"short signal (30 frames over 5000 samples): max-abs "
                     f"{err:.3e} vs plain on the host CPU")
        check(err <= 1e-5, lines[-1])
        results["b3_err"] = worst
        return "; ".join(lines)

    phase("7 B3 vs plain", p7)

    # The fused-frames and sharded path, counters reset just before.
    cfg_frames = dataclasses.replace(cfg, fused_roundtrip=True)
    cfg_nc = pt.StftConfig(frame_size=NFFT, hop_size=HOP, center=False)
    x9 = x[:, :T_SHARDED].contiguous()
    x9_np = x_np[:, :T_SHARDED]
    mesh22 = pt.make_mesh(channel=2, time=2, devices=[dev] * 4)
    mesh11 = pt.make_mesh(channel=1, time=1, devices=[dev])
    inner = slice(NFFT, T_SHARDED - NFFT)
    edge = NFFT - HOP
    b1.launches = 0
    b2.launches = 0
    b2.frames_launches = 0

    def p8():
        check(pt.formulation_for(cfg_frames, None, n) == "fused_rt_frames",
              "route")
        b1_0, b3_0 = b1.launches, b2.frames_launches
        y = pt.round_trip(x, cfg_frames)
        finite(y, (2, n))
        snr = pt.snr_db(x_np, y)
        check(snr >= 60.0, f"snr {snr:.2f} dB")
        check(b2.frames_launches > b3_0 and b1.launches > b1_0,
              "B3 or B1 not launched")
        return (f"route fused_rt_frames, snr {snr:.2f} dB, B3 launches "
                f"+{b2.frames_launches - b3_0}, B1 +{b1.launches - b1_0}")

    def p9():
        gate = fns["noise_gate(-30)"]
        check(spl.shard_route(cfg_nc, gate) == "fused_rt_frames", "route")
        before = b2.frames_launches
        y = pt.sharded_round_trip(x9, cfg_nc, mesh22, gate)
        sync()
        launched = b2.frames_launches - before
        finite(y, (2, T_SHARDED))
        check(launched == 4, f"{launched} B3 launches for 4 shards")
        one = pt.sharded_round_trip(x9, cfg_nc, mesh11, gate)
        check(torch.equal(y, one), "(2, 2) mesh != (1, 1) mesh")
        check(pt.formulation_for(cfg_nc, gate, T_SHARDED) == "fused_rt_ola",
              "one-shot route")
        shot = pt.round_trip(x9, cfg_nc, gate)
        err = float((y[:, inner] - shot[:, inner]).abs().max())
        same = torch.equal(y[:, inner], shot[:, inner])
        results["sharded_b2_err"] = err
        check(err <= 1e-5, f"vs one-shot B2: max-abs {err:.3e}")
        return (f"B3 launches +{launched}; (2, 2) == (1, 1) bit for bit; "
                f"vs one-shot B2 over [N, T-N): max-abs {err:.3e}, "
                f"bit-identical {same}")

    def p10():
        calls = []
        orig = spl._blocked_local_round_trip

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        spl._blocked_local_round_trip = spy
        try:
            y, metrics = pt.sharded_round_trip(x9, cfg_nc, mesh22,
                                               return_metrics=True)
        finally:
            spl._blocked_local_round_trip = orig
        check(len(calls) == 2, f"blocked route engaged {len(calls)} times")
        finite(y, (2, T_SHARDED))
        one = pt.sharded_round_trip(x9, cfg_nc, mesh11)
        snr = pt.snr_db(x9_np[:, inner], y[:, inner])
        check(snr >= 60.0, f"interior snr {snr:.2f} dB")
        check(torch.allclose(y, one, rtol=3e-6, atol=1e-6),
              "(2, 2) mesh not within rtol 3e-6 of (1, 1)")
        check(torch.equal(y[:, :edge], one[:, :edge])
              and torch.equal(y[:, -edge:], one[:, -edge:]),
              "edges not exact")
        mesh_snr = pt.metrics_report(metrics)["snr_db"]
        host_snr = pt.snr_db(x9_np, y)
        check(abs(mesh_snr - host_snr) < 0.01,
              f"metrics snr {mesh_snr:.4f} vs host {host_snr:.4f}")
        return (f"blocked engaged; interior snr {snr:.2f} dB; (2, 2) vs "
                f"(1, 1) bit-identical {torch.equal(y, one)}; metrics snr "
                f"{mesh_snr:.4f} dB vs host {host_snr:.4f} dB")

    phase("8 round_trip fused_roundtrip", p8)
    phase("9 sharded noise_gate (B3)", p9)
    phase("10 sharded identity (blocked)", p10)
    counts2 = {"b1": b1.launches, "b3": b2.frames_launches}
    log(f"fused-frames and sharded path launches: B3 {counts2['b3']}, "
        f"B1 {counts2['b1']}")
    if counts2["b1"] == 0 or counts2["b3"] == 0:
        failures.append("launch counts (path 2)")
        log("FAIL launch counts: a kernel of the path was not launched")

    # Timings.
    def cuda_ms(fn):
        for _ in range(2):
            fn()
        sync()
        times = []
        for _ in range(REPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    def e2e_rate(fn, samples=2 * n):
        fn()
        sync()
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        return samples / statistics.median(times)

    gate = fns["noise_gate(-30)"]
    timing = {}
    try:
        timing["b1"] = cuda_ms(
            lambda: b1.ola_normalized_cuda(frames, norm, HOP, full, cfg.eps))
        timing["b1_plain"] = cuda_ms(
            lambda: b1.ola_normalized_plain(frames, norm, HOP, full, cfg.eps))
        timing["b2"] = cuda_ms(lambda: b2.roundtrip_signal_cuda(
            padded, NFFT, HOP, n_frames, w32, norm, cfg.eps, full,
            gate.packed))
        timing["b2_plain"] = cuda_ms(lambda: b2.roundtrip_signal_plain(
            padded, NFFT, HOP, n_frames, w32, norm, cfg.eps, full,
            gate.packed))
        timing["b3"] = cuda_ms(lambda: b2.roundtrip_frames_cuda(
            padded, NFFT, HOP, n_frames, w32, gate.packed))
        timing["b3_plain"] = cuda_ms(lambda: b2.roundtrip_frames_plain(
            padded, NFFT, HOP, n_frames, w32, gate.packed))
        timing["rt_identity"] = e2e_rate(lambda: pt.round_trip(x, cfg))
        timing["rt_gate"] = e2e_rate(lambda: pt.round_trip(x, cfg, gate))
        timing["rt_frames"] = e2e_rate(lambda: pt.round_trip(x, cfg_frames))
        for name, mesh in (("sharded_11", mesh11), ("sharded_22", mesh22)):
            timing[name] = e2e_rate(
                lambda: pt.sharded_round_trip(x9, cfg_nc, mesh, gate),
                2 * T_SHARDED)
        log(f"time B1 kernel {timing['b1']:.4f} ms, plain "
            f"{timing['b1_plain']:.4f} ms ([2, {n_frames}, {NFFT}] frames; "
            f"CUDA events, median of {REPS})")
        log(f"time B2 kernel {timing['b2']:.4f} ms, plain "
            f"{timing['b2_plain']:.4f} ms (noise_gate, 2 x {SECONDS} s; "
            f"CUDA events, median of {REPS})")
        log(f"time B3 kernel {timing['b3']:.4f} ms, plain "
            f"{timing['b3_plain']:.4f} ms (noise_gate, [2, {n_frames}, "
            f"{NFFT}] frames; CUDA events, median of {REPS})")
        log(f"e2e round_trip identity {timing['rt_identity']:.4e} samples/s; "
            f"noise_gate {timing['rt_gate']:.4e} samples/s; fused_roundtrip "
            f"{timing['rt_frames']:.4e} samples/s (host clock, "
            f"synchronized, median of {REPS})")
        log(f"e2e sharded noise_gate (B3 route), 2 x {T_SHARDED} samples: "
            f"(1, 1) mesh {timing['sharded_11']:.4e} samples/s; (2, 2) mesh "
            f"on one card, shards run in turn, {timing['sharded_22']:.4e} "
            f"samples/s (host clock, synchronized, median of {REPS})")
        log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    except Exception as e:
        failures.append("timings")
        log(f"FAIL timings: {type(e).__name__}: {e}")

    if failures:
        log(f"chip_smoke: {len(failures)} phase(s) failed: {failures}")
        return 1
    kernels = [
        {"name": "ola_normalized (B1)", "route": "cuda",
         "source": "crlot_tpu_torch/csrc/ola_fused.cu",
         "replaces": "crlot_tpu/ola/fused.py:39", "launches": counts["b1"],
         "max_abs_err": results["b1_err"], "ms": timing["b1"],
         "plain_ms": timing["b1_plain"]},
        {"name": "rt_ola (B2)", "route": "cuda",
         "source": "crlot_tpu_torch/csrc/fused_rt.cu",
         "replaces": "crlot_tpu/fft/pallas_rt.py:429",
         "launches": counts["b2"], "max_abs_err": results["b2_err"],
         "ms": timing["b2"], "plain_ms": timing["b2_plain"]},
        {"name": "rt_frames (B3)", "route": "cuda",
         "source": "crlot_tpu_torch/csrc/fused_rt.cu",
         "replaces": "crlot_tpu/fft/pallas_rt.py:277",
         "launches": counts2["b3"], "max_abs_err": results["b3_err"],
         "ms": timing["b3"], "plain_ms": timing["b3_plain"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _oracle(x_np, gains_f64, cfg):
    """float64 numpy STFT * g * iSTFT of the first second of each channel.
    Frames touching t < 1 s lie inside the first 1 s + N samples, so the
    prefix gives the full-signal values there exactly."""
    import numpy as np

    from crlot_tpu_torch.pipeline import _window_f64

    w = _window_f64(cfg)
    pad = NFFT // 2
    outs = []
    for c in range(x_np.shape[0]):
        xp = np.pad(x_np[c, : SR + 2 * NFFT].astype(np.float64), (pad, pad),
                    mode="reflect")  # numpy's reflect is reflect101
        f = (xp.size - NFFT) // HOP + 1
        idx = np.arange(f)[:, None] * HOP + np.arange(NFFT)[None, :]
        y_frames = np.fft.irfft(np.fft.rfft(xp[idx] * w, axis=-1) * gains_f64,
                                n=NFFT, axis=-1)
        acc = np.zeros(xp.size)
        nrm = np.zeros(xp.size)
        for i in range(f):
            acc[i * HOP : i * HOP + NFFT] += y_frames[i]
            nrm[i * HOP : i * HOP + NFFT] += w
        outs.append((acc / np.maximum(nrm, cfg.eps))[pad : pad + SR])
    return np.stack(outs)


if __name__ == "__main__":
    sys.exit(main())
