#!/usr/bin/env python3
"""Drive the PyTorch port's STFT round-trip path once on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `crlot_tpu_torch/csrc/` (nvcc, sm_90a),
holds each kernel against its plain PyTorch version on the card, then runs
the main path through the public entry points (`round_trip`, `stft`,
`istft`) on 2 channels x 60 s at 48 kHz, N=1024 / H=256, Hann, centered,
with the kernels' launch counters reset just before and read just after.

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
Then CUDA-event timings (warm-up, median of 10): each kernel vs its plain
version, and end-to-end samples/s of phases 3 and 6.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Without CUDA, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

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

    def e2e_rate(fn):
        fn()
        sync()
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        return 2 * n / statistics.median(times)

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
        timing["rt_identity"] = e2e_rate(lambda: pt.round_trip(x, cfg))
        timing["rt_gate"] = e2e_rate(lambda: pt.round_trip(x, cfg, gate))
        log(f"time B1 kernel {timing['b1']:.4f} ms, plain "
            f"{timing['b1_plain']:.4f} ms ([2, {n_frames}, {NFFT}] frames; "
            f"CUDA events, median of {REPS})")
        log(f"time B2 kernel {timing['b2']:.4f} ms, plain "
            f"{timing['b2_plain']:.4f} ms (noise_gate, 2 x {SECONDS} s; "
            f"CUDA events, median of {REPS})")
        log(f"e2e round_trip identity {timing['rt_identity']:.4e} samples/s; "
            f"noise_gate {timing['rt_gate']:.4e} samples/s (host clock, "
            f"synchronized, median of {REPS})")
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
