"""Demo / integration showcase, on torch: the reference main() rebuilt.

Counterpart of `crlot_tpu/demo.py` (reference: main/main.cc:68-427). The
same steps, on one explicit device: device report, WAV read, FFT peak
analysis (top-10 table), tone WAV write, streaming 44.1k -> 48k resample
(B4 on a card), STFT round-trip, and the OLA kernel tier (B5 on a card).
With no WAV given it synthesizes 2 s of A440 + harmonics, the reference's
fallback. Run:

    python -m crlot_tpu_torch [input.wav] [--out-dir DIR] [--device cuda|cpu]

`--device cuda` (the default) with no card raises; nothing falls back to
the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch sees no CUDA card")
    return dev


def _device_report(dev: torch.device) -> None:
    # cpu_features CPU report analog (main.cc:69-96): torch/CUDA facts.
    from .ola.kernels import kernel_dispatch_info

    print("== device report ==")
    for k, v in kernel_dispatch_info().items():
        print(f"  {k}: {v}")
    print(f"  running on: {dev}")


def _load_signal(path: str | None):
    from .io.wav import read_wav

    if path is not None:
        data, sr = read_wav(path)
        print(f"== input == {path}: {data.shape[0]} ch, "
              f"{data.shape[1]} frames @ {sr} Hz")
        return data, sr
    print("== input == (no wav given; synthesizing 2 s A440 + harmonics)")
    sr = 44100
    t = np.arange(sr * 2) / sr
    x = sum(a * np.sin(2 * np.pi * f * 440 * t)
            for f, a in [(1, 0.5), (2, 0.25), (3, 0.12)])
    return np.asarray([x], dtype=np.float32), sr


def _peak_analysis(mono: np.ndarray, sr: int, dev: torch.device) -> None:
    # FFT-size pick + Hann + rFFT + top-10 peak table (main.cc:136-208).
    from .core.types import WindowType
    from .fft.dispatch import rfft
    from .window.windows import get_window

    n = 4096
    while n > len(mono):
        n //= 2
    seg = mono[:n] * get_window(WindowType.HANN, n, periodic=True)
    mag = torch.abs(rfft(torch.from_numpy(seg).to(dev), n)).cpu().numpy()
    top = np.argsort(mag)[::-1][:10]
    print(f"== spectrum == N={n}, top-10 peaks:")
    print(f"  {'bin':>6} {'freq (Hz)':>10} {'mag (dB)':>9}")
    ref = mag.max() or 1.0
    for k in top:
        print(f"  {k:>6} {k * sr / n:>10.1f} {20 * np.log10(max(mag[k], 1e-12) / ref):>9.1f}")


def _tone_write(out_dir: str, sr: int) -> None:
    # 440 Hz tone WAV write (main.cc:212-236).
    from .io.wav import write_wav

    t = np.arange(sr) / sr
    tone = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    path = os.path.join(out_dir, "tone440.wav")
    write_wav(path, tone, sr, bits=16)
    print(f"== tone == wrote {path}")


def _resample_demo(mono: np.ndarray, sr: int, out_dir: str,
                   dev: torch.device) -> None:
    # Streaming resample demo (r8brain chunk loop analog, main.cc:238-352).
    from .io.wav import write_wav
    from .resample.polyphase import output_length, resample_chunked

    target = 48000 if sr != 48000 else 44100
    t0 = time.time()
    y = resample_chunked(mono, sr, target, chunk=65536, device=dev)
    dt = time.time() - t0
    if len(y) != output_length(len(mono), sr, target):
        raise RuntimeError(f"resampled length {len(y)}")
    path = os.path.join(out_dir, f"resampled_{target}.wav")
    write_wav(path, y, target, bits=16)
    print(f"== resample == {sr} -> {target} Hz: {len(mono)} -> {len(y)} "
          f"samples in {dt * 1e3:.1f} ms; wrote {path}")


def _round_trip_demo(mono: np.ndarray, sr: int, dev: torch.device) -> None:
    from .core.types import StftConfig
    from .metrics import snr_db
    from .pipeline import round_trip

    cfg = StftConfig(frame_size=1024, hop_size=256, center=True)
    t0 = time.time()
    y = round_trip(torch.from_numpy(mono).to(dev), cfg).cpu().numpy()
    dt = time.time() - t0
    print(f"== round-trip == N=1024 H=256: SNR {snr_db(mono, y):.1f} dB, "
          f"{len(mono) / dt / 1e6:.1f} Msamples/s (incl. host transfers)")


def _kernel_demo(dev: torch.device) -> None:
    # Highway ScalePcmData SIMD demo analog (main.cc:354-383), then the
    # rest of the tier: accumulate once more and drain the ring.
    from .ola.kernels import axpy, axpy_windowed, normalize_and_clear

    x = torch.linspace(-1, 1, 8, dtype=torch.float32).to(dev)
    w = torch.full((8,), 0.5, dtype=torch.float32, device=dev)
    acc = axpy_windowed(torch.zeros(8, device=dev), x, w, 2.0)
    print("== kernel == axpy_windowed(0, x, 0.5w, gain=2):",
          acc.cpu().numpy())
    out, cleared = normalize_and_clear(
        axpy(acc, x, 1.0), torch.full((8,), 2.0, device=dev))
    print("== kernel == normalize_and_clear(axpy(that, x), norm=2):",
          out.cpu().numpy(), "ring cleared:", bool((cleared == 0).all()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("wav", nargs="?", default=None)
    ap.add_argument("--out-dir",
                    default=os.path.join(tempfile.gettempdir(), "crlot_demo"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; no fallback)")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    _device_report(dev)
    data, sr = _load_signal(args.wav)
    mono = data.mean(axis=0).astype(np.float32)  # mixdown (main.cc:150-166)
    _peak_analysis(mono, sr, dev)
    _tone_write(args.out_dir, sr)
    _resample_demo(mono, sr, args.out_dir, dev)
    _round_trip_demo(mono, sr, dev)
    _kernel_demo(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
