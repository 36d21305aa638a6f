"""Example: FIR filtering a WAV through the composed round-trip.

A fixed FIR filter's frequency response (magnitude and phase) composes
with the DFT bases into one hop-block product on the host, so the whole
frame -> spectrum -> filter -> frame chain is one kernel launch (B0 on the
card) over the signal.

Usage: python -m crlot_tpu_torch.examples.fir_filter in.wav out.wav
           [--cutoff-hz 4000] [--device cuda|cpu]
"""

import argparse

import numpy as np

import crlot_tpu_torch as pt


def lowpass_taps(cutoff_hz: float, sr: float, num_taps: int = 127):
    """Windowed-sinc lowpass, designed in float64 (linear phase)."""
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2
    fc = cutoff_hz / sr
    h = 2 * fc * np.sinc(2 * fc * n)
    h *= np.hamming(num_taps)
    return h / h.sum()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--cutoff-hz", type=float, default=4000.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    x, sr = pt.read_wav(args.infile)
    cfg = pt.StftConfig(frame_size=1024, hop_size=256, center=True)
    taps = lowpass_taps(args.cutoff_hz, sr)
    resp = pt.spectral.fir_frequency_response(taps, cfg.frame_size)
    filt = pt.spectral.per_bin_filter(resp)  # a fixed response: composes
    y = pt.round_trip(x, cfg, filt, device=args.device).cpu().numpy()
    pt.write_wav(args.outfile, y, sr, bits=16)
    print(f"{args.infile} -> {args.outfile}: lowpass {args.cutoff_hz:.0f} Hz "
          f"({len(taps)} taps, {pt.formulation_for(cfg, filt, x.shape[-1])} "
          f"route)")


if __name__ == "__main__":
    main()
