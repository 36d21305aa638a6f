"""Example: phase-vocoder time-stretch (or pitch-shift) of a WAV.

Usage: python -m crlot_tpu_torch.examples.time_stretch in.wav out.wav --rate 1.5
       python -m crlot_tpu_torch.examples.time_stretch in.wav out.wav --semitones 4
       (either with [--device cuda|cpu])
"""

import argparse

import crlot_tpu_torch as pt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--rate", type=float, default=None,
                    help="duration factor (>1 = slower)")
    ap.add_argument("--semitones", type=float, default=None,
                    help="pitch shift at constant duration")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if (args.rate is None) == (args.semitones is None):
        ap.error("give exactly one of --rate / --semitones")

    x, sr = pt.read_wav(args.infile)
    cfg = pt.StftConfig(frame_size=1024, hop_size=256)
    if args.rate is not None:
        y = pt.time_stretch(x, cfg, args.rate, device=args.device)
        what = f"stretched x{args.rate}"
    else:
        y = pt.pitch_shift(x, cfg, args.semitones, device=args.device)
        what = f"shifted {args.semitones:+.1f} semitones"
    y = y.cpu().numpy()
    pt.write_wav(args.outfile, y, sr, bits=16)
    print(f"{args.infile} -> {args.outfile}: {what}, "
          f"{x.shape[-1]} -> {y.shape[-1]} samples")


if __name__ == "__main__":
    main()
