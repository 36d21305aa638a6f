"""Example: spectral noise gating of a WAV file.

Usage: python -m crlot_tpu_torch.examples.denoise in.wav out.wav
           [--threshold-db -45] [--device cuda|cpu]
"""

import argparse

import crlot_tpu_torch as pt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--threshold-db", type=float, default=-45.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    x, sr = pt.read_wav(args.infile)
    cfg = pt.StftConfig(frame_size=1024, hop_size=256, center=True)
    gate = pt.spectral.noise_gate(args.threshold_db, attenuation_db=-80.0)
    y = pt.round_trip(x, cfg, gate, device=args.device).cpu().numpy()
    pt.write_wav(args.outfile, y, sr, bits=16)
    print(f"{args.infile} -> {args.outfile}: gated below {args.threshold_db} dB")


if __name__ == "__main__":
    main()
