"""Example: music/audio analysis report for a WAV.

Runs the analysis stack on the device: silence segmentation, global
tempo, the harmonic/percussive energy split, spectral contrast, tonal
centroids and a PCEN mel front-end, and prints a compact report.
Optionally writes the separated harmonic/percussive parts.

Usage: python -m crlot_tpu_torch.examples.analyze in.wav
           [--write-stems outdir] [--device cuda|cpu]
"""

import argparse
import os

import numpy as np
import torch

import crlot_tpu_torch as pt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("infile")
    ap.add_argument("--write-stems", default=None,
                    help="directory for harmonic/percussive WAV stems")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    x, sr = pt.read_wav(args.infile)
    mono = x if x.ndim == 1 else np.mean(x, axis=0).astype(np.float32)
    cfg = pt.StftConfig(frame_size=1024, hop_size=256, center=True)
    signal = torch.from_numpy(mono).to(args.device)

    # Segmentation
    trimmed, (s, e) = pt.trim_silence(signal, cfg, top_db=50.0)
    regions = pt.split_silence(signal, cfg, top_db=50.0)
    print(f"length: {len(mono) / sr:.2f} s  active span: "
          f"[{s / sr:.2f}, {e / sr:.2f}] s  regions: {len(regions)}")
    if trimmed.numel() == 0:
        print("all silence — nothing to analyze")
        return

    # Rhythm
    bpm = float(pt.tempo(trimmed, cfg, float(sr)))
    print(f"tempo: {bpm:.1f} BPM")

    # Harmonic / percussive balance
    h, p = pt.hpss(trimmed, cfg)
    h, p = h.cpu().numpy(), p.cpu().numpy()
    eh = float(np.sum(np.square(h, dtype=np.float64)))
    ep = float(np.sum(np.square(p, dtype=np.float64)))
    print(f"harmonic/percussive energy: {eh / (eh + ep + 1e-30):.1%} / "
          f"{ep / (eh + ep + 1e-30):.1%}")

    # Tonality
    contrast = pt.spectral_contrast(trimmed, cfg, float(sr)).cpu().numpy()
    print("median octave-band contrast (dB):",
          np.round(np.median(contrast, axis=0), 1))
    tc = pt.tonnetz(trimmed, cfg, float(sr)).cpu().numpy().mean(axis=0)
    print("mean tonal centroid (6-D):", np.round(tc, 3))

    # ML front-end: PCEN mel
    mel = pt.mel_spectrogram(trimmed, cfg, float(sr), n_mels=64)
    z = pt.pcen(mel, float(sr) / cfg.hop_size).cpu().numpy()
    print(f"pcen mel: {z.shape} range [{z.min():.2f}, {z.max():.2f}]")

    if args.write_stems:
        os.makedirs(args.write_stems, exist_ok=True)
        pt.write_wav(os.path.join(args.write_stems, "harmonic.wav"), h, sr,
                     bits=16)
        pt.write_wav(os.path.join(args.write_stems, "percussive.wav"), p, sr,
                     bits=16)
        print(f"stems written to {args.write_stems}")


if __name__ == "__main__":
    main()
