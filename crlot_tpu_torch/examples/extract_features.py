"""Example: mel-spectrogram / MFCC feature extraction from a WAV.

The feature stack (framing, the DFT products, |.|^2, the mel filterbank
product, dB, the DCT product) and the descriptors, onsets and tempo run
on the device; the arrays are saved to an .npz.

Usage: python -m crlot_tpu_torch.examples.extract_features in.wav out.npz
           [--n-mels 64] [--n-mfcc 13] [--frame-size 1024]
           [--hop-size 256] [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

import crlot_tpu_torch as pt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("infile")
    ap.add_argument("outfile", help=".npz with mel, mfcc, centroid arrays")
    ap.add_argument("--n-mels", type=int, default=64)
    ap.add_argument("--n-mfcc", type=int, default=13)
    ap.add_argument("--frame-size", type=int, default=1024)
    ap.add_argument("--hop-size", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    x, sr = pt.read_wav(args.infile)
    mono = np.mean(x, axis=0) if x.ndim == 2 else x
    sig = torch.from_numpy(np.ascontiguousarray(mono, np.float32)).to(
        args.device)
    cfg = pt.StftConfig(frame_size=args.frame_size, hop_size=args.hop_size,
                        center=True)

    def host(t):
        return t.cpu().numpy()

    mel_t = pt.mel_spectrogram(sig, cfg, float(sr), n_mels=args.n_mels)
    mel = host(mel_t)
    coeffs_t = pt.mfcc(sig, cfg, float(sr), n_mfcc=args.n_mfcc,
                       n_mels=args.n_mels)
    coeffs = host(coeffs_t)
    d1 = host(pt.delta(coeffs_t))
    centroid = host(pt.spectral_centroid(sig, cfg, float(sr)))
    flatness = host(pt.spectral_flatness(sig, cfg))
    chroma = host(pt.chroma(sig, cfg, float(sr)))
    contrast = host(pt.spectral_contrast(sig, cfg, float(sr)))
    tonnetz = host(pt.tonnetz(sig, cfg, float(sr)))
    pcen = host(pt.pcen(mel_t, float(sr) / args.hop_size))
    onset_mask, onset_env = pt.detect_onsets(sig, cfg, float(sr))
    onsets = np.nonzero(host(onset_mask))[0]
    bpm = float(pt.tempo(sig, cfg, float(sr)))

    np.savez(
        args.outfile, mel=mel, mfcc=coeffs, mfcc_delta=d1,
        centroid=centroid, flatness=flatness, chroma=chroma,
        contrast=contrast, tonnetz=tonnetz, pcen=pcen, tempo_bpm=bpm,
        onset_env=host(onset_env), onset_frames=onsets,
        sample_rate=sr, hop_size=args.hop_size,
    )
    print(
        f"{args.infile}: {mel.shape[0]} frames -> mel{mel.shape} "
        f"mfcc{coeffs.shape} chroma{chroma.shape}; median centroid "
        f"{float(np.median(centroid)):.0f} Hz, median flatness "
        f"{float(np.median(flatness)):.3f}, {len(onsets)} onsets, "
        f"{bpm:.0f} BPM -> {args.outfile}"
    )


if __name__ == "__main__":
    main()
