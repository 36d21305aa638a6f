"""Example: A- and C-weighted level measurement of a WAV.

Applies the IEC 61672 weighting filters (designed in float64, run as the
log-depth scan IIR cascade on the device) and reports weighted RMS levels
in dBFS per channel, plus the short-term level range.

Usage: python -m crlot_tpu_torch.examples.loudness in.wav [--block-ms 125]
           [--device cuda|cpu]
"""

import argparse

import numpy as np

import crlot_tpu_torch as pt


def _dbfs(x: np.ndarray) -> float:
    rms = float(np.sqrt(np.mean(np.square(x))))
    return 20.0 * np.log10(max(rms, 1e-12))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("infile")
    ap.add_argument("--block-ms", type=float, default=125.0,
                    help="short-term block size for the level range")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    x, sr = pt.read_wav(args.infile)
    if x.ndim == 1:
        x = x[None, :]
    ya = pt.sosfilt(pt.a_weighting_sos(float(sr)), x,
                    device=args.device).cpu().numpy()
    yc = pt.sosfilt(pt.c_weighting_sos(float(sr)), x,
                    device=args.device).cpu().numpy()

    block = max(1, int(sr * args.block_ms / 1000.0))
    for ch in range(x.shape[0]):
        n_blocks = len(ya[ch]) // block
        short = ya[ch][: n_blocks * block].reshape(n_blocks, block)
        lv = 20.0 * np.log10(
            np.maximum(np.sqrt(np.mean(np.square(short), axis=1)), 1e-12))
        print(
            f"ch{ch}: unweighted {_dbfs(x[ch]):6.1f} dBFS | "
            f"A-weighted {_dbfs(ya[ch]):6.1f} dBFS | "
            f"C-weighted {_dbfs(yc[ch]):6.1f} dBFS | "
            f"short-term A range [{lv.min():.1f}, {lv.max():.1f}] dBFS "
            f"({args.block_ms:.0f} ms blocks)"
        )


if __name__ == "__main__":
    main()
