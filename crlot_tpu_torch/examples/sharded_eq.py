"""Example: multi-channel graphic EQ over a device mesh.

Shards channels and time blocks over every visible card (the CPU with
`--device cpu`), applies a band-gain EQ in the spectral domain chunk by
chunk, and reconstructs bit-identically to one device.

Usage: python -m crlot_tpu_torch.examples.sharded_eq in.wav out.wav
           [--device cuda|cpu]
"""

import argparse

import crlot_tpu_torch as pt
from crlot_tpu_torch.distributed.mesh import auto_mesh
from crlot_tpu_torch.distributed.stream import sharded_stream


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    x, sr = pt.read_wav(args.infile)
    cfg = pt.StftConfig(frame_size=1024, hop_size=256, center=False)
    eq = pt.spectral.band_gain(
        [200.0, 2000.0, 8000.0], [1.2, 1.0, 0.8, 0.5], sr, 1024)
    devices = None if args.device == "cuda" else [args.device]
    mesh = auto_mesh(channels=x.shape[0], devices=devices)
    y = sharded_stream(x, cfg, mesh, chunk_samples=1 << 20, spectral_fn=eq,
                       device=mesh.device(0, 0))
    pt.write_wav(args.outfile, y, sr, bits=16)
    print(f"processed {x.shape} over mesh {dict(mesh.shape)}")


if __name__ == "__main__":
    main()
