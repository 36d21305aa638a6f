"""Example: checkpointed streaming STFT round-trip of a long WAV.

Processes a file hop by hop through the streaming Framer -> FFT plan ->
streaming OLA chain (the drain on B5's normalize kernel on the card),
checkpointing the stream state every few seconds of audio; re-run with
the same arguments after an interruption and it resumes from the last
checkpoint, producing output bit-identical to an unbroken run.

Usage: python -m crlot_tpu_torch.examples.streaming_checkpoint in.wav out.npy
           [--ckpt PATH] [--crash-after-seconds S] [--device cuda|cpu]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

import crlot_tpu_torch as pt
from crlot_tpu_torch.checkpoint import load_stream_state, save_stream_state
from crlot_tpu_torch.core.device import resolve_indexed
from crlot_tpu_torch.ola.streaming import (
    make_norm_ring,
    ola_add_frame,
    ola_flush,
    ola_init,
    ola_produce,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "stream.ckpt.npz"))
    ap.add_argument("--frame-size", type=int, default=1024)
    ap.add_argument("--hop", type=int, default=256)
    ap.add_argument("--ckpt-every-seconds", type=float, default=2.0)
    ap.add_argument(
        "--crash-after-seconds", type=float, default=None,
        help="simulate an interruption after S seconds of audio")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_indexed(args.device)
    x, sr = pt.read_wav(args.infile)
    mono = np.asarray(x[0])
    n, hop = args.frame_size, args.hop
    w = pt.get_window(pt.WindowType.HANN, n)
    plan = pt.make_fft_plan(pt.FftPlanDesc(domain=pt.FftDomain.REAL, nfft=n))
    cfg = pt.OLAConfig(sample_rate=sr, frame_size=n, hop_size=hop,
                       channels=1)
    norm_ring = torch.from_numpy(np.array(make_norm_ring(cfg, w))).to(dev)
    win = torch.from_numpy(np.array(w)).to(dev)

    start_frame = 0
    state = ola_init(cfg, device=dev)
    pieces = []
    if os.path.exists(args.ckpt):
        state, _, start_frame, _ = load_stream_state(args.ckpt, device=dev)
        pieces = [np.load(args.ckpt + ".out.npy")]
        print(f"resuming at frame {start_frame}")

    framer = pt.Framer(n, hop, channels=1, device=dev)
    framer.push(mono)
    frames = framer.pop_batch()[:, 0]  # [F, n]
    total_frames = frames.shape[0]
    ckpt_every = max(1, int(args.ckpt_every_seconds * sr / hop))
    crash_at = (None if args.crash_after_seconds is None
                else start_frame + int(args.crash_after_seconds * sr / hop))

    for f in range(start_frame, total_frames):
        spec = plan.forward(frames[f] * win)
        out_frame = plan.inverse(spec)  # identity processing
        # Window once: it was applied before the FFT, so the OLA add is
        # unwindowed while norm_ring stays the COLA sum of the window.
        state = ola_add_frame(state, out_frame.reshape(1, n), f * hop, None,
                              cfg)
        state, out, count = ola_produce(state, norm_ring, cfg, hop)
        pieces.append(out[0, :count].cpu().numpy())
        if (f + 1) % ckpt_every == 0:
            save_stream_state(args.ckpt, state, cfg, frame_index=f + 1)
            np.save(args.ckpt + ".out.npy", np.concatenate(pieces))
            if crash_at is not None and f + 1 >= crash_at:
                print(f"simulated crash after frame {f + 1}; rerun to resume")
                return

    state = ola_flush(state)
    state, out, count = ola_produce(state, norm_ring, cfg, n)
    pieces.append(out[0, :count].cpu().numpy())
    y = np.concatenate(pieces)
    np.save(args.outfile, y)
    # The first N samples have partial overlap coverage (stream warm-up):
    # score from there.
    m = min(len(mono), len(y))
    print(f"{args.infile} -> {args.outfile}: {len(y)} samples, "
          f"SNR {pt.snr_db(mono[n:m], y[n:m]):.1f} dB (past the N-sample "
          f"warm-up)")
    for p in (args.ckpt, args.ckpt + ".out.npy"):
        if os.path.exists(p):
            os.remove(p)


if __name__ == "__main__":
    main()
