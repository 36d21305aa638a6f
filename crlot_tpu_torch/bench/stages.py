"""Per-stage times of the round-trip pipeline on the card (or the CPU).

Counterpart of `crlot_tpu/bench/stages.py`: each stage timed alone, to
find the bottleneck. `_time` is one CUDA-event median a call for a CUDA
tensor (queued behind a busy card) and the host clock around each
synchronous call for a CPU tensor; the reference's chain-minima
differencing existed for its tunnel and is not needed on the card.

* `main()`: the generic analogs (gather framing, slice framing, window
  product, `torch.fft` rfft / irfft, the slice-update OLA, normalize) on
  60 s at 48 kHz, N=1024, H=256;
* `main_pipeline()`: the real decomposition: framing, the folded DFT
  products, their round-trip, B1's fused OLA + normalize, and the port's
  route for the main path on the card ("blocked": B0's extended input
  written once, B0's product on it, the two edge patches), each beside
  the whole `round_trip`; the framed and the blocked stage sums are
  reported next to it.

    python -m crlot_tpu_torch.bench.stages [--pipeline [--only a,b]]
        [--device cuda|cpu] [--seconds S]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .probes import device_ms

REPS = 10


def _time(fn, x, reps: int = REPS) -> float:
    """Median seconds of one call of fn(x) on x's device."""
    return device_ms(lambda: fn(x), x.device, reps) / 1e3


def frame_take(padded: torch.Tensor, n: int, hop: int, f: int):
    """Framing by a gather of f x n indices."""
    starts = torch.arange(f, device=padded.device) * hop
    idx = starts[:, None] + torch.arange(n, device=padded.device)[None, :]
    return padded[..., idx]


def frame_slices(padded: torch.Tensor, n: int, hop: int, f: int):
    """Gather-free framing: hop-block reshape + R shifted slices."""
    r = n // hop
    blocks_needed = f + r - 1
    blocks = padded[..., : blocks_needed * hop].reshape(
        padded.shape[:-1] + (blocks_needed, hop))
    parts = [blocks[..., i : i + f, :] for i in range(r)]
    return torch.cat(parts, dim=-1)


def ola_dus(frames: torch.Tensor, hop: int, out_len: int):
    """Overlap-add by R slice updates of a [F + R - 1, hop] accumulator,
    the last hop of every frame first."""
    f, n = frames.shape[-2:]
    r = n // hop
    hops = frames.reshape(frames.shape[:-1] + (r, hop))
    out = frames.new_zeros(frames.shape[:-2] + (f + r - 1, hop))
    for i in range(r - 1, -1, -1):
        out[..., i : i + f, :] += hops[..., :, i, :]
    return out.reshape(out.shape[:-2] + (-1,))[..., :out_len]


def _device(device):
    from ..core.device import resolve_indexed

    return resolve_indexed(device)


def main(seconds=60, n=1024, hop=256, device=None) -> dict:
    """The generic stage analogs; prints and returns one JSON object."""
    dev = _device(device)
    sr = 48000
    total = sr * seconds
    f = (total - (n - hop)) // hop
    rng = np.random.default_rng(0)

    def on(a):
        return torch.from_numpy(a).to(dev)

    x = on(rng.uniform(-1, 1, total).astype(np.float32))
    frames = on(rng.uniform(-1, 1, (f, n)).astype(np.float32))
    w = on(rng.uniform(0, 1, n).astype(np.float32))
    spec = torch.fft.rfft(frames[:256], dim=-1)
    spec = spec.repeat(f // 256 + 1, 1)[:f].contiguous()
    norm = on(rng.uniform(0.5, 2, total).astype(np.float32)).abs()

    results = {
        "frame_take_ms": _time(lambda s: frame_take(s, n, hop, f), x) * 1e3,
        "frame_slices_ms": _time(lambda s: frame_slices(s, n, hop, f),
                                 x) * 1e3,
        "window_mul_ms": _time(lambda fr: fr * w, frames) * 1e3,
        "rfft_ms": _time(lambda fr: torch.fft.rfft(fr, dim=-1), frames) * 1e3,
        "irfft_ms": _time(lambda s: torch.fft.irfft(s, n=n, dim=-1),
                          spec) * 1e3,
        "ola_dus_ms": _time(lambda fr: ola_dus(fr, hop, total), frames) * 1e3,
        "normalize_ms": _time(lambda a: a / torch.clamp_min(norm, 1e-8),
                              x) * 1e3,
        "frames": f,
        "backend": backend_name(dev),
    }
    print(json.dumps(results), flush=True)
    return results


def backend_name(dev) -> str:
    """"cuda:<card name>" on a card, "cpu" on the CPU."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


def main_pipeline(seconds=60, n=1024, hop=256, only=None,
                  device=None) -> dict:
    """The real round-trip decomposition, one JSON line a stage as it
    completes, then one with the stage sums beside `round_trip`. `only`
    restricts to a comma-separated subset of the stages. Returns the
    stage times (ms) and the sums."""
    from ..core.types import StftConfig
    from ..fft.matmul_backend import (
        blocked_plan_for,
        blocked_response,
        hopblock_product,
        irfft_folded_parts,
        rfft_folded_packed,
        roundtrip_folded_matmul,
    )
    from ..frame.framing import frame_signal
    from ..ola.fused import ola_normalized_auto
    from ..ola.norm import edge_norm
    from ..pipeline import blocked_input, formulation_for, round_trip
    from ..window.windows import get_window

    dev = _device(device)
    sr = 48000
    total = sr * seconds
    cfg = StftConfig(frame_size=n, hop_size=hop, center=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, total).astype(np.float32)).to(dev)
    w64 = get_window(cfg.window, n, cfg.periodic, dtype=np.float64)
    w32 = torch.from_numpy(w64.astype(np.float32)).to(dev)
    frames_np = rng.uniform(-1, 1, ((total // hop) + 1, n)).astype(np.float32)
    frames = torch.from_numpy(frames_np).to(dev)
    f = frames.shape[0]
    full = (f - 1) * hop + n
    norm = torch.from_numpy(edge_norm(w64, hop, f, full)).to(dev)
    re_im = torch.cat(rfft_folded_packed(frames, n, w32), dim=-1)
    k = n // 2 + 1

    # The "blocked" route's pieces, as `blocked_composed_round_trip` runs
    # them on this signal, on its plan.
    nf = cfg.frame_spec.num_frames(total)
    plan = blocked_plan_for(cfg, blocked_response(cfg, None))
    kern, bt = plan.operands(dev, cfg.fft_precision)
    bfull = (nf - 1) * hop + n
    span_p = plan.patch_span
    x_ext, edge = blocked_input(x, cfg, bfull)

    def edges(xe):
        xp = xe[..., edge:edge + bfull]
        return (plan.patch(xp[..., :span_p], "head"),
                plan.patch(xp[..., bfull - span_p:], "tail"))

    stages = {
        "frame_signal": (lambda s: frame_signal(s, cfg.frame_spec), x),
        "fwd_folded": (lambda fr: torch.cat(rfft_folded_packed(fr, n),
                                            dim=-1), frames),
        "inv_folded": (lambda p: irfft_folded_parts(p[..., :k], p[..., k:],
                                                    n), re_im),
        "rt_folded": (lambda fr: roundtrip_folded_matmul(fr, n, w64), frames),
        "ola_fused": (lambda fr: ola_normalized_auto(fr, norm, hop, full,
                                                     1e-8), frames),
        "blocked_pad": (lambda s: blocked_input(s, cfg, bfull), x),
        "blocked_b0": (lambda xe: hopblock_product(
            xe, kern, plan.gh, cfg.fft_precision, bt), x_ext),
        "blocked_edges": (edges, x_ext),
        "round_trip": (lambda s: round_trip(s, cfg), x),
    }
    wanted = set(only.split(",")) if only else set(stages)
    out = {}
    for name, (fn, arg) in stages.items():
        if name not in wanted:
            continue
        out[f"{name}_ms"] = _time(fn, arg) * 1e3
        print(json.dumps({f"{name}_ms": out[f"{name}_ms"], "frames": f,
                          "backend": backend_name(dev)}), flush=True)
    framed = ("frame_signal", "rt_folded", "ola_fused")
    blocked = ("blocked_pad", "blocked_b0", "blocked_edges")
    sums = {"route": formulation_for(cfg, None, total)}
    for key, names in (("framed_stage_sum_ms", framed),
                       ("blocked_stage_sum_ms", blocked)):
        if all(f"{s}_ms" in out for s in names):
            sums[key] = sum(out[f"{s}_ms"] for s in names)
    if "round_trip_ms" in out:
        sums["round_trip_ms"] = out["round_trip_ms"]
    print(json.dumps(sums), flush=True)
    out.update(sums)
    return out


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=int, default=60)
    args = ap.parse_args(argv)
    if args.pipeline:
        main_pipeline(seconds=args.seconds, only=args.only,
                      device=args.device)
    else:
        main(seconds=args.seconds, device=args.device)


def stream_block_probe(cfg, device=None):
    """(one_block_fn, tail0): ONE hop block of frames through the
    streaming scan step with the carried OLA tail (`one_block(tail)` ->
    the next tail), for per-hop-block latency timing. As in the
    reference, a value derived from the carried tail is added into the
    frames and one from the output into the tail, so every block depends
    on the one before."""
    from ..streaming_pipeline import streaming_round_trip_blocks

    dev = _device(device)
    n, hop = cfg.frame_size, cfg.hop_size
    rng = np.random.default_rng(2)
    frames1 = torch.from_numpy(
        rng.uniform(-1, 1, (1, 1, n)).astype(np.float32)).to(dev)

    def one_block(tail):
        f1 = frames1 + tail.sum() * 1e-30
        out_b, tail2 = streaming_round_trip_blocks(
            f1, cfg, 1, None, carry_tail=tail, return_carry=True)
        return tail2 + out_b.sum() * 1e-30

    return one_block, torch.zeros(n - hop, dtype=torch.float32, device=dev)


if __name__ == "__main__":
    _cli()
