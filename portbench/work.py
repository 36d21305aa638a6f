"""The operations and bytes a kernel's products need, from a cell's shapes.

Counted from the configuration and the traffic mix, never from a kernel's
launch arguments: each input byte read once, each output byte written
once, whatever kernel computes the product. A 3xTF32 product (precision
tier "high") counts as three TF32 products; its bound is the larger of the
bytes over the HBM bandwidth and the operations over the TF32 peak.
"""

from __future__ import annotations

F32 = 4
TF32_PASSES = {"high": 3}


def _passes(config: dict) -> int:
    if config["precision"] not in TF32_PASSES:
        raise ValueError(f"no count for the {config['precision']!r} tier")
    return TF32_PASSES[config["precision"]]


def frames_of(config: dict, samples: int) -> int:
    """Whole frames of a clip of `samples` (centred: N/2 padding each side)."""
    n, hop = config["frame_size"], config["hop_size"]
    padded = samples + (n if config["center"] else 0)
    return (padded - n) // hop + 1


def blocked_shape(config: dict) -> dict:
    """The hop-block Toeplitz product's geometry: G output hops a row (the
    smallest G with G*H a multiple of 128 that divides 2(R-1)), each row a
    window of (G + 2(R-1)) hops times a [window, G*H] matrix."""
    n, hop = config["frame_size"], config["hop_size"]
    r = n // hop
    g = next(g for g in range(2, 2 * (r - 1) + 1)
             if (g * hop) % 128 == 0 and (2 * (r - 1)) % g == 0)
    return {"block": g * hop, "k": (g + 2 * (r - 1)) * hop}


def b0_clip(config: dict, channels: int, samples: int) -> dict:
    """B0 on `round_trip`'s blocked route over a clip: one product row per
    G*H output samples of the frames' span, and the head and tail patches
    (R-1 frames each times an [N, N] matrix)."""
    n, hop = config["frame_size"], config["hop_size"]
    geo = blocked_shape(config)
    span = (frames_of(config, samples) - 1) * hop + n
    rows = -(-span // geo["block"])
    macs = channels * rows * geo["k"] * geo["block"]
    macs += 2 * channels * (n // hop - 1) * n * n
    data = 2 * channels * span * F32 + geo["k"] * geo["block"] * F32
    return {"ops": 2 * macs * _passes(config), "bytes": data}


def b0_stream_step(config: dict, channels: int, chunk: int,
                   time_shards: int) -> dict:
    """B0 over one stream step: the chunk with its context (N rounded up to
    a multiple of time_shards * H on each side), one product row per G*H
    samples. The context's edge patches land in discarded samples and are
    not needed, so not counted."""
    n, hop = config["frame_size"], config["hop_size"]
    geo = blocked_shape(config)
    unit = time_shards * hop
    ext = chunk + 2 * (-(-n // unit) * unit)
    rows = -(-ext // geo["block"])
    macs = channels * rows * geo["k"] * geo["block"]
    data = 2 * channels * ext * F32 + geo["k"] * geo["block"] * F32
    return {"ops": 2 * macs * _passes(config), "bytes": data}


def b2_clip(config: dict, channels: int, samples: int) -> dict:
    """B2 over a clip: each frame's real DFT and its inverse as folded
    products, (N/2) x (N/2) real MACs for each of the even and odd halves
    each way: N^2 MACs a frame; the signal read, the frames written."""
    n = config["frame_size"]
    f = frames_of(config, samples)
    macs = channels * f * n * n
    data = channels * (samples + n) * F32 + channels * f * n * F32
    return {"ops": 2 * macs * _passes(config), "bytes": data}


def bound_s(work: dict, peaks: dict) -> tuple:
    """(seconds, "ops" or "bytes"): the least time the card could take."""
    t_ops = work["ops"] / peaks["tf32_flops"]
    t_bytes = work["bytes"] / peaks["hbm_bytes_per_s"]
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
