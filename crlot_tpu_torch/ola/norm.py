"""COLA normalization builders (numpy, float64 design).

Copies of `crlot_tpu/ola/norm.py`: `edge_norm` (actual coverage, offline
reconstruction) and `build_norm_linear` (full, steady-state coverage: the
streaming round-trip's norm). The tests hold both byte-identical to the
reference's.
"""

from __future__ import annotations

import numpy as np


def edge_norm(
    window_contrib: np.ndarray, hop: int, num_frames: int, out_len: int
) -> np.ndarray:
    """Actual-coverage norm, float32[out_len]:
    norm[t] = sum over real frames k in [0, num_frames) of w[t - k*hop].
    Edge positions are covered by fewer frames, so dividing by this norm
    reconstructs the signal edges exactly."""
    w = np.asarray(window_contrib, dtype=np.float64)
    n = len(w)
    norm = np.zeros(out_len, dtype=np.float64)
    for k in range(num_frames):
        start = k * hop
        stop = min(start + n, out_len)
        if stop > start:
            norm[start:stop] += w[: stop - start]
    return norm.astype(np.float32)


def build_norm_linear(
    window: np.ndarray, ring_len: int, frame_size: int, hop: int
) -> np.ndarray:
    """Full-coverage per-position window sum, float32[ring_len]: every
    position's norm assumes steady-state frame coverage, which is periodic
    with period `hop`: norm[p] = sum_j w[(p mod hop) + j*hop]. `window` is
    w (norm = sum w) or w^2 (with a synthesis window)."""
    w = np.asarray(window, dtype=np.float64)
    if w.shape != (frame_size,):
        raise ValueError(f"window shape {w.shape} != ({frame_size},)")
    if hop <= 0 or ring_len <= 0:
        raise ValueError("hop and ring_len must be > 0")
    if ring_len % hop != 0:
        raise ValueError(
            f"ring_len ({ring_len}) must be a multiple of hop ({hop})"
        )
    n_pad = -(-frame_size // hop) * hop
    wp = np.zeros(n_pad, dtype=np.float64)
    wp[:frame_size] = w
    period = wp.reshape(-1, hop).sum(axis=0)
    return np.tile(period, ring_len // hop).astype(np.float32)
