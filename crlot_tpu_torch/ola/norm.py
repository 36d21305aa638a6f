"""COLA normalization for offline reconstruction (numpy, float64 design).

A copy of `crlot_tpu/ola/norm.py::edge_norm`; the tests hold it
byte-identical to the reference's.
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
