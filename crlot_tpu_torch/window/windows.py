"""Window generation with a host-side cache (numpy, float64 design).

A copy of `crlot_tpu/window/windows.py`'s design code: the port must not
import the JAX package, and the tests hold these arrays byte-identical to
the reference's.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.types import NormalizationType, WindowType

_CACHE: Dict[Tuple, np.ndarray] = {}
_CACHE_LOCK = threading.Lock()


def _raw_window(wtype: WindowType, n: int, periodic: bool) -> np.ndarray:
    """Raw coefficients in float64; `periodic` uses denominator N, else N-1."""
    if n == 1:
        return np.ones(1, dtype=np.float64)
    denom = n if periodic else n - 1
    k = np.arange(n, dtype=np.float64)
    phase = 2.0 * np.pi * k / denom
    if wtype == WindowType.HANN:
        return 0.5 - 0.5 * np.cos(phase)
    if wtype == WindowType.HAMMING:
        return 0.54 - 0.46 * np.cos(phase)
    if wtype == WindowType.BLACKMAN:
        return 0.42 - 0.5 * np.cos(phase) + 0.08 * np.cos(2.0 * phase)
    if wtype == WindowType.BLACKMAN_HARRIS:
        a0, a1, a2, a3 = 0.35875, 0.48829, 0.14128, 0.01168
        return (
            a0
            - a1 * np.cos(phase)
            + a2 * np.cos(2.0 * phase)
            - a3 * np.cos(3.0 * phase)
        )
    if wtype == WindowType.RECT:
        return np.ones(n, dtype=np.float64)
    raise ValueError(f"unknown window type: {wtype}")


def _normalize(
    w: np.ndarray, norm: NormalizationType, hop: Optional[int]
) -> np.ndarray:
    if norm == NormalizationType.NONE:
        return w
    if norm == NormalizationType.SUM_TO_ONE:
        s = w.sum()
        return w / s if s > 0 else w
    if norm == NormalizationType.L2_NORM:
        s = np.sqrt(np.square(w).sum())
        return w / s if s > 0 else w
    if norm == NormalizationType.OLA_UNITY_GAIN:
        if hop is None or hop <= 0:
            return _normalize(w, NormalizationType.L2_NORM, None)
        g = _max_overlapped_sum(w, hop)
        return w / g if g > 0 else w
    if norm == NormalizationType.OLA_SUM_WSQ:
        wsq = np.square(w).sum()
        if wsq <= 0:
            return w
        if hop is None or hop <= 0:
            return w / np.sqrt(wsq)
        n = len(w)
        return w * np.sqrt(hop / (wsq * n))
    raise ValueError(f"unknown normalization: {norm}")


def _max_overlapped_sum(w: np.ndarray, hop: int) -> float:
    n = len(w)
    best = 0.0
    for p in range(min(hop, n)):
        s = w[p::hop].sum()
        best = max(best, float(s))
    return best


def get_window(
    wtype: WindowType,
    n: int,
    periodic: bool = True,
    norm: NormalizationType = NormalizationType.NONE,
    hop: Optional[int] = None,
    dtype=np.float32,
) -> np.ndarray:
    """The cached, read-only window `dtype[n]`, designed in float64."""
    if n <= 0:
        raise ValueError(f"window size must be > 0, got {n}")
    key = (wtype, n, bool(periodic), norm, hop, np.dtype(dtype).str)
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
        if hit is not None:
            return hit
    w64 = _normalize(_raw_window(wtype, n, periodic), norm, hop)
    w = np.asarray(w64, dtype=dtype)
    w.setflags(write=False)
    with _CACHE_LOCK:
        return _CACHE.setdefault(key, w)
