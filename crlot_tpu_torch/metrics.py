"""Quality metrics (host, float64): counterpart of `crlot_tpu/metrics.py`."""

from __future__ import annotations

import numpy as np
import torch


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64).reshape(-1)


def snr_db(reference, test) -> float:
    """10*log10(sum(ref^2) / sum((ref-test)^2)) in float64; +inf for an
    exact match, -inf for a silent reference."""
    ref, tst = _f64(reference), _f64(test)
    if ref.shape != tst.shape:
        raise ValueError(f"shape mismatch: {ref.shape} vs {tst.shape}")
    sig = np.sum(ref * ref)
    noise = np.sum(np.square(ref - tst))
    if sig <= 0.0:
        return float("-inf")
    if noise <= 0.0:
        return float("inf")
    return float(10.0 * np.log10(sig / noise))
