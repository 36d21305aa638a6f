"""Silence trimming and activity segmentation, in torch.

Counterpart of `crlot_tpu/segment.py`. Frame-level activity is a tensor
computation (dB RMS against a threshold relative to the signal's peak
frame); the data-dependent part (variable-length trims, interval lists) is
a thin host step on the boolean mask.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .core import device as _device
from .core.types import StftConfig

__all__ = [
    "activity_mask",
    "trim_silence",
    "split_silence",
    "frames_to_time",
    "time_to_frames",
]


def frames_to_time(frames, cfg: StftConfig, sr: float) -> np.ndarray:
    """Frame indices -> seconds (host helper). With `cfg.center` frame f is
    centered at f*hop; otherwise at f*hop + frame_size/2."""
    f = np.asarray(frames, np.float64)
    offset = 0.0 if cfg.center else cfg.frame_size / 2.0
    return (f * cfg.hop_size + offset) / float(sr)


def time_to_frames(times, cfg: StftConfig, sr: float) -> np.ndarray:
    """Seconds -> nearest frame indices (inverse of `frames_to_time`,
    clipped at 0)."""
    t = np.asarray(times, np.float64)
    offset = 0.0 if cfg.center else cfg.frame_size / 2.0
    f = np.rint((t * float(sr) - offset) / cfg.hop_size).astype(np.int64)
    return np.maximum(f, 0)


def activity_mask(signal, cfg: StftConfig, top_db: float = 60.0,
                  device=None) -> torch.Tensor:
    """Boolean per-frame activity `[..., T] -> [..., F]`: a frame is
    active when its RMS is within `top_db` dB of the signal's peak RMS
    frame (per batch element). All-silent input yields all-False."""
    from .features import frame_rms

    rms = frame_rms(_device.place(signal, device, torch.float32), cfg)
    db = 20.0 * torch.log10(torch.clamp_min(rms, 1e-12))
    ref = torch.amax(db, dim=-1, keepdim=True)
    return (db > ref - top_db) & (ref > -120.0)


def _frame_span_to_samples(
    first: int, last: int, cfg: StftConfig, length: int
) -> Tuple[int, int]:
    """[first, last] active frame span -> sample span. With center=True
    frame f is centered at f*hop; otherwise it covers
    [f*hop, f*hop + frame_size)."""
    hop, n = cfg.hop_size, cfg.frame_size
    if cfg.center:
        start = first * hop - n // 2
        end = last * hop + n // 2 + 1
    else:
        start = first * hop
        end = last * hop + n
    return max(0, start), min(length, end)


def _mask_1d(signal, cfg, top_db, device, name) -> np.ndarray:
    if signal.ndim != 1:
        raise ValueError(f"{name} expects 1-D audio, got {tuple(signal.shape)}")
    return activity_mask(signal, cfg, top_db, device=device).cpu().numpy()


def trim_silence(signal, cfg: StftConfig, top_db: float = 60.0, device=None):
    """Trim leading/trailing silence from 1-D audio. Returns
    `(trimmed, (start, end))` with `trimmed = signal[start:end]` (a host
    float32 array for array-like input, a slice of the tensor for a tensor).
    All-silent input returns an empty slice and `(0, 0)`."""
    if not isinstance(signal, torch.Tensor):
        signal = np.asarray(signal, np.float32)
    mask = _mask_1d(signal, cfg, top_db, device, "trim_silence")
    idx = np.nonzero(mask)[0]
    if idx.size == 0:
        return signal[:0], (0, 0)
    start, end = _frame_span_to_samples(
        int(idx[0]), int(idx[-1]), cfg, signal.shape[0]
    )
    return signal[start:end], (start, end)


def split_silence(signal, cfg: StftConfig, top_db: float = 60.0,
                  device=None) -> List[Tuple[int, int]]:
    """Split 1-D audio at silence: the `(start, end)` sample intervals of
    each contiguous active region (non-overlapping, ascending; empty for
    all-silent input)."""
    if not isinstance(signal, torch.Tensor):
        signal = np.asarray(signal, np.float32)
    mask = _mask_1d(signal, cfg, top_db, device, "split_silence")
    mask = mask.astype(np.int8)
    if not mask.any():
        return []
    edges = np.diff(np.concatenate([[0], mask, [0]]))
    starts = np.nonzero(edges == 1)[0]
    ends = np.nonzero(edges == -1)[0] - 1  # inclusive frame index
    out = []
    for f0, f1 in zip(starts, ends):
        s, e = _frame_span_to_samples(int(f0), int(f1), cfg, signal.shape[0])
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], e)  # merge frame-overlapping regions
        else:
            out.append((s, e))
    return out
