"""Batch framing: signal -> [..., num_frames, frame_size] as a strided view.

Counterpart of `crlot_tpu/frame/framing.py`. `Tensor.unfold` gives the frame
matrix as a view of the padded signal (frame f starts at f*hop), so no frame
is copied until a consumer reads it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.padding import pad_signal
from ..core.types import FrameSpec


def num_frames(spec: FrameSpec, signal_len: int) -> int:
    return spec.num_frames(signal_len)


def frame_padded(padded: torch.Tensor, frame_size: int, hop: int,
                 n_frames: int) -> torch.Tensor:
    """View `[..., n_frames, frame_size]` of an already padded signal with
    frame f = padded[..., f*hop : f*hop + frame_size]."""
    return padded.unfold(-1, frame_size, hop)[..., :n_frames, :]


def hop_block_frames(x: torch.Tensor, frame_size: int, hop: int,
                     n_frames: int) -> torch.Tensor:
    """`[..., L] -> [..., n_frames, frame_size]` with frame f =
    x[f*hop : f*hop + frame_size], zero past the end of a short signal."""
    span = (n_frames - 1) * hop + frame_size
    if x.shape[-1] < span:
        x = torch.nn.functional.pad(x, (0, span - x.shape[-1]))
    return frame_padded(x, frame_size, hop, n_frames)


def frame_signal(signal: torch.Tensor, spec: FrameSpec) -> torch.Tensor:
    """Slice `signal[..., L]` into `[..., num_frames, frame_size]`, padding
    frame_size//2 on both sides first when `spec.center`. Raises if the
    signal yields no frames."""
    length = signal.shape[-1]
    n = spec.num_frames(length)
    if n <= 0:
        raise ValueError(
            f"signal of length {length} yields no frames for frame_size="
            f"{spec.frame_size}, hop={spec.hop_size}, center={spec.center}"
        )
    padded = pad_signal(
        signal, spec.pad_amount, spec.pad_amount, spec.pad_mode, spec.pad_value
    )
    return frame_padded(padded, spec.frame_size, spec.hop_size, n)


def frame_windowed(
    signal: torch.Tensor,
    spec: FrameSpec,
    window: Optional[np.ndarray | torch.Tensor],
) -> torch.Tensor:
    """Frame and multiply by the analysis window (a new tensor)."""
    frames = frame_signal(signal, spec)
    if window is None:
        return frames
    w = torch.as_tensor(window, dtype=frames.dtype, device=frames.device)
    if w.shape != (spec.frame_size,):
        raise ValueError(
            f"window shape {tuple(w.shape)} != (frame_size,) = "
            f"({spec.frame_size},)"
        )
    return frames * w
