"""Batch framing: signal -> [..., num_frames, frame_size] as a strided view.

Counterpart of `crlot_tpu/frame/framing.py`. `Tensor.unfold` gives the frame
matrix as a view of the padded signal (frame f starts at f*hop), so no frame
is copied until a consumer reads it. `FrameQueue` is the random-access
form, and `aos_to_soa` / `soa_to_aos` convert interleaved samples.
Array-like input goes to `device` (default "cuda"; `core/device.py`); a
tensor stays on its own device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import device as _device
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


def frame_start_indices(spec: FrameSpec, signal_len: int,
                        device=None) -> torch.Tensor:
    """Start sample (in the unpadded signal) of each frame, int64: frame i
    covers [i*hop - pad, i*hop - pad + frame)."""
    n = spec.num_frames(signal_len)
    return (torch.arange(n, device=_device.resolve(device)) * spec.hop_size
            - spec.pad_amount)


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


class FrameQueue:
    """Batch framing with per-frame accessors: the whole [num_frames,
    frame_size] matrix is made up front and contiguous (frame i + 1
    follows frame i); `get_frame` returns a view, `copy_frame` a copy and
    `get_all_frames` the matrix. For pipelines prefer `frame_signal`."""

    def __init__(self, signal, spec: FrameSpec, device=None) -> None:
        self.spec = spec
        x = _device.place(signal, device, torch.float32)
        if x.ndim != 1:
            raise ValueError("FrameQueue takes a 1-D signal")
        self._frames = frame_signal(x, spec).contiguous()

    def __len__(self) -> int:
        return self._frames.shape[0]

    @property
    def num_frames(self) -> int:
        return self._frames.shape[0]

    def get_frame(self, i: int) -> torch.Tensor:
        if not 0 <= i < len(self):
            raise IndexError(f"frame {i} out of range [0, {len(self)})")
        return self._frames[i]

    def copy_frame(self, i: int) -> torch.Tensor:
        return self.get_frame(i).clone()

    def get_all_frames(self) -> torch.Tensor:
        return self._frames


def aos_to_soa(interleaved, channels: int, device=None) -> torch.Tensor:
    """Deinterleave AoS samples [frames*channels] -> SoA [channels, frames]
    (channel-major, contiguous)."""
    flat = _device.place(interleaved, device)
    if flat.ndim != 1 or flat.numel() % channels != 0:
        raise ValueError(
            f"interleaved length {tuple(flat.shape)} not divisible by "
            f"{channels}"
        )
    return flat.reshape(-1, channels).t().contiguous()


def soa_to_aos(soa, device=None) -> torch.Tensor:
    """Interleave SoA [channels, frames] -> AoS [frames*channels]."""
    x = _device.place(soa, device)
    if x.ndim != 2:
        raise ValueError("soa must be 2-D [channels, frames]")
    return x.t().contiguous().reshape(-1)
