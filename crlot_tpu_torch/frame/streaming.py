"""Streaming framer: a host-side stream chunker that hands out frames.

Counterpart of `crlot_tpu/frame/streaming.py`, a real-time push/pop framer
over an internal compacting buffer. The buffer is host plumbing (it moves
bytes, not FLOPs), so it stays a numpy array; only the frames it hands out
go to the device. Semantics kept exactly:

  - available-frame law `floor((N - frame)/hop) + 1`,
  - BoundaryMode.ZERO_PAD allows one zero-filled partial frame on flush,
    DROP refuses partials,
  - the read cursor advances by hop per pop,
  - geometric buffer growth, and compaction once the read cursor passes
    half the buffer.

`pop` returns one [channels, frame_size] frame and `pop_batch` a
[frames, channels, frame_size] batch in one transfer, as float32 tensors
on `device` (default "cuda", which raises without a card; `core/device.py`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import device as _device
from ..core.types import BoundaryMode


class Framer:
    def __init__(
        self,
        frame_size: int,
        hop_size: int,
        channels: int = 1,
        boundary: BoundaryMode = BoundaryMode.ZERO_PAD,
        device=None,
    ) -> None:
        if frame_size <= 0 or hop_size <= 0 or channels <= 0:
            raise ValueError(
                "frame_size, hop_size and channels must all be > 0 "
                f"(got {frame_size}, {hop_size}, {channels})"
            )
        self.frame_size = frame_size
        self.hop_size = hop_size
        self.channels = channels
        self.boundary = boundary
        self.device = _device.resolve_indexed(device)
        self._buf = np.zeros(frame_size * channels * 4, dtype=np.float32)
        self._read = 0  # in samples-per-channel units (frame positions)
        self._write = 0
        self._flushed = False

    # --- buffer management ---

    def _ensure_capacity(self, extra: int) -> None:
        need = (self._write + extra) * self.channels
        if need <= self._buf.size:
            return
        new_size = self._buf.size
        while new_size < need:
            new_size *= 2
        buf = np.zeros(new_size, dtype=np.float32)
        used = self._write * self.channels
        buf[:used] = self._buf[:used]
        self._buf = buf

    def _compact(self) -> None:
        if self._read * self.channels * 2 < self._buf.size:
            return
        n = (self._write - self._read) * self.channels
        self._buf[:n] = self._buf[
            self._read * self.channels : self._write * self.channels
        ]
        self._write -= self._read
        self._read = 0

    # --- push / pop ---

    def push(self, interleaved) -> None:
        """Append interleaved samples; length must be a multiple of channels.
        A tensor is read back to the host."""
        if self._flushed:
            raise RuntimeError("cannot push after flush()")
        if isinstance(interleaved, torch.Tensor):
            interleaved = interleaved.detach().cpu().numpy()
        data = np.asarray(interleaved, dtype=np.float32).reshape(-1)
        if data.size % self.channels != 0:
            raise ValueError(
                f"pushed {data.size} samples is not a multiple of "
                f"channels={self.channels}"
            )
        n = data.size // self.channels
        self._ensure_capacity(n)
        w = self._write * self.channels
        self._buf[w : w + data.size] = data
        self._write += n

    def flush(self) -> None:
        """Mark the end of the stream: in ZERO_PAD mode one trailing
        partial frame becomes poppable (zero-filled tail)."""
        self._flushed = True

    @property
    def buffered(self) -> int:
        """Unread samples per channel in the buffer."""
        return self._write - self._read

    def available(self) -> int:
        """Poppable full frames, floor((N - frame)/hop) + 1, plus one padded
        partial after flush in ZERO_PAD mode."""
        n = self.buffered
        full = ((n - self.frame_size) // self.hop_size + 1
                if n >= self.frame_size else 0)
        if (
            self._flushed
            and self.boundary == BoundaryMode.ZERO_PAD
            and n - full * self.hop_size > 0
        ):
            full += 1
        return max(full, 0)

    def _pop_into(self, out: np.ndarray) -> None:
        """Deinterleave the next frame into out [channels, frame_size]
        (zeros past a flushed partial tail) and advance the cursor."""
        have = min(self.buffered, self.frame_size)
        r = self._read * self.channels
        chunk = self._buf[r : r + have * self.channels].reshape(
            have, self.channels)
        out[:, :have] = chunk.T
        if have < self.frame_size:
            # A flushed ZERO_PAD partial is the last frame: consume the tail.
            self._read = self._write
        else:
            self._read += self.hop_size
        self._compact()

    def pop(self) -> Optional[torch.Tensor]:
        """Pop one frame as [channels, frame_size] (deinterleaved), or None.
        ZERO_PAD zero-fills a flushed partial tail; DROP refuses partials."""
        if self.available() <= 0:
            return None
        out = np.zeros((self.channels, self.frame_size), dtype=np.float32)
        self._pop_into(out)
        return torch.from_numpy(out).to(self.device)

    def pop_batch(self, max_frames: Optional[int] = None) -> torch.Tensor:
        """Pop up to `max_frames` frames at once as [frames, channels,
        frame_size], one transfer to the device."""
        n = self.available()
        if max_frames is not None:
            n = min(n, max_frames)
        frames = np.zeros((n, self.channels, self.frame_size),
                          dtype=np.float32)
        for i in range(n):
            self._pop_into(frames[i])
        return torch.from_numpy(frames).to(self.device)

    def reset(self) -> None:
        self._read = 0
        self._write = 0
        self._flushed = False
        self._buf[:] = 0.0
