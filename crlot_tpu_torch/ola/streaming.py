"""Streaming overlap-add accumulator: a bounded ring drained through B5's K6.

Counterpart of `crlot_tpu/ola/streaming.py`. The reference writes the ring
with one scatter-add and drains it with a gather, divide and clear; the
port goes back to the design those ops replaced: a frame, and a drain,
touch at most two contiguous spans of the ring (the wrap splits them).

* Add: `vals = frames * gain`, then `vals * window`, each rounded to f32
  (the reference's scatter-add is not contracted into a fused multiply-add
  on the CPU: measured bit-equal to two roundings), then one `add_` a span.
  A slot receives one add a frame, so the sums do not depend on the device.
* Drain: each span goes through `ola.kernels.normalize_and_clear` as one
  contiguous [C, n] operand beside the norm expanded over the channels (on
  the card, B5's K6 kernel: `acc / max(norm, eps)`, exactly the
  reference's drain), and the span is zeroed in place, the bits of K6's
  clear.
* Cursors: `read_pos`, `produced` and `flushed` are host values, so
  `available()` costs no device sync. The class renormalizes them by ring
  multiples before they leave int32, as the reference does, so a checkpoint
  holds the reference's values in its dtypes (`checkpoint.py`).

`produce` only releases samples whose every overlapping frame has been
received; `flush` releases the tail. The ring is updated in place (the
reference donates it to each call).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import device as _device
from ..core.types import OLAConfig
from . import kernels as _kernels
from .norm import build_norm_linear


class OLAStreamState(NamedTuple):
    ring: torch.Tensor  # f32 [channels, ring_len] accumulation canvas
    read_pos: int  # absolute sample cursor of the next drain
    produced: int  # absolute high-water mark of written samples
    flushed: bool  # tail-release flag


def ola_init(cfg: OLAConfig, device=None) -> OLAStreamState:
    """An empty ring on `device` (default "cuda"; `core/device.py`)."""
    ring = torch.zeros((cfg.channels, cfg.ring_len), dtype=torch.float32,
                       device=_device.resolve(device))
    return OLAStreamState(ring, 0, 0, False)


def make_norm_ring(cfg: OLAConfig, window: Optional[np.ndarray]) -> np.ndarray:
    """Normalization ring: all ones when no window is applied inside, else
    the full-coverage COLA sum."""
    if window is None or not cfg.apply_window_inside:
        return np.ones(cfg.ring_len, dtype=np.float32)
    return build_norm_linear(window, cfg.ring_len, cfg.frame_size,
                             cfg.hop_size)


def _spans(start: int, count: int, ring_len: int) -> list:
    """[(ring_lo, ring_hi, offset)]: ring positions start .. start+count-1
    (mod ring_len) as at most two contiguous spans, each with the offset of
    its first sample in the run."""
    lo = start % ring_len
    first = min(count, ring_len - lo)
    spans = [(lo, lo + first, 0)] if first > 0 else []
    if count > first:
        spans.append((0, count - first, first))
    return spans


def ola_add_frame(
    state: OLAStreamState,
    frames: torch.Tensor,  # f32 [channels, frame_size] on the ring's device
    start_sample: int,
    window: Optional[torch.Tensor],  # f32 [frame_size] or None
    cfg: OLAConfig,
    gain: float = 1.0,
    start_off: int = 0,
    size: Optional[int] = None,
) -> OLAStreamState:
    """Accumulate one (possibly partial) windowed frame into the ring:
    position start_sample + i receives frames[:, start_off + i] * gain *
    window[start_off + i] for i in [0, size); size defaults to frame_size -
    start_off and is clamped to it."""
    n = cfg.frame_size
    size = n - start_off if size is None else min(size, n - start_off)
    if size > 0:
        vals = frames[:, start_off : start_off + size] * _kernels._f32(gain)
        if window is not None:
            vals = vals * window[start_off : start_off + size]
        ring = state.ring
        for lo, hi, off in _spans(start_sample, size, cfg.ring_len):
            ring[:, lo:hi].add_(vals[:, off : off + hi - lo])
    return state._replace(produced=max(state.produced, start_sample + size))


def ola_available(state: OLAStreamState, cfg: OLAConfig) -> int:
    """Samples safe to drain: written and no longer awaiting overlaps."""
    tail = cfg.frame_size - cfg.hop_size
    safe_end = state.produced if state.flushed else state.produced - tail
    return max(safe_end - state.read_pos, 0)


def _drain(state: OLAStreamState, norm_ring: torch.Tensor, cfg: OLAConfig,
           count: int):
    """(state, out [channels, count]): the next `count` samples divided by
    max(norm, eps), their slots cleared; one K6 launch a span."""
    ring = state.ring
    outs = []
    for lo, hi, _ in _spans(state.read_pos, count, cfg.ring_len):
        acc = ring[:, lo:hi].contiguous()
        nrm = norm_ring[lo:hi].expand(ring.shape[0], hi - lo).contiguous()
        outs.append(_kernels.normalize_and_clear(acc, nrm, cfg.eps)[0])
        ring[:, lo:hi].zero_()
    if not outs:
        out = ring.new_zeros((ring.shape[0], 0))
    else:
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return state._replace(read_pos=state.read_pos + count), out


def ola_produce(
    state: OLAStreamState,
    norm_ring: torch.Tensor,  # f32 [ring_len] on the ring's device
    cfg: OLAConfig,
    n: int,
):
    """Drain up to `n` samples: out = ring / max(norm, eps), the drained
    slots zeroed. Returns (state, out f32 [channels, n], count); out[:,
    count:] is zeros."""
    count = min(ola_available(state, cfg), n)
    state, out = _drain(state, norm_ring, cfg, count)
    if count < n:
        out = torch.nn.functional.pad(out, (0, n - count))
    return state, out, count


def ola_flush(state: OLAStreamState) -> OLAStreamState:
    """Release the overlap tail for draining."""
    return state._replace(flushed=True)


class OLAAccumulator:
    """Stateful accumulator with the reference class's API: set_window /
    add_frame_soa / push_frame_aos / produce / flush / reset and a peak
    meter over channel 0. Numpy frames go to `device` (default "cuda";
    `core/device.py`), where the ring lives; `produce` returns a tensor
    there.

    This is the API-parity layer, bound by the host: each call is a few
    small launches. Batched paths (`pipeline.round_trip`, the streamers)
    are the throughput paths."""

    def __init__(self, cfg: OLAConfig, device=None) -> None:
        self.cfg = cfg
        self.device = _device.resolve_indexed(device)
        self._window: Optional[np.ndarray] = None
        self._window_t: Optional[torch.Tensor] = None
        self._norm = self._norm_on(None)
        self._state = ola_init(cfg, self.device)
        self._peak = torch.zeros((), dtype=torch.float32, device=self.device)
        self._cursor_shift = 0  # host-side absolute offset (overflow guard)

    def _norm_on(self, window) -> torch.Tensor:
        return torch.tensor(make_norm_ring(self.cfg, window),
                            device=self.device)

    def _tensor(self, a) -> torch.Tensor:
        """float32 on the accumulator's device: a tensor must already be
        there, an array-like goes there."""
        if isinstance(a, torch.Tensor):
            if a.device != self.device:
                raise ValueError(f"tensor on {a.device}, the accumulator on "
                                 f"{self.device}")
            return a.float()
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=self.device)

    # --- configuration ---

    def set_window(self, window) -> None:
        if isinstance(window, torch.Tensor):
            window = window.detach().cpu().numpy()
        w = np.asarray(window, dtype=np.float32)
        if w.shape != (self.cfg.frame_size,):
            raise ValueError(
                f"window length {w.shape} != frame_size "
                f"({self.cfg.frame_size},)"
            )
        self._window = w
        self._window_t = torch.tensor(w, device=self.device)
        self._norm = self._norm_on(w)

    @property
    def window(self) -> Optional[np.ndarray]:
        return self._window

    # --- accumulate ---

    def _effective_window(self, window) -> Optional[torch.Tensor]:
        # Inside-config uses the internal copy; otherwise the caller's, or
        # none.
        if self.cfg.apply_window_inside:
            return self._window_t
        return None if window is None else self._tensor(window)

    def add_frame_soa(
        self,
        ch_frames,  # [channels, frame_size] (SoA)
        start_sample: int,
        start_off: int = 0,
        size: Optional[int] = None,
        gain: float = 1.0,
        window=None,
    ) -> None:
        frames = self._tensor(ch_frames)
        if tuple(frames.shape) != (self.cfg.channels, self.cfg.frame_size):
            raise ValueError(
                f"frames shape {tuple(frames.shape)} != "
                f"({self.cfg.channels}, {self.cfg.frame_size})"
            )
        if size is None:
            size = self.cfg.frame_size - start_off
        size = min(size, self.cfg.frame_size - start_off)
        start_sample -= self._cursor_shift  # caller-absolute -> state frame
        read_pos = self._state.read_pos
        if start_sample + size - read_pos > self.cfg.ring_len:
            raise ValueError(
                "frame overruns the ring: drain with produce() first "
                f"(start={start_sample}, size={size}, "
                f"read_pos={read_pos}, ring_len={self.cfg.ring_len})"
            )
        self._state = ola_add_frame(
            self._state, frames, start_sample, self._effective_window(window),
            self.cfg, gain=gain, start_off=start_off, size=size,
        )

    def push_frame_aos(
        self,
        interleaved,  # [frame_size * channels] interleaved
        start_sample: int,
        gain: float = 1.0,
        window=None,
    ) -> None:
        """AoS entry: deinterleave, then the SoA path."""
        flat = self._tensor(interleaved).reshape(
            self.cfg.frame_size, self.cfg.channels)
        self.add_frame_soa(flat.t(), start_sample, gain=gain, window=window)

    # --- drain ---

    def produce(self, n: int) -> torch.Tensor:
        """Drain up to n ready samples -> [channels, count] on the device."""
        count = min(ola_available(self._state, self.cfg), n)
        self._state, result = _drain(self._state, self._norm, self.cfg, count)
        if count:
            self._peak = torch.fmax(self._peak, result[0].abs().max())
        # Renormalize the absolute cursors before they leave int32 (~12 h at
        # 48 kHz): a shift by a ring multiple keeps every ring index and the
        # produced - read_pos difference.
        read_pos = self._state.read_pos
        if read_pos > (1 << 30):
            shift = (read_pos // self.cfg.ring_len) * self.cfg.ring_len
            self._state = self._state._replace(
                read_pos=read_pos - shift,
                produced=self._state.produced - shift,
            )
            self._cursor_shift += shift
        return result

    def available(self) -> int:
        return ola_available(self._state, self.cfg)

    def flush(self) -> None:
        self._state = ola_flush(self._state)

    # --- checkpoint ---

    @property
    def state(self) -> OLAStreamState:
        return self._state

    def load_state(self, state: OLAStreamState) -> None:
        """Resume from a state (`checkpoint.load_stream_state`): its ring is
        copied to the accumulator's device."""
        ring = torch.as_tensor(state.ring, dtype=torch.float32)
        if tuple(ring.shape) != (self.cfg.channels, self.cfg.ring_len):
            raise ValueError(f"ring shape {tuple(ring.shape)} != "
                             f"({self.cfg.channels}, {self.cfg.ring_len})")
        self._state = OLAStreamState(
            ring.to(self.device, copy=True), int(state.read_pos),
            int(state.produced), bool(state.flushed))

    def reset(self) -> None:
        """Zero the ring, cursors and meter, and drop the window."""
        self._state = ola_init(self.cfg, self.device)
        self._window = None
        self._window_t = None
        self._norm = self._norm_on(None)
        self._peak = torch.zeros((), dtype=torch.float32, device=self.device)
        self._cursor_shift = 0

    @property
    def meter_peak(self) -> float:
        return float(self._peak)
