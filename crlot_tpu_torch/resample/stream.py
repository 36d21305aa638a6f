"""Polyphase resampling of a stream fed in pieces: B4 with the history
carried from feed to feed.

`PolyphaseStreamer` takes a `[C, T]` stream in feeds of any length. Each
feed returns the outputs of one-shot `resample` over the whole stream whose
taps all lie inside the input fed so far; `finish` returns the rest, with
the one-shot's zero padding past the end. Output j of the rate L/M reads
input samples s_j .. d_j, where d_j = floor((j*M + h0) / L) and s_j = d_j -
(tp - 1) (h0 the filter's centre, tp its taps a phase: the runs of
`kernel.compact_bank`), so it is complete once d_j < T.

A feed joins the carried history and the new input in one contiguous
buffer and launches B4 once on it (`polyphase._resample_impl`: B4 through
`kernel.resample_cuda`, with `geometry`'s tile, on a CUDA tensor; on a CPU
tensor the grouped product that `resample` runs there). The buffer starts
at stream sample P, a multiple of M, so its local output 0 is stream
output P*L/M, of the same polyphase phase. B4 sums every output in one
ascending order wherever it sits, so on the card each output is the
one-shot's bit for bit. P is the multiple of M at or before the first
sample of the first pending output: the history is at most W + M samples
(W the bank's width), and the outputs B4 computes again before the first
pending one, about (tp / 2 + M) * L / M of them, are dropped.
"""

from __future__ import annotations

import torch

from ..core import device as _device
from . import kernel, polyphase


class PolyphaseStreamer:
    """One polyphase stage, sr_in -> sr_out, over a stream of `channels`
    rows on `device` (default "cuda"). `feed(x)` takes `[C, T]` float
    input (an array-like goes to the stream's device; a tensor must lie
    there) and returns the `[C, n]` outputs it completed; `finish(x=None)`
    feeds `x`, then returns every output left, and ends the stream.
    `join_bytes` is what the last call wrote besides its outputs: the join
    of history and input, and the history kept from it (a copy, so that
    the join is freed).
    """

    def __init__(self, sr_in: int, sr_out: int, channels: int, device=None,
                 taps_per_phase: int | None = None,
                 atten_db: float = 120.0) -> None:
        self.l, self.m = polyphase._rate(sr_in, sr_out)
        if channels < 1:
            raise ValueError(f"channels must be >= 1, got {channels}")
        self.channels = int(channels)
        self.device = _device.resolve_indexed(device)
        self.taps_per_phase, self.atten_db = taps_per_phase, float(atten_db)
        n_h = len(polyphase.design_lowpass(self.l, self.m, taps_per_phase,
                                           self.atten_db))
        self.h0, self.tp = (n_h - 1) // 2, -(-n_h // self.l)
        self.fed = 0  # input samples taken
        self.emitted = 0  # outputs returned
        self.start = 0  # stream sample of history[:, 0], a multiple of M
        self.history = torch.zeros((self.channels, 0), device=self.device)
        self.join_bytes = 0
        self._finished = False

    def tile(self):
        """B4's tile for the rate (`kernel.geometry`, with the bank and the
        runs table it reads, all looked up once built), or None where the
        plain version runs: on the CPU, or at L == M (nothing to do)."""
        if self.device.type == "cpu" or self.l == self.m:
            return None
        return kernel.geometry(self.l, self.m, self.taps_per_phase,
                               self.atten_db)

    def _last_tap(self, j: int) -> int:
        return (j * self.m + self.h0) // self.l

    def _complete(self, t: int) -> int:
        """How many outputs have their last tap before input sample t."""
        return max(0, (t * self.l - 1 - self.h0) // self.m + 1)

    def _start_for(self, j: int) -> int:
        """The buffer's start for pending output j: a multiple of M at or
        before its first sample and at or before j*M/L (so that its local
        index is >= 0), and at or before the end of the input."""
        first = self._last_tap(j) - (self.tp - 1)
        p = min(first, j * self.m // self.l, self.fed) // self.m * self.m
        return max(0, p)

    def _place(self, x) -> torch.Tensor:
        if self._finished:
            raise RuntimeError("feed() after finish(): start a new "
                               "PolyphaseStreamer")
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(f"input on {x.device}, the stream on "
                                 f"{self.device}")
            x = x.float()
        else:
            x = _device.place(x, self.device, torch.float32)
        if x.ndim != 2 or x.shape[0] != self.channels:
            raise ValueError(f"expected [{self.channels}, T], got "
                             f"{tuple(x.shape)}")
        return x

    def _join(self, x) -> torch.Tensor:
        """The history followed by `x` (placed; None: nothing), in one new
        contiguous buffer."""
        x = self.history[:, :0] if x is None else self._place(x)
        buf = torch.cat([self.history, x], dim=-1)
        self.join_bytes = buf.numel() * buf.element_size()
        self.fed += x.shape[-1]
        return buf

    def _emit(self, buf: torch.Tensor, j_end: int) -> torch.Tensor:
        """Outputs [emitted, j_end) from `buf` (stream samples [start,
        fed)); keeps the history the next pending output needs."""
        base = self.start // self.m * self.l
        if j_end > self.emitted:
            y = polyphase._resample_impl(buf, self.l, self.m, j_end - base,
                                         self.taps_per_phase, self.atten_db)
            y = y[:, self.emitted - base:]
            self.emitted = j_end
        else:
            y = buf[:, :0]
        start = self._start_for(self.emitted)
        self.history = buf[:, start - self.start:].clone()
        self.join_bytes += self.history.numel() * self.history.element_size()
        self.start = start
        return y

    def feed(self, x) -> torch.Tensor:
        """Take `x` [C, T]; return the `[C, n]` outputs now complete (n may
        be 0: no launch then)."""
        if self.l == self.m:
            x = self._place(x)
            self.fed += x.shape[-1]
            self.emitted = self.fed
            return x
        buf = self._join(x)
        return self._emit(buf, self._complete(self.fed))

    def finish(self, x=None) -> torch.Tensor:
        """Feed `x` (if given), then return every output left of the
        one-shot's ceil(T*L/M), reading zeros past the end; ends the
        stream."""
        if self._finished:
            raise RuntimeError("finish() after finish()")
        if self.l == self.m:
            y = self.history if x is None else self.feed(x)
        else:
            buf = self._join(x)
            y = self._emit(buf, -(-self.fed * self.l // self.m))
        self._finished = True
        self.history = None
        return y
