"""Unbounded-length sharded streaming: chunk-level overlap-save on a mesh.

Counterpart of `crlot_tpu/distributed/stream.py` (BASELINE.json config 5:
hour-long multi-channel streams, time blocks sharded over the mesh). A
stream of any length runs in fixed-shape chunks, each extended with
`L_ctx >= frame_size` samples of real context on both sides, so every
kept output sample sees its full frame coverage. The kept regions tile the
stream, and the result equals one `sharded_round_trip` over the whole
stream wherever that route's products do not depend on the batch they sit
in (B3 and B0 on the card, `torch.fft` and the seeded OLA), while memory
stays O(chunk).

* `sharded_stream` (the array form) runs the masked frame formulation
  for every chunk (`allow_blocked=False`), as the reference does.
* `ShardedStreamer` and `sharded_stream_iter` run the blocked
  formulation when its gate holds at the halo-extended chunk shape
  (`_blocked_stream_mode`): every chunk is the full-validity blocked mesh
  program, and the stream's head and tail chunks overwrite their edge
  samples with the one-shot's phantom-frame patches, computed per channel
  group on the same device and at the same shapes as the one-shot's edge
  shards, so they are the same bits. Otherwise the masked formulation.

Chunks go to the device once (numpy to `device`, default "cuda";
`core/device.py`; to a card through pinned host memory, so that the copy
does not wait for the chunks in flight) and the context is concatenated
there. The streamer's state (`state` / `load_state`) is the reference's
dict of numpy arrays, so a checkpoint written by either package resumes in
the other.

On a mesh that spans processes (`multihost.global_mesh`) every rank feeds
the same whole chunks, as every process of the reference passes the whole
host array, and computes the shards it holds; `feed(force=False)` returns
the chunk's `GlobalArray` without a sync, and `force=True` gathers it
(`process_allgather`) on every rank. Every rank holds the whole input
chunks, so `state()` is the same on every rank and needs no collective, and
a state saved on one process (or by the reference) loads on every rank.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..core import device as _device
from ..core.types import StftConfig
from ..fft.matmul_backend import blocked_edge_patch, blocked_patch_span
from ..pipeline import _norm_np, _window_f64
from ..profiling import span
from ..streaming_pipeline import _resolve_blocked_per_bin
from .mesh import CHANNEL_AXIS, TIME_AXIS, Mesh, auto_mesh
from .sharded_pipeline import (
    GlobalArray,
    blocked_per_bin,
    process_allgather,
    sharded_round_trip,
)


def _ctx_len(cfg: StftConfig, n_time: int) -> int:
    """Context on each side of a chunk: frame_size rounded up to a
    multiple of n_time * hop (every shard stays hop-aligned)."""
    unit = n_time * cfg.hop_size
    return -(-cfg.frame_size // unit) * unit


def _pinned_place(a: np.ndarray, device) -> torch.Tensor:
    """A host array on `device` (default "cuda"): to a card through a
    pinned host copy and a copy that does not block the host, so it queues
    behind the chunks in flight without waiting for them (the host's pinned
    allocator keeps the buffer until the copy is done)."""
    dev = _device.resolve(device)
    if dev.type != "cuda":
        return torch.as_tensor(a, device=dev)
    host = torch.empty(a.shape, dtype=torch.float32, pin_memory=True)
    host.numpy()[...] = a
    return host.to(dev, non_blocking=True)


def _blocked_stream_mode(cfg: StftConfig, mesh: Mesh, spectral_fn,
                         s: int) -> Optional[dict]:
    """The blocked formulation's constants for a stream of [C, s] chunks on
    `mesh`, or None when its gate does not hold: the one-shot's
    `blocked_per_bin` gate at the halo-extended chunk shape, and chunks
    long enough that the head and tail patches never overlap."""
    n, hop = cfg.frame_size, cfg.hop_size
    n_time = mesh.shape[TIME_AXIS]
    ext = s + 2 * _ctx_len(cfg, n_time)
    edge = n - hop
    if s < 2 * edge + n:
        return None
    rb = _resolve_blocked_per_bin(cfg, spectral_fn)
    if rb is None:
        return None
    nf = (ext - n) // hop + 1
    if blocked_per_bin(cfg, spectral_fn, t_block=ext // n_time,
                       num_frames=nf) is None:
        return None
    # The edge norms do not depend on the frame count: a reference count
    # stands in for the unknown stream length.
    r = n // hop
    nf_ref = 2 * (r - 1) + 2
    span_ref = (nf_ref - 1) * hop + n
    norm_ref = _norm_np(cfg, nf_ref, span_ref)
    wb = np.ascontiguousarray(_window_f64(cfg), np.float64).tobytes()
    return {
        "rb": rb,
        "wb": wb,
        "sb": wb if cfg.synthesis_window else None,
        "head_norm": np.asarray(norm_ref[:edge], np.float32),
        "tail_norm": np.asarray(norm_ref[span_ref - edge :], np.float32),
    }


def sharded_stream(
    x,  # [channels, T], any length
    cfg: StftConfig,
    mesh: Optional[Mesh] = None,
    chunk_samples: int = 1 << 20,
    spectral_fn: Optional[Callable] = None,
    device=None,
):
    """Process a long stream chunk by chunk on the mesh; returns [C, T].

    A numpy (or other array-like) input goes to `device` (default "cuda")
    and the result comes back as numpy, as in the reference; a tensor stays
    on its own device and the result is a tensor on the mesh's first
    device."""
    if mesh is None:
        mesh = auto_mesh()
    as_numpy = not isinstance(x, torch.Tensor)
    x = _device.place(x, device, torch.float32)
    n_time = mesh.shape[TIME_AXIS]
    n_ch = mesh.shape[CHANNEL_AXIS]
    n, hop = cfg.frame_size, cfg.hop_size
    channels, total = x.shape
    if channels % n_ch != 0:
        raise ValueError(f"channels ({channels}) % mesh channel ({n_ch}) != 0")
    unit = n_time * hop
    s = max(chunk_samples // unit, 1) * unit
    if s // n_time < n:
        s = -(-n * n_time // unit) * unit  # every block >= frame
    l_ctx = _ctx_len(cfg, n_time)
    ext = s + 2 * l_ctx

    out = None
    for start in range(0, total, s):
        ext_start = start - l_ctx
        buf = x.new_zeros((channels, ext))
        lo = max(0, ext_start)
        hi = min(total, ext_start + ext)
        if hi > lo:
            buf[:, lo - ext_start : hi - ext_start] = x[:, lo:hi]
        valid = int(np.clip(total - ext_start, 0, ext))
        y = sharded_round_trip(
            buf, cfg, mesh, spectral_fn,
            valid_len=valid,
            valid_start=max(0, -ext_start),  # first chunk: the stream head
            allow_blocked=False,  # one formulation for every chunk
        )
        y = process_allgather(y)
        if out is None:
            out = torch.zeros((channels, total), dtype=torch.float32,
                              device=y.device)
        keep = min(s, total - start)
        out[:, start : start + keep] = y[:, l_ctx : l_ctx + keep]
    if out is None:
        out = torch.zeros_like(x)
    return out.cpu().numpy() if as_numpy else out


class ShardedStreamer:
    """Resumable chunk streamer over the mesh.

    Feed equal-shape hop-aligned [C, S] chunks with `feed()`, which returns
    the reconstructed PREDECESSOR chunk (one chunk of latency: the context
    refeed needs the successor's head), and drain the last chunk with
    `finish()`. The carried state -- the previous chunk, the one before it
    (whose tail is the left context) and the stream-head flag -- is a dict
    of numpy arrays (`state()` / `load_state()`), so a multi-hour stream
    can checkpoint mid-flight and resume in a fresh process with identical
    output. Numpy chunks go to `device` (default "cuda"); tensor chunks
    stay on their device."""

    def __init__(
        self,
        cfg: StftConfig,
        mesh: Optional[Mesh] = None,
        spectral_fn: Optional[Callable] = None,
        allow_blocked: bool = True,
        device=None,
    ) -> None:
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else auto_mesh()
        self.spectral_fn = spectral_fn
        self.allow_blocked = allow_blocked
        self._device = device
        self._n_time = self.mesh.shape[TIME_AXIS]
        self._l_ctx = _ctx_len(cfg, self._n_time)
        self._prev: Optional[torch.Tensor] = None  # previous chunk
        self._tail: Optional[torch.Tensor] = None  # the chunk before that
        self._first = True  # the next processed chunk is the stream head
        self._s: Optional[int] = None
        self._finished = False  # finish() ends the stream; feed() raises
        self._mode: Optional[dict] = None  # blocked-mode constants, or None

    @property
    def blocked(self) -> bool:
        """Whether the stream runs the blocked formulation (known after the
        first chunk)."""
        return self._mode is not None

    def _place(self, chunk) -> torch.Tensor:
        if isinstance(chunk, torch.Tensor):
            t = chunk.float()
        else:
            t = _pinned_place(np.asarray(chunk, np.float32), self._device)
        if self._prev is not None and t.device != self._prev.device:
            raise ValueError(f"chunk on {t.device}, the stream on "
                             f"{self._prev.device}")
        return t

    def _patch(self, y, ext, rows, c: int, side: str) -> None:
        """Overwrite channel group c's head (or tail) edge samples of the
        chunk output `y` with the one-shot's patch, made on the device of
        the one-shot's edge shard at its shapes (across processes, on a
        device of the rank that holds them: the mesh's devices are of one
        kind)."""
        mode, cfg = self._mode, self.cfg
        n, hop = cfg.frame_size, cfg.hop_size
        edge, span_p = n - hop, blocked_patch_span(n, hop)
        l_ctx, s = self._l_ctx, ext.shape[1] - 2 * self._l_ctx
        b = l_ctx if side == "head" else l_ctx + s - edge
        if isinstance(y, GlobalArray):
            if not y.holds(c, b, b + edge):
                return
            dev = self.mesh.local_device()
        else:
            dev = self.mesh.device(c, 0 if side == "head"
                                   else self._n_time - 1)
        a = l_ctx if side == "head" else l_ctx + s - span_p
        with span("crlot.stream.patch", side=side, row=c):
            p = blocked_edge_patch(ext[rows, a : a + span_p].to(dev), n, hop,
                                   mode["wb"], mode["sb"], mode["rb"], side,
                                   cfg.fft_precision, fixed_order=True)
            norm = torch.from_numpy(mode[side + "_norm"]).to(dev)
            p = p / torch.clamp_min(norm, cfg.eps)
            if isinstance(y, GlobalArray):
                y.write(c, b, p)
            else:
                y[rows, b : b + edge] = p.to(y.device)

    def _process(self, left, mid, right, valid_from_mid, is_tail=False):
        l_ctx = self._l_ctx
        with span("crlot.stream.context"):
            ext = torch.cat([left[:, -l_ctx:], mid, right[:, :l_ctx]], dim=1)
        s = mid.shape[1]
        if self._mode is not None:
            # Blocked: the full-validity mesh program for every chunk (the
            # context makes the kept rows read what the one-shot's rows
            # read; the in-mesh phantom patches land in the discarded
            # context), then the stream's edge patches on its head and
            # tail chunks.
            y = sharded_round_trip(ext, self.cfg, self.mesh,
                                   self.spectral_fn)
            c_local = ext.shape[0] // self.mesh.shape[CHANNEL_AXIS]
            for c in range(self.mesh.shape[CHANNEL_AXIS]):
                rows = slice(c * c_local, (c + 1) * c_local)
                if self._first:
                    self._patch(y, ext, rows, c, "head")
                if is_tail:
                    self._patch(y, ext, rows, c, "tail")
        else:
            # Masked frames for every chunk: one formulation keeps chunked
            # == one-shot.
            y = sharded_round_trip(
                ext, self.cfg, self.mesh, self.spectral_fn,
                valid_len=l_ctx + valid_from_mid,
                valid_start=l_ctx if self._first else 0,
                allow_blocked=False,
            )
        self._first = False
        with span("crlot.stream.slice"):
            if isinstance(y, GlobalArray):
                return y.window(l_ctx, l_ctx + s)
            return y[:, l_ctx : l_ctx + s]

    @staticmethod
    def _out(out, force: bool):
        return process_allgather(out).cpu().numpy() if force else out

    def feed(self, chunk, force: bool = True):
        """Feed one [C, S] chunk; returns the reconstructed PREDECESSOR
        chunk, or None on the first call: numpy with `force=True`, else the
        tensor on the mesh's first device (a `GlobalArray` on a mesh that
        spans processes), without a sync (the caller overlaps its own work
        with the chunk's).

        While a profiler records, a feed is the span `crlot.stream.feed`
        (its `rows`, `chunk` and `mode`, and the constants it built and
        kernels it launched) over `crlot.stream.place`, and for a chunk
        it completes `crlot.stream.context`, `crlot.sharded.round_trip`,
        `crlot.stream.patch` on the stream's head and tail and
        `crlot.stream.slice` (`profiling.span`)."""
        if self._finished:
            raise RuntimeError(
                "feed() after finish(): the stream has ended; create a new "
                "ShardedStreamer (or load_state a checkpoint) to continue"
            )
        with span("crlot.stream.feed") as call:
            out = self._feed(chunk, force)
            if call:
                call.note(rows=self._prev.shape[0], chunk=self._s,
                          mode="blocked" if self.blocked else "masked")
            return out

    def _feed(self, chunk, force: bool):
        with span("crlot.stream.place"):
            chunk = self._place(chunk)
        if self._s is None:
            s = chunk.shape[1]
            unit = self._n_time * self.cfg.hop_size
            if s % unit or s // self._n_time < self.cfg.frame_size:
                raise ValueError(
                    f"chunk length {s} must be a multiple of {unit} "
                    f"with {s}//{self._n_time} >= frame_size "
                    f"({self.cfg.frame_size})"
                )
            self._s = s
            if self.allow_blocked:
                self._mode = _blocked_stream_mode(
                    self.cfg, self.mesh, self.spectral_fn, s)
            self._tail = torch.zeros_like(chunk)
        elif chunk.shape[1] != self._s:
            raise ValueError(
                f"chunk length changed: {chunk.shape[1]} != {self._s}")
        out = None
        if self._prev is not None:
            out = self._out(self._process(
                self._tail, self._prev, chunk, self._s + self._l_ctx), force)
            self._tail = self._prev
        self._prev = chunk
        return out

    def finish(self, force: bool = True):
        """Drain the final buffered chunk (the stream ends); the span
        `crlot.stream.finish`, as `feed` is `crlot.stream.feed`."""
        self._finished = True
        if self._prev is None:
            return None
        with span("crlot.stream.finish") as call:
            if call:
                call.note(rows=self._prev.shape[0], chunk=self._s,
                          mode="blocked" if self.blocked else "masked")
            out = self._process(self._tail, self._prev,
                                torch.zeros_like(self._prev), self._s,
                                is_tail=True)
            self._tail = self._prev
            self._prev = None
            return self._out(out, force)

    def state(self) -> dict:
        """Picklable / npz-able checkpoint of the stream position, with the
        reference's keys."""
        return {
            "prev": None if self._prev is None else self._prev.cpu().numpy(),
            "tail": None if self._tail is None else self._tail.cpu().numpy(),
            "first": self._first,
            "s": self._s,
        }

    def load_state(self, st: dict) -> None:
        """Resume from `state()` (the port's or the reference's); arrays go
        to the streamer's device."""
        self._finished = False  # a restored checkpoint resumes the stream
        self._prev = self._tail = None
        self._prev = None if st["prev"] is None else self._place(st["prev"])
        self._tail = None if st["tail"] is None else self._place(st["tail"])
        self._first = bool(st["first"])
        self._s = None if st["s"] is None else int(st["s"])
        self._mode = (
            _blocked_stream_mode(self.cfg, self.mesh, self.spectral_fn,
                                 self._s)
            if self.allow_blocked and self._s is not None else None
        )


def sharded_stream_iter(
    chunks: Iterator,
    cfg: StftConfig,
    mesh: Optional[Mesh] = None,
    spectral_fn: Optional[Callable] = None,
    device=None,
) -> Iterator[np.ndarray]:
    """Generator for unbounded streams: consumes equal, hop-aligned [C, S]
    chunks and yields the reconstructed [C, S] chunks as numpy, one chunk
    behind."""
    streamer = ShardedStreamer(cfg, mesh, spectral_fn, device=device)
    for chunk in chunks:
        out = streamer.feed(chunk)
        if out is not None:
            yield out
    out = streamer.finish()
    if out is not None:
        yield out
