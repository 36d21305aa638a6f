"""Streaming round-trips, in torch: the blocked chunk streamer and the scan form.

Counterpart of `crlot_tpu/streaming_pipeline.py`.

* `BlockedChunkStreamer` runs the blocked (hop-block Toeplitz) formulation
  on halo-extended chunks: each chunk carries `left_ctx` samples of its
  predecessor and `right_ctx` of its successor
  (`fft.matmul_backend.blocked_chunk_geometry`), so every chunk row is the
  one-shot's row over the same data, and the stream head and tail run the
  one-shot's phantom-frame patches (`blocked_edge_patch`). Concatenated
  output equals `pipeline.blocked_composed_round_trip` over the unbroken
  stream bit for bit wherever the products are independent of the batch
  they sit in: on the card at HIGH (B0, a fixed order per output), and on
  the CPU for the identity; at HIGHEST on the card too (B0's fp32 kernel,
  one fmaf chain per output). One chunk of latency:
  `feed` returns the predecessor.
* `streaming_round_trip_blocks`, `streaming_round_trip` and
  `process_wav_file` stream framed blocks with the overlap-add tail carried
  between calls. Within a call the frames of all blocks go through one
  batched round-trip and ONE overlap-add seeded with the carried tail
  (`overlap_add(init_head=...)`): every output position sums "carry, then
  the frames in ascending order", exactly the sums of a per-block scan, so
  the output is the same for any block size and any chunking of a file.

Array-like input goes to `device=` (default "cuda"; `core/device.py`); a
tensor stays on its own device. No environment knob is read.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from .core import device as _device
from .core.consts import as_f32, const_on, design_cache
from .core.types import FftBackend, FftPrecision, StftConfig, float_tier
from .fft import dispatch as _fft
from .fft import tf32x3
from .fft.fused_rt import roundtrip_of_frames
from .fft.matmul_backend import (
    MAX_MATMUL_NFFT,
    blocked_chunk_geometry,
    blocked_edge_patch,
    blocked_patch_span,
    blocked_runtime_kernel,
    composed_block_supported,
    hopblock_apply,
    irfft_folded_parts,
    rfft_folded_packed,
    roundtrip_composed_matmul,
)
from .ola.norm import build_norm_linear
from .ola.reference import overlap_add
from .pipeline import _synthesis, _window_f64, _window_np, blocked_norm_fold
from .spectral import epilogue_of, resolve_per_bin_response

logger = logging.getLogger("crlot_tpu_torch.streaming")


# ---------------------------------------------------------------------------
# Blocked (hop-block Toeplitz) chunk streaming.
# ---------------------------------------------------------------------------


def _resolve_blocked_per_bin(cfg: StftConfig, spectral_fn) -> Optional[bytes]:
    """Per-bin response bytes for the blocked stream (ones for the
    identity), or None when the spectral fn is not a fixed per-bin
    response."""
    n = cfg.frame_size
    if spectral_fn is None:
        per_bin = np.ones(n // 2 + 1)
    else:
        per_bin = resolve_per_bin_response(spectral_fn, n)
        if per_bin is None:
            return None
    return np.ascontiguousarray(per_bin, np.complex128).tobytes()


@design_cache(16)
def _blocked_stream_consts(cfg: StftConfig, rb: bytes) -> dict:
    """Design-time constants of the blocked chunk program, identical to
    what `pipeline.blocked_composed_round_trip` builds for any stream
    length: the interior and edge COLA norms do not depend on the frame
    count (`pipeline.blocked_norm_fold`), so a reference count stands in
    for the unknown stream length. numpy only."""
    n, hop = cfg.frame_size, cfg.hop_size
    r = n // hop
    geo = blocked_chunk_geometry(n, hop)
    nf_ref = 2 * (r - 1) + 2
    norm_ref, full_ref, edge, fold_ok = blocked_norm_fold(cfg, nf_ref)
    w64 = _window_f64(cfg)
    wb = np.ascontiguousarray(w64, np.float64).tobytes()
    sb = wb if cfg.synthesis_window else None
    norm64 = np.asarray(norm_ref, np.float64)
    per_bin = np.frombuffer(rb, np.complex128)
    tile = None
    if fold_ok:
        # The one-shot's fold: 1/interior-norm into the kernel.
        norm_c = float(norm64[edge])
        rb_kern = np.ascontiguousarray(
            np.asarray(per_bin, np.complex128) / norm_c
        ).tobytes()
    else:
        # Divide-after: the interior norm is hop-periodic, so one [hop]
        # tile reproduces the one-shot's values anywhere in the interior.
        rb_kern = rb
        tile = np.maximum(norm64[edge : edge + hop], cfg.eps).astype(
            np.float32
        )
    kern, mg = blocked_runtime_kernel(n, hop, geo["group"], wb, sb, rb_kern)
    return {
        **geo,
        "kern": kern,
        "kern_t": tf32x3.split_t(kern),  # B0's (hi, lo)
        "wb": wb,
        "sb": sb,
        "interior_norm_tile": tile,
        "head_norm": np.maximum(norm64[:edge], cfg.eps).astype(np.float32),
        "tail_norm": np.maximum(
            norm64[full_ref - edge : full_ref], cfg.eps
        ).astype(np.float32),
    }


@design_cache(8)
def _blocked_consts_on(cfg: StftConfig, rb: bytes, device: torch.device):
    c = _blocked_stream_consts(cfg, rb)
    tile = c["interior_norm_tile"]
    return {
        "kern": torch.from_numpy(c["kern"]).to(device),
        "bt": tuple(torch.from_numpy(a).to(device) for a in c["kern_t"]),
        "tile": None if tile is None else as_f32(tile, device),
        "head_norm": as_f32(c["head_norm"], device),
        "tail_norm": as_f32(c["tail_norm"], device),
    }


def blocked_stream_supported(
    cfg: StftConfig, chunk_samples=None, spectral_fn=None
) -> bool:
    """Gate of the blocked chunk streamers: uncentered, a matmul backend
    (AUTO or MATMUL, as `pipeline.formulation_for` decides), a supported
    (N, hop), a per-bin (or identity) response and -- with chunk_samples --
    G*hop-aligned chunks long enough that the head and tail patches never
    overlap (S >= 2*edge + N)."""
    n, hop = cfg.frame_size, cfg.hop_size
    if cfg.center or cfg.fft_backend == FftBackend.XLA:
        return False
    if not composed_block_supported(n, hop):
        return False
    if _resolve_blocked_per_bin(cfg, spectral_fn) is None:
        return False
    if chunk_samples is not None:
        geo = blocked_chunk_geometry(n, hop)
        if chunk_samples % geo["gh"] != 0:
            return False
        if chunk_samples < 2 * geo["edge"] + n:
            return False
    return True


def _splice_edges(out, x_region, cfg: StftConfig, c: dict, k: dict, rb,
                  head: bool, tail: bool):
    """Replace the head / tail `edge` samples of a chunk's interior output
    by the one-shot's exact phantom-frame patches. `x_region(a, b)` gives
    the chunk's extended input [a, b) in float32."""
    n, hop = cfg.frame_size, cfg.hop_size
    edge, s = c["edge"], out.shape[-1]
    span_p = blocked_patch_span(n, hop)
    if head:
        p = blocked_edge_patch(x_region(edge, edge + span_p), n, hop,
                               c["wb"], c["sb"], rb, "head") / k["head_norm"]
        out = torch.cat([p, out[..., edge:]], dim=-1)
    if tail:
        p = blocked_edge_patch(x_region(edge + s - span_p, edge + s), n, hop,
                               c["wb"], c["sb"], rb, "tail") / k["tail_norm"]
        out = torch.cat([out[..., : s - edge], p], dim=-1)
    return out


def _blocked_chunk(lctx, mid, rctx, cfg: StftConfig, rb: bytes, head: bool,
                   tail: bool) -> torch.Tensor:
    """One halo-extended blocked chunk: [..., S] output for the `mid`
    samples. lctx: [..., left_ctx] predecessor tail (zeros at the stream
    head); rctx: [..., right_ctx] successor head (zeros at the tail)."""
    c = _blocked_stream_consts(cfg, rb)
    k = _blocked_consts_on(cfg, rb, mid.device)
    s = mid.shape[-1]
    x_ext = torch.cat([lctx, mid, rctx], dim=-1)
    # Interior: the one-shot's hop-block rows over the same data (its zero
    # padding beyond the stream is lctx / rctx's zeros at the edge chunks).
    out = hopblock_apply(x_ext, k["kern"], c["gh"], s, 0, cfg.fft_precision,
                         k["bt"])
    if k["tile"] is not None:
        out = out / k["tile"].repeat(s // cfg.hop_size)
    return _splice_edges(out, lambda a, b: x_ext[..., a:b], cfg, c, k, rb,
                         head, tail)


class _HaloChunkStreamer:
    """The halo-extended chunk protocol shared by the f32 and int16
    streamers: equal, G*hop-aligned [..., S] chunks; `feed` returns the
    PREDECESSOR chunk's output (one chunk of latency, since the kernel's
    look-ahead needs the successor's head), `finish` drains the last;
    `state` / `load_state` checkpoint the position as a dict of numpy
    arrays and resume bit-identically."""

    def __init__(self, cfg: StftConfig, rb: bytes, device) -> None:
        self.cfg = cfg
        self._rb = rb
        self._device = device
        c = _blocked_stream_consts(cfg, rb)
        self._edge, self._rctx_n, self._gh = c["edge"], c["right_ctx"], c["gh"]
        self._prev = None  # previous chunk (tensor)
        self._lctx = None  # tail of the chunk before that
        self._first = True
        self._finished = False
        self._s = None

    def _chunk(self, lctx, mid, rctx, head: bool, tail: bool):
        raise NotImplementedError

    def _place(self, chunk) -> torch.Tensor:
        if isinstance(chunk, torch.Tensor):
            t = chunk
        else:
            t = _device.place(np.asarray(chunk), self._device)
        if self._prev is not None and t.device != self._prev.device:
            raise ValueError(f"chunk on {t.device}, the stream on "
                             f"{self._prev.device}")
        return t

    def _check(self, chunk: torch.Tensor) -> None:
        s = chunk.shape[-1]
        if self._s is None:
            n = self.cfg.frame_size
            if s % self._gh != 0 or s < 2 * self._edge + n:
                raise ValueError(
                    f"chunk length {s} must be a multiple of G*hop "
                    f"({self._gh}) and >= 2*(N-hop) + N ({2 * self._edge + n})"
                )
            self._s = s
        elif s != self._s:
            raise ValueError(f"chunk length changed: {s} != {self._s}")

    @staticmethod
    def _out(out, force: bool):
        return out.cpu().numpy() if force else out

    def feed(self, chunk, force: bool = True):
        """Feed one [..., S] chunk; returns the reconstructed PREDECESSOR
        chunk, or None on the first call: numpy with `force=True`, else the
        tensor on the stream's device (the caller overlaps the next chunk's
        transfer with this one's work: the prefetch hook)."""
        if self._finished:
            raise RuntimeError(
                f"feed() after finish(): create a new {type(self).__name__} "
                "(or load_state a checkpoint) to continue"
            )
        chunk = self._place(chunk)
        self._check(chunk)
        out = None
        if self._prev is not None:
            out = self._chunk(self._lctx, self._prev,
                              chunk[..., : self._rctx_n], self._first, False)
            self._first = False
            self._lctx = self._prev[..., -self._edge :]
            out = self._out(out, force)
        else:
            self._lctx = chunk.new_zeros(chunk.shape[:-1] + (self._edge,))
        self._prev = chunk
        return out

    def finish(self, force: bool = True):
        """Drain the final buffered chunk (ends the stream)."""
        self._finished = True
        if self._prev is None:
            return None
        rctx = self._prev.new_zeros(self._prev.shape[:-1] + (self._rctx_n,))
        out = self._chunk(self._lctx, self._prev, rctx, self._first, True)
        self._first = False
        self._lctx = self._prev[..., -self._edge :]
        self._prev = None
        return self._out(out, force)

    def state(self) -> dict:
        """Picklable / npz-able checkpoint of the stream position."""
        return {
            "prev": None if self._prev is None else self._prev.cpu().numpy(),
            "lctx": None if self._lctx is None else self._lctx.cpu().numpy(),
            "first": self._first,
            "s": self._s,
        }

    def load_state(self, st: dict) -> None:
        """Resume from `state()`; arrays go to the streamer's device."""
        self._finished = False
        self._prev = self._lctx = None
        self._prev = None if st["prev"] is None else self._place(st["prev"])
        self._lctx = None if st["lctx"] is None else self._place(st["lctx"])
        self._first = bool(st["first"])
        self._s = None if st["s"] is None else int(st["s"])


class BlockedChunkStreamer(_HaloChunkStreamer):
    """Resumable chunk streamer on the blocked formulation (float32).

    Feed equal-shape, G*hop-aligned [..., S] chunks with `feed()` (returns
    the reconstructed PREDECESSOR chunk) and drain the last with
    `finish()`. Numpy chunks go to `device` (default "cuda"); tensor
    chunks stay on their device."""

    def __init__(self, cfg: StftConfig, spectral_fn=None, device=None) -> None:
        if cfg.center:
            raise ValueError("blocked streaming is uncentered (center=False)")
        rb = _resolve_blocked_per_bin(cfg, spectral_fn)
        if rb is None or not blocked_stream_supported(cfg, None, spectral_fn):
            raise ValueError(
                "config not supported by the blocked streamer; use "
                "streaming_round_trip_blocks (scan formulation) instead"
            )
        super().__init__(cfg, rb, device)

    def _place(self, chunk) -> torch.Tensor:
        return super()._place(chunk).float()

    def _chunk(self, lctx, mid, rctx, head, tail):
        return _blocked_chunk(lctx, mid, rctx, self.cfg, self._rb, head, tail)


# ---------------------------------------------------------------------------
# The scan form: framed blocks with a carried overlap-add tail.
# ---------------------------------------------------------------------------


def _frames_round_trip(frames: torch.Tensor, cfg: StftConfig,
                       spectral_fn=None) -> torch.Tensor:
    """[..., F, N] raw frames -> round-trip frames (window, spectral fn,
    inverse, synthesis window), by the reference scan's three routes: a
    fixed per-bin response on a matmul backend is ONE composed [N, N]
    product; the identity or a packed fn on a matmul backend with
    N % 256 == 0 takes the folded packed parts; anything else rfft -> fn
    -> irfft. At HIGH on the card the composed product runs on B0 and the
    folded parts of the identity or a fn with an epilogue menu on B3's
    kernels (`fused_rt.roundtrip_of_frames`), both over the frame rows in
    place with a fixed order per frame: a frame's result does not depend on
    the batch it sits in, so any chunking of a stream gives the same
    frames."""
    n = cfg.frame_size
    w64 = _window_f64(cfg)
    on_matmul = (_fft._pick(cfg.fft_backend, n, frames.device)
                 == FftBackend.MATMUL)
    per_bin = (
        resolve_per_bin_response(spectral_fn, n)
        if spectral_fn is not None and on_matmul and n <= MAX_MATMUL_NFFT
        else None
    )
    if per_bin is not None:
        return roundtrip_composed_matmul(
            frames, n, w64, per_bin, w64 if cfg.synthesis_window else None,
            cfg.fft_precision)
    on_packed = on_matmul and n % 256 == 0 and n <= MAX_MATMUL_NFFT
    if (on_packed and float_tier(cfg.fft_precision) == FftPrecision.HIGH
            and (spectral_fn is None or epilogue_of(spectral_fn) is not None)):
        return _synthesis(roundtrip_of_frames(
            frames, n, const_on(_window_np(cfg), frames.device),
            None if spectral_fn is None else spectral_fn.packed), cfg)
    if on_packed and (spectral_fn is None or hasattr(spectral_fn, "packed")):
        re, im = rfft_folded_packed(frames, n, _window_np(cfg))
        if spectral_fn is not None:
            re, im = spectral_fn.packed(re, im)
        return _synthesis(irfft_folded_parts(re, im, n), cfg)
    spec = _fft.rfft_windowed(frames, n, w64, backend=cfg.fft_backend)
    if spectral_fn is not None:
        spec = spectral_fn(spec)
    return _synthesis(_fft.irfft(spec, n, backend=cfg.fft_backend), cfg)


@design_cache(8)
def _stream_norm_on(cfg: StftConfig, length: int, device: torch.device):
    """The steady-state (full-coverage) COLA norm of `length` samples,
    eps-clamped, float32 on `device`."""
    w = _window_np(cfg)
    contrib = w.astype(np.float64) ** 2 if cfg.synthesis_window else w
    norm = build_norm_linear(contrib, length, cfg.frame_size, cfg.hop_size)
    return torch.clamp_min(as_f32(norm, device), cfg.eps)


def _stream_frames(frames: torch.Tensor, cfg: StftConfig, spectral_fn,
                   carry_tail):
    """[..., F, N] frames -> ([..., F*hop] emitted samples, [..., N-hop]
    new tail): one batched round-trip, one overlap-add seeded with the
    carried tail, and the steady-state normalization."""
    hop = cfg.hop_size
    halo = cfg.frame_size - hop
    out_f = _frames_round_trip(frames, cfg, spectral_fn)
    span = frames.shape[-2] * hop
    if carry_tail is None:
        carry_tail = out_f.new_zeros(out_f.shape[:-2] + (halo,))
    acc = overlap_add(out_f, hop, out_len=span + halo,
                      init_head=carry_tail.to(out_f.device, torch.float32))
    emitted = acc[..., :span] / _stream_norm_on(cfg, span, acc.device)
    return emitted, acc[..., span:]


def streaming_round_trip_blocks(
    frame_blocks: torch.Tensor,  # [num_blocks, block_frames, N] raw frames
    cfg: StftConfig,
    block_frames: int,
    spectral_fn=None,
    carry_tail=None,  # [N - hop] tail from a previous call (chunk chaining)
    return_carry: bool = False,
    device=None,
):
    """Framed blocks through window -> rFFT -> (fn) -> irFFT -> OLA with a
    carried tail; returns [num_blocks * block_frames * hop] steady-state
    normalized samples (and the new [N - hop] tail with `return_carry`).
    The frames of every block sum in ascending order after the carried
    tail, so the output is the offline pipeline's interior bit for bit
    wherever the round-trip frames are. Array-like frames go to `device`
    (default "cuda")."""
    frame_blocks = _device.place(frame_blocks, device)
    if frame_blocks.ndim != 3 or frame_blocks.shape[1] != block_frames:
        raise ValueError(
            f"frame_blocks must be [num_blocks, {block_frames}, N], got "
            f"{tuple(frame_blocks.shape)}")
    frames = frame_blocks.reshape(-1, frame_blocks.shape[-1]).float()
    out, tail = _stream_frames(frames, cfg, spectral_fn, carry_tail)
    return (out, tail) if return_carry else out


def streaming_round_trip(
    signal,
    cfg: StftConfig,
    block_frames: int = 64,
    spectral_fn=None,
    device=None,
):
    """Stream a long 1-D signal through the scan pipeline.

    Returns (output, valid_from): output[t] reconstructs signal[t] for
    t >= valid_from (the first N - hop samples lack full window coverage
    under steady-state normalization). Numpy input gives numpy output; a
    tensor stays on its device."""
    if cfg.center:
        raise ValueError("streaming pipeline is uncentered (center=False)")
    n, hop = cfg.frame_size, cfg.hop_size
    as_numpy = not isinstance(signal, torch.Tensor)
    x = _device.place(signal, device, torch.float32)
    if x.ndim != 1:
        raise ValueError(f"expected a 1-D signal, got {tuple(x.shape)}")
    num_frames = max((x.shape[-1] - (n - hop)) // hop, 0)
    blocks = num_frames // block_frames
    if blocks == 0:
        raise ValueError(
            f"signal too short: {x.shape[-1]} samples < "
            f"{block_frames * hop + (n - hop)} needed for one block"
        )
    f = blocks * block_frames
    frames = x.unfold(-1, n, hop)[:f].reshape(blocks, block_frames, n)
    out = streaming_round_trip_blocks(frames, cfg, block_frames, spectral_fn)
    return (out.cpu().numpy() if as_numpy else out), n - hop


def process_wav_file(
    infile: str,
    outfile: str,
    cfg: StftConfig,
    spectral_fn=None,
    block_frames: int = 64,
    blocks_per_chunk: int = 16,
    bits: int = 16,
    device=None,
) -> int:
    """File-to-file streaming round-trip at bounded memory: read a WAV in
    hop-aligned chunks, run each through the scan pipeline with the OLA
    tail carried across chunks (the output equals an unbroken stream), and
    write it out. Any length and channel count; frames past EOF are
    zero-padded. The chunks run on `device` (default "cuda"). Returns the
    samples written per channel.

    Memory stays bounded by the chunk: `WavStreamReader` decodes only each
    chunk's span of the file (its N - hop overlap read again, by seek), and
    `WavWriter` encodes each output chunk to disk as it comes.

    The first and last N - hop samples have partial window coverage under
    steady-state normalization, as `streaming_round_trip`'s `valid_from`."""
    from .io.wav import WavStreamReader, WavWriter

    if cfg.center:
        raise ValueError("streaming pipeline is uncentered (center=False)")
    n, hop = cfg.frame_size, cfg.hop_size
    chunk_frames = block_frames * blocks_per_chunk
    chunk_out = chunk_frames * hop
    span = (chunk_frames - 1) * hop + n

    reader = WavStreamReader(infile)
    total = reader.num_frames
    logger.info(
        "stream %s -> %s: %d ch, %d frames @ %d Hz, N=%d H=%d, "
        "chunk=%d frames", infile, outfile, reader.channels, total,
        reader.sample_rate, n, hop, chunk_frames,
    )
    with WavWriter(outfile, reader.channels, reader.sample_rate,
                   bits=bits) as writer:
        carry = None
        pos = written = 0
        while written < total:
            reader.seek(pos)
            raw = reader.read_chunk(span)
            if raw.shape[-1] < span:  # EOF: zero-pad trailing frames
                raw = np.pad(raw, [(0, 0), (0, span - raw.shape[-1])])
            x = _device.place(raw, device, torch.float32)
            frames = x.unfold(-1, n, hop)[:, :chunk_frames]
            out, carry = _stream_frames(frames, cfg, spectral_fn, carry)
            chunk = out[:, : min(chunk_out, total - written)].cpu().numpy()
            writer.write(chunk)
            written += chunk.shape[-1]
            pos += chunk_out
    logger.info("stream %s done: %d samples/channel written", outfile,
                written)
    return written
