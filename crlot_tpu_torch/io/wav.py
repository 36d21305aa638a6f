"""WAV I/O: host-side reader/writer with the reference's format contract.

A numpy copy of `crlot_tpu/io/wav.py` (the port never imports the JAX
package): `read_wav`, `write_wav` and the reader / writer classes
`WavReader`, `WavWriter` and `WavStreamReader` (chunked decode for long
streams); arrays are [channels, frames] float32, as there.

Reference: io/wav.{h,cc} over dr_wav. Contract carried over:
  - reader validates channels in {1,2} (strict mode), bits in {16,24,32},
    format PCM or IEEE float32 (io/wav.cc:30-58),
  - samples decode to float32 in [-1, 1],
  - writer converts f32 -> s16 / s24 (clamp + round + scale 8388607 + 3-byte
    LE pack, io/wav.cc:233-247) / s32 / float32 passthrough (io/wav.cc:207-259).

Scaling is symmetric (write *(2^(b-1)-1), read /(2^(b-1)-1)) so round-trips
are pure quantization noise; the tested gates are <= -84 dBFS for 16-bit and
<= -100 dBFS for float32 round-trips (tests/wav_io_test.cc:522-611).

This is pure host plumbing (numpy + struct).
"""

from __future__ import annotations

import logging
import struct
from typing import Tuple

import numpy as np

logger = logging.getLogger("crlot_tpu_torch.io")

_FMT_PCM = 1
_FMT_IEEE_FLOAT = 3
_FMT_EXTENSIBLE = 0xFFFE

_VALID_BITS = (16, 24, 32)


class WavFormatError(ValueError):
    pass


def _full_scale(bits: int) -> float:
    return float((1 << (bits - 1)) - 1)


def read_wav(path: str, strict: bool = True) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 data [channels, frames], sample_rate).

    strict=True enforces the reference's guards (channels in {1,2};
    io/wav.cc:30-58). bits must be 16/24/32 PCM or 32-bit IEEE float either way.
    """
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 12 or blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise WavFormatError(f"{path}: not a RIFF/WAVE file")

    fmt = None
    data = None
    pos = 12
    while pos + 8 <= len(blob):
        cid = blob[pos : pos + 4]
        (size,) = struct.unpack_from("<I", blob, pos + 4)
        body = blob[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or data is None:
        raise WavFormatError(f"{path}: missing fmt/data chunk")

    tag, channels, rate, _, block_align, bits = struct.unpack_from("<HHIIHH", fmt, 0)
    if tag == _FMT_EXTENSIBLE and len(fmt) >= 26:
        (tag,) = struct.unpack_from("<H", fmt, 24)  # subformat GUID's first u16
    if tag not in (_FMT_PCM, _FMT_IEEE_FLOAT):
        raise WavFormatError(f"{path}: unsupported format tag {tag}")
    if bits not in _VALID_BITS:
        raise WavFormatError(f"{path}: unsupported bit depth {bits}")
    if tag == _FMT_IEEE_FLOAT and bits != 32:
        raise WavFormatError(f"{path}: IEEE float must be 32-bit, got {bits}")
    if channels < 1 or (strict and channels > 2):
        raise WavFormatError(f"{path}: unsupported channel count {channels}")

    n_frames = len(data) // block_align
    data = data[: n_frames * block_align]
    if tag == _FMT_IEEE_FLOAT:
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / _full_scale(16)
    elif bits == 32:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / _full_scale(32)
    else:  # 24-bit: 3-byte LE -> sign-extended i32
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        i32 = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        i32 = np.where(i32 & 0x800000, i32 - (1 << 24), i32)
        x = i32.astype(np.float32) / _full_scale(24)
    logger.debug(
        "read %s: %d ch, %d frames @ %d Hz, %d-bit %s",
        path, channels, n_frames, rate, bits,
        "float" if tag == _FMT_IEEE_FLOAT else "pcm",
    )
    return np.ascontiguousarray(x.reshape(n_frames, channels).T), int(rate)


def _check_format(channels: int, sample_rate: int, bits: int,
                  float_format: bool, strict: bool) -> int:
    """Validates a writer's format; returns the bits a sample takes."""
    if channels < 1 or (strict and channels > 2):
        raise WavFormatError(f"unsupported channel count {channels}")
    if sample_rate <= 0:
        raise ValueError(f"sample_rate must be > 0, got {sample_rate}")
    if float_format:
        return 32
    if bits not in _VALID_BITS:
        raise WavFormatError(f"unsupported bit depth {bits}")
    return bits


def _header(channels: int, sample_rate: int, bits: int, float_format: bool,
            data_len: int) -> bytes:
    """RIFF / WAVE header with a 16-byte fmt chunk and the data chunk's
    size; the data (and its pad byte when data_len is odd) follow it."""
    tag = _FMT_IEEE_FLOAT if float_format else _FMT_PCM
    block_align = channels * bits // 8
    fmt = struct.pack("<HHIIHH", tag, channels, sample_rate,
                      sample_rate * block_align, block_align, bits)
    riff = 4 + 8 + len(fmt) + 8 + data_len + (data_len & 1)
    return b"".join([b"RIFF", struct.pack("<I", riff), b"WAVE", b"fmt ",
                     struct.pack("<I", len(fmt)), fmt, b"data",
                     struct.pack("<I", data_len)])


def _encode(x: np.ndarray, bits: int, float_format: bool, path: str) -> bytes:
    """float32 [channels, frames] -> interleaved sample bytes (io/wav.cc:
    207-259): float32 passthrough, or clamp to [-1, 1], round to nearest
    and scale by 2^(bits-1)-1; 24-bit packs 3-byte LE."""
    interleaved = np.ascontiguousarray(x.T)
    if float_format:
        return interleaved.astype("<f4").tobytes()
    scale = _full_scale(bits)
    n_clipped = int(np.count_nonzero(np.abs(interleaved) > 1.0))
    if n_clipped:
        # Reference writer clamps silently (io/wav.cc:233-247); we keep
        # the clamp but leave a breadcrumb for long streaming jobs.
        logger.warning(
            "write %s: clipping %d/%d samples (peak %.3f) to [-1, 1]",
            path, n_clipped, interleaved.size,
            float(np.max(np.abs(interleaved))),
        )
    q = np.rint(np.clip(interleaved, -1.0, 1.0) * scale)
    if bits == 16:
        return q.astype("<i2").tobytes()
    if bits == 32:
        return q.astype("<i4").tobytes()
    i32 = q.astype(np.int32).reshape(-1)  # 24-bit 3-byte LE pack
    b = np.empty((i32.size, 3), dtype=np.uint8)
    b[:, 0] = i32 & 0xFF
    b[:, 1] = (i32 >> 8) & 0xFF
    b[:, 2] = (i32 >> 16) & 0xFF
    return b.tobytes()


def _as_frames(data) -> np.ndarray:
    x = np.asarray(data, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(f"data must be [frames] or [channels, frames], got {x.shape}")
    return x


def write_wav(
    path: str,
    data: np.ndarray,
    sample_rate: int,
    bits: int = 16,
    float_format: bool = False,
    strict: bool = True,
) -> None:
    """Write float32 data [channels, frames] (or [frames]) to a WAV file.

    Conversion semantics mirror the reference writer (io/wav.cc:207-259):
    clamp to [-1, 1], round-to-nearest, scale by 2^(bits-1)-1; 24-bit packs
    3-byte LE; float_format writes IEEE float32 passthrough (bits ignored).
    """
    x = _as_frames(data)
    channels, n_frames = x.shape
    bits = _check_format(channels, sample_rate, bits, float_format, strict)
    payload = _encode(x, bits, float_format, path)
    with open(path, "wb") as f:
        f.write(_header(channels, sample_rate, bits, float_format,
                        len(payload)) + payload
                + (b"\x00" if len(payload) & 1 else b""))
    logger.debug(
        "wrote %s: %d ch, %d frames @ %d Hz, %d-bit %s",
        path, channels, n_frames, sample_rate, bits,
        "float" if float_format else "pcm",
    )


class WavReader:
    """Open/inspect/read API mirroring the reference (io/wav.h:11-40)."""

    def __init__(self, path: str, strict: bool = True) -> None:
        self._data, self._rate = read_wav(path, strict=strict)
        self.path = path

    @property
    def channels(self) -> int:
        return self._data.shape[0]

    @property
    def sample_rate(self) -> int:
        return self._rate

    @property
    def num_frames(self) -> int:
        return self._data.shape[1]

    def read_all(self) -> np.ndarray:
        """All samples as float32 [channels, frames]."""
        return self._data

    def read(self, start: int, count: int) -> np.ndarray:
        return self._data[:, start : start + count]


class WavWriter:
    """Open-with-format/write API mirroring the reference (io/wav.h:42-72).

    Streams to disk at bounded memory: the header goes out at open with a
    data size of 0, each `write` encodes its block and appends it, and
    `close` adds the pad byte of an odd data size and patches the RIFF and
    data sizes. The file's bytes equal `write_wav` of all blocks at once."""

    def __init__(
        self,
        path: str,
        channels: int,
        sample_rate: int,
        bits: int = 16,
        float_format: bool = False,
        strict: bool = True,
    ) -> None:
        self.bits = _check_format(channels, sample_rate, bits, float_format,
                                  strict)
        self.path = path
        self.channels = channels
        self.sample_rate = sample_rate
        self.float_format = float_format
        self.strict = strict
        self.frames = 0
        self._data_len = 0
        self._f = open(path, "wb")
        self._f.write(_header(channels, sample_rate, self.bits, float_format,
                              0))

    def write(self, data: np.ndarray) -> None:
        if self._f is None:
            raise ValueError(f"{self.path}: writer is closed")
        x = _as_frames(data)
        if x.shape[0] != self.channels:
            raise ValueError(f"expected {self.channels} channels, got {x.shape[0]}")
        payload = _encode(x, self.bits, self.float_format, self.path)
        self._f.write(payload)
        self._data_len += len(payload)
        self.frames += x.shape[1]

    def close(self) -> None:
        if self._f is None:
            return
        f, self._f = self._f, None
        with f:
            if self._data_len & 1:
                f.write(b"\x00")
            f.seek(0)
            f.write(_header(self.channels, self.sample_rate, self.bits,
                            self.float_format, self._data_len))
        logger.debug("wrote %s: %d ch, %d frames @ %d Hz (streamed)",
                     self.path, self.channels, self.frames, self.sample_rate)

    def __enter__(self) -> "WavWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class WavStreamReader:
    """Chunked WAV reader for streams too long to hold in memory.

    Parses the header once, then decodes `read_chunk(frames)` windows
    straight from the file -- the host loader for hour-long streaming jobs.
    Same format guards as `read_wav`.
    """

    def __init__(self, path: str, strict: bool = True) -> None:
        self.path = path
        with open(path, "rb") as f:
            head = f.read(12)
            if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
                raise WavFormatError(f"{path}: not a RIFF/WAVE file")
            fmt = None
            self._data_off = None
            self._data_len = 0
            pos = 12
            while True:
                f.seek(pos)
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                cid = hdr[:4]
                (size,) = struct.unpack("<I", hdr[4:])
                if cid == b"fmt ":
                    fmt = f.read(size)
                elif cid == b"data":
                    self._data_off = pos + 8
                    self._data_len = size
                pos += 8 + size + (size & 1)
        if fmt is None or self._data_off is None:
            raise WavFormatError(f"{path}: missing fmt/data chunk")
        tag, ch, rate, _, ba, bits = struct.unpack_from("<HHIIHH", fmt, 0)
        if tag == _FMT_EXTENSIBLE and len(fmt) >= 26:
            (tag,) = struct.unpack_from("<H", fmt, 24)
        if tag not in (_FMT_PCM, _FMT_IEEE_FLOAT):
            raise WavFormatError(f"{path}: unsupported format tag {tag}")
        if bits not in _VALID_BITS or (tag == _FMT_IEEE_FLOAT and bits != 32):
            raise WavFormatError(f"{path}: unsupported bit depth {bits}")
        if ch < 1 or (strict and ch > 2):
            raise WavFormatError(f"{path}: unsupported channel count {ch}")
        self.channels = ch
        self.sample_rate = int(rate)
        self.bits = bits
        self.is_float = tag == _FMT_IEEE_FLOAT
        self._block = ba
        self.num_frames = self._data_len // ba
        self._pos = 0  # frame cursor

    def _decode(self, raw: bytes) -> np.ndarray:
        n = len(raw) // self._block
        if self.is_float:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif self.bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / _full_scale(16)
        elif self.bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / _full_scale(32)
        else:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            i32 = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            i32 = np.where(i32 & 0x800000, i32 - (1 << 24), i32)
            x = i32.astype(np.float32) / _full_scale(24)
        return np.ascontiguousarray(x.reshape(n, self.channels).T)

    def read_chunk(self, frames: int) -> np.ndarray:
        """Next [channels, <=frames] block; empty array at EOF."""
        frames = min(frames, self.num_frames - self._pos)
        if frames <= 0:
            return np.zeros((self.channels, 0), dtype=np.float32)
        with open(self.path, "rb") as f:
            f.seek(self._data_off + self._pos * self._block)
            raw = f.read(frames * self._block)
        self._pos += frames
        return self._decode(raw)

    def seek(self, frame: int) -> None:
        if not 0 <= frame <= self.num_frames:
            raise ValueError(f"seek {frame} out of range [0, {self.num_frames}]")
        self._pos = frame

    def __iter__(self):
        while True:
            chunk = self.read_chunk(1 << 16)
            if chunk.shape[1] == 0:
                return
            yield chunk
