"""WAV I/O: host-side reader/writer with the reference's format contract.

A numpy copy of `crlot_tpu/io/wav.py` (the port never imports the JAX
package); arrays are [channels, frames] float32, as there.

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
    x = np.asarray(data, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(f"data must be [frames] or [channels, frames], got {x.shape}")
    channels, n_frames = x.shape
    if channels < 1 or (strict and channels > 2):
        raise WavFormatError(f"unsupported channel count {channels}")
    if sample_rate <= 0:
        raise ValueError(f"sample_rate must be > 0, got {sample_rate}")
    interleaved = np.ascontiguousarray(x.T)

    if float_format:
        bits = 32
        tag = _FMT_IEEE_FLOAT
        payload = interleaved.astype("<f4").tobytes()
    else:
        if bits not in _VALID_BITS:
            raise WavFormatError(f"unsupported bit depth {bits}")
        tag = _FMT_PCM
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
            payload = q.astype("<i2").tobytes()
        elif bits == 32:
            payload = q.astype("<i4").tobytes()
        else:  # 24-bit 3-byte LE pack (io/wav.cc:233-247)
            i32 = q.astype(np.int32).reshape(-1)
            b = np.empty((i32.size, 3), dtype=np.uint8)
            b[:, 0] = i32 & 0xFF
            b[:, 1] = (i32 >> 8) & 0xFF
            b[:, 2] = (i32 >> 16) & 0xFF
            payload = b.tobytes()

    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    fmt = struct.pack(
        "<HHIIHH", tag, channels, sample_rate, byte_rate, block_align, bits
    )
    chunks = b"".join(
        [
            b"fmt ",
            struct.pack("<I", len(fmt)),
            fmt,
            b"data",
            struct.pack("<I", len(payload)),
            payload,
            b"\x00" if len(payload) & 1 else b"",
        ]
    )
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks)
    logger.debug(
        "wrote %s: %d ch, %d frames @ %d Hz, %d-bit %s",
        path, channels, n_frames, sample_rate, bits,
        "float" if float_format else "pcm",
    )

