"""ctypes bindings for the native C++ host runtime (`csrc/crlot_native.cpp`).

Counterpart of `crlot_tpu/io/native.py`: the host data loader that feeds
the card. `read_wav_native` / `write_wav_native` are the WAV codec,
`NativeRing` the dtype-generic ring buffer and `NativeFramer` the streaming
framer that hands out device-ready [frames, channels, frame_size] float32
batches; each matches the port's pure-Python counterpart bit for bit
(`io/wav.py`, `frame/streaming.Framer`).

`csrc/crlot_native.cpp` is a byte copy of the reference's
`native/crlot_native.cpp` (ABI version 2). The library is built with g++ at
first use, never at import, into
`build/crlot_tpu_torch/native/<digest>/libcrlot_native.so` (git-ignored);
the digest covers the source, the flags and the host CPU (`-march=native`
code runs only where it was built). The build holds an `fcntl.flock` on a
lock file beside the library, compiles to a temporary name and
`os.replace`s it into place, so processes that start together (test
workers) build once and never load a half-written file.

`native_available()` is False only where there is no g++. A failed build
or a library of another ABI version raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .wav import WavFormatError

SRC = Path(__file__).resolve().parent.parent / "csrc" / "crlot_native.cpp"
BUILD_ROOT = (Path(__file__).resolve().parent.parent.parent / "build"
              / "crlot_tpu_torch" / "native")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-fvisibility=hidden"]
ABI_VERSION = 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _host_cpu() -> str:
    """The host CPU's model and feature flags (what `-march=native` reads)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f
                     if ln.startswith(("model name", "flags", "Features"))]
    except OSError:
        lines = []
    return platform.machine() + "".join(sorted(set(lines)))


def library_path() -> Path:
    """Where this source, these flags and this CPU's library lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(_host_cpu().encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libcrlot_native.so"


def build(out: Path) -> None:
    """Compile the library to `out` unless it is there: under an exclusive
    lock on `out`'s directory, to a temporary name, then renamed into
    place. Raises with g++'s output when the compile fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native runtime cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                return
            tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [gxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                capture_output=True, text=True, timeout=300,
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"g++ failed ({proc.returncode}) on {SRC}:\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _declare(host: ctypes.CDLL) -> None:
    """argtypes and restype of every exported symbol (a missing restype
    truncates a 64-bit handle)."""
    c = ctypes.c_int32
    i64 = ctypes.c_int64
    u64 = ctypes.c_uint64
    vp = ctypes.c_void_p
    p8 = ctypes.POINTER(ctypes.c_uint8)
    pf = ctypes.POINTER(ctypes.c_float)
    pi64 = ctypes.POINTER(i64)
    sigs = {
        "crlot_wav_info": ([p8, u64] + [ctypes.POINTER(c)] * 4 + [pi64], c),
        "crlot_wav_decode": ([p8, u64, pf], c),
        "crlot_wav_encoded_size": ([i64, c, c], i64),
        "crlot_wav_encode": ([pf, i64, c, c, c, c, p8, pi64], c),
        "crlot_ring_create": ([i64, c], vp),
        "crlot_ring_create_typed": ([i64, c, i64], vp),
        "crlot_ring_elem_size": ([vp], i64),
        "crlot_ring_destroy": ([vp], None),
        "crlot_ring_split": ([vp, i64, i64, pi64, pi64, pi64, pi64], c),
        "crlot_ring_write": ([vp, i64, vp, i64], None),
        "crlot_ring_read": ([vp, i64, vp, i64], None),
        "crlot_ring_capacity": ([vp], i64),
        "crlot_framer_create": ([i64, i64, i64, c], vp),
        "crlot_framer_destroy": ([vp], None),
        "crlot_framer_push": ([vp, pf, i64], c),
        "crlot_framer_flush": ([vp], None),
        "crlot_framer_available": ([vp], i64),
        "crlot_framer_pop_batch": ([vp, pf, i64], i64),
        "crlot_framer_reset": ([vp], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(host, name)
        fn.argtypes = argtypes
        fn.restype = restype


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built on first call; None only without g++."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if shutil.which("g++") is None:
            return None
        so = library_path()
        if not so.exists():
            build(so)
        host = ctypes.CDLL(str(so))
        host.crlot_native_abi_version.restype = ctypes.c_int32
        version = host.crlot_native_abi_version()
        if version != ABI_VERSION:
            raise RuntimeError(f"{so}: ABI version {version}, expected "
                               f"{ABI_VERSION}")
        _declare(host)
        _lib = host
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _require() -> ctypes.CDLL:
    host = get_lib()
    if host is None:
        raise RuntimeError("native library unavailable: g++ not found")
    return host


_ERRORS = {
    -1: "not a RIFF/WAVE file",
    -2: "missing fmt/data chunk",
    -3: "unsupported format tag",
    -4: "unsupported bit depth",
    -5: "unsupported channel count",
    -6: "invalid block alignment",
}


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_wav_native(path: str, strict: bool = True) -> Tuple[np.ndarray, int]:
    """Native read; the contract of `io.wav.read_wav`: float32 [channels,
    frames] and the sample rate."""
    host = _require()
    blob = np.fromfile(path, dtype=np.uint8)
    ch, rate, bits, isf = (ctypes.c_int32() for _ in range(4))
    frames = ctypes.c_int64()
    rc = host.crlot_wav_info(_u8p(blob), blob.size, ch, rate, bits, isf, frames)
    if rc != 0:
        raise WavFormatError(f"{path}: {_ERRORS.get(rc, rc)}")
    if strict and ch.value > 2:
        raise WavFormatError(f"{path}: unsupported channel count {ch.value}")
    out = np.empty(frames.value * ch.value, dtype=np.float32)
    rc = host.crlot_wav_decode(_u8p(blob), blob.size, _f32p(out))
    if rc != 0:
        raise WavFormatError(f"{path}: {_ERRORS.get(rc, rc)}")
    return np.ascontiguousarray(out.reshape(frames.value, ch.value).T), rate.value


def write_wav_native(
    path: str,
    data: np.ndarray,
    sample_rate: int,
    bits: int = 16,
    float_format: bool = False,
    strict: bool = True,
) -> None:
    """Native write; the contract of `io.wav.write_wav`, the same bytes."""
    host = _require()
    x = np.asarray(data, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    channels, frames = x.shape
    if channels < 1 or (strict and channels > 2):
        raise WavFormatError(f"unsupported channel count {channels}")
    if float_format:
        bits = 32
    if bits not in (16, 24, 32):
        raise WavFormatError(f"unsupported bit depth {bits}")
    interleaved = np.ascontiguousarray(x.T).reshape(-1)
    out = np.empty(host.crlot_wav_encoded_size(frames, channels, bits),
                   dtype=np.uint8)
    out_len = ctypes.c_int64()
    rc = host.crlot_wav_encode(
        _f32p(interleaved), frames, channels, sample_rate, bits,
        1 if float_format else 0, _u8p(out), out_len,
    )
    if rc != 0:
        raise WavFormatError(f"{path}: {_ERRORS.get(rc, rc)}")
    out[: out_len.value].tofile(path)


class NativeRing:
    """Dtype-generic native ring buffer (reference: dsp/ring/ring_buffer.cc,
    instantiated for float/double/int16/int32/uint16/uint32 at :207-213).

    Wrap-around write and contiguous read over a fixed capacity, with an
    optional 2x shadow mirror so reads never wrap. The element type is
    fixed at construction by numpy dtype.
    """

    DTYPES = ("float32", "float64", "int16", "int32", "uint16", "uint32")

    def __init__(self, capacity: int, dtype="float32",
                 shadow: bool = False) -> None:
        host = _require()
        dt = np.dtype(dtype)
        if dt.name not in self.DTYPES:
            raise ValueError(f"unsupported ring dtype {dt.name}; "
                             f"one of {self.DTYPES}")
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self._lib = host
        self.dtype = dt
        self.capacity = capacity
        self._h = host.crlot_ring_create_typed(capacity, 1 if shadow else 0,
                                              dt.itemsize)
        if not self._h:
            raise RuntimeError("ring creation failed")

    def write(self, start: int, src: np.ndarray) -> None:
        data = np.ascontiguousarray(src, dtype=self.dtype).reshape(-1)
        self._lib.crlot_ring_write(self._h, start,
                                   data.ctypes.data_as(ctypes.c_void_p),
                                   data.size)

    def read(self, start: int, n: int) -> np.ndarray:
        out = np.empty(min(n, self.capacity), dtype=self.dtype)
        self._lib.crlot_ring_read(self._h, start,
                                  out.ctypes.data_as(ctypes.c_void_p),
                                  out.size)
        return out

    def split(self, start: int, n: int):
        """(off0, len0, off1, len1) span arithmetic (ring_buffer.cc:43-85)."""
        o0, l0, o1, l1 = (ctypes.c_int64() for _ in range(4))
        self._lib.crlot_ring_split(self._h, start, n, o0, l0, o1, l1)
        return o0.value, l0.value, o1.value, l1.value

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.crlot_ring_destroy(h)
            self._h = None


class NativeFramer:
    """C++ streaming framer emitting [frames, channels, frame_size] batches.

    The semantics of `frame.streaming.Framer` (push / flush / available /
    pop_batch / reset, ZERO_PAD boundary when `zero_pad`), with the
    deinterleave loop in native code. Batches are host float32 arrays; the
    caller copies them to the card in one transfer.
    """

    def __init__(self, frame_size: int, hop_size: int, channels: int = 1,
                 zero_pad: bool = True) -> None:
        host = _require()
        if frame_size <= 0 or hop_size <= 0 or channels <= 0:
            raise ValueError("frame_size, hop_size, channels must be > 0")
        self._lib = host
        self.frame_size = frame_size
        self.hop_size = hop_size
        self.channels = channels
        self._h = host.crlot_framer_create(frame_size, hop_size, channels,
                                          1 if zero_pad else 0)
        if not self._h:
            raise RuntimeError("framer creation failed")

    def push(self, interleaved: np.ndarray) -> None:
        data = np.ascontiguousarray(interleaved, dtype=np.float32).reshape(-1)
        if data.size % self.channels != 0:
            raise ValueError(
                f"pushed {data.size} samples not a multiple of channels")
        rc = self._lib.crlot_framer_push(self._h, _f32p(data),
                                         data.size // self.channels)
        if rc != 0:
            raise RuntimeError("cannot push after flush()")

    def flush(self) -> None:
        self._lib.crlot_framer_flush(self._h)

    def available(self) -> int:
        return int(self._lib.crlot_framer_available(self._h))

    def pop_batch(self, max_frames: Optional[int] = None) -> np.ndarray:
        n = self.available()
        if max_frames is not None:
            n = min(n, max_frames)
        out = np.zeros((n, self.channels, self.frame_size), dtype=np.float32)
        if n:
            got = self._lib.crlot_framer_pop_batch(self._h, _f32p(out), n)
            out = out[:got]
        return out

    def reset(self) -> None:
        self._lib.crlot_framer_reset(self._h)

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.crlot_framer_destroy(h)
            self._h = None
