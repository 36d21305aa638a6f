"""The port's native host runtime (`crlot_tpu_torch/io/native.py`).

Mirrors the 26 cases of `tests/test_native.py` against the port: the
native codec and framer are held bit for bit (`np.array_equal`, byte-equal
files) to the port's Python path (`io/wav.py`, `frame/streaming.Framer`),
as the reference's are to its own. Added:

* `csrc/crlot_native.cpp` is a byte copy of `native/crlot_native.cpp`;
* the port's native codec and framer bit for bit against the JAX
  package's Python path (`crlot_tpu.io.wav`,
  `crlot_tpu.frame.streaming.Framer`), never against
  `crlot_tpu.io.native`, whose first-use build races under several test
  workers (ROADMAP C22);
* four processes building into one fresh directory at once all load the
  library, and nothing is written under `native/`;
* `native_available()` is True wherever g++ is on the PATH, so a broken
  build fails here instead of skipping.

The library is built inside a session fixture, never while the module is
imported. Tolerance: none; every comparison is exact.
"""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from crlot_tpu.frame.streaming import Framer as JaxFramer
from crlot_tpu.io import wav as jwav

from crlot_tpu_torch.frame.streaming import Framer
from crlot_tpu_torch.io import native as N
from crlot_tpu_torch.io.wav import WavFormatError, read_wav, write_wav

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def lib():
    """The port's library, built (under its lock) on first use."""
    lib = N.get_lib()
    assert lib is not None, "g++ is missing: the native runtime cannot build"
    return lib


def _sig(n, c=1, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (c, n)).astype(np.float32)


def _framer_batch(fr):
    b = fr.pop_batch()
    return b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)


# --- the mirrored cases of tests/test_native.py ------------------------------


@pytest.mark.parametrize("bits,float_format",
                         [(16, False), (24, False), (32, False), (32, True)])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_native_matches_python(lib, tmp_path, bits, float_format,
                                   channels):
    x = _sig(4321, channels)
    p_py = str(tmp_path / "py.wav")
    p_nat = str(tmp_path / "nat.wav")
    write_wav(p_py, x, 48000, bits=bits, float_format=float_format)
    N.write_wav_native(p_nat, x, 48000, bits=bits, float_format=float_format)
    assert Path(p_py).read_bytes() == Path(p_nat).read_bytes()
    y_py, r1 = read_wav(p_py)
    y_nat, r2 = N.read_wav_native(p_nat)
    assert r1 == r2 == 48000
    np.testing.assert_array_equal(y_py, y_nat)


def test_native_reads_reference_asset(lib, tmp_path):
    """The reference decodes its oboe asset (44.1 kHz 16-bit stereo), which
    is not in the repository; the port decodes a 2 s WAV of that format,
    written by the Python codec, and the native decode equals the Python
    decode."""
    t = np.arange(88200) / 44100.0
    x = 0.5 * np.sin(2 * np.pi * 440.0 * t)
    x = np.stack([x, 0.7 * x]).astype(np.float32)
    path = str(tmp_path / "oboe_like.wav")
    write_wav(path, x, 44100, bits=16)
    a, ra = read_wav(path)
    b, rb = N.read_wav_native(path)
    assert ra == rb == 44100
    np.testing.assert_array_equal(a, b)


def test_native_rejects_garbage(lib, tmp_path):
    p = str(tmp_path / "bad.wav")
    Path(p).write_bytes(b"definitely not a wav")
    with pytest.raises(WavFormatError):
        N.read_wav_native(p)


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_native_framer_matches_python(lib, channels):
    rng = np.random.default_rng(1)
    total = 997
    inter = rng.uniform(-1, 1, total * channels).astype(np.float32)
    py = Framer(64, 16, channels=channels, device="cpu")
    nat = N.NativeFramer(64, 16, channels=channels)
    for chunk in np.array_split(inter.reshape(total, channels), 7):
        py.push(chunk.reshape(-1))
        nat.push(chunk.reshape(-1))
        assert py.available() == nat.available()
        np.testing.assert_array_equal(_framer_batch(py), nat.pop_batch())
    py.flush()
    nat.flush()
    np.testing.assert_array_equal(_framer_batch(py), nat.pop_batch())


def test_native_framer_zero_pad_tail(lib):
    nat = N.NativeFramer(8, 4, channels=1)
    nat.push(np.ones(10, dtype=np.float32))
    assert nat.available() == 1
    nat.flush()
    batch = nat.pop_batch()
    assert batch.shape[0] == 2
    # The partial frame starts at the read cursor (sample 4): six ones, pad.
    np.testing.assert_array_equal(batch[1, 0], [1, 1, 1, 1, 1, 1, 0, 0])


def test_native_framer_push_after_flush(lib):
    nat = N.NativeFramer(8, 4)
    nat.flush()
    with pytest.raises(RuntimeError):
        nat.push(np.zeros(8, dtype=np.float32))


def test_native_ring_split_semantics(lib):
    h = lib.crlot_ring_create(16, 0)
    assert h
    try:
        o0, l0, o1, l1 = (ctypes.c_int64() for _ in range(4))
        assert lib.crlot_ring_split(h, 2, 8, o0, l0, o1, l1) == 1  # no wrap
        assert (o0.value, l0.value) == (2, 8)
        # wrap: start 12 len 8 -> [12, 16) + [0, 4)
        assert lib.crlot_ring_split(h, 12, 8, o0, l0, o1, l1) == 2
        assert (o0.value, l0.value, o1.value, l1.value) == (12, 4, 0, 4)
        # over-capacity clamps to capacity
        assert lib.crlot_ring_split(h, 0, 100, o0, l0, o1, l1) == 1
        assert l0.value == 16
        lib.crlot_ring_split(h, 35, 4, o0, l0, o1, l1)  # start wraps
        assert o0.value == 3
    finally:
        lib.crlot_ring_destroy(h)


def test_native_ring_write_read_shadow(lib):
    for shadow in (0, 1):
        h = lib.crlot_ring_create(8, shadow)
        try:
            src = np.arange(1, 7, dtype=np.float32)
            lib.crlot_ring_write(h, 5, src.ctypes.data_as(ctypes.c_void_p), 6)
            out = np.zeros(6, dtype=np.float32)
            lib.crlot_ring_read(h, 5, out.ctypes.data_as(ctypes.c_void_p), 6)
            np.testing.assert_array_equal(out, src)  # wrap-around round trip
        finally:
            lib.crlot_ring_destroy(h)


def test_native_ring_zero_capacity_rejected(lib):
    assert not lib.crlot_ring_create(0, 0)
    assert not lib.crlot_ring_create(-5, 0)


def test_native_wav_fuzz(lib, tmp_path):
    """Malformed WAVs: a clean WavFormatError, or finite samples and a
    positive rate; never a crash (the reference's dr_wav posture,
    io/wav.cc:30-58)."""
    good = tmp_path / "good.wav"
    rng = np.random.default_rng(0)
    write_wav(str(good), rng.uniform(-0.5, 0.5, 2000).astype(np.float32),
              16000, bits=16)
    blob = good.read_bytes()
    cases = [blob[:c] for c in (0, 3, 11, 12, 20, 43, 44, len(blob) // 2,
                                len(blob) - 1)]
    for pos in (0, 8, 20, 22, 34, 40):
        b = bytearray(blob)
        b[pos] ^= 0xFF
        cases.append(bytes(b))
    cases += [b"", b"RIFF" + b"\x00" * 100, rng.bytes(256)]
    bad = tmp_path / "bad.wav"
    for i, payload in enumerate(cases):
        bad.write_bytes(payload)
        try:
            data, sr = N.read_wav_native(str(bad))
        except (WavFormatError, ValueError) as e:
            assert str(e), f"case {i}"
            continue
        assert np.isfinite(np.asarray(data)).all(), f"case {i}"
        assert sr > 0, f"case {i}"


@pytest.mark.parametrize(
    "dtype", ["float32", "float64", "int16", "int32", "uint16", "uint32"])
def test_native_ring_dtype_generic(lib, dtype):
    """The reference instantiates RingBuffer<T> for six element types
    (ring_buffer.cc:207-213); the native ring keeps that contract."""
    rng = np.random.default_rng(7)
    for shadow in (False, True):
        ring = N.NativeRing(12, dtype=dtype, shadow=shadow)
        info = (np.iinfo(dtype)
                if np.issubdtype(np.dtype(dtype), np.integer) else None)
        raw = (rng.integers(info.min, info.max, 9) if info
               else rng.uniform(-1, 1, 9))
        data = np.asarray(raw, dtype=dtype)
        ring.write(10, data)  # wraps: 2 at [10, 12), 7 at [0, 7)
        got = ring.read(10, 9)
        np.testing.assert_array_equal(got, data)
        assert got.dtype == np.dtype(dtype)
        ring.write(7, data[:3])  # elsewhere: the wrapped span is untouched
        np.testing.assert_array_equal(ring.read(10, 9), data)


def test_native_ring_rejects_bad_dtype(lib):
    with pytest.raises(ValueError):
        N.NativeRing(8, dtype="complex64")
    with pytest.raises(ValueError):
        N.NativeRing(0)


# --- added ------------------------------------------------------------------


def test_source_is_a_byte_copy_of_the_reference():
    ref = (REPO / "native" / "crlot_native.cpp").read_bytes()
    assert N.SRC.read_bytes() == ref
    assert b"crlot_native_abi_version() { return 2; }" in ref
    assert N.ABI_VERSION == 2


@pytest.mark.parametrize("bits,float_format",
                         [(16, False), (24, False), (32, False), (32, True)])
def test_wav_native_matches_the_jax_package_codec(lib, tmp_path, bits,
                                                  float_format):
    """The port's native encode is byte-equal to `crlot_tpu.io.wav`'s, and
    each side decodes the other's file to equal samples."""
    x = _sig(5003, 2, seed=3)
    p_ref = str(tmp_path / "ref.wav")
    p_nat = str(tmp_path / "nat.wav")
    jwav.write_wav(p_ref, x, 44100, bits=bits, float_format=float_format)
    N.write_wav_native(p_nat, x, 44100, bits=bits, float_format=float_format)
    assert Path(p_ref).read_bytes() == Path(p_nat).read_bytes()
    a, ra = jwav.read_wav(p_nat)
    b, rb = N.read_wav_native(p_ref)
    assert ra == rb == 44100
    np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("channels,frame,hop", [(1, 64, 16), (2, 1024, 256),
                                                (3, 100, 30)])
def test_native_framer_matches_the_jax_package_framer(lib, channels, frame,
                                                      hop):
    """The port's native framer hands out the batches of
    `crlot_tpu.frame.streaming.Framer`, bit for bit, across uneven pushes,
    a capped pop and the zero-padded tail."""
    rng = np.random.default_rng(11)
    total = 5 * frame + 37
    inter = rng.uniform(-1, 1, total * channels).astype(np.float32)
    ref = JaxFramer(frame, hop, channels=channels)
    nat = N.NativeFramer(frame, hop, channels=channels)
    cuts = np.sort(rng.integers(0, total, 6))
    for chunk in np.split(inter.reshape(total, channels), cuts):
        ref.push(chunk.reshape(-1))
        nat.push(chunk.reshape(-1))
        assert ref.available() == nat.available()
        np.testing.assert_array_equal(np.asarray(ref.pop_batch(2)),
                                      nat.pop_batch(2))
    ref.flush()
    nat.flush()
    assert ref.available() == nat.available()
    np.testing.assert_array_equal(np.asarray(ref.pop_batch()),
                                  nat.pop_batch())


def test_four_processes_build_one_fresh_directory(tmp_path):
    """Four processes started together against one empty build directory:
    one compiles (under the lock, to a temporary name, renamed into
    place), every one loads the library and reads its ABI version, and
    nothing is left beside it but the lock."""
    root = tmp_path / "native_build"
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from crlot_tpu_torch.io import native as N\n"
        "N.BUILD_ROOT = Path(sys.argv[1])\n"
        "lib = N.get_lib()\n"
        "print('ABI', lib.crlot_native_abi_version(), N.library_path())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(root)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=tmp_path)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert "ABI 2" in out, out + err
    paths = {out.split()[-1] for out, _ in outs}
    assert len(paths) == 1
    so = Path(paths.pop())
    assert so.parent.parent == root and so.exists()
    assert sorted(p.name for p in so.parent.iterdir()) == [
        "libcrlot_native.so", "lock"]


def test_library_lives_under_build_not_native(lib):
    """The port's library is built under `build/crlot_tpu_torch/native/`;
    the reference's `native/` directory gains nothing from the port."""
    so = N.library_path()
    assert so.exists()
    assert so.is_relative_to(REPO / "build" / "crlot_tpu_torch" / "native")
    assert not str(so).startswith(str(REPO / "native") + os.sep)
    assert N.SRC.parent == REPO / "crlot_tpu_torch" / "csrc"


def test_native_available_wherever_gxx_is():
    """Where g++ is on the PATH the library builds and loads: a broken
    build raises here rather than turning into a skip."""
    if shutil.which("g++") is None:
        assert not N.native_available()
    else:
        assert N.native_available()


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with its output; nothing is left at the
    library's path."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(N, "SRC", bad)
    out = tmp_path / "b" / "libcrlot_native.so"
    assert shutil.which("g++") is not None
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        N.build(out)
    assert not out.exists()
    assert [p.name for p in out.parent.iterdir()] == ["lock"]
