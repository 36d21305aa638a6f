"""Every kernel launch runs on its tensors' device (ROADMAP C10).

Each wrapper launches through `cuda_build.launch`, which enters
`torch.cuda.device(<the tensors' device>)` around the library call, so that
the launch and any per-device setup in it (shared-memory attributes, the SM
count) happen on that card and not on whichever card is current. Here, on
the CPU, `torch.cuda.device` is replaced by a recorder, the library by a
fake whose functions note the device entered at the moment they are called,
and the device check by a no-op, so that each wrapper runs its real
argument handling on CPU tensors up to the (fake) launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import re

import numpy as np
import pytest
import torch

from crlot_tpu_torch import cuda_build
from crlot_tpu_torch import int8_gemm as b6
from crlot_tpu_torch.fft import fused_rt, tf32x3
from crlot_tpu_torch.ola import fused as b1
from crlot_tpu_torch.ola import kernels as b5
from crlot_tpu_torch.resample import kernel as b4


@pytest.fixture
def guarded(monkeypatch):
    """{"inside": the device entered now, "calls": [(function, device
    entered when it was called)]}; the launch counters are restored."""
    state = {"inside": None, "calls": [], "entered": []}

    @contextlib.contextmanager
    def device(d):
        state["entered"].append(torch.device(d))
        before, state["inside"] = state["inside"], torch.device(d)
        try:
            yield
        finally:
            state["inside"] = before

    class Lib:
        def __getattr__(self, name):
            def fn(*args):
                state["calls"].append((name, state["inside"]))
                return 0
            return fn

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(cuda_build, "load_library", lambda: Lib())
    monkeypatch.setattr(cuda_build, "stream_handle",
                        lambda d: ctypes.c_void_p(0))
    monkeypatch.setattr(cuda_build, "require_cuda", lambda what, *t: None)
    for mod, name in ((b1, "launches"), (b4, "launches"),
                      (fused_rt, "launches"), (fused_rt, "frames_launches"),
                      (tf32x3, "launches")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    monkeypatch.setattr(b5, "launches", dict(b5.launches))
    monkeypatch.setattr(fused_rt, "packed_launches",
                        dict(fused_rt.packed_launches))
    monkeypatch.setattr(b6, "launches", dict(b6.launches))
    return state


def _rand(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "i":
        info = np.iinfo(dtype)
        return torch.from_numpy(
            rng.integers(info.min, info.max, shape, dtype=dtype))
    return torch.from_numpy(rng.uniform(-1, 1, shape).astype(dtype))


def _b1():
    frames, norm = _rand((2, 8, 64), 1), _rand(176, 2).abs() + 0.5
    b1.ola_normalized_cuda(frames, norm, 16, 176)
    return "crlot_ola_normalized", frames.device


def _b2():
    """B2 is B3's frames, then B1's overlap-add: two library calls."""
    padded, w = _rand((1, 8192), 3), _rand(1024, 4)
    fused_rt.roundtrip_signal_cuda(padded, 1024, 256, 29, w,
                                   torch.ones(8192), 1e-8, 8192)
    return ("crlot_rt_frames", "crlot_ola_normalized"), padded.device


def _b3():
    padded, w = _rand((1, 8192), 5), _rand(1024, 6)
    fused_rt.roundtrip_frames_cuda(padded, 1024, 256, 29, w)
    return "crlot_rt_frames", padded.device


def _b3_of_frames():
    x = _rand((2, 8192), 30)
    frames = x.unfold(-1, 1024, 256)
    fused_rt.roundtrip_of_frames(frames.to("meta"), 1024, _rand(1024, 31))
    return "crlot_rt_frames", torch.device("meta")


def _split_fold():
    padded, w = _rand((2, 8192), 36), _rand(2048, 37)
    fused_rt.packed_fold_cuda(padded, 2048, 512, 9, w)
    return "crlot_rt_fold", padded.device


def _split_planes(nfft, rows, seed):
    kp = fused_rt.padded_bins(nfft)
    return _rand((rows, kp), seed), _rand((rows, kp), seed + 1)


def _split_forward():
    e, o = _split_planes(4096, 18, 38)
    bases = fused_rt.kernel_bases_on(4096, e.device)
    fused_rt.packed_forward_cuda(e, o, 4096, bases[:4])
    return "crlot_rt_forward", e.device


def _split_inverse():
    re, im = _split_planes(4096, 18, 40)
    bases = fused_rt.kernel_bases_on(4096, re.device)
    fused_rt.packed_inverse_cuda(re, im, 4096, bases[4:])
    return "crlot_rt_inverse", re.device


def _b0():
    x = _rand((2, 15 * 512 + 2048), 32)
    bt = _rand((512, 2048), 33)
    tf32x3.gemm_cuda(x, bt, bt, rows=16, lda=512)
    return "crlot_b6_gemm", x.device


def _b4():
    x = _rand((2, 4410), 7)
    b4.resample_cuda(x, 160, 147, 4800)
    return "crlot_resample", x.device


def _b4_unstaged():
    x = _rand((1, 48000), 8)
    b4.resample_cuda(x, 1, 160, 300)
    return "crlot_resample", x.device


def _axpy():
    a, b = _rand(100, 9), _rand(100, 10)
    b5.axpy_cuda(a, b, 1.5)
    return "crlot_axpy", a.device


def _axpy_windowed():
    a, b, w = _rand(100, 11), _rand(100, 12), _rand(100, 13)
    b5.axpy_windowed_cuda(a, b, w, 0.5)
    return "crlot_axpy_windowed", a.device


def _normalize():
    a, n = _rand(100, 14), _rand(100, 15).abs()
    b5.normalize_and_clear_cuda(a, n, 1e-8)
    return "crlot_normalize_and_clear", a.device


def _i8():
    a, bt = _rand((256, 128), 16, np.int8), _rand((64, 128), 17, np.int8)
    b6.i8_gemm_cuda(a, bt)
    return "crlot_b6_gemm", a.device


def _probe3():
    a0, a1 = _rand((256, 128), 18, np.int8), _rand((256, 128), 19, np.int8)
    b0, b1_ = _rand((64, 128), 20, np.int8), _rand((64, 128), 21, np.int8)
    b6.limb_gemm_cuda(a0, a1, b0, b1_, "probe3")
    return "crlot_b6_gemm", a0.device


def _wire_i16():
    x = _rand((1, 15 * 512 + 2048), 22, np.int16)
    kh, kl = _rand((512, 2048), 23, np.int8), _rand((512, 2048), 24, np.int8)
    b6.limb_gemm_i16_cuda(x, kh, kl, "wire2", 1e-5, rows=16, lda=512)
    return "crlot_b6_gemm", x.device


def _bf16():
    a = _rand((256, 128), 25).to(torch.bfloat16)
    bt = _rand((64, 128), 26).to(torch.bfloat16)
    b6.bf16_gemm_cuda(a, bt)
    return "crlot_b6_gemm", a.device


def _fusedq():
    x = _rand((64, 128), 27)
    bt, b2t = _rand((64, 128), 28, np.int8), _rand((64, 128), 29, np.int8)
    b6.fusedq_gemm_cuda(x, bt, b2t)
    return "crlot_b6_fusedq", x.device


def _fusedq_ref():
    x = _rand((64, 128), 30)
    bh, bl = _rand((64, 128), 31, np.int8), _rand((64, 128), 32, np.int8)
    b6.fusedq_ref_gemm_cuda(x, bh, bl, _rand((64,), 33))
    return "crlot_b6_fusedq", x.device


def _b0_fp32():
    from crlot_tpu_torch.fft import fp32_window

    x = _rand((2, 15 * 128 + 512), 34)
    fp32_window.gemm_cuda(x, _rand((512, 128), 35), rows=16, lda=128)
    return "crlot_fp32_window", x.device


WRAPPERS = {
    "B0 tf32x3": _b0, "B1 ola_normalized": _b1, "B2 rt_ola": _b2,
    "B3 rt_frames": _b3, "B3 of frames": _b3_of_frames,
    "B4 runs": _b4, "B4 windows": _b4_unstaged, "B5 axpy": _axpy,
    "B5 axpy_windowed": _axpy_windowed, "B5 normalize": _normalize,
    "B6-i8": _i8, "B6-limb probe3": _probe3, "B6-limb int16": _wire_i16,
    "B6-bf16": _bf16, "B6-fusedq": _fusedq, "K11 dot_i8x2": _fusedq_ref,
    "B0 fp32": _b0_fp32, "B2 split fold": _split_fold,
    "B2 split forward": _split_forward, "B2 split inverse": _split_inverse,
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_launches_inside_its_tensors_device(guarded, name):
    """Each library call (B2 makes two) made while `torch.cuda.device` was
    entered with the wrapper's tensor device, and the guard left
    afterwards."""
    fns, device = WRAPPERS[name]()
    fns = (fns,) if isinstance(fns, str) else fns
    assert guarded["calls"] == [(fn, device) for fn in fns]
    assert guarded["entered"] == [device] * len(fns)
    assert guarded["inside"] is None


def test_launch_passes_the_devices_stream_inside_the_guard(monkeypatch):
    """`cuda_build.launch` asks for the stream of the device it entered,
    appends it to the arguments, and raises on a non-zero status."""
    seen = []

    @contextlib.contextmanager
    def device(d):
        seen.append(("enter", d))
        yield
        seen.append(("exit", d))

    class Lib:
        def crlot_axpy(self_, *args):
            seen.append(("call", args))
            return 0

        def crlot_error_string(self_, status):
            return b"bad launch"

        def crlot_resample(self_, *args):
            return 1

    lib = Lib()
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(cuda_build, "load_library", lambda: lib)
    monkeypatch.setattr(cuda_build, "_LIB", lib)
    monkeypatch.setattr(cuda_build, "stream_handle",
                        lambda d: ("stream of", d))
    dev = torch.device("meta")
    cuda_build.launch("crlot_axpy", dev, 1, 2)
    assert seen == [("enter", dev), ("call", (1, 2, ("stream of", dev))),
                    ("exit", dev)]
    with pytest.raises(RuntimeError, match="bad launch"):
        cuda_build.launch("crlot_resample", dev)


@pytest.mark.parametrize("devices", [
    ["cuda:0"], ["cuda:0", "cuda:1"], ["cpu"], ["meta"], ["cuda:1", "cpu"]])
def test_require_cuda_wants_one_cuda_device(devices):
    fake = [type("T", (), {"device": torch.device(d)})() for d in devices]
    ok = len(set(devices)) == 1 and devices[0].startswith("cuda")
    if ok:
        cuda_build.require_cuda("x", *fake)
    else:
        with pytest.raises(ValueError, match="one CUDA device"):
            cuda_build.require_cuda("x", *fake)


def test_no_wrapper_calls_the_library_outside_launch():
    """The only path to a kernel is `cuda_build.launch`: no module of the
    port calls a `crlot_*` function of the library itself."""
    from pathlib import Path

    pkg = Path(cuda_build.__file__).parent
    for p in pkg.rglob("*.py"):
        text = p.read_text()
        assert not re.search(r"\blib\.crlot_\w+\(", text), p
        assert not re.search(r"load_library\(\)\.crlot_", text), p


def test_b6_sm90_sets_its_attributes_per_device():
    """The TMA kernel's shared-memory attribute and register check are kept
    per device (an array indexed by cudaGetDevice), not once per process;
    the other kernels set theirs at every launch."""
    src = cuda_build.CSRC
    sm90 = (src / "b6_sm90.cu").read_text()
    assert re.search(r"static int entry_regs\[kMaxDevices\]", sm90)
    assert not re.search(r"static int entry_regs\s*=", sm90)
    for entry in ("int launch_sm90(", "int launch_fusedq("):
        body = sm90[sm90.index(entry):]
        assert body.index("cudaGetDevice(&device)") < body.index(
            "prepare<MODE>(device)")
    for name in ("resample.cu",):
        text = (src / name).read_text()
        assert "cudaFuncSetAttribute" in text
        assert not re.search(r"\bstatic\b", text), name
