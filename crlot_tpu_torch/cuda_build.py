"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` file (with the `csrc/*.cuh` headers they share) is
compiled by its own `nvcc` for Hopper (`sm_90a`),
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with `ctypes`. The build
happens at first use, never at import, into `build/crlot_tpu_torch/<digest>/`
beside the package (listed in `.gitignore`); the digest covers the sources
and the flags, so an edited kernel is rebuilt and an unchanged one is
reused within a checkout.

No `--use_fast_math`: divisions and square roots stay IEEE-rounded, which
the bit-exact OLA kernel relies on. A failed build raises; nothing falls
back to another route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "crlot_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_LIB = None
build_log = ""  # nvcc's output (ptxas register / shared-memory report)
build_seconds = 0.0

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    # (frames, norm, out, batch, n_frames, nfft, hop, out_len, eps, stream)
    "crlot_ola_normalized": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _VP],
    # (frames, seed, seed_len, norm, out, batch, n_frames, nfft, hop, t0,
    #  len, f_lo, f_hi, eps, stream)
    "crlot_ola_seeded_normalized": [
        _VP, _VP, _I, _VP, _VP, *[_I] * 8, _F, _VP,
    ],
    # (x, ch_stride, lp, frame_stride, window, c_hi, c_lo, s_hi, s_lo,
    #  cinv_hi, cinv_lo, sinv_hi, sinv_lo, desc, n_ops, params, e, o, re,
    #  im, out, channels, n_frames, nfft, stream)
    "crlot_rt_frames": [
        _VP, _LL, _LL, _LL, _VP, *[_VP] * 8, _VP, _I, _VP,
        _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP,
    ],
    # (x, ch_stride, lp, frame_stride, window, e, o, channels, n_frames,
    #  nfft, stream)
    "crlot_rt_fold": [_VP, _LL, _LL, _LL, _VP, _VP, _VP, _I, _I, _I, _VP],
    # (e, o, c_hi, c_lo, s_hi, s_lo, desc, n_ops, params, re, im, rows,
    #  nfft, stream)
    "crlot_rt_forward": [*[_VP] * 7, _I, _VP, _VP, _VP, _LL, _I, _VP],
    # (re, im, cinv_hi, cinv_lo, sinv_hi, sinv_lo, out, rows, nfft, stream)
    "crlot_rt_inverse": [*[_VP] * 7, _LL, _I, _VP],
    # (rows, nfft, out[6]): the GEMMs' plan, fft/fused_rt.py's gemm_plan
    "crlot_rt_plan": [_LL, _I, _VP],
    # (x, t_in, u, nc, span, taps_t, offsets, out, channels, n_out, l, m,
    #  tp, w, tau_min, h0, j, r, wc, seg_floats, stream)
    "crlot_resample": [
        _VP, _LL, _VP, _I, _I, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I,
        _I, _I, _I, _I, _LL, _VP,
    ],
    # (dst, src, gain, out, n, stream)
    "crlot_axpy": [_VP, _VP, _F, _VP, _LL, _VP],
    # (dst, src, win, gain, out, n, stream)
    "crlot_axpy_windowed": [_VP, _VP, _VP, _F, _VP, _LL, _VP],
    # (acc, norm, eps, out, cleared, n, stream)
    "crlot_normalize_and_clear": [_VP, _VP, _F, _VP, _VP, _LL, _VP],
    # (mode, a0, a1, lda, a_batch, b0, b1, k_bytes, out, ldc, c_batch, m, n,
    #  batch, scale, stream)
    "crlot_b6_gemm": [
        _I, _VP, _VP, _LL, _LL, _VP, _VP, _I, _VP, _LL, _LL, _I, _I, _I, _F,
        _VP,
    ],
    # (variant, x, m, k, b0, b1, cs, row_scale, out, n, stream)
    "crlot_b6_fusedq": [_I, _VP, _I, _I, _VP, _VP, _VP, _VP, _VP, _I, _VP],
    # (x, lda, a_batch, w, k, n, out, m, batch, stream)
    "crlot_fp32_window": [_VP, _LL, _LL, _VP, _I, _I, _VP, _I, _I, _VP],
    # (x, row_stride, hop, n, frames, rows, window, tables, out, radices,
    #  tm, smem_bytes, stream)
    "crlot_stft_fp32_window": [
        _VP, _LL, _LL, _I, _I, _I, _VP, _VP, _VP, _LL, _I, _I, _VP,
    ],
}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "crlot_tpu_torch cannot be built"
    )


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[Path]) -> str:
    """Of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def compile_library(out_path: Path) -> str:
    """Compile every source with its own nvcc, all at once, and link the
    objects into `out_path`; returns nvcc's output."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=out_path.parent) as tmp:
        objs = [str(Path(tmp) / f"{p.stem}.o") for p in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                for p, o in zip(srcs, objs)]
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            logs = list(pool.map(_run, cmds))
        so_tmp = str(Path(tmp) / out_path.name)
        logs.append(_run([nvcc, *LINK_FLAGS, "-o", so_tmp, *objs]))
        os.replace(so_tmp, out_path)
    return "".join(logs)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _LIB, build_log, build_seconds
    if _LIB is not None:
        return _LIB
    srcs = sources()
    so = BUILD_ROOT / _digest(srcs) / "libcrlot_tpu_torch.so"
    if not so.exists():
        t0 = time.perf_counter()
        build_log = compile_library(so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.crlot_error_string.argtypes = [ctypes.c_int]
    lib.crlot_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        msg = _LIB.crlot_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} at launch: {msg}")


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(what: str, *tensors) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} needs its tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")


def launch(name: str, device, *args) -> None:
    """Call the library's `name` with `args` and the current stream of
    `device` appended, inside `torch.cuda.device(device)`: the launch, and
    any per-device setup it does (shared-memory attributes, the SM count),
    happens on the tensors' card, not on whichever card is current. Raises
    on a non-zero status."""
    import torch

    lib = load_library()
    with torch.cuda.device(device):
        status = getattr(lib, name)(*args, stream_handle(device))
    check(status, name)
