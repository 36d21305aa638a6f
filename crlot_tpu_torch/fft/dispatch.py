"""FFT backend dispatch for the STFT pipeline.

Counterpart of `crlot_tpu/fft/dispatch.py`, route for route:

  - XLA:    `torch.fft` (any N);
  - MATMUL: the DFT as matrix products (IEEE fp32): for nfft <= 4096 the
            folded half-size products (even N; where N % 256 == 0 the
            reference takes their tiled cores, `rfft_folded`, made for the
            TPU's 128 lanes, and the port keeps the untiled products) or
            the dense [N, N+2] basis (odd N); above 4096 the two-stage Cooley-Tukey products for a
            power of two (`ct_backend.py`), `torch.fft` otherwise. The
            complex transforms run Cooley-Tukey for a power of two and
            `torch.fft` otherwise;
            On a CUDA card the windowed rFFT of float32 frames (a frame's
            samples contiguous, N even in [16, 1024] with N/2 a product of
            2, 3, 5 and 7) is B7, one hand-written fp32 FFT kernel that
            reads the frames in place (`fp32_window.stft_cuda`); elsewhere
            the folded products are `matmul_backend.rfft_folded_packed`'s
            torch ops;
  - AUTO:   follows the device of the tensor, as the reference follows its
            backend: on a CUDA tensor MATMUL for an even N <= 4096 or a
            power of two (the reference accelerator's rule), on a CPU
            tensor `torch.fft` (what the reference's CPU runs), so the CPU
            parity tests compare like with like.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.consts import const_on
from ..core.types import FftBackend
from . import ct_backend as _ct
from . import fp32_window as _fp32
from . import matmul_backend as _mm


def _is_pow2(n: int) -> bool:
    return n > 0 and not (n & (n - 1))


def _pick(backend: FftBackend, nfft: int, device: torch.device) -> FftBackend:
    if backend in (FftBackend.XLA, FftBackend.MATMUL):
        return backend
    if device.type == "cuda" and nfft % 2 == 0 and (
            nfft <= _mm.MAX_MATMUL_NFFT or _is_pow2(nfft)):
        return FftBackend.MATMUL
    return FftBackend.XLA


def _fit(x: torch.Tensor, nfft: int) -> torch.Tensor:
    """x cropped or zero-padded to nfft on its last axis, as numpy does."""
    t = x.shape[-1]
    return x[..., :nfft] if t >= nfft else torch.nn.functional.pad(
        x, (0, nfft - t))


def _folds(nfft: int) -> bool:
    """Whether the products take the folded halves."""
    return nfft <= _mm.MAX_MATMUL_NFFT and nfft % 2 == 0


def _mm_rfft(x: torch.Tensor, nfft: int) -> torch.Tensor:
    if nfft <= _mm.MAX_MATMUL_NFFT:
        if _folds(nfft):
            return torch.complex(*_mm.rfft_folded_packed(x, nfft))
        return _mm.rfft_matmul(x, nfft)
    if _is_pow2(nfft):
        return _ct.rfft_ct(x, nfft)
    return torch.fft.rfft(x.float(), n=nfft, dim=-1)


def rfft(
    x: torch.Tensor, nfft: int, backend: FftBackend = FftBackend.AUTO
) -> torch.Tensor:
    """rfft(x, n=nfft) -> complex64 [..., nfft//2+1] (x cropped or
    zero-padded to nfft, as numpy does)."""
    if _pick(backend, nfft, x.device) == FftBackend.MATMUL:
        return _mm_rfft(_fit(x, nfft), nfft)
    return torch.fft.rfft(x.float(), n=nfft, dim=-1)


def windowed_route(nfft: int, device, dtype=torch.float32,
                   last_stride: int = 1,
                   backend: FftBackend = FftBackend.AUTO) -> str:
    """The route `rfft_windowed` takes on frames of `dtype` on `device`
    whose samples lie `last_stride` apart: "B7" (the MATMUL route on a
    card, `fp32_window.stft_takes`), "folded" (the folded products'
    torch ops), "dense" (odd N), "ct" (Cooley-Tukey) or "torch_fft"."""
    if _pick(backend, nfft, torch.device(device)) == FftBackend.MATMUL:
        if _folds(nfft):
            if _fp32.stft_takes(device, dtype, last_stride, nfft):
                return "B7"
            return "folded"
        if nfft <= _mm.MAX_MATMUL_NFFT:
            return "dense"
        if _is_pow2(nfft):
            return "ct"
    return "torch_fft"


def rfft_windowed(
    x: torch.Tensor, nfft: int, window_f64: np.ndarray,
    backend: FftBackend = FftBackend.AUTO,
) -> torch.Tensor:
    """rfft(x * window) -> complex64 [..., nfft//2+1]; on the products of
    nfft <= 4096 the window folds into the basis; B7 applies it as it
    reads the frames."""
    route = windowed_route(nfft, x.device, x.dtype, x.stride(-1), backend)
    if route == "B7":
        return _fp32.stft_cuda(x, nfft, const_on(window_f64, x.device))
    if route == "folded":
        return torch.complex(*_mm.rfft_folded_packed(x, nfft, window_f64))
    if route == "dense":
        return _mm.rfft_matmul(x, nfft, window_f64)
    x = x.float() * const_on(window_f64, x.device)
    if route == "ct":
        return _ct.rfft_ct(x, nfft)
    return torch.fft.rfft(x, n=nfft, dim=-1)


def rfft_windowed_bytes(shape, nfft: int, device: torch.device,
                        backend: FftBackend = FftBackend.AUTO,
                        dtype=torch.float32, last_stride: int = 1) -> int:
    """The bytes `rfft_windowed` writes on frames of `shape` [..., nfft]
    (of `dtype`, samples `last_stride` apart) besides its complex output,
    from the shape alone: none on B7; on the folded products
    `matmul_backend.rfft_folded_bytes`; on the dense product its two
    planes; else the windowed frames (a transform's own scratch is not
    seen)."""
    rows = math.prod(shape[:-1])
    route = windowed_route(nfft, device, dtype, last_stride, backend)
    if route == "B7":
        return 0
    if route == "folded":
        return _mm.rfft_folded_bytes(rows, nfft)
    if route == "dense":
        return 4 * rows * 2 * (nfft // 2 + 1)
    return 4 * rows * nfft


def irfft(
    spec: torch.Tensor, nfft: int, backend: FftBackend = FftBackend.AUTO
) -> torch.Tensor:
    """complex [..., nfft//2+1] -> real [..., nfft] (1/N included)."""
    if _pick(backend, nfft, spec.device) == FftBackend.MATMUL:
        if nfft <= _mm.MAX_MATMUL_NFFT:
            if nfft % 2 == 0:
                return _mm.irfft_folded_parts(spec.real, spec.imag, nfft)
            return _mm.irfft_matmul(spec, nfft)
        if _is_pow2(nfft):
            return _ct.irfft_ct(spec, nfft)
    return torch.fft.irfft(spec, n=nfft, dim=-1)


def fft_complex(
    x: torch.Tensor, nfft: int, backend: FftBackend = FftBackend.AUTO
) -> torch.Tensor:
    """Complex forward FFT -> complex64 [..., nfft] (x cropped or
    zero-padded to nfft): Cooley-Tukey products on the MATMUL route for a
    power of two, `torch.fft` otherwise."""
    x = x.to(torch.complex64)
    if _pick(backend, nfft, x.device) == FftBackend.MATMUL and _is_pow2(nfft):
        return _ct.fft_ct(_fit(x, nfft), nfft)
    return torch.fft.fft(x, n=nfft, dim=-1)


def ifft_complex(
    x: torch.Tensor, nfft: int, backend: FftBackend = FftBackend.AUTO
) -> torch.Tensor:
    """Complex inverse FFT, 1/N included."""
    x = x.to(torch.complex64)
    if _pick(backend, nfft, x.device) == FftBackend.MATMUL and _is_pow2(nfft):
        return _ct.ifft_ct(_fit(x, nfft), nfft)
    return torch.fft.ifft(x, n=nfft, dim=-1)
