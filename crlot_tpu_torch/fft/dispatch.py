"""FFT backend dispatch for the STFT pipeline.

Counterpart of `crlot_tpu/fft/dispatch.py`. AUTO follows the device of the
tensor, as the reference follows its backend: on a CUDA tensor it runs the
folded DFT products (what the reference's accelerator runs), on a CPU
tensor `torch.fft` (what the reference's CPU runs), so the CPU parity tests
compare like with like. Every product is IEEE fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.consts import const_on
from ..core.types import FftBackend
from . import matmul_backend as _mm


def _pick(backend: FftBackend, nfft: int, device: torch.device) -> FftBackend:
    if backend in (FftBackend.XLA, FftBackend.MATMUL):
        return backend
    if device.type == "cuda" and nfft % 2 == 0 and nfft <= _mm.MAX_MATMUL_NFFT:
        return FftBackend.MATMUL
    return FftBackend.XLA


def _check_matmul(nfft: int) -> None:
    if nfft % 2 or nfft > _mm.MAX_MATMUL_NFFT:
        raise NotImplementedError(
            f"MATMUL backend covers even nfft <= {_mm.MAX_MATMUL_NFFT} in "
            f"the port so far, got {nfft} (ROADMAP queue A, opt-in backends)"
        )


def rfft(
    x: torch.Tensor, nfft: int, backend: FftBackend = FftBackend.AUTO
) -> torch.Tensor:
    """rfft(x, n=nfft) -> complex64 [..., nfft//2+1] (x cropped or
    zero-padded to nfft, as numpy does)."""
    if _pick(backend, nfft, x.device) == FftBackend.MATMUL:
        _check_matmul(nfft)
        t = x.shape[-1]
        y = x[..., :nfft] if t >= nfft else torch.nn.functional.pad(
            x, (0, nfft - t))
        re, im = _mm.rfft_folded_packed(y, nfft)
        return torch.complex(re, im)
    return torch.fft.rfft(x.float(), n=nfft, dim=-1)


def rfft_windowed(
    x: torch.Tensor, nfft: int, window_f64: np.ndarray,
    backend: FftBackend = FftBackend.AUTO,
) -> torch.Tensor:
    """rfft(x * window) -> complex64 [..., nfft//2+1]."""
    if _pick(backend, nfft, x.device) == FftBackend.MATMUL:
        _check_matmul(nfft)
        re, im = _mm.rfft_folded_packed(x, nfft, window_f64)
        return torch.complex(re, im)
    w = const_on(window_f64, x.device)
    return torch.fft.rfft(x.float() * w, n=nfft, dim=-1)


def irfft(
    spec: torch.Tensor, nfft: int, backend: FftBackend = FftBackend.AUTO
) -> torch.Tensor:
    """complex [..., nfft//2+1] -> real [..., nfft] (1/N included)."""
    if _pick(backend, nfft, spec.device) == FftBackend.MATMUL:
        _check_matmul(nfft)
        return _mm.irfft_folded_parts(spec.real, spec.imag, nfft)
    return torch.fft.irfft(spec, n=nfft, dim=-1)
