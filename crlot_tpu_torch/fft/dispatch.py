"""FFT backend dispatch for the STFT pipeline.

Counterpart of `crlot_tpu/fft/dispatch.py`. AUTO follows the device of the
tensor, as the reference follows its backend: on a CUDA tensor the real
transforms run the folded DFT products (what the reference's accelerator
runs), on a CPU tensor `torch.fft` (what the reference's CPU runs), so the
CPU parity tests compare like with like. Every product is IEEE fp32.

The complex transforms run `torch.fft` on AUTO on every device. Only an
explicit MATMUL takes the port's matmul form, one product by the real
[2N, 2N] form of the DFT matrix: O(N^2) a row and 16 N^2 bytes of basis
(268 MB at N = 4096), where the reference runs Cooley-Tukey products for
powers of two (not ported yet). MATMUL above `MAX_MATMUL_NFFT` raises.
"""

from __future__ import annotations

from functools import lru_cache

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


@lru_cache(maxsize=2)  # one N's two directions: <= 537 MB at N = 4096
def _complex_basis_on(nfft: int, inverse: bool,
                      device: torch.device) -> torch.Tensor:
    """f32 [2N, 2N] B with [re | im] @ B = [Re | Im] of x @ W, W[j, k] =
    exp(-+2 pi i jk / N) (1/N included in the inverse); designed in
    float64 with the phase reduced mod N exactly."""
    k = np.arange(nfft, dtype=np.int64)
    ph = (np.outer(k, k) % nfft) * (2.0 * np.pi / nfft)
    c = np.cos(ph)
    s = np.sin(ph) if inverse else -np.sin(ph)
    b = np.block([[c, s], [-s, c]])
    if inverse:
        b = b / nfft
    return torch.from_numpy(b.astype(np.float32)).to(device)


def _complex_matmul(x: torch.Tensor, nfft: int, inverse: bool):
    _check_complex_matmul(nfft)
    t = x.shape[-1]
    x = x[..., :nfft] if t >= nfft else torch.nn.functional.pad(
        x, (0, nfft - t))
    b = _complex_basis_on(nfft, inverse, x.device)
    y = torch.matmul(torch.cat([x.real, x.imag], dim=-1).float(), b)
    return torch.complex(y[..., :nfft], y[..., nfft:])


def _check_complex_matmul(nfft: int) -> None:
    if nfft > _mm.MAX_MATMUL_NFFT:
        raise NotImplementedError(
            f"MATMUL backend covers nfft <= {_mm.MAX_MATMUL_NFFT} in the port "
            f"so far, got {nfft} (ROADMAP queue A, opt-in backends)"
        )


def fft_complex(
    x: torch.Tensor, nfft: int, backend: FftBackend = FftBackend.AUTO
) -> torch.Tensor:
    """Complex forward FFT -> complex64 [..., nfft] (x cropped or
    zero-padded to nfft)."""
    x = x.to(torch.complex64)
    if backend == FftBackend.MATMUL:
        return _complex_matmul(x, nfft, inverse=False)
    return torch.fft.fft(x, n=nfft, dim=-1)


def ifft_complex(
    x: torch.Tensor, nfft: int, backend: FftBackend = FftBackend.AUTO
) -> torch.Tensor:
    """Complex inverse FFT, 1/N included."""
    x = x.to(torch.complex64)
    if backend == FftBackend.MATMUL:
        return _complex_matmul(x, nfft, inverse=True)
    return torch.fft.ifft(x, n=nfft, dim=-1)
