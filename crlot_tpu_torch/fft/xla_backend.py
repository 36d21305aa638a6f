"""Library-FFT transforms (`torch.fft`) with the reference's scrub contract.

Counterpart of `crlot_tpu/fft/xla_backend.py`: each forward (`rfft`, the
complex `fft`) scrubs NaN/Inf and |x| < 1e-30 to 0 on its input, each
inverse (`irfft`, `ifft`) includes 1/N and scrubs its output, and the REAL
forward yields nfft/2+1 bins.
"""

from __future__ import annotations

import torch

DENORMAL_THRESHOLD = 1e-30


def scrub(x: torch.Tensor) -> torch.Tensor:
    """NaN/Inf -> 0 and tiny values -> 0, per component for complex input."""
    if x.is_complex():
        return torch.complex(scrub(x.real), scrub(x.imag))
    x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.where(x.abs() < DENORMAL_THRESHOLD, torch.zeros_like(x), x)


def rfft(x: torch.Tensor, nfft: int, do_scrub: bool = True) -> torch.Tensor:
    x = x.float()
    return torch.fft.rfft(scrub(x) if do_scrub else x, n=nfft, dim=-1)


def irfft(x: torch.Tensor, nfft: int, do_scrub: bool = True) -> torch.Tensor:
    y = torch.fft.irfft(x.to(torch.complex64), n=nfft, dim=-1)
    return scrub(y) if do_scrub else y


def fft(x: torch.Tensor, nfft: int, do_scrub: bool = True) -> torch.Tensor:
    x = x.to(torch.complex64)
    return torch.fft.fft(scrub(x) if do_scrub else x, n=nfft, dim=-1)


def ifft(x: torch.Tensor, nfft: int, do_scrub: bool = True) -> torch.Tensor:
    y = torch.fft.ifft(x.to(torch.complex64), n=nfft, dim=-1)
    return scrub(y) if do_scrub else y
