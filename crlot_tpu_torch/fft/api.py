"""Plan-based FFT API: `FftPlan` and `make_fft_plan`.

Counterpart of `crlot_tpu/fft/api.py`. A plan is a thin object over
`fft.dispatch` specialized on (nfft, scrub, backend), with its routes: on a
CUDA tensor AUTO runs the matmul DFT for a REAL plan (Cooley-Tukey products
for a power of two above 4096) and the Cooley-Tukey products for a
power-of-two COMPLEX plan, on a CPU tensor `torch.fft`. The contract is
the reference's: a REAL domain needs an even nfft, in-place raises, strides
are >= 1, the batch is not capped (`max_batch_size`), the inverse includes
1/nfft, and with `scrub` NaN/Inf and |x| < 1e-30 become 0 on the forward's
input and the inverse's output.

Shapes: natural inputs are [..., nfft] (real or complex); the `*_strided`
methods take the reference's flat strided layout (flat element
b*n*stride + i*stride). Array-like input goes to `device` (default
"cuda"; `core/device.py`); a tensor stays on its own device.
"""

from __future__ import annotations

import torch

from ..core import device as _device
from ..core.types import FftDomain, FftPlanDesc
from . import dispatch as _dispatch
from .xla_backend import scrub


class FftPlan:
    def __init__(self, desc: FftPlanDesc) -> None:
        self.desc = desc
        self._nfft = desc.nfft
        self._scrub = desc.scrub

    # --- capability introspection ---

    def supports_batch(self) -> bool:
        return True

    def max_batch_size(self) -> int:
        return 1 << 30  # not capped

    @property
    def num_bins(self) -> int:
        return self.desc.num_bins

    # --- natural [..., nfft] API ---

    def forward(self, x, device=None) -> torch.Tensor:
        """Real -> complex, [..., nfft] -> [..., nfft//2+1]."""
        self._require(FftDomain.REAL)
        x = _device.place(x, device, torch.float32)
        self._check_last(x, self._nfft)
        if self._scrub:
            x = scrub(x)
        return _dispatch.rfft(x, self._nfft, self.desc.backend)

    def inverse(self, spec, device=None) -> torch.Tensor:
        """Complex -> real, [..., nfft//2+1] -> [..., nfft]; includes
        1/nfft."""
        self._require(FftDomain.REAL)
        spec = _device.place(spec, device, torch.complex64)
        self._check_last(spec, self.num_bins)
        y = _dispatch.irfft(spec, self._nfft, self.desc.backend)
        return scrub(y) if self._scrub else y

    def forward_complex(self, x, device=None) -> torch.Tensor:
        self._require(FftDomain.COMPLEX)
        x = _device.place(x, device, torch.complex64)
        self._check_last(x, self._nfft)
        if self._scrub:
            x = scrub(x)
        return _dispatch.fft_complex(x, self._nfft, self.desc.backend)

    def inverse_complex(self, spec, device=None) -> torch.Tensor:
        """Complex inverse; includes 1/nfft."""
        self._require(FftDomain.COMPLEX)
        spec = _device.place(spec, device, torch.complex64)
        self._check_last(spec, self._nfft)
        y = _dispatch.ifft_complex(spec, self._nfft, self.desc.backend)
        return scrub(y) if self._scrub else y

    # --- flat strided layout ---

    def _destride(self, flat: torch.Tensor, elem: int,
                  stride: int) -> torch.Tensor:
        need = self.desc.batch * elem * stride
        if flat.shape[-1] < need - (stride - 1):
            raise ValueError(
                f"flat input of length {flat.shape[-1]} too short for "
                f"batch={self.desc.batch}, n={elem}, stride={stride}"
            )
        taken = flat[..., : need - (stride - 1) : stride]
        return taken.reshape(*flat.shape[:-1], self.desc.batch, elem)

    @staticmethod
    def _restride(x: torch.Tensor, stride: int) -> torch.Tensor:
        """[..., b, n] -> flat [..., b*n*stride]; the gaps between strided
        positions are zero-filled (the reference's functional contract)."""
        flat = x.reshape(*x.shape[:-2], -1)
        if stride == 1:
            return flat
        out = flat.new_zeros((*flat.shape[:-1], flat.shape[-1] * stride))
        out[..., ::stride] = flat
        return out

    def forward_strided(self, flat, device=None) -> torch.Tensor:
        """Flat strided real input -> flat strided complex bins."""
        flat = _device.place(flat, device, torch.float32)
        x = self._destride(flat, self._nfft, self.desc.stride_in)
        return self._restride(self.forward(x), self.desc.stride_out)

    def inverse_strided(self, flat, device=None) -> torch.Tensor:
        flat = _device.place(flat, device, torch.complex64)
        spec = self._destride(flat, self.num_bins, self.desc.stride_in)
        return self._restride(self.inverse(spec), self.desc.stride_out)

    # --- validation ---

    def _require(self, domain: FftDomain) -> None:
        if self.desc.domain != domain:
            raise ValueError(
                f"plan domain is {self.desc.domain.value}; this method needs "
                f"{domain.value}"
            )

    @staticmethod
    def _check_last(x: torch.Tensor, n: int) -> None:
        if x.shape[-1] != n:
            raise ValueError(f"last axis must be {n}, got {x.shape[-1]}")


def make_fft_plan(desc: FftPlanDesc) -> FftPlan:
    return FftPlan(desc)
