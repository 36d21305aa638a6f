"""Exact 1-D FIR convolution as hop-block Toeplitz products, in torch.

Counterpart of `crlot_tpu/convolve.py`. The linear convolution is blocked
like the round-trip's blocked formulation and runs on the same runtime
(`fft.matmul_backend.hopblock_apply`): each output hop-block is one row of a
[B, M*hop] x [M*hop, hop] product whose kernel is the taps laid out on the
Toeplitz diagonals -- exact (no circular wrap). MACs per sample =
ceil((L-1)/hop + 1)*hop ~= L + hop for L taps. The reference computes this
as an XLA dot at its `precision`; the port runs it on B0 on a CUDA tensor
(3xTF32 at the HIGH tier, its fixed-order IEEE fp32 kernel at HIGHEST), and
as `torch.matmul` in IEEE fp32 on the CPU.

Modes follow numpy.convolve: full (T+L-1), same (max(T, L), centered),
valid (max-min+1) -- including the L > len(x) orientations.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .core import device as _device
from .core.types import FftPrecision
from .fft import tf32x3
from .fft.matmul_backend import hopblock_apply

_HOP = 256  # output block, as in the reference


# Bounded: each entry pins ~(L+hop)*hop f32 of host memory (~256x the taps),
# so per-call dynamic filters in a long-lived process must evict.
@lru_cache(maxsize=64)
def _toeplitz_kernel(taps_bytes: bytes, hop: int):
    """[M*hop, hop] kernel: K[tau, s] = taps[s - tau + (M-1)*hop]."""
    taps = np.frombuffer(taps_bytes, dtype=np.float64)
    ll = len(taps)
    mg = -(-(ll - 1) // hop) + 1 if ll > 1 else 1
    k = np.zeros((mg * hop, hop), np.float64)
    off = (mg - 1) * hop
    tau = np.arange(mg * hop)[:, None]
    s = np.arange(hop)[None, :]
    j = s - tau + off
    inside = (j >= 0) & (j < ll)
    k[inside] = taps[j[inside]]
    return np.ascontiguousarray(k.astype(np.float32))


@lru_cache(maxsize=8)
def _toeplitz_on(taps_bytes: bytes, hop: int,
                 device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_toeplitz_kernel(taps_bytes, hop)).to(device)


@lru_cache(maxsize=8)
def _toeplitz_bt_on(taps_bytes: bytes, hop: int, device: torch.device):
    """The kernel as B0 takes it: transposed, TF32 (hi, lo)."""
    return tuple(torch.from_numpy(a).to(device) for a in tf32x3.split_t(
        _toeplitz_kernel(taps_bytes, hop)))


# The reference's `precision=` values: None, its FftPrecision tiers, and
# jax.lax.Precision's DEFAULT / HIGH / HIGHEST (by name or as a string).
_PRECISION_NAMES = ("default", "high", "highest")


def _tier(precision) -> FftPrecision:
    """The port's tier for the reference's precision argument: HIGHEST
    (by name or as FftPrecision) is IEEE fp32; None, HIGH, INT8X2 (no int8
    formulation here: HIGH, as `core.types.float_tier` maps it) and
    DEFAULT (a single bf16 pass on the TPU) are HIGH, 3xTF32 on B0. An
    unknown value raises."""
    if precision is None or precision in (FftPrecision.HIGH,
                                          FftPrecision.INT8X2):
        return FftPrecision.HIGH
    if precision == FftPrecision.HIGHEST:
        return FftPrecision.HIGHEST
    name = getattr(precision, "name", precision)
    if not (isinstance(name, str) and name.lower() in _PRECISION_NAMES):
        raise ValueError(f"unknown precision {precision!r}; one of None, "
                         f"FftPrecision.HIGHEST / HIGH, {_PRECISION_NAMES}")
    return (FftPrecision.HIGHEST if name.lower() == "highest"
            else FftPrecision.HIGH)


def convolve(x, taps, mode: str = "full", precision=None,
             device=None) -> torch.Tensor:
    """Linear convolution of `[..., T]` with 1-D `taps` (len L <= a few
    thousand -- kernel memory is ~L*hop floats), on x's device (an
    array-like goes to `device`, default "cuda"). Matches numpy.convolve
    semantics for `mode` in {"full", "same", "valid"}. `precision` takes
    the reference's values: HIGHEST is an IEEE fp32 product, every other
    tier (None included) HIGH, 3xTF32 on B0 for a CUDA tensor."""
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"unknown mode: {mode}")
    tier = _tier(precision)
    if isinstance(taps, torch.Tensor):
        taps = taps.detach().cpu().numpy()
    taps64 = np.asarray(taps, np.float64)
    if taps64.ndim != 1 or taps64.size == 0:
        raise ValueError("taps must be a non-empty 1-D array")
    x = _device.place(x, device, torch.float32)
    t = x.shape[-1]
    ll = taps64.size
    hop = _HOP
    kern = _toeplitz_on(taps64.tobytes(), hop, x.device)
    n_full = t + ll - 1
    # Left halo = the kernel's look-back span (mg-1 blocks).
    left = kern.shape[0] - hop
    bt = (_toeplitz_bt_on(taps64.tobytes(), hop, x.device)
          if x.device.type != "cpu" and tier == FftPrecision.HIGH else None)
    full = hopblock_apply(x, kern, hop, n_full, left, tier, bt)
    if mode == "full":
        return full
    lo, hi = min(t, ll), max(t, ll)
    if mode == "same":  # numpy: length max(T, L), centered
        start = (lo - 1) // 2
        return full[..., start : start + hi]
    return full[..., lo - 1 : hi]  # valid: length max - min + 1
