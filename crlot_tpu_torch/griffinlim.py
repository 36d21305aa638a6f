"""Griffin-Lim phase reconstruction from magnitude spectrograms, in torch.

Counterpart of `crlot_tpu/griffinlim.py`: given |STFT(x)|, iterate
istft -> stft -> magnitude projection to recover a consistent phase, with
the fast momentum variant (Perraudin, Balazs & Sondergaard 2013):

    t_k   = stft(istft(c_k))
    u_k   = t_k + momentum * (t_k - t_{k-1})
    c_k+1 = mag * u_k / max(|u_k|, eps)

The reference's `lax.scan` is a Python loop of `iters` steps here. Each
step is one `istft` (its overlap-add on B1, `ola/fused.py`, on the card)
and one `stft` (the folded-DFT products on the card), so a call launches
B1 `iters + 1` times.

The initial phase is uniform in [-pi, pi), a counter-based hash of
(`seed`, flat index) computed on the magnitude's device in integer ops,
which are exact: the CPU and the card draw the same bits, with no host work
and no copy. The reference draws it with `jax.random`, which torch cannot
reproduce: the same `seed` starts elsewhere (ROADMAP C17).
`_griffin_lim_from` takes the initial phase as an argument, so the same
start can be fed to both.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core import device as _device
from .core.types import StftConfig


def stft_magnitude(signal, cfg: StftConfig, device=None) -> torch.Tensor:
    """|STFT(x)| `[..., F, nfft//2+1]`, as `hypot(re, im)` (the
    vectorized complex `abs` on the CPU squares and adds in float32)."""
    from .pipeline import stft

    spec = stft(signal, cfg, device=device)
    return torch.hypot(spec.real, spec.imag)


_M32 = 0xFFFFFFFF


def _hash32(x):
    """A 32-bit integer mix (xorshift-multiply rounds) of x in [0, 2^32),
    an int64 tensor or a Python int. The multipliers are below 2^31, so no
    product leaves int64's range."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def initial_phase(shape, seed: int, device) -> torch.Tensor:
    """Uniform phase in [-pi, pi) of `shape` on `device`: the top 24 bits
    of a hash of (`seed`, flat index), so that every device draws the same
    bits."""
    seed = int(seed)
    key = _hash32(_hash32(seed & _M32) ^ ((seed >> 32) & _M32))
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    bits = _hash32(_hash32((idx & _M32) ^ key) ^ (idx >> 32))
    u = (bits >> 8).to(torch.float32) * np.float32(2.0 ** -24)
    return (u * np.float32(2.0 * np.pi) - np.float32(np.pi)).reshape(
        tuple(shape))


def _griffin_lim_from(mag: torch.Tensor, phase0: torch.Tensor,
                      cfg: StftConfig, iters: int, momentum: float,
                      length: Optional[int]) -> torch.Tensor:
    """The iteration from the initial phase `phase0` (same shape as mag)."""
    from .pipeline import istft, stft

    c = torch.complex(mag * torch.cos(phase0), mag * torch.sin(phase0))
    t_prev = torch.zeros_like(c)
    for _ in range(iters):
        t = stft(istft(c, cfg, length=length), cfg)
        u = t + momentum * (t - t_prev)
        scale = mag / torch.clamp_min(torch.abs(u), 1e-16)
        c, t_prev = scale * u, t
    return istft(c, cfg, length=length)


def griffin_lim(
    mag,
    cfg: StftConfig,
    iters: int = 32,
    momentum: float = 0.99,
    length: Optional[int] = None,
    seed: int = 0,
    device=None,
) -> torch.Tensor:
    """Reconstruct a real signal from a magnitude spectrogram
    `[..., F, nfft//2+1]` (e.g. `stft_magnitude(x, cfg)`). Returns
    `[..., length]` (default: the exact span the frames cover)."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if not 0.0 <= momentum < 1.0:
        raise ValueError(f"momentum must be in [0, 1), got {momentum}")
    mag = _device.place(mag, device, torch.float32)
    phase0 = initial_phase(mag.shape, seed, mag.device)
    return _griffin_lim_from(mag, phase0, cfg, iters, momentum, length)
