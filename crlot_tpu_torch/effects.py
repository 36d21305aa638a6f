"""Signal-conditioning effects: pre-emphasis / de-emphasis and mu-law
companding, in torch.

Counterpart of `crlot_tpu/effects.py`. Pre-emphasis is the FIR difference
y[n] = x[n] - coef*x[n-1] (one shifted subtract); de-emphasis inverts it
with the one-pole IIR y[n] = x[n] + coef*y[n-1] on the log-depth scan
(`iir.lfilter`), so both directions stay O(log T) deep on the card.
Mu-law companding (ITU-T G.711, mu = 255 by default) is elementwise;
`quantize=True` and `mu_law_encode` round to the 2^bits levels (int32
codes). A code whose unrounded value lies within an ulp of a level
boundary can land one code apart from the reference's (torch's `log1p` and
XLA's may differ by an ulp; log1p(mu) itself is the float32 of the
float64 value). Array-like input goes to `device` (default
"cuda", `core/device.py`); a tensor stays on its own device.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import device as _device
from .iir import _state_like, lfilter

__all__ = [
    "preemphasis",
    "deemphasis",
    "mu_compress",
    "mu_expand",
    "mu_law_encode",
    "mu_law_decode",
]


def _f32(v: float) -> float:
    """v rounded to float32, as a Python scalar (torch applies it in f32)."""
    return float(np.float32(v))


def preemphasis(signal, coef: float = 0.97, zi=None,
                device=None) -> torch.Tensor:
    """High-pass pre-emphasis `y[n] = x[n] - coef * x[n-1]` on `[..., T]`.

    `zi` is the previous chunk's final sample `[..., 1]` for streaming
    continuity (default: the scipy/librosa convention x[-1] = x[0], which
    makes y[0] = (1-coef)*x[0] rather than a boundary click)."""
    x = _device.place(signal, device, torch.float32)
    prev = x[..., :1] if zi is None else _state_like(zi, x)
    return x - _f32(coef) * torch.cat([prev, x[..., :-1]], dim=-1)


def deemphasis(signal, coef: float = 0.97, zi=None,
               device=None) -> torch.Tensor:
    """Inverse of `preemphasis`: the one-pole IIR `y[n] = x[n] +
    coef*y[n-1]` on the scan. With matching `coef` and the default boundary
    convention, `deemphasis(preemphasis(x))` reconstructs `x` up to f32
    scan accumulation (> 100 dB for audio).

    `zi` is the previous chunk's final OUTPUT sample `[..., 1]` for
    streaming (the default inverts preemphasis's own default)."""
    x = _device.place(signal, device, torch.float32)
    if zi is None:
        # lfilter's DF2T state z0 = coef * y[-1]; the inverting choice is
        # y[-1] = x_original[0] = x[0] / (1 - coef).
        z0 = x[..., :1] * _f32(coef / (1.0 - coef))
    else:
        z0 = _state_like(zi, x) * _f32(coef)
    y, _ = lfilter([1.0], [1.0, -float(coef)], x, zi=z0)
    return y


def mu_compress(signal, mu: float = 255.0, quantize: bool = False,
                device=None) -> torch.Tensor:
    """Mu-law compress `[-1, 1] -> [-1, 1]`:
    `sign(x) * log1p(mu*|x|) / log1p(mu)`. With `quantize=True` the output
    is snapped to the `mu+1` level centers of `mu_law_encode`."""
    x = torch.clamp(_device.place(signal, device, torch.float32), -1.0, 1.0)
    m = _f32(mu)
    y = torch.sign(x) * torch.log1p(m * torch.abs(x)) / _f32(np.log1p(m))
    if quantize:
        # mu+1 centers at code*2/mu - 1 for integer codes in [0, mu].
        y = torch.clamp(torch.floor((y + 1.0) / 2.0 * m + 0.5), 0.0,
                        m) * 2.0 / m - 1.0
    return y


def mu_expand(signal, mu: float = 255.0, device=None) -> torch.Tensor:
    """Inverse mu-law: `sign(y) * ((1+mu)^|y| - 1) / mu`."""
    y = _device.place(signal, device, torch.float32)
    m = _f32(mu)
    return torch.sign(y) * torch.expm1(torch.abs(y) * _f32(np.log1p(m))) / m


def mu_law_encode(signal, bits: int = 8, device=None) -> torch.Tensor:
    """`[-1, 1]` audio -> int32 codes in `[0, 2^bits)` (mu = 2^bits - 1)."""
    mu = float((1 << bits) - 1)
    y = mu_compress(signal, mu=mu, device=device)
    m = _f32(mu)
    return torch.clamp(torch.floor((y + 1.0) / 2.0 * m + 0.5), 0,
                       mu).to(torch.int32)


def mu_law_decode(codes, bits: int = 8, device=None) -> torch.Tensor:
    """int32 codes in `[0, 2^bits)` -> `[-1, 1]` audio (inverse of
    `mu_law_encode` up to the quantization step)."""
    mu = float((1 << bits) - 1)
    y = _device.place(codes, device).to(torch.float32) * 2.0 / _f32(mu)
    y = y - 1.0
    return mu_expand(y, mu=mu)
