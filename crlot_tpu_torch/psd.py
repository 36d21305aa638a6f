"""Welch power-spectral-density estimation on the port's STFT, in torch.

Counterpart of `crlot_tpu/psd.py`: average the per-frame periodograms
|X_f[k]|^2 with the standard window-power and sampling normalization
(scipy.signal.welch with the same window, nperseg = frame_size,
noverlap = frame_size - hop_size, detrend=False), and the magnitude-squared
coherence of two signals from the same frame averages.

The frame average is a sum in one fixed pairwise order along the frames
(`features._sum_last` on the transposed spectrogram), so a channel's
result does not depend on how many channels share the call (a reduction
kernel's order on the card follows the row count, ROADMAP C19). Array-like
input goes to `device` (default "cuda", `core/device.py`); a tensor stays
on its own device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import device as _device
from .core.types import StftConfig
from .features import _sum_last

__all__ = ["welch_psd", "welch_freqs", "coherence"]


def _frame_mean(t: torch.Tensor) -> torch.Tensor:
    """Mean over the frames (axis -2) of `[..., F, K]`, pairwise in F."""
    return _sum_last(t.transpose(-1, -2)) / t.shape[-2]


def welch_psd(
    signal,
    cfg: StftConfig,
    fs: float = 1.0,
    scaling: str = "density",
    device=None,
) -> torch.Tensor:
    """Welch PSD of `[..., T]` -> `[..., nfft//2+1]`.

    `scaling="density"` gives V^2/Hz (divide by fs * sum(w^2));
    `scaling="spectrum"` gives V^2 (divide by sum(w)^2). One-sided:
    interior bins are doubled. `cfg.center` is ignored (Welch segments
    never extend past the data). Use `welch_freqs(cfg, fs)` for the bin
    frequencies.
    """
    if scaling not in ("density", "spectrum"):
        raise ValueError(f"unknown scaling: {scaling}")
    from .pipeline import _window_f64, stft

    cfg_u = dataclasses.replace(cfg, center=False)
    signal = _device.place(signal, device, torch.float32)
    _require_frames(cfg_u, signal.shape[-1])
    spec = stft(signal, cfg_u)  # [..., F, K]
    p = _frame_mean(torch.square(spec.real) + torch.square(spec.imag))
    w = _window_f64(cfg_u)
    if scaling == "density":
        norm = 1.0 / (fs * float(np.sum(w * w)))
    else:
        norm = 1.0 / float(np.sum(w)) ** 2
    p = p * norm
    # One-sided doubling: DC appears once; the last rfft bin is Nyquist
    # (once) only for an even frame_size, and scipy doubles it for an odd
    # one.
    kk = cfg.frame_size // 2 + 1
    last = kk if cfg.frame_size % 2 else kk - 1
    scale = torch.ones(kk, dtype=torch.float32, device=p.device)
    scale[1:last] = 2.0
    return p * scale


def _require_frames(cfg: StftConfig, signal_len: int) -> None:
    """Welch needs >= 1 full segment; a zero-frame mean would be NaN
    (scipy adapts nperseg and warns instead; this fails loudly)."""
    if cfg.frame_spec.num_frames(signal_len) == 0:
        raise ValueError(
            f"signal length {signal_len} yields zero Welch segments for "
            f"frame_size={cfg.frame_size} (need >= frame_size samples)"
        )


def welch_freqs(cfg: StftConfig, fs: float = 1.0) -> np.ndarray:
    """Bin center frequencies for `welch_psd` (host numpy)."""
    return np.fft.rfftfreq(cfg.frame_size, d=1.0 / fs)


def _welch_spectra(x: torch.Tensor, y: torch.Tensor, cfg: StftConfig):
    """Frame-averaged auto / auto / cross spectra (unnormalized): Pxx, Pyy
    and the real and imaginary parts of conj(X) * Y."""
    from .pipeline import stft

    cfg_u = dataclasses.replace(cfg, center=False)
    _require_frames(cfg_u, x.shape[-1])
    _require_frames(cfg_u, y.shape[-1])
    sx = stft(x, cfg_u)
    sy = stft(y, cfg_u)
    pxx = _frame_mean(torch.square(sx.real) + torch.square(sx.imag))
    pyy = _frame_mean(torch.square(sy.real) + torch.square(sy.imag))
    pxy_re = _frame_mean(sx.real * sy.real + sx.imag * sy.imag)
    pxy_im = _frame_mean(sx.real * sy.imag - sx.imag * sy.real)
    return pxx, pyy, pxy_re, pxy_im


def coherence(x, y, cfg: StftConfig, eps: float = 1e-30,
              device=None) -> torch.Tensor:
    """Magnitude-squared coherence Cxy = |Pxy|^2 / (Pxx * Pyy) of two
    `[..., T]` signals -> `[..., nfft//2+1]` in [0, 1] (scipy.signal.coherence
    with the same window / overlap, detrend=False). Needs overlap
    (hop < frame_size): with a single averaged segment the estimate
    degenerates to 1."""
    x = _device.place(x, device, torch.float32)
    y = _device.place(y, device, torch.float32)
    pxx, pyy, pxy_re, pxy_im = _welch_spectra(x, y, cfg)
    num = torch.square(pxy_re) + torch.square(pxy_im)
    return num / torch.clamp_min(pxx * pyy, eps)
