"""Quality metrics (host, float64): counterpart of `crlot_tpu/metrics.py`.

SNR, RMS level, cross-correlation delay and the running peak meter are
verdicts, not hot ops: each reads its input back to the host (a tensor on
the card syncs) and computes in float64, as the reference does."""

from __future__ import annotations

import numpy as np
import torch


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64).reshape(-1)


def snr_db(reference, test) -> float:
    """10*log10(sum(ref^2) / sum((ref-test)^2)) in float64; +inf for an
    exact match, -inf for a silent reference."""
    ref, tst = _f64(reference), _f64(test)
    if ref.shape != tst.shape:
        raise ValueError(f"shape mismatch: {ref.shape} vs {tst.shape}")
    sig = np.sum(ref * ref)
    noise = np.sum(np.square(ref - tst))
    if sig <= 0.0:
        return float("-inf")
    if noise <= 0.0:
        return float("inf")
    return float(10.0 * np.log10(sig / noise))


def rms_db(x) -> float:
    """20*log10(rms(x)) in float64; -inf for silence or no samples."""
    x64 = _f64(x)
    if x64.size == 0:
        return float("-inf")
    rms = np.sqrt(np.mean(np.square(x64)))
    return float(20.0 * np.log10(rms)) if rms > 0 else float("-inf")


def xcorr_delay_samples(reference, test) -> int:
    """Lag (samples) maximizing the cross-correlation of test against
    reference; positive when test lags."""
    ref, tst = _f64(reference), _f64(test)
    n = max(len(ref), len(tst))
    nfft = 1 << (2 * n - 1).bit_length()
    rf = np.fft.rfft(ref, nfft)
    tf = np.fft.rfft(tst, nfft)
    corr = np.fft.irfft(tf * np.conj(rf), nfft)
    corr = np.concatenate([corr[-(n - 1) :], corr[:n]])
    return int(np.argmax(corr)) - (n - 1)


def xcorr_delay_ms(reference, test, sample_rate: int) -> float:
    return xcorr_delay_samples(reference, test) * 1000.0 / sample_rate


class PeakMeter:
    """Running peak level."""

    def __init__(self) -> None:
        self._peak = 0.0

    def update(self, x) -> float:
        block = _f64(x)
        if block.size:
            self._peak = max(self._peak, float(np.max(np.abs(block))))
        return self._peak

    @property
    def peak(self) -> float:
        return self._peak

    @property
    def peak_db(self) -> float:
        return (float(20.0 * np.log10(self._peak)) if self._peak > 0
                else float("-inf"))

    def reset(self) -> None:
        self._peak = 0.0
