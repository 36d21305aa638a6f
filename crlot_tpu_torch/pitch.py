"""Fundamental-frequency estimation (YIN), onset detection and tempo,
vectorized over frames, in torch.

Counterpart of `crlot_tpu/pitch.py`. YIN (de Cheveigne & Kawahara 2002)
per frame: the difference function d[tau] = sum_n (x[n] - x[n+tau])^2
expands into two energy terms (running cumsums) and a cross-correlation,
computed for all frames at once through rFFT products. The cumulative-mean
normalized difference (CMND) and the absolute-threshold pick with
parabolic refinement follow the paper. The onset envelope is the positive
spectral flux of the dB log-mel spectrogram (`features.mel_spectrogram`:
on the card its filterbank product runs on B0's fp32 kernel); the
tempogram and the tempo autocorrelate it through rFFT products.

The reference's FFTs here are `jnp.fft` (XLA's, not a Pallas kernel), so
`torch.fft` stands in; its cumsums are `torch.cumsum` (XLA's CPU cumsum
sums in another order: `tests/test_torch_pitch.py` states the bound). The
means over mel bands, over the onset window and over frames are sums in
one fixed pairwise order (`features._sum_last`), so a channel's result
does not depend on how many channels share the call. Array-like input goes
to `device` (default "cuda", `core/device.py`); a tensor stays on its own
device.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import device as _device
from .core.types import FrameSpec, StftConfig
from .features import _mean_last

__all__ = ["yin_f0", "onset_strength", "detect_onsets", "tempogram", "tempo"]


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[..., idx[...]] along the last axis (`take_along_axis`)."""
    return torch.gather(t, -1, idx[..., None])[..., 0]


def _rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """num / t as an IEEE divide (a Python number over a tensor is a
    reciprocal and a product in torch)."""
    return torch.div(torch.tensor(num, dtype=t.dtype, device=t.device), t)


def yin_f0(
    signal,
    cfg: StftConfig,
    sr: float,
    fmin: float = 60.0,
    fmax: float = 2000.0,
    threshold: float = 0.1,
    device=None,
) -> tuple:
    """YIN pitch track of `[..., T]` -> `(f0, aperiodicity)`, each
    `[..., F]`.

    `f0` is in Hz (0 for frames judged unvoiced: no CMND dip under
    `threshold` anywhere in the lag band); `aperiodicity` is the frame's
    minimum CMND value in the band: near 0 for strongly periodic frames,
    near 1 for noise. The search window is `frame_size // 2` samples, so
    `fmin` must satisfy sr / fmin < frame_size // 2.
    """
    from .frame.framing import frame_signal

    n = cfg.frame_size
    w = n // 2  # YIN integration window; lags up to w fit in the frame
    tau_min = max(1, int(sr / fmax))
    tau_max = min(w - 1, int(np.ceil(sr / fmin)))
    if tau_min >= tau_max:
        raise ValueError(
            f"empty lag band for fmin={fmin}, fmax={fmax} at sr={sr} with "
            f"frame_size={n} (need sr/fmin < frame_size//2 and fmax < sr)"
        )

    x = _device.place(signal, device, torch.float32)
    frames = frame_signal(x, cfg.frame_spec)  # [..., F, n]

    # d[tau] = E0 + E[tau] - 2 * cross[tau], tau in [0, w).
    sq = torch.square(frames)
    csum = torch.cat([torch.zeros_like(sq[..., :1]),
                      torch.cumsum(sq, dim=-1)], dim=-1)  # [..., F, n+1]
    e0 = csum[..., w] - csum[..., 0]
    taus = torch.arange(w, device=x.device)
    e_tau = csum[..., taus + w] - csum[..., taus]  # [..., F, w]

    # Linear correlation of x[:w] against x via rFFT (zero-padded to 2n).
    pad = 2 * n
    head = (torch.arange(n, device=x.device) < w).float() * frames
    fa = torch.fft.rfft(head, n=pad, dim=-1)
    fb = torch.fft.rfft(frames, n=pad, dim=-1)
    cross = torch.fft.irfft(torch.conj(fa) * fb, n=pad, dim=-1)[..., :w]

    d = torch.clamp_min(e0[..., None] + e_tau - 2.0 * cross, 0.0)

    # CMND: d'[tau] = d[tau] * tau / sum_{j<=tau} d[j]; d'[0] = 1.
    run = torch.cumsum(d, dim=-1)
    cmnd = d * taus.float() / torch.clamp_min(run, 1e-12)
    cmnd[..., 0] = 1.0

    # Restrict to the lag band; outside it the CMND is 2.
    band = (taus >= tau_min) & (taus <= tau_max)
    cmnd_b = torch.where(band, cmnd, 2.0)

    # The first local minimum of the CMND under the threshold; if none,
    # the global minimum in the band.
    left = torch.roll(cmnd_b, 1, dims=-1)
    right = torch.roll(cmnd_b, -1, dims=-1)
    under = (cmnd_b < left) & (cmnd_b <= right) & (cmnd_b < threshold)
    any_under = torch.any(under, dim=-1)
    first = torch.argmax(under.to(torch.uint8), dim=-1)  # the first True
    best = torch.argmin(cmnd_b, dim=-1)
    tau_hat = torch.where(any_under, first, best)

    # Parabolic refinement around tau_hat on the raw d' curve.
    t0 = torch.clamp(tau_hat, tau_min, tau_max)
    ym = _take(cmnd, t0 - 1)
    y0 = _take(cmnd, t0)
    yp = _take(cmnd, torch.clamp_max(t0 + 1, w - 1))
    denom = ym - 2.0 * y0 + yp
    shift = torch.where(torch.abs(denom) > 1e-12, 0.5 * (ym - yp) / denom,
                        0.0)
    tau_ref = t0.float() + torch.clamp(shift, -0.5, 0.5)

    aperiodicity = torch.amin(cmnd_b, dim=-1)
    f0 = torch.where(any_under, _rdiv(sr, torch.clamp_min(tau_ref, 1.0)),
                     0.0)
    return f0, aperiodicity


def onset_strength(
    signal,
    cfg: StftConfig,
    sr: float,
    n_mels: int = 64,
    floor_db: float = -80.0,
    device=None,
) -> torch.Tensor:
    """Spectral-flux onset novelty `[..., T] -> [..., F]`: the positive
    first difference of the dB log-mel spectrogram, averaged over bands
    (frame 0 is 0)."""
    from .features import mel_spectrogram, power_to_db

    logmel = power_to_db(
        mel_spectrogram(signal, cfg, sr, n_mels=n_mels, device=device),
        floor_db=floor_db,
    )  # [..., F, M]
    flux = torch.clamp_min(logmel[..., 1:, :] - logmel[..., :-1, :], 0.0)
    env = _mean_last(flux)
    return torch.cat([torch.zeros_like(env[..., :1]), env], dim=-1)


def detect_onsets(
    signal,
    cfg: StftConfig,
    sr: float,
    n_mels: int = 64,
    pre_frames: int = 3,
    post_frames: int = 3,
    delta: float = 1.0,
    device=None,
) -> tuple:
    """Onset picking on the spectral-flux envelope. Returns
    `(onset_mask, envelope)`, both `[..., F]`; `onset_mask` is boolean
    (frame indices: `np.nonzero` on the host).

    A frame is an onset when its novelty is (a) the maximum over a
    `[-pre_frames, +post_frames]` window and (b) at least `delta` dB above
    the window mean.

    Timing convention: the flux rises as soon as the event enters the
    analysis window, so an event at sample p is flagged around frame
    p/hop - (frame_size/hop - 1) with uncentered framing.
    """
    env = onset_strength(signal, cfg, sr, n_mels=n_mels, device=device)
    f = env.shape[-1]
    idx = torch.arange(-pre_frames, f + post_frames,
                       device=env.device).clamp_(0, f - 1)
    windows = env[..., idx].unfold(-1, pre_frames + post_frames + 1, 1)
    is_max = env >= torch.amax(windows, dim=-1) - 1e-9
    above = env >= _mean_last(windows) + delta
    return is_max & above & (env > 0), env


def tempogram(
    signal,
    cfg: StftConfig,
    sr: float,
    win_frames: int = 384,
    n_mels: int = 64,
    device=None,
) -> torch.Tensor:
    """Local autocorrelation tempogram `[..., T] -> [..., F, win_frames]`
    (Grosche & Mueller 2010): the onset envelope framed into Hann-windowed
    `win_frames`-long windows at every frame (hop 1, zero-padded so window
    f is centered on frame f), each autocorrelated via rFFT products and
    normalized by its own lag-0 energy, so values lie in [-1, 1]. Lag l is
    60 * (sr/hop) / l BPM.
    """
    from .core.consts import const_on
    from .frame.framing import frame_signal

    env = onset_strength(signal, cfg, sr, n_mels=n_mels, device=device)
    left = win_frames // 2
    right = win_frames - 1 - left
    pad = torch.nn.functional.pad(env, (left, right))
    wins = frame_signal(pad, FrameSpec(win_frames, 1))  # [..., F, win]
    w = const_on(np.hanning(win_frames + 1)[:-1], env.device)
    spec = torch.fft.rfft(wins * w, n=2 * win_frames, dim=-1)
    ac = torch.fft.irfft(
        torch.square(spec.real) + torch.square(spec.imag),
        n=2 * win_frames, dim=-1,
    )[..., :win_frames]
    return ac / torch.clamp_min(ac[..., :1], 1e-12)


def tempo(
    signal,
    cfg: StftConfig,
    sr: float,
    start_bpm: float = 120.0,
    std_bpm: float = 1.0,
    min_bpm: float = 30.0,
    max_bpm: float = 300.0,
    n_mels: int = 64,
    device=None,
) -> torch.Tensor:
    """Global tempo estimate in BPM, `[..., T] -> [...]`. The mean-removed
    onset envelope is autocorrelated once (rFFT), scored against a
    log-normal tempo prior centered at `start_bpm` (std `std_bpm`
    octaves), and the best lag inside `[min_bpm, max_bpm]` is refined
    parabolically. Returns 0 where the envelope is silent.
    """
    env = onset_strength(signal, cfg, sr, n_mels=n_mels, device=device)
    env = env - _mean_last(env)[..., None]
    f = env.shape[-1]
    spec = torch.fft.rfft(env, n=2 * f, dim=-1)
    ac = torch.fft.irfft(
        torch.square(spec.real) + torch.square(spec.imag), n=2 * f, dim=-1
    )[..., :f]

    frame_rate = sr / cfg.hop_size
    # An envelope shorter than one max-tempo period has no valid lag, and
    # an argmax over an all -inf score would return lag 0: a host check.
    lags_np = np.arange(f, dtype=np.float32)
    bpm_np = 60.0 * frame_rate / np.maximum(lags_np, 1e-6)
    if not ((bpm_np >= min_bpm) & (bpm_np <= max_bpm) & (lags_np >= 1)).any():
        raise ValueError(
            f"signal too short for tempo(): onset envelope has {f} frames "
            f"but no autocorrelation lag falls inside [{min_bpm}, {max_bpm}] "
            f"BPM at frame rate {frame_rate:.1f}/s (the fastest allowed "
            f"tempo needs {60.0 * frame_rate / max_bpm:.1f} frames)"
        )
    lags = torch.arange(f, dtype=torch.float32, device=env.device)
    bpm = _rdiv(60.0 * frame_rate, torch.clamp_min(lags, 1e-6))
    prior = torch.exp(-0.5 * torch.square(
        (torch.log2(bpm) - float(np.float32(np.log2(start_bpm)))) / std_bpm))
    valid = (bpm >= min_bpm) & (bpm <= max_bpm) & (lags >= 1)
    score = torch.where(valid, ac * prior, -torch.inf)
    l0 = torch.argmax(score, dim=-1)

    # Parabolic refinement on the raw autocorrelation around the peak.
    ym = _take(ac, torch.clamp(l0 - 1, 0, f - 1))
    y0 = _take(ac, l0)
    yp = _take(ac, torch.clamp(l0 + 1, 0, f - 1))
    denom = ym - 2.0 * y0 + yp
    shift = torch.where(torch.abs(denom) > 1e-12, 0.5 * (ym - yp) / denom,
                        0.0)
    lag_ref = l0.float() + torch.clamp(shift, -0.5, 0.5)

    # True silence leaves a ~1e-6 residue in the dB-flux envelope (f32
    # rounding in the STFT of zeros); anything musical is O(1).
    silent = torch.amax(torch.abs(env), dim=-1) <= 1e-4
    return torch.where(
        silent, 0.0, _rdiv(60.0 * frame_rate, torch.clamp_min(lag_ref, 1e-6)))
